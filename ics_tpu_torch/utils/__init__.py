"""Resize, timing and tracing."""
