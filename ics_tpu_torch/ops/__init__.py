"""Operators: convolution, PSF helpers, reductions and the CUDA kernels."""
