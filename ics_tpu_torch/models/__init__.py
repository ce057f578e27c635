"""The RL-MM solver, the deblur pipeline and PSF checkpoints."""
