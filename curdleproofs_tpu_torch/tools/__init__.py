"""Measurement scripts for the port on a CUDA card (see `kernel_probe`)."""
