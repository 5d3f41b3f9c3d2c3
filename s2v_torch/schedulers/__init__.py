"""Diffusion schedulers of the port."""
