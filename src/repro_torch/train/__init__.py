"""Diffusion model specs (`DiffusionSpec`) and the DSM/HSM training losses."""
