"""Diffusion model specs (training itself is not ported yet)."""
