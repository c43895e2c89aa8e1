"""Step factories and the serving CLI."""
