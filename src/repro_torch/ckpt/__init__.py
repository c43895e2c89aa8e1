"""Atomic, async, restartable checkpoints."""
