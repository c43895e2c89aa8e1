"""Decode attention (one query per row against a KV cache): plain version
(ref) and CUDA kernel dispatch (ops)."""
