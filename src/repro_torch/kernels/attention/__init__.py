"""Flash attention: plain version (ref) and CUDA kernel dispatch (ops)."""
