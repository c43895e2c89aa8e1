"""The fused gDDIM round commit: plain version (ref) and CUDA kernel
dispatch (ops)."""
