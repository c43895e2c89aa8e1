"""The fused gDDIM EI update and the factored coefficient apply: plain
version (ref) and CUDA kernel dispatch (ops), with the canonical packing
layer."""
