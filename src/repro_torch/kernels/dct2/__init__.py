"""The 2-D DCT of BDM's frequency basis and the fused BDM EI update: plain
version (ref) and CUDA kernel dispatch (ops)."""
