"""Hand-written CUDA kernels of the seam DP, their build and wrappers."""
