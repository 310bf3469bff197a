"""Hand-written CUDA kernels and their nvcc build/loader."""
