"""Hand-written CUDA kernels: the build step and one wrapper per kernel."""
