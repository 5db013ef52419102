"""Build and load of the CUDA kernels (``nvcc`` + ``ctypes``)."""
