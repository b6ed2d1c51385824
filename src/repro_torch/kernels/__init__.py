"""Hand-written CUDA kernels of the port, their plain torch twins, and
the nvcc build. Nothing here builds or imports a compiler at import
time: the CUDA library is compiled and loaded at its first launch."""
