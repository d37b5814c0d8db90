from .builder import CUDAKernelBuilder, get_builder, load_kernels

__all__ = ["CUDAKernelBuilder", "get_builder", "load_kernels"]
