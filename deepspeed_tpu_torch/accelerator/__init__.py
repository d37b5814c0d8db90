from .real_accelerator import get_accelerator

__all__ = ["get_accelerator"]
