# Hand-written CUDA kernels for the Coconut hot path (csrc/, built on first
# use), their wrappers (ops) and their plain PyTorch versions (ref).
from . import ops, ref

__all__ = ["ops", "ref"]
