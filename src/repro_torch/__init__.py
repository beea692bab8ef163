"""PyTorch / CUDA port of the GleanVec vector-search stack.

The JAX package ``repro`` is the reference; this package runs the same
flat-index search path (fit -> encode -> fused scan -> rerank -> serving
engine) on an NVIDIA Hopper GPU, with its scan and assignment kernels
written by hand in CUDA C++ (``repro_torch/csrc``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request it raises
instead of falling back (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
