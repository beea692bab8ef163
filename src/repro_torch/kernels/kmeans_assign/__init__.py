"""Spherical k-means assignment (Eq. 14 / 23): CUDA kernel
(``csrc/kmeans_assign.cu``), its plain PyTorch version, and the wrapper.

Port of ``repro/kernels/kmeans_assign`` (TPU kernel ``kmeans_assign``)."""
from __future__ import annotations

import ctypes

import torch

__all__ = ["kmeans_assign", "kmeans_assign_plain"]

def kmeans_assign_plain(x: torch.Tensor, centers: torch.Tensor,
                        block: int = 65536):
    """``x (N, D)``, ``centers (C, D)`` -> (tags (N,) i32, maxsim (N,) f32),
    blocked over N; ties go to the first center (``torch.max``)."""
    cent = centers.to(torch.float32)
    n = x.shape[0]
    tags = torch.empty(n, dtype=torch.int32, device=x.device)
    sims = torch.empty(n, dtype=torch.float32, device=x.device)
    for start in range(0, n, block):
        s = x[start:start + block].to(torch.float32) @ cent.T
        best, arg = torch.max(s, dim=1)
        tags[start:start + block] = arg.to(torch.int32)
        sims[start:start + block] = best
    return tags, sims


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kmeans_assign_f32.argtypes = [p, p, i, i, i, p, p, p]
    lib.kmeans_assign_f32.restype = ctypes.c_int


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor):
    """``x (N, D)`` f32, ``centers (C, D)`` f32 -> (tags (N,) i32,
    maxsim (N,) f32), ties to the first center. Any C >= 1 and any D in
    one launch: the kernel streams the centers with the rows, one pass
    over x for up to 128 centers (more re-read each row tile from L2 per
    further tile of centers). CPU tensors take :func:`kmeans_assign_plain`;
    CUDA tensors launch the kernel or raise."""
    from repro_torch import kernels as K
    if K.on_cpu(x, centers):
        return kmeans_assign_plain(x, centers)
    K.check_cuda_inputs("kmeans_assign", x=x, centers=centers)
    if x.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("kmeans_assign takes f32 x and centers")
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"kmeans_assign shapes {tuple(x.shape)}, "
                         f"{tuple(centers.shape)}")
    n, d = x.shape
    c = centers.shape[0]
    if c < 1:
        raise ValueError("kmeans_assign needs at least one center")
    lib = K.load_library("kmeans_assign", _bind)
    tags = torch.empty(n, dtype=torch.int32, device=x.device)
    sims = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return tags, sims
    err = lib.kmeans_assign_f32(x.data_ptr(), centers.data_ptr(), n, d, c,
                                tags.data_ptr(), sims.data_ptr(),
                                K.current_stream(x.device))
    K.check_launch("kmeans_assign", err, lib)
    K.count_launch(kmeans_assign)
    return tags, sims


kmeans_assign.launches = 0
