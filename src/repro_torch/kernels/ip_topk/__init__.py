"""Fused MIPS scan + top-k: CUDA kernel (``csrc/ip_topk.cu``), its plain
PyTorch version, and the wrapper that picks between them by device.

Port of ``repro/kernels/ip_topk`` (TPU kernel ``ip_topk``, body
``_ip_topk_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.index.topk import blocked_topk

__all__ = ["ip_topk", "ip_topk_plain"]


def ip_topk_plain(q: torch.Tensor, x: torch.Tensor, k: int,
                  block: int = 65536):
    """Exact MIPS top-k, blocked over N: ``q (M, d)``, ``x (N, d)`` f32 or
    u8 -> (vals (M, k) f32, ids (M, k) i32)."""
    q = q.to(torch.float32)

    def score(start, size):
        return q @ x[start:start + size].to(torch.float32).T

    return blocked_topk(score, x.shape[0], k, block, q.shape[0], q.device)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("ip_topk_f32", "ip_topk_u8"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int


def ip_topk(q: torch.Tensor, x: torch.Tensor, k: int):
    """``q (M, d)`` f32, ``x (N, d)`` f32 or u8 -> (vals (M, k) f32,
    ids (M, k) i32), best first, ids = row index of x. Any k >= 1 (above
    ``K.PASS_K`` the kernel scans in passes).

    CPU tensors take :func:`ip_topk_plain`; CUDA tensors launch the kernel
    (or raise on what it does not take)."""
    from repro_torch import kernels as K
    if K.on_cpu(q, x):
        return ip_topk_plain(q, x, k)
    K.check_cuda_inputs("ip_topk", q=q, x=x)
    if q.dtype != torch.float32 or x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"ip_topk takes f32 q and f32/u8 x, got {q.dtype}, "
                        f"{x.dtype}")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"ip_topk shapes {tuple(q.shape)}, {tuple(x.shape)}")
    K.check_k(k)
    m, d = q.shape
    n = x.shape[0]
    vals = torch.empty((m, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((m, k), dtype=torch.int32, device=q.device)
    if m == 0:
        return vals, ids
    s = K.splits(row_tiles=-(-n // K.GEMM_TILE_N),
                 query_blocks=-(-m // K.GEMM_TILE_M), k=k,
                 blocks_per_sm=2, device=q.device)
    pv = torch.empty((m, s, K.pass_k(k)), dtype=torch.float32,
                     device=q.device)
    pi = torch.empty((m, s, K.pass_k(k)), dtype=torch.int32, device=q.device)
    lib = K.load_library("ip_topk", _bind)
    fn = lib.ip_topk_f32 if x.dtype == torch.float32 else lib.ip_topk_u8
    err = fn(q.data_ptr(), x.data_ptr(), m, n, d, k, s, pv.data_ptr(),
             pi.data_ptr(), vals.data_ptr(), ids.data_ptr(),
             K.current_stream(q.device))
    K.check_launch("ip_topk", err, lib)
    ip_topk.launches += 1
    return vals, ids


ip_topk.launches = 0
