"""Fused MIPS scan + top-k: CUDA kernel (``csrc/ip_topk.cu``), its plain
PyTorch version, and the wrapper that picks between them by device.

Port of ``repro/kernels/ip_topk`` (TPU kernel ``ip_topk``, body
``_ip_topk_kernel``)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.index.topk import blocked_topk

__all__ = ["ip_topk", "ip_topk_plain", "ScanPlan", "scan_plan",
           "split_plan", "fold_profile"]


def ip_topk_plain(q: torch.Tensor, x: torch.Tensor, k: int,
                  block: int = 65536):
    """Exact MIPS top-k, blocked over N: ``q (M, d)``, ``x (N, d)`` f32 or
    u8 -> (vals (M, k) f32, ids (M, k) i32)."""
    q = q.to(torch.float32)

    def score(start, size):
        return q @ x[start:start + size].to(torch.float32).T

    return blocked_topk(score, x.shape[0], k, block, q.shape[0], q.device)


class ScanPlan(NamedTuple):
    """Launch shape of one ``ip_topk`` call: the scan's grid (query
    blocks, splits), the splits S, and the shape (M, S, pass_k(k)) of the
    partial lists every pass writes."""
    grid: tuple
    splits: int
    partial_shape: tuple


def split_plan(m: int, tiles: int, k: int, sms: int) -> ScanPlan:
    """The grid and partial-list sizes of the pipelined scan
    (``csrc/ip_scan.cuh``, one block an SM) for ``m`` queries, ``tiles`` row
    tiles and any k >= 1 on a card with ``sms`` SMs: blocks of
    ``K.IP_TILE_M`` queries, and the tiles split so that the grid fills at
    most one wave (fewer splits, fewer top-k insertions: each split's list
    takes about k (1 + ln(rows / k))); S is at most the tiles and
    S * pass_k(k) at most ``K.MERGE_MAX``."""
    from repro_torch import kernels as K
    query_blocks = -(-m // K.IP_TILE_M)
    s = max(1, min(sms // max(query_blocks, 1), tiles,
                   K.MERGE_MAX // K.pass_k(k)))
    return ScanPlan((query_blocks, s), s, (m, s, K.pass_k(k)))


def scan_plan(m: int, n: int, k: int, sms: int) -> ScanPlan:
    """:func:`split_plan` of ``ip_topk`` over ``n`` rows: row tiles of
    ``K.IP_TILE_N``."""
    from repro_torch import kernels as K
    return split_plan(m, -(-n // K.IP_TILE_N), k, sms)


def _scratch(q, x, k):
    """The plan, the partial lists (values, ids) and the splits' shared
    floors (M, S) of one call on CUDA tensors."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = scan_plan(q.shape[0], x.shape[0], k, sms)
    pv = torch.empty(plan.partial_shape, dtype=torch.float32,
                     device=q.device)
    pi = torch.empty(plan.partial_shape, dtype=torch.int32, device=q.device)
    floors = torch.empty(plan.partial_shape[:2], dtype=torch.int32,
                         device=q.device)
    return plan, pv, pi, floors


def _bind(lib):
    from repro_torch import kernels as K
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("ip_topk_f32", "ip_topk_u8"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    lib.ip_topk_profile.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.ip_topk_profile.restype = ctypes.c_int
    lib.ip_topk_tile.argtypes = [i]
    lib.ip_topk_tile.restype = ctypes.c_int
    tile = (lib.ip_topk_tile(0), lib.ip_topk_tile(1))
    if tile != (K.IP_TILE_M, K.IP_TILE_N):
        raise RuntimeError(
            f"ip_topk: the kernel's tile {tile} is not (IP_TILE_M, "
            f"IP_TILE_N) = {(K.IP_TILE_M, K.IP_TILE_N)}: its partial lists "
            "would be sized wrong")


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
    lib = K.load_library("ip_topk", _bind)
    plan, pv, pi, floors = _scratch(q, x, k)
    fn = lib.ip_topk_f32 if x.dtype == torch.float32 else lib.ip_topk_u8
    err = fn(q.data_ptr(), x.data_ptr(), m, n, d, k, plan.splits,
             pv.data_ptr(), pi.data_ptr(), floors.data_ptr(), vals.data_ptr(),
             ids.data_ptr(), K.current_stream(q.device))
    K.check_launch("ip_topk", err, lib)
    K.count_launch(ip_topk)
    return vals, ids


ip_topk.launches = 0


FOLD_PARTS = ("kernel", "fold", "append", "wait", "insert", "vote")


def fold_profile(q: torch.Tensor, x: torch.Tensor, k: int) -> dict:
    """One pass of the kernel's scan on CUDA tensors (k <= ``K.PASS_K``,
    no merge) with its fold profiled: {part: cycles} of ``FOLD_PARTS``,
    thread 0's ``clock64`` summed over the blocks -- the kernel, its top-k
    folds, and inside them the compares and appends, the wait at the
    barrier after them, the list inserts and the wait at the closing
    vote. For timing only: not counted in ``ip_topk.launches``."""
    from repro_torch import kernels as K
    K.check_cuda_inputs("ip_topk", q=q, x=x)
    if not 1 <= k <= K.PASS_K:
        raise ValueError(f"one scan pass takes 1 <= k <= {K.PASS_K}")
    m, d = q.shape
    n = x.shape[0]
    lib = K.load_library("ip_topk", _bind)
    plan, pv, pi, floors = _scratch(q, x, k)
    clocks = torch.zeros(len(FOLD_PARTS), dtype=torch.int64, device=q.device)
    err = lib.ip_topk_profile(q.data_ptr(), x.data_ptr(),
                              int(x.dtype == torch.uint8), m, n, d, k,
                              plan.splits, pv.data_ptr(), pi.data_ptr(),
                              floors.data_ptr(), clocks.data_ptr(),
                              K.current_stream(q.device))
    K.check_launch("ip_topk profile", err, lib)
    return dict(zip(FOLD_PARTS, clocks.tolist()))
