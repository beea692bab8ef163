"""Dense int8 scores: CUDA kernel (``csrc/dense_scores.cu``, ``sq_dot_u8``),
its plain PyTorch version, and the wrapper.

Port of ``repro/kernels/sq_dot`` (TPU kernel ``sq_dot``, body
``_sq_dot_kernel``). With per-dimension scales folded into the query,

    scores[m, n] = <q_m, codes_n * delta + lo> = <q_m * delta, codes_n>
                   + <q_m, lo>.

``sq_dot(q, codes, lo, delta)`` folds as the reference's wrapper does and
launches; ``sq_dot_folded(q_scaled, q_lo, codes)`` takes the folded
operands (a ``QuantizedScorer``'s prepared queries). Both launch the same
kernel (the dense instantiation of the pipelined scan, ``csrc/ip_scan.cuh``,
with the launch shape of :func:`dense_plan`) and count in
``sq_dot.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gleanvec_sq import dense_plain
from repro_torch.kernels.ip_topk import ScanPlan, split_plan

__all__ = ["sq_dot", "sq_dot_folded", "sq_dot_folded_plain", "dense_plan"]


def _fold(q, lo, delta):
    q = q.to(torch.float32)
    return q * delta[None, :], q @ lo


def sq_dot_folded_plain(q_scaled, q_lo, codes, block: int = 65536):
    """(M, N) f32 scores ``q_scaled @ codes.T + q_lo[:, None]``, blocked
    over N."""
    q_scaled = q_scaled.to(torch.float32)

    def score(start, size):
        return q_scaled @ codes[start:start + size].to(torch.float32).T \
            + q_lo[:, None]

    return dense_plain(score, codes.shape[0], q_scaled.shape[0],
                       q_scaled.device, block)


def dense_plan(m: int, n: int, sms: int) -> ScanPlan:
    """The grid of ``sq_dot`` on a card with ``sms`` SMs: ``ip_topk``'s
    one-wave split of the ``K.IP_TILE_N``-row tiles, one block an SM. The
    blocks write disjoint columns: no partial lists (``partial_shape`` is
    None), no merge."""
    from repro_torch import kernels as K
    return split_plan(m, -(-n // K.IP_TILE_N), 1, sms)._replace(
        partial_shape=None)


def _bind(lib):
    from repro_torch import kernels as K
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sq_dot_u8.argtypes = [p, p, p, i, i, i, i, p, p]
    lib.sq_dot_u8.restype = ctypes.c_int
    lib.sq_dot_tile.argtypes = [i]
    lib.sq_dot_tile.restype = ctypes.c_int
    tile = (lib.sq_dot_tile(0), lib.sq_dot_tile(1))
    if tile != (K.IP_TILE_M, K.IP_TILE_N):
        raise RuntimeError(
            f"sq_dot: the kernel's tile {tile} is not (IP_TILE_M, "
            f"IP_TILE_N) = {(K.IP_TILE_M, K.IP_TILE_N)}: its grid would be "
            "sized wrong")


def sq_dot_folded(q_scaled, q_lo, codes):
    """``q_scaled (M, d)`` f32, ``q_lo (M,)`` f32, ``codes (N, d)`` u8 ->
    (M, N) f32. CPU tensors take :func:`sq_dot_folded_plain`; CUDA tensors
    launch the kernel or raise."""
    from repro_torch import kernels as K
    if K.on_cpu(q_scaled, q_lo, codes):
        return sq_dot_folded_plain(q_scaled, q_lo, codes)
    K.check_cuda_inputs("sq_dot", q_scaled=q_scaled, q_lo=q_lo, codes=codes)
    if q_scaled.dtype != torch.float32 or q_lo.dtype != torch.float32 \
            or codes.dtype != torch.uint8:
        raise TypeError("sq_dot takes f32 queries and u8 codes, got "
                        f"{q_scaled.dtype}, {q_lo.dtype}, {codes.dtype}")
    m, d = q_scaled.shape
    n = codes.shape[0]
    if q_lo.shape != (m,) or codes.shape != (n, d):
        raise ValueError(f"sq_dot shapes {tuple(q_scaled.shape)}, "
                         f"{tuple(q_lo.shape)}, {tuple(codes.shape)}")
    dev = q_scaled.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dense_plan(m, n, sms)
    lib = K.load_library("dense_scores", _bind)
    err = lib.sq_dot_u8(q_scaled.data_ptr(), q_lo.data_ptr(),
                        codes.data_ptr(), m, d, n, plan.splits,
                        out.data_ptr(), K.current_stream(dev))
    K.check_launch("sq_dot", err, lib)
    K.count_launch(sq_dot)
    return out


def sq_dot(q, codes, lo, delta):
    """``q (M, d)`` f32, ``codes (N, d)`` u8, ``lo``/``delta (d,)`` f32 ->
    (M, N) f32 = <q * delta, codes> + <q, lo>: the fold, then
    :func:`sq_dot_folded`."""
    return sq_dot_folded(*_fold(q, lo, delta), codes)


sq_dot.launches = 0
