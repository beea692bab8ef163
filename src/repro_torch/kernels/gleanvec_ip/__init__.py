"""Dense eager GleanVec scores (Alg. 4): CUDA kernel
(``csrc/dense_scores.cu``, ``gleanvec_ip_f32``), its plain PyTorch version,
and the wrapper.

Port of ``repro/kernels/gleanvec_ip`` (TPU kernel ``gleanvec_ip``, body
``_gleanvec_ip_kernel``):

    scores[m, n] = <q_views[m, tags[n]], x_low[n]>
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gleanvec_sq import (bucket_tiles, dense_buffer,
                                             dense_plain, tile_scores)

__all__ = ["gleanvec_ip", "gleanvec_ip_plain"]


def gleanvec_ip_plain(q_views, tags, x_low, block: int = 65536):
    """(M, N) f32, blocked over N, one matmul per cluster in each block."""
    q_lo = torch.zeros(q_views.shape[:2], dtype=torch.float32,
                       device=q_views.device)

    def score(start, size):
        return tile_scores(q_views, q_lo, tags[start:start + size],
                           x_low[start:start + size])

    return dense_plain(score, x_low.shape[0], q_views.shape[0],
                       q_views.device, block)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gleanvec_ip_f32.argtypes = [p, p, p, i, i, i, i, i, p, p, i, p, p]
    lib.gleanvec_ip_f32.restype = ctypes.c_int
    lib.dense_bucket_workspace_bytes.argtypes = [i, i]
    lib.dense_bucket_workspace_bytes.restype = ctypes.c_longlong


def gleanvec_ip(q_views, tags, x_low):
    """``q_views (M, C, d)`` f32, ``tags (N,)`` i32, ``x_low (N, d)`` f32
    -> (M, N) f32. CPU tensors take :func:`gleanvec_ip_plain`; CUDA tensors
    launch the kernel (the bucketed tile of dense ``gleanvec_sq`` without
    an affine term) or raise."""
    from repro_torch import kernels as K
    if K.on_cpu(q_views, tags, x_low):
        return gleanvec_ip_plain(q_views, tags, x_low)
    K.check_cuda_inputs("gleanvec_ip", q_views=q_views, tags=tags,
                        x_low=x_low)
    if q_views.dtype != torch.float32 or x_low.dtype != torch.float32 \
            or tags.dtype != torch.int32:
        raise TypeError("gleanvec_ip takes f32 q_views/x_low and i32 tags")
    m, c, d = q_views.shape
    n = x_low.shape[0]
    if x_low.shape != (n, d) or tags.shape != (n,):
        raise ValueError(f"gleanvec_ip shapes {tuple(q_views.shape)}, "
                         f"{tuple(tags.shape)}, {tuple(x_low.shape)}")
    dev = q_views.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = K.load_library("dense_scores", _bind)
    buf, mc = dense_buffer(m, n, c, dev)
    s = K.splits(row_tiles=bucket_tiles(n, c),
                 query_blocks=-(-mc // K.GEMM_TILE_M), k=1, blocks_per_sm=3,
                 device=dev)
    ws = torch.empty(lib.dense_bucket_workspace_bytes(n, c),
                     dtype=torch.uint8, device=dev)
    err = lib.gleanvec_ip_f32(q_views.data_ptr(), tags.data_ptr(),
                              x_low.data_ptr(), m, c, d, n, s, ws.data_ptr(),
                              buf.data_ptr(), mc, out.data_ptr(),
                              K.current_stream(dev))
    K.check_launch("gleanvec_ip", err, lib)
    K.count_launch(gleanvec_ip)
    return out


gleanvec_ip.launches = 0
