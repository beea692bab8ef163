"""Fused causal / sliding-window GQA attention (forward): CUDA kernels
(``csrc/flash_attention.cu``), their plain PyTorch version, and the wrapper.

Which kernel a call takes (``_variant``): bf16 with dh % 8 == 0, 64 < dh <=
128, 16-byte aligned bases and 16-byte multiple strides (the transformer's
(B, S, H, dh) views, danube's dh 120) -> ``flash_wgmma_kernel`` (wgmma fed
by TMA, 128-query by 128-key tiles; where the GQA group is even, two of its
heads a cluster of two blocks sharing each K / V tile); other bf16 shapes ->
``flash_bf16_kernel`` (mma.sync); f32 -> ``flash_f32_kernel`` (fp32 FMA).

Port of ``repro/kernels/flash_attention`` (TPU kernel ``flash_attention``;
the reference's ``ops.py`` routes it to its oracle off the TPU). Forward
only, as the reference's kernel: training needs a differentiable path
(later work)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF",
           "VARIANTS", "wgmma_work", "wgmma_profile", "PROFILE_PARTS"]

NEG_INF = -3.4e38       # the reference's mask value
MAX_DH = 128            # widest head the kernel takes (zero-padded to 32/64/128)
Q_CHUNK = 512           # queries a step of the plain version
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the entry point's variants (``flash_attention_fwd``'s first argument)
VARIANTS = ("flash_f32_kernel", "flash_bf16_kernel", "flash_wgmma_kernel")
WG_TILE_Q = 128         # queries a block of flash_wgmma_kernel (csrc FW_Q)
WG_TILE_K = 128         # keys a KV tile of it (csrc FW_K)
WG_ROWS = 64            # query rows of one consumer warpgroup


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, H, S, dh) and k, v "
                         f"(B, KV, S, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, dh) or k.shape[1] < 1 \
            or h % k.shape[1]:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (H % KV == 0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """``q (B, H, S, dh)``, ``k/v (B, KV, S, dh)`` -> (B, H, S, dh) in q's
    type. Query position i attends to keys j <= i (``causal``) with
    i - j < ``window``; scores ``(q / sqrt(dh)) . k`` and softmax in f32,
    masked with NEG_INF as the reference. Blocked over ``Q_CHUNK`` queries,
    so one (B, H, Q_CHUNK, S) f32 score tile is live at a time."""
    _check(q, k, v, window)
    b, h, s, dh = q.shape
    kv = k.shape[1]
    group = h // kv
    scale = 1.0 / float(dh) ** 0.5
    kt = k.to(torch.float32).transpose(-1, -2)          # (B, KV, dh, S)
    vf = v.to(torch.float32)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    k_pos = torch.arange(s, device=q.device)
    for c0 in range(0, s, Q_CHUNK):
        c1 = min(s, c0 + Q_CHUNK)
        qc = (q[:, :, c0:c1].to(torch.float32) * scale).reshape(
            b, kv, group * (c1 - c0), dh)                # heads of a group
        scores = (qc @ kt).view(b, kv, group, c1 - c0, s)
        q_pos = torch.arange(c0, c1, device=q.device)[:, None]
        mask = torch.ones((c1 - c0, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos - k_pos[None, :]) < window
        scores.masked_fill_(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).view(b, kv, group * (c1 - c0), s)
        out[:, :, c0:c1] = (probs @ vf).view(b, h, c1 - c0, dh).to(q.dtype)
    return out


def _tma_view(t: torch.Tensor) -> bool:
    """A TMA map can read ``t`` (B, heads, S, dh) in bf16: 16-byte aligned
    base and, on every axis longer than 1, a positive stride of a multiple
    of 8 elements (16 bytes)."""
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st % 8 == 0)
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def _variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The kernel a call takes, an index of ``VARIANTS``: f32 the SIMT
    kernel; bf16 with dh % 8 == 0, 64 < dh <= 128 and TMA-able views the
    wgmma kernel; other bf16 shapes the mma.sync kernel."""
    if q.dtype == torch.float32:
        return 0
    dh = q.shape[-1]
    if dh % 8 == 0 and 64 < dh <= MAX_DH and all(
            _tma_view(t) for t in (q, k, v)):
        return 2
    return 1


def wgmma_work(s: int, causal: bool = True,
               window: Optional[int] = None) -> list:
    """``flash_wgmma_kernel``'s work for one (b, h), in launch order: one
    ``(q0, t0, t1, full)`` per query tile of ``WG_TILE_Q`` -- KV tiles
    ``[t0, t1)`` of ``WG_TILE_K`` keys (the kernel's ``kv_tiles``), heaviest
    first (causal: the last query tile first), and ``full[w][i]`` True when
    tile ``t0 + i`` needs no mask for consumer ``w``'s ``WG_ROWS`` rows (the
    kernel's ``FW_FULL``). A Python mirror of the kernel's plan, for the
    tests."""
    n_qt = -(-s // WG_TILE_Q)
    order = range(n_qt - 1, -1, -1) if causal else range(n_qt)
    work = []
    for qt in order:
        q0 = qt * WG_TILE_Q
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(s, q0 + WG_TILE_Q) if causal else s
        t0, t1 = lo // WG_TILE_K, -(-hi // WG_TILE_K)
        full = []
        for w in range(WG_TILE_Q // WG_ROWS):
            r0 = q0 + WG_ROWS * w
            full.append([
                k0 + WG_TILE_K <= s
                and (not causal or k0 + WG_TILE_K - 1 <= r0)
                and (not window or r0 + WG_ROWS - 1 - k0 < window)
                for k0 in range(t0 * WG_TILE_K, t1 * WG_TILE_K, WG_TILE_K)])
        work.append((q0, t0, t1, full))
    return work


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [i, i, p, p, p, p] + [ll] * 12 \
        + [i] * 7 + [p, p]
    lib.flash_attention_fwd.restype = ctypes.c_int


ENCODE_ERROR = 10000    # + the CUresult of a TMA map that failed to encode
# the wgmma kernel's clock64 profile (csrc FP_*): the whole consumer, then
# waiting for Q / K / V, waiting its turn, issuing, waiting for S, the
# softmax, waiting for P V, rescale and pack, the epilogue
PROFILE_PARTS = ("kernel", "data", "turn", "issue", "wait_s", "softmax",
                 "wait_pv", "pack", "store")


def _launch(lib, variant, q, k, v, out, causal, window, clocks=None):
    from repro_torch import kernels as K
    b, h, s, dh = q.shape
    err = lib.flash_attention_fwd(
        variant, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], b, h, k.shape[1], s, dh,
        int(causal), 0 if window is None else int(window),
        None if clocks is None else clocks.data_ptr(),
        K.current_stream(q.device))
    if err >= ENCODE_ERROR:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - ENCODE_ERROR}")
    K.check_launch("flash_attention", err, lib)


def wgmma_profile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> dict:
    """One run of ``flash_wgmma_kernel`` on CUDA tensors that it takes,
    profiled: {part: cycles} of ``PROFILE_PARTS``, thread 0 of each consumer
    warpgroup's ``clock64`` summed over the blocks. For timing only: not
    counted in ``flash_attention.launches``."""
    from repro_torch import kernels as K
    _check(q, k, v, window)
    if _variant(q, k, v) != 2:
        raise ValueError("wgmma_profile: these inputs do not take "
                         "flash_wgmma_kernel")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    clocks = torch.zeros(len(PROFILE_PARTS), dtype=torch.int64,
                         device=q.device)
    _launch(K.load_library("flash_attention", _bind), 2, q, k, v, out,
            causal, window, clocks)
    return dict(zip(PROFILE_PARTS, clocks.tolist()))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """``q (B, H, S, dh)``, ``k/v (B, KV, S, dh)`` -> (B, H, S, dh), the
    function of :func:`flash_attention_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel that ``_variant`` picks (bf16 on
    the tensor cores, f32 on fp32 FMA; dh <= 128) or raise. Inputs may be
    strided views with a contiguous last dim (e.g. ``x.transpose(1, 2)`` of
    a (B, S, H, dh) tensor); the output takes q's memory layout."""
    from repro_torch import kernels as K
    _check(q, k, v, window)
    if K.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, window)
    cur = torch.cuda.current_device()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.index != cur:
            raise ValueError(f"flash_attention: {name} is on {t.device}, the "
                             f"current device is cuda:{cur}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError("flash_attention takes q, k, v of one type, "
                            f"bf16 or f32; got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             "contiguous")
    dh = q.shape[-1]
    if dh > MAX_DH:
        raise ValueError(f"flash_attention kernel takes dh <= {MAX_DH}, "
                         f"got {dh}")
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _launch(K.load_library("flash_attention", _bind), _variant(q, k, v), q,
            k, v, out, causal, window)
    K.count_launch(flash_attention)
    return out


flash_attention.launches = 0
