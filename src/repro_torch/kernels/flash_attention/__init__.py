"""Fused causal / sliding-window GQA attention (forward): CUDA kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, and the wrapper.

Port of ``repro/kernels/flash_attention`` (TPU kernel ``flash_attention``;
the reference's ``ops.py`` routes it to its oracle off the TPU). Forward
only, as the reference's kernel: training needs a differentiable path
(later work)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF"]

NEG_INF = -3.4e38       # the reference's mask value
MAX_DH = 128            # widest head the kernel takes (zero-padded to 32/64/128)
Q_CHUNK = 512           # queries a step of the plain version
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [i, p, p, p, p] + [ll] * 12 \
        + [i] * 7 + [p]
    lib.flash_attention_fwd.restype = ctypes.c_int


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """``q (B, H, S, dh)``, ``k/v (B, KV, S, dh)`` -> (B, H, S, dh), the
    function of :func:`flash_attention_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16 on the tensor cores, f32
    on fp32 FMA; dh <= 128) or raise. Inputs may be strided views with a
    contiguous last dim (e.g. ``x.transpose(1, 2)`` of a (B, S, H, dh)
    tensor); the output takes q's memory layout."""
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
    b, h, s, dh = q.shape
    if dh > MAX_DH:
        raise ValueError(f"flash_attention kernel takes dh <= {MAX_DH}, "
                         f"got {dh}")
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = K.load_library("flash_attention", _bind)
    err = lib.flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b, h, k.shape[1], s, dh, int(causal),
        0 if window is None else int(window), K.current_stream(q.device))
    K.check_launch("flash_attention", err, lib)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
