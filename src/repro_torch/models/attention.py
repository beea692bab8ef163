"""Attention of the LM, from the reference's ``repro/models/attention.py``.

* ``prefill_attention`` -- the prompt's causal (and sliding-window)
  attention, lowered to the hand-written kernel
  :func:`repro_torch.kernels.flash_attention`, which the reference names
  its serving/forward path. Its plain version is the CPU path; the
  reference's ``chunked_attention`` (the differentiable form) comes with
  training.
* ``decode_attention`` -- one new token against a KV cache (plain torch;
  the reference has no kernel for it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention

__all__ = ["prefill_attention", "decode_attention"]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int] = None) -> torch.Tensor:
    """``q (B, S, H, dh)``, ``k/v (B, S, KV, dh)`` -> (B, S, H, dh), causal.
    The kernel reads the (B, heads, S, dh) views in place and writes its
    output in q's layout, so no copy is made either way."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=window)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """One-step attention: ``q (B, H, dh)``, caches ``(B, S, KV, dh)``;
    ``length``: the number of valid cache entries (int, or a (B,)
    tensor). Scores in f32 on ``q * scale``, output in q's type."""
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    group = h // kv
    scale = 1.0 / float(dh) ** 0.5
    qr = q.reshape(b, kv, group, dh).to(torch.float32) * scale
    # f32 copies of the caches made straight into (B, KV, S, dh): one copy
    # each, and both products take them without another
    kf, vf = (c.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
              for c in (k_cache, v_cache))
    scores = qr @ kf.transpose(-1, -2)                    # (B, KV, G, S)
    pos = torch.arange(s, device=q.device)
    if isinstance(length, torch.Tensor):    # an int stays on the host:
        length = length.to(q.device).reshape(-1, 1)    # no copy, no sync
    valid = pos[None, :] < length                         # (B or 1, S)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ vf                                      # (B, KV, G, dh)
    return out.reshape(b, h, dh).to(q.dtype)
