"""Attention of the LM, from the reference's ``repro/models/attention.py``.

* ``chunked_attention`` -- the differentiable form that training runs
  (the reference's own), in plain torch under autograd on the CPU and on
  the card alike: the scores are made ``q_chunk`` queries at a time, one
  (B, H, qc, S) f32 tile each (autograd keeps each tile's probabilities
  for the backward, as the reference's scan keeps its residuals). The reference's ``flash_attention`` is forward
  only and has no backward, so neither has a kernel here.
* ``prefill_attention`` -- the prompt's causal (and sliding-window)
  attention, lowered to the hand-written kernel
  :func:`repro_torch.kernels.flash_attention`, which the reference names
  its serving/forward path. Its plain version is the CPU path.
* ``decode_attention`` -- one new token against a KV cache (plain torch;
  the reference has no kernel for it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention

__all__ = ["chunked_attention", "prefill_attention", "decode_attention",
           "decode_attention_partial"]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512) -> torch.Tensor:
    """``q (B, S, H, dh)``, ``k/v (B, S, KV, dh)`` -> (B, S, H, dh), as the
    reference computes it: GQA by repeating K and V up to H heads; per
    chunk of ``q_chunk`` queries the scores in f32 on ``q * scale``, the
    causal and window mask at ``NEG_INF``, the softmax in f32, then the
    probabilities cast to q's type for the product with V (in q's type).
    The reference pads the last chunk with zero queries and drops their
    rows; here the last chunk is shorter, with the same output. A
    tensor-parallel rank passes its local q heads and the KV heads
    ``partitioned.local_kv`` maps them to: a whole GQA group of q heads a
    KV head, or one KV head a q head (repeats allowed) where the heads
    cut across ranks."""
    b, s, h, dh = q.shape
    group = h // k.shape[2]
    scale = 1.0 / float(dh) ** 0.5
    q_chunk = min(q_chunk, s)
    if group > 1:
        k = k.repeat_interleave(group, dim=2)             # (B, S, H, dh)
        v = v.repeat_interleave(group, dim=2)
    kf = k.to(torch.float32)
    vq = v.to(q.dtype)
    k_pos = torch.arange(s, device=q.device)
    outs = []
    for c0 in range(0, s, q_chunk):
        q_c = q[:, c0:c0 + q_chunk]                       # (B, qc, H, dh)
        scores = torch.einsum("bqhd,bshd->bhqs",
                              q_c.to(torch.float32) * scale, kf)
        q_pos = torch.arange(c0, c0 + q_c.shape[1], device=q.device)
        mask = torch.ones((q_c.shape[1], s), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqs,bshd->bqhd", probs, vq))
    return torch.cat(outs, dim=1)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int] = None) -> torch.Tensor:
    """``q (B, S, H, dh)``, ``k/v (B, S, KV, dh)`` -> (B, S, H, dh), causal.
    The kernel reads the (B, heads, S, dh) views in place and writes its
    output in q's layout, so no copy is made either way."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=window)
    return out.transpose(1, 2)


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor):
    """One step's scores in f32 on ``q * scale``: ``q (B, H, dh)``, caches
    ``(B, S, KV, dh)`` -> (scores (B, KV, G, S), values (B, KV, S, dh) in
    f32)."""
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    scale = 1.0 / float(dh) ** 0.5
    qr = q.reshape(b, kv, h // kv, dh).to(torch.float32) * scale
    # f32 copies of the caches made straight into (B, KV, S, dh): one copy
    # each, and both products take them without another
    kf, vf = (c.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
              for c in (k_cache, v_cache))
    return qr @ kf.transpose(-1, -2), vf


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """One-step attention: ``q (B, H, dh)``, caches ``(B, S, KV, dh)``;
    ``length``: the number of valid cache entries (int, or a (B,)
    tensor). Scores in f32 on ``q * scale``, output in q's type."""
    b, h, dh = q.shape
    s = k_cache.shape[1]
    scores, vf = _decode_scores(q, k_cache, v_cache)      # (B, KV, G, S)
    pos = torch.arange(s, device=q.device)
    if isinstance(length, torch.Tensor):    # an int stays on the host:
        length = length.to(q.device).reshape(-1, 1)    # no copy, no sync
    valid = pos[None, :] < length                         # (B or 1, S)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ vf                                      # (B, KV, G, dh)
    return out.reshape(b, h, dh).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, valid: torch.Tensor):
    """:func:`decode_attention` over one slice of the cache, before the
    softmax's sums meet: ``valid (S,)`` the slice's filled positions ->
    (m, l, o), its largest score (..., 1), its sum of ``exp(score - m)``
    (..., 1) and of ``exp(score - m) v`` (..., dh), shaped (B, KV, G, .)
    for ``partitioned.lse_combine``."""
    scores, vf = _decode_scores(q, k_cache, v_cache)
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m).masked_fill(~valid, 0.0)
    return m, e.sum(dim=-1, keepdim=True), e @ vf
