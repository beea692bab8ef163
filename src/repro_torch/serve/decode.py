"""LM generation loop: prefill once, then decode steps against the KV cache
(the reference's ``repro/serve/decode.py``).

The prefill's trailing window goes into the ring slots that ``decode_step``
reads (position p -> slot p % cache_len). The reference copies it into
slots 0..W-1 instead, which differs from the ring whenever the prompt is
longer than the window and not a multiple of it (ROADMAP C3); both agree
wherever the reference is right. Decode steps run eagerly; capturing them
in a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm

__all__ = ["generate"]


def generate(params, prompt, n_new: int, cfg: tfm.TransformerConfig,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, device=None):
    """``prompt (B, S0)`` -> generated tokens ``(B, S0 + n_new)`` on
    ``device`` (the GPU unless ``device="cpu"``; ``params`` must live
    there). Greedy when ``temperature == 0``, else categorical sampling
    with ``generator`` (one seeded 0 on the device when None). The cache
    is sized for the full output (SWA archs keep only their window)."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s0 = prompt.shape
    logits, cache = tfm.prefill_step(params, prompt, cfg)
    full = tfm.init_cache(cfg, b, s0 + n_new, device=dev)
    keep = cache["k"].shape[2]
    slots = torch.arange(s0 - keep, s0, device=dev) % full["k"].shape[2]
    for kk in ("k", "v"):
        full[kk][:, :, slots] = cache[kk]
    del cache
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0] \
                .to(prompt.dtype)
        return torch.argmax(lg, dim=-1).to(prompt.dtype)

    tokens = prompt
    last = pick(logits)
    for i in range(n_new):
        tokens = torch.cat([tokens, last[:, None]], dim=1)
        if i == n_new - 1:
            break
        logits, full = tfm.decode_step(params, full, last, s0 + i, cfg)
        last = pick(logits)
    return tokens
