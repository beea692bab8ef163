"""LM generation loop: prefill once, then decode steps against the KV cache
(the reference's ``repro/serve/decode.py``).

The prefill writes its trailing window straight into the ring slots that
``decode_step`` reads (position p -> slot p % cache_len). The reference
copies it into slots 0..W-1 instead, which differs from the ring whenever
the prompt is longer than the window and not a multiple of it (ROADMAP
C3); both agree wherever the reference is right. Decode steps run
eagerly; capturing them in a CUDA graph is later work.

With ``mesh`` (a ``launch.mesh.Mesh`` over a live process group of its
size) each rank generates for its own blocks under the mesh's prefill
specs (``models/partitioned.py``): its parameter blocks, its batch block
of the prompt, its slice of the ring cache; the greedy pick reads the
whole vocab from the ranks' slices of the logits. Sampling over a mesh is
refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.partitioned import (NO_GROUPS, global_argmax,
                                            groups_on)
from repro_torch.models.sharding import MeshRules

__all__ = ["generate"]


def generate(params, prompt, n_new: int, cfg: tfm.TransformerConfig,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, device=None,
             mesh=None):
    """``prompt (B, S0)`` -> generated tokens ``(B, S0 + n_new)`` on
    ``device`` (the GPU unless ``device="cpu"``; ``params`` must live
    there). Greedy when ``temperature == 0``, else categorical sampling
    with ``generator`` (one seeded 0 on the device when None). The cache
    is sized for the full output (SWA archs keep only their window).

    With ``mesh``: ``params`` are this rank's blocks under
    ``transformer.param_specs(cfg, MeshRules.for_mesh(mesh))`` and
    ``prompt`` its block of the batch (a tensor, whose device type the
    mesh takes); returns this rank's block of the tokens. Greedy only:
    sampling over a mesh raises ``ValueError``."""
    if mesh is None:
        dev = resolve_device(device)
        prompt = torch.as_tensor(prompt, device=dev)
        groups, specs = NO_GROUPS, None
    else:
        if temperature > 0:
            raise ValueError("generate over a mesh is greedy only "
                             "(temperature 0)")
        dev = prompt.device
        rules = MeshRules.for_mesh(mesh)
        specs = tfm.param_specs(cfg, rules)
        groups = groups_on(mesh, rules, dev.type)
    b, s0 = prompt.shape
    logits, cache = tfm.prefill_step(params, prompt, cfg, groups, specs,
                                     ring=tfm.cache_len(cfg, s0 + n_new))
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0] \
                .to(prompt.dtype)
        return global_argmax(lg, groups).to(prompt.dtype)

    tokens = prompt
    last = pick(logits)
    for i in range(n_new):
        tokens = torch.cat([tokens, last[:, None]], dim=1)
        if i == n_new - 1:
            break
        logits, cache = tfm.decode_step(params, cache, last, s0 + i, cfg,
                                        groups, specs)
        last = pick(logits)
    return tokens
