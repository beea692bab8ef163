"""Shared building blocks of the LM (dict params), from the reference's
``repro/models/layers.py``: ``rmsnorm`` and ``rope`` compute in f32 and
return the input's type, as the reference does. ``dense``, the MLP towers
and ``embed_init`` wait for the recsys and GNN models."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "rope", "rope_tables", "apply_rope", "activation"]


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def rope_tables(positions: torch.Tensor, dh: int, theta: float = 1e4):
    """(cos, sin) of rotary embeddings for ``positions (..., S)``, each
    (..., S, 1, dh // 2) f32: the same for every layer, so a model builds
    them once per step."""
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate ``x (..., S, H, dh)`` by :func:`rope_tables`' (cos, sin)."""
    cos, sin = tables
    half = x.shape[-1] // 2
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embeddings, the half-split form (not interleaved). ``x (...,
    S, H, dh)``, ``positions (..., S)``."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                  # jax.nn.gelu's default: tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "squared_relu":          # Primer / nemotron-4
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name!r}")
