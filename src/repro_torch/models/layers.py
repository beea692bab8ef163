"""Shared building blocks of the LM and the recommenders (dict params),
from the reference's ``repro/models/layers.py``: ``rmsnorm`` and ``rope``
compute in f32 and return the input's type, as the reference does;
``dense`` and the MLP towers cast their operands to ``compute_dtype``
(bf16 by default, as the reference). Initializers draw from an explicit
``torch.Generator`` on ``device`` (default: the GPU; a generator on
another device raises), and the reference's ``jax.random`` draws other
numbers at the same scales."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

__all__ = ["generator_device", "dense_init", "dense", "rmsnorm_init", "rmsnorm", "rope",
           "rope_tables", "apply_rope", "activation", "mlp_init",
           "mlp_apply", "embed_init"]


def generator_device(gen: torch.Generator, device=None) -> torch.device:
    """The device an initializer draws on: ``resolve_device(device)``,
    which ``gen`` must live on (a CPU generator needs ``device="cpu"``)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type or dev.index not in (None,
                                                        gen.device.index):
        raise ValueError(f"the generator is on {gen.device}, the "
                         f"parameters on {dev}: draw them on one device")
    return gen.device


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, with_bias: bool = False, device=None):
    """``w (d_in, d_out)`` uniform in +-1/sqrt(d_in); ``b`` zeros."""
    dev = generator_device(gen, device)
    scale = 1.0 / math.sqrt(d_in)
    w = (torch.rand((d_in, d_out), generator=gen, device=dev,
                    dtype=torch.float32) * (2 * scale) - scale).to(dtype)
    if with_bias:
        return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=dev)}
    return {"w": w}


def dense(params, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` with both operands cast to ``compute_dtype``."""
    y = x.to(compute_dtype) @ params["w"].to(compute_dtype)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype,
                                device=resolve_device(device))}


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


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32,
             with_bias: bool = True, device=None):
    """Plain MLP tower: ``dims = (d_in, h1, ..., d_out)``."""
    dev = generator_device(gen, device)
    return {"layers": [dense_init(gen, dims[i], dims[i + 1], dtype,
                                  with_bias, dev)
                       for i in range(len(dims) - 1)]}


def mlp_apply(params, x: torch.Tensor, act: str = "relu",
              final_act: Optional[str] = None,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = dense(layer, x, compute_dtype)
        if i < n - 1:
            x = activation(act, x)
        elif final_act is not None:
            x = activation(final_act, x)
    return x


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None):
    """``table (vocab, d)``, normal at scale 0.02."""
    dev = generator_device(gen, device)
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  device=dev) * 0.02).to(dtype)}
