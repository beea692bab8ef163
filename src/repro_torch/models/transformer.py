"""Config-driven decoder-only LM for serving: prefill and decode steps, from
the reference's ``repro/models/transformer.py``.

Covers every LM of ``configs/``: GQA and sliding-window attention
(h2o-danube-3-4b), QKV bias (qwen2-72b), squared-ReLU without a GLU
(nemotron-4-15b), and mixture-of-experts FFNs (grok-1-314b,
llama4-maverick-400b-a17b; ``models/moe.py``). Parameters are a dict of
stacked (L, ...) tensors mirroring the reference's tree, so
``repro_torch.convert`` carries them across one to one; the reference's
``scan`` over layers is a Python loop. Dtypes follow the reference at
every step: the residual stream in ``compute_dtype``, ``rmsnorm`` and
``rope`` in f32, the LM head a bf16 x bf16 product cast to f32 whatever
the compute dtype. The prompt's attention goes through the hand-written
``flash_attention`` kernel (``models.attention.prefill_attention``).

Not ported: sharding (``MeshRules``, ``constrain``, ``param_specs``;
ROADMAP A4) and training (``train_loss``, ``_chunked_xent``, remat and the
blocked layer layout; ROADMAP A2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe
from repro_torch.models.moe import MoEConfig

__all__ = ["TransformerConfig", "init", "cache_len", "init_cache",
           "prefill_step", "decode_step", "param_count"]


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "silu"
    glu: bool = True
    qkv_bias: bool = False
    swa_window: Optional[int] = None
    moe: Optional[MoEConfig] = None  # an MoE FFN in every layer if set
    rope_theta: float = 1e4
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def qkv_dims(self) -> Tuple[int, int]:
        return self.n_heads * self.d_head, self.n_kv_heads * self.d_head


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init(cfg: TransformerConfig, seed: int = 0, device=None):
    """Random parameters at the reference's scales (``_layer_init``), drawn
    on ``device`` from a seeded ``torch.Generator`` (the reference's
    ``jax.random`` draws other numbers from the same seed). An MoE config
    gets the reference's ``"moe"`` subtree (stacked (L, ...)) in place of
    the layer-level ``w_up`` / ``w_down`` / ``w_gate``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, n = cfg.param_dtype, cfg.n_layers
    dq, dkv = cfg.qkv_dims
    s = cfg.d_model ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dt).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    p = {
        "ln1": {"scale": ones(n, cfg.d_model)},
        "wq": normal((n, cfg.d_model, dq), s),
        "wk": normal((n, cfg.d_model, dkv), s),
        "wv": normal((n, cfg.d_model, dkv), s),
        "wo": normal((n, dq, cfg.d_model), dq ** -0.5),
        "ln2": {"scale": ones(n, cfg.d_model)},
    }
    if cfg.moe is not None:
        p["moe"] = moe.moe_init(cfg.d_model, cfg.d_ff, cfg.moe, cfg.glu, dt,
                                gen, dev, n_stack=n)
    else:
        p["w_up"] = normal((n, cfg.d_model, cfg.d_ff), s)
        p["w_down"] = normal((n, cfg.d_ff, cfg.d_model), cfg.d_ff ** -0.5)
        if cfg.glu:
            p["w_gate"] = normal((n, cfg.d_model, cfg.d_ff), s)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, dq), dtype=dt, device=dev)
        p["bk"] = torch.zeros((n, dkv), dtype=dt, device=dev)
        p["bv"] = torch.zeros((n, dkv), dtype=dt, device=dev)
    return {
        "embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "layers": p,
        "final_norm": {"scale": ones(cfg.d_model)},
        "lm_head": normal((cfg.d_model, cfg.vocab), s),
    }


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def _layer(stacked, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Layer body (shared by prefill and decode)
# ---------------------------------------------------------------------------


def _embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  compute_dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def _qkv(p, cfg: TransformerConfig, h: torch.Tensor):
    cd = cfg.compute_dtype
    q = h @ p["wq"].to(cd)
    k = h @ p["wk"].to(cd)
    v = h @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _mlp(p, cfg: TransformerConfig, h: torch.Tensor) -> torch.Tensor:
    """The FFN on ``h (..., D)``: dense, or the MoE layer on the flattened
    tokens (prefill's (B, S) in (batch, position) order; a decode step's B
    tokens one group), its auxiliary loss dropped as the reference's
    prefill and decode drop it."""
    cd = cfg.compute_dtype
    if cfg.moe is not None:
        return moe.moe_apply(p["moe"], h, cfg.moe, cfg.act, cfg.glu, cd)[0]
    up = h @ p["w_up"].to(cd)
    if cfg.glu:
        act = layers.activation(cfg.act, h @ p["w_gate"].to(cd)) * up
    else:
        act = layers.activation(cfg.act, up)
    return act @ p["w_down"].to(cd)


def _head(params, h: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: bf16 x bf16, the result cast to f32."""
    h = layers.rmsnorm(params["final_norm"], h)
    return (h.to(torch.bfloat16)
            @ params["lm_head"].to(torch.bfloat16)).to(torch.float32)


# ---------------------------------------------------------------------------
# Prefill (forward pass + KV cache build)
# ---------------------------------------------------------------------------


def cache_len(cfg: TransformerConfig, max_seq: int) -> int:
    if cfg.swa_window is not None:
        return min(cfg.swa_window, max_seq)
    return max_seq


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device=None):
    """Zero caches ``{"k", "v"}`` of shape (L, batch, cache_len, KV, dh)."""
    shape = (cfg.n_layers, batch, cache_len(cfg, max_seq), cfg.n_kv_heads,
             cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def prefill_step(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Forward over the prompt ``tokens (B, S)``: returns the last token's
    logits (B, V) f32 and the KV cache ``{"k", "v"}`` (L, B, keep, KV, dh)
    of the trailing ``keep = cache_len(cfg, S)`` positions (the window for
    SWA archs), in position order."""
    b, s = tokens.shape
    cd = cfg.compute_dtype
    nh, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = _embed_lookup(params["embed"], tokens, cd)
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    rot = layers.rope_tables(positions, dh, cfg.rope_theta)
    keep = cache_len(cfg, s)
    shape = (cfg.n_layers, b, keep, nkv, dh)
    cache = {"k": torch.empty(shape, dtype=cd, device=h.device),
             "v": torch.empty(shape, dtype=cd, device=h.device)}
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        q, k, v = _qkv(p, cfg, layers.rmsnorm(p["ln1"], h))
        q = layers.apply_rope(q.view(b, s, nh, dh), rot)
        k = layers.apply_rope(k.view(b, s, nkv, dh), rot)
        v = v.view(b, s, nkv, dh)
        attn = attention.prefill_attention(q, k, v, cfg.swa_window)
        h = h + attn.reshape(b, s, nh * dh) @ p["wo"].to(cd)
        h = h + _mlp(p, cfg, layers.rmsnorm(p["ln2"], h))
        cache["k"][i] = k[:, s - keep:]
        cache["v"][i] = v[:, s - keep:]
    return _head(params, h[:, -1]), cache


# ---------------------------------------------------------------------------
# Decode (one token, KV cache)
# ---------------------------------------------------------------------------


def decode_step(params, cache, tokens: torch.Tensor, pos: int,
                cfg: TransformerConfig):
    """One decode step: ``tokens (B,)`` at absolute position ``pos``.
    Writes the new keys and values into ``cache`` in place (slot ``pos %
    cache_len`` for SWA archs: a ring; ``pos`` otherwise) and returns
    (logits (B, V) f32, cache)."""
    b = tokens.shape[0]
    cd = cfg.compute_dtype
    nh, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = _embed_lookup(params["embed"], tokens, cd)            # (B, D)
    s_cache = cache["k"].shape[2]
    slot = pos % s_cache if cfg.swa_window is not None else pos
    length = min(pos + 1, s_cache)
    rot = layers.rope_tables(torch.full((b, 1), pos, device=h.device), dh,
                             cfg.rope_theta)
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        q, k, v = _qkv(p, cfg, layers.rmsnorm(p["ln1"], h))
        q = layers.apply_rope(q.view(b, 1, nh, dh), rot)[:, 0]
        k = layers.apply_rope(k.view(b, 1, nkv, dh), rot)[:, 0]
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, slot] = k.to(k_c.dtype)
        v_c[:, slot] = v.view(b, nkv, dh).to(v_c.dtype)
        attn = attention.decode_attention(q, k_c, v_c, length)
        h = h + attn.reshape(b, nh * dh) @ p["wo"].to(cd)
        h = h + _mlp(p, cfg, layers.rmsnorm(p["ln2"], h))
    return _head(params, h), cache
