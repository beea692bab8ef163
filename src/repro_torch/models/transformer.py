"""Config-driven decoder-only LM: the training loss, prefill and decode
steps, from the reference's ``repro/models/transformer.py``.

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

Training (``train_loss``) runs the reference's differentiable path under
autograd: ``attention.chunked_attention`` in every layer (the kernel has
no backward, in the reference either), each layer under the config's
remat policy (``torch.utils.checkpoint``), groups of ``remat_block``
layers under one more checkpoint (the reference's hierarchical remat),
and a cross entropy over ``loss_chunks`` chunks of the sequence, each
recomputed in the backward, so no (T, V) logits outlive their chunk.
The stacked layer tensors are split with ``unbind`` (one ``stack`` in the
backward, not a full-size zero tensor a layer). ``train_loss`` takes the
port's flat (L, ...) stacks or the reference's blocked (n_blocks, block,
...) ones, which ``blocked_view`` makes from the flat ones without a copy.

Sharding: ``param_logical_axes``, ``param_specs`` and ``cache_specs``
give the reference's partition specs of the parameter and cache trees
(``models/sharding.py``; the launch tooling's step bundles carry them),
and ``_embed_lookup`` takes a tensor-parallel process group for the
reference's vocab-parallel lookup (a rank's slice of the table, one
all-reduce). ``prefill_step``, ``decode_step`` and ``train_loss`` take
the process groups of a mesh (``partitioned.Groups``) and then run on one
rank's blocks under those specs with explicit collectives, autograd's
included (``models/partitioned.py`` sets out the layout); the
one-process step is the same body with every group of one rank. The
reference's ``constrain`` layout hints change no value and are left
out.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe
from repro_torch.models.moe import MoEConfig
from repro_torch.models.partitioned import (NO_GROUPS, Groups, copy_tp,
                                            gather_dim, local_kv, lse_combine,
                                            max_tp, sum_tp)
from repro_torch.models.sharding import (MeshRules, logical_to_spec,
                                         sum_over_group)

__all__ = ["TransformerConfig", "init", "cache_len", "init_cache",
           "prefill_step", "decode_step", "param_count", "train_loss",
           "blocked_layout", "blocked_view", "param_logical_axes",
           "param_specs", "cache_specs"]


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
    q_chunk: int = 512
    loss_chunks: int = 8
    remat_policy: str = "nothing"    # "nothing" | "dots" | "none"
    remat_block: int = 0             # >0: hierarchical remat over groups
                                     # of this many layers

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


def _map_axes(fn, tree_):
    """``fn`` on every logical-axes tuple of a nested dict."""
    if isinstance(tree_, dict):
        return {k: _map_axes(fn, v) for k, v in tree_.items()}
    return fn(tree_)


def param_logical_axes(cfg: TransformerConfig):
    """Logical per-dim axis names mirroring ``init``'s tree (the
    reference's blocked (n_blocks, block, ...) layout adds a leading None
    where ``blocked_layout``)."""
    lay = {
        "ln1": {"scale": (None,)},
        "wq": (None, "fsdp", "tp"),
        "wk": (None, "fsdp", None),   # KV replicated over tp (n_kv < tp)
        "wv": (None, "fsdp", None),
        "wo": (None, "tp", "fsdp"),
        "ln2": {"scale": (None,)},
    }
    if cfg.qkv_bias:
        lay["bq"] = (None, "tp")
        lay["bk"] = (None, None)
        lay["bv"] = (None, None)
    if cfg.moe is not None:
        ep = cfg.moe.sharding == "ep"
        lay["moe"] = {
            "router": (None, "fsdp", None),
            "w_up": (None, "ep", "fsdp", None) if ep
            else (None, None, "fsdp", "tp"),
            "w_down": (None, "ep", None, "fsdp") if ep
            else (None, None, "tp", "fsdp"),
        }
        if cfg.glu:
            lay["moe"]["w_gate"] = lay["moe"]["w_up"]
    else:
        lay["w_up"] = (None, "fsdp", "tp")
        lay["w_down"] = (None, "tp", "fsdp")
        if cfg.glu:
            lay["w_gate"] = (None, "fsdp", "tp")
    if blocked_layout(cfg):
        lay = _map_axes(lambda t: (None,) + t, lay)
    return {"embed": ("vocab", None), "layers": lay,
            "final_norm": {"scale": (None,)}, "lm_head": (None, "vocab")}


def param_specs(cfg: TransformerConfig, rules: MeshRules):
    """``param_logical_axes`` under ``rules``: a tree of partition specs."""
    return _map_axes(lambda t: logical_to_spec(rules, t),
                     param_logical_axes(cfg))


def cache_specs(cfg: TransformerConfig, rules: MeshRules):
    """The KV cache's specs: batch over dp, the sequence over tp
    (flash-decoding), a leading None in the blocked layout."""
    logical = (None, "batch", "seq_tp", None, None)
    if blocked_layout(cfg):
        logical = (None,) + logical
    spec = logical_to_spec(rules, logical)
    return {"k": spec, "v": spec}


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# replicated over "model" but read only for the rank's local KV heads: their
# gradient is each rank's share, summed over "model" (``copy_tp``)
_KV_LEAVES = ("wk", "wv", "bk", "bv")


def _gathered(p, groups: Groups = NO_GROUPS, specs=None):
    """One layer's parameters ``p`` (the rank's blocks) as its step reads
    them: each dimension that ``groups``' fsdp axes cut all-gathered over
    them (``specs``: the layer's specs, read only where ``groups`` has
    fsdp axes), and the KV projections through ``copy_tp``."""
    out = {}
    for k, x in p.items():
        if isinstance(x, dict):
            out[k] = _gathered(x, groups, None if specs is None else specs[k])
            continue
        if k in _KV_LEAVES:
            x = copy_tp(x, groups)
        if groups.fsdp_axes:
            for d, entry in enumerate(tuple(specs[k])):
                if entry == groups.fsdp_axes:
                    x = gather_dim(x, d, groups.fsdp, groups.fsdp_size)
        out[k] = x
    return out


def _drop_lead(specs, n: int):
    """The spec tree of ``n`` leading dimensions indexed away (a layer of
    a stack)."""
    if isinstance(specs, dict):
        return {k: _drop_lead(v, n) for k, v in specs.items()}
    return tuple(specs)[n:]


def _layer(stacked, i: int, groups: Groups = NO_GROUPS, specs=None):
    """Layer ``i``'s parameters: views into the stacked tensors, gathered
    as :func:`_gathered` says (``specs``: the stacked tensors' specs, each
    led by the layer's None)."""
    def index(tree):
        return {k: index(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    return _gathered(index(stacked), groups,
                     None if specs is None else _drop_lead(specs, 1))


# ---------------------------------------------------------------------------
# Layer body (shared by prefill and decode)
# ---------------------------------------------------------------------------


def _embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  compute_dtype, tp_group=None) -> torch.Tensor:
    """``table[tokens]`` in ``compute_dtype``. With ``tp_group`` the
    reference's vocab-parallel lookup: ``table`` is this rank's slice of
    the vocab (rows ``[rank * V / tp, (rank + 1) * V / tp)``), ``tokens``
    its batch; each rank takes the tokens its slice holds, zeros the rest
    and one all-reduce over the group sums the slices."""
    if tp_group is None:
        return table[tokens.long()].to(compute_dtype)
    import torch.distributed as dist
    rows = table.shape[0]
    loc = tokens.long() - dist.get_rank(tp_group) * rows
    hit = (loc >= 0) & (loc < rows)
    emb = table[loc.clamp(0, rows - 1)].to(compute_dtype)
    emb = torch.where(hit[..., None], emb, torch.zeros_like(emb))
    return sum_over_group(emb, tp_group)


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


def _mlp(p, cfg: TransformerConfig, h: torch.Tensor,
         groups: Groups = NO_GROUPS, whole_aux: bool = False):
    """The FFN on ``h (..., D)``: dense, or the MoE layer on the flattened
    tokens (prefill's (B, S) in (batch, position) order; a decode step's B
    tokens one group). Returns (output, the MoE auxiliary loss or None):
    training adds it (``whole_aux``: over the whole batch), prefill and
    decode drop it as the reference's do. Under ``groups`` each rank's
    partial output (its FFN columns or, for an expert-parallel MoE, its
    experts) is summed over "model", and the MoE's groups of tokens are cut
    over the data ranks' whole batch."""
    cd = cfg.compute_dtype
    if cfg.moe is not None:
        out, aux = moe.moe_apply(p["moe"], h, cfg.moe, cfg.act, cfg.glu, cd,
                                 groups=groups, whole_aux=whole_aux)
        return sum_tp(out, groups), aux
    h = copy_tp(h, groups)
    up = h @ p["w_up"].to(cd)
    if cfg.glu:
        act = layers.activation(cfg.act, h @ p["w_gate"].to(cd)) * up
    else:
        act = layers.activation(cfg.act, up)
    return sum_tp(act @ p["w_down"].to(cd), groups), None


def _head(params, h: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: bf16 x bf16, the result cast to f32."""
    h = layers.rmsnorm(params["final_norm"], h)
    return (h.to(torch.bfloat16)
            @ params["lm_head"].to(torch.bfloat16)).to(torch.float32)


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def blocked_layout(cfg: TransformerConfig) -> bool:
    """The reference keeps a config's stacked layers as (n_blocks, block,
    ...) when hierarchical remat is on; here it decides the remat's
    grouping (and ``blocked_view``'s shapes)."""
    return (cfg.remat_block > 0 and cfg.n_layers % cfg.remat_block == 0
            and cfg.n_layers > cfg.remat_block)


def blocked_view(params, cfg: TransformerConfig):
    """``params`` with every stacked layer tensor viewed as the reference's
    blocked (n_blocks, block, ...) layout (no copy; the flat tree itself
    when the config is not blocked). Optimizer state made on this view has
    the reference's shapes, so its factored moments are the reference's."""
    if not blocked_layout(cfg):
        return params
    nb = cfg.n_layers // cfg.remat_block

    def view(tree):
        if isinstance(tree, dict):
            return {k: view(v) for k, v in tree.items()}
        return tree.view((nb, cfg.remat_block) + tuple(tree.shape[1:]))

    return {**params, "layers": view(params["layers"])}


def _unstack(stacked, n_layers: int, blocked: bool):
    """The ``n_layers`` per-layer parameter dicts of a stacked tree, views
    made by ``unbind`` (its backward is one ``stack`` a tensor)."""
    if isinstance(stacked, dict):
        kids = {k: _unstack(v, n_layers, blocked) for k, v in stacked.items()}
        return [{k: kids[k][i] for k in kids} for i in range(n_layers)]
    return (stacked.flatten(0, 1) if blocked else stacked).unbind(0)


def _layer_fwd(p, cfg: TransformerConfig, h: torch.Tensor, rot,
               aux: torch.Tensor, groups: Groups = NO_GROUPS, specs=None):
    """One decoder layer, training form, on ``h (B, S, D)``: returns (h,
    aux plus the layer's MoE auxiliary loss). Under ``groups`` ``p`` is the
    rank's blocks (``specs`` the layer's), gathered here, inside the
    remat, so the backward gathers them again (ZeRO-3); the layout is
    prefill's (``models/partitioned.py``)."""
    b, s, _ = h.shape
    cd = cfg.compute_dtype
    p = _gathered(p, groups, specs)
    q, k, v = _qkv(p, cfg, copy_tp(layers.rmsnorm(p["ln1"], h), groups))
    k = layers.apply_rope(k.view(b, s, cfg.n_kv_heads, cfg.d_head), rot)
    attn = _local_attention(
        q, k, v.view(b, s, cfg.n_kv_heads, cfg.d_head), rot, cfg, groups,
        functools.partial(attention.chunked_attention, causal=True,
                          window=cfg.swa_window, q_chunk=cfg.q_chunk))
    h = h + sum_tp(attn @ p["wo"].to(cd), groups)
    out, layer_aux = _mlp(p, cfg, layers.rmsnorm(p["ln2"], h), groups,
                          whole_aux=True)
    return h + out, aux if layer_aux is None else aux + layer_aux


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of products without batch
    dimensions (``mm``: the projections, FFN and router) and recompute the
    rest, batched products (attention, experts) included -- the
    reference's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint`` as every remat here runs it: the
    non-reentrant form, keeping no RNG state (the model draws no random
    numbers, and the CPU generator's state would be a host tensor a
    step)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def _remat(fn, policy: str):
    """``fn`` under the config's activation remat: "nothing" saves only
    its inputs and recomputes the rest in the backward; "dots" also saves
    ``_save_matmuls``' outputs; "none" saves everything (no checkpoint)."""
    if policy == "none":
        return fn
    if policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_matmuls)
        return functools.partial(_checkpoint, fn, context_fn=context)
    if policy != "nothing":
        raise ValueError(f"unknown remat policy {policy!r}")
    return functools.partial(_checkpoint, fn)


def _xent_chunk(h_c: torch.Tensor, w_head: torch.Tensor, l_c: torch.Tensor,
                groups: Groups = NO_GROUPS) -> torch.Tensor:
    """The summed cross entropy of one chunk: bf16 x bf16 logits cast to
    f32, ``logsumexp`` less the label's logit (a gather: the same f32 value
    as the reference's one-hot product). Under a "model" group ``w_head``
    is the rank's vocab slice: the largest logit (the shift) and the sum of
    exponentials are reduced over "model", and the label's logit comes from
    the rank whose slice holds it (one all-reduce of both sums)."""
    logits = (h_c.to(torch.bfloat16)
              @ w_head.to(torch.bfloat16)).to(torch.float32)
    if groups.tp_size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        label = logits.gather(-1, l_c.long()[..., None])[..., 0]
        return torch.sum(lse - label)
    v_loc = logits.shape[-1]
    top = max_tp(logits.detach().amax(dim=-1), groups)
    loc = l_c.long() - groups.tp_rank * v_loc
    hit = (loc >= 0) & (loc < v_loc)
    label = logits.gather(-1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    sums = sum_tp(torch.stack([
        torch.exp(logits - top[..., None]).sum(dim=-1),
        torch.where(hit, label, 0.0)]), groups)
    return torch.sum(top + torch.log(sums[0]) - sums[1])


def _chunked_xent(h: torch.Tensor, w_head: torch.Tensor,
                  labels: torch.Tensor, n_chunks: int,
                  groups: Groups = NO_GROUPS) -> torch.Tensor:
    """Mean cross entropy over ``n_chunks`` chunks of the sequence, each
    under a checkpoint: its (B, S / n_chunks, V) logits are made again in
    the backward and never outlive the chunk (under ``groups``: the rank's
    vocab slice of them, the mean over the rank's rows)."""
    b, s, _ = h.shape
    n_chunks = min(n_chunks, s)
    if s % n_chunks:
        raise ValueError(f"sequence {s} does not cut into {n_chunks} chunks")
    sc = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s, sc):
        total = total + _checkpoint(_xent_chunk, h[:, c:c + sc], w_head,
                                    labels[:, c:c + sc], groups)
    return total / (b * s)


def train_loss(params, batch: Dict[str, torch.Tensor],
               cfg: TransformerConfig, groups: Groups = NO_GROUPS,
               specs=None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (``tokens`` and
    ``labels``, (B, S)) plus the layers' MoE auxiliary loss over
    ``n_layers``, differentiable in ``params`` (flat (L, ...) layer stacks
    or ``blocked_view``'s).

    With ``groups`` (``partitioned.Groups`` of a live mesh) this is one
    rank's loss on its blocks: ``params`` under ``specs`` (``param_specs``
    of the same layout; read only where ``groups`` has fsdp axes),
    ``batch`` its rows. It returns the mean over the rank's rows plus the
    auxiliary loss of the whole batch, so the data ranks' mean is the
    one-process loss, and its backward leaves each leaf's whole gradient on
    every "model" rank (an fsdp leaf's summed over the data ranks:
    ``trainstep.make_train_step`` reduces the rest)."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    h = _embed_lookup(params["embed"], tokens, cfg.compute_dtype,
                      tp_group=groups.tp if groups.tp_size > 1 else None)
    rot = layers.rope_tables(
        torch.arange(s, device=h.device)[None, :].expand(b, s), cfg.d_head,
        cfg.rope_theta)
    stacked = params["layers"]
    blocked = stacked["wq"].ndim == 4
    per_layer = _unstack(stacked, cfg.n_layers, blocked)
    layer_specs = _drop_lead(specs["layers"], 2 if blocked else 1) \
        if groups.fsdp_axes else None

    def body(p, h, aux):
        return _layer_fwd(p, cfg, h, rot, aux, groups, layer_specs)

    layer = _remat(body, cfg.remat_policy)

    def run(group, h, aux):
        for p in group:
            h, aux = layer(p, h, aux)
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if blocked_layout(cfg):
        # hierarchical remat: only each block's input is kept; a block's
        # layers (under their own policy) are run again in the backward
        for g in range(0, cfg.n_layers, cfg.remat_block):
            h, aux = _checkpoint(run, per_layer[g:g + cfg.remat_block],
                                 h, aux)
    else:
        h, aux = run(per_layer, h, aux)
    h = copy_tp(layers.rmsnorm(params["final_norm"], h), groups)
    loss = _chunked_xent(h, params["lm_head"], labels, cfg.loss_chunks,
                         groups)
    return loss + aux / cfg.n_layers


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


def _q_cols(cfg: TransformerConfig, groups: Groups) -> Tuple[int, int]:
    """(first column, columns) of this rank's block of the q projection."""
    dq = cfg.n_heads * cfg.d_head
    if dq % groups.tp_size:
        raise ValueError(f"{dq} q columns do not cut into {groups.tp_size} "
                         "equal blocks")
    n = dq // groups.tp_size
    return groups.tp_rank * n, n


def _kv_heads(t: torch.Tensor, heads, dim: int) -> torch.Tensor:
    """``t``'s KV heads ``heads`` along ``dim``: ``t`` itself where they are
    all of them, a view where they run in order, else an index copy."""
    if heads == list(range(t.shape[dim])):
        return t
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return t.narrow(dim, heads[0], len(heads))
    return t.index_select(dim, torch.tensor(heads, device=t.device))


def _local_attention(q, k, v, rot, cfg: TransformerConfig, groups: Groups,
                     attend) -> torch.Tensor:
    """``q (B, S, n_cols)`` the rank's q columns, ``k / v (B, S, KV, dh)``
    every KV head (k roped) -> the rank's columns of the causal attention
    output (B, S, n_cols), ``attend(q, k, v)`` on (B, S, heads, dh) (the
    flash kernel in prefill, ``chunked_attention`` in training). Whole
    local heads are roped and attend the KV heads they map to; heads cut
    across ranks are gathered over "model" first, and the rank attends
    every head its columns touch."""
    b, s, _ = q.shape
    dh = cfg.d_head
    c0, n_cols = _q_cols(cfg, groups)
    if c0 % dh == 0 and n_cols % dh == 0:
        h0, n_q = c0 // dh, n_cols // dh
        qh = layers.apply_rope(q.view(b, s, n_q, dh), rot)
    else:
        h0, h1 = c0 // dh, -(-(c0 + n_cols) // dh)
        n_q = h1 - h0
        full = gather_dim(q, 2, groups.tp, groups.tp_size)
        qh = layers.apply_rope(full[:, :, h0 * dh:h1 * dh].reshape(
            b, s, n_q, dh), rot)
    heads, _ = local_kv(h0, n_q, cfg.n_heads, cfg.n_kv_heads)
    out = attend(qh, _kv_heads(k, heads, 2),
                 _kv_heads(v, heads, 2)).reshape(b, s, n_q * dh)
    return out if n_q * dh == n_cols else \
        out[:, :, c0 - h0 * dh:c0 - h0 * dh + n_cols]


def _ring_runs(s: int, keep: int, ring: int, off: int, n_loc: int):
    """The kept positions ``[s - keep, s)`` whose ring slot ``p % ring``
    lies in a rank's block of slots ``[off, off + n_loc)``, as runs
    (first position, first slot in the block, length): at most two a turn
    of the ring, copied as slices (no index tensor, no host copy)."""
    runs, p = [], s - keep
    while p < s:
        slot = p % ring
        n = min(s - p, ring - slot)                 # up to the ring's end
        lo, hi = max(slot, off), min(slot + n, off + n_loc)
        if lo < hi:
            runs.append((p + lo - slot, lo - off, hi - lo))
        p += n
    return runs


def prefill_step(params, tokens: torch.Tensor, cfg: TransformerConfig,
                 groups: Groups = NO_GROUPS, specs=None,
                 ring: Optional[int] = None):
    """Forward over the prompt ``tokens (B, S)``: returns the last token's
    logits (B, V) f32 and the KV cache ``{"k", "v"}`` (L, B, keep, KV, dh)
    of the trailing ``keep = cache_len(cfg, S)`` positions (the window for
    SWA archs), in position order. With ``ring`` the cache is instead a
    ring of ``ring`` slots (position p at slot ``p % ring``, unfilled
    slots zero), the layout ``decode_step`` reads.

    With ``groups`` (``partitioned.Groups`` of a live mesh) this is one
    rank's step on its blocks: ``params`` under ``specs``
    (``param_specs``; read only where ``groups`` has fsdp axes),
    ``tokens`` its batch block; it returns the logits over the rank's
    vocab slice and its sequence block of the cache (block ``tp_rank`` of
    the ``keep`` positions or of the ring)."""
    b, s = tokens.shape
    cd = cfg.compute_dtype
    nkv, dh = cfg.n_kv_heads, cfg.d_head
    h = _embed_lookup(params["embed"], tokens, cd,
                      tp_group=groups.tp if groups.tp_size > 1 else None)
    rot = layers.rope_tables(
        torch.arange(s, device=h.device)[None, :].expand(b, s), dh,
        cfg.rope_theta)
    keep = cache_len(cfg, s)
    n_slots = keep if ring is None else ring
    if n_slots % groups.tp_size:
        raise ValueError(f"a cache of {n_slots} positions does not cut "
                         f"into {groups.tp_size} equal blocks")
    n_loc = n_slots // groups.tp_size
    off = groups.tp_rank * n_loc
    runs = (((s - keep + off, 0, n_loc),) if ring is None else
            _ring_runs(s, keep, ring, off, n_loc))
    shape = (cfg.n_layers, b, n_loc, nkv, dh)
    make = torch.empty if ring is None else torch.zeros
    cache = {"k": make(shape, dtype=cd, device=h.device),
             "v": make(shape, dtype=cd, device=h.device)}
    layer_specs = specs["layers"] if groups.fsdp_axes else None
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i, groups, layer_specs)
        q, k, v = _qkv(p, cfg, layers.rmsnorm(p["ln1"], h))
        k = layers.apply_rope(k.view(b, s, nkv, dh), rot)
        v = v.view(b, s, nkv, dh)
        attn = _local_attention(
            q, k, v, rot, cfg, groups,
            functools.partial(attention.prefill_attention,
                              window=cfg.swa_window))
        h = h + sum_tp(attn @ p["wo"].to(cd), groups)
        h = h + _mlp(p, cfg, layers.rmsnorm(p["ln2"], h), groups)[0]
        for name, t in (("k", k), ("v", v)):
            for src, dst, n in runs:
                cache[name][i][:, dst:dst + n] = t[:, src:src + n]
        del p               # the layer's gathered weights, before the next
    return _head(params, h[:, -1]), cache


# ---------------------------------------------------------------------------
# Decode (one token, KV cache)
# ---------------------------------------------------------------------------


def _decode_attention(q, k, v, k_c, v_c, rot, at, cfg: TransformerConfig,
                      groups: Groups) -> torch.Tensor:
    """One step's attention for one layer: the new token's ``q (B,
    n_cols)`` (the rank's q columns), ``k`` (roped) / ``v`` (B, KV, dh)
    written into the caches ``k_c / v_c (B, S_l, KV, dh)`` at ``at`` ->
    the rank's columns of the output (B, n_cols). ``at``: (slot, length)
    in one process; (the slot within the rank's slice, whether the rank
    owns it, its slice's filled positions) under a "model" group, where q
    is gathered, every head attends the slice and the slices meet by
    their log-sum-exp."""
    b = q.shape[0]
    nh, dh = cfg.n_heads, cfg.d_head
    if groups.tp_size == 1:
        slot, length = at
        q = layers.apply_rope(q.view(b, 1, nh, dh), rot)[:, 0]
        k_c.index_copy_(1, slot, k.to(k_c.dtype)[:, None])
        v_c.index_copy_(1, slot, v.to(v_c.dtype)[:, None])
        return attention.decode_attention(q, k_c, v_c, length).reshape(
            b, nh * dh)
    here, owner, valid = at
    for c, new in ((k_c, k), (v_c, v)):
        old = c.index_select(1, here)
        c.index_copy_(1, here, torch.where(owner, new.to(c.dtype)[:, None],
                                           old))
    q = gather_dim(q, 1, groups.tp, groups.tp_size)
    q = layers.apply_rope(q.view(b, 1, nh, dh), rot)[:, 0]
    m, l_, o = attention.decode_attention_partial(q, k_c, v_c, valid)
    out = lse_combine(m, l_, o, groups.tp, groups.tp_size)
    c0, n_cols = _q_cols(cfg, groups)
    return out.reshape(b, nh * dh).to(q.dtype)[:, c0:c0 + n_cols]


def decode_step(params, cache, tokens: torch.Tensor, pos,
                cfg: TransformerConfig, groups: Groups = NO_GROUPS,
                specs=None):
    """One decode step: ``tokens (B,)`` at absolute position ``pos`` (an
    int, or a 0-d integer tensor as the reference's abstract argument; an
    int becomes one on the device, so the slot and length arithmetic stays
    there, no host sync). Writes the new keys and values into ``cache`` in
    place (slot ``pos % cache_len`` for SWA archs: a ring; ``pos``
    otherwise) and returns (logits (B, V) f32, cache); the reference
    returns a new cache.

    With ``groups`` (``partitioned.Groups`` of a live mesh) this is one
    rank's step on its blocks: ``params`` under ``specs`` (read only where
    ``groups`` has fsdp axes), ``cache`` its sequence block (L, B_l, S_l,
    KV, dh) of ``S_l * tp`` slots, ``tokens`` its batch block; only the
    rank whose block holds the slot writes it, and the logits are over the
    rank's vocab slice."""
    b = tokens.shape[0]
    cd = cfg.compute_dtype
    nkv, dh = cfg.n_kv_heads, cfg.d_head
    h = _embed_lookup(params["embed"], tokens, cd,
                      tp_group=groups.tp if groups.tp_size > 1 else None)
    s_loc = cache["k"].shape[2]
    s_cache = s_loc * groups.tp_size
    if not isinstance(pos, torch.Tensor):       # a fill on the device
        pos = torch.full((), pos, dtype=torch.int64, device=h.device)
    pos = pos.to(device=h.device, dtype=torch.int64)
    slot = (pos % s_cache if cfg.swa_window is not None else pos).reshape(1)
    length = torch.clamp(pos + 1, max=s_cache)
    positions = pos.reshape(1, 1).expand(b, 1)
    rot = layers.rope_tables(positions, dh, cfg.rope_theta)
    if groups.tp_size == 1:
        at = (slot, length)
    else:                   # this rank's slice of the sequence
        off = groups.tp_rank * s_loc
        here = slot - off
        at = (here.clamp(0, s_loc - 1), (here >= 0) & (here < s_loc),
              (off + torch.arange(s_loc, device=h.device)) < length)
    layer_specs = specs["layers"] if groups.fsdp_axes else None
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i, groups, layer_specs)
        q, k, v = _qkv(p, cfg, layers.rmsnorm(p["ln1"], h))
        k = layers.apply_rope(k.view(b, 1, nkv, dh), rot)[:, 0]
        attn = _decode_attention(q, k, v.view(b, nkv, dh), cache["k"][i],
                                 cache["v"][i], rot, at, cfg, groups)
        h = h + sum_tp(attn @ p["wo"].to(cd), groups)
        h = h + _mlp(p, cfg, layers.rmsnorm(p["ln2"], h), groups)[0]
        del p
    return _head(params, h), cache
