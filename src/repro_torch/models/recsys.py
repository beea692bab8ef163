"""The four recommender architectures (port of ``repro/models/recsys.py``).

  dlrm  MLPerf DLRM (Criteo 1TB): 13 dense features, 26 sparse tables at
        the MLPerf cardinalities (187,767,399 rows, padded to a multiple of
        512: 96.1 GB in f32 at embed_dim 128), dot interaction, bottom MLP
        13-512-256-128, top MLP 1024-1024-512-256-1, bf16 compute.
  fm    Factorization Machine (Rendle '10): 39 sparse fields, k = 10, the
        pairwise term through the O(nk) sum-square identity.
  bst   Behavior Sequence Transformer: a 20-item behaviour sequence, one
        transformer block (8 heads, d = 32), MLP 1024-512-256-1.
  mind  Multi-Interest Network with Dynamic routing: 4 interest capsules,
        3 routing iterations, label-aware attention.

Each namespace has ``init(gen, cfg, device=None)`` (random weights at the
reference's shapes and scales, drawn from ``gen`` on ``device``: the GPU
by default, and ``gen`` must live there), ``ctr_loss(params,
batch, cfg)`` (the training loss, differentiable under autograd) and
``user_embedding(params, batch, cfg)``, the query tower of candidate
retrieval (:mod:`repro_torch.serve.retrieval`). Params are dicts of
tensors, batches dicts of tensors (:mod:`repro_torch.train.data`).

The reference's ``rules: MeshRules`` argument and its ``constrain`` calls
are left out: they are layout hints that change no value
(``models/sharding.constrain``). ``dlrm.logits`` / ``ctr_loss`` take the
reference's ``lookup_fn`` hook (``embedding.make_sharded_lookup`` on a
mesh). BST's attention is the reference's plain einsum-softmax, not the
``flash_attention`` kernel, as in the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import embedding as emb_mod
from repro_torch.models import layers

__all__ = ["DLRMConfig", "FMConfig", "BSTConfig", "MINDConfig",
           "MLPERF_CRITEO_VOCAB_SIZES", "dlrm", "fm", "bst", "mind"]

# MLPerf DLRM (Criteo Terabyte) per-table cardinalities.
MLPERF_CRITEO_VOCAB_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36)


def _bce(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logit = logit.to(torch.float32)
    y = y.to(torch.float32)
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def _normal(gen: torch.Generator, shape, scale: float, dtype):
    """Draws on ``gen``'s device, which the inits have checked."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocab_sizes: Tuple[int, ...] = MLPERF_CRITEO_VOCAB_SIZES
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_total_vocab(self) -> int:
        """Rows padded to a multiple of 512 (even shards on any mesh axis);
        the pad rows are unused."""
        return -(-self.total_vocab // 512) * 512


class dlrm:
    Config = DLRMConfig

    @staticmethod
    def init(gen: torch.Generator, cfg: DLRMConfig, device=None):
        dev = layers.generator_device(gen, device)
        return {
            "table": _normal(gen, (cfg.padded_total_vocab, cfg.embed_dim),
                             cfg.embed_dim ** -0.5, cfg.param_dtype),
            "bot": layers.mlp_init(gen, (cfg.n_dense,) + cfg.bot_mlp,
                                   cfg.param_dtype, device=dev),
            "top": layers.mlp_init(
                gen, (cfg.n_sparse * (cfg.n_sparse + 1) // 2
                      + cfg.bot_mlp[-1],) + cfg.top_mlp, cfg.param_dtype,
                device=dev),
        }

    @staticmethod
    def offsets(cfg: DLRMConfig) -> np.ndarray:
        return emb_mod.pack_table_offsets(cfg.vocab_sizes)

    @staticmethod
    def forward(params, dense: torch.Tensor, emb: torch.Tensor,
                cfg: DLRMConfig) -> torch.Tensor:
        """``dense (B, 13)``, ``emb (B, 26, D)`` (looked up) -> (B,)
        logits in ``compute_dtype``."""
        cd = cfg.compute_dtype
        bot = layers.mlp_apply(params["bot"], dense.to(cd), act="relu",
                               final_act="relu", compute_dtype=cd)
        z = torch.cat([bot[:, None, :], emb.to(cd)], dim=1)  # (B, 27, D)
        inter = z @ z.transpose(1, 2)                         # (B, 27, 27)
        iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1,
                                    device=z.device)
        top_in = torch.cat([bot, inter[:, iu, ju]], dim=1)    # (B, 128+351)
        return layers.mlp_apply(params["top"], top_in, act="relu",
                                compute_dtype=cd)[:, 0]

    @staticmethod
    def logits(params, batch: Dict[str, torch.Tensor], cfg: DLRMConfig,
               lookup_fn=None) -> torch.Tensor:
        """(B,) logits of a batch: its packed ids looked up with
        ``lookup_fn(table, idx)`` where given (``make_sharded_lookup``'s on
        a mesh), else with a plain take."""
        idx = batch["sparse"] + _dlrm_offsets(cfg, batch["sparse"])
        emb = (emb_mod.embedding_lookup(params["table"], idx)
               if lookup_fn is None else lookup_fn(params["table"], idx))
        return dlrm.forward(params, batch["dense"], emb, cfg)

    @staticmethod
    def ctr_loss(params, batch: Dict[str, torch.Tensor], cfg: DLRMConfig,
                 lookup_fn=None) -> torch.Tensor:
        return _bce(dlrm.logits(params, batch, cfg, lookup_fn),
                    batch["label"])

    @staticmethod
    def user_embedding(params, batch, cfg: DLRMConfig) -> torch.Tensor:
        """The bottom MLP's output as the retrieval query, (B, D) f32 (no
        table is read)."""
        cd = cfg.compute_dtype
        return layers.mlp_apply(params["bot"], batch["dense"].to(cd),
                                act="relu", final_act="relu",
                                compute_dtype=cd).to(torch.float32)


def _dlrm_offsets(cfg: DLRMConfig, like: torch.Tensor) -> torch.Tensor:
    """(1, 26) row offsets of the packed tables on ``like``'s device,
    copied there once (a copy a step would be a host sync); a fake tensor
    (the dry run's trace) gets its own, so none outlives its fake mode."""
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(like, FakeTensor):
        return _offsets_on.__wrapped__(cfg, like.device)
    return _offsets_on(cfg, like.device)


@functools.lru_cache(maxsize=None)
def _offsets_on(cfg: DLRMConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dlrm.offsets(cfg), device=device)[None, :]


# ---------------------------------------------------------------------------
# FM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    vocab_per_field: int = 100_000
    embed_dim: int = 10
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field


class fm:
    Config = FMConfig

    @staticmethod
    def init(gen: torch.Generator, cfg: FMConfig, device=None):
        dev = layers.generator_device(gen, device)
        return {
            "v": _normal(gen, (cfg.total_vocab, cfg.embed_dim), 0.01,
                         cfg.param_dtype),
            "w": torch.zeros((cfg.total_vocab,), dtype=cfg.param_dtype,
                             device=dev),
            "w0": torch.zeros((), dtype=cfg.param_dtype, device=dev),
        }

    @staticmethod
    def _ids(sparse: torch.Tensor, cfg: FMConfig) -> torch.Tensor:
        offs = torch.arange(cfg.n_sparse, device=sparse.device) \
            * cfg.vocab_per_field
        return (sparse + offs[None, :]).long()

    @staticmethod
    def logits(params, sparse: torch.Tensor, cfg: FMConfig) -> torch.Tensor:
        """``sparse (B, F)`` field-local ids -> (B,) logits; the pairwise
        term by sum_{i<j} <v_i, v_j> = (||sum v_i||^2 - sum ||v_i||^2) / 2."""
        idx = fm._ids(sparse, cfg)
        v = params["v"][idx]                                  # (B, F, k)
        w = params["w"][idx]                                  # (B, F)
        sum_v = torch.sum(v, dim=1)
        pair = 0.5 * (torch.sum(sum_v * sum_v, dim=-1)
                      - torch.sum(v * v, dim=(1, 2)))
        return params["w0"] + torch.sum(w, dim=1) + pair

    @staticmethod
    def ctr_loss(params, batch, cfg: FMConfig) -> torch.Tensor:
        return _bce(fm.logits(params, batch["sparse"], cfg), batch["label"])

    @staticmethod
    def user_embedding(params, batch, cfg: FMConfig) -> torch.Tensor:
        """Sum of the fields' factors, (B, k) f32."""
        v = params["v"][fm._ids(batch["sparse"], cfg)]
        return torch.sum(v, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# BST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 4_000_000
    seq_len: int = 20
    embed_dim: int = 32
    n_heads: int = 8
    n_blocks: int = 1
    ff_dim: int = 128
    mlp: Tuple[int, ...] = (1024, 512, 256, 1)
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


class bst:
    Config = BSTConfig

    @staticmethod
    def init(gen: torch.Generator, cfg: BSTConfig, device=None):
        dev = layers.generator_device(gen, device)
        d, dt = cfg.embed_dim, cfg.param_dtype
        blocks = []
        for _ in range(cfg.n_blocks):
            blocks.append({
                "wq": _normal(gen, (d, d), d ** -0.5, dt),
                "wk": _normal(gen, (d, d), d ** -0.5, dt),
                "wv": _normal(gen, (d, d), d ** -0.5, dt),
                "wo": _normal(gen, (d, d), d ** -0.5, dt),
                "ln1": layers.rmsnorm_init(d, dt, dev),
                "ln2": layers.rmsnorm_init(d, dt, dev),
                "w_up": _normal(gen, (d, cfg.ff_dim), d ** -0.5, dt),
                "w_down": _normal(gen, (cfg.ff_dim, d), cfg.ff_dim ** -0.5,
                                  dt),
            })
        s1 = cfg.seq_len + 1
        return {
            "item_emb": _normal(gen, (cfg.n_items, d), 0.02, dt),
            "pos_emb": _normal(gen, (s1, d), 0.02, dt),
            "blocks": blocks,
            "mlp": layers.mlp_init(gen, (s1 * d,) + cfg.mlp, dt, device=dev),
        }

    @staticmethod
    def _encode(params, seq_items: torch.Tensor, target_item: torch.Tensor,
                cfg: BSTConfig) -> torch.Tensor:
        """``seq (B, S)``, ``target (B,)`` -> the block's output (B, S+1,
        d)."""
        cd = cfg.compute_dtype
        items = torch.cat([seq_items, target_item[:, None]], dim=1).long()
        h = params["item_emb"][items].to(cd) + params["pos_emb"].to(cd)[None]
        b, s, d = h.shape
        nh = cfg.n_heads
        dh = d // nh
        for blk in params["blocks"]:
            hn = layers.rmsnorm(blk["ln1"], h)
            q = (hn @ blk["wq"].to(cd)).reshape(b, s, nh, dh)
            k = (hn @ blk["wk"].to(cd)).reshape(b, s, nh, dh)
            v = (hn @ blk["wv"].to(cd)).reshape(b, s, nh, dh)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / dh ** 0.5
            probs = torch.softmax(scores.to(torch.float32), dim=-1).to(cd)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
            h = h + attn @ blk["wo"].to(cd)
            hn = layers.rmsnorm(blk["ln2"], h)
            ff = F.relu(hn @ blk["w_up"].to(cd))
            h = h + ff @ blk["w_down"].to(cd)
        return h

    @staticmethod
    def logits(params, batch, cfg: BSTConfig) -> torch.Tensor:
        h = bst._encode(params, batch["seq"], batch["target"], cfg)
        return layers.mlp_apply(params["mlp"], h.reshape(h.shape[0], -1),
                                act="relu",
                                compute_dtype=cfg.compute_dtype)[:, 0]

    @staticmethod
    def ctr_loss(params, batch, cfg: BSTConfig) -> torch.Tensor:
        return _bce(bst.logits(params, batch, cfg), batch["label"])

    @staticmethod
    def user_embedding(params, batch, cfg: BSTConfig) -> torch.Tensor:
        """Mean of the sequence positions' outputs (the target slot, filled
        with the last item, left out), (B, d) f32."""
        h = bst._encode(params, batch["seq"], batch["seq"][:, -1], cfg)
        return torch.mean(h[:, :-1], dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# MIND
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 4_000_000
    seq_len: int = 50
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    pow_p: float = 2.0          # label-aware attention sharpness
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


# Users a chunk of MIND's in-batch softmax: its (users, batch, K) f32
# similarities stay near 1 GiB at a batch of 262,144.
MIND_LOSS_CHUNK = 256


class mind:
    Config = MINDConfig

    @staticmethod
    def init(gen: torch.Generator, cfg: MINDConfig, device=None):
        layers.generator_device(gen, device)
        d = cfg.embed_dim
        return {
            "item_emb": _normal(gen, (cfg.n_items, d), 0.02, cfg.param_dtype),
            # the shared bilinear map S of the B2I routing
            "s": _normal(gen, (d, d), d ** -0.5, cfg.param_dtype),
        }

    @staticmethod
    def interests(params, seq: torch.Tensor, cfg: MINDConfig) -> torch.Tensor:
        """Behaviour-to-interest dynamic routing -> (B, K, d) capsules."""
        cd = cfg.compute_dtype
        e = params["item_emb"][seq.long()].to(cd)                # (B, S, d)
        eh = e @ params["s"].to(cd)
        eh32 = eh.to(torch.float32)
        b_logits = torch.zeros(e.shape[:2] + (cfg.n_interests,),
                               dtype=torch.float32, device=e.device)

        def squash(x):
            n2 = torch.sum(x * x, dim=-1, keepdim=True)
            return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)

        caps = None
        for _ in range(cfg.capsule_iters):
            c = torch.softmax(b_logits, dim=-1)                  # (B, S, K)
            caps = squash((c.to(cd).transpose(1, 2) @ eh).to(torch.float32))
            b_logits = b_logits + eh32 @ caps.transpose(1, 2)
        return caps                                              # (B, K, d)

    @staticmethod
    def score_against(caps: torch.Tensor, target_emb: torch.Tensor,
                      pow_p: float) -> torch.Tensor:
        """Label-aware attention: the softmax(p <cap, e>)-weighted capsule
        against the target, (B,)."""
        sims = torch.einsum("bkd,bd->bk", caps, target_emb)
        w = torch.softmax(pow_p * sims, dim=-1)
        user = torch.einsum("bk,bkd->bd", w, caps)
        return torch.sum(user * target_emb, dim=-1)

    @staticmethod
    def _chunk_loss(cu: torch.Tensor, t_emb: torch.Tensor, s: int,
                    pow_p: float) -> torch.Tensor:
        """The summed in-batch log-softmax of users ``s ..`` (capsules
        ``cu``) at their own targets."""
        n, k, d = cu.shape
        bsz = t_emb.shape[0]
        sims = (cu.reshape(-1, d) @ t_emb.T).reshape(n, k, bsz)
        w = torch.softmax(pow_p * sims, dim=1)
        scores = torch.sum(w * sims, dim=1)                      # (u, B)
        rows = torch.arange(n, device=cu.device)
        diag = scores[rows, s + rows]
        return torch.sum(diag - torch.logsumexp(scores, dim=1))

    @staticmethod
    def ctr_loss(params, batch, cfg: MINDConfig) -> torch.Tensor:
        """In-batch sampled softmax over the targets: every user against
        every in-batch target. The (B, B) score matrix is made
        ``MIND_LOSS_CHUNK`` users at a time (each row's log-softmax needs
        only its own row), so a batch of 262,144 needs no 275 GB matrix;
        each chunk runs under a checkpoint, so the backward makes its (u,
        K, B) similarities again rather than keeping every chunk's (~0.8
        GB a chunk at train_batch's 65,536 users). The arithmetic per row
        is the reference's."""
        caps = mind.interests(params, batch["seq"], cfg)          # (B, K, d)
        t_emb = params["item_emb"][batch["target"].long()].to(torch.float32)
        total = torch.zeros((), dtype=torch.float32, device=caps.device)
        for s in range(0, caps.shape[0], MIND_LOSS_CHUNK):
            total = total + checkpoint(
                mind._chunk_loss, caps[s:s + MIND_LOSS_CHUNK], t_emb, s,
                cfg.pow_p, use_reentrant=False, preserve_rng_state=False)
        return -total / caps.shape[0]

    @staticmethod
    def user_embedding(params, batch, cfg: MINDConfig) -> torch.Tensor:
        """The mean capsule, (B, d) f32 (max-sim retrieval would use all K
        interests)."""
        return torch.mean(mind.interests(params, batch["seq"], cfg), dim=1)
