"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 -- llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified] The port's copy of the reference's config,
its training fields (query chunk, loss chunks, remat, gradient
accumulation) included."""
import torch

from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "h2o-danube-3-4b"
FAMILY = "lm"
SHAPES = dict(LM_SHAPES)   # SWA => long_500k runs (windowed KV cache)
TRAIN_ACCUM = 4
SKIPS = {}


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_head=16, d_ff=128, vocab=256, swa_window=16,
            q_chunk=32, loss_chunks=2, remat_policy="dots")
    return TransformerConfig(
        name=ARCH_ID, n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_head=120, d_ff=10240, vocab=32000, swa_window=4096,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        q_chunk=512, loss_chunks=8, remat_policy="nothing",
        remat_block=0)
