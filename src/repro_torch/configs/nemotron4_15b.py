"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 -- GQA + squared-ReLU MLP (no GLU). [arXiv:2402.16819;
unverified] The port's copy of the reference's config, its training
fields included."""
import torch

from repro_torch.configs.lm_common import FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "nemotron-4-15b"
FAMILY = "lm"
SHAPES = {k: v for k, v in LM_SHAPES.items() if k != "long_500k"}
TRAIN_ACCUM = 8
SKIPS = dict(FULL_ATTN_LONG_SKIP)


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
            act="squared_relu", glu=False, q_chunk=32, loss_chunks=2,
            remat_policy="dots")
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=24576, vocab=256000, act="squared_relu", glu=False,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        q_chunk=512, loss_chunks=16, remat_policy="nothing",
        remat_block=0)
