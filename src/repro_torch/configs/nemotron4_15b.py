"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 -- GQA + squared-ReLU MLP (no GLU). [arXiv:2402.16819;
unverified] The port's copy of the reference's config (its training-only
fields are not ported)."""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "nemotron-4-15b"


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
            act="squared_relu", glu=False)
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=24576, vocab=256000, act="squared_relu", glu=False,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
