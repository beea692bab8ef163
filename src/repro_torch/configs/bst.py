"""bst [recsys]: Behavior Sequence Transformer (Alibaba): embed_dim=32
seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256.
[arXiv:1905.06874; paper] The port's copy of the reference's config."""
from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.models.recsys import BSTConfig

ARCH_ID = "bst"
FAMILY = "recsys"
MODEL = "bst"
SHAPES = dict(RECSYS_SHAPES)
SKIPS = {}


def make_config(smoke: bool = False) -> BSTConfig:
    if smoke:
        return BSTConfig(name=ARCH_ID + "-smoke", n_items=1000, seq_len=8,
                         mlp=(64, 32, 1))
    return BSTConfig(name=ARCH_ID, n_items=4_000_000, seq_len=20,
                     embed_dim=32, n_heads=8, n_blocks=1,
                     mlp=(1024, 512, 256, 1))
