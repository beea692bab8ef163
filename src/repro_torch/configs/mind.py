"""mind [recsys]: Multi-Interest Network with Dynamic routing: embed_dim=64
n_interests=4 capsule_iters=3. [arXiv:1904.08030; unverified] The port's
copy of the reference's config."""
from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.models.recsys import MINDConfig

ARCH_ID = "mind"
FAMILY = "recsys"
MODEL = "mind"
SHAPES = dict(RECSYS_SHAPES)
SKIPS = {}


def make_config(smoke: bool = False) -> MINDConfig:
    if smoke:
        return MINDConfig(name=ARCH_ID + "-smoke", n_items=1000, seq_len=8,
                          embed_dim=16)
    return MINDConfig(name=ARCH_ID, n_items=4_000_000, seq_len=50,
                      embed_dim=64, n_interests=4, capsule_iters=3)
