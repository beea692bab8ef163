"""fm [recsys]: Factorization Machine, n_sparse=39 embed_dim=10,
pairwise <v_i, v_j> x_i x_j via the O(nk) sum-square trick.
[ICDM'10 (Rendle); paper] The port's copy of the reference's config."""
from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.models.recsys import FMConfig

ARCH_ID = "fm"
FAMILY = "recsys"
MODEL = "fm"
SHAPES = dict(RECSYS_SHAPES)
SKIPS = {}


def make_config(smoke: bool = False) -> FMConfig:
    if smoke:
        return FMConfig(name=ARCH_ID + "-smoke", n_sparse=5,
                        vocab_per_field=1000, embed_dim=10)
    return FMConfig(name=ARCH_ID)   # 39 fields x 100k hashed, k=10
