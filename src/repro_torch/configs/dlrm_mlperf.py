"""dlrm-mlperf [recsys]: MLPerf DLRM benchmark config (Criteo 1TB):
n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 interaction=dot. [arXiv:1906.00091; paper]
The port's copy of the reference's config."""
from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.models.recsys import DLRMConfig

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"
MODEL = "dlrm"
SHAPES = dict(RECSYS_SHAPES)
SKIPS = {}


def make_config(smoke: bool = False) -> DLRMConfig:
    if smoke:
        return DLRMConfig(name=ARCH_ID + "-smoke",
                          vocab_sizes=(1000, 200, 50, 3000), embed_dim=16,
                          bot_mlp=(32, 16), top_mlp=(64, 32, 1))
    return DLRMConfig(name=ARCH_ID)   # exact MLPerf defaults
