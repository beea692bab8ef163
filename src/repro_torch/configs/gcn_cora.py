"""gcn-cora [gnn]: n_layers=2 d_hidden=16 aggregator=mean norm=sym.
[arXiv:1609.02907; paper] The port's copy of the reference's config.

Shape-specific graph stats come from the assignment (Cora, Reddit-like
minibatch, ogbn-products, batched molecules); feature widths / class counts
follow the public datasets. The graphs themselves are drawn from a seed
(``train/data.py``); nothing is downloaded.
"""
from repro_torch.models.gnn import GCNConfig

ARCH_ID = "gcn-cora"
FAMILY = "gnn"
SHAPES = {
    "full_graph_sm": {"kind": "gnn_full", "n_nodes": 2708,
                      "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
    "minibatch_lg": {"kind": "gnn_minibatch", "n_nodes": 232965,
                     "n_edges": 114615892, "batch_nodes": 1024,
                     "fanouts": (15, 10), "d_feat": 602, "n_classes": 41},
    "ogb_products": {"kind": "gnn_full", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
    "molecule": {"kind": "gnn_batched", "n_nodes": 30, "n_edges": 64,
                 "batch": 128, "d_feat": 16, "n_classes": 1},
}
SKIPS = {}


def make_config(smoke: bool = False, d_feat: int = 1433,
                n_classes: int = 7) -> GCNConfig:
    if smoke:
        return GCNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16,
                         d_feat=min(d_feat, 64), n_classes=n_classes)
    return GCNConfig(name=ARCH_ID, n_layers=2, d_hidden=16, d_feat=d_feat,
                     n_classes=n_classes)
