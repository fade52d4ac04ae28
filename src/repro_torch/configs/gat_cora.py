"""gat-cora — 2 layers, 8 heads × d_hidden=8, attention aggregator.
[arXiv:1710.10903; paper]"""
from repro_torch.configs.base import GnnArch

ARCH = GnnArch(
    name="gat-cora",
    kind="gat",
    n_layers=2,
    d_hidden=8,
    n_heads=8,
    aggregators=("attn",),
    source="arXiv:1710.10903",
)
