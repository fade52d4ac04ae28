"""gin-tu — 5 layers, d_hidden=64, sum aggregator, learnable eps.
[arXiv:1810.00826; paper]"""
from repro_torch.configs.base import GnnArch

ARCH = GnnArch(
    name="gin-tu",
    kind="gin",
    n_layers=5,
    d_hidden=64,
    aggregators=("sum",),
    source="arXiv:1810.00826",
)
