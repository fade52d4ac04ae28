"""pna — 4 layers, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation.  [arXiv:2004.05718; paper]"""
from repro_torch.configs.base import GnnArch

ARCH = GnnArch(
    name="pna",
    kind="pna",
    n_layers=4,
    d_hidden=75,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
    source="arXiv:2004.05718",
)
