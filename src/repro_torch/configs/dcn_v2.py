"""dcn-v2 — 13 dense + 26 sparse features, embed_dim=16, 3 cross layers,
MLP 1024-1024-512, cross interaction.  [arXiv:2008.13535; paper]"""
from repro_torch.configs.base import RecsysArch

ARCH = RecsysArch(
    name="dcn-v2",
    n_dense=13,
    n_sparse=26,
    embed_dim=16,
    rows_per_table=1_000_000,
    n_cross_layers=3,
    mlp_dims=(1024, 1024, 512),
    source="arXiv:2008.13535",
)
