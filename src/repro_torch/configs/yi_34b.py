"""yi-34b — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import LmArch

ARCH = LmArch(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    source="arXiv:2403.04652",
)
