"""llama3.2-3b — 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-3B; unverified]"""
from repro_torch.configs.base import LmArch

ARCH = LmArch(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    source="hf:meta-llama/Llama-3.2-3B",
)
