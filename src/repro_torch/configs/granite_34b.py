"""granite-34b — 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
llama-arch code model.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import LmArch

ARCH = LmArch(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # MQA
    d_ff=24576,
    vocab=49152,
    source="arXiv:2405.04324",
)
