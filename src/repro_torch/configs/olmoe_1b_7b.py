"""olmoe-1b-7b — 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE: 64 routed experts top-8, no shared expert, normalised top-k probs.
[arXiv:2409.02060; hf]"""
from repro_torch.configs.base import LmArch
from repro_torch.models.moe import MoEConfig

ARCH = LmArch(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(
        num_experts=64,
        top_k=8,
        d_ff_expert=1024,
        d_ff_shared=0,
        norm_topk=True,
        capacity_factor=1.25,
    ),
    source="arXiv:2409.02060",
)
