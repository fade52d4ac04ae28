"""qwen2-moe-a2.7b — 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed top-4.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Qwen1.5-MoE-A2.7B details: moe_intermediate_size=1408 per routed expert,
shared_expert_intermediate_size=5632 (= 4×1408, the "4 shared"),
norm_topk_prob=False, sigmoid-gated shared expert."""
from repro_torch.configs.base import LmArch
from repro_torch.models.moe import MoEConfig

ARCH = LmArch(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_ff_expert=1408,
        d_ff_shared=5632,  # 4 shared experts fused into one 4× wide FFN
        norm_topk=False,
        capacity_factor=1.25,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
