"""The paper's technique applied to MoE serving, in the PyTorch port:
expert→device placement from routing statistics (hot experts ≡ hub
vertices).

    PYTHONPATH=src python examples/torch_moe_expert_placement.py

1. train-style routing statistics with a power-law expert popularity
2. Algorithm 2 on experts: load-sorted cyclic deal into EP blocks
3. Algorithm 4 placement of blocks on a 2-D torus (greedy+2opt)
4. report all-to-all hop reduction vs identity placement

The same statistics and lines as `examples/moe_expert_placement.py`, through
`repro_torch.models.moe.expert_device_permutation` (host numpy).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.models.moe import expert_device_permutation

rng = np.random.default_rng(0)
N_DP, N_EXPERTS, EP = 16, 64, 16

# Zipf expert popularity + per-DP-shard affinity (locality structure the
# placement can exploit — e.g. domain-sharded corpora)
base = 1.0 / np.arange(1, N_EXPERTS + 1) ** 1.1
counts = np.zeros((N_DP, N_EXPERTS))
for d in range(N_DP):
    affinity = np.roll(base, d * 4)  # each DP shard prefers a rotated set
    counts[d] = rng.multinomial(100_000, affinity / affinity.sum())

perm, stats = expert_device_permutation(counts, EP)
print(f"experts={N_EXPERTS} EP blocks={EP}")
print(f"expert-block load balance (max/mean): {stats['load_balance']:.3f} "
      f"(Algorithm 2's cyclic deal over the popularity sort)")
print(f"all-to-all byte-hops: identity {stats['hops_identity']:.3f} → "
      f"placed {stats['hops_optimized']:.3f}  "
      f"({stats['hop_reduction']:.2f}× lower)")
print(f"block→device permutation: {perm.tolist()}")
