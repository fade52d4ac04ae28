"""EmbeddingBag over stacked tables: `ops.embedding_bag` (dispatch and
autograd), `kernel` (the CUDA kernel `csrc/embedding_bag.cu`), `ref` (the
plain version)."""
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref"]
