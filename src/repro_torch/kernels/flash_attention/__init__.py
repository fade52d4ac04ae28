"""GQA flash attention: `ops.flash_attention` (dispatch), `kernel` (the CUDA
kernel `csrc/flash_attention.cu`), `ref` (the plain versions)."""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
