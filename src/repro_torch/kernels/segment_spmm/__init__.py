"""Degree-binned ELL SpMM: `ops` (dispatch), `kernel` (the CUDA kernel's
build and launch), `ref` (plain PyTorch versions)."""
from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
from repro_torch.kernels.segment_spmm.ref import coo_spmm_ref, ell_spmm_ref, segment_spmm_ref

__all__ = ["ell_spmm", "segment_spmm", "ell_spmm_ref", "segment_spmm_ref", "coo_spmm_ref"]
