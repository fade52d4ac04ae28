"""Hand-written Hopper kernels of the port, one sub-package each
(`kernel` = build + launch, `ref` = plain PyTorch version, `ops` = dispatch)."""
