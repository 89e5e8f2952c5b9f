"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the `ops` dispatch layer (see `repro_torch.kernels.ops`)."""
