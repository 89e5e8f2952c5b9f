"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the `ops` dispatch layer (see `repro_torch.kernels.ops`); `ref` holds the
naive oracles. Re-exports `ops` and `ref`, as `repro.kernels` does."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
