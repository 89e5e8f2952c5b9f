"""PyTorch / CUDA port of the Sinkhorn-WMD serving engine (`repro`).

The JAX package `repro` is the reference; this package computes the same
functions with the same public names, argument names, shapes and dtypes,
on one NVIDIA GPU or on a single-controller mesh of them
(`repro_torch.launch.mesh`). It imports torch and numpy, never jax and
nothing of `repro`. Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"`` (or a mesh of CPU devices); on a CPU tensor every kernel wrapper in
`repro_torch.kernels.ops` runs its plain PyTorch version, on a CUDA tensor
it launches the hand-written kernel (`kernels/csrc/*.cu`) or raises.

Precision: every float32 matmul the port does runs in full fp32. The
matmul form of the cost matrix, ``|a|^2 + |b|^2 - 2ab``, cancels badly
near the diagonal; TF32 products would move the K rows far beyond the
parity tolerance against the reference. Importing the package pins it.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
