"""The paper's own workload as a config: the Sinkhorn-WMD query service.

A copy of `repro.configs.sinkhorn_wmd`.

Shapes (paper section III-B2 scaled up per its "database of 5M documents"
motivation):
  paper_5k  -- the paper's measured dataset: V=100k, w=300, N=5000,
               nnz ~ 173k (nnz_max 128), v_r bucket 32, 15 iterations.
  prod_5m   -- the paper's motivating scale: N = 5M docs, same vocab.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WMDConfig:
    name: str
    vocab_size: int
    embed_dim: int
    num_docs: int
    nnz_max: int          # padded ELL slots per doc (pre vocab-bucketing)
    v_r: int              # query bucket size (padded)
    lamb: float
    max_iter: int
    num_queries: int = 1  # simultaneous query batch (vmapped)


def config(shape: str = "paper_5k") -> WMDConfig:
    if shape == "paper_5k":
        return WMDConfig(name="sinkhorn-wmd/paper_5k", vocab_size=100_000,
                         embed_dim=300, num_docs=5_000, nnz_max=128, v_r=32,
                         lamb=1.0, max_iter=15)
    if shape == "prod_5m":
        return WMDConfig(name="sinkhorn-wmd/prod_5m", vocab_size=100_000,
                         embed_dim=300, num_docs=5_242_880, nnz_max=128,
                         v_r=32, lamb=1.0, max_iter=15)
    raise ValueError(f"unknown wmd shape {shape!r}")


def smoke_config() -> WMDConfig:
    return WMDConfig(name="sinkhorn-wmd-smoke", vocab_size=512, embed_dim=32,
                     num_docs=64, nnz_max=16, v_r=8, lamb=1.0, max_iter=5)
