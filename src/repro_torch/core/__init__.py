"""Formats, precompute, the sparse Sinkhorn engine, the K cache, guards
and the generic Sinkhorn OT solver (`ot`, the MoE router's).

Re-exports every public name of `repro.core`, in the reference's order.
"""
from repro_torch.core.cost_matrix import cdist, cdist_direct, cdist_matmul
from repro_torch.core.formats import (BucketedEll, EllDocs, bucket_by_length,
                                      ell_from_dense, ell_from_csc,
                                      ell_from_doc_lists, pad_docs,
                                      rebucket_for_vocab_shards)
from repro_torch.core.sinkhorn import (SinkhornPrecompute,
                                       assemble_precompute, m_rows,
                                       precompute, precompute_rows,
                                       select_query, sinkhorn_wmd_dense)
from repro_torch.core.guards import (GuardError, InvalidQueryError,
                                     NumericalError, check_distances,
                                     check_finite, check_km_rows,
                                     underflow_possible, validate_query)
from repro_torch.core.kcache import KCache, KCacheStats, MCache
from repro_torch.core.rwmd import (assemble_m_stripes, rwmd_bound_batch,
                                   rwmd_lower_bound, rwmd_query_side_bound)
from repro_torch.core.cascade import (centroid_bound_batch, doc_centroids,
                                      lc_rwmd_bound_batch, min_cost_vectors)
from repro_torch.core.sparse_sinkhorn import (
    BatchedSinkhornPrecompute, batched_sinkhorn_loop, pad_k,
    precompute_batch, sddmm, spmm, sddmm_batch, spmm_batch,
    sddmm_spmm_type1, sddmm_spmm_type2, sddmm_spmm_type1_batch,
    sddmm_spmm_type2_batch, sinkhorn_wmd_sparse, sinkhorn_wmd_sparse_batch,
    sinkhorn_wmd_sparse_batch_stripes)
from repro_torch.core.ot import (SinkhornResult, sinkhorn_divergence,
                                 sinkhorn_plan)
from repro_torch.core.convergence import (BatchConvergedWMD, ConvergedWMD,
                                          sinkhorn_wmd_converged,
                                          sinkhorn_wmd_converged_batch)

__all__ = [
    "cdist", "cdist_direct", "cdist_matmul",
    "BucketedEll", "EllDocs", "bucket_by_length",
    "ell_from_dense", "ell_from_csc", "ell_from_doc_lists",
    "pad_docs", "rebucket_for_vocab_shards",
    "SinkhornPrecompute", "assemble_precompute", "m_rows", "precompute",
    "precompute_rows", "select_query", "sinkhorn_wmd_dense",
    "GuardError", "InvalidQueryError", "NumericalError",
    "check_distances", "check_finite", "check_km_rows",
    "underflow_possible", "validate_query",
    "KCache", "KCacheStats", "MCache",
    "assemble_m_stripes", "rwmd_bound_batch", "rwmd_lower_bound",
    "rwmd_query_side_bound",
    "centroid_bound_batch", "doc_centroids", "lc_rwmd_bound_batch",
    "min_cost_vectors",
    "pad_k", "sddmm", "spmm", "sddmm_spmm_type1", "sddmm_spmm_type2",
    "sinkhorn_wmd_sparse",
    "BatchedSinkhornPrecompute", "precompute_batch",
    "batched_sinkhorn_loop", "sddmm_batch", "spmm_batch",
    "sddmm_spmm_type1_batch", "sddmm_spmm_type2_batch",
    "sinkhorn_wmd_sparse_batch", "sinkhorn_wmd_sparse_batch_stripes",
    "SinkhornResult", "sinkhorn_divergence", "sinkhorn_plan",
    "ConvergedWMD", "sinkhorn_wmd_converged",
    "BatchConvergedWMD", "sinkhorn_wmd_converged_batch",
]
