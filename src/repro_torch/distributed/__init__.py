"""Distribution substrate: partitioning rules, fault tolerance, elasticity.

Re-exports the reference's `repro.distributed` modules, in its order.
"""
from repro_torch.distributed import elastic, fault_tolerance, partitioning

__all__ = ["elastic", "fault_tolerance", "partitioning"]
