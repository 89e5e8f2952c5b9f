"""Distribution substrate: elasticity and fault tolerance.

Re-exports the reference's `repro.distributed` modules that the port has.
Not ported yet: `partitioning` (the LM substrate's sharding rules, ROADMAP
Queue 1, item 5).
"""
from repro_torch.distributed import elastic, fault_tolerance

__all__ = ["elastic", "fault_tolerance"]
