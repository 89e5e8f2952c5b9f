"""Distribution substrate: fault tolerance.

Re-exports the reference's `repro.distributed` modules that the port has.
Not ported yet: `elastic` and `partitioning` (ROADMAP Queue 1, item 3).
"""
from repro_torch.distributed import fault_tolerance

__all__ = ["fault_tolerance"]
