"""Serving substrate: language-model prefill / decode steps, the WMD
query service, the async admission layer
(request coalescer + load generators), AOT warmup, the offline
bulk-scoring driver, and the resilience layer (circuit breakers, retry,
brownout degradation; fault injection lives in serving.faultinject and is
test-only by contract).

Re-exports every public name of `repro.serving`, in the reference's order.
"""
from repro_torch.serving.coalescer import (CoalescerClosedError,
                                           QueryCoalescer, QueueFullError,
                                           ServingStats)
from repro_torch.serving.loadgen import LoadgenResult, closed_loop, open_loop
from repro_torch.serving.offline import (OfflineResult, load_query_file,
                                         run_offline, save_query_file)
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.serving.resilience import (BrownoutController,
                                            CircuitBreaker, DegradedResult,
                                            EngineGuard, ResiliencePolicy,
                                            ResilienceStats)
from repro_torch.serving.warmup import (ProgramShape, ShapeRegistry,
                                        WarmupReport,
                                        enable_compilation_cache,
                                        flush_compilation_cache,
                                        measure_compiles, warm)
from repro_torch.serving.wmd_service import WMDService

__all__ = ["build_serve_fns", "WMDService", "QueryCoalescer",
           "ServingStats", "QueueFullError", "CoalescerClosedError",
           "LoadgenResult", "open_loop", "closed_loop",
           "ProgramShape", "ShapeRegistry", "WarmupReport", "warm",
           "enable_compilation_cache", "flush_compilation_cache",
           "measure_compiles",
           "OfflineResult", "run_offline", "load_query_file",
           "save_query_file",
           "ResiliencePolicy", "EngineGuard", "DegradedResult",
           "CircuitBreaker", "BrownoutController", "ResilienceStats"]
