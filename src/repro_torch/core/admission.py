"""Request outcome constants (`repro.core.admission`'s public outcomes).

Only the constants the closed-cohort runtimes report are ported here; the
admission policies arrive with the event-driven runtime.
"""

#: per-request terminal outcomes reported via ``ExecutionResult.outcome``
SERVED = "served"      # ran to success / exhausted depth / planner stop
REJECTED = "rejected"  # turned away before any stage executed
SHED = "shed"          # aborted mid-flight (>=1 stage executed or in service)
FAILED = "failed"      # killed by the fault model (retries exhausted, or a
#                        fault-touched request whose budget then died)

#: the closed set of ``ExecutionResult.outcome`` values
OUTCOMES = (SERVED, REJECTED, SHED, FAILED)
