"""Picklable stage executors for the sharded tests' spawned ranks.

A rank of `repro_torch.dist.spawn` unpickles its case, executor
included, so the executor must be an object of an importable module, not
a closure: `oracle_sim`'s scenarios use `ScenarioExecutor`.  This module
imports numpy alone, so the ranks that import it load neither jax nor
`repro`.
"""
import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class ScenarioExecutor:
    """`oracle_sim.run_subject`'s executor: (success, cost, work) of
    request q at depth d, whatever the model."""

    succ: np.ndarray
    cost: np.ndarray
    work: np.ndarray

    def __call__(self, q, d, m, t):
        return bool(self.succ[q, d]), float(self.cost[q, d]), \
            float(self.work[q, d])
