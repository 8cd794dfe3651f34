"""Workflow-template DSL.

A workflow template is a typed description of an agentic workflow: a
sequence of *decision points* (configurable LLM stage invocations) produced
by unrolling the template's bounded loops, interleaved with fixed tool
stages.  This mirrors the paper's §3.1-3.2 setting: tool stages do not
branch the execution trie; configurable stages branch over their admissible
model set, and repeated loop iterations of the same logical stage are
distinct decision points.

The template is the *static* object; `repro.core.trie.Trie` enumerates the
feasible model-choice prefixes it induces, and `repro.core.runtime` executes
requests against it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A candidate model/endpoint (paper: L_i in the pool \\mathcal{L}).

    ``price`` is $ per 1k output tokens, ``base_latency``/``per_token_latency``
    parameterise the latency model, ``power`` is the latent quality score used
    only by the synthetic workload generator (real deployments measure it).
    ``engine`` names the serving backend the model is hosted on — the unit of
    load-aware latency adjustment (paper §4.3, \\delta_e(t)).
    """

    name: str
    price: float
    base_latency: float
    per_token_latency: float
    power: float
    engine: str = "default"


@dataclasses.dataclass(frozen=True)
class ToolStage:
    """A fixed (non-branching) stage: SQL execution, retrieval, etc."""

    name: str
    cost: float = 0.0
    latency: float = 0.05


@dataclasses.dataclass(frozen=True)
class DecisionPoint:
    """One configurable LLM stage *invocation* after loop unrolling.

    ``stage`` is the logical stage name ("generate", "repair", ...),
    ``iteration`` the loop iteration index (0-based), ``models`` the indices
    into the workflow's model pool admissible at this invocation, and
    ``tools_after`` the fixed tool stages executed after this invocation
    (their cost/latency fold into path metrics; paper §4.5 "Non-LLM stages").
    """

    stage: str
    iteration: int
    models: tuple[int, ...]
    tools_after: tuple[ToolStage, ...] = ()


@dataclasses.dataclass(frozen=True)
class WorkflowTemplate:
    """An unrolled workflow template.

    ``decisions[d]`` describes the (d+1)-th configurable invocation on any
    feasible path.  ``min_depth`` is the number of invocations that must run
    before the workflow may terminate (1 for generate-then-repair loops:
    generation always runs).  Every node at depth >= min_depth is a feasible
    terminating plan, matching the paper's path counts (e.g. NL2SQL-8:
    8 + 64 + 512 = 584 plans at depths 1..3).
    """

    name: str
    models: tuple[ModelSpec, ...]
    decisions: tuple[DecisionPoint, ...]
    min_depth: int = 1

    @property
    def max_depth(self) -> int:
        """Number of decision points (maximum workflow stages)."""
        return len(self.decisions)

    @property
    def n_models(self) -> int:
        """Size of the model pool decisions index into."""
        return len(self.models)

    def model_names(self) -> list[str]:
        """Model names in pool-index order."""
        return [m.name for m in self.models]

    def admissible(self, depth: int) -> tuple[int, ...]:
        """Admissible model indices for the decision at 0-based ``depth``."""
        return self.decisions[depth].models

    def tool_cost_latency(self, depth: int) -> tuple[float, float]:
        """Summed (cost, latency) of the tool calls that run after the
        decision at 0-based ``depth``."""
        tools = self.decisions[depth].tools_after
        return (sum(t.cost for t in tools), sum(t.latency for t in tools))


def make_refinement_workflow(
    name: str,
    models: Sequence[ModelSpec],
    *,
    gen_stage: str = "generate",
    repair_stage: str = "repair",
    max_repairs: int = 2,
    tool: ToolStage | None = None,
    gen_models: Sequence[int] | None = None,
    repair_models: Sequence[int] | None = None,
) -> WorkflowTemplate:
    """Generation + bounded repair loop (paper's NL2SQL workflows, Fig. 1)."""
    all_ids = tuple(range(len(models)))
    tools = (tool,) if tool is not None else ()
    decisions = [
        DecisionPoint(
            stage=gen_stage,
            iteration=0,
            models=tuple(gen_models) if gen_models is not None else all_ids,
            tools_after=tools,
        )
    ]
    for it in range(max_repairs):
        decisions.append(
            DecisionPoint(
                stage=repair_stage,
                iteration=it,
                models=tuple(repair_models) if repair_models is not None else all_ids,
                tools_after=tools,
            )
        )
    return WorkflowTemplate(
        name=name, models=tuple(models), decisions=tuple(decisions), min_depth=1
    )


def make_reflection_workflow(
    name: str,
    models: Sequence[ModelSpec],
    *,
    stage: str = "reflect",
    max_rounds: int = 6,
) -> WorkflowTemplate:
    """Single repeated self-reflection stage (paper's MathQA workflow)."""
    all_ids = tuple(range(len(models)))
    decisions = tuple(
        DecisionPoint(stage=stage, iteration=it, models=all_ids)
        for it in range(max_rounds)
    )
    return WorkflowTemplate(
        name=name, models=tuple(models), decisions=decisions, min_depth=1
    )
