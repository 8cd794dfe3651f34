"""Paper workload presets (§5.1): NL2SQL-8, NL2SQL-2, MathQA-4.

Model pools mirror the paper's candidates.  Price is $/1k output tokens,
latency parameters approximate public serving characteristics; ``power`` is
the latent quality score used by the synthetic workload generator.  Models
are spread over four serving engines so the load-aware experiments (Fig. 10)
have backend structure to exploit.
"""
from __future__ import annotations

from repro_torch.core.workflow import (
    ModelSpec,
    ToolStage,
    WorkflowTemplate,
    make_refinement_workflow,
    make_reflection_workflow,
)

# name, price $/1k-out-tok, base_lat s, per-token s, power, engine
_POOL8 = [
    ModelSpec("gemma-3-27b",    0.0009, 0.30, 0.0012, 0.47, "engine-a"),
    ModelSpec("sonnet-4.6",     0.0150, 0.80, 0.0028, 0.82, "engine-b"),
    ModelSpec("kimi-k2.5",      0.0025, 0.55, 0.0020, 0.66, "engine-c"),
    ModelSpec("qwen3-32b",      0.0010, 0.35, 0.0013, 0.52, "engine-a"),
    ModelSpec("glm-4.7",        0.0060, 0.70, 0.0024, 0.74, "engine-d"),
    ModelSpec("llama-3.3-70b",  0.0018, 0.50, 0.0018, 0.60, "engine-c"),
    ModelSpec("deepseek-v3.2",  0.0028, 0.60, 0.0022, 0.70, "engine-d"),
    ModelSpec("gpt-oss-120b",   0.0040, 0.65, 0.0023, 0.64, "engine-b"),
]

_SQL_TOOL = ToolStage("sql_exec", cost=0.0, latency=0.12)


def nl2sql_8() -> WorkflowTemplate:
    """One generation + up to two repairs, eight models: 584 plans."""
    return make_refinement_workflow(
        "NL2SQL-8", _POOL8, max_repairs=2, tool=_SQL_TOOL
    )


def nl2sql_2() -> WorkflowTemplate:
    """One generation + up to three repairs, two models: 30 plans."""
    pool = [_POOL8[0], _POOL8[1]]  # Gemma-3-27B, Sonnet-4.6 (paper §5.1)
    return make_refinement_workflow(
        "NL2SQL-2", pool, max_repairs=3, tool=_SQL_TOOL
    )


def mathqa_4() -> WorkflowTemplate:
    """Self-reflection, up to six rounds, four models: 5460 plans."""
    pool = [_POOL8[0], _POOL8[1], _POOL8[2], _POOL8[3]]
    return make_reflection_workflow("MathQA-4", pool, max_rounds=6)


PRESETS = {"nl2sql_8": nl2sql_8, "nl2sql_2": nl2sql_2, "mathqa_4": mathqa_4}
