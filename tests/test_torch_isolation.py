"""The port stands alone and never runs on the CPU unasked.

An AST scan shows that no module of `src/repro_torch/`, nor
`chip_smoke.py`, imports `jax` or `repro`.  With CUDA hidden, every entry
point raises unless the caller passes ``device="cpu"``, and works with it.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import presets
from repro_torch.core.controller import Objective
from repro_torch.core.controller_torch import TrieDevice, make_resident_planner
from repro_torch.core.estimators import OnlineEstimators, TrieAnnotator
from repro_torch.core.events import run_events
from repro_torch.core.fleet import run_fleet
from repro_torch.core.profiler import profile_cascade
from repro_torch.core.runtime import make_workload_executor, run_cohort
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload
from repro_torch.dist import spawn
from repro_torch.dist.runs import run_cases
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
SSM_ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    dist = {p.name for p in files if p.parent.name == "dist"}
    assert {"__init__.py", "sharding.py", "group.py", "runs.py"} <= dist
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    tpl = presets.nl2sql_2()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, 40, seed=0)
    return trie, wl, wl.exact_annotations(trie)


def _annotator(trie, wl, **kw):
    est = OnlineEstimators.from_profile(
        trie, profile_cascade(wl, trie, 0.2, seed=0))
    return TrieAnnotator(trie, est, **kw)


def test_entry_points_refuse_the_cpu_unasked(no_cuda):
    trie, wl, ann = _small()
    obj = Objective("max_acc")
    execu = make_workload_executor(wl)
    reqs = np.arange(4)
    annot = _annotator(trie, wl)
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    calls = [
        lambda: run_cohort(trie, ann, obj, reqs, execu, engine="fleet"),
        lambda: run_cohort(trie, ann, obj, reqs, execu, engine="scalar"),
        lambda: run_cohort(trie, ann, obj, reqs, execu, engine="events"),
        lambda: run_fleet(trie, ann, obj, reqs, execu),
        lambda: run_events(trie, ann, obj, reqs, execu),
        lambda: run_events(trie, ann, obj, reqs[:0], execu),
        lambda: make_resident_planner(TrieDevice.build(trie, ann), obj, 4),
        lambda: TrieDevice.build(trie, ann),
        lambda: spawn(run_cases, 2, device="cuda", args=([],)),
        annot.publish,
        lambda: Model(cfg),
        lambda: params_from_jax(cfg, {}),
        lambda: ServingEngine("e", Model(cfg, device="cpu")),
    ]
    for arch in SSM_ARCHS:
        c = get_config(arch, smoke=True)
        calls += [lambda c=c: Model(c), lambda c=c: params_from_jax(c, {}),
                  lambda c=c: ServingEngine("e", Model(c, device="cpu"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_entry_points_run_on_the_cpu_when_asked(no_cuda):
    trie, wl, ann = _small()
    obj = Objective("max_acc")
    res = run_cohort(trie, ann, obj, np.arange(4), make_workload_executor(wl),
                     engine="fleet", device="cpu")
    assert len(res) == 4 and all(r.n_stages >= 1 for r in res)
    res, stats = run_events(trie, ann, obj, np.arange(4),
                            make_workload_executor(wl),
                            arrivals=np.array([0.0, 0.5, 1.0, 1.5]),
                            capacity=2, device="cpu")
    assert len(res) == 4 and stats.replans > 0
    td = TrieDevice.build(trie, ann, device="cpu")
    assert td.device.type == "cpu"
    planner = make_resident_planner(td, obj, 4)
    assert planner.replan(np.zeros(td.n_engines))[0].shape == (4,)
    pub = _annotator(trie, wl, device="cpu").publish()
    assert pub.device.type == "cpu" and pub.version == 1
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine("e", model, device="cpu")
    out, ttft, dec = eng.generate(np.zeros((1, 8), np.int32), max_new=3)
    assert out.shape == (1, 3) and ttft > 0 and dec > 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_models_run_on_the_cpu_when_asked(no_cuda, arch):
    model = Model(get_config(arch, smoke=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in model.parameters())
    eng = ServingEngine("e", model, device="cpu")
    out, ttft, dec = eng.generate(np.zeros((1, 8), np.int32), max_new=3)
    assert out.shape == (1, 3) and ttft > 0 and dec > 0


@pytest.mark.parametrize("change", [
    {"family": "moe"}, {"moe": MoEConfig(n_experts=4, top_k=2)},
    {"family": "vlm"}, {"family": "audio"}])
def test_model_still_refuses_unported_families(change):
    """Every family is ported: a ``moe``, ``vlm`` or ``audio`` family
    without its `MoEConfig`, `VLMConfig` or `EncDecConfig` is refused as a
    bad config, and a `MoEConfig` builds a MoE model on the CPU."""
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True), **change)
    if "moe" in change:
        model = Model(cfg, device="cpu")
        assert all(blk.moe for blk in model.layers)
        return
    want = {"moe": "a MoEConfig", "vlm": "a VLMConfig",
            "audio": "an EncDecConfig"}[change["family"]]
    with pytest.raises(ValueError, match=f"needs {want}"):
        Model(cfg, device="cpu")
