"""The port's FSDP-style sharded step against two single-device steps.

`repro`'s own sharded step is no reference here: its multi-device test
(`tests/test_dist.py::test_multidevice_sharded_train_step`) fails under
jax 0.9's explicit mesh axes.  So the port's sharded step
(`make_train_step(model, tcfg, mesh=)`, run by
`repro_torch.dist.train_runs.run_train_cases` in spawned gloo groups on
the CPU) is held to the port's single-device step and to `repro`'s
``jax.jit(step)`` on one device, with `test_dist`'s tolerances: loss rel
2e-4 (Yi) / 2e-2 (Granite-MoE, whose routing and aux loss each rank
computes over its own rows), grad norm rel max(tol, 1e-3), and parameter
movement (the squared distance the step moved the masters) rel 0.05 /
0.3.  The SMOKE models run in float32 from `repro`'s
``init(PRNGKey(0))`` (`params_from_jax(..., train=True)`), at
`test_dist`'s sizes: sequence 32, batch 8, kgram 1.

Three meshes: ``("data",)`` of 2, ``("data", "model")`` of (2, 2) (the
model axis replicates the batch), and (3, 1), where 8 rows do not split
over 3 (every rank takes the whole batch, weighted 1/3) and the leaves
`repro`'s rules put on ``"model"`` have extent 1.  Each runs AdamW for 2
steps and AdamW-int8 and Adafactor for one (their whole-leaf rules
gather the leaf).  Every rank's digest of its records must equal rank
0's, and each step must issue exactly the collectives
`sharded_step_collectives` predicts.  Zamba2 (the quirk's leaves) trains
on (3, 1) and Whisper's encoder-decoder on 2 ranks, each against the
port's single-device step.
"""
import concurrent.futures
import dataclasses
import functools
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import MarkovLMData as JaxMarkovLMData
from repro.models import build_model as jax_build_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.dist import spawn
from repro_torch.dist.train_runs import run_train_cases
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               TrainConfig, make_train_step)
from repro_torch.train.step import sharded_step_collectives

ARCHS = ("yi-9b", "granite-moe-1b-a400m")
# loss rtol, movement rtol (tests/test_dist.py); grad norm max(loss, 1e-3)
TOLS = {"yi-9b": (2e-4, 0.05), "granite-moe-1b-a400m": (2e-2, 0.3),
        "zamba2-2.7b": (2e-4, 0.05), "whisper-base": (2e-4, 0.05)}
OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
OPTS = {"adamw": ({}, 2), "adamw-int8": ({"quantize_moments": True}, 1),
        "adafactor": ({"kind": "adafactor"}, 1)}
MESHES = {"data2": ((2,), ("data",)),
          "data2x2": ((2, 2), ("data", "model")),
          "data3x1": ((3, 1), ("data", "model"))}
# extra families on one mesh each, held to the port's single device
FAMILIES = {"zamba2-2.7b": "data3x1", "whisper-base": "data2"}
DEADLINE_S = 240.0


class _Mesh:
    """A shape-only mesh: the rules read ``axis_names`` and ``shape``."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    """`repro`'s nested tree as {"a@b": numpy leaf}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}@"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _start(arch):
    """(repro's model, its params, the port's float32 config, the params as
    the port's flat master dict of numpy arrays)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    return jm, params, cfg, _flat(jax.tree.map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _batches(arch, n):
    cfg = _start(arch)[2]
    data = JaxMarkovLMData(JaxDataConfig(vocab=cfg.vocab, seq_len=32,
                                         batch=8, kgram=1))
    out = [data.next_batch() for _ in range(n)]
    if cfg.encdec is not None:
        rng = np.random.default_rng(7)
        for b in out:
            b["frames"] = rng.standard_normal(
                (8, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def _tcfg(opt):
    return TrainConfig(opt=OptConfig(**OPT, **OPTS[opt][0]))


def _movement(after: dict, before: dict) -> float:
    return sum(float(np.sum((np.asarray(after[k], np.float64) - v) ** 2))
               for k, v in before.items())


@functools.lru_cache(maxsize=None)
def _port_single(arch, opt):
    """The port's single-device steps: per-step (loss, grad norm), and the
    movement."""
    _, params, cfg, flat = _start(arch)
    tm = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                         device="cpu", train=True)
    init, step = make_train_step(tm, _tcfg(opt))
    params, state = tm.params(), init(tm.params())
    out = []
    for b in _batches(arch, OPTS[opt][1]):
        params, state, m = step(params, state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    after = {k: p.detach().numpy() for k, p in params.items()}
    return out, _movement(after, flat)


@functools.lru_cache(maxsize=None)
def _repro_single(arch, opt):
    """`repro`'s ``jax.jit(step)`` on one device, as `test_dist` runs it."""
    jm, params, _, flat = _start(arch)
    kw, n = OPTS[opt]
    init, step = jax_make_train_step(jm, JaxTrainConfig(
        opt=JaxOptConfig(**OPT, **kw)))
    step = jax.jit(step)
    p, s, out = params, init(params), []
    for b in _batches(arch, n):
        p, s, m = step(p, s, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, _movement(_flat(jax.tree.map(np.asarray, p)), flat)


def _case(arch, opt, mesh):
    _, _, cfg, flat = _start(arch)
    return dict(kind="steps", mesh=MESHES[mesh], cfg=cfg, params=flat,
                tcfg=_tcfg(opt), batches=_batches(arch, OPTS[opt][1]),
                return_params=(arch, opt) == LOOP_CASE)


# the loop's run of LOOP_CASE on the (2, 2) mesh, checkpointing its
# last step: a temporary directory for the test session
LOOP_CASE = ("yi-9b", "adamw")
_CKPT = tempfile.TemporaryDirectory(prefix="repro_torch_test_ckpt_")


def _loop_case():
    arch, opt = LOOP_CASE
    cfg = _start(arch)[2]
    return dict(kind="loop", mesh=MESHES["data2x2"], cfg=cfg,
                params=_start(arch)[3], tcfg=_tcfg(opt),
                data=DataConfig(vocab=cfg.vocab, seq_len=32, batch=8,
                                kgram=1),
                lcfg=LoopConfig(total_steps=OPTS[opt][1], ckpt_every=100,
                                ckpt_dir=_CKPT.name, async_ckpt=False,
                                log_every=100))


def _keys(mesh):
    return [(a, o) for a in ARCHS for o in OPTS] + [
        (a, "adamw") for a, m in FAMILIES.items() if m == mesh]


@functools.lru_cache(maxsize=None)
def _groups() -> dict:
    """Every mesh's cases in its own spawned gloo group, the three groups
    started at once in the background (their ranks mostly start up while
    `repro`'s references compile): {mesh: future of `spawn`'s result}."""
    cases = {m: [_case(a, o, m) for a, o in _keys(m)] for m in MESHES}
    cases["data2x2"].append(_loop_case())
    pool = concurrent.futures.ThreadPoolExecutor(len(MESHES))
    return {m: pool.submit(spawn, run_train_cases,
                           int(np.prod(MESHES[m][0])), device="cpu",
                           args=(cases[m],), timeout_s=60.0,
                           deadline_s=DEADLINE_S) for m in MESHES}


@functools.lru_cache(maxsize=None)
def _group(mesh):
    """{(arch, opt): (record, every rank's measure)} of ``mesh``'s group,
    every rank's digest equal to rank 0's."""
    out = _groups()[mesh].result()
    assert len(set(out["digests"])) == 1, out["digests"]
    return {k: (out["records"][i], [m[i] for m in out["measures"]])
            for i, k in enumerate(_keys(mesh))}


@functools.lru_cache(maxsize=None)
def _loop_record():
    out = _groups()["data2x2"].result()
    return out["records"][len(_keys("data2x2"))]


def _hold(got, want, movement, want_movement, tol, mov_tol, label):
    assert len(got) == len(want)
    for i, ((loss, gn), (wl, wg)) in enumerate(zip(got, want)):
        assert loss == pytest.approx(wl, rel=tol), (label, i, "loss")
        assert gn == pytest.approx(wg, rel=max(tol, 1e-3)), (label, i)
    assert movement == pytest.approx(want_movement, rel=mov_tol), label


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_matches_both_single_device_steps(mesh, arch, opt):
    _groups()
    refs = (("port", _port_single(arch, opt)),
            ("repro", _repro_single(arch, opt)))
    rec, measures = _group(mesh)[arch, opt]
    got = [(m["loss"], m["grad_norm"]) for m in rec["metrics"]]
    tol, mov_tol = TOLS[arch]
    for name, (want, want_mov) in refs:
        _hold(got, want, rec["movement"], want_mov, tol, mov_tol, name)
    expect = sharded_step_collectives(_start(arch)[2], _tcfg(opt),
                                      _Mesh(*MESHES[mesh]))
    for rank, m in enumerate(measures):
        assert [s["collectives"] for s in m["steps"]] == \
            [expect] * len(got), rank


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_sharded_step_other_families(arch):
    """Zamba2 on (3, 1): its leaves on `repro`'s ``"model"`` fallback
    are replicated over the extent-1 axis and train; Whisper's
    encoder-decoder goes through the same ``mesh=`` path, its frames split
    with its tokens."""
    rec, _ = _group(FAMILIES[arch])[arch, "adamw"]
    got = [(m["loss"], m["grad_norm"]) for m in rec["metrics"]]
    want, want_mov = _port_single(arch, "adamw")
    _hold(got, want, rec["movement"], want_mov, *TOLS[arch], "port")


def test_the_quirk_and_unsupported_options_are_refused():
    """`repro`'s spec for a leaf with no dimension divisible by 3 on a
    1-D data-3 mesh names ``"model"``, which that mesh lacks: the sharded
    step refuses it by leaf and axis, before any collective.  Gradient
    accumulation and compression are refused by name."""
    cfg = _start("yi-9b")[2]
    model = build_model(get_config("zamba2-2.7b", smoke=True), device="cpu",
                        train=True)
    with pytest.raises(ValueError, match=r"leaf 'embed'.*'model'"):
        make_train_step(model, _tcfg("adamw"),
                        mesh=_Mesh((3,), ("data",)))
    yi = build_model(cfg, device="cpu", train=True)
    for over in (dict(accum_steps=2), dict(compress_grads=True)):
        with pytest.raises(ValueError, match="accum_steps"):
            make_train_step(yi, dataclasses.replace(_tcfg("adamw"), **over),
                            mesh=_Mesh((2,), ("data",)))


def test_loop_checkpoint_on_a_2x2_mesh_holds_the_gathered_masters():
    """``train(mesh=)`` on (2, 2), whose leaves the checkpoint gathers to
    rank 0 over each data group (the model axis replicates them), writes
    the masters the sharded step reaches on the same batches bit for bit,
    with the same losses."""
    arch, opt = LOOP_CASE
    rec, _ = _group("data2x2")[LOOP_CASE]
    loop = _loop_record()
    assert loop["losses"] == [m["loss"] for m in rec["metrics"]]
    mgr = CheckpointManager(_CKPT.name)
    step = OPTS[opt][1]
    assert mgr.latest_step() == step
    target = {k: np.empty(0) for k in rec["params"]}
    back = mgr.restore(step, {"params": target})["params"]
    for k, want in rec["params"].items():
        np.testing.assert_array_equal(back[k], want, err_msg=k)
