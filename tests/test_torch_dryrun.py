"""The port's dry run (`repro_torch.launch.dryrun`) against `repro`'s.

`repro`'s dry run sets ``XLA_FLAGS`` for 512 host devices in its first
lines, so its helpers are read from its source with that line replaced,
as `tests/test_dryrun_unit.py` does.  Held here:

- `input_specs` equals `repro`'s for all 32 runnable cells, shape and
  dtype, and the 8 full-attention architectures skip ``long_500k``;
- the argument bytes a rank holds, on both production meshes, equal the
  bytes of `repro`'s ``spec_tree`` / ``batch_specs`` / ``cache_specs``
  over ``jax.eval_shape`` of its params, train state, batch and cache
  (the cache's ``len`` and ``pos`` scalars excepted: the port keeps them
  as host ints), for every AdamW architecture with the state under
  `repro`'s dry-run rule (``spec_tree_state``).  For Arctic's Adafactor
  state the port shards each statistic by `spec_tree` (its
  ``train_specs`` rule) where `repro`'s dry run replicates the factored
  ones: the port's bytes equal `repro`'s ``spec_tree`` over the state,
  and are fewer than ``spec_tree_state``'s;
- in fresh processes with fake groups of 2 and 4 ranks, the SMOKE sharded
  step's traced collectives equal `sharded_step_collectives`, rank 0 and
  the last rank read the same, and at 2 ranks its gathered and reduced
  bytes equal a gloo group's on the CPU running the same step
  (`dist.train_runs.run_train_cases`, as `tests/test_torch_train_sharded.
  py` runs it);
- each kernel's shape route gives the plain version's shapes and dtypes
  and counts one launch; real tensors and fake CPU tensors never reach
  it;
- `make_production_mesh` gives `repro`'s axis names and extents;
  ``"cuda"`` without a card still raises outside a fake mode;
- the command line traces the smallest full-width cell (Whisper-base's
  decode) and writes its record.
"""
import concurrent.futures
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jsh
from repro.models import build_model as jax_build_model
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch import device as port_device
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_cells_for
from repro_torch.dist import spawn
from repro_torch.dist.train_runs import run_train_cases
from repro_torch.kernels import _build, ops, ref
from repro_torch.launch import dryrun
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.step import sharded_step_collectives

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


class _Mesh:
    """A shape-only mesh: the spec rules read ``axis_names`` and
    ``shape``."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _jax_dryrun():
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    src = path.read_text().replace(
        'os.environ["XLA_FLAGS"] = '
        '"--xla_force_host_platform_device_count=512"', "pass")
    mod = types.ModuleType("repro_dryrun_for_port_test")
    mod.__dict__["__file__"] = str(path)
    exec(compile(src, "dryrun.py", "exec"), mod.__dict__)
    return mod


def test_input_specs_equal_repros_for_all_cells():
    jd = _jax_dryrun()
    total, skips = 0, []
    assert ARCH_IDS == list(JAX_ARCH_IDS)
    for arch in ARCH_IDS:
        cells = shape_cells_for(arch)
        if "long_500k" not in cells:
            skips.append(arch)
        for name in cells:
            ours = dryrun.input_specs(get_config(arch), SHAPES[name])
            theirs = jd.input_specs(jax_get_config(arch), JAX_SHAPES[name])
            assert list(ours) == list(theirs), (arch, name)
            for k, s in theirs.items():
                assert ours[k].shape == tuple(s.shape), (arch, name, k)
                assert ours[k].dtype == DTYPES[s.dtype.type], (arch, name, k)
            total += 1
    assert total == 32
    assert len(skips) == 8
    assert all(not get_config(a).sub_quadratic for a in skips)
    assert dryrun._train_opt_for("arctic-480b").kind == "adafactor"
    for arch in ARCH_IDS:
        for name in shape_cells_for(arch):
            assert dryrun.opt_overrides_for(arch, name) == \
                jd.opt_overrides_for(arch, name)


def _spec_bytes(sds, spec, mesh: dict) -> int:
    n = math.prod(sds.shape) * jnp.dtype(sds.dtype).itemsize
    for entry in tuple(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            n //= mesh[a]
    return n


def _tree_bytes(tree, specs, mesh: dict) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_spec_bytes(x, s, mesh) for x, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    model = jax_build_model(jax_get_config(arch))
    return model, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


def _repro_arguments(arch, name, mesh: dict) -> tuple[int, int | None]:
    """(the bytes a rank holds under `repro`'s rules, and for Adafactor
    the bytes with the state under `repro`'s ``spec_tree_state``)."""
    jd = _jax_dryrun()
    cfg, cell = jax_get_config(arch), JAX_SHAPES[name]
    model, params = _jax_params(arch)
    m = _Mesh(mesh)
    p_specs = jsh.spec_tree(params, m)
    batch = jd.input_specs(cfg, cell)
    n = _tree_bytes(params, p_specs, mesh) + _tree_bytes(
        batch, jsh.batch_specs(batch, m), mesh)
    if cell.kind == "train":
        opt = jd._train_opt_for(arch)
        init, _ = jax_make_train_step(model, JaxTrainConfig(opt=opt))
        state = jax.eval_shape(init, params)
        dry = _tree_bytes(state, jd.spec_tree_state(state, p_specs), mesh)
        if opt.kind == "adafactor":
            return n + _tree_bytes(state, jsh.spec_tree(state, m), mesh), \
                n + dry
        return n + dry, None
    if cell.kind == "decode":
        if cfg.encdec is not None:
            cache = jax.eval_shape(lambda: model.init_cache(
                cell.global_batch, cell.seq_len, cfg.encdec.encoder_len))
        else:
            cache = jax.eval_shape(lambda: model.init_cache(
                cell.global_batch, cell.seq_len))
        cache = {k: v for k, v in cache.items() if k not in ("len", "pos")}
        n += _tree_bytes(cache, jsh.cache_specs(cache, m), mesh)
    return n, None


@pytest.fixture(scope="module")
def port_arguments():
    """Both meshes' argument bytes from the port, each in its own process
    (a fake group of 256 or 512 ranks), started at once."""
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {mk: ex.submit(dryrun.isolated, "cell_arguments",
                              mesh_kind=mk) for mk in MESHES}
        return {mk: f.result() for mk, f in futs.items()}


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_argument_bytes_equal_repros_specs(port_arguments, mesh_kind):
    ours = port_arguments[mesh_kind]
    assert len(ours) == 32
    for arch in ARCH_IDS:
        for name in shape_cells_for(arch):
            want, dry = _repro_arguments(arch, name, MESHES[mesh_kind])
            assert ours[f"{arch} {name}"] == want, (arch, name)
            if dry is not None:   # Adafactor: repro replicates vr / vc
                assert ours[f"{arch} {name}"] < dry, (arch, name)


def _gloo_step(batch):
    case = dict(kind="steps", mesh=((2,), ("data",)),
                cfg=get_config("yi-9b", smoke=True), key=0,
                tcfg=TrainConfig(opt=OptConfig()), batches=[batch])
    out = spawn(run_train_cases, 2, device="cpu", args=([case],),
                deadline_s=120)
    return out["records"][0]["measure"]["steps"][0]


def test_fake_group_step_matches_the_gloo_step_and_the_formula():
    B, S = 8, 32
    batch = {"tokens": np.zeros((B, S), np.int32),
             "labels": np.zeros((B, S), np.int32)}
    runs = {(2, 0): dict(world=2, rank=0),
            (2, 1): dict(world=2, rank=1),
            (4, 0): dict(world=4, rank=0, mesh_shape=(2, 2),
                         axes=("data", "model")),
            (4, 3): dict(world=4, rank=3, mesh_shape=(2, 2),
                         axes=("data", "model"))}
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        gloo = ex.submit(_gloo_step, batch)
        futs = {k: ex.submit(dryrun.isolated, "sharded_step", arch="yi-9b",
                             smoke=True, batch=[B, S], **kw)
                for k, kw in runs.items()}
        fake = {k: f.result() for k, f in futs.items()}
        gloo = gloo.result()
    cfg, tcfg = get_config("yi-9b", smoke=True), TrainConfig()
    for world, shape in ((2, {"data": 2}), (4, {"data": 2, "model": 2})):
        want = sharded_step_collectives(cfg, tcfg, _Mesh(shape))
        first, last = fake[world, 0], fake[world, world - 1]
        assert first["collectives"]["count"] == want
        assert first["metrics"]["collectives"] == want
        for key in ("collectives", "metrics", "kernels"):
            assert first[key] == last[key], (world, key)
    two = fake[2, 0]
    assert gloo["collectives"] == two["metrics"]["collectives"]
    assert gloo["gathered_bytes"] == two["metrics"]["gathered_bytes"] == \
        two["collectives"]["all-gather"]["bytes"]
    assert gloo["reduced_bytes"] == two["metrics"]["reduced_bytes"] == \
        two["collectives"]["reduce-scatter"]["bytes"] + \
        two["collectives"]["all-reduce"]["bytes"]
    # remat: the forward twice; the backward once; 4L + 1 norms
    L = cfg.n_layers
    assert two["kernels"]["launches"] == {
        "flash_attention": 2 * L, "flash_attention_bwd": L,
        "rms_norm": 4 * L + 1}


def _fakes(*shapes_dtypes):
    dev = port_device.resolve_device("cuda")
    return [torch.zeros(s, dtype=d, device=dev) for s, d in shapes_dtypes]


def _route_cases():
    bf, f32 = torch.bfloat16, torch.float32
    q, kv = ((2, 4, 5, 16), bf), ((2, 2, 7, 16), bf)
    return {
        "flash_attention": (
            lambda q, k, v: ops.attention(q, k, v, causal=False),
            lambda q, k, v: ref.attention(q, k, v, causal=False),
            [q, kv, kv]),
        "decode_attention": (
            lambda q, k, v, n: ops.decode_attention(q, k, v, n, window=3),
            lambda q, k, v, n: ref.decode_attention(q, k, v, n, window=3),
            [((2, 4, 16), bf), ((2, 2, 9, 16), bf), ((2, 2, 9, 16), bf),
             ((2,), torch.int32)]),
        "rms_norm": (ops.rms_norm, ref.rms_norm,
                     [((3, 5, 32), bf), ((32,), f32)]),
        "ssd_scan": (
            lambda *a: ops.ssd_scan(*a, chunk=4, return_state=True),
            lambda *a: ref.ssd_scan_chunked(*a, chunk=4, return_state=True),
            [((2, 9, 3, 8), bf), ((2, 9, 3), f32), ((3,), f32),
             ((2, 9, 16), bf), ((2, 9, 16), bf)]),
    }


def _sig(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("name", sorted(_route_cases()))
def test_shape_route_gives_the_plain_shapes_and_one_launch(name):
    fn, plain, spec = _route_cases()[name]
    real = [torch.ones(s, dtype=d) for s, d in spec]
    if name == "decode_attention":
        real[3] = torch.tensor([9, 4], dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    want = _sig(plain(*real))
    assert _sig(fn(*real)) == want          # a real CPU tensor: plain
    with FakeTensorMode():
        fake_cpu = [torch.zeros(s, dtype=d) for s, d in spec]
        assert _sig(fn(*fake_cpu)) == want  # a fake CPU tensor: plain too
        assert _build.LAUNCHES == before
        got = fn(*_fakes(*spec))
    assert _sig(got) == want
    assert _build.LAUNCHES[name] == before[name] + 1
    assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1


def test_attention_routes_with_gradients_count_the_training_form():
    before = dict(_build.LAUNCHES)
    with FakeTensorMode():
        q, k, v = _fakes(((1, 4, 6, 32), torch.bfloat16),
                         ((1, 2, 6, 32), torch.bfloat16),
                         ((1, 2, 6, 32), torch.bfloat16))
        for t in (q, k, v):
            t.requires_grad_(True)
        o = ops.attention(q, k, v)
        dq, dk, dv = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert _build.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert _build.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1


def test_cuda_without_a_card_raises_outside_a_fake_mode(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device("cuda")
    with FakeTensorMode():
        assert port_device.resolve_device("cuda").type == "meta"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device("cuda")


_MESH_SNIPPET = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import dryrun, mesh as M
out = {}
for world, multi in ((256, False), (512, True)):
    with dryrun.fake_group(world):
        import repro_torch.launch.mesh
        try:
            M.make_production_mesh(multi_pod=multi)
            out["outside"] = "no error"
        except RuntimeError as e:
            out["outside"] = "raised"
        with FakeTensorMode():
            m = M.make_production_mesh(multi_pod=multi)
        out[world] = [list(m.axis_names), m.shape, str(m.device.type),
                      list(M.data_axes(m)), M.model_axis(m)]
with dryrun.fake_group(6):
    out["host"] = M.make_host_mesh(2).shape
    try:
        M.make_host_mesh(4)
    except ValueError:
        out["host4"] = "raised"
print(json.dumps(out))
"""


def test_production_meshes_equal_repros():
    import repro.launch.mesh as jax_mesh

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _MESH_SNIPPET], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["outside"] == "raised"
    assert out["256"][:2] == [["data", "model"], {"data": 16, "model": 16}]
    assert out["512"][:2] == [["pod", "data", "model"],
                              {"pod": 2, "data": 16, "model": 16}]
    assert out["256"][3:] == [["data"], "model"]
    assert out["512"][3:] == [["pod", "data"], "model"]
    assert out["host"] == {"data": 3, "model": 2}
    assert out["host4"] == "raised"
    # repro's own functions on stand-in meshes of those axes
    for names, want in ((("data", "model"), ("data",)),
                        (("pod", "data", "model"), ("pod", "data"))):
        stand_in = types.SimpleNamespace(axis_names=names)
        assert jax_mesh.data_axes(stand_in) == want
        assert jax_mesh.model_axis(stand_in) == "model"


def test_command_line_traces_the_smallest_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--mesh", "single",
         "--force", "--report-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.startswith("[OK ] whisper-base")
    rec = json.loads((tmp_path / "whisper-base__decode_32k__single.json")
                     .read_text())
    assert rec["ok"] and rec["mesh_shape"] == {"data": 16, "model": 16}
    cfg = get_config("whisper-base")
    # 2L decode launches (self, cross), 3L + 1 norms
    assert rec["kernels"]["launches"] == {
        "decode_attention": 2 * cfg.n_layers,
        "rms_norm": 3 * cfg.n_layers + 1}
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost"]["flops"] > rec["cost"]["kernel_flops"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0
