"""The port's spec heuristics against `repro`'s, on shape-only meshes.

`repro_torch.dist.spec_tree`, `batch_specs` and `cache_specs` are
`repro.dist.sharding`'s rules on shapes alone, so the two are compared
leaf for leaf, as tuples, with no tolerance:

- `spec_tree` of every architecture's SMOKE and full parameters (the
  port's from `models.param_shapes`, which allocates nothing; `repro`'s
  from ``jax.eval_shape`` of ``Model.init``), keys equal, on five
  stand-in meshes: (16, 16), (2, 16, 16) with ``"pod"``, (4, 2), 1-D
  data 2, and 1-D data 3, where `repro`'s model-axis fallback names an
  axis the mesh lacks (its quirk, kept; `check_specs` refuses it);
- `batch_specs` of model inputs whose leading dimension does and does
  not divide the data extent;
- `cache_specs` of every family's decode cache at batch 1 and 128, field
  by field of the port's cache dataclasses against `repro`'s dict, and
  `repro`'s own asserts (`tests/test_dist.py::test_batch_and_cache_specs`)
  on the port's Yi-9B cache at full size (meta tensors);
- `train_mesh`'s refusals, and `Sharding` / `sharding_tree` cutting a
  leaf on a one-rank mesh.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jsh
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.dist import (
    Sharding,
    batch_specs,
    cache_specs,
    check_specs,
    one_rank_group,
    sharding_tree,
    spec_tree,
    train_mesh,
)
from repro_torch.models import build_model, param_shapes
from repro_torch.models.transformer import KVCache


class _Mesh:
    """A shape-only mesh: ``axis_names`` and ``shape``, as
    `tests/test_dist.py::_FakeMesh`."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"16x16": dict(data=16, model=16),
          "pod2x16x16": dict(pod=2, data=16, model=16),
          "4x2": dict(data=4, model=2),
          "data2": dict(data=2),
          "data3": dict(data=3)}


def _flat_specs(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"@".join(str(q.key) for q in path): tuple(s)
            for path, s in flat}


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch: str, smoke: bool):
    cfg = jax_get_config(arch, smoke=smoke)
    return jax.eval_shape(
        lambda: jax_build_model(cfg).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tree_matches_repro(arch, smoke, mesh):
    m = _Mesh(**MESHES[mesh])
    shapes = param_shapes(get_config(arch, smoke=smoke))
    want = _flat_specs(jsh.spec_tree(_jax_shapes(arch, smoke), m))
    got = spec_tree(shapes, m)
    assert got == want
    # every sharded dimension splits evenly where the mesh has the axis
    for k, spec in got.items():
        for d, ax in enumerate(spec):
            axes = (ax,) if isinstance(ax, str) else ax or ()
            n = int(np.prod([m.shape.get(a, 1) for a in axes]))
            assert shapes[k][d] % n == 0, (k, shapes[k], spec)


def test_the_quirk_names_a_missing_axis_and_is_refused():
    """On the 1-D data-3 mesh the model extent reads 1, so every SMOKE leaf
    with no dimension divisible by 3 falls back to ``"model"`` in both
    packages (145 leaves over the ten architectures), and `check_specs`
    refuses each by name; on ``{"data": 2}`` no leaf does."""
    quirk = 0
    for arch in ARCH_IDS:
        shapes = param_shapes(get_config(arch, smoke=True))
        specs = spec_tree(shapes, _Mesh(data=3))
        named = [k for k, s in specs.items() if "model" in s]
        quirk += len(named)
        if named:
            with pytest.raises(ValueError, match=f"'{named[0]}'.*'model'"):
                check_specs({k: specs[k] for k in named[:1]}, _Mesh(data=3))
        assert not any("model" in s for s in
                       spec_tree(shapes, _Mesh(data=2)).values())
    assert quirk == 145


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_repro(mesh):
    m = _Mesh(**MESHES[mesh])
    shapes = {"tokens": (256, 4096), "labels": (256, 4096),
              "frames": (256, 1500, 512), "patch_embeds": (6, 2880, 1024),
              "odd": (7, 3), "step": ()}
    want = jsh.batch_specs({k: jax.ShapeDtypeStruct(s, np.float32)
                            for k, s in shapes.items()}, m)
    got = batch_specs({k: np.zeros(s, np.int8) for k, s in shapes.items()},
                      m)
    assert got == {k: tuple(v) for k, v in want.items()}
    # 256 rows: over the data axes, but for 3, which does not divide them
    assert got["tokens"][0] == {"data3": None,
                                "pod2x16x16": ("pod", "data")}.get(mesh,
                                                                   "data")


def _port_cache(arch: str, B: int, S: int):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    if cfg.encdec is not None:
        return model.init_cache(B, S, cfg.encdec.encoder_len)
    return model.init_cache(B, S)


def _jax_cache(arch: str, B: int, S: int):
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    if cfg.encdec is not None:
        return jax.eval_shape(
            lambda: model.init_cache(B, S, cfg.encdec.encoder_len))
    return jax.eval_shape(lambda: model.init_cache(B, S))


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_repro(arch, batch):
    S = 64
    port, ref = _port_cache(arch, batch, S), _jax_cache(arch, batch, S)
    for name, shape in MESHES.items():
        m = _Mesh(**shape)
        got = cache_specs(port, m)
        want = {k: tuple(v) for k, v in jsh.cache_specs(ref, m).items()}
        assert got == want, name


def test_repro_cache_asserts_on_the_full_yi_cache():
    """`repro`'s asserts on Yi-9B's full-size cache: kv 4 does not divide
    16, so the model axis takes the sequence; the request batch takes the
    data axis at 128 and none at 1."""
    cfg = get_config("yi-9b")
    m = _Mesh(data=16, model=16)

    def cache(B, S):
        shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
        return KVCache(k=torch.empty(shape, device="meta"),
                       v=torch.empty(shape, device="meta"), len=S - 1,
                       pos=S - 1)

    cs = cache_specs(cache(128, 32768), m)
    assert cs["k"][3] == "model" and cs["k"][1] == "data"
    assert cs["len"] == () and cs["pos"] == ()
    assert cache_specs(cache(1, 1024), m)["k"][1] is None


def test_train_mesh_refusals():
    with pytest.raises(ValueError, match="repro_torch.dist.spawn"):
        train_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="expected one of"):
        train_mesh((2,), ("model",), device="cpu")
    with pytest.raises(ValueError, match="extent"):
        train_mesh((2, 0), ("data", "model"), device="cpu")


def test_sharding_on_a_one_rank_mesh():
    """World size 1: every block is the whole leaf, and `sharding_tree`
    pairs the mesh with each leaf's spec (a spec that names a missing axis
    refused)."""
    with one_rank_group("gloo"):
        mesh = train_mesh((1, 1), ("data", "model"), device="cpu")
        x = torch.arange(24.0).view(4, 6)
        tree = sharding_tree({"w": x, "b": torch.zeros(3), "n": 5}, mesh)
        assert tree["w"].spec == (None, "data") and tree["n"].spec == ()
        assert torch.equal(tree["w"].shard(x), x)
        one = train_mesh((1,), ("data",), device="cpu")
        with pytest.raises(ValueError, match="lacks"):
            sharding_tree({"w": torch.zeros(5)}, _Mesh(data=3))
        with pytest.raises(ValueError, match="not an axis"):
            Sharding(one, (None, "model")).shard(x)
