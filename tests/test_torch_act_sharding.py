"""The port's activation constraints against `repro.dist.act_sharding`.

- Without a mapping `constrain` returns ``x`` itself; `use_mesh_axes`
  nests and restores the mapping, per thread.
- The resolved spec equals the ``PartitionSpec`` `repro`'s `constrain`
  hands to ``with_sharding_constraint`` (caught by a test-scoped
  monkeypatch), with ``dp`` one axis and ``("pod", "data")``.
- On every SMOKE family the port's forward gives the same outputs, bit
  for bit, with a mapping active and a dry run recording as without.
- The sites the port records are `repro`'s, in order, by logical spec and
  shape, on the same inputs: `repro`'s forward is traced for its shapes
  (``jax.eval_shape``), its layers unrolled (``scan_layers=False``, which
  traces each layer's body once),
  with `repro.models.layers.constrain` and
  `repro.models.transformer.constrain` replaced for the test by a
  recorder.  One difference is `repro`'s own and dead: its cross
  attention computes keys and values from the decoder's input (and
  constrains them) before taking the encoder's, and XLA drops them; the
  port computes only the query there, so those two sites of each of
  Whisper's decoder layers are left out of `repro`'s list.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import repro.dist.act_sharding as jax_act
import repro.models.layers as jax_layers
import repro.models.transformer as jax_transformer
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import record
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import act_sharding
from repro_torch.models import build_model

B, S = 2, 16
MESH = {"pod": 2, "data": 2, "model": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_identity_without_a_mapping():
    x = torch.randn(2, 3)
    assert act_sharding.constrain(x, "dp", None) is x
    with record.recording(record.TraceRecord()) as rec:
        assert act_sharding.constrain(x, "dp", "tp") is x
    assert rec.sites == []


def test_mapping_nests_and_restores_per_thread():
    assert act_sharding._mapping() is None
    with act_sharding.use_mesh_axes("data", "model"):
        assert act_sharding.resolve("dp", None, "tp") == ("data", None,
                                                          "model")
        with act_sharding.use_mesh_axes(("pod", "data"), None):
            assert act_sharding.resolve("dp", "tp") == (("pod", "data"),
                                                        None)
            seen = []
            t = threading.Thread(target=lambda: seen.append(
                act_sharding._mapping()))
            t.start()
            t.join()
            assert seen == [None]
        assert act_sharding.resolve("tp") == ("model",)
    assert act_sharding._mapping() is None


@pytest.mark.parametrize("dp", ["data", ("pod", "data")],
                         ids=["data", "pod-data"])
@pytest.mark.parametrize("logical", [("dp", None, "tp", None),
                                     ("dp", None, None), ("dp", None, "tp"),
                                     (None, "tp"), ("dp",)])
def test_resolved_spec_equals_repros(monkeypatch, dp, logical):
    caught = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: caught.append(tuple(spec)) or x)
    x = np.zeros((2,) * len(logical), np.float32)
    with jax_act.use_mesh_axes(dp, "model"):
        jax_act.constrain(x, *logical)
    with act_sharding.use_mesh_axes(dp, "model"):
        ours = act_sharding.resolve(*logical)
        with record.recording(record.TraceRecord(mesh_shape=MESH)) as rec:
            act_sharding.constrain(torch.zeros(x.shape), *logical)
    assert caught == [ours]
    site = rec.sites[0]
    assert site["spec"] == [list(a) if isinstance(a, tuple) else a
                            for a in ours]
    assert site["tp_realised"] is False
    assert site["tp_unrealised_bytes"] == (
        site["bytes"] // 2 if "tp" in logical else 0)


def _inputs(cfg, seed=0):
    g = np.random.default_rng(seed)
    batch = {"tokens": g.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.vlm is not None:
        batch["patch_embeds"] = (0.5 * g.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_dim))).astype(np.float32)
    if cfg.encdec is not None:
        batch["frames"] = (0.5 * g.standard_normal(
            (B, cfg.encdec.encoder_len, cfg.d_model))).astype(np.float32)
    return batch


def _port_forward(model, cfg, batch):
    tokens = torch.as_tensor(batch["tokens"]).long()
    with torch.no_grad():
        if cfg.encdec is not None:
            return model.forward(torch.as_tensor(batch["frames"]), tokens)
        patches = batch.get("patch_embeds")
        return model.forward(tokens, None if patches is None
                             else torch.as_tensor(patches))


def _repro_sites(monkeypatch, arch, batch):
    sites = []

    def rec(x, *logical):
        sites.append((tuple(logical), tuple(x.shape)))
        return x

    monkeypatch.setattr(jax_layers, "constrain", rec)
    monkeypatch.setattr(jax_transformer, "constrain", rec)
    cfg = jax_get_config(arch, smoke=True, scan_layers=False,
                         use_pallas=False)
    model = jax_build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    jax.eval_shape(model.forward, params, {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    if cfg.encdec is not None:
        # per decoder layer: self q, k, v; cross q, (dead) k, v; MLP
        n_enc = cfg.encdec.n_encoder_layers * 4
        dec = sites[n_enc:]
        assert len(dec) == 7 * cfg.n_layers
        sites = sites[:n_enc] + [s for i, s in enumerate(dec)
                                 if i % 7 not in (4, 5)]
    return sites


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sites_equal_repros_and_outputs_unchanged(monkeypatch, arch):
    cfg = get_config(arch, smoke=True)
    batch = _inputs(cfg)
    model = build_model(cfg, device="cpu", train=True)
    model.init(torch.Generator().manual_seed(0))
    plain = _port_forward(model, cfg, batch)
    with act_sharding.use_mesh_axes("data", "model"), \
            record.recording(record.TraceRecord(mesh_shape=MESH)) as rec:
        mapped = _port_forward(model, cfg, batch)
    assert torch.equal(plain, mapped)
    ours = [(tuple(s["logical"]), tuple(s["shape"])) for s in rec.sites]
    theirs = _repro_sites(monkeypatch, arch, batch)
    assert len(ours) > 0
    assert ours == theirs
