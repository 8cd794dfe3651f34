"""The port's resident planner against `repro`'s on one update sequence.

Both planners receive the same `update`/`replan` calls, drawn with numpy
from a seed: lanes with per-class elapsed shifts (``-inf`` for
deadline-free lanes), outages rendered as the blocked-depth column,
annotation swaps.  Every lane's (target, next model) must be identical.
The port's planner swaps annotations by copying columns into the ones its
launch path is bound to, so a swap changes plans and binds nothing new.
"""
import numpy as np
import pytest

from repro.core import controller_jax as jc
from repro.core import presets as jpresets
from repro.core.controller import Objective as JObjective
from repro.core.faults import blocked_depth_table
from repro.core.trie import Trie as JTrie
from repro.core.workload import generate_workload as jgenerate
from repro_torch.core import controller_torch as tc
from repro_torch.core import presets
from repro_torch.core.controller import Objective
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload

CAPACITY = 6


def _pair(name, kind="max_acc", n=200):
    """(port trie, port ann, port objective, repro trie, repro ann, repro
    objective) for one preset."""
    tpl, jtpl = presets.PRESETS[name](), jpresets.PRESETS[name]()
    trie, jtrie = Trie.build(tpl), JTrie.build(jtpl)
    ann = generate_workload(tpl, n, seed=0).exact_annotations(trie)
    jann = jgenerate(jtpl, n, seed=0).exact_annotations(jtrie)
    term = trie.terminal
    caps = dict(cost_cap=float(np.quantile(ann.cost[term], 0.6)),
                lat_cap=float(np.quantile(ann.lat[term], 0.7)))
    if kind == "min_cost":
        caps["acc_floor"] = float(np.quantile(ann.acc[term], 0.4))
    return (trie, ann, Objective(kind, **caps), jtrie, jann,
            JObjective(kind, **caps))


def _planners(name, kind="max_acc", lat_cap=None):
    trie, ann, obj, jtrie, jann, jobj = _pair(name, kind)
    td = tc.TrieDevice.build(trie, ann, device="cpu")
    jtd = jc.TrieDevice.build(jtrie, jann)
    p = tc.make_resident_planner(td, obj, CAPACITY, lat_cap=lat_cap)
    jp = jc.make_resident_planner(jtd, jobj, CAPACITY, lat_cap=lat_cap)
    return trie, ann, td, p, (jtrie, jann, jp)


def _draw_updates(rng, trie, lat_cap, n_engines):
    """One event's lane updates: a few slots at random prefixes with an
    elapsed latency near the cap, some shifted to -inf (deadline-free
    class), and one shared delay row."""
    k = int(rng.integers(1, CAPACITY + 1))
    slots = rng.choice(CAPACITY, k, replace=False)
    u = rng.integers(0, trie.n_nodes, k).astype(np.int32)
    el = (rng.random(k) * lat_cap).astype(np.float32)
    el[rng.random(k) < 0.3] = -np.inf
    ec = (rng.random(k) * 0.01).astype(np.float32)
    row = (rng.random(n_engines) * 0.2 * lat_cap).astype(np.float32)
    return slots, u, el, ec, row


@pytest.mark.parametrize("name,kind", [("nl2sql_2", "max_acc"),
                                       ("nl2sql_8", "max_acc"),
                                       ("mathqa_4", "min_cost")])
def test_resident_matches_repro_with_shifts_and_outages(name, kind):
    trie, ann, td, p, (_, _, jp) = _planners(name, kind)
    lat_cap = p.scalars[2]
    assert np.float32(lat_cap) == np.float32(jp.scalars[2])
    path_models = td.path_models.numpy()
    eom = td.engine_of_model.numpy()
    rng = np.random.default_rng(3)
    builds = None
    for step in range(12):
        slots, u, el, ec, row = _draw_updates(rng, trie, lat_cap,
                                              td.n_engines)
        p.update(slots, u, el, ec)
        jp.update(slots, u, el, ec)
        blocked = None
        if step % 3 == 1:  # an outage of one engine
            down = np.zeros(td.n_engines, dtype=bool)
            down[step % td.n_engines] = True
            blocked = blocked_depth_table(path_models, eom, down)
            assert blocked.any()
        tgt, nxt = p.replan(row, blocked=blocked)
        jtgt, jnxt = jp.replan(row, blocked=blocked)
        np.testing.assert_array_equal(tgt, jtgt)
        np.testing.assert_array_equal(nxt, jnxt)
        if builds is None:
            builds = tc.planner_builds()
    assert tc.planner_builds() == builds


def test_class_shift_lanes_follow_their_own_deadline():
    """With the effective cap at the largest class deadline, a lane
    shifted by -inf is deadline-free and one shifted by the cap
    difference is held to its tighter deadline, as `repro`'s are."""
    trie, ann, obj, jtrie, jann, jobj = _pair("nl2sql_8")
    term = trie.terminal
    tight, loose = (float(np.quantile(ann.lat[term], q)) for q in (0.2, 0.9))
    td = tc.TrieDevice.build(trie, ann, device="cpu")
    p = tc.make_resident_planner(td, obj, 3, lat_cap=loose)
    jp = jc.make_resident_planner(jc.TrieDevice.build(jtrie, jann), jobj, 3,
                                  lat_cap=loose)
    el = np.array([0.0, loose - tight, -np.inf], dtype=np.float32)
    for planner in (p, jp):
        planner.update(np.arange(3), np.zeros(3, np.int32), el,
                       np.zeros(3, np.float32))
    row = np.zeros(td.n_engines, np.float32)
    tgt, _ = p.replan(row)
    np.testing.assert_array_equal(tgt, jp.replan(row)[0])
    lat = ann.lat
    assert lat[tgt[0]] <= loose + 1e-5 and lat[tgt[1]] <= tight + 1e-5
    assert tgt[0] != tgt[1]


def test_swap_device_changes_plans_without_a_new_binding():
    trie, ann, td, p, (jtrie, jann, jp) = _planners("nl2sql_8")
    rng = np.random.default_rng(0)
    slots = np.arange(CAPACITY)
    u = np.zeros(CAPACITY, np.int32)
    el = np.zeros(CAPACITY, np.float32)
    el[1::2] = (rng.random(CAPACITY // 2) * p.scalars[2] * 0.5)
    ec = np.zeros(CAPACITY, np.float32)
    row = np.zeros(td.n_engines, np.float32)
    for planner in (p, jp):
        planner.update(slots, u, el, ec)
    before = p.replan(row)
    builds = tc.planner_builds()
    new_td = tc.TrieDevice.build(trie, ann.scaled(lat=1.6, acc=0.9),
                                 device="cpu")
    new_td.version = 1
    jnew = jc.TrieDevice.build(jtrie, jann.scaled(lat=1.6, acc=0.9))
    jnew.version = 1
    assert p.swap_device(new_td) is td
    jp.swap_device(jnew)
    after = p.replan(row)
    np.testing.assert_array_equal(after[0], jp.replan(row)[0])
    np.testing.assert_array_equal(after[1], jp.replan(row)[1])
    assert not np.array_equal(before[0], after[0])
    assert p.device_version == 1
    assert tc.planner_builds() == builds
    # a different structure is refused
    small, small_ann, *_ = _pair("nl2sql_2")
    with pytest.raises(ValueError, match="identical"):
        p.swap_device(tc.TrieDevice.build(small, small_ann, device="cpu"))


def test_planners_of_one_shape_read_their_own_columns():
    """Two live planners of the same shape each plan on their own trie
    device, and each binds its two layouts when it is made, none after."""
    trie, ann, obj, jtrie, jann, jobj = _pair("nl2sql_8")
    td = tc.TrieDevice.build(trie, ann, device="cpu")
    td2 = tc.TrieDevice.build(trie, ann.scaled(lat=2.0), device="cpu")
    builds = tc.planner_builds()
    a = tc.make_resident_planner(td, obj, CAPACITY)
    b = tc.make_resident_planner(td2, obj, CAPACITY)
    assert tc.planner_builds() == builds + 4
    el = np.full(CAPACITY, obj.lat_cap * 0.3, np.float32)
    for q in (a, b):
        q.update(np.arange(CAPACITY), np.zeros(CAPACITY, np.int32), el,
                 np.zeros(CAPACITY, np.float32))
    row = np.zeros(td.n_engines, np.float32)
    fresh = tc.LanePlanner(td2, obj)(np.zeros(CAPACITY, np.int32), el, None,
                                     np.zeros((CAPACITY, td.n_engines),
                                              np.float32))
    builds = tc.planner_builds()
    ta, tb, ta2 = a.replan(row)[0], b.replan(row)[0], a.replan(row)[0]
    np.testing.assert_array_equal(tb, fresh[0].numpy())
    np.testing.assert_array_equal(ta, ta2)
    assert not np.array_equal(ta, tb)
    assert tc.planner_builds() == builds


def test_reset_and_superseded_devices():
    trie, ann, td, p, _ = _planners("nl2sql_2")
    row = np.zeros(td.n_engines, np.float32)
    zero = p.replan(row)
    p.update([0, 2], [3, 5], [0.5, -np.inf], [0.0, 0.0])
    assert p.replan(row)[0].tolist() != zero[0].tolist()
    p.reset()
    np.testing.assert_array_equal(p.replan(row)[0], zero[0])
    td.version = 1
    td.check_live()
    td.supersede(2)
    assert td.superseded_by == 2
    with pytest.raises(RuntimeError, match="version 2"):
        td.check_live()
    with pytest.raises(RuntimeError, match="swap_device"):
        p.replan(row)
    fresh = tc.TrieDevice.build(trie, ann, device="cpu")
    p.swap_device(fresh)
    np.testing.assert_array_equal(p.replan(row)[0], zero[0])
    with pytest.raises(RuntimeError, match="superseded"):
        p.swap_device(td)


def test_admission_probe_matches_repro():
    trie, ann, obj, jtrie, jann, jobj = _pair("nl2sql_8")
    td = tc.TrieDevice.build(trie, ann, device="cpu")
    jtd = jc.TrieDevice.build(jtrie, jann)
    probe = tc.make_admission_probe(td, obj)
    jprobe = jc.make_admission_probe(jtd, jobj)
    rng = np.random.default_rng(9)
    b = 16
    u = rng.integers(0, trie.n_nodes, b)
    el = rng.random(b) * obj.lat_cap * 1.2
    ec = np.zeros(b)
    delays = rng.random((b, td.n_engines)) * 0.3
    got = probe(u, el, ec, delays)
    assert got.dtype == bool and got.shape == (b,)
    np.testing.assert_array_equal(got, jprobe(u, el, ec, delays))
    assert got.any() and not got.all()
    bd = blocked_depth_table(td.path_models.numpy(),
                             td.engine_of_model.numpy(),
                             np.array([True] + [False] * (td.n_engines - 1)))
    np.testing.assert_array_equal(probe(u, el, ec, delays, blocked=bd),
                                  jprobe(u, el, ec, delays, blocked=bd))


def test_resident_planner_refuses_what_is_not_ported():
    trie, ann, obj, *_ = _pair("nl2sql_2")
    td = tc.TrieDevice.build(trie, ann, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        tc.make_resident_planner(td, obj, 4, mesh=object())
    p = tc.make_resident_planner(td, obj, 4)
    with pytest.raises(NotImplementedError, match="item 6"):
        p.update_loads([0], [0], [1.0])
    with pytest.raises(NotImplementedError, match="item 6"):
        p.replan_coupled(None, None, None)
    with pytest.raises(ValueError, match="slots"):
        p.update([4], [0], [0.0], [0.0])
    with pytest.raises(ValueError, match="delay_row"):
        p.replan(np.zeros(td.n_engines + 1))
    with pytest.raises(ValueError, match="cuda"):
        tc.make_resident_planner(td, obj, 4, variant="cuda")
