"""The cluster decode attention of `csrc/decode_attention.cu`, as an
algorithm, against `repro`'s Pallas decode kernel, and its launch plan.

`ref.decode_attention_cluster` computes decode attention the way the CUDA
kernel does: the valid slots of a sequence are covered by tiles counted
from the window's start, rank r of a cluster of C owns tiles [r T // C,
(r + 1) T // C), each rank keeps a float32 partial (m, l, acc), empty
ranks included, and the partials merge in rank order by log-sum-exp
weights.  The same numpy inputs go through `repro`'s Pallas
`decode_attention` in interpret mode, at the tolerances of
tests/test_kernels.py (2e-5 float32, 2e-2 bfloat16).  With 8-slot tiles
the 128-slot cache has 16 tiles, so every cluster size up to 16 cuts it;
the lengths 1, 61, 96 and 128 put the end of the valid slots inside the
first tile (every rank but one empty), in a ragged tail, at a tile
boundary and at the end of the cache, and the window of 48 starts the
tiles off the cache's tile grid.  The kernel's own tiles (64 bf16, 32
float32 keys) are held too.

The wrapper's launch plan `decode_plans` is checked without a card at
every shape `chip_smoke.py` times and at edge shapes: cluster sizes, the
grid within a wave, shared memory, the ring and a tile for every block;
and the source is checked to instantiate every head dim in both dtypes
with no workspace, counter or atomic, and to write no rank's shared
memory before the cluster barrier says every rank has started.
"""
import functools
import importlib.util
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import _build, ref
from repro_torch.kernels import decode_attention as dmod

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMS = 132  # the H100's SMs
KV, S, D = 2, 128, 32
LENS = (1, 61, 96, 128)
TILE = 8
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@functools.lru_cache(maxsize=None)
def _case(G, window, dtype):
    """(q, k, v, lens) as CPU tensors of ``dtype`` and the Pallas result,
    from one numpy draw per (G, window, dtype)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(G * 1000 + window)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((len(LENS), G * KV, D), (len(LENS), KV, S, D),
                          (len(LENS), KV, S, D))]
    jarrs = [jnp.asarray(a, jdt) for a in arrs]
    lens = np.array(LENS, np.int32)
    exp = pallas_decode(*jarrs, jnp.asarray(lens), window=window,
                        block_k=64, interpret=True)
    tarrs = [torch.from_numpy(np.array(j, np.float32)).to(tdt) for j in jarrs]
    return (*tarrs, torch.from_numpy(lens)), np.asarray(exp, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [1, 7, 8, 32, 64])
@pytest.mark.parametrize("window", [0, 48, 1000])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_split_decode_matches_pallas_decode(cluster, window, G, dtype):
    (q, k, v, lens), exp = _case(G, window, dtype)
    out = ref.decode_attention_cluster(q, k, v, lens, window=window,
                                       cluster=cluster, tile=TILE)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(), exp, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_kernel_tiles_match_pallas_decode(cluster, window, dtype):
    """The kernel's own tiles, 128 bytes a column: 2 bf16 or 4 float32
    tiles cover the cache, so clusters of 4 leave ranks empty in bf16."""
    (q, k, v, lens), exp = _case(8, window, dtype)
    out = ref.decode_attention_cluster(q, k, v, lens, window=window,
                                       cluster=cluster)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(), exp, atol=tol, rtol=tol)


@pytest.mark.parametrize("cluster", [2, 4, 16])
def test_one_full_span_equals_the_unsplit_plain_version(cluster):
    """Valid slots inside one tile: every rank but the last is empty and
    must merge with weight exactly 0, so the cluster result is the
    unsplit one."""
    rng = np.random.default_rng(cluster)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 8 * KV, D), (3, KV, S, D), (3, KV, S, D)))
    lens = torch.tensor([1, 8, 16], dtype=torch.int32)
    for window in (0, 5):
        out = ref.decode_attention_cluster(q, k, v, lens, window=window,
                                           cluster=cluster, tile=16)
        want = ref.decode_attention(q, k, v, lens, window=window)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_no_valid_slot_gives_zero():
    q = torch.ones(2, 4, D)
    k = torch.ones(2, 2, S, D)
    out = ref.decode_attention_cluster(q, k, k, torch.tensor([0, 0]),
                                       cluster=4, tile=16)
    assert torch.equal(out, torch.zeros_like(q))


# ----------------------------------------------------------------------
# the plan rule
# ----------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed_shapes():
    """(label, B, KV, G, S, D, itemsize) of every decode `chip_smoke.py`
    times: the serving shapes at a 448-token prompt's cache, the media
    caches, the zoo's float32 cache."""
    cs = _chip_smoke()
    out = [(arch, 1, KV, H // KV, cs.PROMPT + 64, D, 2)
           for arch, (H, KV, D, _) in cs.ATTN_SHAPES.items()]
    out += [(label, B, KV, H // KV, Sc, D, 2)
            for label, B, H, KV, D, Sc, _ in cs.MEDIA_DECODE]
    out += [(arch, 1, KV, H // KV, cs.ZOO_DECODE[0], D, 4)
            for arch, (H, KV, D) in cs.ZOO_ATTN.items()]
    return out


# (cluster, slices, head chunk, stages) where 16-block clusters all fit
EXPECTED = {
    "yi-9b": (8, 4, 8, 1),
    "zamba2-2.7b": (4, 1, 1, 2),
    "mistral-nemo-12b": (8, 2, 4, 1),
    "qwen2-72b": (8, 2, 8, 1),
    "granite-moe-1b-a400m": (8, 2, 2, 1),
    "arctic-480b": (8, 2, 7, 1),
    "llava-next-34b image": (16, 1, 7, 3),
    "whisper-base self": (1, 4, 1, 2),
    "whisper-base cross": (4, 1, 1, 6),
    "zoo-s": (1, 1, 1, 3),
    "zoo-m": (1, 1, 1, 3),
    "zoo-l": (1, 2, 1, 3),
}


def _check_plans(plans, B, KV_, G, S_, D_, itemsize, fits):
    """Every plan in the kernel's limits: a cluster of at most 16 blocks,
    at most 8 unless the card holds all its clusters, no more blocks than a
    cluster's share of the tiles of a full cache, none for a cache of at
    most MIN_SPLIT_TILES tiles, the grid within a wave
    once clustered, shared memory for two blocks an SM, a ring as deep as
    a block's share up to three, head chunks of at most HEAD_CHUNK that
    cover G, and column slices in chunks of 8 columns.  The chosen plan comes first and has the
    largest cluster."""
    assert plans and plans[0].cluster == max(p.cluster for p in plans)
    assert len(plans) == len(set(plans)) <= len(dmod.CLUSTERS)
    tiles = -(-S_ // dmod.tile_keys(itemsize))
    for p in plans:
        nchunk = -(-G // p.hc)
        slabs = B * KV_ * nchunk
        blocks = slabs * p.cluster * p.slices
        assert p.cluster in dmod.CLUSTERS and p.cluster <= max(1, tiles)
        assert p.cluster == 1 or tiles > dmod.MIN_SPLIT_TILES
        if p.cluster > dmod.PORTABLE_CLUSTER:
            assert fits(p) >= slabs * p.slices
        if p.cluster > 1:
            assert blocks <= SMS
        smem = dmod.smem_bytes(D_, itemsize, p.slices, p.stages)
        assert smem <= dmod.SMEM_TWO
        share = -(-tiles // p.cluster)
        assert min(share, 3) <= p.stages <= min(share, dmod.MAX_STAGES)
        assert 1 <= p.hc <= dmod.HEAD_CHUNK and (nchunk - 1) * p.hc < G
        assert D_ % p.slices == 0 and \
            (D_ // p.slices) % (16 if itemsize == 2 else 8) == 0
        assert D_ // p.slices >= min(D_, dmod.MIN_COLS)


def _fits(n):
    return lambda plan: n


@pytest.mark.parametrize("shape", _timed_shapes(), ids=lambda s: s[0])
def test_decode_plan_at_every_timed_shape(shape):
    label, B, KV_, G, S_, D_, itemsize = shape
    for n in (0, 64):
        plans = dmod.decode_plans(B, KV_, G, S_, D_, SMS, itemsize,
                                  max_clusters=_fits(n))
        _check_plans(plans, B, KV_, G, S_, D_, itemsize, _fits(n))
        assert plans[0] == dmod.decode_plan(B, KV_, G, S_, D_, SMS, itemsize,
                                            max_clusters=_fits(n))
    assert tuple(plans[0]) == EXPECTED[label]
    # no card's answer: portable clusters only
    plans = dmod.decode_plans(B, KV_, G, S_, D_, SMS, itemsize)
    assert all(p.cluster <= dmod.PORTABLE_CLUSTER for p in plans)


@pytest.mark.parametrize("fits", [0, 7, 64])
def test_llava_takes_16_only_where_its_clusters_fit(fits):
    """LLaVA's image cache (8 kv heads, 53 tiles): 16-block clusters where
    the card holds all 8 at once, else 8-block clusters and two column
    slices, 128 blocks either way."""
    p = dmod.decode_plan(1, 8, 7, 3392, 128, SMS, 2,
                         max_clusters=_fits(fits))
    assert (p.cluster, p.slices) == ((16, 1) if fits >= 8 else (8, 2))
    assert 8 * p.cluster * p.slices == 128


@pytest.mark.parametrize("B,KV_,G,S_,D_", [
    (1, 1, 1, 1, 32), (1, 1, 100, 7, 64), (64, 8, 4, 4096, 128),
    (3, 2, 33, 1000, 80), (1, 1, 32, 512, 128), (1, 4, 8, 4096, 128)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("fits", [None, 64])
def test_decode_plan_stays_in_kernel_limits(B, KV_, G, S_, D_, itemsize,
                                            fits):
    mc = None if fits is None else _fits(fits)
    plans = dmod.decode_plans(B, KV_, G, S_, D_, SMS, itemsize,
                              max_clusters=mc)
    _check_plans(plans, B, KV_, G, S_, D_, itemsize, mc or _fits(0))


def test_rule_reads_shapes_and_the_card_only():
    """The rule takes no length: the lengths lie on the device, and the
    plan must not change with them (a CUDA graph replays one plan)."""
    for fn in (dmod.decode_plans, dmod.decode_plan):
        params = list(inspect.signature(fn).parameters)
        assert params == ["B", "KV", "G", "S", "D", "sms", "itemsize",
                          "max_clusters"]
    a = dmod.decode_plans(1, 8, 7, 3392, 128, SMS, 2, _fits(8))
    assert a == dmod.decode_plans(1, 8, 7, 3392, 128, SMS, 2, _fits(8))


# ----------------------------------------------------------------------
# the source
# ----------------------------------------------------------------------
def _source(name):
    return (pathlib.Path(_build.CSRC) / name).read_text()


def test_source_instantiates_every_head_dim_in_both_dtypes():
    """Both dtypes reach a dispatch that instantiates the kernel at every
    head dim of the wrapper, launched through a cluster and fed by TMA;
    the C constants are the wrapper's."""
    text = _source("decode_attention.cu")
    body = re.search(r"int dispatch_decode\(.*?\n}", text, re.S).group(0)
    dims = tuple(int(d) for d in re.findall(r"case (\d+): return "
                                            r"launch_decode<T, \1>", body))
    assert dims == dmod.HEAD_DIMS
    entry = text[text.index('extern "C"'):]
    for t in ("__nv_bfloat16", "float"):
        assert f"dispatch_decode<{t}>(D" in entry
    for piece in ("kernel<<<grid, kDecodeThreads", "cudaLaunchKernelEx",
                  "cudaLaunchAttributeClusterDimension",
                  "cudaFuncAttributeNonPortableClusterSizeAllowed",
                  "cudaOccupancyMaxActiveClusters", "map_shared_rank",
                  "tma_load_3d", "mbar_arrive_expect_tx", "mbar_try_wait",
                  "encode_tile_map<T>", "mma_bf16(", "ldmatrix_x4(",
                  "ldmatrix_x4_trans("):
        assert piece in text
    consts = dict(re.findall(r"constexpr int (kDecode\w+) = (\d+);", text))
    assert int(consts["kDecodeHeads"]) == dmod.HEAD_CHUNK
    assert int(consts["kDecodeMaxStages"]) == dmod.MAX_STAGES
    assert int(consts["kDecodeThreads"]) == dmod.THREADS
    assert int(consts["kDecodeMaxCluster"]) == max(dmod.CLUSTERS)
    assert "template <typename T>\ninline int encode_tile_map(" in \
        _source("sm90.cuh")


def test_decode_path_has_no_workspace_or_counter():
    """The merge lives in the cluster's shared memory: the kernel takes no
    workspace or counter and issues no atomic, and the wrapper allocates
    nothing but its output."""
    text = _source("decode_attention.cu")
    for gone in (r"arrive_acq_rel", r"atomic[A-Z]\w*\(", r"\batom\.",
                 r"\bcounters\b", r"\bws\b", r"kDecodeMaxSplits",
                 r"kMergeBatch", r"cp_async"):
        assert not re.search(gone, text), gone
    wrapper = (ROOT / "src/repro_torch/kernels/decode_attention.py"
               ).read_text()
    assert "_build.counters" not in wrapper
    launch = wrapper[wrapper.index("def _launch("):]
    assert re.findall(r"torch\.\w+\(", launch) == ["torch.empty_like("]
    for gone in ("MAX_SPLITS", "partial_floats", "split_plan"):
        assert not hasattr(dmod, gone)
    assert not hasattr(ref, "decode_attention_split")


def test_no_rank_is_written_before_the_cluster_has_started():
    """Distributed shared memory may be written only once every block of
    the cluster is known to have started: every thread arrives on the
    cluster barrier before the tile loop, and waits on it before the
    block merge's first push; the stats follow the merge."""
    text = _source("decode_attention.cu")
    kernel = text[text.index("decode_kernel(const __grid_constant__"):]
    kernel = kernel[:kernel.index("\n}\n")]
    arrive = kernel.index("cluster_arrive_relaxed()")
    assert arrive < kernel.index("decode_mma<D>(blk") < \
        kernel.index("blk.push_stats()") < \
        kernel.index("cg::this_cluster().sync()")
    merge = text[text.index("void decode_block_merge("):]
    merge = merge[:merge.index("\n}\n")]
    assert merge.index("cluster_wait()") < merge.index("k.push(")
    for path in ("decode_mma(", "decode_simt("):
        body = text[text.index(f"void {path}"):]
        body = body[:body.index("\n}\n")]
        assert "push" not in body and "map_shared_rank" not in body
        assert "decode_block_merge<D," in body
    assert "__device__ __forceinline__ void cluster_arrive_relaxed()" in \
        _source("sm90.cuh")
