"""Each kernel's work (`repro_torch.kernels.cost`) against the bounds of
`PERF.md`'s kernel table.

`chip_smoke.py` divides these counts by the H100's data-sheet rates
(3.35 TB/s; 989 TFLOP/s bf16, 67 float32) and prints the larger time as
a kernel's bound; the dry run's shape routes add the same counts into
its record.  Each case here is a row of the table, its bound as printed
(six decimals of a millisecond) and what bounds it.  The pair count's
closed form equals the mask `chip_smoke.py` used to count on numpy.
"""
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import cost

HBM_BPS, BF16_OPS, F32_OPS = 3.35e12, 989e12, 67e12


def bound(work, peak):
    nbytes, ops = work
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (round(t_bytes, 6), "bytes") if t_bytes >= t_ops else \
        (round(t_ops, 6), "operations")


def _mask_pairs(Sq, Sk, causal, window):
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m = k <= q
        if window > 0:
            m &= k > q - window
    return int(m.sum())


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (1, 1, True, 0), (7, 7, True, 0), (100, 100, True, 48), (64, 1500, False,
                                                            0),
    (448, 1500, True, 0), (1500, 448, True, 0), (300, 300, True, 1),
    (33, 17, True, 5)])
def test_attn_pairs_equal_the_mask(Sq, Sk, causal, window):
    assert cost.attn_pairs(Sq, Sk, causal, window) == \
        _mask_pairs(Sq, Sk, causal, window)


@pytest.mark.parametrize("case,want", [
    # (B, H, KV, Sq, Sk, D, itemsize, causal): the table's rows
    ((1, 32, 4, 448, 448, 128, 2, True), (0.002465, "bytes")),
    ((1, 32, 32, 448, 448, 80, 2, True), (0.002739, "bytes")),
    ((1, 64, 8, 448, 448, 128, 2, True), (0.004930, "bytes")),
    ((2, 32, 4, 2048, 2048, 128, 2, True), (0.069518, "operations")),
    ((1, 56, 8, 3328, 3328, 128, 2, True), (0.160594, "operations")),
    ((4, 8, 8, 1500, 1500, 64, 2, False), (0.018637, "operations")),
])
def test_flash_forward_bounds(case, want):
    assert bound(cost.flash_work(*case), BF16_OPS) == want


@pytest.mark.parametrize("case,peak,want", [
    ((2, 32, 4, 2048, 2048, 128, 2, True), BF16_OPS, (0.173794,
                                                      "operations")),
    ((1, 56, 8, 192, 192, 128, 2, True), BF16_OPS, (0.003769, "bytes")),
    ((2, 8, 8, 1500, 1500, 64, 2, False), BF16_OPS, (0.023296,
                                                     "operations")),
    ((4, 8, 8, 128, 128, 64, 4, True), F32_OPS, (0.002524, "operations")),
])
def test_flash_backward_bounds(case, peak, want):
    assert bound(cost.flash_bwd_work(*case), peak) == want


@pytest.mark.parametrize("case,want", [
    # (B, H, KV, D, valid length, itemsize)
    ((1, 32, 4, 128, 449, 2), (0.000279, "bytes")),
    ((1, 56, 8, 128, 3329, 2), (0.004079, "bytes")),
    ((4, 8, 8, 64, 1500, 2), (0.003671, "bytes")),
])
def test_decode_bounds(case, want):
    assert bound(cost.decode_work(*case), BF16_OPS) == want


@pytest.mark.parametrize("rows,D,itemsize,want", [
    (448, 4096, 2, (0.002196, "bytes")),
    (512, 512, 4, (0.000627, "bytes")),
    (6000, 512, 2, (0.003669, "bytes")),
    (448, 7168, 2, (0.003843, "bytes")),
])
def test_rms_norm_bounds(rows, D, itemsize, want):
    assert bound(cost.rms_norm_work(rows, D, itemsize), F32_OPS) == want


@pytest.mark.parametrize("arch,S,Hn,final,want", [
    ("mamba2-1.3b", 448, 64, True, (0.002920, "bytes")),
    ("zamba2-2.7b", 448, 80, True, (0.003207, "bytes")),
    ("mamba2-1.3b", 2048, 64, False, (0.010486, "bytes")),
    ("zamba2-2.7b", 2048, 80, False, (0.012873, "bytes")),
])
def test_ssd_bounds(arch, S, Hn, final, want):
    s = get_config(arch).ssm
    work = cost.ssd_work(S, Hn, s.head_dim, s.state_dim, s.chunk,
                         final=final)
    assert bound(work, BF16_OPS) == want


def test_ssd_work_sums_chunks_and_scales_with_the_batch():
    one = cost.ssd_work(600, 4, 8, 16, 256)
    chunks = [cost.ssd_work(n, 4, 8, 16, 256)[1] for n in (256, 256, 88)]
    assert one[1] == pytest.approx(sum(chunks))
    three = cost.ssd_work(600, 4, 8, 16, 256, B=3)
    assert three[1] == pytest.approx(3 * one[1])
    assert three[0] == 3 * (one[0] - 4 * 4) + 4 * 4


def test_plan_work_counts_the_union_of_intervals():
    sizes = np.array([7, 3, 1, 1, 3, 1, 1])   # a binary trie of 7 nodes
    nbytes, ops = cost.plan_work(sizes, [1, 4, 1], n_models=2, n_engines=3)
    assert ops == (3 + 3 + 3) * (2 * 2 + 12)
    assert nbytes == 6 * (6 * 4 + 2 * 4) + 3 * (4 + 4 + 12 + 4 + 8) + 8


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_prints_these_bounds(chip_smoke):
    """`chip_smoke.py`'s bound of a count is the table's: its peaks are
    this module's."""
    assert (chip_smoke.HBM_BPS, chip_smoke.BF16_OPS, chip_smoke.F32_OPS) == \
        (HBM_BPS, BF16_OPS, F32_OPS)
    b_ms, b_by = chip_smoke.bound(*cost.flash_bwd_work(
        2, 32, 4, 2048, 2048, 128, 2, True), chip_smoke.BF16_OPS)
    assert (round(b_ms, 6), b_by) == (0.173794, "operations")
