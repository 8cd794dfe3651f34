"""The port's perf probe (`repro_torch.launch.perf_probe`) against
`repro.launch.perf_probe`.

`top_buffers` aggregates a trace's results by (shape, op) as `repro`'s
aggregates the HLO's: the same rows for the same buffers, written once as
HLO lines for `repro`'s parser and once as the port's trace rows.
`top_collectives` orders the recorded collectives by bytes.  The command
line traces a two-layer cut of a full-width cell in a fresh process (a
fake group of 256 ranks) and prints `repro`'s sections.
"""
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

from repro_torch.launch import perf_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]

BUFFERS = [(64, "float32[4,4]", "add"), (64, "float32[4,4]", "add"),
           (32, "bfloat16[4,4]", "mm"), (256, "float32[8,8]", "mul"),
           (4, "int32[1]", "add"), (64, "float32[4,4]", "mul")]


def _jax_perf_probe():
    """`repro`'s probe module with its dry-run import stubbed (importing
    `repro.launch.dryrun` sets ``XLA_FLAGS`` for 512 devices): the
    parser's helpers are read from the dry run's source."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    src = src.replace('os.environ["XLA_FLAGS"] = '
                      '"--xla_force_host_platform_device_count=512"', "pass")
    dry = types.ModuleType("repro.launch.dryrun")
    dry.__dict__["__file__"] = str(ROOT / "src" / "repro" / "launch" /
                                   "dryrun.py")
    exec(compile(src, "dryrun.py", "exec"), dry.__dict__)
    probe_src = (ROOT / "src" / "repro" / "launch" /
                 "perf_probe.py").read_text()
    mod = types.ModuleType("repro_perf_probe_for_port_test")
    saved = sys.modules.get("repro.launch.dryrun")
    sys.modules["repro.launch.dryrun"] = dry
    try:
        exec(compile(probe_src, "perf_probe.py", "exec"), mod.__dict__)
    finally:
        if saved is None:
            del sys.modules["repro.launch.dryrun"]
        else:
            sys.modules["repro.launch.dryrun"] = saved
    return mod


def _hlo(rows):
    names = {"float32": "f32", "bfloat16": "bf16", "int32": "s32"}
    lines = []
    for i, (_, shape, op) in enumerate(rows):
        d, dims = re.match(r"(\w+)\[([\d,]*)\]", shape).groups()
        lines.append(f"  %v{i} = {names[d]}[{dims}]{{0}} {op}(f32[1] %a)")
    return "\n".join(lines)


def test_top_buffers_aggregates_as_repro_does():
    ours = perf_probe.top_buffers(BUFFERS)
    assert ours[0] == (256, 1, "float32[8,8]", "mul")
    assert ours[1] == (128, 2, "float32[4,4]", "add")
    assert [r[:2] for r in ours] == [(256, 1), (128, 2), (64, 1), (32, 1),
                                     (4, 1)]
    theirs = _jax_perf_probe().top_buffers(_hlo(BUFFERS))
    assert [(b, n, op) for b, n, _, op in ours] == \
        [(b, n, op) for b, n, _, op in theirs]
    assert perf_probe.top_buffers(BUFFERS, k=2) == ours[:2]


def test_top_collectives_orders_by_bytes():
    calls = [(16, "all-reduce", "float32[4]"),
             (4096, "all-gather", "float32[64,16]"),
             (1024, "reduce-scatter", "float32[16,16]"),
             (0, "all-gather-object", "")]
    got = perf_probe.top_collectives(calls)
    assert [r[1] for r in got] == ["all-gather", "reduce-scatter",
                                   "all-reduce", "all-gather-object"]
    assert got[0] == (4096, "all-gather", ["float32[64,16]"])
    assert got[-1][2] == []
    assert perf_probe.top_collectives(calls, k=1) == got[:1]


@pytest.mark.parametrize("extra", [[], ["--unroll", "--donate-cache"]],
                         ids=["plain", "repro-flags"])
def test_command_line_prints_repros_sections(extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf_probe", "--arch",
         "whisper-base", "--shape", "train_4k", "--layers", "2",
         "--override", "remat=none", *extra],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = p.stdout.splitlines()
    assert out[0].startswith("== whisper-base train_4k overrides="
                             "{'n_layers': 2, 'remat': 'none'}")
    assert re.match(r"args \d+\.\d\d GiB  temp \d+\.\d\d GiB  out "
                    r"\d+\.\d\d GiB$", out[1])
    assert out[2].startswith("cost: {'flops': ")
    i = out.index("-- top buffers (aggregated by shape x op) --")
    j = out.index("-- top collectives --")
    assert 3 <= i < j and j - i - 1 == 12
    assert len(out) - j - 1 == 12
    assert all("all-gather" in line or "reduce-scatter" in line
               or "all-reduce" in line for line in out[j + 1:])
