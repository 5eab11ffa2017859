"""The per-layer metrics that read the port's own spans and counters
(``yardstick/recorder.py``), on a tiny traced run of each cell on the CPU,
and with a port that has no recorder."""

import json
import math
import types

import pytest

from conftest import CELLS, HERE, tiny

import run

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
# read from the trace's host spans or the port's counters: on the CPU too
HOST = ("entry_copy_ms", "h2d_mb_per_chunk", "host_syncs_per_chunk")
# extents on a CUDA stream, and kernel loads: none on the CPU
DEVICE = ("assemble_ms_per_chunk", "operands_ms_per_chunk", "eval_ms_per_chunk", "nt_ms_per_chunk", "kernel_load_s")
PROGRAM = {m["name"] for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")}


def reader(name):
    return run.load_module(HERE / "metrics" / f"{name}.py").read


def test_every_program_metric_is_named_here():
    assert PROGRAM == set(HOST) | set(DEVICE) | {"planck_rule_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_program_metrics_on_a_tiny_traced_run(cell):
    from pythonic_disort_torch.utils import profiling

    profiling.reset()
    result = run.run_cell(cell, 2**31 + 4242, 0.3, True, device="cpu", overrides=tiny(cell))
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in HOST:
        assert math.isfinite(got[name]) and got[name] >= 0, name
    assert got["entry_copy_ms"] > 0
    # no copy reaches a CUDA device on the CPU, and no device value is read
    assert got["h2d_mb_per_chunk"] == 0 and got["host_syncs_per_chunk"] == 0
    assert ("planck_rule_ms" in got) == (cell == "lw_flux_temper")
    if cell == "lw_flux_temper":
        assert 0 < got["planck_rule_ms"] < got["planck_ms_per_chunk"]
    assert not set(DEVICE) & set(got)
    profiling.reset()


def test_readers_without_the_recorder(monkeypatch):
    """A port without ``profiling.recorded`` (and no ``disort.`` span in the
    trace): every reader returns None and none raises."""
    from pythonic_disort_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    trace = types.SimpleNamespace(spans=lambda name: [])
    ctx = types.SimpleNamespace(trace=trace, trace_steps=2)
    for name in sorted(PROGRAM):
        assert reader(name)(ctx) is None, name


def test_readers_of_a_record(monkeypatch):
    """The readers' arithmetic on a record made by hand: per traced step,
    device extents summed over their spans, bytes in MB."""
    from yardstick import recorder

    rec = {"spans": {"disort.entry": {"calls": 4, "host_ms": 8.0, "device_ms": None},
                     "disort.solve.outputs": {"calls": 4, "host_ms": 1.0, "device_ms": 2.0},
                     "disort.eval.fluxes": {"calls": 4, "host_ms": 1.0, "device_ms": 6.0}},
           "counters": {"h2d_bytes": 4_000_000, "host_syncs": 28},
           "builds": {"eig_stage": {"seconds": 0.25, "nvcc": False}}, "launches": {}}
    copies = [(10.0, 1010.0), (2000.0, 4000.0)]                       # us
    trace = types.SimpleNamespace(spans=lambda name: copies if name == "disort.entry.copy" else [])
    ctx = types.SimpleNamespace(trace=trace, trace_steps=4)
    monkeypatch.setattr(recorder, "record", lambda: rec)
    assert reader("eval_ms_per_chunk")(ctx) == pytest.approx(2.0)
    assert reader("assemble_ms_per_chunk")(ctx) is None
    assert reader("h2d_mb_per_chunk")(ctx) == pytest.approx(1.0)
    assert reader("host_syncs_per_chunk")(ctx) == 7
    assert reader("entry_copy_ms")(ctx) == pytest.approx(0.75)
    assert reader("kernel_load_s")(ctx) == 0.25
