"""The pole guard's readers (``pole_ms_per_chunk``, ``pole_solves_per_chunk``)
on records made by hand and with a port that has no guard, and the float32
shortwave cell ``sw_flux_f32`` in a tiny traced run on the CPU."""

import json
import types

import pytest

from conftest import HERE, tiny

import run
from yardstick import recorder

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def reader(name):
    return run.load_module(HERE / "metrics" / f"{name}.py").read


def _ctx(steps=4):
    return types.SimpleNamespace(trace=types.SimpleNamespace(spans=lambda name: []), trace_steps=steps)


@pytest.mark.parametrize("spans,counters,ms,solves", [
    ({"disort.solve.pole": 8.0}, {"beam_pole_solves": 60}, 2.0, 15.0),
    ({"disort.solve.pole": 0.4}, {}, 0.1, 0.0),             # the guard ran and moved nothing
    ({"disort.solve.eig": 4.0}, {"beam_pole_solves": 3}, None, None),   # a port without the guard
])
def test_readers_of_a_record(monkeypatch, spans, counters, ms, solves):
    rec = {"spans": {name: {"calls": 4, "host_ms": 1.0, "device_ms": d} for name, d in spans.items()},
           "counters": counters, "builds": {}, "launches": {}}
    monkeypatch.setattr(recorder, "record", lambda: rec)
    assert reader("pole_ms_per_chunk")(_ctx()) == (None if ms is None else pytest.approx(ms))
    assert reader("pole_solves_per_chunk")(_ctx()) == solves
    assert reader("pole_solves_per_chunk")(types.SimpleNamespace(trace=None, trace_steps=4)) is None


def test_readers_without_the_recorder(monkeypatch):
    from pythonic_disort_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    for name in ("pole_ms_per_chunk", "pole_solves_per_chunk"):
        assert reader(name)(_ctx()) is None


def test_entries_list_every_cell_whose_driver_reaches_the_guard():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    beam = [w["name"] for w in BENCH["workloads"] if w["name"] != "lw_flux_temper"]
    for name in ("pole_ms_per_chunk", "pole_solves_per_chunk"):
        assert sorted(per_layer[name]["workloads"]) == sorted(beam)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if "sw_flux" in m.get("workloads", []):
            assert "sw_flux_f32" in m["workloads"], m["name"]


def test_sw_flux_f32_on_a_tiny_traced_run():
    from pythonic_disort_torch.utils import profiling

    profiling.reset()
    result = run.run_cell("sw_flux_f32", 2**31 + 4243, 0.3, True, device="cpu", overrides=tiny("sw_flux_f32"))
    profiling.reset()
    assert result["correct"] and result["checks"]["flux_err"]["value"] < 1e-4
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["pole_solves_per_chunk"] >= 0 and "pole_ms_per_chunk" not in got     # no device on the CPU
