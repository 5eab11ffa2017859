"""The benchmark's files, names and readers; a tiny run of every cell on the
CPU against the reference; adding a cell, a configuration and a metric by
files alone."""

import json
import re
import shutil
import sys

import numpy as np
import pytest

from conftest import CELLS, HERE, tiny

import run
from yardstick import reference, work

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PENDING = json.loads((HERE / "pending" / "sw_column.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert all(LINE.match(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"] + PENDING["end_to_end"] + PENDING["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] == 1


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"columns_per_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    assert len(BENCH["per_layer"]) == 7
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_in_order_and_each_reports_what_it_must():
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs == {"rfmip_sw_g224_f64", "rfmip_lw_g256"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in CELLS:
        spec = run.resolve(cell)
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and spec.per_layer
        for m in spec.per_layer:
            assert m["moves"] in names


def test_metrics_moving_columns_per_s_list_exactly_its_cells():
    reporting = set(next(m for m in BENCH["end_to_end"] if m["name"] == "columns_per_s")["workloads"])
    assert reporting == {"sw_flux", "lw_flux_temper", "sw_radiance"}
    for m in BENCH["per_layer"]:
        if m["moves"] == "columns_per_s" and m["name"] not in ("planck_ms_per_chunk", "planck_syncs_per_chunk"):
            assert set(m["workloads"]) == reporting, m["name"]
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_every_file_is_found_by_name():
    files = set()
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        config = json.loads(path.read_text())
        assert config["name"] == c["name"]
        for key in c["reduced"]:
            assert key in config and f"source_{key}" in config
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in BENCH["end_to_end"] + PENDING["end_to_end"]:
        assert callable(run.load_module(HERE / "end_to_end" / f"{m['name']}.py").read)
    for m in BENCH["per_layer"] + PENDING["per_layer"]:
        assert callable(run.load_module(HERE / "metrics" / f"{m['name']}.py").read)
    assert run.stage_kernels() == {"bvp": {"bvp_fused_kernel"}, "eig": {"eig_stage_kernel"}}
    for path in HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(path.relative_to(ROOT))), path


def test_frozen_work_counts_equal_the_validation_script():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for n, sweeps in ((16, 5), (16, 9), (24, 5)):
        assert work.eig_flops(n, sweeps) == chip_smoke.eig_flops(n, sweeps)
    for L, N in ((64, 16), (60, 16), (64, 24)):
        assert work.bvp_flops(L, N) == chip_smoke.bvp_flops(L, N)
    share = work.roofline_pct(67e12, 0.0, 2.0, "float32")
    assert share == pytest.approx(50.0)


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla_client"], ["jaxlib"]), (["flax"], ["flax"]),
    (["pythonic_disort_tpu.ops"], ["pythonic_disort_tpu"]), (["pythonic_disort_torch", "numpy"], []),
    (["pythonic_disort_torch.ops.planck", "jaxtyping"], []),
])
def test_import_check_compares_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


def test_the_harness_imports_no_jax():
    import subprocess

    code = ("import sys; sys.path[:0] = [%r, %r]; import run, control; "
            "from yardstick import reference, trace, sweep; import pythonic_disort_torch; "
            "print(run.forbidden_modules())" % (str(HERE), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", CELLS + ("sw_column",))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_agrees_with_the_reference(cell, trace, capsys, column_root):
    """Each cell, and the pending column cell added by its entries alone."""
    root = column_root if cell == "sw_column" else ROOT
    result = run.run_cell(cell, 2**31 + 12345, 0.3, trace, device="cpu", overrides=tiny(cell), root=root)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks" and list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                                                 "device"]
    spec = run.resolve(cell, root)
    wanted = spec.per_layer if trace else spec.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in wanted}
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["checks"] == result["checks"]
    assert err.strip().splitlines()[-1].startswith(f"check {list(result['checks'])[-1]}:")


@pytest.mark.parametrize("cell", CELLS)
def test_inputs_repeat_from_the_seed(cell):
    from yardstick import generator

    spec = run.resolve(cell, overrides=tiny(cell))
    a, b = generator.pool(spec.config, 2**33 + 7), generator.pool(spec.config, 2**33 + 7)
    c = generator.pool(spec.config, 2**33 + 8)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in c.items()}
    assert not np.array_equal(a["tau"], c["tau"])


def test_reference_agrees_with_the_port_in_float64():
    """The independent reference and the port's plain float64 path: fluxes
    with a beam, with thermal sources, and NT-corrected radiances."""
    import torch
    import pythonic_disort_torch as pt

    rng = np.random.default_rng(5)
    R, L, NQ, NF = 4, 5, 8, 4
    tau = np.cumsum(rng.uniform(0.05, 0.5, (R, L)), 1)
    om, g = rng.uniform(0.3, 0.99, (R, L)), rng.uniform(0.5, 0.85, (R, L))
    leg = g[..., None] ** np.arange(NQ + 1)
    f = leg[..., NQ]
    mu0, I0, phi0 = rng.uniform(0.2, 1, R), np.full(R, np.pi), rng.uniform(0, 6, R)
    sp = np.stack([rng.uniform(0.2, 1, (R, L)), rng.uniform(0, 0.1, (R, L))], -1)
    bp = rng.uniform(0.5, 1.5, R)
    cfg = lambda **k: pt.DisortConfig(nquad=NQ, nleg=NQ, nleg_all=NQ + 1, nlayers=L, nbdrf=0, has_deltam=True, **k)

    p = pt.make_batched_problem(cfg(nfourier=1, nscoeffs=0, has_beam=True, only_flux=True), tau, om, leg, mu0, I0,
                                f_arr=f, dtype=torch.float64, device="cpu")
    got = np.stack([x.numpy() for x in pt.solve_fluxes(p, p.tau_arr)])
    want = np.stack(reference.fluxes(reference.solve(tau, om, leg, f, mu0, I0, phi0, NQ, NQ, 1), tau))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    p = pt.make_batched_problem(cfg(nfourier=1, nscoeffs=2, has_beam=False, only_flux=True), tau, om, leg,
                                np.zeros(R), np.zeros(R), f_arr=f, s_poly_coeffs=sp,
                                b_pos=np.broadcast_to(bp[:, None, None], (R, NQ // 2, 1)).copy(),
                                dtype=torch.float64, device="cpu")
    got = np.stack([x.numpy() for x in pt.solve_fluxes(p, p.tau_arr)])
    sol = reference.solve(tau, om, leg, f, np.full(R, 0.5), np.zeros(R), phi0, NQ, NQ, 1, s_poly=sp, b_pos=bp,
                          has_beam=False)
    np.testing.assert_allclose(got, np.stack(reference.fluxes(sol, tau)), rtol=0, atol=1e-12)

    p = pt.make_batched_problem(cfg(nfourier=NF, nscoeffs=0, has_beam=True, only_flux=False, nt_correct=True),
                                tau, om, leg, mu0, I0, phi0=phi0, f_arr=f, dtype=torch.float64, device="cpu")
    te, ph = tau * (1 - 1e-6), np.tile([0.0, 1.6, 3.1, 4.7], (R, 1))
    got = pt.solve_intensity(p, torch.tensor(te), torch.tensor(ph), probes_per_layer=True).numpy()
    want = reference.intensity(reference.solve(tau, om, leg, f, mu0, I0, phi0, NQ, NQ, NF), te, ph, nt_correct=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_planck_reference_converges():
    from yardstick import planck

    T = np.array([200.0, 250.0, 310.0])
    for lo, hi in ((10.0, 250.0), (2680.0, 3250.0)):
        np.testing.assert_allclose(planck.band_emission(T, lo, hi), planck.band_emission(T, lo, hi, panels=256),
                                   rtol=1e-12)


def test_a_cell_a_configuration_and_a_metric_added_as_files(tmp_path):
    """In a copy of the benchmark: a configuration (fewer layers), a traffic
    mix (other chunks) and a per-layer metric, each a new file and a new
    entry, run without an edit to any file already there."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((HERE / "configs" / "rfmip_sw_g224_f64.json").read_text())
    config.update(name="small_sw", layers=3)
    (tmp_path / "benchmark/configs/small_sw.json").write_text(json.dumps(config))
    traffic = json.loads((HERE / "traffic" / "sw_flux.json").read_text())
    traffic["chunk_columns"] = 1
    (tmp_path / "benchmark/traffic/sw_flux_one.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/metrics/steps_traced.py").write_text("def read(ctx):\n    return ctx.trace_steps\n")
    bench["configs"].append({"name": "small_sw", "source": "test", "file": "benchmark/configs/small_sw.json",
                             "reduced": ["columns", "layers"], "why": "test"})
    bench["workloads"].append({"name": "small.one", "config": "small_sw", "traffic": "sw_flux_one", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "columns_per_s":
            m["workloads"].append("small.one")
    bench["per_layer"].append({"name": "steps_traced", "unit": "count", "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "columns_per_s", "workloads": ["small.one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    copy = run.load_module(tmp_path / "benchmark" / "run.py")
    small = tiny("sw_flux")
    small["config"].pop("layers")
    result = copy.run_cell("small.one", 3, 0.2, True, device="cpu", overrides=small, root=tmp_path)
    assert result["correct"] and result["metrics"]["steps_traced"]["value"] == small["traffic"]["trace_steps"]
    result = copy.run_cell("small.one", 3, 0.2, False, device="cpu", overrides=small, root=tmp_path)
    assert set(result["metrics"]) == {"columns_per_s", "setup_s"}


def test_without_the_program_the_command_fails(tmp_path):
    """A directory with BENCHMARK.json and the benchmark alone: no result."""
    import subprocess

    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sw_flux", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_on_the_card(card, cell):
    """Each cell at its full size for 2 s, traced: correct, and the device
    busy in the traced window."""
    result = run.run_cell(cell, 2**31 + 99, 2.0, True)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["device"]["kind"] == card
