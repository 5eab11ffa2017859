"""The Cloud C.1 deck configuration (``benchmark/configs/cloud_c1_sw_g112_nq48_f64.json``)
on the CPU in float64, at its widths: NQuad = NLeg = 48, 300 Legendre
moments, 48 Fourier modes.

- The deck itself (``benchmark/yardstick/cloud.py``): chi_0 = 1, f = chi_48,
  the draws fixed by the seed, the layers outside the deck untouched.
- The port against the benchmark's independent float64 reference
  (``benchmark/yardstick/reference.py``) on 2 rows of 6 layers with a
  2-layer deck: NT-corrected u at one probe a layer and 4 azimuths through
  ``make_batched_problem`` -> ``solve_intensity(probes_per_layer=True)``,
  and ``solve_fluxes``.
- The NT correction's spans and Legendre counter under a profiler.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pythonic_disort_torch as pt
from pythonic_disort_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
PHI = [0.0, 1.6, 3.1, 4.7]
PROBE_OFFSET = 1e-6
SEED = 2**31 + 2026


def _load(name):
    spec = importlib.util.spec_from_file_location(f"cloud_test_{name}", BENCH / "yardstick" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


generator, cloud, reference = _load("generator"), _load("cloud"), _load("reference")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def small_config():
    """The configuration at 2 rows (one g-point a column) of 6 layers, a
    2-layer deck whose top is one of layers 1-3; every width as in the file."""
    config = json.loads((BENCH / "configs" / "cloud_c1_sw_g112_nq48_f64.json").read_text())
    config.update(columns=2, gpoints=1, layers=6)
    config["deck"] = dict(config["deck"], layers=2, top=[1, 3])
    return config


def pool(config, seed=SEED):
    """The generator's pool and the deck laid into it."""
    a = generator.pool(config, seed)
    top = cloud.add_deck(a, config, seed)
    return a, top


@pytest.fixture(scope="module")
def deck():
    config = small_config()
    a, top = pool(config)
    return config, a, top


def test_the_widths_are_the_configurations():
    config = json.loads((BENCH / "configs" / "cloud_c1_sw_g112_nq48_f64.json").read_text())
    assert (config["nquad"], config["nleg"], config["nleg_all"], config["dtype"]) == (48, 48, 300, "float64")
    chi = np.load(Path(__file__).parent / "data" / "leg_coeffs_5.npy") / (2 * np.arange(300) + 1)
    np.testing.assert_array_equal(config["c1_moments"], chi)
    traffic = json.loads((BENCH / "traffic" / "cloud_radiance.json").read_text())
    assert traffic["nfourier"] == 48 and traffic["nt_correct"] and traffic["phi"] == PHI
    assert traffic["probe_offset"] == PROBE_OFFSET


def test_deck_moments_fraction_and_untouched_layers(deck):
    config, a, top = deck
    base = generator.pool(config, SEED)
    n = config["deck"]["layers"]
    assert a["leg"].shape == (2, 6, 300)
    np.testing.assert_array_equal(a["leg"][..., 0], 1.0)
    np.testing.assert_array_equal(a["f_arr"], a["leg"][..., 48])
    assert top.shape == (2,) and ((top >= 1) & (top <= 3)).all()
    thick, base_thick = np.diff(a["tau"], axis=1, prepend=0.0), np.diff(base["tau"], axis=1, prepend=0.0)
    c1 = np.asarray(config["c1_moments"])
    for r in range(2):
        inside = np.zeros(6, bool)
        inside[top[r]:top[r] + n] = True
        out = ~inside
        np.testing.assert_array_equal(a["leg"][r, out], base["leg"][r, out])
        np.testing.assert_array_equal(a["omega"][r, out], base["omega"][r, out])
        np.testing.assert_allclose(thick[r, out], base_thick[r, out], rtol=1e-13)
        assert ((thick[r, inside] >= 1) & (thick[r, inside] <= 6)).all()
        assert ((a["omega"][r, inside] >= 0.9) & (a["omega"][r, inside] <= 0.999)).all()
        # each deck layer's moments are a mix of C.1 and the row's HG draw
        g = base["leg"][r, inside, 1][:, None]
        hg = g ** np.arange(300)
        w = (a["leg"][r, inside, 1] - g[:, 0]) / (c1[1] - g[:, 0])
        assert ((w >= 0.7) & (w <= 1.0)).all()
        np.testing.assert_allclose(a["leg"][r, inside], w[:, None] * c1 + (1 - w[:, None]) * hg, rtol=0, atol=1e-14)
    for k in ("mu0", "I0", "phi0"):
        np.testing.assert_array_equal(a[k], base[k])


def test_deck_draws_repeat_from_the_seed(deck):
    config, a, top = deck
    b, top_b = pool(config)
    c, _ = pool(config, SEED + 1)
    assert (top == top_b).all() and all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tau"], c["tau"])


def _problem(config, a, nfourier, only_flux):
    cfg = pt.DisortConfig(nquad=48, nleg=48, nleg_all=300, nfourier=nfourier, nlayers=config["layers"], nscoeffs=0,
                          nbdrf=0, has_beam=True, only_flux=only_flux, nt_correct=not only_flux, has_deltam=True)
    return pt.make_batched_problem(cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"], phi0=a["phi0"],
                                   f_arr=a["f_arr"], dtype=torch.float64, device="cpu")


def _radiances(config, a):
    p = _problem(config, a, 48, False)
    phi = torch.tensor(np.tile(PHI, (2, 1)))
    return pt.solve_intensity(p, p.tau_arr * (1.0 - PROBE_OFFSET), phi, probes_per_layer=True).numpy()


def _row_errors(got, want):
    """Largest |difference| of each row over its largest |reference|, as
    the benchmark's comparison reads it."""
    diff = np.abs(got - want).reshape(len(want), -1).max(1)
    return diff / np.abs(want).reshape(len(want), -1).max(1)


@pytest.fixture(scope="module")
def solved(deck):
    """The port's u, the reference's, and the reference's without the NT
    correction."""
    config, a, _ = deck
    sol = reference.solve(a["tau"], a["omega"], a["leg"], a["f_arr"], a["mu0"], a["I0"], a["phi0"], 48, 48, 48)
    want = [reference.intensity(sol, a["tau"] * (1.0 - PROBE_OFFSET), np.tile(PHI, (2, 1)), nt_correct=nt)
            for nt in (True, False)]
    return _radiances(config, a), *want


def test_nt_radiances_against_the_reference(solved):
    """Tolerance 1e-9 of each row's largest |u|: float64 roundoff (1e-16)
    grown by the deck's conditioning (thick layers of albedo up to 0.999,
    24 eigenvalues a mode and layer, 288 unknowns a banded solve) reads
    1e-11 to 1.5e-10 on the seeds tried; the exact phase function's series
    cut at 48 moments reads 4e-3 to 1.2 on the same seeds."""
    got, want, _ = solved
    assert got.shape == want.shape == (2, 48, 6, 4)
    assert np.isfinite(got).all()
    assert _row_errors(got, want).max() < 1e-9


def test_nt_correction_is_a_large_part_of_the_radiances(solved):
    """The comparison sees the NT correction: without it the reference's
    radiances move by more than 5e-4 of each row's largest |u|, five
    hundred thousand times the tolerance above."""
    _, want, plain = solved
    assert _row_errors(plain, want).min() > 5e-4


def test_fluxes_against_the_reference(deck):
    """Tolerance 1e-10 of the largest |flux|: fluxes are the zeroth mode's
    moments, smoother than u, and read about 1e-13 here."""
    config, a, _ = deck
    p = _problem(config, a, 1, True)
    got = np.stack([x.numpy() for x in pt.solve_fluxes(p, p.tau_arr)])
    sol = reference.solve(a["tau"], a["omega"], a["leg"], a["f_arr"], a["mu0"], a["I0"], a["phi0"], 48, 48, 1)
    want = np.stack(reference.fluxes(sol, a["tau"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_nt_spans_and_legendre_terms_under_a_profiler(deck):
    """One ``disort.eval.nt.series`` and one ``disort.eval.nt.layers`` a
    call, and 300 + 48 + 300 Clenshaw steps (the exact and truncated phase
    functions, the IMS residual); nothing recorded without a profiler."""
    config, a, _ = deck
    profiling.reset()
    try:
        plain = _radiances(config, a)
        rec = profiling.recorded()
        assert rec["spans"] == {} and rec["counters"] == {}
        with profile(activities=[ProfilerActivity.CPU]):
            traced = _radiances(config, a)
        rec = profiling.recorded()
        for name in ("disort.eval.nt", "disort.eval.nt.series", "disort.eval.nt.layers"):
            assert rec["spans"][name]["calls"] == 1, name
        assert rec["counters"]["legendre_terms"] == 300 + 48 + 300
        np.testing.assert_array_equal(plain, traced)
    finally:
        profiling.reset()


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("name,spans,counters,want", [
    ("nt_series_terms_per_chunk", {}, {"legendre_terms": 1296}, 648.0),
    ("nt_series_terms_per_chunk", {}, {"host_syncs": 18}, None),
    ("nt_series_ms_per_chunk", {"disort.eval.nt.series": {"calls": 2, "host_ms": 9.0, "device_ms": 8.0}}, {}, 4.0),
    ("nt_series_ms_per_chunk", {}, {"legendre_terms": 1296}, None),
])
def test_nt_series_readers(monkeypatch, name, spans, counters, want):
    """The benchmark's two NT series metrics on a record made by hand, per
    traced step; None where the port records no such span or counter (the
    parent of this configuration), and without a trace."""
    import types

    read = _reader(name, monkeypatch)
    from yardstick import recorder

    spans = dict(spans, **{"disort.entry": {"calls": 2, "host_ms": 1.0, "device_ms": None}})
    monkeypatch.setattr(recorder, "record", lambda: {"spans": spans, "counters": counters, "builds": {},
                                                     "launches": {}})
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(spans=lambda name: []), trace_steps=2)
    assert read(ctx) == want
    assert read(types.SimpleNamespace(trace=None, trace_steps=2)) is None


def test_the_cell_runs_on_the_cpu(monkeypatch):
    """``cloud_radiance`` through the benchmark's harness on the CPU, at few
    streams and modes (the 300 moments and the deck as configured): the
    window's steps correct against the reference, and its end-to-end
    metrics reported."""
    monkeypatch.syspath_prepend(str(BENCH))
    spec = importlib.util.spec_from_file_location("cloud_test_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    small = {"config": {"columns": 2, "gpoints": 2, "layers": 8, "nquad": 8, "nleg": 8,
                        "deck": {"layers": 3, "top": [1, 4], "thickness": [1.0, 6.0], "omega": [0.9, 0.999],
                                 "droplet_share": [0.7, 1.0]}},
             "traffic": {"nfourier": 4, "sample_rows": 4}}
    result = run.run_cell("cloud_radiance", 2**31 + 77, 0.2, False, device="cpu", overrides=small)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"columns_per_s", "setup_s"}
