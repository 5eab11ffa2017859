"""The port's recorder (``utils/profiling.py``: ``span``, ``count``,
``recorded``, ``reset``) on the CPU: nothing recorded without a profiler,
the stage spans of the batched solve, the Planck route, the NT intensity
and the backward rules under one, how they nest, that none lies on a
device timeline, that outputs do not change, the kernel loads and
launches it records always, and the benchmark's readers of the gradient
spans and rooflines on hand-made records."""

import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pythonic_disort_torch as pt
from pythonic_disort_torch.ops import _build, planck
from pythonic_disort_torch.utils import profiling

R, L, NQ, NF = 4, 5, 8, 4
SOLVE = {"disort.entry", "disort.entry.copy", "disort.entry.legendre", "disort.solve.assemble", "disort.solve.eig",
         "disort.solve.pole", "disort.solve.operands", "disort.solve.bvp", "disort.solve.outputs"}
NT = {"disort.eval.nt", "disort.eval.nt.series", "disort.eval.nt.layers"}
GRAD = {"disort.grad.bvp", "disort.grad.eig"}


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _arrays():
    rng = np.random.default_rng(11)
    tau = np.cumsum(rng.uniform(0.05, 0.5, (R, L)), 1)
    om, g = rng.uniform(0.3, 0.99, (R, L)), rng.uniform(0.5, 0.85, (R, L))
    leg = g[..., None] ** np.arange(NQ + 1)
    return dict(tau=tau, om=om, leg=leg, f=leg[..., NQ], mu0=rng.uniform(0.2, 1, R), I0=np.full(R, np.pi),
                phi0=rng.uniform(0, 6, R))


def _config(nfourier=1, only_flux=True, nt_correct=False):
    return pt.DisortConfig(nquad=NQ, nleg=NQ, nleg_all=NQ + 1, nlayers=L, nfourier=nfourier, nscoeffs=0, nbdrf=0,
                           has_beam=True, only_flux=only_flux, nt_correct=nt_correct, has_deltam=True)


def _problem(cfg, a):
    return pt.make_batched_problem(cfg, a["tau"], a["om"], a["leg"], a["mu0"], a["I0"], phi0=a["phi0"], f_arr=a["f"],
                                   dtype=torch.float64, device="cpu")


def flux_call():
    a = _arrays()
    p = _problem(_config(), a)
    return pt.solve_fluxes(p, p.tau_arr)


def planck_call():
    temper = torch.linspace(200.0, 300.0, L + 1, dtype=torch.float64).expand(R, L + 1)
    tau = torch.as_tensor(_arrays()["tau"])
    return (planck.s_poly_coeffs_from_temper(tau, temper, 500.0, 1000.0),
            planck.band_integrated_emission(temper[:, -1], 10.0, 500.0))


def nt_probes_call():
    a = _arrays()
    p = _problem(_config(NF, only_flux=False, nt_correct=True), a)
    phi = torch.tensor(np.tile([0.0, 1.6, 3.1], (R, 1)))
    return pt.solve_intensity(p, p.tau_arr * (1 - 1e-6), phi, probes_per_layer=True)


def nt_general_call():
    a = _arrays()
    p = _problem(_config(NF, only_flux=False, nt_correct=True), a)
    phi = torch.tensor(np.tile([0.0, 1.6, 3.1], (R, 1)))
    return pt.solve_intensity(p, p.tau_arr * 0.5, phi)


def jacobian_call():
    """u at tau = 0 on the general path with NT, and d sum(u) / d (tau_arr,
    omega_arr): the backward rules of the BVP solve and of the Jacobi."""
    a = _arrays()
    tau, om = (torch.tensor(a[k], requires_grad=True) for k in ("tau", "om"))
    p = pt.make_batched_problem(_config(NF, only_flux=False, nt_correct=True), tau, om, a["leg"], a["mu0"], a["I0"],
                                phi0=a["phi0"], f_arr=a["f"], dtype=torch.float64, device="cpu")
    u = pt.solve_intensity(p, torch.zeros((R, 1), dtype=torch.float64), torch.tensor(np.tile([0.0, 1.6, 3.1], (R, 1))))
    return (u.detach(), *torch.autograd.grad(u.sum(), (tau, om)))


CALLS = {"flux": (flux_call, SOLVE | {"disort.eval.fluxes"}),
         "planck": (planck_call, {"disort.planck.emission", "disort.planck.rule"}),
         "nt_probes": (nt_probes_call, SOLVE | NT | {"disort.eval.modes"}),
         "nt_general": (nt_general_call, SOLVE | NT | {"disort.eval.modes"}),
         "jacobian": (jacobian_call, SOLVE | NT | GRAD | {"disort.eval.modes"})}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_nothing_recorded_without_a_profiler():
    flux_call()
    rec = profiling.recorded()
    assert rec["spans"] == {} and rec["counters"] == {} and rec["builds"] == {}
    assert profiling.span("disort.entry") is profiling.span("disort.solve.eig", torch.device("cpu"))


def test_backward_records_nothing_without_a_profiler():
    """The backward rules' spans are off, as every span, with no profiler
    running."""
    jacobian_call()
    rec = profiling.recorded()
    assert rec["spans"] == {} and rec["counters"] == {}


def test_block_thomas_backward_records_its_span():
    """The generic block-Thomas Function's backward (the transposed solve
    and the block cotangents) is a ``disort.grad.bvp`` span, one a call."""
    from pythonic_disort_torch.ops.cuda_blocktri import solve_block_tridiag_lanes_cuda

    rng = np.random.default_rng(5)
    n, B = 3, 2
    blocks = [torch.tensor(rng.standard_normal((L, n, n, B)) + (6.0 * np.eye(n)[None, :, :, None] if k == 1 else 0),
                           requires_grad=True) for k in range(3)]
    rhs = torch.tensor(rng.standard_normal((L, n, B)), requires_grad=True)
    call = lambda: torch.autograd.grad(solve_block_tridiag_lanes_cuda(*blocks, rhs).sum(), (*blocks, rhs))
    plain = call()
    assert profiling.recorded()["spans"] == {}
    traced, _ = _profiled(call)
    rec = profiling.recorded()
    assert set(rec["spans"]) == {"disort.grad.bvp"} and rec["spans"]["disort.grad.bvp"]["calls"] == 1
    assert rec["spans"]["disort.grad.bvp"]["device_ms"] is None
    assert all(torch.equal(x, y) for x, y in zip(plain, traced))


@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_call_records_its_spans(call):
    fn, names = CALLS[call]
    _, prof = _profiled(fn)
    rec = profiling.recorded()
    assert set(rec["spans"]) == names
    for s in rec["spans"].values():
        assert s["calls"] >= 1 and s["host_ms"] > 0 and s["device_ms"] is None     # no device on the CPU
    assert {e.name for e in prof.events() if e.name.startswith("disort.")} == names
    # no copy to a CUDA device here, and no host read of one
    assert rec["counters"].get("h2d_bytes", 0) == 0 and rec["counters"].get("host_syncs", 0) == 0
    assert rec["launches"] == {}                          # no kernel launches on the CPU


def test_entry_copies_nest_inside_the_entry_and_no_span_is_on_a_device():
    from torch.autograd import DeviceType

    _, prof = _profiled(flux_call)
    events = [e for e in prof.events() if e.name.startswith("disort.")]
    assert events and all(e.device_type == DeviceType.CPU for e in events)
    entry = [e for e in events if e.name == "disort.entry"]
    copies = [e for e in events if e.name == "disort.entry.copy"]
    assert len(entry) == 1 and len(copies) == 8          # tau, omega, leg, f, mu0, I0, phi0, lam_mu0
    e = entry[0]
    for c in copies:
        assert c.thread == e.thread and e.time_range.start <= c.time_range.start <= c.time_range.end <= e.time_range.end
    assert profiling.recorded()["spans"]["disort.entry.copy"]["calls"] == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_entry_copies_host_arrays_in_their_dtype_and_converts_them(dtype):
    """The entry copies a host array in its own dtype and converts it
    where the problem lives: the problem's tensors hold the bits of a
    conversion on the host, whatever the host array's dtype (float64,
    float32, a Python list)."""
    a = _arrays()
    leg32 = a["leg"].astype(np.float32)
    p = pt.make_batched_problem(_config(), a["tau"], a["om"], leg32, list(a["mu0"]), a["I0"], phi0=a["phi0"],
                                f_arr=a["f"], dtype=dtype, device="cpu")
    for got, host in ((p.tau_arr, a["tau"]), (p.omega_arr, a["om"]), (p.leg_coeffs_all, leg32),
                      (p.mu0, np.asarray(a["mu0"])), (p.I0, a["I0"]), (p.phi0, a["phi0"]), (p.f_arr, a["f"])):
        assert got.dtype == dtype and torch.equal(got, torch.tensor(host, dtype=dtype))


@pytest.mark.parametrize("call", sorted(CALLS))
def test_outputs_bitwise_equal_under_the_profiler(call):
    fn = CALLS[call][0]
    plain = fn()
    traced, _ = _profiled(fn)
    plain, traced = (x if isinstance(x, tuple) else (x,) for x in (plain, traced))
    assert len(plain) == len(traced) and all(torch.equal(x, y) for x, y in zip(plain, traced))


def test_reset_empties_the_record():
    _profiled(flux_call)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("host_syncs", 3)
    profiling.built("eig_stage", 0.5, False)
    profiling.launched("eig_stage")
    profiling.launched("eig_stage")
    rec = profiling.recorded()
    # the flux call's pole guard ran and moved no solve
    assert rec["spans"] and rec["counters"] == {"host_syncs": 3, "beam_pole_solves": 0} and rec["builds"]
    assert rec["launches"] == {"eig_stage": 2}
    profiling.reset()
    rec = profiling.recorded()
    assert rec["spans"] == {} and rec["counters"] == {} and rec["builds"] == {} and rec["launches"] == {}


def test_planck_rule_builds_then_hits():
    """With the rule cache cleared, the first band integral counts one
    build and no hit, and a repeat one hit and no build; the rule's span is
    recorded on the hit too."""
    T = torch.full((R,), 250.0, dtype=torch.float64)
    planck._RULES.clear()
    first, _ = _profiled(lambda: planck.band_integrated_emission(T, 500.0, 1000.0))
    rec = profiling.recorded()
    assert rec["counters"].get("planck_rule_builds") == 1 and "planck_rule_hits" not in rec["counters"]
    profiling.reset()
    again, _ = _profiled(lambda: planck.band_integrated_emission(T, 500.0, 1000.0))
    rec = profiling.recorded()
    assert rec["counters"].get("planck_rule_hits") == 1 and "planck_rule_builds" not in rec["counters"]
    assert rec["spans"]["disort.planck.rule"]["calls"] == 1 and torch.equal(first, again)


@pytest.mark.parametrize("counters,want", [({"planck_rule_hits": 30, "planck_rule_builds": 2}, 93.75),
                                           ({"planck_rule_hits": 64}, 100.0), ({"host_syncs": 6}, None)])
def test_planck_rule_hit_pct_reads_the_counters(monkeypatch, counters, want):
    """The benchmark's ``planck_rule_hit_pct`` on a record made by hand, per
    traced step: hits over lookups in %, None where neither counter counted
    (a port without the rule cache)."""
    import importlib.util
    import pathlib

    bench = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
    monkeypatch.syspath_prepend(str(bench))
    from yardstick import recorder

    spec = importlib.util.spec_from_file_location("planck_rule_hit_pct", bench / "metrics" / "planck_rule_hit_pct.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    rec = {"spans": {"disort.entry": {"calls": 2, "host_ms": 1.0, "device_ms": None}}, "counters": counters,
           "builds": {}, "launches": {}}
    monkeypatch.setattr(recorder, "record", lambda: rec)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(spans=lambda name: []), trace_steps=2)
    assert metric.read(ctx) == want
    assert metric.read(types.SimpleNamespace(trace=None, trace_steps=2)) is None


@pytest.mark.parametrize("compiled", [["eig_stage"], []])
def test_kernel_loads_are_recorded_without_a_profiler(monkeypatch, compiled):
    """`_build.load` with the build stubbed: a kernel compiled, or found
    built; a second load of a loaded kernel records nothing."""
    lib = object()
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda names: list(compiled))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    assert _build.load("eig_stage") is lib
    builds = profiling.recorded()["builds"]
    assert list(builds) == ["eig_stage"] and builds["eig_stage"]["nvcc"] is bool(compiled)
    assert builds["eig_stage"]["seconds"] >= 0
    profiling.reset()
    assert _build.load("eig_stage") is lib and profiling.recorded()["builds"] == {}


def test_launch_counts_one_launch_or_raises_naming_the_kernel(monkeypatch):
    """`_build.launch` through a fake entry point swapped in for kernel 3's
    (`_build.swapped`): the entry gets the arguments and the stream last,
    declared from `_build.SIGNATURES`; a zero return counts one launch
    under ``blocktri``, a nonzero one (a CUDA error code) raises
    ``RuntimeError`` naming the kernel and counts nothing."""
    class FakeLibrary:
        pass

    calls, codes = [], [0, 700]

    def blocktri_f64(*args):
        calls.append(args)
        return codes.pop(0)

    lib = FakeLibrary()
    lib.blocktri_f64 = blocktri_f64
    fake = _build.Build("fake", "blocktri", _build.BUILD_DIR / "fake.so", lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=42))
    with _build.swapped(fake):
        _build.launch("blocktri", torch.float64, "cpu", 1, 2, 3)
        assert calls == [(1, 2, 3, 42)] and profiling.recorded()["launches"] == {"blocktri": 1}
        with pytest.raises(RuntimeError, match="blocktri kernel launch failed: CUDA error 700"):
            _build.launch("blocktri", torch.float64, "cpu", 4, 5, 6)
    assert calls[1] == (4, 5, 6, 42) and profiling.recorded()["launches"] == {"blocktri": 1}
    assert tuple(vars(blocktri_f64).values()) == _build.SIGNATURES["blocktri"][""]    # its signature, declared
    assert "blocktri" not in _build._swapped


def test_totals_under_threads(monkeypatch):
    """Eight threads update one span and one counter at once (the gate
    forced on): no update is lost."""
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                with profiling.span("disort.test"):
                    profiling.count("n")

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = profiling.recorded()
    assert rec["counters"] == {"n": 16000} and rec["spans"]["disort.test"]["calls"] == 16000


def _metric(monkeypatch, name):
    """The benchmark's reader ``metrics/<name>.py`` and its ``yardstick``
    package, the benchmark folder on the path."""
    import importlib
    import importlib.util
    import pathlib

    bench = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
    monkeypatch.syspath_prepend(str(bench))
    spec = importlib.util.spec_from_file_location(name, bench / "metrics" / f"{name}.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    return metric, importlib.import_module("yardstick.recorder")


@pytest.mark.parametrize("name,span", [("grad_bvp_ms_per_chunk", "disort.grad.bvp"),
                                       ("grad_eig_ms_per_chunk", "disort.grad.eig")])
def test_gradient_span_readers_read_the_record(monkeypatch, name, span):
    """``grad_bvp_ms_per_chunk`` and ``grad_eig_ms_per_chunk`` on records
    made by hand: the span's device ms per traced step; None without a
    trace, without the span (a port without the spans) or without a device
    extent (the CPU)."""
    metric, recorder = _metric(monkeypatch, name)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(spans=lambda name: []), trace_steps=4)
    rec = {"spans": {span: {"calls": 4, "host_ms": 2.0, "device_ms": 10.0},
                     "disort.solve.bvp": {"calls": 4, "host_ms": 1.0, "device_ms": 7.0}},
           "counters": {}, "builds": {}, "launches": {}}
    monkeypatch.setattr(recorder, "record", lambda: rec)
    assert metric.read(ctx) == 2.5
    assert metric.read(types.SimpleNamespace(trace=None, trace_steps=4)) is None
    rec["spans"][span]["device_ms"] = None
    assert metric.read(ctx) is None
    del rec["spans"][span]
    assert metric.read(ctx) is None
    monkeypatch.setattr(recorder, "record", lambda: None)
    assert metric.read(ctx) is None


@pytest.mark.parametrize("stage,kernel,shape,flops,nbytes", [
    # kernel 3 on the cloud_jacobian step's transposed solve: L = 60, n = 48, 112 x 48 lanes
    ("blocktri", "blocktri_kernel", {"L": 60, "n": 48, "lanes": 5376},
     59 * (2 * 48 * 48 * 49 + 47 * (3 * 48 * 48 + 48) + 2 * 48 * 48) + 47 * 48 * 49, (3 * 60 * 48 * 48 + 2 * 60 * 48) * 8),
    # kernel 4 on its eigenproblems: n = 24, 9 sweeps in float64, 322 560 lanes
    ("jacobi", "jacobi_eigh_kernel", {"n": 24, "lanes": 322560},
     9 * (6 * 24 * 24 * 23 + 10 * 24 * 23), (2 * 24 * 24 + 24) * 8)])
def test_gradient_roofline_readers(monkeypatch, stage, kernel, shape, flops, nbytes):
    """``blocktri_roofline`` and ``jacobi_roofline`` on a trace made by hand:
    the least time of the traced steps' work at the H100's float64 and HBM
    peaks over the kernels' device seconds, in %; None without a trace,
    without the kernel or without the stage's shapes."""
    metric, _ = _metric(monkeypatch, f"{stage}_roofline")
    seconds = 0.25
    trace = types.SimpleNamespace(stage_seconds=lambda names: seconds if names == {kernel} else None)
    ctx = types.SimpleNamespace(trace=trace, trace_steps=4, shapes={stage: shape}, dtype="float64",
                                stage_kernels={stage: {kernel}, "other": {"x"}})
    least = 4 * shape["lanes"] * max(flops / 34e12, nbytes / 3.35e12)
    assert metric.read(ctx) == pytest.approx(100.0 * least / seconds, rel=1e-12)
    assert 0 < metric.read(ctx) < 100
    assert metric.read(types.SimpleNamespace(**{**vars(ctx), "trace": None})) is None
    assert metric.read(types.SimpleNamespace(**{**vars(ctx), "shapes": {}})) is None
    ctx.stage_kernels[stage] = {"not_run_kernel"}
    assert metric.read(ctx) is None
