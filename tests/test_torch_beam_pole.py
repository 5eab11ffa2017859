"""The beam's pole guard (``models/disort/solve.py::off_pole``) on the CPU.

The beam's particular solution divides by 1/mu0 - k for every eigenvalue
k of every (mode, layer); the guard moves the mu0 of each solve whose least
|1 - k mu0| lies below the dtype's gap.  Held here, at a small size, against
the plain PyTorch reference (``reference/disort_plain.py``, float64), which
solves the beam by a linear solve of (A + I/mu0) and shares no code with
the port:

- float32 solves set on their pole (mu0 = 1/k to rounding, k from the
  port's own eigen stage) give finite fluxes and u on the batched and the
  single-column paths, within float32's bound of the reference;
- a float64 solve at its pole is continuous with its neighbours at
  mu0 (1 +- 1e-6);
- a float64 solve far from the pole keeps the bits of the unguarded solve;
- gradients to mu0, tau and omega through a moved solve are finite;
- the ``beam_pole_solves`` counter counts exactly the moved solves;
- `off_pole` itself: where a move lands, the order of the moves, mu0 <= 1.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import batch_solve
from pythonic_disort_torch.models.disort import solve as single
from pythonic_disort_torch.parallel.batch import fluxes_at, solve_vmapped, u_corrected_at
from pythonic_disort_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
R, L, NQ, NF = 4, 6, 16, 4
N = NQ // 2
PHI = [0.0, 1.6, 3.1]
f32, f64 = torch.float32, torch.float64
# float32 at the pole: a moved solve is exact at its moved mu0, a gap or
# more off every k, where float32 reads about 0.3 u / d (u its unit
# roundoff); relative to the reference at the unmoved mu0 that is at most
# 0.3 u / gap plus the move, 4 gaps, about 2e-3: held at 1e-2.  Elsewhere
# float32 reads below 1e-4 at this size.
BOUND32_POLE, BOUND32 = 1e-2, 1e-4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


plain = _load("reference/disort_plain.py", "beam_pole_test_plain")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rows(seed=3):
    """Seeded rows in the shortwave cells' ranges: thickness, albedo,
    Henyey-Greenstein moments g^l, delta-M f = g^NQ, the beam."""
    rng = np.random.default_rng(seed)
    tau = np.cumsum(rng.uniform(0.05, 0.5, (R, L)), 1)
    omega = rng.uniform(0.3, 0.99, (R, L))
    g = rng.uniform(0.5, 0.85, (R, L))
    leg = g[..., None] ** np.arange(NQ + 1)
    return dict(tau=tau, omega=omega, leg=leg, f=leg[..., NQ].copy(), mu0=rng.uniform(0.2, 1.0, R),
                I0=np.full(R, math.pi), phi0=rng.uniform(0.0, 2 * math.pi, R))


def _config(only_flux=False):
    return pt.DisortConfig(nquad=NQ, nleg=NQ, nleg_all=NQ + 1, nfourier=NF, nlayers=L, nscoeffs=0, nbdrf=0,
                           has_beam=True, only_flux=only_flux, nt_correct=not only_flux, has_deltam=True)


def _problem(a, dtype, mu0=None, **leaves):
    """The batched problem of rows ``a``; ``mu0`` (a tensor, e.g. a leaf)
    in place of ``a["mu0"]``, and ``leaves`` (tau, omega) likewise."""
    return pt.make_batched_problem(_config(), leaves.get("tau", a["tau"]), leaves.get("omega", a["omega"]), a["leg"],
                                   a["mu0"] if mu0 is None else mu0, a["I0"], phi0=a["phi0"], f_arr=a["f"],
                                   dtype=dtype, device="cpu")


class Guard:
    """`off_pole` as both paths call it, with each call's eigenvalues,
    mu0 and outcome kept."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = single.off_pole

        def watched(mu0, k):
            out = real(mu0, k)
            self.calls.append(dict(mu0=mu0.detach().clone(), k=k.detach().clone(), moved_mu0=out[0].detach().clone(),
                                   moved=out[1].clone()))
            return out

        monkeypatch.setattr(batch_solve, "off_pole", watched)
        monkeypatch.setattr(single, "off_pole", watched)

    def eigenvalues(self):
        """(M, S) eigenvalues of the solves of the calls so far, which are
        then forgotten."""
        k = self.outcome()["k"]
        self.calls.clear()
        return k

    def outcome(self):
        """The calls' eigenvalues, moved mu0 and masks, joined over solves."""
        return {key: torch.cat([c[key] for c in self.calls], dim=-1) for key in ("k", "moved_mu0", "moved")}


def _solve(path, prob, tau):
    """(flux_up, flux_down_diffuse, flux_down_direct, u) at ``tau`` and the
    azimuths PHI: the batched solve, or the single-column one row by row."""
    phi = torch.tensor(PHI, dtype=prob.tau_arr.dtype).expand(R, len(PHI))
    sol = batch_solve.solve_batched(prob) if path == "batched" else solve_vmapped(prob)
    return (*fluxes_at(sol, tau), u_corrected_at(sol, tau, phi))


def _reference(a, mu0, tau):
    """The plain reference in float64 at ``mu0``: the three fluxes as the
    benchmark's NumPy reference forms them from mode 0, and the
    NT-corrected u."""
    T = lambda x: torch.as_tensor(np.asarray(x, np.float64))
    mu0, tau = T(mu0), T(tau)
    sol = plain.solve(T(a["tau"]), T(a["omega"]), T(a["leg"]), T(a["f"]), mu0, T(a["I0"]), T(a["phi0"]), NQ, NQ, NF)
    u0 = plain.modes_at(sol, tau)[:, 0]
    muw = sol.mu * sol.w
    up, dn = 2 * math.pi * (u0[..., :N] @ muw), 2 * math.pi * (u0[..., N:] @ muw)
    _, t = plain._layer_of(sol, tau)
    direct = sol.I0[:, None] * mu0[:, None] * torch.exp(-tau / mu0[:, None])
    dn = dn + sol.I0[:, None] * mu0[:, None] * torch.exp(-t / mu0[:, None]) - direct
    u = plain.intensity(sol, tau, T(np.tile(PHI, (R, 1))), nt_correct=True)
    return up, dn, direct, u


def _row_error(got, ref):
    """(R,) largest difference of a row over its outputs, over the row's
    largest |reference| (the benchmark's row error)."""
    diff = torch.cat([(g.double() - r).abs().reshape(R, -1) for g, r in zip(got, ref)], dim=1).amax(dim=1)
    scale = torch.cat([r.abs().reshape(R, -1) for r in ref], dim=1).amax(dim=1)
    return diff / scale


def _on_pole(k, dtype, rng):
    """Per solve, mu0 = 1/k to rounding in ``dtype`` for one of its
    eigenvalues k in (1, 5) (mu0 in (0.2, 1)), and the lane's distance
    |1 - k mu0|."""
    mu0, dist = [], []
    for s in range(k.shape[1]):
        ks = k[:, s][(k[:, s] > 1.0) & (k[:, s] < 5.0)]
        kk = ks[int(rng.integers(len(ks)))]
        m = (1.0 / kk).to(dtype)
        mu0.append(m)
        dist.append(float((1.0 - kk.double() * m.double()).abs()))
    return torch.stack(mu0), dist


@pytest.mark.parametrize("path", ["batched", "single"])
def test_float32_on_the_pole_is_finite_and_near_the_reference(monkeypatch, path):
    a = _rows()
    guard = Guard(monkeypatch)
    tau = torch.as_tensor(a["tau"] * 0.999, dtype=f32)
    _solve(path, _problem(a, f32), tau)
    mu0, dist = _on_pole(guard.eigenvalues(), f32, np.random.default_rng(1))
    assert max(dist) < 1e-6                                   # on the pole to float32's rounding
    got = _solve(path, _problem(a, f32, mu0=mu0), tau)
    assert all(torch.isfinite(x).all() for x in got)
    moved = guard.outcome()
    assert moved["moved"].all()
    k, m = moved["k"].double(), moved["moved_mu0"].double()
    assert float((1.0 - k * m).abs().amin()) >= single.POLE_GAP[f32] * (1 - 1e-3)   # each move landed
    err = _row_error(got, _reference(a, mu0.double(), tau.double()))
    assert float(err.max()) <= BOUND32_POLE, err
    # the same rows off the pole read float32's usual error
    far = _row_error(_solve(path, _problem(a, f32), tau), _reference(a, a["mu0"], tau.double()))
    assert float(far.max()) <= BOUND32, far


def test_float64_at_the_pole_is_continuous_with_its_neighbours(monkeypatch):
    a = _rows()
    guard = Guard(monkeypatch)
    tau = torch.as_tensor(a["tau"] * 0.999)
    _solve("batched", _problem(a, f64), tau)
    mu0, dist = _on_pole(guard.eigenvalues(), f64, np.random.default_rng(2))
    assert max(dist) < 1e-14
    at = _solve("batched", _problem(a, f64, mu0=mu0), tau)
    assert guard.calls[-1]["moved"].all()
    side = [_solve("batched", _problem(a, f64, mu0=mu0 * (1 + e)), tau) for e in (-1e-6, 1e-6)]
    assert not guard.calls[-1]["moved"].any()
    mid = [0.5 * (x + y) for x, y in zip(*side)]
    jump = _row_error(at, mid)
    step = _row_error(side[0], side[1])
    # the pole lies between its neighbours: within their own difference
    assert all(torch.isfinite(x).all() for x in at)
    assert float(jump.max()) <= 1e-7 and float((jump - step).max()) <= 0, (jump, step)


@pytest.mark.parametrize("path", ["batched", "single"])
def test_float64_far_from_the_pole_keeps_its_bits(monkeypatch, path):
    """Every solve at least the gap off the pole: the outputs are the
    unguarded solve's bits (the guard replaced by one that moves nothing)."""
    a = _rows()
    guard = Guard(monkeypatch)
    tau = torch.as_tensor(a["tau"] * 0.999)
    got = _solve(path, _problem(a, f64), tau)
    k = guard.eigenvalues()
    assert float((1.0 - k * torch.as_tensor(a["mu0"])).abs().amin()) > 1e3 * single.POLE_GAP[f64]
    unguarded = lambda mu0, k: (mu0, torch.zeros(mu0.shape, dtype=torch.bool))
    monkeypatch.setattr(batch_solve, "off_pole", unguarded)
    monkeypatch.setattr(single, "off_pole", unguarded)
    want = _solve(path, _problem(a, f64), tau)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("dtype", [f32, f64])
def test_gradients_through_a_moved_solve_are_finite(monkeypatch, dtype):
    a = _rows()
    guard = Guard(monkeypatch)
    tau_eval = torch.as_tensor(a["tau"] * 0.999, dtype=dtype)

    def loss(mu0_values):
        leaves = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (mu0_values, a["tau"], a["omega"])]
        mu0, tau, omega = leaves
        up, dn, direct, u = _solve("batched", _problem(a, dtype, mu0=mu0, tau=tau, omega=omega), tau_eval)
        return torch.autograd.grad(up.sum() + dn.sum() + u.sum(), leaves)

    loss(a["mu0"])
    mu0, _ = _on_pole(guard.eigenvalues(), dtype, np.random.default_rng(4))
    grads = loss(mu0.numpy())
    assert guard.calls[-1]["moved"].all()
    assert all(torch.isfinite(g).all() and g.abs().amax() > 0 for g in grads)


def test_the_counter_counts_exactly_the_moved_solves(monkeypatch):
    a = _rows()
    guard = Guard(monkeypatch)
    tau = torch.as_tensor(a["tau"] * 0.999, dtype=f32)
    _solve("batched", _problem(a, f32), tau)
    k = guard.eigenvalues()
    pole, _ = _on_pole(k, f32, np.random.default_rng(5))
    far = float((1.0 - k.double() * torch.as_tensor(a["mu0"])).abs().amin(dim=0).min())
    assert far >= 10 * single.POLE_GAP[f32]                  # the rows' own mu0 lie off the pole
    on = torch.tensor([True, False, True, False])
    mu0 = torch.where(on, pole, torch.as_tensor(a["mu0"], dtype=f32))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _solve("batched", _problem(a, f32, mu0=mu0), tau)
        _solve("single", _problem(a, f32, mu0=mu0), tau)
    rec = profiling.recorded()
    profiling.reset()
    assert torch.equal(guard.outcome()["moved"], torch.cat([on, on]))     # the batched call, then R single ones
    assert rec["counters"]["beam_pole_solves"] == 4
    assert rec["spans"]["disort.solve.pole"]["calls"] == 1 + R


def test_off_pole_moves_land_in_order_and_keep_mu0_at_most_1():
    gap = single.POLE_GAP[f64]
    mu0 = torch.tensor([0.5, 0.5, 0.5, 1.0, 0.25], dtype=f64, requires_grad=True)
    k = torch.tensor([[2.0, 2.0 * (1 + 0.5 * gap), 2.0, 1.0, 3.0],
                      [3.0, 3.0, 2.0 * (1 + 2 * gap), 1.0 + 2 * gap, 3.9],
                      [7.0, 7.0, 7.0, 7.0, 7.0]], dtype=f64)
    moved_mu0, moved = single.off_pole(mu0, k)
    factor = (moved_mu0 / mu0).detach()
    assert moved.tolist() == [True, True, True, True, False]
    # the nearest move first (down by 2 gaps), unless it does not land (solve
    # 2: another k there; up by 2 gaps); mu0 = 1 never moves up (solve 3:
    # down by 4 gaps)
    want = torch.tensor([1.0 + c * gap for c in (-2, -2, 2, -4, 0)], dtype=f64)
    assert torch.allclose(factor, want, rtol=0, atol=1e-15)
    assert float(moved_mu0.detach()[4]) == 0.25 and float(moved_mu0.detach().max()) <= 1.0
    dist = (1.0 - k * moved_mu0.detach()).abs().amin(dim=0)
    assert (dist >= gap * (1 - 1e-6)).all()
    g, = torch.autograd.grad(moved_mu0.sum(), mu0)          # d mu0' / d mu0: the factor taken
    assert torch.equal(g, want)


def test_off_pole_takes_the_farthest_move_where_none_lands():
    gap = single.POLE_GAP[f32]
    offsets = torch.arange(-4, 5, dtype=f64) * 1.5 * gap      # a k every 1.5 gaps around 1 / mu0
    mu0 = torch.tensor([0.5], dtype=f32)
    k = (2.0 * (1 + offsets))[:, None].to(f32)
    moved_mu0, moved = single.off_pole(mu0, k)
    dist = (1.0 - k.double() * moved_mu0.double()).abs().amin(dim=0)
    # every move ends half a gap from a k: the farthest of them is taken
    assert bool(moved[0]) and 0.4 * gap <= float(dist[0]) < gap


def test_the_card_checks_pole_step_on_the_cpu():
    """``tools/check_operands.py::pole_step`` at a small chunk on the CPU:
    rows on, inside and just outside their pole, finite and within the
    float32 cell's limit of the float64 step, the guard put back."""
    from pythonic_disort_torch.tools import check_operands

    assert check_operands.pole_step(device="cpu", chunk=(1, 28, 8, 16))
    assert batch_solve.off_pole is single.off_pole
