"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pythonic_disort_torch/csrc``, holds
each kernel against its plain PyTorch version on inputs taken from real
solves, and drives both paths of the port:

- the batched flux-only sweep of ``bench.py`` (64 layers, NQuad=32, 128
  bands per column, 8-column chunks, delta-M beam, float32) through
  ``make_batched_problem`` and ``solve_fluxes``, checked against the
  port's float64 CPU result, timed and traced;
- the single-column ``pydisort`` in float32: all 35 Stamnes goldens of
  ``tests/data/stamnes`` at the reference thresholds (the thermal sources,
  emissivities and Hapke modes of families 6, 7 and 9c built with the
  port's ``subroutines``) and the 9corrections check, a 64-layer column at
  NQuad=32 with 32 Fourier modes against the port's float64 CPU result,
  and a batched 8-column NQuad=48 chunk, which takes the fused
  boundary-value kernel of 34 <= 2N <= 64 (kernel 7), checked, timed and
  traced;
- first-order gradients: d loss / d omega through ``solve_fluxes`` at the
  bench configuration and at NQuad = 48 (the Jacobi kernel at n = 24,
  kernel 7 forward), and through ``solve`` and ``eval.flux_up`` on the
  64-layer column, which take the Jacobi kernel as their eigen stage and
  the block-Thomas kernel for the transposed solve, against the port's
  float64 CPU gradient, timed and traced;
- the widths the first four kernels do not take (phase 7): ``pydisort`` at
  NQuad = 2, 6 and 30 (odd N) and 68 and 128 (N > 32, 2N > 64), a batched
  NQuad=68 chunk and an NQuad=68 column gradient, which go through the
  wide Jacobi kernel (5) and the wide block-Thomas kernel (6), against the
  port's float64 CPU result; the NQuad = 68 and 128 calls, the chunk and
  the gradient are traced by kernel name;
- the batched intensity path (phase 8): ``bench.py:117-177``'s intensity
  chunk (2 columns x 128 bands, 64 layers, NQuad=32, NFourier=16, delta-M
  beam, NT corrections, float32) through ``solve_intensity`` with one
  probe per layer and through its general path, and a longwave chunk (8
  columns, a linear isotropic source in every layer, surface emission, no
  beam) through ``solve_fluxes`` and ``solve_actinic``, each against the
  port's float64 CPU result on a subset of rows, timed and traced; the NT
  correction's three Legendre series take one launch each of the
  Legendre-series kernel (``csrc/legendre_series.cu``).  Phase 3 holds
  kernel 1 and the fused solve at the intensity chunk's shapes (262 144 eigen lanes,
  B = 4096 boundary-value lanes) and the Legendre-series kernel, bit for
  bit, against the plain loop at a ``cloud_radiance`` chunk's series and
  the intensity chunk's; phase 5 counts its launches in the NT goldens;
- a longwave sweep from temperature profiles (phase 9): the bench chunk's
  optical properties, 128 bands over 10-3250 cm^-1 and one 65-level
  profile a column, through ``ops.planck.s_poly_coeffs_from_temper`` and
  ``band_integrated_emission`` on the card into ``make_batched_problem``
  and ``solve_fluxes``, against the float64 host route (scipy) and the
  port's float64 CPU solve; its gradient with respect to the temperatures
  (and jointly with omega); 8ARTS_A and 8ARTS_B through ``pydisort`` with
  the port's ``subroutines`` against their goldens; and one golden's
  ``interpolate`` and actinic closures in float32 against float64;
- in phase 6 besides: d loss / d mu0 of the bench chunk (m), whose beam
  table at -mu0 is then built on the card, and forward mode (f):
  ``jacobi_eigh`` and ``disort_eigh_lanes`` under ``forward_ad`` against
  float64, the eigen kernel's entry refusing dual operands and the whole
  solve raising under forward mode;
- the resumable sweep driver (phase 10): ``parallel.SweepDriver`` over 16
  bench chunks and a ragged one, with and without overlap, its files
  against ``solve_fluxes`` bit for bit, a resume, its syncs and a trace;
- the mesh (phase 11): ``parallel.default_mesh``, ``shard_batch`` and
  ``solve_fluxes_sharded`` at world 1 in this process on the main-path
  chunk (bit for bit, launches, no collective, no added synchronization,
  timed in turns with ``solve_fluxes``); then two gloo ranks of
  ``pythonic_disort_torch/tools/mesh_worker.py`` sharing the card: the
  bench flux sweep of 16 columns (one chunk a rank) against the unsharded
  solve and float64, ``global_flux_stats`` as an ``all_reduce`` of CUDA
  tensors, the intensity chunk on a ``("columns", "bands")`` mesh, and
  ``SweepDriver`` with the mesh against phase 10's sweep, with a resume.
  A rank that fails, hangs or prints no ``OK`` fails the run.

Every failed check raises, so the exit code is nonzero.  Its last two
lines are a JSON line of per-kernel numbers and ``{"ok": true, "device":
{...}}``.  Without CUDA it exits nonzero and prints no result.  It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from contextlib import contextmanager
from math import pi
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "tests" / "data"

NBANDS, NLAYERS, NQUAD = 128, 64, 32
CHUNK_COLS, REF_COLS, N_CHUNKS, REPS = 8, 2, 8, 3
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and float32 /
# float64 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "float64": 34e12}
# cuSOLVER's batched eigh (behind torch.linalg.eigh on the card) refuses
# 32768 or more 16x16 matrices in one call (CUSOLVER_STATUS_INVALID_VALUE
# with torch 2.11 / CUDA 12.8), so the library yardstick is timed in lane
# chunks, and the plain eigen stage (plain Jacobi) in the same ones.
EIGH_CHUNK = 16384
# The float32 gradient's bound per row, 2e-3 x max|g_ref|, grows by
# (POLE / d)^2 on a row whose distance d to the beam pole (see
# `beam_pole_distance`) is below POLE: the conditioning of the particular
# solution there, which the plain versions in float32 share.  The growth
# stops at POLE_CAP x max|g_ref|, reached at d = POLE / sqrt(5).
POLE, POLE_CAP = 1e-3, 1e-2
# phase 8: bench.py:117-177's intensity chunk (2 columns x 128 bands,
# NFourier = 16, seed 7, timed over BENCH_INT_COLS = 8 columns = 4 chunks)
# and a longwave chunk (8 columns, iso source, no beam); the float64 CPU
# references take 16 and 256 rows (16 384 eigen lanes each, as phase 4's)
INT_COLS, INT_NFOURIER, INT_CHUNKS, INT_REF_ROWS = 2, 16, 4, 16
INT_PHI = (0.0, 1.6, 3.1, 4.7)
LW_REF_ROWS = REF_COLS * NBANDS
# phase 9: the longwave chunk from temperature profiles: RRTMG's longwave
# range, 10-3250 cm^-1, in NBANDS equal bands, and one 65-level profile a
# column, each from its own seed TEMP_SEED + column; the level emissions of
# the float32 Planck route within LW_EMISSION_TOL x their row's maximum of
# the float64 host route (float32's 6e-8 over a 256-node sum)
LW_RANGE, TEMP_SEED, LW_EMISSION_TOL = (10.0, 3250.0), 100, 2e-5
# the golden whose float32 closures phase 9 (e) holds against float64
CLOSURE_GOLDEN = "7c"

def log(*a):
    print(*a, flush=True)


class CheckFailed(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)
    log(f"  ok: {what}")


# ----------------------------------------------------------------- inputs
def bench_arrays(ncols, seed=42, nlayers=NLAYERS, nquad=NQUAD):
    """The generator of bench.py:51-77 (same seed, same draws)."""
    from pythonic_disort_torch.tools.check_bvp import bench_arrays as generator

    return generator(ncols, seed=seed, nlayers=nlayers, nquad=nquad, nbands=NBANDS)


def make_problem(arrs, dtype, device, nquad=NQUAD):
    from pythonic_disort_torch.tools.check_bvp import batched_problem

    prob = batched_problem(arrs, nquad, dtype, device)
    # fluxes at the layer bottoms, with tau already on the device
    return prob, prob.tau_arr


def rows(arrs, n):
    return {k: v[:n] for k, v in arrs.items()}


def intensity_problem(arrs, dtype, device):
    """bench.py:117-177's intensity configuration (NQuad = 32, NFourier =
    16, delta-M beam, NT corrections) with its probes, tau (1 - 1e-6) at
    each layer's bottom, and four azimuths (the mesh worker's, which phase
    11's ranks build)."""
    from pythonic_disort_torch.tools.mesh_worker import intensity_problem as problem

    return problem(arrs, dtype, device, INT_NFOURIER, INT_PHI)


def longwave_arrays(ncols, seed=42):
    """`bench_arrays` (seed 42) with a thermal source in place of the beam:
    per layer a linear isotropic source c0 + c1 tau (c0 in [0.2, 1], c1 in
    [0, 0.1]) and an isotropic surface emission in b_pos ([0.5, 1.5]),
    drawn from their own numpy seed."""
    a = bench_arrays(ncols, seed=seed)
    rng = np.random.default_rng(seed + 1)
    S, L = a["tau"].shape
    a["s_poly"] = np.stack([rng.uniform(0.2, 1.0, (S, L)), rng.uniform(0.0, 0.1, (S, L))], axis=-1)
    a["b_pos"] = np.broadcast_to(rng.uniform(0.5, 1.5, (S, 1, 1)), (S, NQUAD // 2, 1)).copy()
    return a


def longwave_problem(a, dtype, device, only_flux):
    """The longwave chunk: NQuad = 32, NFourier = 1, delta-M, no beam."""
    import pythonic_disort_torch as pt

    S, L = a["tau"].shape
    cfg = pt.DisortConfig(
        nquad=NQUAD, nleg=NQUAD, nleg_all=NQUAD + 1, nfourier=1, nlayers=L, nscoeffs=2, nbdrf=0,
        has_beam=False, only_flux=only_flux, has_deltam=True)
    prob = pt.make_batched_problem(cfg, a["tau"], a["omega"], a["leg"], np.zeros(S), np.zeros(S),
                                   f_arr=a["f_arr"], b_pos=a["b_pos"], s_poly_coeffs=a["s_poly"],
                                   dtype=dtype, device=device)
    return prob, prob.tau_arr


def column_kwargs(nt_cor=False, nquad=NQUAD, nlayers=NLAYERS, nfourier=None):
    """``pydisort`` arguments of one column of the bench generator (column
    0, band 0) with intensity: by default 64 layers, NQuad = 32 and 32
    Fourier modes."""
    a = rows(bench_arrays(1, nlayers=nlayers, nquad=nquad), 1)
    kw = dict(tau_arr=a["tau"][0], omega_arr=a["omega"][0], NQuad=nquad, Leg_coeffs_all=a["leg"][0],
              mu0=float(a["mu0"][0]), I0=float(a["I0"][0]), phi0=1.0, f_arr=a["f_arr"][0], NT_cor=nt_cor)
    return kw if nfourier is None else dict(kw, NFourier=nfourier)


def golden_cases():
    """All 35 Stamnes cases of ``tests/test_stamnes.py`` and
    ``tests/test_stamnes_sources.py``, as ``name -> (pydisort arguments,
    degrees masked around the beam)``; the thermal sources, emissivities and
    Hapke modes of families 6, 7 and 9c come from the port's ``subroutines``
    and ``models.surfaces``, with those tests' arguments."""
    from pythonic_disort_torch.models.surfaces import hapke_fourier_modes
    from pythonic_disort_torch.subroutines import (
        blackbody_contrib_to_BCs as blackbody, generate_emissivity_from_BDRF as emissivity,
        generate_s_poly_coeffs as s_poly)

    def unit(n, second=0.0):
        leg = np.zeros(n)
        leg[0], leg[2] = 1.0, second
        return leg

    def const_bdrf(value):
        return [lambda mu, neg_mup: np.full((len(mu), len(neg_mup)), value)]

    cases = {}
    for name, tau, omega in [("1a", 0.03125, 0.2), ("1b", 0.03125, 1 - 1e-6), ("1c", 0.03125, 0.99),
                             ("1d", 32, 0.2), ("1e", 32, 1 - 1e-6), ("1f", 32, 0.99)]:
        cases[name] = (dict(tau_arr=tau, omega_arr=omega, NQuad=16, Leg_coeffs_all=unit(17),
                            mu0=0.1, I0=pi / 0.1, phi0=pi), 0)
    for name, tau, omega in [("2a", 0.2, 0.5), ("2b", 0.2, 1 - 1e-6), ("2c", 5, 0.5), ("2d", 5, 1 - 1e-6)]:
        cases[name] = (dict(tau_arr=tau, omega_arr=omega, NQuad=16, Leg_coeffs_all=unit(17, second=0.1),
                            mu0=0.080442, I0=pi, phi0=pi), 0)
    hg = 0.75 ** np.arange(32)
    for name, tau in [("3a", 1), ("3b", 8)]:
        cases[name] = (dict(tau_arr=tau, omega_arr=1 - 1e-6, NQuad=16, Leg_coeffs_all=hg,
                            mu0=1, I0=pi, phi0=pi, f_arr=hg[16], NT_cor=True), 0)
    haze = np.load(DATA / "leg_coeffs_4.npy") / (2 * np.arange(83) + 1)
    for name, omega, mu0 in [("4a", 1 - 1e-6, 1), ("4b", 0.9, 1), ("4c", 0.9, 0.5)]:
        cases[name] = (dict(tau_arr=1, omega_arr=omega, NQuad=32, Leg_coeffs_all=haze,
                            mu0=mu0, I0=pi, phi0=pi, f_arr=haze[32], NT_cor=True), 0)
    cloud = np.load(DATA / "leg_coeffs_5.npy") / (2 * np.arange(300) + 1)
    for name, omega in [("5a", 1 - 1e-6), ("5b", 0.9)]:
        cases[name] = (dict(tau_arr=64, omega_arr=omega, NQuad=48, Leg_coeffs_all=cloud,
                            mu0=1, I0=pi, phi0=pi, f_arr=cloud[48], NT_cor=True), 10)

    # family 6: no scattering; BDRF, blackbody boundaries, internal emission
    hapke16 = hapke_fourier_modes(16)
    base6 = dict(tau_arr=1, omega_arr=0, NQuad=16, Leg_coeffs_all=unit(17), mu0=0.5, I0=200, phi0=0)
    b_pos6 = emissivity(8, hapke16[0]) * blackbody(300, 0, 50000)
    b_neg6 = blackbody(250, 0, 50000) + 100 / pi
    flux6 = dict(base6, BDRF_Fourier_modes=hapke16, only_flux=True)
    cases["6b"] = (base6, 0)
    cases["6c"] = (dict(base6, BDRF_Fourier_modes=const_bdrf(0.5)), 0)
    cases["6d"] = (flux6, 0)
    cases["6e"] = (dict(flux6, b_pos=b_pos6), 0)
    cases["6f"] = (dict(flux6, b_pos=b_pos6, b_neg=b_neg6), 0)
    for name, tau in [("6g", 1), ("6h", 10)]:
        cases[name] = (dict(flux6, tau_arr=tau, b_pos=b_pos6, b_neg=b_neg6,
                            s_poly_coeffs=s_poly(tau, np.array([250, 300]), 0, 50000)), 0)

    # family 7: absorption, scattering and every source
    cases["7a"] = (dict(tau_arr=1, omega_arr=0.1, NQuad=16, Leg_coeffs_all=0.05 ** np.arange(17), mu0=0, I0=0,
                        phi0=0, s_poly_coeffs=s_poly(1, np.array([200, 300]), 300, 800)), 0)
    cases["7b"] = (dict(tau_arr=100, omega_arr=0.95, NQuad=16, Leg_coeffs_all=0.75 ** np.arange(17), mu0=0,
                        I0=0, phi0=0, s_poly_coeffs=s_poly(100, np.array([200, 300]), 2702.99, 2703.01)), 0)
    leg7 = 0.8 ** np.arange(24)
    base7 = dict(tau_arr=1, omega_arr=0.5, NQuad=12, Leg_coeffs_all=leg7, mu0=0.5, I0=200, phi0=0,
                 s_poly_coeffs=s_poly(1, np.array([300, 200]), 0, 80000, epsrel=1e-15),
                 b_neg=blackbody(100, 0, 80000, epsrel=1e-15) + 100, f_arr=leg7[12])
    cases["7c"] = (dict(base7, b_pos=blackbody(320, 0, 80000, epsrel=1e-15), NT_cor=True), 0)
    cases["7d"] = (dict(base7, BDRF_Fourier_modes=const_bdrf(1.0), NT_cor=True), 0)
    hapke12 = hapke_fourier_modes(12)
    cases["7e"] = (dict(base7, BDRF_Fourier_modes=hapke12, only_flux=True,
                        b_pos=emissivity(6, hapke12[0]) * blackbody(320, 0, 80000)), 0)

    for name, tau, omega in [("8a", [0.25, 0.5], [0.5, 0.3]), ("8b", [0.25, 0.5], [0.8, 0.95]),
                             ("8c", [1, 3], [0.8, 0.95])]:
        cases[name] = (dict(tau_arr=np.array(tau, np.float64), omega_arr=np.array(omega, np.float64), NQuad=8,
                            Leg_coeffs_all=np.tile(unit(9), (2, 1)), mu0=0, I0=0, phi0=0, b_neg=1 / pi), 0)
    tau9 = np.array([np.arange(i + 2).sum() for i in range(6)], np.float64)
    omega9 = 0.6 + np.arange(1, 7) * 0.05
    leg9b = np.array([1, 2.00916, 1.56339, 0.67407, 0.22215, 0.04725, 0.00671, 0.00068, 0.00005]) \
        / (2 * np.arange(9) + 1)
    for name, leg in [("9a", unit(9)), ("9b", leg9b)]:
        cases[name] = (dict(tau_arr=tau9, omega_arr=omega9, NQuad=8, Leg_coeffs_all=np.tile(leg, (6, 1)),
                            mu0=0, I0=0, phi0=0, b_neg=1 / pi), 0)
    cases["9c"] = (dict(tau_arr=tau9, omega_arr=omega9, NQuad=8,
                        Leg_coeffs_all=np.vstack([(l / 7) ** np.arange(9) for l in np.arange(1, 7)]),
                        mu0=0.5, I0=pi, phi0=0, BDRF_Fourier_modes=const_bdrf(0.5),
                        s_poly_coeffs=s_poly(tau9, 600 + np.arange(7) * 10.0, 999, 1000),
                        b_pos=blackbody(700, 999, 1000) * (1 - 0.5), b_neg=blackbody(550, 999, 1000) + 1), 0)
    return cases


def corrections_case():
    """``tests/test_stamnes_sources.py::test_9corrections``'s medium (six
    layers, NQuad = 4, Lambertian BDRF, thermal boundaries and internal
    sources, a beam), its sources from the port's ``subroutines``: the
    arguments of the uncorrected run, and the delta-M + NT extras."""
    from pythonic_disort_torch.subroutines import blackbody_contrib_to_BCs as blackbody, generate_s_poly_coeffs

    tau = np.array([np.sum(np.arange(i + 2)) for i in range(6)], np.float64)
    leg = np.vstack([((l / 3 + 4) / 7) ** np.arange(4 * 5) for l in np.arange(1, 7)])
    common = dict(tau_arr=tau, omega_arr=0.9 + np.arange(1, 7) * 0.01, NQuad=4, Leg_coeffs_all=leg, mu0=0.5, I0=pi,
                  phi0=0.0, b_pos=blackbody(700, 999, 1000) * (1 - 0.5), b_neg=blackbody(550, 999, 1000) + 1,
                  s_poly_coeffs=generate_s_poly_coeffs(tau, 600 + np.arange(7) * 10.0, 999, 1000),
                  BDRF_Fourier_modes=[lambda mu, neg_mup: np.full((len(mu), len(neg_mup)), 0.5)])
    return common, dict(f_arr=leg[:, 4], NT_cor=True)


def corrections_readings(dtype, device):
    """``tests/test_stamnes_sources.py::test_9corrections``'s readings
    against ``9corrections_test.npz``: max |diff| of flux_up, the diffuse
    flux_down and u, without and with delta-M + NT (the latter 9c)."""
    from pythonic_disort_torch import pydisort
    from pythonic_disort_torch.utils.compare import compare

    common, extras = corrections_case()
    results = np.load(DATA / "stamnes" / "9corrections_test.npz")
    readings = []
    for kw in (common, dict(common, **extras)):
        mu_arr, flux_up, flux_down, _, u = pydisort(**kw, dtype=dtype, device=device)
        out = compare(results, np.full(len(mu_arr), True), np.argsort(mu_arr), flux_up, flux_down, u,
                      verbose=False)
        readings.append((out[0], out[2], out[6]))
    return readings


def arts_a_surface(dtype, device):
    """``tests/test_arts.py::test_8ARTS_A``: the surface intensity of 101
    pure-absorption atmospheres (20 layers, NQuad = 8, linear sources)
    through ``pydisort``, and the golden ``8ARTS_A_test.npy``."""
    from pythonic_disort_torch import pydisort

    data = np.load(DATA / "arts_A.npz")
    src, tau = data["src"], data["tau"]
    out = np.empty(src.shape[0])
    for i in range(src.shape[0]):
        u = pydisort(tau_arr=tau[i], omega_arr=tau[i] * 0, NQuad=8, Leg_coeffs_all=np.ones((len(tau[i]), 1)),
                     I0=0.0, mu0=0.0, phi0=0.0, NLeg=1, NFourier=1, s_poly_coeffs=src[i] * 1e15,
                     dtype=dtype, device=device)[4]
        out[i] = u(tau[i], 0.0).T[-1, -1]
    return out, np.load(DATA / "stamnes" / "8ARTS_A_test.npy")


def arts_b_inputs(ifreq):
    """``tests/test_arts.py::test_8ARTS_B``'s arguments at frequency
    ``ifreq`` (48 layers, NQuad = 40, microwave), the thermal source and
    boundaries from the port's ``subroutines``."""
    from pythonic_disort_torch.subroutines import blackbody_contrib_to_BCs, generate_s_poly_coeffs

    data = np.load(DATA / "arts_B.npz")
    tau = data["optical_thicknesses"][ifreq]
    temper = data["TEMPER"]
    return dict(tau_arr=tau, omega_arr=data["single_scattering_albedo"][ifreq],
                NQuad=int(data["quadrature_dimension"]),
                Leg_coeffs_all=np.hstack([data["legendre_coefficients"][ifreq], np.zeros((len(tau), 1))]),
                mu0=0, I0=0, phi0=0, s_poly_coeffs=generate_s_poly_coeffs(tau, temper, 0.0, 50000.0),
                b_pos=blackbody_contrib_to_BCs(np.mean(temper), 0.0, 50000.0),
                b_neg=blackbody_contrib_to_BCs(np.median(temper), 0.0, 50000.0))


def arts_b_readings(kwargs, ifreq, dtype, device):
    """``tests/test_arts.py::test_8ARTS_B``'s four readings against
    ``8ARTS_B<ifreq>_test.npz``: the largest relative error of u, flux_up,
    the diffuse and the direct flux_down where |diff| > 1e-3."""
    from pythonic_disort_torch import pydisort

    mu_arr, flux_up, flux_down, _, u = pydisort(**kwargs, dtype=dtype, device=device)
    g = np.load(DATA / "stamnes" / f"8ARTS_B{ifreq}_test.npz")
    tau = g["tau_test_arr"]

    def worst(ref, ours):
        d = np.abs(ref - ours)
        return float(np.max(np.divide(d, np.abs(ref), out=np.zeros_like(d), where=ref != 0)[d > 1e-3], initial=0))

    fd, fdir = flux_down(tau)
    return dict(u=worst(g["uu"], u(tau, g["phi_arr"])[np.argsort(mu_arr)].reshape(g["uu"].shape)),
                flux_up=worst(g["flup"], flux_up(tau)), flux_down_diffuse=worst(g["rfldn"], fd),
                flux_down_direct=worst(g["rfldir"], fdir))


ARTS_B_LIMITS = dict(u=1e-2, flux_up=1e-3, flux_down_diffuse=1e-3, flux_down_direct=1e-3)


class Recorder:
    """Stands in for a kernel wrapper: keeps a copy of the operands of its
    last call and passes them on."""

    def __init__(self, wrapper):
        self.wrapper, self.operands = wrapper, None

    def __call__(self, *ops):
        self.operands = tuple(x.clone() if hasattr(x, "clone") else x for x in ops)
        return self.wrapper(*ops)


@contextmanager
def recording(module, name):
    """Record the operands that ``module.name`` (a kernel wrapper) is given."""
    rec = Recorder(getattr(module, name))
    setattr(module, name, rec)
    try:
        yield rec
    finally:
        setattr(module, name, rec.wrapper)


def capture_kernel_inputs(problem, tau, phi=None):
    """Run the batched path once, keeping copies of its kernels' operands:
    ``eig`` (even N <= 32) or ``jacobi_wide`` (the congruence M, other N),
    ``bvp`` (the operands of ``solve_bvp_fused``, any 2N; kernel 7 up to
    2N = 64), ``blocktri`` (the blocks it assembles above 2N = 64;
    kernel 6) and ``operands`` (the keyword arguments of ``bvp_operands``).
    With azimuths ``phi`` the path is ``solve_intensity`` with one probe per
    layer at ``tau``, else ``solve_fluxes``."""
    from pythonic_disort_torch import solve_fluxes, solve_intensity
    from pythonic_disort_torch.models.disort import batch_solve as bs_mod
    from pythonic_disort_torch.ops import cuda_blocktri, cuda_jacobi
    from pythonic_disort_torch.ops import eig as eig_mod
    from pythonic_disort_torch.tools.check_operands import as_kwargs

    with recording(eig_mod, "eig_stage_lanes") as eig, \
            recording(cuda_jacobi, "jacobi_eigh_lanes_wide") as jacobi_wide, \
            recording(bs_mod, "solve_bvp_fused") as bvp, \
            recording(cuda_blocktri, "solve_block_tridiag_lanes_cuda") as blocktri, \
            recording(bs_mod, "bvp_operands") as operands:
        if phi is None:
            solve_fluxes(problem, tau)
        else:
            solve_intensity(problem, tau, phi, probes_per_layer=True)
    return {"eig": eig.operands, "jacobi_wide": jacobi_wide.operands, "bvp": bvp.operands,
            "blocktri": blocktri.operands,
            "operands": None if operands.operands is None else as_kwargs(operands.operands)}


# ----------------------------------------------------------------- timing
def in_chunks(fn, *lanes_ops, chunk=EIGH_CHUNK):
    """Call ``fn`` on consecutive lane chunks (the batch is the last axis)."""
    B = lanes_ops[0].shape[-1]
    for b in range(0, B, chunk):
        fn(*(x[..., b:b + chunk] for x in lanes_ops))


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOP_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def eig_flops(n, sweeps):
    """Operations the eigen stage needs per lane: two Cholesky
    factorizations (n^3/3 each), the congruence M = L^T (-At) L (two
    triangular products, 2n^3), the Jacobi sweeps (n - 1 rounds of n/2
    pairs; a pair takes one 2n dot and the rotation of its two rows of C
    and of Z, 12n: 7n^2(n - 1) per sweep) and the back-transforms
    V = L^-T Z and L Z (2n^3) with the scalings by K (2n^2)."""
    chol = 2 * n**3 / 3
    congruence = 2 * n**3
    jacobi = 7 * n * n * (n - 1) * sweeps
    back = 2 * n**3 + 2 * n * n
    return chol + congruence + jacobi + back


def bvp_flops(L, N):
    """Operations of the BVP solve per lane, as the kernel does them: the
    layer correction Low H u (L-1 layers), the Gauss-Jordan elimination of
    the 2N x (3N+1) system (L layers) and the back substitution."""
    corr = 2 * N * (2 * N * (N + 1) + 2 * N * N)
    gj = 4 * N * (4 * N * N + 3 * N)
    back = 8 * N * N
    return (L - 1) * corr + L * gj + (L - 1) * back


def jacobi_flops(n, sweeps):
    """Operations the two-sided Jacobi needs per lane: per sweep, for each
    of the n(n-1)/2 pairs, the pivot (about 20), the rotation of one
    triangle of the symmetric A (two of its rows, 6n) and of two rows of V
    (6n).  The kernel's second triangle and re-symmetrization are not
    counted: symmetric storage would not do them."""
    return sweeps * (6 * n * n * (n - 1) + 10 * n * (n - 1))


def blocktri_flops(L, n):
    """Operations of the generic block-Thomas solve per lane, as the
    algorithm needs them: the layer correction [D | r] - Low [W | g]
    (L-1 layers, 2n^2(n+1)); the Gauss-Jordan elimination, whose step k
    updates the n-1 rows other than the pivot row in the columns right of
    k, over n x (2n+1) in the first L-1 layers (2(n-1) sum_k (2n-k) =
    (n-1)(3n^2+n) each) and over [dhat | rhat] alone, n x (n+1), in the
    last (2(n-1) sum_k (n-k) = (n-1)n(n+1)); and the back substitution
    (L-1 layers, 2n^2).  A layer's O(n^2) multipliers, reciprocals and
    scalings are not counted."""
    return (L - 1) * (2 * n * n * (n + 1) + (n - 1) * (3 * n * n + n) + 2 * n * n) + (n - 1) * n * (n + 1)


# ------------------------------------------------------------ eigen checks
def log_eig_errors(label, e):
    log(f"  {label}: sorted K rel {e['k_rel']:.3e}, |At Bt V - V K^2| {e['r_eig']:.3e}, "
        f"|Yr - Bt V/K| {e['r_y']:.3e}, |Pr V - I| {e['r_p']:.3e}, |Qr Yr - I| {e['r_q']:.3e}")


def eig_sweep_control(At, Bt, Kp, sweeps):
    """The eigen kernel with fewer Jacobi sweeps than its fixed count,
    called through its C entry point (not counted as a launch): a control
    for the limits of `tools.check_eig.EIG_TOL`."""
    from pythonic_disort_torch.tools.check_eig import eig_errors, run_sweeps

    err, outs = run_sweeps(At, Bt, sweeps)
    check(err == 0, f"{sweeps}-sweep control launched")
    e = eig_errors(At, Bt, outs, Kp)
    log_eig_errors(f"control, {sweeps} sweeps", e)
    return e


def eig_checks(At, Bt, label, full=False, Kp=None):
    """Kernel vs plain, order-free; returns (max_abs_err, max_rel_err)."""
    import torch
    from pythonic_disort_torch.ops.cuda_eig import eig_stage_lanes
    from pythonic_disort_torch.tools.check_eig import EIG_READINGS, EIG_TOL, eig_errors, plain_K

    outs = eig_stage_lanes(At, Bt)
    torch.cuda.synchronize()
    Kp = plain_K(At, Bt) if Kp is None else Kp
    check(all(torch.isfinite(x).all() for x in outs), f"{label}: outputs finite")
    e = eig_errors(At, Bt, outs, Kp)
    log_eig_errors(label, e)
    tol = EIG_TOL[str(At.dtype).removeprefix("torch.")]
    for k, what in EIG_READINGS.items():
        check(e[k] < tol[k], f"{label}: {what} < {tol[k]:g}")
    if full:
        eye = torch.eye(At.shape[0], dtype=torch.float64, device=At.device)
        V64, B64 = outs[1].double().permute(2, 0, 1), Bt.double().permute(2, 0, 1)
        # per-lane orthogonality of Z = L^T V (tests_tpu bound 1e-4)
        Lc = torch.linalg.cholesky(-B64)
        Z = Lc.transpose(-1, -2) @ V64
        orth = (Z.transpose(-1, -2) @ Z - eye).abs().amax(dim=(1, 2))
        log(f"  {label}: per-lane max |Z^T Z - I| = {orth.max().item():.3e}")
        check(orth.max().item() < 1e-4, f"{label}: per-lane orthogonality < 1e-4 at B={At.shape[2]}")
    return e["k_abs"], e["k_rel"]


def bvp_checks(ops, label):
    """Kernel vs the plain version in float64 on the same inputs."""
    import torch
    from pythonic_disort_torch.ops.cuda_blocktri import solve_bvp_fused, solve_bvp_fused_plain

    x = solve_bvp_fused(*ops)
    torch.cuda.synchronize()
    xp = solve_bvp_fused_plain(*(o.double() for o in ops))
    err = (x.double() - xp).abs()
    lane_scale = xp.abs().amax(dim=(0, 1))
    rel = (err.amax(dim=(0, 1)) / lane_scale).max().item()
    log(f"  {label}: max |x - x64| {err.max().item():.3e}, per-lane rel {rel:.3e}")
    check(torch.isfinite(x).all().item(), f"{label}: x finite")
    # f32 roundoff grown by the conditioning of the pivoted block
    # elimination; f64 runs hold the kernel to its own precision
    tol = 1e-3 if x.dtype == torch.float32 else 1e-9
    check(rel < tol, f"{label}: x within {tol:g} of the float64 plain solve (per lane)")
    return err.max().item(), rel


def lane_rel_err(x, ref):
    """Largest per-lane error of ``x`` (L, n, B), relative to the lane's
    largest |ref|; also the largest absolute error."""
    err = (x.double() - ref.double()).abs()
    return err.max().item(), (err.amax(dim=(0, 1)) / ref.double().abs().amax(dim=(0, 1))).max().item()


def blocktri_checks(ops, label, fused_x=None):
    """The generic block-Thomas kernel vs its plain version in float64 on the
    same blocks (the ignored edge blocks zeroed for the plain version), and
    vs the fused kernel's x where that is given."""
    import torch
    from pythonic_disort_torch.ops.blocktri import solve_block_tridiag_lanes
    from pythonic_disort_torch.ops.cuda_blocktri import solve_block_tridiag_lanes_cuda

    x = solve_block_tridiag_lanes_cuda(*ops)
    torch.cuda.synchronize()
    xp = solve_block_tridiag_lanes(*(o.double().nan_to_num(0.0) for o in ops))
    err, rel = lane_rel_err(x, xp)
    log(f"  {label}: max |x - x64| {err:.3e}, per-lane rel {rel:.3e}")
    check(torch.isfinite(x).all().item(), f"{label}: x finite")
    # the limits of bvp_checks: the same pivoted elimination
    tol = 1e-3 if x.dtype == torch.float32 else 1e-9
    check(rel < tol, f"{label}: x within {tol:g} of the float64 plain solve (per lane)")
    if fused_x is not None:
        _, rel_fused = lane_rel_err(x, fused_x)
        log(f"  {label}: per-lane rel against solve_bvp_fused {rel_fused:.3e}")
        check(rel_fused < tol, f"{label}: x within {tol:g} of the fused kernel's x (per lane)")
    return err, rel


def congruence(At, Bt):
    """M = L^T (-At) L with L = chol(-Bt), lanes (n, n, B): what the eigen
    stage's gradient route diagonalizes with the Jacobi kernel."""
    import torch

    Lc = torch.linalg.cholesky(-Bt.permute(2, 0, 1))
    return (Lc.mT @ (-At.permute(2, 0, 1)) @ Lc).permute(1, 2, 0).contiguous()


def jacobi_checks(At, label, more_sweeps=0, keys=None):
    """The Jacobi kernel, ``more_sweeps`` past its default count, against
    its plain version in float64 on the same matrices, order-free: sorted
    w, per-lane |V^T V - I| and per-lane |V diag(w) V^T - A| (``keys``,
    default all, held to `tools.check_jacobi.LIMITS`)."""
    import torch
    from pythonic_disort_torch.ops.cuda_jacobi import jacobi_eigh_lanes
    from pythonic_disort_torch.ops.jacobi import default_sweeps, jacobi_eigh_lanes_plain
    from pythonic_disort_torch.tools.check_jacobi import LIMITS, check_readings, readings

    n = At.shape[0]
    w, V = jacobi_eigh_lanes(At, default_sweeps(n, At.dtype) + more_sweeps)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(w).all() and torch.isfinite(V).all()), f"{label}: outputs finite")
    w64 = jacobi_eigh_lanes_plain(At.double(), default_sweeps(n, torch.float64))[0].T.sort(dim=1).values
    r = readings(At, w, V, w64)
    keys = keys or tuple(LIMITS[At.dtype])
    check(check_readings(label, r, At.dtype, log=log, keys=keys) == 0,
          f"{label}: {', '.join(keys)} within {LIMITS[At.dtype]}")
    return r


def bvp_gradient_route_check(ops, label):
    """Gradients of sum(x * r), r fixed and random, through the fused BVP
    kernel's Function and through the assembled blocks and the generic
    kernel's Function, in float32: each held to the fused route's gradient
    in float64 on the same operands within rtol 2e-3 and 1e-5 x max|g| (the
    float32 bound of tests_tpu/test_tpu_production.py for the two routes'
    comparison).  The two float32 routes' difference is logged: at 2N = 48
    the last layer's x is known to float32 only to about 1e-3 of its own
    scale, and the two routes' errors there differ in sign.  Returns the
    fused route's largest error over max|g|."""
    import torch
    from pythonic_disort_torch.ops.blocktri import assemble_bvp_blocks
    from pythonic_disort_torch.ops.cuda_blocktri import solve_block_tridiag_lanes_cuda, solve_bvp_fused

    r = torch.randn(ops[3].shape, generator=torch.Generator(device=ops[3].device).manual_seed(0),
                    device=ops[3].device, dtype=ops[3].dtype)

    def grads(route, operands, weights):
        leaves = [o.detach().clone().requires_grad_() for o in operands]
        return torch.autograd.grad((route(*leaves) * weights).sum(), leaves)

    fused = grads(solve_bvp_fused, ops, r)
    assembled = grads(lambda G, d, b, rhs: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(G, d, b), rhs),
                      ops, r)
    ref = grads(solve_bvp_fused, tuple(o.double() for o in ops), r.double())
    worst = 0.0
    for i, name in enumerate(("Gt", "decay_t", "bt_rows", "rhs_t")):
        b = ref[i]
        scale = b.abs().max().item()
        log(f"  {label}: d/d {name}: max |fused - assembled| / max|g| = "
            f"{(fused[i].double() - assembled[i].double()).abs().max().item() / scale:.3e} (both float32)")
        for route, g in (("fused", fused[i]), ("assembled", assembled[i])):
            a = g.double()
            err = (a - b).abs()
            excess = (err - 2e-3 * b.abs()).max().item() / scale
            if route == "fused":
                worst = max(worst, err.max().item() / scale)
            log(f"  {label}: d/d {name}: max |{route} - float64| / max|g| = {err.max().item() / scale:.3e}")
            check(bool(torch.isfinite(a).all()) and excess <= 1e-5,
                  f"{label}: d/d {name} of the {route} route agrees with the float64 gradient "
                  "within rtol 2e-3, atol 1e-5 x max|g|")
    return worst


# ------------------------------------------------------------------ phases
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from pythonic_disort_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(_build.kernel_sources())
    log(f"built {_build.kernel_sources()} in {time.perf_counter() - t0:.1f} s")
    # what ptxas reports for every kernel variant
    for name in _build.kernel_sources():
        for args, regs, stack, st, ld, smem in _build.current(name).ptxas():
            log(f"  ptxas {name}<{args}>: {regs} registers, stack {stack} B, spill stores {st} B, "
                f"spill loads {ld} B, static shared {smem} B")


def phase_kernels(main_ops):
    import torch
    from pythonic_disort_torch import pydisort
    from pythonic_disort_torch.ops import cuda_blocktri
    from pythonic_disort_torch.ops import eig as eig_mod
    from pythonic_disort_torch.ops.blocktri import assemble_bvp_blocks, solve_block_tridiag_lanes
    from pythonic_disort_torch.ops.cuda_blocktri import (
        solve_block_tridiag_lanes_cuda, solve_bvp_fused, solve_bvp_fused_plain, transposed_system)
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.ops.cuda_eig import (
        eig_stage_lanes, eig_stage_lanes_plain, jacobi_sweeps)
    from pythonic_disort_torch.ops.cuda_jacobi import jacobi_eigh_lanes, jacobi_eigh_lanes_wide
    from pythonic_disort_torch.ops.jacobi import _round_robin_schedule, default_sweeps, jacobi_eigh_lanes_plain
    from pythonic_disort_torch.tools.check_blocktri import random_blocks
    from pythonic_disort_torch.tools.check_bvp import spill_bytes
    from pythonic_disort_torch.tools.check_eig import EIG_TOL, function_operands, plain_K
    from pythonic_disort_torch.tools.check_jacobi import (
        DEFAULT_SWEEP_READINGS, constant_diagonal_matrices, scan_matrices, tied_matrices)

    log("phase 3: kernels against their plain versions")
    At, Bt = main_ops["eig"]
    Kp = plain_K(At, Bt)
    eig_abs, eig_rel = eig_checks(At, Bt, f"eig n={At.shape[0]} B={At.shape[2]} f32", full=True, Kp=Kp)
    # controls: the kernel one and two sweeps short of its fixed count
    sweeps, tol = jacobi_sweeps(At.dtype), EIG_TOL["float32"]
    eig_sweep_control(At, Bt, Kp, sweeps - 1)
    short = eig_sweep_control(At, Bt, Kp, sweeps - 2)
    check(short["k_rel"] >= tol["k_rel"] or short["r_eig"] >= tol["r_eig"],
          f"the float32 limits reject the {sweeps - 2}-sweep control")
    small = capture_kernel_inputs(*make_problem(
        bench_arrays(1, seed=5, nlayers=10, nquad=8), torch.float32, "cuda", nquad=8))
    eig_checks(*(x[..., :1000].contiguous() for x in small["eig"]), "eig n=4 B=1000 f32 (ragged)")
    eig_checks(At[..., :4096].double().contiguous(), Bt[..., :4096].double().contiguous(), "eig n=16 B=4096 f64")
    # the variant with 24-entry rows (16 < n <= 24), NQuad = 48
    eig_checks(*function_operands(24, 3000, 8, torch.float32, "cuda"), "eig n=24 B=3000 f32 (ragged)")
    eig_checks(*function_operands(24, 500, 9, torch.float64, "cuda"), "eig n=24 B=500 f64 (ragged)")

    ops = main_ops["bvp"]
    bvp_abs, bvp_rel = bvp_checks(ops, f"bvp L={ops[0].shape[0]} 2N={ops[0].shape[1]} B={ops[0].shape[3]} f32")
    one = capture_kernel_inputs(*make_problem(bench_arrays(7, seed=6, nlayers=1), torch.float32, "cuda"))
    bvp_checks(tuple(o[..., :777].contiguous() for o in one["bvp"]), "bvp L=1 B=777 f32 (ragged)")
    five = capture_kernel_inputs(*make_problem(bench_arrays(8, seed=7, nlayers=5), torch.float64, "cuda"))
    bvp_checks(tuple(o[..., :1001].contiguous() for o in five["bvp"]), "bvp L=5 B=1001 f64 (ragged)")

    # the generic block-Thomas kernel: explicit blocks from the same operands,
    # against its plain version and against the fused kernel's x
    bt_main = tuple(x.contiguous() for x in (*assemble_bvp_blocks(*ops[:3]), ops[3]))
    shape = lambda o: f"L={o[1].shape[0]} n={o[1].shape[1]} B={o[1].shape[3]}"
    bt_abs, bt_rel = blocktri_checks(bt_main, f"blocktri {shape(bt_main)} f32 (main-path blocks)",
                                     fused_x=solve_bvp_fused(*ops))
    # kernel 3 at n = 48: the NQuad=48 chunk's boundary-value operands,
    # assembled as the route kernel 7 replaced assembled them
    nquad48 = capture_kernel_inputs(*make_problem(
        bench_arrays(CHUNK_COLS, seed=11, nquad=48), torch.float32, "cuda", nquad=48))
    assembled = lambda o: tuple(x.contiguous() for x in (*assemble_bvp_blocks(*o[:3]), o[3]))
    bt_wide = assembled(nquad48["bvp"])
    blocktri_checks(bt_wide, f"blocktri {shape(bt_wide)} f32 (NQuad=48 batched solve's blocks)")
    wide64 = assembled(capture_kernel_inputs(*make_problem(
        bench_arrays(1, seed=12, nlayers=6, nquad=48), torch.float64, "cuda", nquad=48))["bvp"])
    blocktri_checks(tuple(o[..., :33].contiguous() for o in wide64), "blocktri L=6 n=48 B=33 f64 (ragged)")
    with recording(cuda_blocktri, "solve_block_tridiag_lanes_cuda") as rec, \
            recording(eig_mod, "eig_stage_lanes") as eig_col:
        pydisort(**column_kwargs(), dtype=torch.float32, device="cuda")
    bt_col = rec.operands
    blocktri_checks(bt_col, f"blocktri {shape(bt_col)} f32 (single-column solve)")
    with recording(cuda_blocktri, "solve_block_tridiag_lanes_cuda") as rec:
        pydisort(**column_kwargs(), dtype=torch.float64, device="cuda")
    bt_col64 = rec.operands
    blocktri_checks(bt_col64, f"blocktri {shape(bt_col64)} f64 (single-column solve)")
    # the batched gradient step's backward solve: the main-path blocks
    # transposed as the backward of solve_bvp_fused transposes them (the
    # forward right-hand side in place of the loss's cotangent), in f32 and
    # f64, and the NQuad=48 chunk's blocks in f64
    bt_grad = tuple(x.contiguous() for x in (*transposed_system(*bt_main[:3]), ops[3]))
    blocktri_checks(bt_grad, f"blocktri {shape(bt_grad)} f32 (transposed main-path blocks, the gradient's solve)")
    bt_grad64 = tuple(x.double() for x in bt_grad)
    blocktri_checks(bt_grad64, f"blocktri {shape(bt_grad64)} f64 (transposed main-path blocks)")
    bt_wide64 = tuple(x.double() for x in bt_wide)
    blocktri_checks(bt_wide64, f"blocktri {shape(bt_wide64)} f64 (NQuad=48 batched solve's blocks)")
    bt_ptxas = {args: dict(registers=regs, stack=stack, spill_stores=st, spill_loads=ld)
                for args, regs, stack, st, ld, _ in _build.current("blocktri").ptxas()}
    for args, r in bt_ptxas.items():
        log(f"  blocktri variant <{args}>: {r['registers']} registers, {r['spill_stores'] + r['spill_loads']} B spilled")
    check(all(r["spill_stores"] + r["spill_loads"] == 0 for r in bt_ptxas.values()),
          "no variant of the block-Thomas kernel spills")
    # general dense blocks; the edge blocks lower[0], upper[L-1] hold NaN
    for L_, n_, B_, dt in [(1, 16, 7, torch.float32), (3, 8, 1, torch.float32), (5, 32, 33, torch.float32),
                           (4, 48, 7, torch.float32), (6, 64, 9, torch.float64), (3, 2, 40, torch.float64)]:
        blocktri_checks(random_blocks(L_, n_, B_, 100 * L_ + n_, dt),
                        f"blocktri L={L_} n={n_} B={B_} {str(dt).removeprefix('torch.')} (dense, NaN edge blocks)")

    # the two-sided Jacobi kernel: on the congruence M of the main-path
    # operands (what the eigen stage's gradient route diagonalizes), n = 24
    # ragged, float64, diagonals tied in pairs or constant, and the TPU
    # kernel's 131072-lane reconstruction scan
    M = congruence(At, Bt)
    jac = jacobi_checks(M, f"jacobi n={M.shape[0]} B={M.shape[2]} f32 (main-path congruence M)")
    jacobi_checks(congruence(*function_operands(24, 3000, 8, torch.float32, "cuda")),
                  "jacobi n=24 B=3000 f32 (ragged)")
    # the congruence in float64 too: a float32 M is symmetric only to float32
    # roundoff, which the reconstruction reading would measure
    jacobi_checks(congruence(At[..., :4096].double(), Bt[..., :4096].double()), "jacobi n=16 B=4096 f64")
    tied = tied_matrices(16, 4096, 3, torch.float32)
    p0, q0 = _round_robin_schedule(16)
    diag = tied.diagonal(dim1=0, dim2=1)                    # (B, n)
    met = int((diag[:, p0[0]] == diag[:, q0[0]]).any(dim=1).sum())
    log(f"  tied diagonals: {met} of {tied.shape[2]} lanes meet a tied pair in their first round")
    check(met > 0, "the tied batch exercises the rotation of a tied pair")
    jacobi_checks(tied, "jacobi n=16 B=4096 f32 (diagonals tied in pairs)")
    # every pair of the first sweep tied: the TPU kernel's skip would
    # return the constant diagonal as the eigenvalues.  Held at the default
    # sweep count on w and orthogonality, one sweep later on every reading
    # (`tools.check_jacobi.DEFAULT_SWEEP_READINGS`)
    for n_, B_, dt in ((2, 4096, torch.float32), (4, 4096, torch.float32), (16, 4096, torch.float32),
                       (16, 1024, torch.float64)):
        dense = constant_diagonal_matrices(n_, B_, n_ + 1000 * (dt == torch.float64), dt)
        label = f"jacobi n={n_} B={B_} {str(dt).removeprefix('torch.')} (constant diagonal)"
        jacobi_checks(dense, label, keys=DEFAULT_SWEEP_READINGS)
        jacobi_checks(dense, f"{label}, one sweep more", more_sweeps=1)
    scan = jacobi_checks(scan_matrices(16, 131072, 0, torch.float32), "jacobi n=16 B=131072 f32 (scan)")
    n_bad = int((scan["lanes_abs"] > 1e-3).sum())
    log(f"  scan: {n_bad} lanes with max |V diag(w) V^T - A| above 1e-3, largest {scan['recon_abs']:.3e}")
    check(n_bad == 0 and scan["recon_abs"] < 1e-4, "scan: no lane above 1e-3, the largest under 1e-4")
    # the NQuad=48 chunk's congruence M (n = 24: the eigen stage of the
    # NQuad=48 gradient step), in float32 and a slice in float64, and the
    # 64-layer column's (B = 2048: the column gradient's)
    A48, B48 = nquad48["eig"]
    M48 = congruence(A48, B48)
    jacobi_checks(M48, f"jacobi n={M48.shape[0]} B={M48.shape[2]} f32 (NQuad=48 chunk's congruence M)")
    jacobi_checks(congruence(A48[..., :4096].double(), B48[..., :4096].double()),
                  "jacobi n=24 B=4096 f64 (NQuad=48 chunk's congruence M)")
    M_col = congruence(*eig_col.operands)
    jacobi_checks(M_col, f"jacobi n={M_col.shape[0]} B={M_col.shape[2]} f32 (64-layer column's congruence M)")
    jac_ptxas = {args: dict(registers=regs, stack=stack, spill_stores=st, spill_loads=ld)
                 for args, regs, stack, st, ld, _ in _build.current("jacobi_eigh").ptxas()}
    for args, r in jac_ptxas.items():
        log(f"  jacobi_eigh variant <{args}>: {r['registers']} registers, {r['spill_stores'] + r['spill_loads']} B spilled")
    check(all(r["spill_stores"] + r["spill_loads"] == 0 for r in jac_ptxas.values()),
          "no variant of the Jacobi kernel spills")

    bvp_grad_err = bvp_gradient_route_check(ops, f"bvp gradient L={ops[0].shape[0]} 2N={ops[0].shape[1]} "
                                                 f"B={ops[0].shape[3]} f32 (main-path operands)")

    log("timing kernels at the main-path shapes (CUDA events)")
    n, B = At.shape[0], At.shape[2]
    eig_ms = cuda_ms(lambda: eig_stage_lanes(At, Bt), 20)
    eig_plain_ms = cuda_ms(lambda: in_chunks(eig_stage_lanes_plain, At, Bt), 3)
    eigh_ms = cuda_ms(lambda: in_chunks(lambda m: torch.linalg.eigh(m.permute(2, 0, 1)), M), 3)
    jac_sweeps = default_sweeps(n, M.dtype)
    jac_ms = cuda_ms(lambda: jacobi_eigh_lanes(M, jac_sweeps), 20)
    jac_plain_ms = cuda_ms(lambda: jacobi_eigh_lanes_plain(M, jac_sweeps), 3)
    jac_k5_ms = cuda_ms(lambda: jacobi_eigh_lanes_wide(M, jac_sweeps), 10)
    esz = At.element_size()
    def eig_bound_ms(n_, B_):
        return bound_ms((2 * n_ * n_ + 4 * n_ * n_ + n_) * B_ * esz, eig_flops(n_, jacobi_sweeps(At.dtype)) * B_,
                        "float32")

    eig_bound, eig_by = eig_bound_ms(n, B)
    # kernel 1 at the single column's lanes and at the NQuad=48 chunk's (n = 24)
    eig_others = []
    for what, (a_, b_) in (("single-column solve", eig_col.operands), ("NQuad=48 batched solve", nquad48["eig"])):
        ms_ = cuda_ms(lambda: eig_stage_lanes(a_, b_), 20)
        bound_, by_ = eig_bound_ms(a_.shape[0], a_.shape[2])
        eig_others.append(dict(shape=f"n={a_.shape[0]} B={a_.shape[2]}", operands=what, ms=ms_, bound_ms=bound_,
                               bound_by=by_))
    L, n2, _, Bb = ops[0].shape
    bvp_ms = cuda_ms(lambda: solve_bvp_fused(*ops), 20)
    bvp_plain_ms = cuda_ms(lambda: solve_bvp_fused_plain(*ops), 2)
    bvp_bytes = sum(o.numel() for o in ops) * esz + ops[3].numel() * esz
    bvp_bound, bvp_by = bound_ms(bvp_bytes, bvp_flops(L, n2 // 2) * Bb, "float32")
    # the route the fused solve replaces: the blocks assembled by tensor code, then kernel 3
    route_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(*ops[:3]), ops[3]), 20)
    jac_bound, jac_by = bound_ms((2 * n * n + n) * B * esz, jacobi_flops(n, jac_sweeps) * B, "float32")
    log(f"  eig_stage: {eig_ms:.4f} ms (plain {eig_plain_ms:.3f} ms, torch.linalg.eigh on M "
        f"{eigh_ms:.3f} ms, bound {eig_bound:.4f} ms by {eig_by}; ptxas spills {spill_bytes('eig_stage')} B)")
    for o in eig_others:
        log(f"  eig_stage {o['shape']}, {o['operands']}: {o['ms']:.4f} ms (bound {o['bound_ms']:.4f} ms "
            f"by {o['bound_by']})")
    log(f"  jacobi_eigh: {jac_ms:.4f} ms (plain {jac_plain_ms:.3f} ms, kernel 5 on the same M {jac_k5_ms:.4f} ms, "
        f"torch.linalg.eigh on the same M {eigh_ms:.3f} ms, bound {jac_bound:.4f} ms by {jac_by}: "
        f"{(2 * n * n + n) * B * esz / 1e9:.3f} GB, {jacobi_flops(n, jac_sweeps) * B:.3e} FLOP)")
    # kernel 4 at the other shapes the gradient paths give it, with kernel 5
    # and the library call on the same M
    jac_others = []
    for what, Mx, plain_reps in (("NQuad=48 chunk's congruence M", M48, 1),
                                 ("main-path congruence M", congruence(At.double(), Bt.double()), 0),
                                 ("NQuad=48 chunk's congruence M", congruence(A48.double(), B48.double()), 0),
                                 ("64-layer column's congruence M", M_col, 3)):
        n_, _, B_ = Mx.shape
        name = str(Mx.dtype).removeprefix("torch.")
        sw = default_sweeps(n_, Mx.dtype)
        ms = cuda_ms(lambda: jacobi_eigh_lanes(Mx, sw), 10)
        k5 = cuda_ms(lambda: jacobi_eigh_lanes_wide(Mx, sw), 5)
        lib = cuda_ms(lambda: in_chunks(lambda m: torch.linalg.eigh(m.permute(2, 0, 1)), Mx), 2)
        plain = cuda_ms(lambda: jacobi_eigh_lanes_plain(Mx, sw), plain_reps) if plain_reps else None
        bound, by = bound_ms((2 * n_ * n_ + n_) * B_ * Mx.element_size(), jacobi_flops(n_, sw) * B_, name)
        jac_others.append(dict(shape=f"n={n_} B={B_} {name}", operands=what, ms=ms, plain_ms=plain,
                               kernel5_ms=k5, library_ms=lib, bound_ms=bound, bound_by=by))
        log(f"  jacobi_eigh n={n_} B={B_} {name} ({what}): {ms:.4f} ms (plain "
            f"{'not timed' if plain is None else f'{plain:.3f} ms'}, kernel 5 {k5:.4f} ms, torch.linalg.eigh "
            f"{lib:.3f} ms, bound {bound:.4f} ms by {by}: {jacobi_flops(n_, sw) * B_:.3e} FLOP)")
    log(f"  bvp_fused_wide at NC = 32: {bvp_ms:.4f} ms (plain {bvp_plain_ms:.3f} ms, bound {bvp_bound:.4f} ms by {bvp_by}; "
        f"assemble_bvp_blocks + blocktri on the same operands {route_ms:.4f} ms; "
        f"ptxas spills {spill_bytes('bvp_fused_wide')} B)")

    def time_blocktri(o, what, reps, plain_reps):
        """ms, plain ms, bound ms and what bounds it, at the shape of ``o``."""
        L_, n_, _, B_ = o[1].shape
        # each input once (the two ignored edge blocks never), x once; the
        # [W | g] stack is scratch and is logged beside the bound
        nbytes = (sum(x.numel() for x in o) - 2 * n_ * n_ * B_ + o[3].numel()) * o[1].element_size()
        bound, by = bound_ms(nbytes, blocktri_flops(L_, n_) * B_, str(o[1].dtype).removeprefix("torch."))
        ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*o), reps)
        plain = cuda_ms(lambda: solve_block_tridiag_lanes(*o), plain_reps) if plain_reps else None
        scratch = 2 * L_ * n_ * (n_ + 1) * B_ * o[1].element_size()
        log(f"  blocktri {shape(o)}, {what}: {ms:.4f} ms (plain {'not timed' if plain is None else f'{plain:.3f} ms'}, "
            f"bound {bound:.4f} ms by {by}: {nbytes / 1e9:.3f} GB in and out, {blocktri_flops(L_, n_) * B_:.3e} FLOP; "
            f"scratch stack written and read {scratch / 1e9:.3f} GB)")
        return dict(shape=shape(o), blocks=what, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)

    bt_main_t = time_blocktri(bt_main, "main-path blocks", 20, 2)
    # the kernel's time depends on the data only through the arithmetic's
    # slow paths: random dense blocks of the column's shape beside its own
    bt_others = [time_blocktri(bt_wide, "NQuad=48 batched solve", 10, 1),
                 time_blocktri(bt_grad, "transposed main-path blocks (the gradient's solve)", 20, 0),
                 time_blocktri(bt_col, "single-column solve", 20, 2),
                 time_blocktri(random_blocks(*bt_col[3].shape, 1, torch.float32),
                               "random dense blocks", 20, 0),
                 time_blocktri(bt_wide64, "NQuad=48 batched solve, f64", 5, 0),
                 time_blocktri(bt_grad64, "transposed main-path blocks, f64", 10, 0),
                 time_blocktri(bt_col64, "single-column solve, f64", 20, 0)]
    return nquad48["bvp"], [
        dict(name="eig_stage", route="cuda", source="pythonic_disort_torch/csrc/eig_stage.cu",
             replaces="pythonic_disort_tpu/ops/pallas_eig.py:172",
             replaces_function="eig_stage_lanes_pallas",
             launches=None, max_abs_err=eig_abs, max_err=eig_rel, ms=eig_ms, plain_ms=eig_plain_ms,
             bound_ms=eig_bound, bound_by=eig_by, library_ms=eigh_ms,
             library_call=f"torch.linalg.eigh on the (B, 16, 16) M matrices in chunks of {EIGH_CHUNK} (eigh alone, not the stage)",
             other_shapes=eig_others),
        dict(name="bvp_fused", route="cuda", source="pythonic_disort_torch/csrc/bvp_fused_wide.cu",
             replaces="pythonic_disort_tpu/ops/pallas_blocktri.py:382",
             replaces_function="solve_bvp_fused_pallas, at 2N <= 32 (kernel 7's capacities 16, 32)",
             launches=None, max_abs_err=bvp_abs, max_err=bvp_rel, ms=bvp_ms, plain_ms=bvp_plain_ms,
             bound_ms=bvp_bound, bound_by=bvp_by, library_ms=None, library_call=None,
             assembled_route_ms=route_ms, gradient_route_max_err=bvp_grad_err),
        dict(name="blocktri", route="cuda", source="pythonic_disort_torch/csrc/blocktri.cu",
             replaces="pythonic_disort_tpu/ops/pallas_blocktri.py:553",
             replaces_function="solve_block_tridiag_lanes_pallas",
             launches=None, max_abs_err=bt_abs, max_err=bt_rel, ms=bt_main_t["ms"],
             plain_ms=bt_main_t["plain_ms"], bound_ms=bt_main_t["bound_ms"], bound_by=bt_main_t["bound_by"],
             library_ms=None, library_call=None, timed_at=bt_main_t["shape"], other_shapes=bt_others,
             ptxas=bt_ptxas),
        dict(name="jacobi_eigh", route="cuda", source="pythonic_disort_torch/csrc/jacobi_eigh.cu",
             replaces="pythonic_disort_tpu/ops/pallas_jacobi.py:244",
             replaces_function="jacobi_eigh_lanes_pallas",
             launches=None, max_abs_err=jac["w_abs"], max_err=jac["w"], ms=jac_ms, plain_ms=jac_plain_ms,
             bound_ms=jac_bound, bound_by=jac_by, library_ms=eigh_ms,
             library_call=f"torch.linalg.eigh on the same (B, 16, 16) M in chunks of {EIGH_CHUNK}",
             timed_at=f"n={n} B={B} float32, the main-path congruence M", kernel5_ms=jac_k5_ms,
             other_shapes=jac_others, ptxas=jac_ptxas),
    ]


def phase_intensity_kernels(kernels):
    """Kernel 1 and the fused solve at the shapes of phase 8's intensity
    chunk (256 solves x 16 Fourier modes x 64 layers: kernel 1 at B =
    262 144 lanes, the fused solve at 2N = 32, B = 4096), against their
    plain versions and timed."""
    import torch
    from pythonic_disort_torch.ops.cuda_blocktri import solve_bvp_fused, solve_bvp_fused_plain
    from pythonic_disort_torch.ops.cuda_eig import eig_stage_lanes, eig_stage_lanes_plain, jacobi_sweeps

    log("phase 3: kernel 1 and the fused solve at the intensity chunk's shapes")
    problem, tau, phi = intensity_problem(bench_arrays(INT_COLS, seed=7), torch.float32, "cuda")
    ops = capture_kernel_inputs(problem, tau, phi)
    del problem
    At, Bt = ops["eig"]
    n, _, B = At.shape
    # the float64 plain stage on the card, in lanes chunks
    Kp = torch.cat([eig_stage_lanes_plain(At[..., b:b + EIGH_CHUNK].double(), Bt[..., b:b + EIGH_CHUNK].double())[0]
                    for b in range(0, B, EIGH_CHUNK)], dim=-1)
    eig_abs, eig_rel = eig_checks(At, Bt, f"eig n={n} B={B} f32 (intensity chunk)", full=True, Kp=Kp)
    del Kp
    bops = ops["bvp"]
    L, n2, _, Bb = bops[0].shape
    bvp_abs, bvp_rel = bvp_checks(bops, f"bvp L={L} 2N={n2} B={Bb} f32 (intensity chunk)")

    esz = At.element_size()
    eig_ms = cuda_ms(lambda: eig_stage_lanes(At, Bt), 10)
    eig_plain = cuda_ms(lambda: in_chunks(eig_stage_lanes_plain, At, Bt), 2)
    M = torch.cat([congruence(At[..., b:b + EIGH_CHUNK], Bt[..., b:b + EIGH_CHUNK])
                   for b in range(0, B, EIGH_CHUNK)], dim=-1)
    eigh_ms = cuda_ms(lambda: in_chunks(lambda m: torch.linalg.eigh(m.permute(2, 0, 1)), M), 2)
    del M
    eig_bound, eig_by = bound_ms((2 * n * n + 4 * n * n + n) * B * esz, eig_flops(n, jacobi_sweeps(At.dtype)) * B,
                                 "float32")
    bvp_ms = cuda_ms(lambda: solve_bvp_fused(*bops), 10)
    bvp_plain = cuda_ms(lambda: solve_bvp_fused_plain(*bops), 1)
    bvp_bound, bvp_by = bound_ms((sum(o.numel() for o in bops) + bops[3].numel()) * esz,
                                 bvp_flops(L, n2 // 2) * Bb, "float32")
    log(f"  eig_stage n={n} B={B}: {eig_ms:.4f} ms (plain {eig_plain:.3f} ms, torch.linalg.eigh on M "
        f"{eigh_ms:.3f} ms, bound {eig_bound:.4f} ms by {eig_by})")
    log(f"  bvp_fused_wide L={L} 2N={n2} B={Bb}: {bvp_ms:.4f} ms (plain {bvp_plain:.3f} ms, bound {bvp_bound:.4f} ms "
        f"by {bvp_by})")
    kernels[0]["other_shapes"].append(dict(
        shape=f"n={n} B={B}", operands="intensity chunk (phase 8)", ms=eig_ms, plain_ms=eig_plain,
        library_ms=eigh_ms, bound_ms=eig_bound, bound_by=eig_by, max_abs_err=eig_abs, max_err=eig_rel))
    kernels[1]["other_shapes"] = [dict(
        shape=f"L={L} 2N={n2} B={Bb}", operands="intensity chunk (phase 8)", ms=bvp_ms, plain_ms=bvp_plain,
        bound_ms=bvp_bound, bound_by=bvp_by, max_abs_err=bvp_abs, max_err=bvp_rel)]


# the fused solve at 2N <= 32 in phase 3: the NQuad of the captured calls,
# and the cells that run it at 2N = 32 (name, lanes, dtype; L = 60 in each)
BVP_NARROW_NQUAD = (2, 6, 16, 30)
BVP_CELLS = (("sw_radiance", 7168, "float64"), ("sw_flux", 1792, "float64"), ("sw_flux_f32", 1792, "float32"),
             ("lw_flux_temper", 2048, "float32"))


def phase_bvp_narrow(main_ops, kernels):
    """Phase 3 for the fused solve at 2N <= 32 (kernel 7's capacities NC =
    16 and 32, which took over from kernel 2): against its float64 plain
    version on the main-path operands in float64 and at NQuad = 2, 6, 16 and
    30 calls in float32 and float64, and on ragged batches with one lane of
    NaN operands (the other lanes held, that lane non-finite); ptxas's
    registers and spills per capacity; then timed at the shapes of the four
    cells that run 2N = 32 (the main-path operands' first 60 layers, the
    lanes repeated) beside the route it replaced (`assemble_bvp_blocks` +
    kernel 3), the plain version and the bound.  Fills kernel 2's row of
    ``kernels`` (its ``cells`` and ``ptxas``)."""
    import torch
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.ops.blocktri import assemble_bvp_blocks
    from pythonic_disort_torch.ops.cuda_blocktri import (
        solve_block_tridiag_lanes_cuda, solve_bvp_fused, solve_bvp_fused_plain)
    from pythonic_disort_torch.tools.check_bvp import lanes, nan_lane_check

    log("phase 3: the fused solve at 2N <= 32 (kernel 7 at NC = 16, 32) against its plain version")
    f32, f64 = torch.float32, torch.float64
    shape = lambda o: f"L={o[0].shape[0]} 2N={o[0].shape[1]} B={o[0].shape[3]}"
    name = lambda dt: str(dt).removeprefix("torch.")
    captured = lambda seed, nlayers, nquad, dt: capture_kernel_inputs(*make_problem(
        bench_arrays(1, seed=seed, nlayers=nlayers, nquad=nquad), dt, "cuda", nquad=nquad))["bvp"]
    ops = main_ops["bvp"]
    bvp_checks(tuple(o.double() for o in ops), f"bvp {shape(ops)} f64 (main-path operands)")
    for nquad in BVP_NARROW_NQUAD:
        for dt in (f32, f64):
            o = captured(50 + nquad, 16, nquad, dt)
            bvp_checks(o, f"bvp {shape(o)} {name(dt)} (NQuad={nquad} call)")
    for nquad, dt, B in ((2, f64, 1001), (16, f32, 777), (32, f32, 777), (32, f64, 1001)):
        o = lanes(captured(60 + nquad, 16, nquad, dt), B)
        rel, nan_out = nan_lane_check(o, 5)
        tol = 1e-3 if dt == f32 else 1e-9
        log(f"  bvp {shape(o)} {name(dt)}, lane 5's operands NaN: the other lanes' per-lane rel {rel:.3e}; "
            f"lane 5 {'non-finite' if nan_out else 'finite'}")
        check(rel < tol and nan_out, f"bvp {shape(o)} {name(dt)}: a NaN lane stays in its lane, the others within "
                                     f"{tol:g}")
    ptxas = {args: dict(registers=regs, stack=stack, spill_stores=st, spill_loads=ld)
             for args, regs, stack, st, ld, _ in _build.current("bvp_fused_wide").ptxas()
             if "Li16E" in args or "Li32E" in args}
    for args, r in ptxas.items():
        log(f"  bvp_fused_wide variant <{args}>: {r['registers']} registers, "
            f"{r['spill_stores'] + r['spill_loads']} B spilled")
    check(len(ptxas) == 4 and all(r["spill_stores"] + r["spill_loads"] == 0 for r in ptxas.values()),
          "the four narrow variants of kernel 7 do not spill")

    log("timing the fused solve at the shapes of the cells that run 2N = 32 (CUDA events)")
    ops60 = tuple(o if k == 2 else o[:60] for k, o in enumerate(ops))
    cells = []
    for cell, B, dt in BVP_CELLS:
        o = lanes(tuple(x.to(getattr(torch, dt)) for x in ops60), B)
        L, n2, _, _ = o[0].shape
        x = solve_bvp_fused(*o)
        _, rel = lane_rel_err(x, solve_bvp_fused_plain(*(t.double() for t in o)))
        tol = 1e-3 if dt == "float32" else 1e-9
        check(bool(torch.isfinite(x).all()) and rel < tol, f"bvp {shape(o)} {dt} ({cell}): within {tol:g} per lane")
        ms = cuda_ms(lambda: solve_bvp_fused(*o), 5)
        route = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(*o[:3]), o[3]), 2)
        plain = cuda_ms(lambda: solve_bvp_fused_plain(*o), 1)
        esz = o[0].element_size()
        nbytes = (sum(t.numel() for t in o) + o[3].numel()) * esz
        bound, by = bound_ms(nbytes, bvp_flops(L, n2 // 2) * B, dt)
        log(f"  bvp {shape(o)} {dt} ({cell}): {ms:.4f} ms (per-lane rel {rel:.3e}; assemble_bvp_blocks + blocktri "
            f"{route:.4f} ms; plain {plain:.3f} ms; bound {bound:.4f} ms by {by}: {nbytes / 1e9:.3f} GB in and out, "
            f"{bvp_flops(L, n2 // 2) * B:.3e} FLOP)")
        cells.append(dict(cell=cell, shape=f"{shape(o)} {dt}", ms=ms, assembled_route_ms=route, plain_ms=plain,
                          bound_ms=bound, bound_by=by, max_err=rel))
    kernels[1].update(cells=cells, ptxas=ptxas)


# kernel 5's widths (n = N = NQuad/2) and kernel 6's (L, n, B, dtype) in
# phase 3
WIDE_JACOBI_N = (1, 3, 17, 31, 33, 34, 64, 128)
WIDE_BLOCKTRI = [(64, 68, 33, "float32"), (3, 66, 5, "float32"), (3, 66, 7, "float64"), (2, 68, 9, "float64"),
                 (4, 128, 7, "float32"), (3, 128, 3, "float64"), (2, 136, 5, "float32"), (2, 136, 3, "float64"),
                 (2, 256, 3, "float32"), (2, 256, 2, "float64")]
# kernel 6 at the columns' shapes of phase 7 (NQuad=68, 16 layers, 68
# Fourier modes; NQuad=128, 8 layers, 16 modes), float32: checked in phase
# 3 like WIDE_BLOCKTRI and timed there
WIDE_COLUMN_BLOCKTRI = [("NQuad=68 column", 16, 68, 68), ("NQuad=128 column", 8, 128, 16)]
# the batched NQuad=68 chunk of phases 3 and 7: 2 columns x 128 bands, 64 layers
WIDE_NQUAD, WIDE_COLS, WIDE_SEED = 68, 2, 21


def wide_jacobi_checks(At, label):
    """Kernel 5 against its plain version in float64 on the same matrices,
    order-free (`jacobi_checks`' readings, held to
    `tools.check_wide.wide_limits`), in shared memory or the workspace as
    the wrapper chooses, and again forced into the device workspace.  A
    float32 batch also logs the plain version's own float32 readings: the
    roundoff any float32 Jacobi leaves at this n."""
    import torch
    from pythonic_disort_torch.ops.cuda_jacobi import jacobi_eigh_lanes_wide
    from pythonic_disort_torch.ops.jacobi import default_sweeps, jacobi_eigh_lanes_plain
    from pythonic_disort_torch.tools.check_jacobi import check_readings, readings
    from pythonic_disort_torch.tools.check_wide import wide_limits

    n, sweeps = At.shape[0], default_sweeps(At.shape[0], At.dtype)
    w64 = jacobi_eigh_lanes_plain(At.double(), default_sweeps(n, torch.float64))[0].T.sort(dim=1).values
    lim = wide_limits(n, At.dtype)
    out = {}
    for storage, run in (("", lambda: jacobi_eigh_lanes_wide(At, sweeps)),
                         (", device workspace", lambda: jacobi_eigh_lanes_wide(At, sweeps, workspace=True))):
        w, V = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(w).all() and torch.isfinite(V).all()), f"{label}{storage}: outputs finite")
        out[storage] = r = readings(At, w, V, w64)
        check(check_readings(label + storage, r, At.dtype, log=log, limits=lim) == 0,
              f"{label}{storage}: {', '.join(lim)} within {lim}")
    if At.dtype == torch.float32:
        r = readings(At, *jacobi_eigh_lanes_plain(At, sweeps), w64)
        log(f"  {label}, the plain version in float32: sorted w rel {r['w']:.3e}, per-lane |V^T V - I| "
            f"{r['orth']:.3e}, |V diag(w) V^T - A| rel {r['recon']:.3e}")
    return out[""]


def phase_wide_kernels():
    """Phase 3 for kernels 5 and 6, the widths the JAX package serves with
    jnp: each against its plain version on operands of real solves and on
    random batches, float32 and float64, shared memory and device
    workspace; then each timed at the batched NQuad=68 chunk's shape."""
    import torch
    from pythonic_disort_torch.ops.blocktri import solve_block_tridiag_lanes
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.ops.cuda_blocktri import solve_block_tridiag_lanes_wide
    from pythonic_disort_torch.ops.cuda_jacobi import jacobi_eigh_lanes_wide
    from pythonic_disort_torch.ops.jacobi import default_sweeps, jacobi_eigh_lanes_plain
    from pythonic_disort_torch.tools.check_blocktri import random_blocks
    from pythonic_disort_torch.tools.check_jacobi import scan_matrices
    from pythonic_disort_torch.tools.check_wide import JACOBI_TIMED

    log("phase 3: kernels 5 and 6 against their plain versions")
    dt = {"float32": torch.float32, "float64": torch.float64}
    for n in WIDE_JACOBI_N:
        # the congruence M of a batched float64 solve at NQuad = 2n
        # (3 layers x 128 bands), and the same M in float32
        M = capture_kernel_inputs(*make_problem(bench_arrays(1, seed=30 + n, nlayers=3, nquad=2 * n),
                                                torch.float64, "cuda", nquad=2 * n))["jacobi_wide"][0]
        M = M[..., :301].contiguous()
        wide_jacobi_checks(M, f"jacobi_wide n={n} B={M.shape[2]} f64 (congruence M, NQuad={2 * n})")
        wide_jacobi_checks(M.float(), f"jacobi_wide n={n} B={M.shape[2]} f32 (congruence M, NQuad={2 * n})")
        for name, dtype in dt.items():
            wide_jacobi_checks(scan_matrices(n, 37, n, dtype), f"jacobi_wide n={n} B=37 {name} (random symmetric)")

    # the batched NQuad=68 chunk: M (n = 34) and the blocks (n = 68)
    ops = capture_kernel_inputs(*make_problem(bench_arrays(WIDE_COLS, seed=WIDE_SEED, nquad=WIDE_NQUAD),
                                              torch.float32, "cuda", nquad=WIDE_NQUAD))
    M = ops["jacobi_wide"][0]
    jac = wide_jacobi_checks(M, f"jacobi_wide n={M.shape[0]} B={M.shape[2]} f32 (batched NQuad={WIDE_NQUAD} chunk)")
    blocks = ops["blocktri"]
    shape = lambda o: f"L={o[1].shape[0]} n={o[1].shape[1]} B={o[1].shape[3]}"
    bt_abs, bt_rel = blocktri_checks(blocks, f"blocktri_wide {shape(blocks)} f32 (batched NQuad={WIDE_NQUAD} chunk)")
    for L_, n_, B_, name in WIDE_BLOCKTRI + [(L_, n_, B_, "float32") for _, L_, n_, B_ in WIDE_COLUMN_BLOCKTRI]:
        o = random_blocks(L_, n_, B_, 100 * L_ + n_, dt[name])
        label = f"blocktri_wide L={L_} n={n_} B={B_} {name} (dense, NaN edge blocks)"
        blocktri_checks(o, label)
        x = solve_block_tridiag_lanes_wide(*o, workspace=True)
        torch.cuda.synchronize()
        _, rel = lane_rel_err(x, solve_block_tridiag_lanes(*(t.double().nan_to_num(0.0) for t in o)))
        tol = 1e-3 if dt[name] == torch.float32 else 1e-9
        log(f"  {label}, device workspace: per-lane rel {rel:.3e}")
        check(bool(torch.isfinite(x).all()) and rel < tol, f"{label}, device workspace: within {tol:g} per lane")

    log(f"timing kernels 5 and 6 at the batched NQuad={WIDE_NQUAD} chunk's shapes (CUDA events)")
    n, _, B = M.shape
    sweeps = default_sweeps(n, M.dtype)
    esz = M.element_size()
    jac_ms = cuda_ms(lambda: jacobi_eigh_lanes_wide(M, sweeps), 5)
    jac_plain_ms = cuda_ms(lambda: jacobi_eigh_lanes_plain(M, sweeps), 1)
    eigh_ms = cuda_ms(lambda: in_chunks(lambda m: torch.linalg.eigh(m.permute(2, 0, 1)), M), 2)
    jac_bound, jac_by = bound_ms((2 * n * n + n) * B * esz, jacobi_flops(n, sweeps) * B, "float32")
    log(f"  jacobi_eigh_wide n={n} B={B}: {jac_ms:.4f} ms (plain {jac_plain_ms:.3f} ms, torch.linalg.eigh on the "
        f"same M {eigh_ms:.3f} ms, bound {jac_bound:.4f} ms by {jac_by}: {(2 * n * n + n) * B * esz / 1e9:.3f} GB, "
        f"{jacobi_flops(n, sweeps) * B:.3e} FLOP)")
    # kernel 5 at the other shapes of tools.check_wide.JACOBI_TIMED: the
    # columns' lanes, float64 and an odd n, on random symmetric matrices
    jac_shapes = {}
    for label, n_, B_, dt_ in JACOBI_TIMED[1:]:
        Mx = scan_matrices(n_, B_, 1, dt_)
        sw = default_sweeps(n_, dt_)
        ms = cuda_ms(lambda: jacobi_eigh_lanes_wide(Mx, sw), 5)
        name = str(dt_).removeprefix("torch.")
        bound, by = bound_ms((2 * n_ * n_ + n_) * B_ * Mx.element_size(), jacobi_flops(n_, sw) * B_, name)
        jac_shapes[f"{label}, n={n_} B={B_} {name}"] = dict(ms=ms, bound_ms=bound, bound_by=by)
        log(f"  jacobi_eigh_wide n={n_} B={B_} {name} ({label}, random symmetric): {ms:.4f} ms "
            f"(bound {bound:.4f} ms by {by})")
    L, nb, _, Bb = blocks[1].shape
    nbytes = (sum(x.numel() for x in blocks) - 2 * nb * nb * Bb + blocks[3].numel()) * esz
    bt_bound, bt_by = bound_ms(nbytes, blocktri_flops(L, nb) * Bb, "float32")
    bt_ms = cuda_ms(lambda: solve_block_tridiag_lanes_wide(*blocks), 5)
    bt_plain_ms = cuda_ms(lambda: solve_block_tridiag_lanes(*blocks), 1)
    scratch = 2 * L * nb * (nb + 1) * Bb * esz
    log(f"  blocktri_wide {shape(blocks)}: {bt_ms:.4f} ms (plain {bt_plain_ms:.3f} ms, bound {bt_bound:.4f} ms by "
        f"{bt_by}: {nbytes / 1e9:.3f} GB in and out, {blocktri_flops(L, nb) * Bb:.3e} FLOP; scratch stack written "
        f"and read {scratch / 1e9:.3f} GB)")
    columns = {}
    for label, L_, n_, B_ in WIDE_COLUMN_BLOCKTRI:
        o = random_blocks(L_, n_, B_, 100 * L_ + n_, torch.float32)
        ms = cuda_ms(lambda: solve_block_tridiag_lanes_wide(*o), 5)
        cb = (sum(x.numel() for x in o) - 2 * n_ * n_ * B_ + o[3].numel()) * esz
        bound, by = bound_ms(cb, blocktri_flops(L_, n_) * B_, "float32")
        columns[label] = dict(ms=ms, bound_ms=bound, bound_by=by, shape=f"L={L_} n={n_} B={B_}")
        log(f"  blocktri_wide L={L_} n={n_} B={B_} ({label}'s blocks, random dense): {ms:.4f} ms "
            f"(bound {bound:.4f} ms by {by})")
    ptxas = {name: {args: dict(registers=regs, stack=stack, spill_stores=st, spill_loads=ld)
                    for args, regs, stack, st, ld, _ in _build.current(name).ptxas()}
             for name in ("jacobi_eigh_wide", "blocktri_wide")}
    return [
        dict(name="jacobi_eigh_wide", route="cuda", source="pythonic_disort_torch/csrc/jacobi_eigh_wide.cu",
             replaces="pythonic_disort_tpu/ops/pallas_jacobi.py:244",
             replaces_function="jacobi_eigh_lanes_pallas, at the odd n and n > 32 where the JAX package runs jnp",
             launches=None, max_abs_err=jac["w_abs"], max_err=jac["w"], ms=jac_ms, plain_ms=jac_plain_ms,
             bound_ms=jac_bound, bound_by=jac_by, library_ms=eigh_ms,
             library_call=f"torch.linalg.eigh on the same (B, {n}, {n}) M in chunks of {EIGH_CHUNK}",
             timed_at=f"n={n} B={B} float32, the congruence M of the batched NQuad={WIDE_NQUAD} chunk",
             ms_shapes=jac_shapes, ptxas=ptxas["jacobi_eigh_wide"]),
        dict(name="blocktri_wide", route="cuda", source="pythonic_disort_torch/csrc/blocktri_wide.cu",
             replaces="pythonic_disort_tpu/ops/pallas_blocktri.py:553",
             replaces_function="solve_block_tridiag_lanes_pallas, at the n > 64 where the JAX package runs jnp",
             launches=None, max_abs_err=bt_abs, max_err=bt_rel, ms=bt_ms, plain_ms=bt_plain_ms,
             bound_ms=bt_bound, bound_by=bt_by, library_ms=None, library_call=None,
             timed_at=f"{shape(blocks)} float32, the blocks of the batched NQuad={WIDE_NQUAD} chunk",
             ms_columns=columns, ptxas=ptxas["blocktri_wide"]),
    ]


# NQuad values of kernel 7's captured calls in phase 3 (1 column x 128
# bands, 16 layers), besides the NQuad=48 chunk
BVP_WIDE_NQUAD = (34, 64)


def phase_bvp_wide(ops48):
    """Phase 3 for kernel 7 (34 <= 2N <= 64): against its plain version in
    float64 on the NQuad=48 chunk's operands (float32, and float64 from the
    same problem built in float64), on NQuad = 34 and 64 calls, at a
    ragged B, L = 1 and on random dense G at 2N = 34, 48 and 64; its
    gradient route and the assembled blocks' against float64; its ptxas
    spills; then timed beside the route it replaces
    (`assemble_bvp_blocks` + kernel 3) on the chunk's operands, in turns."""
    import torch
    from pythonic_disort_torch.ops.blocktri import assemble_bvp_blocks
    from pythonic_disort_torch.ops.cuda_blocktri import (
        solve_block_tridiag_lanes_cuda, solve_bvp_fused, solve_bvp_fused_plain)
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.tools.check_bvp import random_operands

    log("phase 3: kernel 7 (the fused boundary-value solve at 34 <= 2N <= 64) against its plain version")
    f32, f64 = torch.float32, torch.float64
    shape = lambda o: f"L={o[0].shape[0]} 2N={o[0].shape[1]} B={o[0].shape[3]}"
    name = lambda dt: str(dt).removeprefix("torch.")
    captured = lambda ncols, seed, nlayers, nquad, dt: capture_kernel_inputs(*make_problem(
        bench_arrays(ncols, seed=seed, nlayers=nlayers, nquad=nquad), dt, "cuda", nquad=nquad))["bvp"]
    k7_abs, k7_rel = bvp_checks(ops48, f"bvp_fused_wide {shape(ops48)} f32 (NQuad=48 chunk)")
    chunk64 = captured(CHUNK_COLS, 11, NLAYERS, 48, f64)
    bvp_checks(chunk64, f"bvp_fused_wide {shape(chunk64)} f64 (NQuad=48 chunk)")
    for nquad in BVP_WIDE_NQUAD:
        for dt in (f32, f64):
            o = captured(1, 40 + nquad, 16, nquad, dt)
            bvp_checks(o, f"bvp_fused_wide {shape(o)} {name(dt)} (NQuad={nquad} call)")
    one = tuple(o[..., :777].contiguous() for o in captured(7, 6, 1, 48, f32))
    bvp_checks(one, f"bvp_fused_wide {shape(one)} f32 (ragged)")
    five = tuple(o[..., :1001].contiguous() for o in captured(8, 7, 5, 64, f64))
    bvp_checks(five, f"bvp_fused_wide {shape(five)} f64 (ragged)")
    # random systems are worse conditioned than real solves': float32 where
    # the layers are few and 2N < 64 (as tools/check_bvp.py holds them; at
    # L = 1, 2N = 64, B = 33 the plain version in float32 loses 6.6e-4 per
    # lane, too close to the 1e-3 limit to tell a fault from rounding)
    for L_, N_, B_, dt in ((1, 17, 45, f32), (1, 24, 300, f32), (1, 32, 33, f64), (6, 24, 70, f64),
                           (4, 32, 9, f64), (3, 17, 5, f64)):
        o = random_operands(L_, N_, B_, L_ + N_, dt)
        bvp_checks(o, f"bvp_fused_wide {shape(o)} {name(dt)} (random dense G)")
        if dt == f32:
            _, rel = lane_rel_err(solve_bvp_fused_plain(*o), solve_bvp_fused_plain(*(t.double() for t in o)))
            log(f"  the plain version in float32 on the same operands: per-lane rel {rel:.3e}")
    grad_err = bvp_gradient_route_check(ops48, f"bvp gradient {shape(ops48)} f32 (NQuad=48 chunk's operands)")
    ptxas = {args: dict(registers=regs, stack=stack, spill_stores=st, spill_loads=ld)
             for args, regs, stack, st, ld, _ in _build.current("bvp_fused_wide").ptxas()}
    for args, r in ptxas.items():
        log(f"  bvp_fused_wide variant <{args}>: {r['registers']} registers, "
            f"{r['spill_stores'] + r['spill_loads']} B spilled")
    check(all(r["spill_stores"] + r["spill_loads"] == 0 for r in ptxas.values()), "no variant of kernel 7 spills")

    log("timing kernel 7 at the NQuad=48 chunk's operands (CUDA events, in turns with the assembled route)")
    L, n2, _, B = ops48[0].shape

    def timed(ops, reps):
        """kernel 7, the assembled route, kernel 7 again; the bound."""
        route = lambda: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(*ops[:3]), ops[3])
        first = cuda_ms(lambda: solve_bvp_fused(*ops), reps)
        route_ms = cuda_ms(route, reps)
        again = cuda_ms(lambda: solve_bvp_fused(*ops), reps)
        esz = ops[0].element_size()
        nbytes = (sum(o.numel() for o in ops) + ops[3].numel()) * esz
        bound, by = bound_ms(nbytes, bvp_flops(L, n2 // 2) * B, name(ops[0].dtype))
        stack = 2 * L * n2 * (n2 // 2 + 1) * B * esz
        log(f"  bvp_fused_wide {shape(ops)} {name(ops[0].dtype)}: {first:.4f} ms, then {again:.4f} ms; "
            f"assemble_bvp_blocks + blocktri between them {route_ms:.4f} ms; bound {bound:.4f} ms by {by} "
            f"({nbytes / 1e9:.3f} GB in and out, {bvp_flops(L, n2 // 2) * B:.3e} FLOP; [H | g] stack written "
            f"and read {stack / 1e9:.3f} GB)")
        return first, again, route_ms, bound, by

    ms, ms_again, route_ms, bound, by = timed(ops48, 20)
    plain_ms = cuda_ms(lambda: solve_bvp_fused_plain(*ops48), 1)
    log(f"  plain version at {shape(ops48)} f32: {plain_ms:.3f} ms")
    ms64, ms64_again, route64, bound64, by64 = timed(chunk64, 5)
    return dict(name="bvp_fused_wide", route="cuda", source="pythonic_disort_torch/csrc/bvp_fused_wide.cu",
                replaces="pythonic_disort_tpu/ops/pallas_blocktri.py:382",
                replaces_function="solve_bvp_fused_pallas, at 34 <= 2N <= 64",
                launches=None, max_abs_err=k7_abs, max_err=k7_rel, ms=ms, ms_again=ms_again, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None, library_call=None, assembled_route_ms=route_ms,
                gradient_route_max_err=grad_err, timed_at=f"{shape(ops48)} float32, the NQuad=48 chunk's operands",
                f64=dict(ms=ms64, ms_again=ms64_again, assembled_route_ms=route64, bound_ms=bound64, bound_by=by64),
                ptxas=ptxas)


def phase_legendre():
    """The Legendre-series kernel against the plain loop on the card
    (``tools/check_legendre.py``'s check, bit for bit, one launch a
    series): the NT correction's three series at a ``cloud_radiance``
    chunk's shapes (300 moments, float64) and at phase 8's intensity
    chunk's (float32); timed at the exact phase function's series of the
    ``cloud_radiance`` chunk, on both routes."""
    import torch
    from pythonic_disort_torch.ops import _build, legendre
    from pythonic_disort_torch.tools.check_legendre import CELLS, bound_ms, check_bits, loop, nt_series

    log("phase 3: the Legendre-series kernel against the plain loop")
    cloud = nt_series(CELLS["cloud_radiance"], torch.float64)
    chunk = nt_series((INT_COLS * NBANDS, NLAYERS, NQUAD // 2, len(INT_PHI), NQUAD + 1, NQUAD), torch.float32)
    for what, series in (("cloud_radiance chunk, f64", cloud), ("intensity chunk, f32", chunk)):
        for label, (c, x) in series.items():
            check(check_bits(f"  legendre_series {label} {tuple(c.shape)} x {tuple(x.shape)} ({what})", c, x),
                  f"legendre_series {label} ({what}): the plain loop's bits, one launch")
    c, x = cloud["tms_exact"]
    ms = cuda_ms(lambda: legendre.legendre_series_bcast(c, x), 20)
    plain_ms = cuda_ms(lambda: loop(c, x), 3)
    bound, by = bound_ms(c, x)
    ptxas = {v.args: dict(registers=v.registers, spill_stores=v.spill_stores, spill_loads=v.spill_loads)
             for v in _build.current("legendre_series").ptxas()}
    log(f"  legendre_series at {tuple(c.shape)} x {tuple(x.shape)} f64: {ms:.4f} ms, plain loop {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms ({by})")
    check(all(r["spill_stores"] + r["spill_loads"] == 0 for r in ptxas.values()), "legendre_series does not spill")
    return dict(name="legendre_series", route="cuda", source="pythonic_disort_torch/csrc/legendre_series.cu",
                replaces=None, replaces_function="none: pythonic_disort_tpu/ops/legendre.py::legendre_series "
                "is a lax.scan, no Pallas kernel",
                launches=None, max_abs_err=0.0, max_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, library_call=None,
                timed_at=f"{tuple(c.shape)} x {tuple(x.shape)} float64, the cloud_radiance chunk's exact phase "
                "function", ptxas=ptxas)


def phase_operands(main_ops):
    """The BVP operands kernel against its plain version on the card
    (``tools/check_operands.py``'s check: ``Gt`` bit for bit, ``B_l``
    within its limit of each lane's largest, one launch a call), with and
    without the beam, on the operands of phase 4's main-path chunk
    (float32) and of phase 8's intensity chunk built in float64; its ptxas
    spills; timed at the intensity chunk's operands on both routes."""
    import torch
    from pythonic_disort_torch.ops import _build, operands
    from pythonic_disort_torch.tools.check_operands import bound_ms, check_bits, without_beam

    log("phase 3: the BVP operands kernel against its plain version")
    problem, tau, phi = intensity_problem(bench_arrays(INT_COLS, seed=7), torch.float64, "cuda")
    chunk = capture_kernel_inputs(problem, tau, phi)["operands"]
    del problem
    worst = {}
    for what, ops in (("main-path chunk, f32", main_ops["operands"]), ("intensity chunk, f64", chunk)):
        for beam, o in (("beam", ops), ("no beam", without_beam(ops))):
            ok, worst[what, beam] = check_bits(f"  bvp_operands n={o['X'].shape[0]} L={o['L']} S={o['S']} "
                                               f"{o['X'].shape[2]} lanes ({what}, {beam})", o)
            check(ok, f"bvp_operands ({what}, {beam}): Gt the plain version's bits, B_l within its limit, "
                  "one launch")
    ms = cuda_ms(lambda: operands.bvp_operands(**chunk), 20)
    plain_ms = cuda_ms(lambda: operands.bvp_operands_plain(**chunk), 3)
    bound = bound_ms(chunk)
    ptxas = {v.args: dict(registers=v.registers, spill_stores=v.spill_stores, spill_loads=v.spill_loads)
             for v in _build.current("bvp_operands").ptxas()}
    for args, r in ptxas.items():
        log(f"  bvp_operands variant <{args}>: {r['registers']} registers, "
            f"{r['spill_stores'] + r['spill_loads']} B spilled")
    log(f"  bvp_operands at the intensity chunk's operands, f64: {ms:.4f} ms, plain version {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms (bytes)")
    check(len(ptxas) == 4 and all(r["spill_stores"] + r["spill_loads"] == 0 for r in ptxas.values()),
          "bvp_operands: four variants, none spills")
    X = chunk["X"]
    return dict(name="bvp_operands", route="cuda", source="pythonic_disort_torch/csrc/bvp_operands.cu",
                replaces=None, replaces_function="none: pythonic_disort_tpu/models/disort/batch_solve.py builds "
                "G, its L-major copy and the beam's particular solution in jnp, no Pallas kernel",
                launches=None, max_abs_err=None, max_err=max(worst.values()), gt_equal_bits=True, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None, library_call=None,
                timed_at=f"n={X.shape[0]} L={chunk['L']} S={chunk['S']} {X.shape[2]} lanes float64, "
                "the intensity chunk's operands with the beam", ptxas=ptxas)


def phase_main_path(arrs, problem, tau, kernels):
    import torch
    from pythonic_disort_torch import solve_fluxes
    from pythonic_disort_torch.utils import profiling

    log(f"phase 4: main path, {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}, NQuad={NQUAD}, f32, cuda")
    profiling.reset()
    out = solve_fluxes(problem, tau)
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches in one chunk: {launches}")
    for k, source in zip(kernels[:2], ("eig_stage", "bvp_fused_wide")):
        k["launches"], k["launches_on"] = launches[source], "batched flux path, one chunk"
    check(launches["eig_stage"] > 0 and launches["bvp_fused_wide"] == 1,
          "the eigen kernel and the fused BVP kernel (kernel 7 at NC = 32) launched on the main path")
    check(launches["bvp_operands"] == 1, "the BVP operands kernel once a chunk")
    check(launches["blocktri"] == 0 and launches["jacobi_eigh"] == 0
          and launches["jacobi_eigh_wide"] == 0 and launches["blocktri_wide"] == 0,
          "the forward-only NQuad=32 chunk takes neither the generic block-Thomas nor a Jacobi kernel")
    check(all(torch.isfinite(x).all().item() for x in out), "fluxes finite")
    check(all(x.shape == (CHUNK_COLS * NBANDS, NLAYERS) for x in out), "fluxes have shape (1024, 64)")

    nref = REF_COLS * NBANDS
    t0 = time.perf_counter()
    p64, tau64 = make_problem(rows(arrs, nref), torch.float64, "cpu")
    ref = [x.numpy() for x in solve_fluxes(p64, tau64)]
    log(f"  float64 CPU reference ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref, out):
        within(a, b[:nref].double().cpu().numpy(), lbl)

    chunk_ms = best_ms(lambda: solve_fluxes(problem, tau), N_CHUNKS)
    eig_ms = kernels[0]["ms"] * launches["eig_stage"]
    bvp_ms = kernels[1]["ms"] * launches["bvp_fused_wide"]
    cols_s = CHUNK_COLS / chunk_ms * 1e3
    log(f"  steady state: {cols_s:.3f} columns/s ({N_CHUNKS} chunks best of {REPS}: "
        f"{N_CHUNKS * chunk_ms:.2f} ms); per chunk {chunk_ms:.3f} ms = eig kernel {eig_ms:.3f} + "
        f"BVP kernel {bvp_ms:.3f} + rest {chunk_ms - eig_ms - bvp_ms:.3f} ms")
    return chunk_ms


def phase_trace(run, what, wall_ms):
    """``run()`` once under torch.profiler: the card's busy time (the union
    of its kernel and copy intervals), its idle share against the untraced
    time ``wall_ms`` of the same work, the device work by name, and the
    host's CUDA runtime calls (launches, copies, synchronizations).  Returns
    the busy ms and the device ms by name, or None if the profiler saw no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log(f"traced: {what} under torch.profiler")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        log("  the profiler saw no device activity: busy time and idle share not measured")
        return None
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    window_us = max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
    per_name = Counter()
    calls = Counter(e.name for e in dev)
    for e in dev:
        per_name[e.name] += e.time_range.elapsed_us()
    busy_ms = busy_us / 1e3
    log(f"  device busy {busy_ms:.3f} ms in {len(dev)} device operations "
        f"(first start to last end {window_us / 1e3:.3f} ms); idle share against the "
        f"untraced run ({wall_ms:.3f} ms): {1 - busy_ms / wall_ms:.3f}")
    for name, us in per_name.most_common(12):
        log(f"    {us / 1e3:8.3f} ms  x{calls[name]:<4d} {name[:90]}")
    copies = {k: v for k, v in calls.items() if k.startswith(("Memcpy", "Memset"))}
    log(f"  device copies and sets: {copies or 'none'}")
    runtime = Counter(e.name for e in events
                      if e.device_type == DeviceType.CPU and e.name.startswith(("cuda", "cuLaunch", "cuMemcpy")))
    log("  host CUDA runtime calls: " + ", ".join(f"{k} x{v}" for k, v in sorted(runtime.items())))
    return busy_ms, {name: us / 1e3 for name, us in per_name.items()}


def within(a, b, label, bound=1e-3, what="float64"):
    """|a - b| < bound x max(|a|, 1): by default the float32-against-float64
    bound of the main path (tests_tpu/test_tpu_production.py:139-154)."""
    scale = max(np.abs(a).max(), 1.0)
    d = np.abs(a - b).max()
    log(f"  {label}: max |f32 - ref| = {d:.3e} (bound {bound * scale:.3e})")
    check(np.isfinite(b).all() and d < bound * scale, f"{label} within {bound:g} x max(|.|, 1) of {what}")


def run_golden(name, kwargs, deg_around_beam, dtype, device):
    """One Stamnes case through ``pydisort``; the readings the reference
    thresholds apply to (largest relative error where |diff| > 1e-3), the
    intensity's where the case returns one (``only_flux=False``)."""
    from pythonic_disort_torch import pydisort
    from pythonic_disort_torch.utils.compare import compare

    outputs = pydisort(**kwargs, dtype=dtype, device=device)
    mu_arr, flux_up, flux_down = outputs[:3]
    u = outputs[4] if len(outputs) > 4 else None
    reorder = np.argsort(mu_arr)
    away = np.abs(np.arccos(np.abs(mu_arr[reorder])) - np.arccos(kwargs["mu0"])) * 180 / pi
    out = compare(np.load(DATA / "stamnes" / f"{name}_test.npz"), away > deg_around_beam, reorder,
                  flux_up, flux_down, u, verbose=False)
    worst = lambda diff, ratio: float(np.max(ratio[diff > 1e-3], initial=0))
    got = dict(flux_up=worst(out[0], out[1]), flux_down_diffuse=worst(out[2], out[3]),
               flux_down_direct=worst(out[4], out[5]))
    if u is not None:
        got["intensity"] = worst(out[6], out[7])
    return got


GOLDEN_LIMITS = dict(flux_up=1e-3, flux_down_diffuse=1e-3, flux_down_direct=1e-3, intensity=1e-2)


def phase_single_column(kernels):
    """The single-column ``pydisort`` in float32 on the card."""
    import torch
    from pythonic_disort_torch import pydisort, solve_fluxes
    from pythonic_disort_torch.utils import profiling

    f32 = dict(dtype=torch.float32, device="cuda")
    by_name = {k["name"]: k for k in kernels}
    log("phase 5: single-column path, pydisort in float32 on the card")
    cases = golden_cases()
    margins = {}
    profiling.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the goldens' albedos near 1 warn, as in the reference
        for name, (kwargs, deg) in cases.items():
            got = run_golden(name, kwargs, deg, **f32)
            margins[name] = max(got[k] / GOLDEN_LIMITS[k] for k in got)
            log(f"  golden {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in got.items()))
            check(all(v < GOLDEN_LIMITS[k] for k, v in got.items()),
                  f"golden {name}: relative errors where |diff| > 1e-3 below 1e-3 (fluxes) and 1e-2 (intensity)")
    tight = max(margins, key=margins.get)
    log(f"  {len(cases)} goldens pass in float32; the tightest is {tight} at {margins[tight]:.3f} of its limit")
    nt_cases = sum(bool(kwargs.get("NT_cor")) for kwargs, _ in cases.values())
    series = profiling.recorded()["launches"].get("legendre_series", 0)
    log(f"  the {nt_cases} goldens with NT_cor=True launched the Legendre-series kernel {series} times")
    check(series >= 3 * nt_cases > 0, "the NT goldens' series ran on the Legendre-series kernel, three a correction")
    by_name["legendre_series"]["launches_nt_goldens"] = series
    (dfu, dfdd, diff), (dfu_dM, dfdd_dM, diff_NT) = corrections_readings(**f32)
    log(f"  9corrections: mean improvement of flux_up {np.mean(dfu - dfu_dM):.3e}, diffuse flux_down "
        f"{np.mean(dfdd - dfdd_dM):.3e}, u {np.mean(diff - diff_NT):.3e}; corrected run max |diff| flux_up "
        f"{np.max(dfu_dM):.3e}, flux_down {np.max(dfdd_dM):.3e}, u {np.max(diff_NT):.3e}")
    check(np.mean(dfu - dfu_dM) > 0 and np.mean(dfdd - dfdd_dM) > 0 and np.mean(diff - diff_NT) > 0,
          "9corrections: delta-M + NT beat the uncorrected run in mean on flux_up, diffuse flux_down and u")
    check(np.max(dfu_dM) < 0.05 and np.max(dfdd_dM) < 0.05 and np.max(diff_NT) < 0.6,
          "9corrections: the corrected run within 0.05, 0.05 and 0.6 of the golden")

    log(f"  one column, L={NLAYERS}, NQuad={NQUAD}, NFourier={NQUAD}, intensity")
    kwargs = column_kwargs()
    tau = np.linspace(0.0, kwargs["tau_arr"][-1], 8)
    phi = np.array([0.0, 1.0, 4.0])
    profiling.reset()
    _, fu, fd, u0, u = pydisort(**kwargs, **f32)
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches in one pydisort call: {launches}")
    kernels[2]["launches"], kernels[2]["launches_on"] = launches["blocktri"], "single-column path, one pydisort call"
    kernels[0]["launches_single_column"] = launches["eig_stage"]
    check(launches["eig_stage"] > 0 and launches["blocktri"] > 0,
          "the eigen and block-Thomas kernels launched on the single-column path")
    check(launches["bvp_fused_wide"] == 0 and launches["jacobi_eigh"] == 0,
          "the forward-only single-column path takes neither fused BVP kernel nor the Jacobi kernel")
    _, fu64, fd64, u064, u64 = pydisort(**kwargs, dtype=torch.float64, device="cpu")
    within(fu64(tau), fu(tau), "flux_up")
    for lbl, a, b in zip(("flux_down diffuse", "flux_down direct"), fd64(tau), fd(tau)):
        within(a, b, lbl)
    within(u064(tau), u0(tau), "u0")
    out = u(tau, phi)
    check(out.shape == (NQUAD, 8, 3) and np.isfinite(out).all(), "u is finite with shape (32, 8, 3)")
    within(u64(tau, phi), out, "u")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        u_nt = pydisort(**column_kwargs(nt_cor=True), **f32)[4]
        u_nt64 = pydisort(**column_kwargs(nt_cor=True), dtype=torch.float64, device="cpu")[4]
    within(u_nt64(tau, phi), u_nt(tau, phi), "u with the NT corrections")

    log(f"  batched flux chunk at NQuad=48: {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}")
    arrs = bench_arrays(CHUNK_COLS, seed=13, nquad=48)
    problem, ptau = make_problem(arrs, torch.float32, "cuda", nquad=48)
    profiling.reset()
    out = solve_fluxes(problem, ptau)
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches: {launches}")
    k7 = by_name["bvp_fused_wide"]
    k7["launches"], k7["launches_on"] = launches["bvp_fused_wide"], "batched flux path at NQuad=48, one chunk"
    check(launches["bvp_fused_wide"] > 0 and launches["blocktri"] == 0,
          "the NQuad=48 batched solve takes kernel 7, not the generic block-Thomas kernel")
    check(all(torch.isfinite(x).all().item() for x in out), "NQuad=48 fluxes finite")
    nref = REF_COLS * NBANDS
    p64, tau64 = make_problem(rows(arrs, nref), torch.float64, "cpu", nquad=48)
    for lbl, a, b in zip(("fup", "fdn", "fdir"), solve_fluxes(p64, tau64), out):
        within(a.numpy(), b[:nref].double().cpu().numpy(), f"NQuad=48 {lbl} ({nref} rows)")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_fluxes(problem, ptau)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    chunk48_ms = min(times)
    log(f"  NQuad=48 chunk: {chunk48_ms:.3f} ms (best of {REPS}: {', '.join(f'{t:.3f}' for t in times)}), "
        f"{CHUNK_COLS / chunk48_ms * 1e3:.3f} columns/s; kernel 7 {k7['ms']:.3f} ms x {launches['bvp_fused_wide']} "
        f"({k7['timed_at']}, phase 3)")
    k7["nquad48_chunk_ms"] = chunk48_ms
    traced = phase_trace(lambda: solve_fluxes(problem, ptau), "phase 5, one batched NQuad=48 chunk", chunk48_ms)
    if traced:
        busy, per_name = traced
        for label, key in (("kernel 7", "bvp_wide_kernel"), ("kernel 3", "blocktri_kernel")):
            ms = sum(v for name, v in per_name.items() if key in name)
            log(f"  {label} in the traced NQuad=48 chunk: {ms:.3f} ms, {ms / busy:.3f} of the device busy time")

    log("  host-clock time per pydisort call (solve and one flux_up evaluation, synchronized)")
    timed = {name: cases[name][0] for name in ("1a", "5a", "9b")}
    timed[f"column L={NLAYERS} NQuad={NQUAD} NFourier={NQUAD}"] = kwargs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, kw in timed.items():
            top = np.atleast_1d(kw["tau_arr"])[-1]
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pydisort(**kw, **f32)[1](top)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            log(f"    {name}: first call {times[0]:.3f} ms, then {', '.join(f'{t:.3f}' for t in times[1:])} ms")
    phase_trace(lambda: pydisort(**kwargs, **f32)[1](kwargs["tau_arr"][-1]),
                f"phase 5, one pydisort call of the column (L={NLAYERS}, NQuad={NQUAD}, NFourier={NQUAD})",
                min(times[1:]))


def column_gradient(dtype, device, nquad=NQUAD, only_flux=False):
    """d sum(flux_up) / d omega (64,) of the 64-layer column through
    build_problem, solve and eval.flux_up."""
    import torch
    import pythonic_disort_torch as pt
    from pythonic_disort_torch.models.disort import eval as ev

    kwargs = column_kwargs(nquad=nquad)
    _, prob = pt.build_problem(**kwargs, only_flux=only_flux, dtype=dtype, device=device)
    prob.omega_arr = prob.omega_arr.clone().requires_grad_()
    tau = torch.linspace(0.0, float(kwargs["tau_arr"][-1]), 8, dtype=dtype, device=device)
    flux_up = ev.flux_up(pt.solve(prob), tau)
    return torch.autograd.grad(flux_up.sum(), prob.omega_arr)[0]


def within_grad(g, g_ref, bound, label):
    """|g - g_ref| < bound x max|g_ref|, on the CPU in float64."""
    import torch

    scale = g_ref.abs().max().item()
    err = (g.double().cpu() - g_ref).abs().max().item()
    log(f"  {label}: max |g - g_ref| = {err:.3e}, {err / scale:.3e} of max|g_ref| = {scale:.3e} (bound {bound:g})")
    check(bool(torch.isfinite(g).all()) and err < bound * scale, f"{label} within {bound:g} x max|g_ref|")


def beam_pole_distance(arrs, nquad=NQUAD):
    """Per row, min |K mu0 - 1| over its layers and eigenvalues K (float64,
    CPU).  The beam's particular solution divides by 1/mu0 - K: near that
    pole the solution is a difference of large terms, and its derivative
    divides by the square of the distance, so a float32 gradient loses
    about (1/distance)^2 x 6e-8 of its scale there, whatever computes it."""
    import torch
    from pythonic_disort_torch.models.disort.batch_solve import solve_batched

    problem, _ = make_problem(arrs, torch.float64, "cpu", nquad=nquad)
    K = solve_batched(problem).K[:, 0, :, nquad // 2:]                  # (S, L, N), K > 0
    mu0 = torch.as_tensor(arrs["mu0"], dtype=torch.float64)
    return (K * mu0[:, None, None] - 1).abs().amin(dim=(1, 2))


def phase_gradient(arrs, kernels, chunk_ms):
    """First-order gradients on the card: the batched path at the bench
    configuration and the 64-layer column, each against float64 on the CPU."""
    import torch
    from pythonic_disort_torch.tools.check_jacobi import gradient_step
    from pythonic_disort_torch.utils import profiling

    log(f"phase 6: gradient path, d loss / d omega, {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}, "
        f"NQuad={NQUAD}, f32, cuda")
    step = gradient_step(arrs, torch.float32, "cuda")
    profiling.reset()
    g = step()
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches in one gradient step: {launches}")
    check(launches["jacobi_eigh"] >= 1 and launches["bvp_fused_wide"] == 1 and launches["blocktri"] >= 1
          and launches["eig_stage"] == 0 and launches["jacobi_eigh_wide"] == 0 and launches["blocktri_wide"] == 0,
          "one gradient step takes the Jacobi kernel, the fused BVP kernel once, the block-Thomas kernel "
          "for the transposed solve, and not the forward-only eigen kernel")
    by_name = {k["name"]: k for k in kernels}
    by_name["jacobi_eigh"]["launches"] = launches["jacobi_eigh"]
    by_name["jacobi_eigh"]["launches_on"] = "batched gradient path, one step (forward and backward)"
    for name, source in (("bvp_fused", "bvp_fused_wide"), ("blocktri", "blocktri")):
        by_name[name]["launches_gradient_step"] = launches[source]
    check(g.shape == (CHUNK_COLS * NBANDS, NLAYERS), "d loss / d omega has shape (1024, 64)")

    nref = REF_COLS * NBANDS
    t0 = time.perf_counter()
    g_ref = gradient_step(rows(arrs, nref), torch.float64, "cpu")()
    log(f"  float64 CPU gradient ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    within_grad(gradient_step(rows(arrs, nref), torch.float64, "cuda")(), g_ref, 1e-8,
                "float64 card gradient (every kernel in float64)")
    scale = g_ref.abs().max().item()
    # float32, per row: 2e-3 x max|g_ref|, grown by the beam pole's
    # conditioning on the rows near it up to POLE_CAP x max|g_ref|; the
    # plain versions in float32 on the CPU are read beside it
    dist = beam_pole_distance(rows(arrs, nref))
    near = dist < POLE
    bound = torch.clamp(2e-3 * scale * (POLE / dist) ** 2, min=2e-3 * scale, max=POLE_CAP * scale)
    t0 = time.perf_counter()
    g_plain = gradient_step(rows(arrs, nref), torch.float32, "cpu")().double()
    log(f"  float32 CPU gradient (plain versions, {nref} solves) in {time.perf_counter() - t0:.1f} s")
    err = (g[:nref].double().cpu() - g_ref).abs().amax(dim=1)
    err_plain = (g_plain - g_ref).abs().amax(dim=1)
    k = int(dist.argmin())
    log(f"  {int(near.sum())} of {nref} rows have an eigenvalue K with |K mu0 - 1| < {POLE:g}, "
        f"{int((bound >= POLE_CAP * scale).sum())} of them at the cap; the largest row bound "
        f"{bound.max().item() / scale:.3e} of max|g_ref|; on the row nearest the pole (d = {dist[k].item():.3e}) "
        f"bound {bound[k].item() / scale:.3e}, card {err[k].item() / scale:.3e}, "
        f"CPU plain versions {err_plain[k].item() / scale:.3e} of max|g_ref|")
    j = int(err.argmax())
    log(f"  the row of the largest card error: d = {dist[j].item():.3e}, card {err[j].item() / scale:.3e}, "
        f"bound {bound[j].item() / scale:.3e}, CPU plain versions {err_plain[j].item() / scale:.3e} of max|g_ref|")
    for label, sel in ((f"|K mu0 - 1| >= {POLE:g}", ~near), (f"|K mu0 - 1| < {POLE:g}", near)):
        if sel.any():
            log(f"  float32 against float64 on the rows with {label}: card {err[sel].max().item() / scale:.3e}, "
                f"CPU plain versions {err_plain[sel].max().item() / scale:.3e} of max|g_ref|; "
                f"card error / bound at most {(err[sel] / bound[sel]).max().item():.3f}")
    check(bool(torch.isfinite(g).all()) and bool((err < bound).all()),
          f"float32 card gradient within 2e-3 x max|g_ref| x max(1, ({POLE:g} / |K mu0 - 1|)^2), "
          f"at most {POLE_CAP:g} x max|g_ref|, on every row")

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = min(times)
    log(f"  forward + backward: {step_ms:.3f} ms per chunk (best of {REPS}: "
        f"{', '.join(f'{t:.3f}' for t in times)}), {step_ms / CHUNK_COLS:.3f} ms per column; "
        f"the forward-only chunk {chunk_ms:.3f} ms, ratio {step_ms / chunk_ms:.2f}")
    phase_trace(step, "phase 6, one gradient step of the main-path chunk", step_ms)
    gradient_mu0(arrs, by_name, step, dist)
    forward_mode(by_name)
    gradient_step_nquad48(by_name)

    log(f"  single column, L={NLAYERS}, NQuad={NQUAD}, NFourier={NQUAD}: d sum(flux_up) / d omega")
    profiling.reset()
    t0 = time.perf_counter()
    gc = column_gradient(torch.float32, "cuda")
    torch.cuda.synchronize()
    col_ms = 1e3 * (time.perf_counter() - t0)
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches: {launches}; host clock {col_ms:.3f} ms (build_problem, solve, flux_up, backward)")
    check(launches["jacobi_eigh"] == 1 and launches["blocktri"] == 2 and launches["eig_stage"] == 0,
          "the column's gradient takes the Jacobi kernel once and the block-Thomas kernel twice")
    by_name["jacobi_eigh"]["launches_single_column_gradient"] = launches["jacobi_eigh"]
    col_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        column_gradient(torch.float32, "cuda")
        torch.cuda.synchronize()
        col_times.append(1e3 * (time.perf_counter() - t0))
    log(f"  then {', '.join(f'{t:.3f}' for t in col_times)} ms")
    within_grad(gc, column_gradient(torch.float64, "cpu"), 2e-3, "float32 column gradient")

def gradient_mu0(arrs, by_name, omega_step, dist):
    """Phase 6 (m): d loss / d mu0 of the bench chunk in float32, mu0 the
    leaf (its Legendre table at -mu0 then built on the card), against the
    port's float64 CPU gradient on the rows of ``dist`` (their distances to
    the beam pole) under phase 6's pole bound; timed in turns with the
    omega step ``omega_step``, and traced."""
    import torch
    from pythonic_disort_torch.tools.check_jacobi import gradient_step

    log(f"  (m) d loss / d mu0 of the same chunk, mu0 the leaf, f32, cuda")
    step = gradient_step(arrs, torch.float32, "cuda", wrt="mu0")
    g, launches = launched(step, "(m) one d loss / d mu0 step", ("eig_stage", "bvp_fused_wide", "blocktri"),
                           ("jacobi_eigh", "jacobi_eigh_wide", "blocktri_wide", "bvp_operands"))
    check(launches["eig_stage"] == 1 and launches["bvp_fused_wide"] == 1,
          "(m) the eigen kernel and the fused BVP kernel once each: the eigen operands take no gradient")
    for name, source in (("eig_stage", "eig_stage"), ("bvp_fused", "bvp_fused_wide"), ("blocktri", "blocktri")):
        by_name[name]["launches_mu0_gradient_step"] = launches[source]
    check(g.shape == (CHUNK_COLS * NBANDS,), f"(m) d loss / d mu0 has shape ({CHUNK_COLS * NBANDS},)")
    nref = len(dist)
    t0 = time.perf_counter()
    g_ref = gradient_step(rows(arrs, nref), torch.float64, "cpu", wrt="mu0")()
    log(f"  (m) float64 CPU gradient ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    scale = g_ref.abs().max().item()
    bound = torch.clamp(2e-3 * scale * (POLE / dist) ** 2, min=2e-3 * scale, max=POLE_CAP * scale)
    err = (g[:nref].double().cpu() - g_ref).abs()
    j = int((err / bound).argmax())
    log(f"  (m) float32 against float64 on {nref} rows: largest error {err.max().item() / scale:.3e} of "
        f"max|g_ref| = {scale:.3e}; error / bound at most {(err / bound).max().item():.3f} (row {j}: d = "
        f"{dist[j].item():.3e}, error {err[j].item() / scale:.3e}, bound {bound[j].item() / scale:.3e}); "
        f"the row nearest the pole: d = {dist.min().item():.3e}")
    check(bool(torch.isfinite(g).all()) and bool((err < bound).all()),
          f"(m) float32 card d loss / d mu0 within 2e-3 x max|g_ref| x max(1, ({POLE:g} / |K mu0 - 1|)^2), "
          f"at most {POLE_CAP:g} x max|g_ref|, on every row")
    times = {"d / d omega": [], "d / d mu0": []}
    for _ in range(REPS):
        for label, run in zip(times, (omega_step, step)):
            times[label].append(best_ms(run, 1, reps=1))
    omega_ms, mu0_ms = (min(t) for t in times.values())
    log("  (m) forward + backward, host clock, in turns: "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} ms" for k, v in times.items()))
    log(f"  (m) best of {REPS}: d / d mu0 {mu0_ms:.3f} ms per chunk, d / d omega {omega_ms:.3f} ms")
    by_name["bvp_fused"]["mu0_gradient_step_ms"] = mu0_ms
    phase_trace(step, "phase 6 (m), one d loss / d mu0 step of the main-path chunk", mu0_ms)


FWD_LANES = 2048        # lanes of a forward-mode tangent held against float64 on the CPU
# phase 6 (f): a float32 tangent per lane within this x its lane's largest
# float64 entry (the plain versions in float32 on the CPU read at most
# 6.4e-5 for dw and 1.2e-4 for the projectors' tangents at n = 24)
FWD_TOL = {"eigenvalues": 1e-3, "projectors": 3e-3}


def symmetric_tangent(x, seed, rel=1e-2):
    """A random symmetric tangent of the batch of matrices ``x`` (..., n, n),
    ``rel`` x each matrix's largest entry."""
    import torch

    r = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(seed), dtype=x.dtype,
                    device=x.device)
    return 0.5 * (r + r.mT) * rel * x.abs().amax(dim=(-2, -1), keepdim=True)


def lane_errors(label, got, ref, tol):
    """Per lane (the leading axis), max |got - ref| / max |ref|, with ``ref``
    in float64 on the CPU; checked below ``tol``."""
    import torch

    dims = tuple(range(1, ref.dim()))
    e = (got.double().cpu() - ref).abs().amax(dim=dims) / ref.abs().amax(dim=dims)
    log(f"  (f) {label}: per-lane max |f32 - f64| / lane max: largest {e.max().item():.3e}, "
        f"median {e.median().item():.3e} over {len(e)} lanes (bound {tol:g})")
    check(bool(torch.isfinite(got).all()) and e.max().item() < tol,
          f"(f) {label} within {tol:g} of float64 on every lane")


def dual(fn, primals, tangents):
    """``fn`` under ``torch.autograd.forward_ad``: (primal, tangent) of each output."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        outs = fn(*(fwAD.make_dual(p, t) for p, t in zip(primals, tangents)))
        return [tuple(fwAD.unpack_dual(o)) for o in outs]


def projector_tangents(V, dV):
    """Tangents of the projectors V[:, i] V[:, i]^T of (B, n, n) V: (B, n, n, n),
    free of the eigenvectors' signs."""
    import torch

    t = torch.einsum("bri,bci->birc", dV, V)
    return t + t.transpose(-1, -2)


def spectral_by_k(K, X, P, dK, dX, dP):
    """Lanes outputs of `disort_eigh_lanes` under a tangent -> per lane, in
    ascending K: K, dK and the tangents of the spectral projectors
    X[:, i] P[i, :], (B, N), (B, N), (B, N, N, N)."""
    import torch

    order = torch.argsort(K, dim=0)
    dproj = torch.einsum("ikb,kjb->bkij", dX, P) + torch.einsum("ikb,kjb->bkij", X, dP)
    pick = order.T[:, :, None, None].expand(dproj.shape)
    return (torch.take_along_dim(K, order, 0).T, torch.take_along_dim(dK, order, 0).T,
            torch.take_along_dim(dproj, pick, 1))


def raises(run, exc, label):
    """Check that ``run()`` raises ``exc``."""
    try:
        run()
    except exc as e:
        check(True, f"{label} raises {exc.__name__}: {str(e)[:120]}")
        return
    check(False, f"{label} raises {exc.__name__}")


def forward_mode(by_name):
    """Phase 6 (f): forward mode on the card.  `jacobi_eigh` under
    ``forward_ad`` on the bench chunk's and the NQuad=48 chunk's congruence
    M (kernel 4 once a call), `disort_eigh_lanes` with dual operands at the
    bench shape (the Jacobi route, not kernel 1), each tangent on FWD_LANES
    lanes against float64 on the CPU; the eigen kernel's entry refusing dual
    operands, and `solve_fluxes` on a dual omega raising."""
    import torch
    import torch.autograd.forward_ad as fwAD
    from pythonic_disort_torch import solve_fluxes
    from pythonic_disort_torch.models.disort import batch_solve as bs_mod
    from pythonic_disort_torch.ops import cuda_eig
    from pythonic_disort_torch.ops import eig as eig_mod
    from pythonic_disort_torch.ops.eig import disort_eigh_lanes
    from pythonic_disort_torch.ops.jacobi import jacobi_eigh
    from pythonic_disort_torch.tools.check_bvp import batched_problem

    log(f"  (f) forward mode (torch.autograd.forward_ad), f32, cuda; tangents on {FWD_LANES} lanes against "
        f"float64 on the CPU")
    others = ("eig_stage", "jacobi_eigh_wide", "blocktri", "blocktri_wide", "bvp_fused_wide")
    for nquad, seed in ((NQUAD, 42), (48, 13)):
        arrs = bench_arrays(CHUNK_COLS, seed=seed, nquad=nquad)
        problem, tau = make_problem(arrs, torch.float32, "cuda", nquad=nquad)
        with recording(eig_mod, "eig_stage_lanes") as eig_rec, recording(bs_mod, "disort_eigh_lanes") as d_rec:
            solve_fluxes(problem, tau)
        At, Bt = eig_rec.operands
        A = congruence(At, Bt).permute(2, 0, 1).contiguous()                  # (B, n, n), as the stage's M
        dA = symmetric_tangent(A, seed)
        n = A.shape[-1]
        outs, launches = launched(lambda: dual(jacobi_eigh, (A,), (dA,)),
                                  f"(f) jacobi_eigh under forward_ad, n={n}, B={A.shape[0]}", ("jacobi_eigh",), others)
        check(launches["jacobi_eigh"] == 1, f"(f) n={n}: kernel 4 once a call")
        by_name["jacobi_eigh"][f"launches_forward_mode_n{n}"] = launches["jacobi_eigh"]
        (w, dw), (V, dV) = outs
        (w64, V64), (dw64, dV64) = torch.func.jvp(
            torch.linalg.eigh, (A[:FWD_LANES].double().cpu(),), (dA[:FWD_LANES].double().cpu(),))
        lane_errors(f"n={n}: dw", dw[:FWD_LANES], dw64, FWD_TOL["eigenvalues"])
        lane_errors(f"n={n}: tangents of the projectors V_i V_i^T",
                    projector_tangents(V[:FWD_LANES].double(), dV[:FWD_LANES].double()),
                    projector_tangents(V64, dV64), FWD_TOL["projectors"])
        if nquad != NQUAD:
            continue
        # the eigen stage at the bench shape with dual operands
        Dp, Dm, mu, w_q = d_rec.operands
        dDp, dDm = (symmetric_tangent(D.permute(2, 0, 1), s).permute(1, 2, 0).contiguous()
                    for D, s in ((Dp, 1), (Dm, 2)))
        stage = lambda a, b: disort_eigh_lanes(a, b, mu, w_q)
        outs, launches = launched(lambda: dual(stage, (Dp, Dm), (dDp, dDm)),
                                  f"(f) disort_eigh_lanes with dual operands, N={Dp.shape[0]}, B={Dp.shape[2]}",
                                  ("jacobi_eigh",), others)
        check(launches["jacobi_eigh"] == 1, "(f) dual operands take _eig_stage_ad: kernel 4 once, kernel 1 never")
        by_name["jacobi_eigh"]["launches_forward_mode_eigen_stage"] = launches["jacobi_eigh"]
        by_name["eig_stage"]["launches_forward_mode_eigen_stage"] = launches["eig_stage"]
        (K, dK), (X, dX), _, (P, dP), _ = outs
        lanes = lambda x: x[..., :FWD_LANES].double().cpu()
        ref = dual(lambda a, b: disort_eigh_lanes(a, b, mu.double().cpu(), w_q.double().cpu()),
                   (lanes(Dp), lanes(Dm)), (lanes(dDp), lanes(dDm)))
        (K6, dK6), (X6, dX6), _, (P6, dP6), _ = ref
        got = spectral_by_k(*(lanes(x) for x in (K, X, P, dK, dX, dP)))
        want = spectral_by_k(K6, X6, P6, dK6, dX6, dP6)
        lane_errors("the eigen stage: dK, in ascending K", got[1], want[1], FWD_TOL["eigenvalues"])
        lane_errors("the eigen stage: tangents of the projectors X_i P_i, matched by ascending K", got[2], want[2],
                    FWD_TOL["projectors"])
        # the repaired fault: the kernel's entry refuses dual operands
        with fwAD.dual_level():
            dual_ops = (fwAD.make_dual(At, torch.zeros_like(At)), fwAD.make_dual(Bt, torch.zeros_like(Bt)))
            raises(lambda: cuda_eig.eig_stage_lanes(*dual_ops), NotImplementedError,
                   "(f) cuda_eig.eig_stage_lanes with dual operands")
        with fwAD.dual_level():
            omega = torch.tensor(arrs["omega"], dtype=torch.float32, device="cuda")
            prob = batched_problem(dict(arrs, omega=fwAD.make_dual(omega, torch.ones_like(omega))), NQUAD,
                                   torch.float32, "cuda")
            raises(lambda: solve_fluxes(prob, prob.tau_arr), NotImplementedError,
                   "(f) solve_fluxes on a dual omega (forward mode through the whole solve, as in the JAX package)")


def gradient_step_nquad48(by_name):
    """Phase 6 at NQuad = 48: one gradient step of the 8-column chunk of
    phase 5 in float32, whose eigen stage is the Jacobi kernel at n = 24;
    its launches, its gradient on 64 rows against float64 on the CPU, its
    time and trace, and the two relayout copies of the Jacobi Function's
    forward (batch-major to lanes and back) timed on the step's operand."""
    import torch
    from pythonic_disort_torch.tools.check_jacobi import gradient_step
    from pythonic_disort_torch.ops import cuda_jacobi
    from pythonic_disort_torch.ops.jacobi import jacobi_eigh, jacobi_eigh_lanes_raw
    from pythonic_disort_torch.utils import profiling

    log(f"  gradient step at NQuad=48: {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}, f32")
    arrs = bench_arrays(CHUNK_COLS, seed=13, nquad=48)
    step = gradient_step(arrs, torch.float32, "cuda", nquad=48)
    profiling.reset()
    with recording(cuda_jacobi, "jacobi_eigh_lanes") as rec:
        g = step()
        torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches in one NQuad=48 gradient step: {launches}")
    check(launches["jacobi_eigh"] >= 1 and launches["bvp_fused_wide"] == 1 and launches["blocktri"] >= 1
          and launches["eig_stage"] == 0 and launches["jacobi_eigh_wide"] == 0
          and launches["blocktri_wide"] == 0,
          "the NQuad=48 gradient step takes the Jacobi kernel 4, kernel 7 once, kernel 3 for the transposed "
          "solve, and not kernels 1, 2, 5 or 6")
    by_name["jacobi_eigh"]["launches_gradient_step_nquad48"] = launches["jacobi_eigh"]
    check(g.shape == (CHUNK_COLS * NBANDS, NLAYERS), "the NQuad=48 d loss / d omega has shape (1024, 64)")
    nref = 64
    t0 = time.perf_counter()
    g_ref = gradient_step(rows(arrs, nref), torch.float64, "cpu", nquad=48)()
    log(f"  float64 CPU gradient at NQuad=48 ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    scale = g_ref.abs().max().item()
    dist = beam_pole_distance(rows(arrs, nref), nquad=48)
    bound = torch.clamp(2e-3 * scale * (POLE / dist) ** 2, min=2e-3 * scale, max=POLE_CAP * scale)
    err = (g[:nref].double().cpu() - g_ref).abs().amax(dim=1)
    j = int((err / bound).argmax())
    log(f"  NQuad=48 float32 against float64 on {nref} rows: largest error {err.max().item() / scale:.3e} of "
        f"max|g_ref|; error / bound at most {(err / bound).max().item():.3f} (row {j}: d = {dist[j].item():.3e}, "
        f"bound {bound[j].item() / scale:.3e})")
    check(bool(torch.isfinite(g).all()) and bool((err < bound).all()),
          f"NQuad=48 float32 card gradient within 2e-3 x max|g_ref| x max(1, ({POLE:g} / |K mu0 - 1|)^2), "
          f"at most {POLE_CAP:g} x max|g_ref|, on {nref} rows")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = min(times)
    log(f"  NQuad=48 forward + backward: {step_ms:.3f} ms per chunk (best of {REPS}: "
        f"{', '.join(f'{t:.3f}' for t in times)})")
    by_name["jacobi_eigh"]["gradient_step_nquad48_ms"] = step_ms
    traced = phase_trace(step, "phase 6, one gradient step of the NQuad=48 chunk", step_ms)
    if traced:
        busy, per_name = traced
        k4 = sum(v for name, v in per_name.items() if "jacobi_eigh_kernel" in name)
        log(f"  kernel 4 in the traced NQuad=48 step: {k4:.3f} ms, {k4 / busy:.3f} of the device busy time")
    # the Jacobi Function's forward on the step's operand, as the eigen
    # stage calls it (sort=False), and its parts with CUDA events: the
    # relayout of M from (B, n, n) to lanes, kernel 4, and the relayout of
    # w and V back (a trace names every copy kernel alike, so it cannot
    # tell these two from the step's other copies)
    lanes = rec.operands[0]
    A = lanes.permute(2, 0, 1).contiguous()                           # (B, n, n), as the Function gets it
    w_l, V_l = jacobi_eigh_lanes_raw(lanes)
    fwd_ms = cuda_ms(lambda: jacobi_eigh(A, sort=False), 10)
    in_ms = cuda_ms(lambda: A.permute(1, 2, 0).contiguous(), 10)
    k4_ms = cuda_ms(lambda: jacobi_eigh_lanes_raw(lanes), 10)
    out_ms = cuda_ms(lambda: (w_l.T.contiguous(), V_l.permute(2, 0, 1).contiguous()), 10)
    log(f"  the Jacobi Function's forward on (B, n, n) = {tuple(A.shape)}: {fwd_ms:.4f} ms (CUDA events); "
        f"kernel 4 {k4_ms:.4f} ms, the relayout copies {in_ms:.4f} ms in and {out_ms:.4f} ms out")
    by_name["jacobi_eigh"]["relayout_copies_ms_nquad48"] = dict(into_lanes=in_ms, out_of_lanes=out_ms)


# phase 7 columns: NQuad -> (layers, NFourier); cut for NQuad = 68 and 128,
# whose float64 CPU reference at 64 layers and NFourier = NQuad takes minutes
WIDTH_COLUMNS = {2: (NLAYERS, None), 6: (NLAYERS, None), 30: (NLAYERS, None), 68: (16, None), 128: (8, 16)}
WIDE_REF_ROWS = 8       # rows of a batched call held against float64 on the CPU
# batched calls at odd N (one column x 128 bands, 64 layers): kernel 5 and
# the fused boundary-value kernel
ODD_BATCHED = (2, 6, 30)


def phase_widths(kernels):
    """Phase 7: the NQuad values that take kernels 5 and 6, float32 on the
    card against the port's float64 CPU result."""
    import torch
    from pythonic_disort_torch.tools.check_jacobi import gradient_step
    from pythonic_disort_torch import pydisort, solve_fluxes
    from pythonic_disort_torch.utils import profiling

    f32 = dict(dtype=torch.float32, device="cuda")
    by_name = {k["name"]: k for k in kernels}
    log("phase 7: widths, pydisort, solve_fluxes and a gradient at NQuad values that take kernels 5 and 6, f32")
    per_call = {}
    for nquad, (nlayers, nfourier) in WIDTH_COLUMNS.items():
        kwargs = column_kwargs(nquad=nquad, nlayers=nlayers, nfourier=nfourier)
        tau = np.linspace(0.0, kwargs["tau_arr"][-1], 8)
        phi = np.array([0.0, 1.0, 4.0])
        label = f"NQuad={nquad} L={nlayers} NFourier={nfourier or nquad}"
        profiling.reset()
        _, fu, fd, u0, u = pydisort(**kwargs, **f32)
        torch.cuda.synchronize()
        launches = Counter(profiling.recorded()["launches"])
        log(f"  {label}: launches in one pydisort call: {launches}")
        per_call[nquad] = {k: launches[k] for k in ("jacobi_eigh_wide", "blocktri", "blocktri_wide")}
        wide = nquad > 64
        check(launches["jacobi_eigh_wide"] > 0 and launches["eig_stage"] == 0 and launches["jacobi_eigh"] == 0,
              f"{label}: the eigen stage takes kernel 5, not kernel 1 or 4")
        check((launches["blocktri_wide"] > 0 and launches["blocktri"] == 0) if wide
              else (launches["blocktri"] > 0 and launches["blocktri_wide"] == 0),
              f"{label}: the block-Thomas solve takes kernel {6 if wide else 3}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, fu64, fd64, u064, u64 = pydisort(**kwargs, dtype=torch.float64, device="cpu")
        within(fu64(tau), fu(tau), f"{label} flux_up")
        for lbl, a, b in zip(("flux_down diffuse", "flux_down direct"), fd64(tau), fd(tau)):
            within(a, b, f"{label} {lbl}")
        within(u064(tau), u0(tau), f"{label} u0")
        out = u(tau, phi)
        check(out.shape == (nquad, 8, 3) and np.isfinite(out).all(), f"{label}: u is finite with shape ({nquad}, 8, 3)")
        within(u64(tau, phi), out, f"{label} u")
        if nquad > 64:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                nt = dict(kwargs, NT_cor=True)
                within(pydisort(**nt, dtype=torch.float64, device="cpu")[4](tau, phi),
                       pydisort(**nt, **f32)[4](tau, phi), f"{label} u with the NT corrections")
                # the plain versions in float32 on the CPU: float32's own loss
                _, _, _, u0c, uc = pydisort(**kwargs, dtype=torch.float32, device="cpu")
            log(f"  {label}: the plain versions in float32 on the CPU: max |u0 - u0_64| "
                f"{np.abs(u0c(tau) - u064(tau)).max():.3e}, max |u - u_64| {np.abs(uc(tau, phi) - u64(tau, phi)).max():.3e}")
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pydisort(**kwargs, **f32)[1](tau[-1])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        log(f"  {label}: host-clock ms per pydisort call (solve and one flux_up): first {times[0]:.3f}, "
            f"then {', '.join(f'{t:.3f}' for t in times[1:])}")
        if wide:
            phase_trace(lambda: pydisort(**kwargs, **f32)[1](tau[-1]), f"phase 7, one pydisort call at {label}",
                        min(times[1:]))
    by_name["jacobi_eigh_wide"]["launches_pydisort"] = {q: c["jacobi_eigh_wide"] for q, c in per_call.items()}
    by_name["blocktri_wide"]["launches_pydisort"] = {q: c["blocktri_wide"] for q, c in per_call.items()}

    log(f"  batched flux call at NQuad={WIDE_NQUAD}: {WIDE_COLS} columns x {NBANDS} bands, L={NLAYERS}")
    arrs = bench_arrays(WIDE_COLS, seed=WIDE_SEED, nquad=WIDE_NQUAD)
    problem, ptau = make_problem(arrs, torch.float32, "cuda", nquad=WIDE_NQUAD)
    profiling.reset()
    out = solve_fluxes(problem, ptau)
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches: {launches}")
    check(launches["jacobi_eigh_wide"] > 0 and launches["blocktri_wide"] > 0
          and launches["eig_stage"] == launches["blocktri"] == launches["bvp_fused_wide"] == 0,
          f"the NQuad={WIDE_NQUAD} batched solve takes kernels 5 and 6 and no other")
    for name in ("jacobi_eigh_wide", "blocktri_wide"):
        by_name[name]["launches"] = launches[name]
        by_name[name]["launches_on"] = f"batched flux path at NQuad={WIDE_NQUAD}, one chunk"
    check(all(torch.isfinite(x).all().item() for x in out), f"NQuad={WIDE_NQUAD} fluxes finite")
    t0 = time.perf_counter()
    p64, tau64 = make_problem(rows(arrs, WIDE_REF_ROWS), torch.float64, "cpu", nquad=WIDE_NQUAD)
    ref = solve_fluxes(p64, tau64)
    log(f"  float64 CPU reference ({WIDE_REF_ROWS} solves) in {time.perf_counter() - t0:.1f} s")
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref, out):
        within(a.numpy(), b[:WIDE_REF_ROWS].double().cpu().numpy(), f"NQuad={WIDE_NQUAD} {lbl}")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_fluxes(problem, ptau)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    chunk_ms = min(times)
    log(f"  NQuad={WIDE_NQUAD} chunk: {chunk_ms:.3f} ms (best of {REPS}: {', '.join(f'{t:.3f}' for t in times)}), "
        f"{WIDE_COLS / chunk_ms * 1e3:.3f} columns/s; kernel 5 {by_name['jacobi_eigh_wide']['ms']:.3f} ms x "
        f"{launches['jacobi_eigh_wide']}, kernel 6 {by_name['blocktri_wide']['ms']:.3f} ms x {launches['blocktri_wide']}")
    # the chunk's time by device operation: the kernels and the plain
    # tensor code around them
    phase_trace(lambda: solve_fluxes(problem, ptau), f"phase 7, one batched NQuad={WIDE_NQUAD} chunk", chunk_ms)

    for nquad in ODD_BATCHED:
        arrs = bench_arrays(1, seed=WIDE_SEED + nquad, nquad=nquad)
        problem, ptau = make_problem(arrs, torch.float32, "cuda", nquad=nquad)
        profiling.reset()
        out = solve_fluxes(problem, ptau)
        torch.cuda.synchronize()
        launches = Counter(profiling.recorded()["launches"])
        log(f"  batched flux call at NQuad={nquad}: 1 column x {NBANDS} bands, L={NLAYERS}; launches: {launches}")
        check(launches["jacobi_eigh_wide"] > 0 and launches["bvp_fused_wide"] == 1
              and launches["eig_stage"] == launches["blocktri"] == launches["blocktri_wide"] == 0,
              f"the NQuad={nquad} batched solve takes kernels 5 and 7")
        p64, tau64 = make_problem(rows(arrs, WIDE_REF_ROWS), torch.float64, "cpu", nquad=nquad)
        for lbl, a, b in zip(("fup", "fdn", "fdir"), solve_fluxes(p64, tau64), out):
            within(a.numpy(), b[:WIDE_REF_ROWS].double().cpu().numpy(), f"NQuad={nquad} {lbl}")

    # the batched gradient with every kernel in float64 (the float32 one
    # loses digits near the beam pole, phase 6)
    for nquad in (6, WIDE_NQUAD):
        arrs = rows(bench_arrays(1, seed=WIDE_SEED + nquad, nquad=nquad), WIDE_REF_ROWS)
        profiling.reset()
        g = gradient_step(arrs, torch.float64, "cuda", nquad=nquad)()
        torch.cuda.synchronize()
        launches = Counter(profiling.recorded()["launches"])
        log(f"  batched gradient at NQuad={nquad}, {WIDE_REF_ROWS} rows, float64; launches: {launches}")
        check(launches["jacobi_eigh_wide"] >= 1 and launches["eig_stage"] == launches["jacobi_eigh"] == 0
              and (launches["blocktri_wide"] == 2 if nquad > 64 else launches["blocktri"] >= 1),
              f"the NQuad={nquad} batched gradient takes kernel 5 and kernel {6 if nquad > 64 else 3} "
              "for the transposed solve")
        within_grad(g, gradient_step(arrs, torch.float64, "cpu", nquad=nquad)(), 1e-8,
                    f"float64 card gradient at NQuad={nquad} (every kernel in float64)")
    # and at NQuad = 48: the Jacobi kernel (n = 24) as the eigen stage,
    # kernel 7 forward and kernel 3 on the transposed blocks
    arrs = rows(bench_arrays(1, seed=WIDE_SEED + 48, nquad=48), WIDE_REF_ROWS)
    profiling.reset()
    g = gradient_step(arrs, torch.float64, "cuda", nquad=48)()
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  batched gradient at NQuad=48, {WIDE_REF_ROWS} rows, float64; launches: {launches}")
    check(launches["bvp_fused_wide"] == 1 and launches["blocktri"] >= 1
          and launches["eig_stage"] == 0 and launches["jacobi_eigh"] >= 1 and launches["jacobi_eigh_wide"] == 0,
          "the NQuad=48 batched gradient takes the Jacobi kernel 4, kernel 7 once and kernel 3 for the "
          "transposed solve")
    within_grad(g, gradient_step(arrs, torch.float64, "cpu", nquad=48)(), 1e-8,
                "float64 card gradient at NQuad=48 (every kernel in float64)")

    log(f"  single column, L={NLAYERS}, NQuad={WIDE_NQUAD}, flux only: d sum(flux_up) / d omega")
    col = dict(nquad=WIDE_NQUAD, only_flux=True)
    profiling.reset()
    t0 = time.perf_counter()
    gc = column_gradient(torch.float32, "cuda", **col)
    torch.cuda.synchronize()
    grad_ms = 1e3 * (time.perf_counter() - t0)
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches: {launches}; host clock {grad_ms:.3f} ms (build_problem, solve, flux_up, backward)")
    check(launches["jacobi_eigh_wide"] >= 1 and launches["blocktri_wide"] == 2
          and launches["eig_stage"] == launches["jacobi_eigh"] == launches["blocktri"] == 0,
          "the column's gradient takes kernel 5 and kernel 6 twice (forward and transposed solve)")
    for name in ("jacobi_eigh_wide", "blocktri_wide"):
        by_name[name]["launches_column_gradient"] = launches[name]
    within_grad(gc, column_gradient(torch.float64, "cpu", **col), 2e-3, f"float32 NQuad={WIDE_NQUAD} column gradient")
    phase_trace(lambda: column_gradient(torch.float32, "cuda", **col), f"phase 7, the NQuad={WIDE_NQUAD} column gradient",
                grad_ms)


def best_ms(run, chunks, reps=REPS):
    """Host-clock ms of ``chunks`` synchronized calls of ``run``, best of
    ``reps``, per call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / chunks)
    return min(times)


def launched(run, label, kernels_on, kernels_off):
    """``run()`` once with the launch counts set to 0 just before it; checks
    that ``kernels_on`` launched and ``kernels_off`` did not."""
    import torch
    from pythonic_disort_torch.utils import profiling

    profiling.reset()
    out = run()
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches in {label}: {launches}")
    check(all(launches[k] > 0 for k in kernels_on) and all(launches[k] == 0 for k in kernels_off),
          f"{label}: {', '.join(kernels_on)} launched, {', '.join(kernels_off)} not")
    return out, launches


def phase_intensity(kernels, card):
    """Phase 8: the batched intensity path and a longwave (iso-source) chunk
    in float32 on the card, against the port's float64 result on the CPU
    for a subset of rows (the solves are independent)."""
    import torch
    from pythonic_disort_torch import (
        solve_actinic, solve_batched, solve_fluxes, solve_intensity, u0_at, u_at, u_corrected_at)
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.parallel.batch import _check_probes_per_layer
    from pythonic_disort_torch.utils import profiling

    t_phase = time.perf_counter()
    by_name = {k["name"]: k for k in kernels}
    others = [k for k in _build.kernel_sources() if k not in ("eig_stage", "bvp_fused_wide", "bvp_operands")]
    nt_on = ("eig_stage", "bvp_fused_wide", "bvp_operands", "legendre_series")
    nt_others = [k for k in others if k not in nt_on]
    S = INT_COLS * NBANDS
    log(f"phase 8: batched intensity path, {INT_COLS} columns x {NBANDS} bands, L={NLAYERS}, NQuad={NQUAD}, "
        f"NFourier={INT_NFOURIER}, NT-corrected, {len(INT_PHI)} azimuths, f32, cuda ({card})")
    arrs = bench_arrays(INT_COLS, seed=7)
    problem, tau, phi = intensity_problem(arrs, torch.float32, "cuda")

    # (a) one probe per layer, the path bench.py times
    probes = lambda: solve_intensity(problem, tau, phi, probes_per_layer=True)
    u, launches = launched(probes, "(a) one intensity chunk, probes per layer", nt_on, nt_others)
    for k in nt_on:
        by_name["bvp_fused" if k == "bvp_fused_wide" else k]["launches_intensity_chunk"] = launches[k]
    check(launches["legendre_series"] == 3, "(a) the NT correction's three series, one launch each")
    check(u.shape == (S, NQUAD, NLAYERS, len(INT_PHI)) and torch.isfinite(u).all().item(),
          f"u finite with shape ({S}, {NQUAD}, {NLAYERS}, {len(INT_PHI)})")
    a_ms = best_ms(probes, INT_CHUNKS)
    check_ms = best_ms(lambda: _check_probes_per_layer(problem.tau_arr, tau), 20)
    log(f"  (a) {a_ms:.3f} ms per chunk ({INT_CHUNKS} chunks, best of {REPS}), "
        f"{INT_COLS / a_ms * 1e3:.3f} intensity columns/s; the probe precondition check {check_ms:.4f} ms a call "
        f"(one reduction, one host read); kernel 1 {by_name['eig_stage']['other_shapes'][-1]['ms']:.3f} ms + "
        f"the fused solve {by_name['bvp_fused']['other_shapes'][-1]['ms']:.3f} ms (phase 3)")
    phase_trace(probes, "phase 8 (a), one intensity chunk, probes per layer", a_ms)

    # (b) the general path: GC materialized, layer gathers in the evaluators
    general = lambda: solve_intensity(problem, tau, phi)
    u_gen, launches = launched(general, "(b) one intensity chunk, general path", nt_on, nt_others)
    check(launches["legendre_series"] == 3, "(b) the NT correction's three series, one launch each")
    within(u.double().cpu().numpy(), u_gen.double().cpu().numpy(), "(b) general path against (a)",
           what="the probe path (a)")
    del u_gen
    b_ms = best_ms(general, INT_CHUNKS)
    log(f"  (b) {b_ms:.3f} ms per chunk, {INT_COLS / b_ms * 1e3:.3f} intensity columns/s")
    phase_trace(general, "phase 8 (b), one intensity chunk, general path", b_ms)

    sol = solve_batched(problem)
    u_raw, u0 = u_at(sol, tau, phi), u0_at(sol, tau)
    del sol
    t0 = time.perf_counter()
    p64, tau64, phi64 = intensity_problem(rows(arrs, INT_REF_ROWS), torch.float64, "cpu")
    sol64 = solve_batched(p64)
    ref = [u_corrected_at(sol64, tau64, phi64), u_at(sol64, tau64, phi64), u0_at(sol64, tau64)]
    log(f"  float64 CPU reference ({INT_REF_ROWS} solves x {INT_NFOURIER} modes) in {time.perf_counter() - t0:.1f} s")
    for (lbl, bound), a, b in zip((("NT-corrected u", 2e-3), ("u (u_at)", 1e-3), ("u0", 1e-3)), ref,
                                  (u, u_raw, u0)):
        within(a.numpy(), b[:INT_REF_ROWS].double().cpu().numpy(), f"{lbl} ({INT_REF_ROWS} rows)", bound)
    del u, u_raw, u0, problem

    # (c) longwave: no beam, a linear iso source in every layer, surface emission
    log(f"  (c) longwave chunk: {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}, NQuad={NQUAD}, NFourier=1, "
        f"iso source (2 coefficients), surface emission, delta-M, no beam")
    lw = longwave_arrays(CHUNK_COLS)
    p_flux, lw_tau = longwave_problem(lw, torch.float32, "cuda", only_flux=True)
    p_act, _ = longwave_problem(lw, torch.float32, "cuda", only_flux=False)
    fluxes = lambda: solve_fluxes(p_flux, lw_tau)
    actinic = lambda: solve_actinic(p_act, lw_tau)
    f_out, launches = launched(fluxes, "(c) one longwave flux chunk",
                               ("eig_stage", "bvp_fused_wide", "bvp_operands"), others)
    for name, k in (("eig_stage", "eig_stage"), ("bvp_fused", "bvp_fused_wide")):
        by_name[name]["launches_longwave_chunk"] = launches[k]
    act_out, _ = launched(actinic, "(c) one longwave actinic chunk", ("eig_stage", "bvp_fused_wide", "bvp_operands"),
                          others)
    t0 = time.perf_counter()
    lw64 = rows(lw, LW_REF_ROWS)
    ref = [*solve_fluxes(*longwave_problem(lw64, torch.float64, "cpu", only_flux=True)),
           *solve_actinic(*longwave_problem(lw64, torch.float64, "cpu", only_flux=False))]
    log(f"  float64 CPU reference ({LW_REF_ROWS} solves) in {time.perf_counter() - t0:.1f} s")
    check(ref[2].abs().max().item() == 0 and ref[0].abs().min().item() > 0,
          "longwave: no direct beam, upward flux everywhere")
    for lbl, a, b in zip(("longwave fup", "longwave fdn", "longwave fdir", "longwave actinic up",
                          "longwave actinic down"), ref, (*f_out, *act_out)):
        within(a.numpy(), b[:LW_REF_ROWS].double().cpu().numpy(), f"{lbl} ({LW_REF_ROWS} rows)")
    c_ms = best_ms(fluxes, N_CHUNKS)
    c_act_ms = best_ms(actinic, N_CHUNKS)
    log(f"  (c) longwave fluxes {c_ms:.3f} ms per chunk ({CHUNK_COLS / c_ms * 1e3:.3f} columns/s), "
        f"actinic fluxes {c_act_ms:.3f} ms per chunk ({N_CHUNKS} chunks, best of {REPS})")
    phase_trace(fluxes, "phase 8 (c), one longwave flux chunk", c_ms)
    phase_trace(actinic, "phase 8 (c), one longwave actinic chunk", c_act_ms)
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s ({card})")


def temperature_profiles(ncols):
    """One 65-level profile a column, top to bottom, each from its own seed
    ``TEMP_SEED + column``: 280-310 K at the surface, falling linearly to
    200-230 K at the top, with +-2 K of uniform noise at every level."""
    out = np.empty((ncols, NLAYERS + 1))
    frac = np.linspace(0.0, 1.0, NLAYERS + 1)
    for c in range(ncols):
        rng = np.random.default_rng(TEMP_SEED + c)
        top, surface = rng.uniform(200.0, 230.0), rng.uniform(280.0, 310.0)
        out[c] = top + (surface - top) * frac + rng.uniform(-2.0, 2.0, NLAYERS + 1)
    return out


def band_edges():
    return np.linspace(*LW_RANGE, NBANDS + 1)


def planck_stage(tau, temper):
    """The device Planck route of a chunk: per band one call of
    ``s_poly_coeffs_from_temper`` and one of ``band_integrated_emission``
    (the surface) over the columns.  ``tau`` (C x NBANDS, L) with row
    c x NBANDS + k column c's band k, ``temper`` (C, L + 1); returns
    ``s_poly`` (C x NBANDS, L, 2) and ``b_pos`` (C x NBANDS, N, 1)."""
    import torch
    from pythonic_disort_torch.ops.planck import band_integrated_emission, s_poly_coeffs_from_temper

    C = temper.shape[0]
    tau_cb = tau.view(C, NBANDS, -1)
    edges = band_edges()
    s_poly, surface = [], []
    for k in range(NBANDS):
        lo, hi = float(edges[k]), float(edges[k + 1])
        s_poly.append(s_poly_coeffs_from_temper(tau_cb[:, k], temper, lo, hi))
        surface.append(band_integrated_emission(temper[:, -1], lo, hi))
    b_pos = torch.stack(surface, dim=1).reshape(-1, 1, 1).expand(-1, NQUAD // 2, 1)
    return torch.stack(s_poly, dim=1).reshape(C * NBANDS, -1, 2), b_pos


def temperature_chunk(a, temper, tau_eval=None):
    """Temperatures -> fluxes: ``planck_stage``, ``make_batched_problem`` and
    ``solve_fluxes`` of the longwave configuration (`longwave_problem`) on
    the device of ``a["tau"]`` (tensors of the chunk's arrays), at the layer
    bottoms unless ``tau_eval`` (B, Ntau) is given."""
    from pythonic_disort_torch import solve_fluxes

    s_poly, b_pos = planck_stage(a["tau"], temper)
    prob, tau = longwave_problem(dict(a, s_poly=s_poly, b_pos=b_pos), a["tau"].dtype, a["tau"].device,
                                 only_flux=True)
    return solve_fluxes(prob, tau if tau_eval is None else tau_eval)


def host_route(a, temper, nrows):
    """The float64 host route (scipy's adaptive quadrature) for the first
    ``nrows`` rows: level emissions (nrows, L + 1), ``s_poly`` and ``b_pos``."""
    from pythonic_disort_torch.utils.thermal import blackbody_contrib_to_BCs, generate_s_poly_coeffs

    edges = band_edges()
    emission = np.empty((nrows, NLAYERS + 1))
    s_poly = np.empty((nrows, NLAYERS, 2))
    for r in range(nrows):
        c, k = divmod(r, NBANDS)
        emission[r] = blackbody_contrib_to_BCs(temper[c], edges[k], edges[k + 1])
        s_poly[r] = generate_s_poly_coeffs(a["tau"][r], temper[c], edges[k], edges[k + 1])
    b_pos = np.broadcast_to(emission[:, -1, None, None], (nrows, NQUAD // 2, 1)).copy()
    return emission, s_poly, b_pos


def on_device(a, dtype, device, grad=()):
    """The chunk's arrays as tensors (``grad``: the keys that require one)."""
    import torch

    return {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=k in grad) for k, v in a.items()
            if k in ("tau", "omega", "leg", "f_arr")}


def temperature_gradient(a, temper, dtype, device, wrt):
    """d sum(flux_up at the top) / d (``wrt``: "temper", and "omega" if
    asked) of the temperature chunk; returns a step function that gives the
    gradients (tensors in the order of ``wrt``)."""
    import torch

    arrs = on_device(a, dtype, device, grad=wrt)
    T = torch.tensor(temper, dtype=dtype, device=device, requires_grad=True)
    top = torch.zeros((a["tau"].shape[0], 1), dtype=dtype, device=device)
    leaves = [T if k == "temper" else arrs[k] for k in wrt]

    def step():
        return torch.autograd.grad(temperature_chunk(arrs, T, top)[0].sum(), leaves)

    return step


def phase_longwave(kernels, card):
    """Phase 9: a longwave sweep from temperature profiles to fluxes (the
    Planck route on the card), its gradient with respect to the
    temperatures, ARTS through the port's ``subroutines``, and the mu
    interpolation and actinic closures of a golden, in float32 on the card."""
    import torch
    from pythonic_disort_torch import pydisort, solve_fluxes
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.ops.planck import band_integrated_emission
    from pythonic_disort_torch.subroutines import generate_diff_act_flux_funcs, interpolate
    from pythonic_disort_torch.utils import profiling

    t_phase = time.perf_counter()
    by_name = {k["name"]: k for k in kernels}
    others = [k for k in _build.kernel_sources() if k not in ("eig_stage", "bvp_fused_wide", "bvp_operands")]
    S, nref = CHUNK_COLS * NBANDS, REF_COLS * NBANDS
    log(f"phase 9: longwave chunk from temperatures, {CHUNK_COLS} columns x {NBANDS} bands "
        f"({LW_RANGE[0]:g}-{LW_RANGE[1]:g} cm^-1), L={NLAYERS}, NQuad={NQUAD}, NFourier=1, delta-M, no beam, "
        f"f32, cuda ({card})")
    a = bench_arrays(CHUNK_COLS)
    temper = temperature_profiles(CHUNK_COLS)
    arrs = on_device(a, torch.float32, "cuda")
    T = torch.tensor(temper, dtype=torch.float32, device="cuda")

    # (a) temperatures -> sources -> fluxes
    chunk = lambda: temperature_chunk(arrs, T)
    out, launches = launched(chunk, "(a) one longwave chunk from temperatures",
                             ("eig_stage", "bvp_fused_wide", "bvp_operands"), others)
    for name, k in (("eig_stage", "eig_stage"), ("bvp_fused", "bvp_fused_wide")):
        by_name[name]["launches_temperature_chunk"] = launches[k]
    check(all(x.shape == (S, NLAYERS) and torch.isfinite(x).all().item() for x in out),
          f"(a) fluxes finite with shape ({S}, {NLAYERS})")
    t0 = time.perf_counter()
    emission, s_host, b_host = host_route(a, temper, nref)
    log(f"  float64 host route ({nref} rows, scipy quad_vec) in {time.perf_counter() - t0:.1f} s")
    edges = band_edges()
    e_card = torch.stack([band_integrated_emission(T[:REF_COLS], float(edges[k]), float(edges[k + 1]))
                          for k in range(NBANDS)], dim=1).reshape(nref, -1).double().cpu().numpy()
    rel = (np.abs(e_card - emission).max(axis=1) / np.abs(emission).max(axis=1)).max()
    log(f"  level emissions ({nref} rows x {NLAYERS + 1} levels, {emission.min():.3e} to {emission.max():.3e}): "
        f"max |f32 - host f64| / row max = {rel:.3e} (bound {LW_EMISSION_TOL:g})")
    check(np.isfinite(e_card).all() and rel < LW_EMISSION_TOL,
          f"(a) level emissions within {LW_EMISSION_TOL:g} x their row's maximum of the float64 host route")
    t0 = time.perf_counter()
    ref = solve_fluxes(*longwave_problem(dict(rows(a, nref), s_poly=s_host, b_pos=b_host), torch.float64, "cpu",
                                         only_flux=True))
    log(f"  float64 CPU reference on the host route's sources ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    check(ref[2].abs().max().item() == 0 and ref[0].abs().min().item() > 0,
          "(a) no direct beam, upward flux everywhere")
    for lbl, r, o in zip(("fup", "fdn", "fdir"), ref, out):
        within(r.numpy(), o[:nref].double().cpu().numpy(), f"(a) {lbl} ({nref} rows)")
    s_poly, b_pos = planck_stage(arrs["tau"], T)
    prob, tau = longwave_problem(dict(arrs, s_poly=s_poly, b_pos=b_pos), torch.float32, "cuda", only_flux=True)
    # the three timed in turns: the host-bound stages vary with what ran before
    runs = {"Planck stage": lambda: planck_stage(arrs["tau"], T), "solve": lambda: solve_fluxes(prob, tau),
            "whole chunk": chunk}
    times = {k: [] for k in runs}
    for _ in range(REPS):
        for k, run in runs.items():
            times[k].append(best_ms(run, 1, reps=1))
    planck_ms, solve_ms, chunk_ms = (min(t) for t in times.values())
    log("  (a) host clock, in turns: " + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} ms"
                                                   for k, v in times.items()))
    log(f"  (a) best of {REPS}: Planck stage {planck_ms:.3f} ms per chunk ({2 * NBANDS} calls), solve "
        f"{solve_ms:.3f} ms, the whole chunk from temperatures to fluxes {chunk_ms:.3f} ms "
        f"({CHUNK_COLS / chunk_ms * 1e3:.3f} columns/s)")
    phase_trace(chunk, "phase 9 (a), one longwave chunk from temperatures to fluxes", chunk_ms)

    # (b) d sum(flux_up at the top) / d temper, and jointly with omega
    t0 = time.perf_counter()
    g_ref = temperature_gradient(rows(a, nref), temper[:REF_COLS], torch.float64, "cpu", ("temper", "omega"))()
    log(f"  float64 CPU gradient, d / d (temper, omega) ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    for wrt, on, off in ((("temper",), ("eig_stage", "bvp_fused_wide", "blocktri"), ("jacobi_eigh",)),
                         (("temper", "omega"), ("jacobi_eigh", "bvp_fused_wide", "blocktri"), ("eig_stage",))):
        label = "d / d " + " and ".join(wrt)
        step = temperature_gradient(a, temper, torch.float32, "cuda", wrt)
        g, launches = launched(step, f"(b) one gradient step, {label}", on,
                               off + ("jacobi_eigh_wide", "blocktri_wide"))
        for k in on:
            by_name["bvp_fused" if k == "bvp_fused_wide" else k][
                f"launches_temperature_gradient_{'_'.join(wrt)}"] = launches[k]
        within_grad(g[0][:REF_COLS], g_ref[0], 2e-3, f"(b) {label}: d sum(flux_up(top)) / d temper, columns 0-1")
        if len(wrt) > 1:
            within_grad(g[1][:nref], g_ref[1], 2e-3, f"(b) {label}: d sum(flux_up(top)) / d omega, {nref} rows")
        step_ms = best_ms(step, 1)
        log(f"  (b) {label}: forward + backward {step_ms:.3f} ms per chunk (best of {REPS}); "
            f"the forward chunk {chunk_ms:.3f} ms")
        phase_trace(step, f"phase 9 (b), one gradient step, {label}", step_ms)

    # (c) ARTS through the port's subroutines
    log("  (c) 8ARTS_A: 101 pure-absorption atmospheres, 20 layers, NQuad=8, one pydisort call each")
    for dtype in (torch.float32, torch.float64):
        profiling.reset()
        t0 = time.perf_counter()
        surf, ref = arts_a_surface(dtype, "cuda")
        ms = 1e3 * (time.perf_counter() - t0) / len(ref)
        launches = Counter(profiling.recorded()["launches"])
        err = np.max(np.abs(surf - ref) / ref)
        log(f"    {dtype}: max relative error of the surface intensity {err:.3e}; {ms:.3f} ms per call "
            f"(pydisort and one u evaluation); launches {launches}")
        check(launches["eig_stage"] == launches["blocktri"] == len(ref)
              and sum(launches.values()) == 2 * len(ref), f"8ARTS_A {dtype}: kernels 1 and 3 once a call")
        if dtype == torch.float64:
            check(err < 1e-2, "8ARTS_A in float64 on the card: surface intensity within 1e-2 of the golden")
        else:
            check(np.isfinite(surf).all(), "8ARTS_A in float32: finite (the 1e-2 bound needs float64: the deep "
                  "layers' source intercepts cancel, ROADMAP section 3)")
            by_name["eig_stage"]["launches_arts_a"] = launches["eig_stage"]
            by_name["blocktri"]["launches_arts_a"] = launches["blocktri"]
    log("  (c) 8ARTS_B0-2: 48 layers, NQuad=40, microwave, float32")
    for ifreq in range(3):
        kw = arts_b_inputs(ifreq)
        profiling.reset()
        got = arts_b_readings(kw, ifreq, torch.float32, "cuda")
        launches = Counter(profiling.recorded()["launches"])
        ms = best_ms(lambda: pydisort(**kw, dtype=torch.float32, device="cuda")[1](kw["tau_arr"][-1]), 1)
        log(f"    8ARTS_B{ifreq}: " + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
            + f"; {ms:.3f} ms per call (solve and one flux_up, best of {REPS}); launches {launches}")
        check(launches["eig_stage"] == 1 and launches["blocktri"] == 1 and sum(launches.values()) == 2,
              f"8ARTS_B{ifreq}: kernels 1 and 3 once")
        check(all(v < ARTS_B_LIMITS[k] for k, v in got.items()),
              f"8ARTS_B{ifreq}: u within 1e-2 and fluxes within 1e-3 (relative, where |diff| > 1e-3)")

    # (e) the mu interpolation and actinic closures of one golden
    kw = golden_cases()[CLOSURE_GOLDEN][0]
    log(f"  (e) golden {CLOSURE_GOLDEN}'s closures: interpolate(u), interpolate(u0), the actinic fluxes")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mu, _, _, u0, u = pydisort(**kw, dtype=torch.float32, device="cuda")
        _, _, _, u0_64, u_64 = pydisort(**kw, dtype=torch.float64, device="cpu")
    taus = np.linspace(0.0, np.atleast_1d(kw["tau_arr"])[-1], 5)
    phis = np.array([0.0, 1.5, 3.0])
    mus = np.concatenate([mu, [0.3, -0.45, 1.0]])
    within(interpolate(u_64)(mus, taus, phis), interpolate(u)(mus, taus, phis), "(e) interpolate(u)")
    within(interpolate(u0_64)(mus, taus), interpolate(u0)(mus, taus), "(e) interpolate(u0)")
    for lbl, f, f64 in zip(("up", "down"), generate_diff_act_flux_funcs(u0), generate_diff_act_flux_funcs(u0_64)):
        within(f64(taus), f(taus), f"(e) diffuse actinic flux {lbl}")
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s ({card})")


# phase 10: a sweep of SWEEP_CHUNKS full chunks (CHUNK_COLS x NBANDS solves)
# and one ragged chunk of half as many, through parallel.SweepDriver; the
# chunks whose manifest entries the resume check deletes
SWEEP_CHUNKS, SWEEP_DROPPED = 16, (3, 9, 16)


def phase_sweep(kernels, card):
    """Phase 10: the resumable sweep driver on the card.  bench.py's arrays
    for SWEEP_CHUNKS full chunks and a ragged one, built once on the card;
    `SweepDriver.run` with and without overlap in turns, each into a fresh
    directory under build/; its files against `solve_fluxes` on each chunk's
    slice and against each other bit for bit, a resume, the ragged chunk
    against float64 on the CPU, the syncs of a chunk and a trace.  Returns
    the first sweep's ``gather()``."""
    import json as json_mod
    import shutil
    import tempfile
    import torch
    from pythonic_disort_torch import solve_fluxes
    from pythonic_disort_torch.parallel import SweepDriver
    from pythonic_disort_torch.tools.mesh_worker import problem_rows
    from pythonic_disort_torch.utils import profiling

    t_phase = time.perf_counter()
    chunk = CHUNK_COLS * NBANDS
    n_total = SWEEP_CHUNKS * chunk + chunk // 2
    n_chunks = SWEEP_CHUNKS + 1
    ncols = n_total // NBANDS
    log(f"phase 10: the sweep driver, {n_total} solves ({ncols} columns x {NBANDS} bands) in {SWEEP_CHUNKS} "
        f"chunks of {chunk} and one of {chunk // 2}, L={NLAYERS}, NQuad={NQUAD}, f32, cuda ({card})")
    t0 = time.perf_counter()
    arrs = bench_arrays(ncols)
    problem, tau = make_problem(arrs, torch.float32, "cuda")
    torch.cuda.synchronize()
    log(f"  the problem built on the card once in {time.perf_counter() - t0:.1f} s")
    part = lambda a, b: problem_rows(problem, a, b)
    depths = lambda a, b: tau[a:b]
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="sweep-", dir=scratch))
    try:
        runs = iter(range(1000))

        def sweep(overlap):
            """A sweep into a fresh directory: (driver, per-chunk times, wall ms)."""
            driver = SweepDriver(str(work / f"run{next(runs)}"), chunk, overlap=overlap)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            times = driver.run(part, depths, n_total)
            return driver, times, 1e3 * (time.perf_counter() - t0)

        profiling.reset()
        first, times, first_ms = sweep(True)
        launches = Counter(profiling.recorded()["launches"])
        log(f"  launches in the first overlapped sweep: {launches}; {first_ms:.3f} ms")
        check(launches["eig_stage"] == launches["bvp_fused_wide"] == launches["bvp_operands"] == n_chunks
              and sum(launches.values()) == 3 * n_chunks,
              f"the sweep launches kernels 1 and 7 and the operands kernel once a chunk ({n_chunks} chunks), no other")
        for name, source in (("eig_stage", "eig_stage"), ("bvp_fused", "bvp_fused_wide")):
            next(k for k in kernels if k["name"] == name)["launches_sweep"] = launches[source]
        check(sorted(times) == list(range(n_chunks)), f"run returns the times of all {n_chunks} chunks")
        out = first.gather()
        ref = [torch.cat(x).cpu().numpy() for x in zip(*(
            solve_fluxes(part(a, min(a + chunk, n_total)), depths(a, min(a + chunk, n_total)))
            for a in range(0, n_total, chunk)))]
        check(all(out[k].shape == (n_total, NLAYERS) and np.array_equal(out[k], r)
                  for k, r in zip(("flux_up", "flux_down_diffuse", "flux_down_direct"), ref)),
              f"gather() equals solve_fluxes on each chunk's slice bit for bit, ({n_total}, {NLAYERS}) each")

        walls = {True: [], False: []}
        drivers = {}
        for _ in range(REPS):
            for overlap in (True, False):
                drivers[overlap], _, ms = sweep(overlap)
                walls[overlap].append(ms)
        for overlap in (True, False):
            got = drivers[overlap].gather()
            check(all(np.array_equal(got[k], out[k]) for k in out),
                  f"the sweep with overlap={overlap} equals the first bit for bit")
        best = {k: min(v) for k, v in walls.items()}
        for overlap in (True, False):
            log(f"  overlap={overlap}: {', '.join(f'{t:.3f}' for t in walls[overlap])} ms (in turns); best "
                f"{best[overlap]:.3f} ms, {ncols / best[overlap] * 1e3:.3f} columns/s, "
                f"{best[overlap] / n_chunks:.3f} ms a chunk")
        log(f"  overlap saves {best[False] - best[True]:.3f} ms of {best[False]:.3f} "
            f"({1 - best[True] / best[False]:.3f})")

        # resume: three chunks lose their manifest entries
        path = work / "run0" / "manifest.json"
        manifest = json_mod.loads(path.read_text())
        for ci in SWEEP_DROPPED:
            del manifest["chunks"][str(ci)]
        path.write_text(json_mod.dumps(manifest))
        resumed = SweepDriver(str(work / "run0"), chunk)
        times = resumed.run(part, depths, n_total)
        check(sorted(times) == list(SWEEP_DROPPED), f"a resume runs exactly chunks {SWEEP_DROPPED}, got {sorted(times)}")
        got = resumed.gather()
        check(all(np.array_equal(got[k], out[k]) for k in out), "gather() after the resume is unchanged bit for bit")

        # the ragged chunk against float64 on the CPU
        a, nref = SWEEP_CHUNKS * chunk, REF_COLS * NBANDS
        t0 = time.perf_counter()
        p64, tau64 = make_problem({k: v[a:a + nref] for k, v in arrs.items()}, torch.float64, "cpu")
        ref64 = [x.numpy() for x in solve_fluxes(p64, tau64)]
        log(f"  float64 CPU reference ({nref} solves) in {time.perf_counter() - t0:.1f} s")
        for lbl, r, k in zip(("fup", "fdn", "fdir"), ref64, out):
            within(r, out[k][a:a + nref].astype(np.float64), f"the ragged chunk's first {nref} rows, {lbl}")

        # host syncs of a chunk, as the sync debug mode sees them
        for overlap in (True, False):
            driver = SweepDriver(str(work / f"syncs-{overlap}"), chunk, overlap=overlap)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    driver.run(part, depths, n_total)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = Counter(str(w.message).splitlines()[0][:100] for w in caught
                            if "synchroniz" in str(w.message).lower())
            log(f"  overlap={overlap}: {sum(syncs.values())} synchronizing operations flagged in {n_chunks} chunks "
                f"({sum(syncs.values()) / n_chunks:.2f} a chunk){': ' + str(dict(syncs)) if syncs else ''}; "
                f"besides, the drain's wait on its copy's event, once a chunk"
                + ("" if overlap else " after a device synchronization"))
        phase_trace(lambda: sweep(True), "phase 10, one overlapped sweep", best[True])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# phase 11: the mesh.  (a) world 1 in this process on the main-path chunk;
# (b) MESH_RANKS gloo ranks of tools/mesh_worker.py sharing the card (NCCL
# refuses two ranks on one device), each on its own rows: bench.py's flux
# sweep of MESH_COLS columns (one main-path chunk a rank), the intensity
# chunk on a (ranks, 1) ("columns", "bands") mesh, and SweepDriver with the
# mesh over the first 4.5 chunks of phase 10's arrays.  Sharded rows against
# the unsharded float32 solve within MESH_TOL x max(|f|, 1) (the bound of
# __graft_entry__.py:163-170), grown by POLE / d on a row whose distance d
# to the beam pole (`beam_pole_distance`) is below POLE: half the batch runs
# the plain tensor code's reductions in another order, and the particular
# solution there magnifies the last bits by about 1 / d (the unsharded and
# the sharded row lie equally far from float64); the ranks' wait,
# MESH_TIMEOUT s.
MESH_RANKS, MESH_COLS, MESH_TOL, MESH_TIMEOUT = 2, 16, 1e-5, 300


def pole_growth(problem):
    """Per row of a batched problem, max(1, POLE / d): d the distance to the
    beam pole, min |K mu0 - 1| over its layers, modes and eigenvalues K of
    its float32 solve on the card."""
    from pythonic_disort_torch.models.disort.batch_solve import solve_batched

    N = problem.config.n
    K = solve_batched(problem).K[..., N:].double()                    # (S, NF, L, N), K > 0
    d = (K * problem.mu0.double()[:, None, None, None] - 1).abs().amin(dim=(1, 2, 3))
    return (POLE / d).clamp(min=1.0).cpu().numpy()


def near(a, b, label, growth, scale=None):
    """Per row (the leading axis), |a - b| < MESH_TOL x scale x growth, the
    scale max(|b|, 1) unless given; logs the rows near the beam pole that
    needed the growth.  Returns whether a equals b bit for bit."""
    bound = MESH_TOL
    scale = max(float(np.abs(b).max()), 1.0) if scale is None else scale
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).reshape(len(a), -1).max(axis=1)
    far = growth == 1
    equal = bool(np.array_equal(a, b))
    log(f"  {label}: max |sharded - unsharded| = {d.max():.3e}, {d[far].max(initial=0):.3e} on the "
        f"{int(far.sum())} rows at d >= {POLE:g} (bound {bound * scale:.3e}); {int((d >= bound * scale).sum())} rows "
        f"above it, each within its growth POLE / d (largest (|diff| / bound) / growth "
        f"{(d / (bound * scale * growth)).max():.3f}); bit for bit: {equal}")
    check(np.isfinite(a).all() and (d < bound * scale * growth).all(),
          f"{label} within {bound:g} x {scale:.3g} x max(1, POLE / d) of the unsharded solve")
    return equal


def flagged_syncs(run):
    """The synchronizing operations the sync debug mode flags in ``run()``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def phase_mesh(problem, tau, kernels, card, sweep_out):
    """Phase 11: the sharded entries on the card, in this process at world 1
    (a) and over MESH_RANKS ranks of ``tools/mesh_worker.py`` sharing the
    card through gloo (b)."""
    import os
    import shutil
    import tempfile
    import torch
    from pythonic_disort_torch import solve_fluxes, solve_intensity
    from pythonic_disort_torch.ops import _build
    from pythonic_disort_torch.parallel import (
        SweepDriver, count_collectives, default_mesh, initialize_distributed, shard_batch, solve_fluxes_sharded)
    from pythonic_disort_torch.tools import mesh_worker
    from pythonic_disort_torch.utils import profiling

    t_phase = time.perf_counter()
    log(f"phase 11: the mesh ({card})")
    log(f"  (a) world 1 in this process: {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}, NQuad={NQUAD}, f32")
    mesh = default_mesh()
    check(mesh.world == 1 and mesh.device == torch.device("cuda", 0) and mesh.groups == (None,),
          "default_mesh() without a process group: one rank on cuda:0, no group")
    local, tau_s = shard_batch(problem, mesh), shard_batch(tau, mesh)
    check(local.tau_arr.data_ptr() == problem.tau_arr.data_ptr() and tau_s.data_ptr() == tau.data_ptr(),
          "shard_batch at world 1 hands on views: no copy")
    profiling.reset()
    outs, counts = count_collectives(solve_fluxes_sharded, local, tau_s, mesh)
    torch.cuda.synchronize()
    launches = Counter(profiling.recorded()["launches"])
    log(f"  launches: {launches}; collectives: {counts}")
    check(launches["eig_stage"] == launches["bvp_fused_wide"] == launches["bvp_operands"] == 1
          and sum(launches.values()) == 3,
          "solve_fluxes_sharded launches kernels 1 and 7 and the operands kernel once each, no other")
    check(all(v == 0 for v in counts.values()), "count_collectives reads zero for every kind")
    check(all(torch.equal(a, b) for a, b in zip(outs, solve_fluxes(problem, tau))),
          "solve_fluxes_sharded equals solve_fluxes bit for bit")
    syncs = {name: flagged_syncs(run) for name, run in (
        ("solve_fluxes", lambda: solve_fluxes(problem, tau)),
        ("solve_fluxes_sharded", lambda: solve_fluxes_sharded(local, tau_s, mesh)))}
    log(f"  synchronizing operations flagged in one call: {syncs}")
    check(syncs["solve_fluxes_sharded"] == syncs["solve_fluxes"], "the sharded entry adds no synchronization")
    walls = {"solve_fluxes": [], "solve_fluxes_sharded": []}
    for _ in range(REPS):
        walls["solve_fluxes"].append(best_ms(lambda: solve_fluxes(problem, tau), N_CHUNKS, reps=1))
        walls["solve_fluxes_sharded"].append(best_ms(lambda: solve_fluxes_sharded(local, tau_s, mesh), N_CHUNKS,
                                                     reps=1))
    for name, t in walls.items():
        log(f"  {name}: {', '.join(f'{x:.3f}' for x in t)} ms a chunk (in turns, {N_CHUNKS} chunks each); "
            f"best {min(t):.3f} ms, {CHUNK_COLS / min(t) * 1e3:.3f} columns/s")

    log(f"  (b) {MESH_RANKS} gloo ranks sharing the card ({card})")
    raises(lambda: initialize_distributed("127.0.0.1:1", MESH_RANKS, 0, backend="nccl"), ValueError,
           f"initialize_distributed with NCCL for {MESH_RANKS} ranks on one card")
    check(all(_build.library_path(n).exists() for n in _build.kernel_sources()),
          "phase 2 built every kernel: the ranks load them and build none")
    work = Path(tempfile.mkdtemp(prefix="mesh-", dir=Path(__file__).resolve().parent / "build"))
    try:
        t0 = time.perf_counter()
        ranks = mesh_worker.run_ranks(
            MESH_RANKS, ["bench", "bench_intensity", "bench_sweep"], work, device="cuda", backend="gloo",
            timeout=MESH_TIMEOUT, env=dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2))),
            sweep_dir=work / "sweep")
        ranks_s = time.perf_counter() - t0
        sweep = SweepDriver(str(work / "sweep"), mesh_worker.SWEEP_CHUNK).gather()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  the {MESH_RANKS} ranks ran in {ranks_s:.1f} s (start, kernels loaded, cases, float64 references)")
    for rank, (meta, _) in enumerate(ranks):
        check(meta["backend"] == "gloo" and meta["device"] == "cuda:0", f"rank {rank}: gloo on cuda:0")

    # the bench sweep: each rank one main-path chunk
    arrs = bench_arrays(MESH_COLS)
    full, ftau = make_problem(arrs, torch.float32, "cuda")
    ref = [x.cpu().numpy() for x in solve_fluxes(full, ftau)]
    growth = pole_growth(full)
    del full, ftau
    bit_equal = []
    for rank, (meta, arr) in enumerate(ranks):
        m = meta["bench"]
        (a, b), = m["index"]
        check((a, b) == (rank * CHUNK_COLS * NBANDS, (rank + 1) * CHUNK_COLS * NBANDS),
              f"rank {rank} holds solves {a}:{b}")
        log(f"  rank {rank}: launches {m['launches']}, collectives {m['counts']}; global_flux_stats "
            f"{m['stat_counts']} on {m['stat_device']}; float64 reference in {m['ref_s']:.1f} s")
        check(m["launches"] == {"eig_stage": 1, "bvp_fused_wide": 1, "blocktri": 0},
              f"rank {rank}: kernels 1 and 7 launched once, kernel 3 not")
        check(all(v == 0 for v in m["counts"].values()), f"rank {rank}: count_collectives of the solve reads zero")
        bit_equal.append(all([near(arr[f"bench_{k}"], r[a:b], f"rank {rank} {k}", growth[a:b])
                              for k, r in zip(("fup", "fdn", "fdir"), ref)]))
        for k in ("fup", "fdn", "fdir"):
            within(arr[f"bench_ref_{k}"], arr[f"bench_{k}"][:mesh_worker.REF_ROWS].astype(np.float64),
                   f"rank {rank}'s first {mesh_worker.REF_ROWS} rows, {k}")
        mean = float(ref[0].astype(np.float64).mean())
        log(f"  rank {rank}: global_flux_stats {m['stat']:.9g}, unsharded mean {mean:.9g}")
        check(m["stat_counts"]["all-reduce"] == 1 and m["stat_device"] == "cuda:0"
              and abs(m["stat"] - mean) < 1e-6 * abs(mean),
              f"rank {rank}: global_flux_stats is one all_reduce of CUDA tensors through gloo, within 1e-6 "
              "of the unsharded mean")
    for k, source in zip(kernels[:2], ("eig_stage", "bvp_fused_wide")):
        k["launches_sharded"] = [meta["bench"]["launches"][source] for meta, _ in ranks]
        k["launches_sharded_on"] = f"{MESH_RANKS} gloo ranks on one card, one main-path chunk a rank"

    # the intensity chunk on a (ranks, 1) (columns, bands) mesh
    iprob, itau, iphi = intensity_problem(bench_arrays(INT_COLS, seed=7), torch.float32, "cuda")
    u_ref = solve_intensity(iprob, itau, iphi, probes_per_layer=True).cpu().numpy()
    u_growth = pole_growth(iprob).reshape(INT_COLS, -1)
    del iprob, itau, iphi
    u_ref = u_ref.reshape((INT_COLS, -1) + u_ref.shape[1:])
    for rank, (meta, arr) in enumerate(ranks):
        m = meta["bench_intensity"]
        idx = tuple(slice(a, b) for a, b in m["index"])
        log(f"  rank {rank} (coordinates {m['coords']}): intensity rows {m['index']}, launches {m['launches']}, "
            f"collectives {m['counts']}")
        check(m["launches"]["eig_stage"] == 1 and m["launches"]["bvp_fused_wide"] == 1
              and all(v == 0 for v in m["counts"].values()),
              f"rank {rank}: the sharded intensity launches kernels 1 and 7 once, no collective")
        near(arr["bench_intensity_u"][0], u_ref[idx][0], f"rank {rank} u, scale max|u|", u_growth[idx][0],
             scale=float(np.abs(u_ref).max()))

    # SweepDriver over the mesh against phase 10's single-device sweep
    n = mesh_worker.SWEEP_TOTAL
    sweep_growth = pole_growth(make_problem(rows(bench_arrays(mesh_worker.SWEEP_COLS), n), torch.float32, "cuda")[0])
    sweep_equal = all([near(sweep[k], sweep_out[k][:n], f"the mesh sweep's {n} rows, {k}", sweep_growth)
                       for k in sweep])
    for rank, (meta, _) in enumerate(ranks):
        m = meta["bench_sweep"]
        log(f"  rank {rank}: sweep chunks {m['ran']}, launches {m['launches']}, collectives {m['counts']}; "
            f"resumed {m['resumed']}")
        check(m["ran"] == list(range(5)) and m["launches"]["eig_stage"] == 5 and m["launches"]["bvp_fused_wide"] == 5,
              f"rank {rank}: the mesh sweep runs its 5 chunks, kernels 1 and 7 once a chunk")
        check(m["resumed"] == list(mesh_worker.SWEEP_DROPPED),
              f"rank {rank}: the resume runs exactly chunks {list(mesh_worker.SWEEP_DROPPED)}")
    check(ranks[0][0]["bench_sweep"]["resume_equal"], "the resumed directory equals the first sweep bit for bit")

    log(f"  time-shared on one card: not a scaling measurement ({card})")
    for rank, (meta, _) in enumerate(ranks):
        log(f"    rank {rank}: bench chunk {meta['bench']['ms']:.3f} ms (best of 3), intensity chunk "
            f"{meta['bench_intensity']['ms']:.3f} ms, mesh sweep {meta['bench_sweep']['wall_ms']:.3f} ms; "
            + ", ".join(f"{c} {meta[c]['seconds']:.1f} s" for c in ("bench", "bench_intensity", "bench_sweep")))
    log(f"  bit for bit against the unsharded solve: bench ranks {bit_equal}, the mesh sweep {sweep_equal}")
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s ({card})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pythonic_disort_torch import solve_fluxes      # fails outside the repository

    log("phase 1: device")
    card = phase_device()
    log("phase 2: build")
    phase_build()
    arrs = bench_arrays(CHUNK_COLS)
    problem, tau = make_problem(arrs, torch.float32, "cuda")
    main_ops = capture_kernel_inputs(problem, tau)
    ops48, kernels = phase_kernels(main_ops)
    phase_intensity_kernels(kernels)
    phase_bvp_narrow(main_ops, kernels)
    kernels += phase_wide_kernels() + [phase_bvp_wide(ops48), phase_legendre(), phase_operands(main_ops)]
    chunk_ms = phase_main_path(arrs, problem, tau, kernels)
    phase_trace(lambda: solve_fluxes(problem, tau), "phase 4, one main-path chunk", chunk_ms)
    phase_single_column(kernels)
    phase_gradient(arrs, kernels, chunk_ms)
    phase_widths(kernels)
    phase_intensity(kernels, card)
    phase_longwave(kernels, card)
    sweep_out = phase_sweep(kernels, card)
    phase_mesh(problem, tau, kernels, card, sweep_out)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
