"""The port's utilities and ``subroutines`` namespace held against the JAX
package (CPU, float64).

The host functions (mu interpolation, actinic fluxes, BDRF helpers and
surfaces, ``misc``, quadrature, ``_mathscr_v``) on the cases of
``tests/test_utils.py`` and ``tests/test_ops.py``, run on the port's
``pydisort`` closures and on the JAX package's; the inputs of the 35
Stamnes cases built with either package's ``subroutines`` (the port's
cases come from ``chip_smoke.golden_cases``, which ``chip_smoke.py`` runs
on the card); ``8ARTS_A``, ``8ARTS_B0-2``, ``9corrections`` and
``tests/test_consistency.py``'s checks through the port alone, at those
tests' thresholds; the profiling tools; and that no module of the port
imports JAX or the JAX package.
"""

import inspect
import subprocess
import sys
import warnings
from math import pi
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.integrate import quad, quad_vec

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import subroutines as jsub
from pythonic_disort_tpu.models import surfaces as jsurfaces

import chip_smoke
import pythonic_disort_torch as pt
from pythonic_disort_torch import subroutines as tsub
from pythonic_disort_torch.models import surfaces as tsurfaces
from pythonic_disort_torch.models.disort.solve import iso_particular_tensor, iso_poly_eval
from pythonic_disort_torch.utils import profiling
from pythonic_disort_torch.utils.profiling import nan_guard, trace
from test_stamnes import CASES as CASES_A
from test_stamnes_sources import CASES as CASES_B

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_subroutines_has_every_name():
    assert sorted(tsub.__all__) == sorted(jsub.__all__)
    missing = [name for name in jsub.__all__ if not hasattr(tsub, name)]
    assert not missing
    assert pt.subroutines is tsub


# ------------------------------------------------------------ closures
SOLVED_KW = dict(
    tau_arr=2.0, omega_arr=0.8, NQuad=16, Leg_coeffs_all=0.75 ** np.arange(32), mu0=0.6, I0=pi / 0.6,
    phi0=0.9 * pi, f_arr=0.75 ** 16, NT_cor=False, b_pos=1, b_neg=1, BDRF_Fourier_modes=[0.5],
    s_poly_coeffs=np.array([[1.0, 2.0]]))


@pytest.fixture(scope="module")
def solved():
    """``tests/test_utils.py``'s ``solved`` case through both packages."""
    return pt.pydisort(**SOLVED_KW, device="cpu"), pdt.pydisort(**SOLVED_KW)


def test_interpolate_u(solved):
    (mu_arr, _, _, _, u), ref = solved
    u_interp, ref_interp = tsub.interpolate(u), jsub.interpolate(ref[4])
    tau, phi = np.array([0.3, 1.2]), np.array([0.1, 2.0, 4.0])
    np.testing.assert_allclose(u_interp(mu_arr, tau, phi), u(tau, phi), rtol=1e-10)
    mu = np.array([0.3, -0.45, 0.999, -0.02, 1.0, -1.0])
    out = u_interp(mu, tau, phi)
    assert out.shape == (6, 2, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref_interp(mu, tau, phi)), rtol=1e-9, atol=1e-12)
    # the return_tau_arr form and a scalar mu
    vals, tau_arr = u_interp(0.3, tau, phi, return_tau_arr=True)
    np.testing.assert_allclose(vals, out[0], rtol=1e-14)
    assert tau_arr[-1] == 2.0
    with pytest.raises(ValueError, match="mu values must be between -1 and 1"):
        u_interp(np.array([1.5]), tau, phi)


def test_interpolate_u0(solved):
    (mu_arr, _, _, u0, _), ref = solved
    u0_interp = tsub.interpolate(u0)
    tau = np.array([0.5, 1.5])
    np.testing.assert_allclose(u0_interp(mu_arr, tau), u0(tau), rtol=1e-10)
    mu = np.array([0.25, -0.7])
    np.testing.assert_allclose(u0_interp(mu, tau), np.asarray(jsub.interpolate(ref[3])(mu, tau)), rtol=1e-9,
                               atol=1e-12)


def test_actinic_closures(solved):
    (mu_arr, _, _, u0, _), ref = solved
    up, down = tsub.generate_diff_act_flux_funcs(u0)
    ref_up, ref_down = jsub.generate_diff_act_flux_funcs(ref[3])
    tau = np.array([0.25, 1.75])
    N = len(mu_arr) // 2
    _, W = np.polynomial.legendre.leggauss(N)
    np.testing.assert_allclose(up(tau), 2 * pi * (W / 2) @ u0(tau)[:N], rtol=1e-10)
    for ours, theirs in ((up, ref_up), (down, ref_down)):
        np.testing.assert_allclose(ours(tau), np.asarray(theirs(tau)), rtol=1e-9)
        np.testing.assert_allclose(ours(tau, True), np.asarray(theirs(tau, True)), rtol=1e-9)
        vals, tau_arr = ours(tau, return_tau_arr=True)
        np.testing.assert_array_equal(vals, ours(tau))
        assert tau_arr[-1] == 2.0


# ------------------------------------------------------------ surfaces, BDRF
def test_surfaces():
    mu = np.linspace(0.1, 1, 4)
    ours, theirs = tsurfaces.hapke_fourier_modes(3), jsurfaces.hapke_fourier_modes(3)
    for m in range(3):
        out = ours[m](mu, mu)
        assert out.shape == (4, 4) and np.isfinite(out).all()
        np.testing.assert_array_equal(out, theirs[m](mu, mu))
    assert tsurfaces.lambertian(0.2) == jsurfaces.lambertian(0.2) == [0.2]
    np.testing.assert_array_equal(tsurfaces.hapke(0.8, 0.1, 0.5)(mu, mu[::-1], 0.7),
                                  jsurfaces.hapke(0.8, 0.1, 0.5)(mu, mu[::-1], 0.7))


def test_bdrf_helpers():
    modes = tsurfaces.hapke_fourier_modes(4, nquad_phi=64)
    jmodes = jsurfaces.hapke_fourier_modes(4, nquad_phi=64)
    np.testing.assert_array_equal(tsub.generate_emissivity_from_BDRF(8, modes[0]),
                                  jsub.generate_emissivity_from_BDRF(8, jmodes[0]))
    assert tsub.generate_emissivity_from_BDRF(8, 0.3) == 1 - 0.3
    mu = np.polynomial.legendre.leggauss(8)[0] / 2 + 0.5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "No caching with respect to `mu0`."
        for mu0 in (0.6, 0.0):
            ours = tsub.cache_BDRF_Fourier_modes(8, modes + [0.25], mu0=mu0)
            theirs = jsub.cache_BDRF_Fourier_modes(8, jmodes + [0.25], mu0=mu0)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a(mu, mu), b(mu, mu))
                np.testing.assert_array_equal(a(mu, np.array([0.6])), b(mu, np.array([0.6])))
    full = lambda mu, neg_mup, dphi: np.outer(mu, neg_mup) * (1 + 0.5 * np.cos(dphi))
    for a, b in zip(tsub.fourier_modes_from_bdrf(full, 3, 32), jsub.fourier_modes_from_bdrf(full, 3, 32)):
        np.testing.assert_array_equal(a(mu, mu), b(mu, mu))


# ------------------------------------------------------------ misc, quadrature
def test_misc_functions():
    rng = np.random.default_rng(5)
    arr = rng.uniform(size=6)
    np.testing.assert_array_equal(tsub.prepend(arr, 6, 9.0), jsub.prepend(arr, 6, 9.0))
    args = (np.array([0.2, -0.5]), np.array([0.0, 1.0, 2.0]), np.array([0.7]), np.array([0.3, 4.0]))
    np.testing.assert_array_equal(tsub.calculate_nu(*args), jsub.calculate_nu(*args))
    for a in (3.0, arr, np.ones((2, 3))):
        np.testing.assert_array_equal(tsub.atleast_2d_append(a), jsub.atleast_2d_append(a))
    for x, y in zip(tsub.atleast_2d_append(1.0, arr), jsub.atleast_2d_append(1.0, arr)):
        np.testing.assert_array_equal(x, y)
    grid, D = tsub.generate_FD_mat(9, 0.0, 2.0)
    jgrid, jD = jsub.generate_FD_mat(9, 0.0, 2.0)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(D.toarray(), jD.toarray())
    A = rng.uniform(size=(7, 7))
    np.testing.assert_array_equal(tsub.to_diag_ordered_form(A, 2, 1), jsub.to_diag_ordered_form(A, 2, 1))
    np.testing.assert_array_equal(tsub.transform_interval(arr, 2.0, 5.0, 0.0, 1.0),
                                  jsub.transform_interval(arr, 2.0, 5.0, 0.0, 1.0))
    np.testing.assert_array_equal(tsub.transform_weights(arr, 2.0, 5.0, 0.0, 1.0),
                                  jsub.transform_weights(arr, 2.0, 5.0, 0.0, 1.0))


def test_quadrature_rules():
    for args in ((8,), (5, -1.0, 3.0)):
        for a, b in zip(tsub.Gauss_Legendre_quad(*args), jsub.Gauss_Legendre_quad(*args)):
            np.testing.assert_array_equal(a, b)
    for args in ((51,), (9, 1.0, 2.0)):
        for a, b in zip(tsub.Clenshaw_Curtis_quad(*args), jsub.Clenshaw_Curtis_quad(*args)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="odd and greater than 2"):
        tsub.Clenshaw_Curtis_quad(8)


def test_affine_transform_poly_coeffs_matches_jax():
    rng = np.random.default_rng(9)
    c, a, b = rng.normal(size=(4, 3)), rng.uniform(0.5, 2.0, 4), rng.normal(size=4)
    ours = tsub.affine_transform_poly_coeffs(*map(torch.tensor, (c, a, b)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jsub.affine_transform_poly_coeffs(c, a, b)), rtol=1e-12)


@pytest.mark.parametrize("anti", [False, True], ids=["plain", "antiderivative"])
def test_mathscr_v(anti):
    """``_mathscr_v`` against the JAX package's and against the solver's
    tensor pair ``iso_particular_tensor``/``iso_poly_eval`` (cubic sources,
    three layers, NQuad = 6)."""
    rng = np.random.default_rng(13)
    NL, NQ, ns = 3, 6, 4
    G = rng.normal(size=(NL, NQ, NQ))
    K = rng.uniform(0.5, 3.0, (NL, NQ)) * rng.choice([-1, 1], (NL, NQ))
    G_inv_mu_inv = rng.normal(size=(NL, NQ))
    s = rng.normal(size=(NL, ns))
    scale_tau = rng.uniform(0.5, 1.0, NL)
    tau = np.array([0.1, 0.4, 0.9, 1.3, 2.2])
    l = np.array([0, 0, 1, 2, 2])
    out = tsub._mathscr_v(tau, scale_tau, l, ns, s, G, K, G_inv_mu_inv, is_antiderivative_wrt_tau=anti)
    ref = jsub._mathscr_v(tau, scale_tau, l, ns, s, G, K, G_inv_mu_inv, is_antiderivative_wrt_tau=anti)
    assert out.shape == (NQ, len(tau))
    np.testing.assert_allclose(out, ref, rtol=1e-12)
    b = iso_particular_tensor(*map(torch.tensor, (G, K, G_inv_mu_inv)), torch.tensor(s[:, ::-1].copy()))
    t = torch.tensor(tau)
    v = iso_poly_eval(b[torch.tensor(l)], t, torch.tensor(scale_tau[l]), antiderivative=anti)
    np.testing.assert_allclose(v.numpy().T, out, rtol=1e-10, atol=1e-12 * np.abs(out).max())
    # the reference's per-tau scale_tau, (Ntau, 1), gives the same numbers
    if anti:
        out_t = tsub._mathscr_v(tau, scale_tau[l][:, None], l, ns, s, G, K, G_inv_mu_inv,
                                is_antiderivative_wrt_tau=True)
        np.testing.assert_allclose(out_t, out, rtol=1e-14)


# ------------------------------------------------------------ the Stamnes inputs
def _bdrf_values(modes, mu):
    """The first two and the last mode on ``mu`` x ``mu`` (the Hapke modes
    are one code path apart from the mode number)."""
    picked = modes if len(modes) <= 3 else [modes[0], modes[1], modes[-1]]
    return [np.full((len(mu), len(mu)), m) if np.isscalar(m) else np.asarray(m(mu, mu)) for m in picked]


def test_family_inputs_match_either_subroutines():
    """The 35 cases' arguments built with the port's ``subroutines`` and
    ``models.surfaces`` (``chip_smoke.golden_cases``) against those of
    ``tests/test_stamnes.py`` and ``tests/test_stamnes_sources.py`` (the JAX
    package's): arrays equal to roundoff, BDRF modes equal on a grid."""
    ours = chip_smoke.golden_cases()
    theirs = {**CASES_A, **CASES_B}
    assert sorted(ours) == sorted(theirs) and len(ours) == 35
    mu = np.linspace(0.05, 1.0, 7)
    for name, (kw, deg) in ours.items():
        case = theirs[name]() if callable(theirs[name]) else theirs[name]
        ref = case["kwargs"]
        assert deg == case.get("deg_around_beam", 0), name
        assert sorted(kw) == sorted(ref), name
        for key, value in ref.items():
            if key == "BDRF_Fourier_modes":
                assert len(kw[key]) == len(value), name
                for a, b in zip(_bdrf_values(kw[key], mu), _bdrf_values(value, mu)):
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} {key}")
            else:
                np.testing.assert_allclose(kw[key], value, rtol=1e-15, atol=0, err_msg=f"{name} {key}")
    common, extras = chip_smoke.corrections_case()
    assert extras["NT_cor"] and common["NQuad"] == 4


# ------------------------------------------------------------ ARTS, 9corrections
def test_8ARTS_A_through_the_port():
    out, ref = chip_smoke.arts_a_surface(torch.float64, "cpu")
    assert np.max(np.abs(out - ref) / ref) < 1e-2


@pytest.mark.parametrize("ifreq", [0, 1, 2])
def test_8ARTS_B_through_the_port(ifreq):
    got = chip_smoke.arts_b_readings(chip_smoke.arts_b_inputs(ifreq), ifreq, torch.float64, "cpu")
    assert all(got[k] < chip_smoke.ARTS_B_LIMITS[k] for k in got), got


def test_9corrections_through_the_port():
    (dfu, dfdd, diff), (dfu_dM, dfdd_dM, diff_NT) = chip_smoke.corrections_readings(torch.float64, "cpu")
    assert np.mean(dfu - dfu_dM) > 0
    assert np.mean(dfdd - dfdd_dM) > 0
    assert np.mean(diff - diff_NT) > 0
    assert np.max(dfu_dM) < 0.05 and np.max(dfdd_dM) < 0.05 and np.max(diff_NT) < 0.6


# ------------------------------------------------------------ consistency
def _full_feature_kwargs(tau_arr, nlayers, s_coeffs):
    """``tests/test_consistency.py``'s every-feature column."""
    leg = np.tile(0.75 ** np.arange(32), (nlayers, 1))
    return dict(
        tau_arr=tau_arr, omega_arr=np.full(nlayers, 0.8), NQuad=16,
        Leg_coeffs_all=leg if nlayers > 1 else leg[0], mu0=0.6, I0=pi / 0.6, phi0=0.9 * pi, b_pos=1, b_neg=1,
        f_arr=np.full(nlayers, leg[0, 16]) if nlayers > 1 else leg[0, 16],
        BDRF_Fourier_modes=[lambda mu, neg_mup: np.full((len(mu), len(neg_mup)), 1.0)],
        s_poly_coeffs=np.tile(s_coeffs, (nlayers, 1)) if nlayers > 1 else s_coeffs, NT_cor=True,
        device="cpu")


def test_single_vs_multi_layer_through_the_port():
    tau_arr = np.arange(16) / 2 + 0.5
    tau_test_arr = np.sort(np.random.default_rng(11).random(100) * tau_arr[-1])
    phi_arr, _ = tsub.Clenshaw_Curtis_quad(int((16 * pi) // 2) * 2 + 1)
    s = np.array([6.0, 7.0])
    fu1, fd1, _, u1 = pt.pydisort(**_full_feature_kwargs(tau_arr[-1], 1, s))[1:]
    fu16, fd16, _, u16 = pt.pydisort(**_full_feature_kwargs(tau_arr, 16, s))[1:]
    assert np.allclose(fu1(tau_test_arr), fu16(tau_test_arr))
    assert np.allclose(fd1(tau_test_arr), fd16(tau_test_arr))
    assert np.allclose(u1(tau_test_arr, phi_arr), u16(tau_test_arr, phi_arr))


@pytest.mark.parametrize("s_coeffs", [[1.0], [1.0, 2.0], [1.0, 2.0, 3.0, 4.0]],
                         ids=["constant", "linear", "cubic"])
def test_antiderivative_through_the_port(s_coeffs):
    kwargs = _full_feature_kwargs(np.array([8.0]), 1, np.array(s_coeffs))
    kwargs["BDRF_Fourier_modes"] = [1]
    flux_up, flux_down, u0, u = pt.pydisort(**kwargs)[1:]
    phi_arr, _ = tsub.Clenshaw_Curtis_quad(int((16 * pi) // 2) * 2 + 1)
    end = 8.0
    assert np.allclose(quad_vec(lambda tau: u(tau, phi_arr), 0, end)[0],
                       u(end, phi_arr, True) - u(0, phi_arr, True))
    assert np.allclose(quad_vec(u0, 0, end)[0], u0(end, True) - u0(0, True))
    assert np.allclose(quad(flux_up, 0, end)[0], flux_up(end, True) - flux_up(0, True))
    for i in (0, 1):
        assert np.allclose(quad(lambda tau: flux_down(tau)[i], 0, end)[0],
                           flux_down(end, True)[i] - flux_down(0, True)[i])


# ------------------------------------------------------------ profiling
def test_stage_timer_and_device_sync():
    """The recorder that replaced ``StageTimer`` and ``device_sync``: named
    stages timed (nested, repeated) and counted under a profiler, with
    nothing to synchronize on the CPU; nothing recorded without one."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profiling.span("a"):
        profiling.count("n")
    assert profiling.recorded()["spans"] == {} and profiling.recorded()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a", torch.device("cpu")):
            with profiling.span("b"):
                sum(range(1000))
        with profiling.span("a"):
            profiling.count("n", 2)
    rec = profiling.recorded()
    assert rec["spans"]["a"]["calls"] == 2 and rec["spans"]["b"]["calls"] == 1
    assert rec["spans"]["a"]["host_ms"] >= rec["spans"]["b"]["host_ms"] > 0
    assert rec["spans"]["a"]["device_ms"] is None and rec["counters"] == {"n": 2}
    profiling.reset()


def test_trace_writes_a_file(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_nan_guard():
    with pytest.raises(FloatingPointError, match="NaN"):
        with nan_guard():
            torch.log(torch.tensor(-1.0))
    torch.log(torch.tensor(-1.0))         # the guard is gone after the block
    # the solve of tests/test_determinism.py:47 raises nothing under it
    _, prob = pt.build_problem(
        tau_arr=np.array([0.5, 1.5]), omega_arr=np.array([0.7, 0.9]), NQuad=8,
        Leg_coeffs_all=np.tile(0.6 ** np.arange(9), (2, 1)), mu0=0.7, I0=pi, phi0=0.4,
        f_arr=np.array([0.6**8, 0.6**8]), device="cpu")
    from pythonic_disort_torch.models.disort import eval as ev

    with nan_guard():
        out = ev.u0(pt.solve(prob), torch.linspace(0.0, 2.0, 9, dtype=torch.float64))
    assert torch.isfinite(out).all()


# ------------------------------------------------------------ imports
def test_the_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (tools and ``chip_smoke.py`` included) in a
    fresh interpreter: neither ``jax`` nor ``pythonic_disort_tpu`` loads."""
    pkg = REPO / "pythonic_disort_torch"
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                     for p in pkg.rglob("*.py"))
    code = "; ".join([f"import {m}" for m in modules] + ["import chip_smoke", "import sys", (
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pythonic_disort_tpu'))"),
        "print(len(bad), bad)"])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
    assert {"pythonic_disort_torch.subroutines", "pythonic_disort_torch.ops.planck", "pythonic_disort_torch.parallel.mesh",
            "pythonic_disort_torch.tools.mesh_worker"} <= set(modules)


def test_interpolate_dispatches_on_the_closures_signature(solved):
    (_, _, _, u0, u), _ = solved
    assert "phi" in inspect.signature(u).parameters
    assert "phi" not in inspect.signature(u0).parameters
