"""The port's ``build_problem`` and ``pydisort`` held against the JAX
package (CPU, float64).

Problems are compared field by field; every validation message and
warning of ``pythonic_disort_tpu/models/disort/api.py`` is raised by both
packages from the same arguments and compared letter for letter; the
closures' return shapes and flags and their values are compared on a
handful of small configurations (each distinct one costs a JAX compile).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu.models.disort.api import build_problem as jax_build_problem

import pythonic_disort_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def hg(g, n, layers=None):
    leg = g ** np.arange(n)
    return leg if layers is None else np.tile(leg, (layers, 1))


LAMBERT = [lambda mu, neg_mup: np.full((len(mu), len(neg_mup)), 0.3)]
TAU3 = np.array([0.5, 1.5, 3.0])
OMEGA3 = np.array([0.9, 0.85, 0.8])

# small pydisort configurations, one JAX compile each
CONFIGS = {
    "beam_nt": dict(tau_arr=TAU3, omega_arr=OMEGA3, NQuad=8, Leg_coeffs_all=hg(0.75, 16, 3), mu0=0.6,
                    I0=np.pi, phi0=np.pi / 2, f_arr=hg(0.75, 16, 3)[:, 8], NT_cor=True),
    "iso": dict(tau_arr=np.array([1.0, 2.5]), omega_arr=np.array([0.3, 0.6]), NQuad=8,
                Leg_coeffs_all=hg(0.5, 9, 2), mu0=0, I0=0, phi0=0, b_neg=0.2, b_pos=np.linspace(0.1, 0.4, 4),
                s_poly_coeffs=np.array([[0.5, 0.2, 0.1], [0.9, -0.1, 0.05]])),
    "bdrf": dict(tau_arr=0.8, omega_arr=0.7, NQuad=8, Leg_coeffs_all=hg(0.6, 9), mu0=0.5, I0=2.0, phi0=1.0,
                 BDRF_Fourier_modes=LAMBERT),
    "layers_flux": dict(tau_arr=np.array([0.2, 0.9, 1.4, 4.0]), omega_arr=np.array([0.95, 0.5, 0.2, 0.8]),
                        NQuad=4, Leg_coeffs_all=np.stack([hg(g, 5) for g in (0.1, 0.4, 0.7, 0.8)]), mu0=0.9,
                        I0=1.0, phi0=0.0, f_arr=np.array([0.0001, 0.0256, 0.2401, 0.4096]), only_flux=True),
}


@pytest.fixture(scope="module")
def solved():
    """Both packages' ``pydisort`` returns for every configuration."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {k: (pdt.pydisort(**kw), pt.pydisort(**kw, device="cpu")) for k, kw in CONFIGS.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_problem_matches_jax_field_by_field(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg, jprob = jax_build_problem(**CONFIGS[name])
        cfg, prob = pt.build_problem(**CONFIGS[name], device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for f in dataclasses.fields(jprob):
        if f.name == "config":
            continue
        ref, out = getattr(jprob, f.name), getattr(prob, f.name)
        if ref is None:
            assert out is None, f.name
            continue
        assert out.dtype == torch.float64 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=f.name)


def test_build_problem_dtype_and_device():
    _, prob = pt.build_problem(**CONFIGS["bdrf"], dtype=torch.float32, device="cpu")
    assert prob.tau_arr.dtype == torch.float32 and prob.bdrf_modes.shape == (1, 4, 4)


BASE = dict(tau_arr=1.0, omega_arr=0.5, NQuad=16, Leg_coeffs_all=hg(0.0, 17) + 0.0, mu0=0.5, I0=1.0, phi0=0.0)
TWO = dict(BASE, tau_arr=np.array([1.0, 2.0]), omega_arr=np.array([0.5, 0.5]), Leg_coeffs_all=hg(0.0, 17, 2))

# one case per message of api.py:89-205 (and :264-280 for the boundary shapes)
MESSAGES = {
    "tau_nonpositive": dict(BASE, tau_arr=-1.0),
    "thickness_nonpositive": dict(TWO, tau_arr=np.array([1.0, 0.5])),
    "omega_range": dict(BASE, omega_arr=1.0),
    "nleg_positive": dict(BASE, NLeg=0),
    "nleg_exceeds_given": dict(BASE, NLeg=20),
    "leg_rows": dict(TWO, Leg_coeffs_all=hg(0.0, 17, 1)),
    "omega_rows": dict(TWO, omega_arr=np.array([0.5])),
    "f_arr_length": dict(TWO, f_arr=np.array([0.1, 0.1, 0.1])),
    "s_poly_rows": dict(TWO, s_poly_coeffs=np.array([[1.0, 2.0]])),
    "leg_zeroth_corrected": dict(BASE, Leg_coeffs_all=np.concatenate([[0.9], np.zeros(16)])),
    "leg_range": dict(BASE, Leg_coeffs_all=np.concatenate([[1.0, 1.0], np.zeros(15)])),
    "two_streams": dict(BASE, NQuad=0, NLeg=1, NFourier=1),
    "even_streams": dict(BASE, NQuad=5, NLeg=4, NFourier=4),
    "nfourier_positive": dict(BASE, NFourier=0),
    "nfourier_exceeds_nleg": dict(BASE, NLeg=4, NFourier=5),
    "nfourier_large": dict(BASE, NQuad=66, NLeg=66, NFourier=66, Leg_coeffs_all=hg(0.0, 67) + 0.0),
    "nleg_exceeds_nquad": dict(BASE, NLeg=17, NFourier=16),
    "i0_negative": dict(BASE, I0=-1.0),
    "mu0_range": dict(BASE, mu0=1.5),
    "phi0_range": dict(BASE, phi0=7.0),
    "b_pos_shape": dict(BASE, b_pos=np.ones(3)),
    "b_neg_shape": dict(BASE, b_neg=np.ones((8, 3))),
    "f_arr_range": dict(BASE, f_arr=1.5),
    "nscoeffs_large": dict(BASE, s_poly_coeffs=np.full((1, 11), 0.1)),
    "nt_mu0_on_a_node": dict(BASE, mu0=float(pt.ops.quadrature.double_gauss(16)[0][3]), Leg_coeffs_all=hg(0.5, 32),
                             f_arr=0.5 ** 16, NT_cor=True),
    "scaled_omega_near_one": dict(BASE, omega_arr=1 - 1e-7),
    "scaled_leg_near_one": dict(BASE, Leg_coeffs_all=np.concatenate([[1.0, 0.97], np.zeros(15)])),
}


def outcome(build, kwargs):
    """What `build_problem` does with the arguments: the error it raises, or the
    warnings it gives, as text."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            build(**{k: np.copy(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()})
        except ValueError as e:
            return ("ValueError", str(e))
    return ("warnings", tuple(str(w.message) for w in caught))


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_validation_message_matches_jax(name):
    ref = outcome(jax_build_problem, MESSAGES[name])
    out = outcome(lambda **kw: pt.build_problem(**kw, device="cpu"), MESSAGES[name])
    assert ref[1], f"{name}: the arguments trigger no message in the JAX package"
    assert out == ref


def test_every_message_of_the_reference_is_covered():
    """22 errors and 5 warnings in ``api.py:89-205, 264-280``: each case
    above triggers a different one."""
    texts = [outcome(jax_build_problem, kw) for kw in MESSAGES.values()]
    assert sum(kind == "ValueError" for kind, _ in texts) == 22
    assert len({t if isinstance(t, str) else t[0] for _, t in texts}) == len(MESSAGES) == 27


def test_pydisort_argument_messages_match_jax(solved):
    for fn in (pdt.pydisort, lambda **kw: pt.pydisort(**kw, device="cpu")):
        with pytest.raises(ValueError, match="The minimum threshold `use_banded_solver_NLayers` is 3, "
                                             "else the matrix will not be banded."):
            fn(**BASE, use_banded_solver_NLayers=2)
    message = r"tau input outside the tau range specified for the atmosphere \(check `tau_arr`\)\."
    for outputs in solved["beam_nt"]:
        for call in (lambda: outputs[1](3.5), lambda: outputs[2](-0.1), lambda: outputs[3]([0.1, 4.0]),
                     lambda: outputs[4](3.5, 0.0)):
            with pytest.raises(ValueError, match=message):
                call()


def test_device_default_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.pydisort(**CONFIGS["bdrf"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.build_problem(**CONFIGS["bdrf"])


def same(ref, out, label):
    """Same arity, shapes and values: f64 on both sides, rtol 1e-8, and
    1e-11 of the output's size (at least 1) for values that cancel to zero,
    as the upward flux does at a black surface."""
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref), label
    for a, b in zip(ref, out):
        a, b = np.asarray(a), np.asarray(b)
        assert b.shape == a.shape, f"{label}: shape {b.shape} against {a.shape}"
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-11 * max(np.abs(a).max(), 1.0), err_msg=label)


TAU = np.array([0.25, 1.0, 2.5])
PHI = np.array([0.0, 2.0])


@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("ferr", [False, True])
@pytest.mark.parametrize("tau_arr_flag", [False, True])
def test_corrected_u_flag_matrix(solved, anti, ferr, tau_arr_flag):
    ref, out = solved["beam_nt"]
    flags = dict(is_antiderivative_wrt_tau=anti, return_Fourier_error=ferr, return_tau_arr=tau_arr_flag)
    r, o = ref[4](TAU, PHI, **flags), out[4](TAU, PHI, **flags)
    same(r[0] if (ferr or tau_arr_flag) else r, o[0] if (ferr or tau_arr_flag) else o, f"u {flags}")
    if ferr:
        assert isinstance(o[1], float) and o[1] == pytest.approx(r[1], rel=1e-6)
    if tau_arr_flag:
        np.testing.assert_array_equal(o[-1], r[-1])
    assert (len(o) if isinstance(o, tuple) else 1) == 1 + ferr + tau_arr_flag


@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("tau_arr_flag", [False, True])
def test_u0_flux_flag_matrix(solved, anti, tau_arr_flag):
    ref, out = solved["beam_nt"]
    flags = dict(is_antiderivative_wrt_tau=anti, return_tau_arr=tau_arr_flag)
    for idx, label in ((1, "flux_up"), (2, "flux_down"), (3, "u0")):
        same(ref[idx](TAU, **flags), out[idx](TAU, **flags), f"{label} {flags}")
    same(ref[3](TAU, _return_act_dscale_for_reclass=True, **flags),
         out[3](TAU, _return_act_dscale_for_reclass=True, **flags), f"u0 with the reclassification term {flags}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pydisort_matches_jax(solved, name):
    ref, out = solved[name]
    assert len(out) == len(ref) == (4 if CONFIGS[name].get("only_flux") else 5)
    np.testing.assert_array_equal(out[0], ref[0])
    top = float(np.atleast_1d(CONFIGS[name]["tau_arr"])[-1])
    for tau in (np.linspace(0.0, top, 5), 0.3 * top, [top]):
        same(ref[1](tau), out[1](tau), f"{name} flux_up")
        same(ref[2](tau), out[2](tau), f"{name} flux_down")
        same(ref[3](tau), out[3](tau), f"{name} u0")
        if len(ref) == 5:
            same(ref[4](tau, PHI), out[4](tau, PHI), f"{name} u")
            same(ref[4](tau, 1.3), out[4](tau, 1.3), f"{name} u at one phi")


def test_closures_take_tensors(solved):
    _, out = solved["bdrf"]
    t64 = lambda x: torch.tensor(x, dtype=torch.float64)
    np.testing.assert_array_equal(out[1](t64([0.1, 0.5])), out[1](np.array([0.1, 0.5])))
    np.testing.assert_array_equal(out[4](t64(0.4), t64([0.0, 1.0])), out[4](0.4, [0.0, 1.0]))
