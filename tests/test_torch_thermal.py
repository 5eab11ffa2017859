"""The port's Planck routes held against the JAX package (CPU, float64).

``pythonic_disort_torch.ops.planck`` (the device route: ``planck``,
``band_integrated_emission``, ``s_poly_coeffs_from_temper``) against
``pythonic_disort_tpu.ops.planck`` to roundoff and against the host route
(``utils.thermal``, scipy's adaptive quadrature) to the quadrature's
accuracy; the temperature-driven longwave pipeline through the port's
``solve_fluxes`` against JAX's on the same kind of inputs, against the
port's ``pydisort`` fed host-route sources, and its gradient with respect
to the temperatures against ``jax.grad``.  The atmosphere is
``tests/test_thermal_device.py``'s, cut to 8 layers.
"""

import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu.ops import planck as jplanck
from pythonic_disort_tpu.parallel import make_batched_problem as jax_make_batched_problem
from pythonic_disort_tpu.parallel import solve_fluxes as jax_solve_fluxes

import pythonic_disort_torch as pt
from pythonic_disort_torch.ops import planck as tplanck
from pythonic_disort_torch.utils import thermal as tthermal

L, NQ = 8, 16
BANDS = [(200.0, 600.0), (600.0, 1200.0), (1200.0, 2500.0)]  # cm^-1
F64 = dict(dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _atmosphere():
    """``test_thermal_device._atmosphere`` (seed 3) at L = 8 layers."""
    rng = np.random.default_rng(3)
    thickness = rng.uniform(0.02, 0.25, (len(BANDS), L))
    tau = np.cumsum(thickness, axis=1)
    omega = rng.uniform(0.05, 0.3, (len(BANDS), L))
    temper = np.linspace(300.0, 220.0, L + 1)
    leg = np.zeros((len(BANDS), L, 2))
    leg[..., 0] = 1.0
    leg[..., 1] = 0.05
    return tau, omega, temper, leg


def _config(jax_side):
    cls = pdt.DisortConfig if jax_side else pt.DisortConfig
    return cls(nquad=NQ, nleg=2, nleg_all=2, nfourier=1, nlayers=L, nscoeffs=2, nbdrf=0, has_beam=False,
               only_flux=True, has_deltam=False)


def test_planck_pointwise():
    """``tests/test_ops.py::test_planck_pointwise_matches_host``'s case, a
    level at T = 0 among them."""
    T = np.array([0.0, 150.0, 300.0])
    out = tplanck.planck(torch.tensor(T), 50000.0)
    assert out.dtype == torch.float64 and out[0].item() == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(jplanck.planck(jnp.asarray(T), 50000.0)), rtol=1e-12)
    np.testing.assert_allclose(out.numpy(), tthermal.planck(T, 50000.0), rtol=1e-12)
    # numpy in, device="cpu": the same numbers
    np.testing.assert_array_equal(tplanck.planck(T, 50000.0, device="cpu").numpy(), out.numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 50000.0), (300.0, 800.0), (2702.99, 2703.01), (999.0, 1000.0)])
def test_band_integrated_emission(lo, hi):
    """``tests/test_ops.py::test_planck_band_integration_vs_adaptive``'s
    bands: the JAX device route to roundoff, the host route (adaptive
    quadrature) at the bound of the source coefficients below."""
    T = np.array([100.0, 200.0, 300.0, 320.0])
    out = tplanck.band_integrated_emission(torch.tensor(T), lo, hi).numpy()
    np.testing.assert_allclose(out, np.asarray(jplanck.band_integrated_emission(jnp.asarray(T), lo, hi)),
                               rtol=1e-12)
    np.testing.assert_allclose(out, tthermal.blackbody_contrib_to_BCs(T, max(lo, 1e-9), hi), rtol=5e-7)


def test_band_integrated_emission_shapes():
    T = torch.full((2, 3), 250.0, **F64)
    assert tplanck.band_integrated_emission(T, 100.0, 900.0).shape == (2, 3)
    assert torch.equal(tplanck.band_integrated_emission(T, 900.0, 100.0), torch.zeros(2, 3, **F64))
    # float32 in, float32 out
    assert tplanck.band_integrated_emission(T.float(), 100.0, 900.0).dtype == torch.float32


def test_s_poly_coeffs_from_temper():
    """Per band, against the JAX device route to roundoff and against the
    host route at ``tests/test_thermal_device.py``'s bound."""
    tau, _, temper, _ = _atmosphere()
    for b, (lo, hi) in enumerate(BANDS):
        out = tplanck.s_poly_coeffs_from_temper(torch.tensor(tau[b]), torch.tensor(temper), lo, hi).numpy()
        assert out.shape == (L, 2)
        ref = np.asarray(jplanck.s_poly_coeffs_from_temper(jnp.asarray(tau[b]), jnp.asarray(temper), lo, hi))
        np.testing.assert_allclose(out, ref, rtol=1e-12)
        np.testing.assert_allclose(out, tthermal.generate_s_poly_coeffs(tau[b], temper, lo, hi), rtol=5e-7)
    # batched over leading axes: (bands, L) depths against one profile per band
    temper3 = np.stack([temper, temper + 5.0, temper - 5.0])
    lo, hi = BANDS[1]
    out = tplanck.s_poly_coeffs_from_temper(tau, temper3, lo, hi, device="cpu").numpy()
    ref = np.asarray(jplanck.s_poly_coeffs_from_temper(jnp.asarray(tau), jnp.asarray(temper3), lo, hi))
    assert out.shape == (len(BANDS), L, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-12)


def _port_route(tau, omega, temper, leg, tau_eval):
    """Temperatures -> per-band sources and surface emission -> fluxes,
    on the port (``temper`` a tensor, which may require a gradient)."""
    nb = len(BANDS)
    s_poly = torch.stack([tplanck.s_poly_coeffs_from_temper(tau[b], temper, lo, hi)
                          for b, (lo, hi) in enumerate(BANDS)])
    surface = torch.stack([tplanck.band_integrated_emission(temper[-1], lo, hi) for lo, hi in BANDS])
    b_pos = surface[:, None, None].expand(nb, NQ // 2, 1)
    prob = pt.make_batched_problem(_config(False), tau, omega, leg, np.zeros(nb), np.zeros(nb), b_pos=b_pos,
                                   s_poly_coeffs=s_poly, device="cpu", **F64)
    return pt.solve_fluxes(prob, tau_eval)


def _jax_route(tau, omega, temper, leg, tau_eval):
    nb = len(BANDS)
    s_poly = jnp.stack([jplanck.s_poly_coeffs_from_temper(tau[b], temper, lo, hi)
                        for b, (lo, hi) in enumerate(BANDS)])
    surface = jnp.stack([jplanck.band_integrated_emission(temper[-1], lo, hi) for lo, hi in BANDS])
    b_pos = jnp.broadcast_to(surface[:, None, None], (nb, NQ // 2, 1))
    prob = jax_make_batched_problem(_config(True), tau, jnp.asarray(omega), jnp.asarray(leg), np.zeros(nb),
                                    np.zeros(nb), b_pos=b_pos, s_poly_coeffs=s_poly, dtype=jnp.float64)
    return jax_solve_fluxes(prob, tau_eval)


@pytest.fixture(scope="module")
def atmosphere():
    tau, omega, temper, leg = _atmosphere()
    return tau, omega, temper, leg, tau * (1 - 1e-9)


def test_device_thermal_pipeline_matches_jax(atmosphere):
    tau, omega, temper, leg, tau_eval = atmosphere
    out = _port_route(torch.tensor(tau), omega, torch.tensor(temper), leg, torch.tensor(tau_eval))
    ref = jax.jit(lambda t, T: _jax_route(t, omega, T, leg, jnp.asarray(tau_eval)))(
        jnp.asarray(tau), jnp.asarray(temper))
    for lbl, o, r in zip(("flux_up", "flux_down", "flux_direct"), out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert np.isfinite(o).all(), lbl
        np.testing.assert_allclose(o, r, rtol=1e-10, atol=1e-12 * np.abs(r).max(), err_msg=lbl)
    assert np.abs(out[0].numpy()).min() > 0 and np.abs(out[2].numpy()).max() == 0


def test_device_thermal_pipeline_matches_single_column_api(atmosphere):
    """The batched device-Planck route against the port's ``pydisort`` fed
    host-route sources (``tests/test_thermal_device.py:107-137``)."""
    tau, omega, temper, leg, tau_eval = atmosphere
    fup = _port_route(torch.tensor(tau), omega, torch.tensor(temper), leg, torch.tensor(tau_eval))[0].numpy()
    for b, (lo, hi) in enumerate(BANDS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = pt.pydisort(tau[b], omega[b], NQ, leg[b], 0, 0, 0, NLeg=2, NFourier=1, only_flux=True,
                              s_poly_coeffs=tthermal.generate_s_poly_coeffs(tau[b], temper, lo, hi),
                              b_pos=tthermal.blackbody_contrib_to_BCs(temper[-1], lo, hi), device="cpu")
        np.testing.assert_allclose(fup[b], out[1](tau_eval[b]), rtol=2e-6, err_msg=f"band {b}")


def test_flux_gradient_wrt_temperature_matches_jax(atmosphere):
    tau, omega, temper, leg, tau_eval = atmosphere
    T = torch.tensor(temper, requires_grad=True)
    _port_route(torch.tensor(tau), omega, T, leg, torch.tensor(tau_eval))[0].sum().backward()
    loss = lambda T: jnp.sum(_jax_route(jnp.asarray(tau), omega, T, leg, jnp.asarray(tau_eval))[0])
    ref = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(temper)))
    g = T.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).min() > 0
    np.testing.assert_allclose(g, ref, rtol=1e-8, atol=1e-12 * np.abs(ref).max())


def test_zero_temperature_level_gives_zero_emission_and_a_finite_gradient(atmosphere):
    """A level at T = 0 (an emission-free top): the source there is zero and
    the gradient of the fluxes with respect to every level stays finite
    (the unselected branch of ``planck``'s ``torch.where`` holds no NaN)."""
    tau, omega, temper, leg, tau_eval = atmosphere
    temper0 = temper.copy()
    temper0[0] = 0.0
    T = torch.tensor(temper0, requires_grad=True)
    lo, hi = BANDS[0]
    emission = tplanck.band_integrated_emission(T, lo, hi)
    assert emission[0].item() == 0.0 and (emission[1:] > 0).all()
    emission.sum().backward()
    assert torch.isfinite(T.grad).all() and T.grad[0].item() == 0.0
    T.grad = None
    fup = _port_route(torch.tensor(tau), omega, T, leg, torch.tensor(tau_eval))[0]
    assert torch.isfinite(fup).all()
    fup.sum().backward()
    assert torch.isfinite(T.grad).all()


def test_gradient_wrt_optical_depth_is_finite(atmosphere):
    """``s_poly_coeffs_from_temper`` is differentiable in ``tau_arr`` too."""
    tau, _, temper, _, _ = atmosphere
    t = torch.tensor(tau[0], requires_grad=True)
    lo, hi = BANDS[0]
    tplanck.s_poly_coeffs_from_temper(t, torch.tensor(temper), lo, hi).sum().backward()
    jg = jax.grad(lambda t: jnp.sum(jplanck.s_poly_coeffs_from_temper(t, jnp.asarray(temper), lo, hi)))(
        jnp.asarray(tau[0]))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-10)


def test_numpy_inputs_default_to_cuda():
    """Without a tensor argument and without ``device="cpu"`` the device
    route asks for the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplanck.band_integrated_emission(np.array([250.0]), 100.0, 900.0)


# (lo, hi): hi * 1e-4 < lo, so the geometric panels start at lo; lo = 0;
# hi * 1e-4 > lo, so a first panel [lo, hi * 1e-4] comes before them
RULE_BANDS = [(200.0, 600.0), (0.0, 50000.0), (0.01, 3250.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lo,hi", RULE_BANDS)
def test_cached_rule_gives_the_fresh_rules_outputs_bit_for_bit(lo, hi, dtype):
    """With the rule cache cleared and then warm, the band integral and the
    source polynomials equal, bit for bit, those of a rule built afresh
    for the call (what the route computed before it kept its rules); the
    cached nodes and weights are `_panel_rule`'s cast to the dtype; in
    float64 the warm outputs stay at the JAX route's roundoff."""
    tau, _, temper, _ = _atmosphere()
    T, t = torch.tensor(temper, dtype=dtype), torch.tensor(tau[0], dtype=dtype)
    nodes, weights = (torch.as_tensor(x, dtype=dtype) for x in tplanck._panel_rule(lo, hi, 32, 8))
    fresh = torch.sum(tplanck.planck(T[..., None], nodes) * weights, dim=-1)
    tplanck._RULES.clear()
    cold = tplanck.band_integrated_emission(T, lo, hi), tplanck.s_poly_coeffs_from_temper(t, T, lo, hi)
    assert list(tplanck._RULES) == [(lo, hi, 32, 8, dtype, T.device)]
    warm = tplanck.band_integrated_emission(T, lo, hi), tplanck.s_poly_coeffs_from_temper(t, T, lo, hi)
    assert len(tplanck._RULES) == 1
    cached = tplanck._RULES[(lo, hi, 32, 8, dtype, T.device)]
    assert torch.equal(cached[0], nodes) and torch.equal(cached[1], weights)
    assert cached[0].dtype == cached[1].dtype == dtype
    assert torch.equal(cold[0], fresh) and torch.equal(warm[0], fresh)
    assert torch.equal(cold[1], warm[1])
    if dtype == torch.float64:
        np.testing.assert_allclose(warm[0].numpy(), np.asarray(jplanck.band_integrated_emission(
            jnp.asarray(temper), lo, hi)), rtol=1e-12)
        np.testing.assert_allclose(warm[1].numpy(), np.asarray(jplanck.s_poly_coeffs_from_temper(
            jnp.asarray(tau[0]), jnp.asarray(temper), lo, hi)), rtol=1e-12)


def test_a_rule_built_in_inference_mode_serves_autograd():
    """A rule first built under ``torch.inference_mode`` is no inference
    tensor: d emission / d T through it, outside that mode, neither raises
    nor differs from the gradient through a rule built outside it."""
    lo, hi = BANDS[0]
    temper = _atmosphere()[2]
    tplanck._RULES.clear()
    with torch.inference_mode():
        first = tplanck.band_integrated_emission(torch.tensor(temper), lo, hi)
    assert first.is_inference()
    assert not any(x.is_inference() or x.requires_grad for x in tplanck._RULES[(lo, hi, 32, 8, torch.float64,
                                                                                  torch.device("cpu"))])

    def grad():
        T = torch.tensor(temper, requires_grad=True)
        return torch.autograd.grad(tplanck.band_integrated_emission(T, lo, hi).sum(), T)[0]

    cached = grad()
    tplanck._RULES.clear()
    assert torch.equal(cached, grad())


def test_rule_cache_keys_and_bound(monkeypatch):
    """Another dtype, edge or order is another entry; the cache holds at
    most ``_RULES_MAX`` rules, dropping the oldest, also with eight threads
    filling it at once."""
    T = torch.tensor([250.0, 280.0], **F64)
    tplanck._RULES.clear()
    for args in [(T, 100.0, 900.0), (T.float(), 100.0, 900.0), (T, 100.0, 901.0), (T, 100.0, 900.0, 16),
                 (T, 100.0, 900.0)]:
        tplanck.band_integrated_emission(*args)
    cpu = torch.device("cpu")
    assert list(tplanck._RULES) == [(100.0, 900.0, 32, 8, torch.float64, cpu), (100.0, 900.0, 32, 8, torch.float32, cpu),
                                    (100.0, 901.0, 32, 8, torch.float64, cpu), (100.0, 900.0, 16, 8, torch.float64, cpu)]
    monkeypatch.setattr(tplanck, "_RULES_MAX", 6)
    for k in range(10):
        tplanck.band_integrated_emission(T, 100.0, 200.0 + k, 4)
    assert list(tplanck._RULES) == [(100.0, 200.0 + k, 4, 8, torch.float64, cpu) for k in range(4, 10)]

    want = {k: tplanck.band_integrated_emission(T, 100.0, 300.0 + k, 4) for k in range(20)}
    errors = []

    def work(i):
        try:
            for k in [(i + j) % 20 for j in range(60)]:
                if not torch.equal(tplanck.band_integrated_emission(T, 100.0, 300.0 + k, 4), want[k]):
                    errors.append(k)
        except Exception as e:          # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(tplanck._RULES) <= 6
