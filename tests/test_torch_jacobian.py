"""TOA radiance Jacobians on the port's reverse mode (CPU, float64), at a
small size of the ``cloud_jacobian`` cell: NQuad 8, 4 layers, 24 Legendre
moments, delta-M, NT corrections, u at tau = 0 on the general path and
its gradients with respect to the layer bottoms ``tau_arr`` and the
albedos ``omega_arr``, a few seeded rows.

- The port against the plain PyTorch reference (``reference/disort_plain.py``),
  values and gradients.
- The plain reference against the benchmark's NumPy reference
  (``benchmark/yardstick/reference.py``), and its autograd gradient
  against central differences of that NumPy reference.
- The port against ``jax.grad`` of the JAX package on the general path at
  tau = 0 with ``tau_arr`` a leaf.
- The boundary-value solve's slim backward (`cuda_blocktri.transposed_bvp_blocks`,
  `cuda_blocktri.bvp_cotangents`) against the formula it replaced:
  autograd through the assembled blocks of ``blocktri.assemble_bvp_blocks``.
"""

import importlib.util
from math import pi
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar

import pythonic_disort_torch as pt
from pythonic_disort_torch.ops import blocktri, cuda_blocktri

ROOT = Path(__file__).resolve().parents[1]
R, L, NQ, NLEG_ALL = 3, 4, 8, 24
N = NQ // 2
PHI = [0.0, 1.6, 3.1, 4.7]
f64 = torch.float64


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


plain = _load("reference/disort_plain.py", "jacobian_test_plain")
np_ref = _load("benchmark/yardstick/reference.py", "jacobian_test_np_reference")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rows(seed):
    """Seeded rows with a cloud-like deck in layers 1-2: thickness, albedo,
    Henyey-Greenstein moments g^l, delta-M f = chi_NQ, the beam."""
    rng = np.random.default_rng(seed)
    thick = rng.uniform(0.05, 0.5, (R, L))
    thick[:, 1:3] = rng.uniform(1.0, 6.0, (R, 2))
    omega = rng.uniform(0.3, 0.99, (R, L))
    omega[:, 1:3] = rng.uniform(0.9, 0.999, (R, 2))
    g = rng.uniform(0.5, 0.85, (R, L))
    leg = g[..., None] ** np.arange(NLEG_ALL)
    return dict(tau=np.cumsum(thick, 1), omega=omega, leg=leg, f=leg[..., NQ].copy(), mu0=rng.uniform(0.2, 1.0, R),
                I0=np.full(R, pi), phi0=rng.uniform(0.0, 2 * pi, R), v=rng.standard_normal((R, N, 1, len(PHI))))


def _config():
    return pt.DisortConfig(nquad=NQ, nleg=NQ, nleg_all=NLEG_ALL, nfourier=NQ, nlayers=L, nscoeffs=0, nbdrf=0,
                           has_beam=True, only_flux=False, nt_correct=True, has_deltam=True)


def port_step(a):
    """The cell's step on the CPU: u at tau = 0 over the upward streams and
    d sum(v u) / d (tau_arr, omega_arr), as numpy."""
    tau = torch.tensor(a["tau"]).requires_grad_()
    omega = torch.tensor(a["omega"]).requires_grad_()
    prob = pt.make_batched_problem(_config(), tau, omega, a["leg"], a["mu0"], a["I0"], phi0=a["phi0"], f_arr=a["f"],
                                   dtype=f64, device="cpu")
    u = pt.solve_intensity(prob, np.zeros((R, 1)), np.tile(PHI, (R, 1)))[:, :N]
    grads = torch.autograd.grad((torch.tensor(a["v"]) * u).sum(), (tau, omega))
    return (u.detach().numpy(), *(g.numpy() for g in grads))


def plain_step(a):
    T = torch.tensor
    tau, omega = T(a["tau"]).requires_grad_(), T(a["omega"]).requires_grad_()
    sol = plain.solve(tau, omega, T(a["leg"]), T(a["f"]), T(a["mu0"]), T(a["I0"]), T(a["phi0"]), NQ, NQ, NQ)
    u = plain.intensity(sol, torch.zeros((R, 1), dtype=f64), T(np.tile(PHI, (R, 1))), nt_correct=True)[:, :N]
    grads = torch.autograd.grad((T(a["v"]) * u).sum(), (tau, omega))
    return (u.detach().numpy(), *(g.numpy() for g in grads))


def np_loss(a, tau, omega):
    sol = np_ref.solve(tau, omega, a["leg"], a["f"], a["mu0"], a["I0"], a["phi0"], NQ, NQ, NQ)
    u = np_ref.intensity(sol, np.zeros((R, 1)), np.tile(PHI, (R, 1)), nt_correct=True)[:, :N]
    return u, float((a["v"] * u).sum())


def close(got, ref, rtol, label=""):
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, f"{label}: relative error {err:.3e} > {rtol:.0e}"


@pytest.mark.parametrize("seed", [1, 2])
def test_port_matches_the_plain_reference(seed):
    a = _rows(seed)
    for name, got, ref in zip(("u", "d/d tau", "d/d omega"), port_step(a), plain_step(a)):
        assert np.isfinite(got).all() and np.abs(ref).max() > 0, name
        close(got, ref, 1e-9, name)


def test_plain_reference_forward_matches_the_numpy_reference():
    a = _rows(3)
    u, _ = np_loss(a, a["tau"], a["omega"])
    close(plain_step(a)[0], u, 1e-11, "u")


@pytest.mark.parametrize("leaf", ["tau", "omega"])
def test_plain_reference_gradient_matches_central_differences(leaf):
    """Central differences of the NumPy reference's loss, step 1e-6 in one
    entry at a time (12 entries), against the plain reference's autograd."""
    a = _rows(4)
    g = plain_step(a)[1 if leaf == "tau" else 2]
    fd = np.zeros_like(a[leaf])
    eps = 1e-6
    for i in np.ndindex(fd.shape):
        step = np.zeros_like(fd)
        step[i] = eps
        at = lambda s: np_loss(a, *(dict(a, **{leaf: a[leaf] + s})[k] for k in ("tau", "omega")))[1]
        fd[i] = (at(step) - at(-step)) / (2 * eps)
    close(g, fd, 1e-6, leaf)


def test_port_matches_jax_on_the_general_path_at_the_top():
    """The case ``test_grad_through_batched_nt_corrected_intensity`` lacks:
    the general path at tau = 0, ``tau_arr`` and ``omega_arr`` both
    leaves, against ``jax.grad`` of the JAX package."""
    a = _rows(5)
    kwargs = dict(nquad=NQ, nleg=NQ, nleg_all=NLEG_ALL, nfourier=NQ, nlayers=L, nscoeffs=0, nbdrf=0, has_beam=True,
                  only_flux=False, has_deltam=True, nt_correct=True)

    def jloss(tau, omega):
        prob = jpar.make_batched_problem(pdt.DisortConfig(**kwargs), tau, omega, a["leg"], a["mu0"], a["I0"],
                                         phi0=a["phi0"], f_arr=a["f"], dtype=jnp.float64)
        u = jpar.solve_intensity(prob, jnp.zeros((R, 1)), jnp.asarray(np.tile(PHI, (R, 1))))
        return jnp.sum(jnp.asarray(a["v"]) * u[:, :N])

    refs = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a["tau"]), jnp.asarray(a["omega"]))
    for name, g, g_ref in zip(("d/d tau", "d/d omega"), port_step(a)[1:], refs):
        close(g, np.asarray(g_ref), 1e-8, name)


def _old_bvp_cotangents(Gt, decay_t, bt_rows, x, y):
    """The backward's pull-back before it was written in closed form:
    autograd through the assembled blocks."""
    inputs = tuple(t.detach().requires_grad_() for t in (Gt, decay_t, bt_rows))
    with torch.enable_grad():
        blocks = blocktri.assemble_bvp_blocks(*inputs)
    live = [(b, c) for b, c in zip(blocks, cuda_blocktri.block_cotangents(y, x)) if b.requires_grad]
    return torch.autograd.grad([b for b, _ in live], inputs, [c for _, c in live])


@pytest.mark.parametrize("L_,N_,B", [(1, 2, 3), (2, 3, 4), (9, 4, 5), (17, 2, 3)])
def test_slim_bvp_backward_matches_the_old_formula(L_, N_, B):
    """The transposed blocks bit for bit (the ignored edge blocks zero), and
    the operands' cotangents to 1e-12 of the old formula's, over more
    layers than a slab of the pull-back holds."""
    rng = np.random.default_rng(L_ + 10 * N_)
    n2 = 2 * N_
    T = lambda *s: torch.tensor(rng.standard_normal(s))
    Gt, bt_rows, x, y = T(L_, n2, n2, B), T(N_, n2, B), T(L_, n2, B), T(L_, n2, B)
    decay = torch.tensor(rng.uniform(0.05, 0.95, (L_, N_, B)))
    lower, diag, upper = cuda_blocktri.transposed_bvp_blocks(Gt, decay, bt_rows)
    old = cuda_blocktri.transposed_system(*blocktri.assemble_bvp_blocks(Gt, decay, bt_rows))
    for got, ref in zip((lower, diag, upper), old):
        assert torch.equal(got, ref)
    assert not lower[0].any() and not upper[-1].any()
    for i, (got, ref) in enumerate(zip(cuda_blocktri.bvp_cotangents(Gt, decay, y, x),
                                       _old_bvp_cotangents(Gt, decay, bt_rows, x, y))):
        close(got.numpy(), ref.numpy(), 1e-12, f"operand {i}")
