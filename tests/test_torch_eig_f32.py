"""The plain eigen stage in float32 near omega = 1 (CPU).

``cuda_eig.eig_stage_lanes_plain`` is the CPU route of kernel 1 and the
oracle ``chip_smoke.py`` holds the kernel against.  It diagonalizes
M = L^T (-At) L by Jacobi, as the kernel and the JAX package's CPU route
(``_eig_stage_lanes_jnp``) do: Jacobi keeps the relative digits of the
small eigenvalue K^2 that omega = 1 - 1e-6 gives, where LAPACK's ``eigh``
in float32 is accurate only to about eps ||M||.

- Goldens 4a and 5a (omega = 1 - 1e-6) through the port's ``pydisort`` in
  float32 on the CPU, at the reference thresholds of
  ``tests/test_torch_stamnes.py`` and within 1e-3 of the golden flux_up;
- the plain stage's smallest K per lane in float32 against float64 at
  golden 4a's operands, and the float64 stage against the JAX package's
  at the same operands.

`lapack_stage` is the stage with LAPACK's ``eigh`` in place of Jacobi: the
independent eigensolver other port tests compare the Jacobi route with.
"""

from math import pi

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pythonic_disort_tpu.ops.eig import _eig_stage_lanes_jnp

import pythonic_disort_torch as pt
from pythonic_disort_torch.ops import cuda_eig, eig
from pythonic_disort_torch.utils.compare import compare
from helpers import load_golden
from test_stamnes import CASES


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def lapack_stage(At: torch.Tensor, Bt: torch.Tensor):
    """The eigen stage on (n, n, B) lanes operands with LAPACK's ``eigh``:
    ``(K (n, B), V, Yr, Pr, Qr (n, n, B))``, K ascending."""
    A, Bm = At.permute(2, 0, 1), Bt.permute(2, 0, 1)
    L = torch.linalg.cholesky(-Bm)
    K2, Z = torch.linalg.eigh(L.mT @ (-A) @ L)
    K = torch.sqrt(torch.clamp(K2, min=torch.finfo(At.dtype).tiny))
    V = torch.linalg.solve_triangular(L.mT, Z, upper=True)
    LZ = L @ Z
    lanes = lambda x: x.permute(1, 2, 0).contiguous()
    return (K.T.contiguous(), lanes(V), lanes(-LZ / K[:, None, :]), lanes(LZ.mT),
            lanes(-K[:, :, None] * V.mT))


def kwargs_of(name):
    case = CASES[name]() if callable(CASES[name]) else CASES[name]
    return case, case["kwargs"]


@pytest.mark.parametrize("name", ["4a", "5a"])
def test_golden_near_conservative_in_float32(name):
    case, kw = kwargs_of(name)
    assert np.all(np.asarray(kw["omega_arr"]) == 1 - 1e-6)
    outputs = pt.pydisort(**kw, device="cpu", dtype=torch.float32)
    mu_arr, flux_up, flux_down = outputs[:3]
    u = outputs[4] if case.get("intensity", True) and len(outputs) > 4 else None
    golden = load_golden(name)
    reorder = np.argsort(mu_arr)
    away = np.abs(np.arccos(np.abs(mu_arr[reorder])) - np.arccos(kw["mu0"])) * 180 / pi
    out = compare(golden, away > case.get("deg_around_beam", 0), reorder, flux_up, flux_down, u, verbose=False)
    dfu, rfu, dfdd, rfdd, dfdr, rfdr = out[:6]
    assert np.max(rfu[dfu > 1e-3], initial=0) < 1e-3, "flux_up mismatch"
    assert np.max(rfdd[dfdd > 1e-3], initial=0) < 1e-3, "flux_down diffuse mismatch"
    assert np.max(rfdr[dfdr > 1e-3], initial=0) < 1e-3, "flux_down direct mismatch"
    if u is not None:
        diff, ratio = out[6], out[7]
        assert np.max(ratio[diff > 1e-3], initial=0) < 1e-2, "intensity mismatch"
    # the plain stage on LAPACK's eigh read 9.3e-3 (4a) and 1.6e-2 (5a);
    # Jacobi 2.5e-5 and 4.0e-5
    assert np.abs(flux_up(golden["tau_test_arr"]) - golden["flup"]).max() < 1e-3


@pytest.fixture(scope="module")
def operands_4a():
    """Golden 4a's eigen-stage operands (At, Bt) (16, 16, 32), float64, as
    the single-column solve hands them to the stage."""
    _, kw = kwargs_of("4a")
    seen = []
    stage = eig.eig_stage_lanes

    def record(At, Bt):
        seen.append((At.clone(), Bt.clone()))
        return stage(At, Bt)

    eig.eig_stage_lanes = record
    try:
        pt.pydisort(**kw, device="cpu")
    finally:
        eig.eig_stage_lanes = stage
    return seen[0]


def test_plain_stage_smallest_k_in_float32(operands_4a):
    """The smallest K of every lane (7.7e-4 in the lanes of Fourier mode 0
    at omega = 1 - 1e-6) in float32 against float64, relative: Jacobi reads
    9.9e-4, LAPACK's eigh 2.0e-2 (`lapack_stage`), so the bound 5e-3 tells
    them apart."""
    At, Bt = operands_4a
    k64 = cuda_eig.eig_stage_lanes_plain(At, Bt)[0].min(dim=0).values
    assert k64.min() < 1e-3
    k32 = cuda_eig.eig_stage_lanes_plain(At.float(), Bt.float())[0].double().min(dim=0).values
    assert ((k32 - k64).abs() / k64).max() < 5e-3
    k_lapack = lapack_stage(At.float(), Bt.float())[0].double().min(dim=0).values
    assert ((k_lapack - k64).abs() / k64).max() > 5e-3


def test_plain_stage_float64_matches_jax(operands_4a):
    """Sorted K and the order-free relations of the raw outputs against the
    JAX package's CPU stage on golden 4a's operands, float64."""
    At, Bt = operands_4a
    K, V, Yr, Pr, Qr = cuda_eig.eig_stage_lanes_plain(At, Bt)
    ref = [np.asarray(x) for x in _eig_stage_lanes_jnp(jnp.asarray(At.numpy()), jnp.asarray(Bt.numpy()))]
    np.testing.assert_allclose(np.sort(K.numpy(), axis=0), np.sort(ref[0], axis=0), rtol=1e-10, atol=0)
    eye = torch.eye(At.shape[0], dtype=torch.float64)[:, :, None]
    mm = lambda a, b: torch.einsum("ijb,jkb->ikb", a, b)
    assert (mm(Pr, V) - eye).abs().max() < 1e-9
    assert (mm(Qr, Yr) - eye).abs().max() < 1e-9
