"""The Legendre series of ``ops/legendre.py`` in the row form the CUDA
kernel ``csrc/legendre_series.cu`` takes, held on the CPU.

The kernel reduces a call of `legendre_series_bcast` to R rows of
coefficients and Q points a row (`row_operands`) and runs the plain
loop's recurrence with the loop's roundings; `legendre_series_rows_plain`
is its function in plain PyTorch.  Here the reduction and the plain model
are held to the Clenshaw loop as it stood before the kernel (bit for bit)
and to the JAX package's ``legendre_series`` (float64, at the NT
correction's three calls in both radiance cells of the benchmark), and
the route is held to its rule: a call that takes a gradient or carries a
forward-mode tangent keeps the plain loop, and ``legendre_terms`` counts
alike on both routes.  The kernel itself runs only on the card
(``python3 -m pythonic_disort_torch.tools.check_legendre``).
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp

from pythonic_disort_tpu.ops import legendre as jleg
from pythonic_disort_torch.ops import legendre
from pythonic_disort_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def loop_before(coeffs, x):
    """The Clenshaw loop of ``legendre_series_bcast`` before the kernel."""
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    b1 = torch.zeros(shape, dtype=x.dtype, device=x.device)
    b2 = torch.zeros_like(b1)
    for ell in range(coeffs.shape[-1] - 1, -1, -1):
        alpha = (2.0 * ell + 1.0) / (ell + 1.0)
        beta = (ell + 1.0) / (ell + 2.0)
        b1, b2 = coeffs[..., ell] + alpha * x * b1 - beta * b2, b1
    return b1


def moments(batch, ndeg, seed, dtype=torch.float64):
    """Phase-function moments (2l + 1) w g^l, g in [0.5, 0.9], w in
    [0.5, 1], of shape ``batch + (ndeg,)``, and a sign flipped at random
    (series that cancel as well as add)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 0.9, batch + (1,))
    w = rng.uniform(0.5, 1.0, batch + (1,)) * rng.choice([-1.0, 1.0], batch + (1,))
    ell = np.arange(ndeg)
    return torch.as_tensor((2 * ell + 1) * w * g**ell, dtype=dtype)


def points(shape, seed, dtype=torch.float64):
    """Points in [-1, 1] with both ends among them."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).reshape(-1)
    x[:2] = (-1.0, 1.0)[: x.size]
    return torch.as_tensor(x.reshape(shape), dtype=dtype)


# The NT correction's three calls (models/disort/nt.py) in the benchmark's
# radiance cells: cell -> (S solves a chunk, L layers, N streams a
# hemisphere, azimuths, NLeg_all, NLeg)
CELLS = {"cloud_radiance": (112, 60, 24, 4, 300, 48), "sw_radiance": (448, 60, 16, 4, 33, 32)}


def nt_calls(cell, seed=0, dtype=torch.float64):
    """{call: (coeffs, x, (R, Q))} of the three series of one chunk of
    ``cell``, at its shapes."""
    S, L, N, P, nleg_all, nleg = CELLS[cell]
    nu_neg = points((S, N, P), seed, dtype)
    nu = points((S, 1, 2 * N, P), seed + 1, dtype)
    return {"ims": (moments((S, 1, 1), nleg_all, seed + 2, dtype), nu_neg, (S, N * P)),
            "tms_exact": (moments((S, L, 1, 1), nleg_all, seed + 3, dtype), nu, (S * L, 2 * N * P)),
            "tms_truncated": (moments((S, L, 1, 1), nleg, seed + 4, dtype), nu, (S * L, 2 * N * P))}


def through_rows(coeffs, x):
    """The wrapper's reduction, then the kernel's plain model, on the CPU."""
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    c2, x2 = legendre.row_operands(coeffs, x, shape)
    return legendre.legendre_series_rows_plain(c2, x2).reshape(shape)


def bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("R,Q,ndeg", [(1, 1, 1), (3, 5, 2), (7, 33, 7), (5, 257, 48), (2, 300, 301),
                                      (112, 96, 300), (40, 192, 33)])
def test_rows_plain_is_the_loop_bit_for_bit(R, Q, ndeg, dtype):
    """The kernel's plain model on (R, ndeg) and (R, Q) operands: ndeg 1, 2
    and odd; Q not a multiple of a warp or of the kernel's 256-point block."""
    coeffs, x = moments((R,), ndeg, R + Q, dtype), points((R, Q), ndeg, dtype)
    got = legendre.legendre_series_rows_plain(coeffs, x)
    assert bitwise(got, loop_before(coeffs[:, None, :], x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("call", ["ims", "tms_exact", "tms_truncated"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_nt_calls_reduce_to_rows_bit_for_bit(cell, call, dtype):
    """Each NT call at the cell's shapes takes the row form: the IMS call S
    rows of N x azimuths points, the TMS calls S x L rows of 2N x azimuths;
    the reduction plus the plain model give the loop's bits."""
    coeffs, x, rq = nt_calls(cell, dtype=dtype)[call]
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    c2, x2 = legendre.row_operands(coeffs, x, shape)
    assert (c2.shape, x2.shape) == ((rq[0], coeffs.shape[-1]), rq) and c2.is_contiguous() and x2.is_contiguous()
    assert bitwise(through_rows(coeffs, x), loop_before(coeffs, x))


@pytest.mark.parametrize("call", ["ims", "tms_exact", "tms_truncated"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_nt_calls_match_jax(cell, call):
    """The row form against the JAX package's ``legendre_series`` mapped
    over the rows, float64: the same recurrence, which XLA may contract."""
    coeffs, x, (R, Q) = nt_calls(cell, seed=7)[call]
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    c2, x2 = legendre.row_operands(coeffs, x, shape)
    ref = np.asarray(jax.vmap(jleg.legendre_series)(jnp.asarray(c2.numpy()), jnp.asarray(x2.numpy())))
    got = through_rows(coeffs, x).reshape(R, Q).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("cshape,xshape,rq", [
    ((4, 1, 1), (4, 3, 2), (4, 6)),             # the IMS call
    ((4, 5, 1, 1), (4, 1, 3, 2), (20, 6)),      # the TMS calls: x broadcast along the layers
    ((4, 5, 1, 1), (3, 2), (20, 6)),            # legendre_series: every series at every point
    ((1, 5, 1), (4, 5, 3), None),               # coefficients shared along the leading axis
    ((4, 1, 5, 1), (4, 3, 5, 2), None),         # ... and along an inner one
    ((1, 1), (4, 3), (1, 12)),                  # one series
    ((4, 3), (), (12, 1)),                      # one point
    ((0, 1), (0, 2), None),                     # no rows
])
def test_row_form(cshape, xshape, rq):
    """Which calls the kernel takes, and how they reduce; those it does not
    keep the plain loop."""
    coeffs, x = moments(cshape, 9, 1), points(xshape, 2)
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    operands = legendre.row_operands(coeffs, x, shape)
    assert (operands if operands is None else operands[1].shape) == rq
    if operands is not None:
        assert bitwise(through_rows(coeffs, x), loop_before(coeffs, x))


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors routed as CUDA tensors are, with the kernel's plain model
    standing in for the launch; returns the list of its calls."""
    calls = []

    def rows(coeffs, x):
        calls.append((coeffs.shape, x.shape))
        return legendre.legendre_series_rows_plain(coeffs, x)

    monkeypatch.setattr(legendre, "_on_card", lambda coeffs, x: True)
    monkeypatch.setattr(legendre, "legendre_series_rows", rows)
    return calls


def counted_terms(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    terms = profiling.recorded()["counters"].get("legendre_terms")
    profiling.reset()
    return out, terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_route_takes_the_kernel_and_counts_alike(kernel_route, monkeypatch, dtype):
    coeffs, x = moments((3, 4, 1, 1), 33, 5, dtype), points((3, 1, 6, 2), 6, dtype)
    got, terms = counted_terms(lambda: legendre.legendre_series_bcast(coeffs, x))
    assert kernel_route == [((12, 33), (12, 12))]
    monkeypatch.setattr(legendre, "_on_card", lambda coeffs, x: False)
    plain, plain_terms = counted_terms(lambda: legendre.legendre_series_bcast(coeffs, x))
    assert len(kernel_route) == 1 and terms == plain_terms == 33
    assert bitwise(got, plain) and bitwise(got, loop_before(coeffs, x))


def test_route_keeps_the_loop_under_a_gradient(kernel_route):
    coeffs = moments((3, 1), 20, 8).requires_grad_()
    x = points((3, 5), 9).requires_grad_()
    out = legendre.legendre_series_bcast(coeffs, x)
    assert kernel_route == [] and out.requires_grad
    gc, gx = torch.autograd.grad(out.square().sum(), (coeffs, x))
    c0, x0 = coeffs.detach().requires_grad_(), x.detach().requires_grad_()
    rc, rx = torch.autograd.grad(loop_before(c0, x0).square().sum(), (c0, x0))
    assert bitwise(gc, rc) and bitwise(gx, rx)
    with torch.no_grad():                  # no gradient taken: the kernel's call
        legendre.legendre_series_bcast(coeffs, x)
    assert kernel_route == [((3, 20), (3, 5))]


def test_route_keeps_the_loop_under_forward_mode(kernel_route):
    coeffs, x = moments((3, 1), 20, 10), points((3, 5), 11)
    tc, tx = moments((3, 1), 20, 12), points((3, 5), 13)
    with fwAD.dual_level():
        out = fwAD.unpack_dual(legendre.legendre_series_bcast(fwAD.make_dual(coeffs, tc), fwAD.make_dual(x, tx)))
        ref = fwAD.unpack_dual(loop_before(fwAD.make_dual(coeffs, tc), fwAD.make_dual(x, tx)))
    assert kernel_route == []
    assert bitwise(out.primal, ref.primal) and bitwise(out.tangent, ref.tangent)


def test_route_keeps_the_loop_for_mixed_or_other_dtypes(kernel_route):
    coeffs, x = moments((3, 1), 7, 14), points((3, 5), 15)
    assert bitwise(legendre.legendre_series_bcast(coeffs.float(), x), loop_before(coeffs.float(), x))
    assert bitwise(legendre.legendre_series_bcast(coeffs.to(torch.bfloat16), x.to(torch.bfloat16)),
                   loop_before(coeffs.to(torch.bfloat16), x.to(torch.bfloat16)))
    assert kernel_route == []


def test_rows_on_the_cpu_take_the_plain_model():
    coeffs, x = moments((4,), 12, 16), points((4, 7), 17)
    assert bitwise(legendre.legendre_series_rows(coeffs, x), legendre.legendre_series_rows_plain(coeffs, x))
