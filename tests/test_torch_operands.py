"""The boundary-value operands of the batched solve (``ops/operands.py``)
held on the CPU.

`bvp_operands_plain` is the tensor code that ``batch_solve._solve`` ran
inline between the eigen stage and the BVP: here it is held, bit for bit,
to a frozen copy of that inline code (`inline_before`), on the operands
of real solves (beam with and without BDRF, an isotropic source, NF = 1
and NF > 1, NQuad 4-16, odd N too), and the isotropic source's mode-0
blocks taken from ``Gt`` to ``G_l[..., :L*S]``.  A numpy model of the
CUDA kernel's lane map and order of operations (`kernel_model`) is held
to it: ``Gt`` bit for bit, ``B_l`` to roundoff.  The route is held to its
rule: the CPU, and operands that take a gradient or carry a forward-mode
tangent, take the plain code.  The kernel itself runs only on the card
(``python3 -m pythonic_disort_torch.tools.check_operands``).
"""

import inspect

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.profiler import ProfilerActivity, profile

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import batch_solve
from pythonic_disort_torch.models.disort.solve import iso_particular_tensor
from pythonic_disort_torch.ops import operands
from pythonic_disort_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _mat_lanes(A, x):
    return torch.einsum("ikq,kq->iq", A, x)


def inline_before(X, Y, P, Q, K_pos, L, S, xp=None, xn=None, mu0=None):
    """The operands stage of ``batch_solve._solve`` as it stood inline,
    before `bvp_operands`: ``(Gt, B_l or None, G_l)``."""
    N, _, lanes = X.shape
    NF = lanes // (L * S)
    LS = L * S

    def per_mode(x_sl):
        return x_sl.T[None].expand(NF, L, S).reshape(NF * LS)

    a_blk = 0.5 * (X + Y)
    b_blk = 0.5 * (X - Y)
    G_l = torch.cat(
        [torch.cat([a_blk, b_blk], dim=1), torch.cat([b_blk, a_blk], dim=1)], dim=0)
    K_full = torch.cat([-K_pos, K_pos], dim=0)
    B_l = None
    if xp is not None:
        Pp, Pn = _mat_lanes(P, xp), _mat_lanes(P, xn)
        Qp, Qn = _mat_lanes(Q, xp), _mat_lanes(Q, xn)
        y_top = 0.5 * (Pp + Qp + Pn - Qn)
        y_bot = 0.5 * (Pp - Qp + Pn + Qn)
        mu0_q = per_mode(mu0[:, None].expand(S, L))
        ycat = torch.cat([y_top, y_bot], dim=0) / (1.0 / mu0_q + K_full)
        zt, zb = ycat[:N], ycat[N:]
        B_l = torch.cat([_mat_lanes(a_blk, zt) + _mat_lanes(b_blk, zb),
                         _mat_lanes(b_blk, zt) + _mat_lanes(a_blk, zb)], dim=0)
    Gt = G_l.reshape(2 * N, 2 * N, NF, L, S).movedim(3, 0).reshape(L, 2 * N, 2 * N, NF * S)
    return Gt, B_l, G_l


def kernel_model(X, Y, P, Q, K_full, L, S, xp=None, xn=None, mu0=None):
    """``csrc/bvp_operands.cu`` in numpy, float64: each lane q's (m, l, s)
    and its flat offsets into ``Gt``, a and b rounded as the kernel rounds
    them, the dot products summed in the kernel's order (k, j ascending;
    an fma there, a product and a sum here: the same to roundoff)."""
    X, Y = X.numpy(), Y.numpy()
    N, _, lanes = X.shape
    NF = lanes // (L * S)
    q = np.arange(lanes)
    m, l, s = q // (L * S), (q % (L * S)) // S, q % S
    NFS = NF * S
    gl = l * (2 * N) * (2 * N) * NFS + m * S + s          # Gt[l, 0, 0, m S + s]
    Gt = np.full(L * 4 * N * N * NFS, np.nan)
    B = None
    if xp is not None:
        P, Q, K, xp, xn = (x.numpy() for x in (P, Q, K_full, xp, xn))
        inv = 1.0 / mu0.numpy()[s]
        z = np.zeros((2 * N, lanes))
        for i in range(N):
            pp = pn = qp = qn = np.zeros(lanes)
            for k in range(N):
                pp, pn = pp + P[i, k] * xp[k], pn + P[i, k] * xn[k]
                qp, qn = qp + Q[i, k] * xp[k], qn + Q[i, k] * xn[k]
            z[i] = 0.5 * (((pp + qp) + pn) - qn) / (inv + K[i])
            z[N + i] = 0.5 * (((pp - qp) + pn) + qn) / (inv + K[N + i])
        B = np.zeros((2 * N, lanes))
    for i in range(N):
        at = bb = bt = ab = np.zeros(lanes)
        for j in range(N):
            a, b = 0.5 * (X[i, j] + Y[i, j]), 0.5 * (X[i, j] - Y[i, j])
            for r, c, v in ((i, j, a), (i, N + j, b), (N + i, j, b), (N + i, N + j, a)):
                Gt[gl + (r * 2 * N + c) * NFS] = v
            if B is not None:
                at, bb = at + a * z[j], bb + b * z[N + j]
                bt, ab = bt + b * z[j], ab + a * z[N + j]
        if B is not None:
            B[i], B[N + i] = at + bb, bt + ab
    return Gt.reshape(L, 2 * N, 2 * N, NFS), B


# (NQuad, layers, NFourier, beam, iso source, BDRF)
CASES = [
    (4, 3, 1, True, False, False),
    (6, 2, 3, True, False, False),      # odd N: the eigen stage's Jacobi route, operands not contiguous
    (8, 4, 4, True, False, True),
    (8, 2, 1, False, True, False),
    (10, 3, 5, True, True, True),
    (16, 2, 8, True, True, False),
    (16, 1, 1, False, True, True),
]


def problem(nquad, nlayers, nfourier, beam, iso, bdrf, S=3, seed=0):
    rng = np.random.default_rng(seed + nquad + 7 * nlayers)
    N = nquad // 2
    tau = np.cumsum(rng.uniform(0.1, 0.7, (S, nlayers)), axis=1)
    omega = rng.uniform(0.2, 0.95, (S, nlayers))
    g = rng.uniform(0.2, 0.8, (S, nlayers))
    leg = g[..., None] ** np.arange(nquad + 1)[None, None, :]
    cfg = pt.DisortConfig(nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=nfourier, nlayers=nlayers,
                          nscoeffs=3 if iso else 0, nbdrf=1 if bdrf else 0, has_beam=beam, only_flux=False,
                          has_deltam=True)
    modes = np.broadcast_to(rng.uniform(0.1, 0.4, (S, 1, 1, 1)), (S, 1, N, N)).copy() if bdrf else None
    return pt.make_batched_problem(
        cfg, tau, omega, leg, rng.uniform(0.3, 0.9, S) if beam else np.zeros(S),
        np.full(S, np.pi) if beam else np.zeros(S), phi0=rng.uniform(0, 2 * np.pi, S), f_arr=leg[..., nquad],
        s_poly_coeffs=rng.uniform(0.1, 1.0, (S, nlayers, 3)) if iso else None, bdrf_modes=modes,
        bdrf_modes_mu0=modes[:, :, 0] if bdrf else None, dtype=torch.float64, device="cpu")


def captured(prob, monkeypatch):
    """The solve of ``prob``, recording each `bvp_operands` call: [(its
    arguments by name, its outputs)] and the solution."""
    calls = []
    signature = inspect.signature(operands.bvp_operands)

    def record(*args, **kwargs):
        out = operands.bvp_operands(*args, **kwargs)
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append((dict(bound.arguments), out))
        return out

    monkeypatch.setattr(batch_solve, "bvp_operands", record)
    sol = batch_solve.solve_batched(prob)
    return calls, sol


def as_before(ops):
    """`bvp_operands`'s arguments as `inline_before` takes them (K+, not
    [-K+; K+])."""
    ops = dict(ops)
    K_full = ops.pop("K_full")
    return dict(ops, K_pos=K_full[K_full.shape[0] // 2:])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "nq{}-L{}-nf{}-{}".format(
    c[0], c[1], c[2], "+".join(n for n, on in zip(("beam", "iso", "bdrf"), c[3:]) if on)))
def test_plain_operands_are_the_inline_codes_bits(case, monkeypatch):
    """One `bvp_operands` call a solve; its ``Gt`` and ``B_l`` are the
    inline code's, bit for bit, on the solve's own operands."""
    calls, sol = captured(problem(*case), monkeypatch)
    assert len(calls) == 1
    ops, (Gt, B_l) = calls[0]
    Gt0, B0, _ = inline_before(**as_before(ops))
    assert torch.equal(Gt, Gt0)
    assert (B_l is None) == (not case[3]) and (B0 is None) == (not case[3])
    if B_l is not None:
        assert torch.equal(B_l, B0)
        N = ops["X"].shape[0]
        assert torch.equal(sol.B, B_l.reshape(2 * N, -1, ops["L"], ops["S"]).permute(3, 1, 2, 0))


@pytest.mark.parametrize("case", [c for c in CASES if c[4]], ids=lambda c: f"nq{c[0]}-L{c[1]}-nf{c[2]}")
def test_iso_source_reads_mode_0_from_gt(case, monkeypatch):
    """`mode0_blocks` of ``Gt`` is ``G_l[..., :L*S].permute(2, 0, 1)``,
    value and layout, and the isotropic source's tensor from it has the
    bits it had from ``G_l``."""
    calls, _ = captured(problem(*case), monkeypatch)
    ops, (Gt, _) = calls[0]
    L, S = ops["L"], ops["S"]
    G_l = inline_before(**as_before(ops))[2]
    before = G_l[..., :L * S].permute(2, 0, 1)
    now = operands.mode0_blocks(Gt, S)
    assert torch.equal(now, before)
    assert now.stride()[0] == 1 and now.stride()[2] * now.shape[2] == now.stride()[1]
    rng = np.random.default_rng(3)
    n2 = Gt.shape[1]
    K0 = torch.as_tensor(rng.uniform(0.5, 3.0, (L * S, n2)))
    gim = torch.as_tensor(rng.normal(size=(L * S, n2)))
    s_desc = torch.as_tensor(rng.uniform(0.1, 1.0, (L * S, 3)))
    assert torch.equal(iso_particular_tensor(now, K0, gim, s_desc), iso_particular_tensor(before, K0, gim, s_desc))


@pytest.mark.parametrize("case", [c for c in CASES if c[3]][:4], ids=lambda c: f"nq{c[0]}-L{c[1]}-nf{c[2]}")
def test_kernel_model_against_plain(case, monkeypatch):
    """The kernel's lane map and order of operations, modelled in numpy:
    ``Gt`` the plain code's bits, ``B_l`` within 1e-13 of the largest
    |B_l| of its lane."""
    calls, _ = captured(problem(*case), monkeypatch)
    ops, (Gt, B_l) = calls[0]
    Gm, Bm = kernel_model(**ops)
    np.testing.assert_array_equal(Gm, Gt.numpy())
    B = B_l.numpy()
    assert (np.abs(Bm - B).max(axis=0) <= 1e-13 * np.abs(B).max(axis=0)).all()


def test_kernel_model_without_beam():
    rng = np.random.default_rng(5)
    N, L, S, NF = 3, 2, 5, 4
    X, Y = (torch.as_tensor(rng.normal(size=(N, N, NF * L * S))) for _ in range(2))
    K = torch.as_tensor(rng.uniform(0.5, 2.0, (2 * N, NF * L * S)))
    Gt, B = operands.bvp_operands(X, Y, None, None, K, L, S)
    Gm, Bm = kernel_model(X, Y, None, None, K, L, S)
    assert B is None and Bm is None
    np.testing.assert_array_equal(Gm, Gt.numpy())


def random_operands(N=3, L=2, S=4, NF=2, seed=0, **kw):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape), **kw)
    lanes = NF * L * S
    K = torch.as_tensor(rng.uniform(0.5, 2.0, (N, lanes)), **kw)
    return dict(X=t(N, N, lanes), Y=t(N, N, lanes), P=t(N, N, lanes), Q=t(N, N, lanes),
                K_full=torch.cat([-K, K]), L=L, S=S, xp=t(N, lanes), xn=t(N, lanes),
                mu0=torch.as_tensor(rng.uniform(0.2, 1.0, S), **kw))


def launches(run):
    """``run()`` under a profiler: (output, the launches recorded)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    rec = profiling.recorded()["launches"]
    profiling.reset()
    return out, rec


def test_cpu_takes_the_plain_code():
    ops = random_operands()
    (Gt, B), rec = launches(lambda: operands.bvp_operands(**ops))
    Gp, Bp = operands.bvp_operands_plain(**ops)
    assert rec == {} and torch.equal(Gt, Gp) and torch.equal(B, Bp)


@pytest.mark.parametrize("which", ["X", "P", "xp", "mu0", "K_full"])
def test_route_under_a_gradient(which):
    """An operand that requires a gradient, with grad mode on, takes the
    plain code (and its gradient flows); under ``no_grad`` it does not."""
    ops = random_operands()
    ops[which] = ops[which].clone().requires_grad_()
    assert operands._plain_only(*(ops[k] for k in ("X", "Y", "P", "Q", "K_full", "xp", "xn", "mu0")))
    with torch.no_grad():
        assert not operands._plain_only(ops[which])
    (Gt, B), rec = launches(lambda: operands.bvp_operands(**ops))
    assert rec == {}
    (g,) = torch.autograd.grad((Gt.sum() + B.square().sum()) if which != "mu0" else B.sum(), ops[which])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_route_under_a_tangent():
    """An operand carrying a forward-mode tangent takes the plain code:
    the primal and tangent are the plain code's."""
    ops = random_operands()
    tangent = torch.ones_like(ops["X"])
    assert not operands._plain_only(ops["X"])
    with fwAD.dual_level():
        dual = dict(ops, X=fwAD.make_dual(ops["X"], tangent))
        assert operands._plain_only(dual["X"])
        Gt, B = operands.bvp_operands(**dual)
        Gp, Bp = operands.bvp_operands_plain(**dual)
        for a, b in ((Gt, Gp), (B, Bp)):
            a, b = fwAD.unpack_dual(a), fwAD.unpack_dual(b)
            assert torch.equal(a.primal, b.primal) and torch.equal(a.tangent, b.tangent)


@pytest.mark.parametrize("grad", [False, True])
def test_meta_tensors_take_the_plain_code(grad):
    """Without a card (meta tensors) the wrapper takes the plain code, with
    or without a gradient, and gives the kernel's output shapes."""
    ops = random_operands(N=4, L=3, S=5, NF=2)
    ops = {k: (v.to("meta").requires_grad_(grad) if isinstance(v, torch.Tensor) else v) for k, v in ops.items()}
    Gt, B = operands.bvp_operands(**ops)
    assert Gt.device.type == "meta" and Gt.shape == (3, 8, 8, 10) and B.shape == (8, 30)
    Gt, B = operands.bvp_operands(ops["X"], ops["Y"], ops["P"], ops["Q"], ops["K_full"], 3, 5)
    assert Gt.shape == (3, 8, 8, 10) and B is None


def test_beam_operands_go_together():
    ops = random_operands()
    with pytest.raises(ValueError, match="go together"):
        operands.bvp_operands(**dict(ops, xn=None))


@pytest.mark.parametrize("fault", ["shape", "lanes", "dtype"])
def test_check_refuses(fault):
    """The kernel's operand check (device-free): shapes, lanes that are not
    NF * L * S, mixed dtypes."""
    ops = random_operands()
    if fault == "shape":
        ops["xp"] = ops["xp"][:, :-1]
    elif fault == "lanes":
        ops["L"] = 5
    else:
        ops["Y"] = ops["Y"].float()
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        operands._check(**ops)
    operands._check(**random_operands())


def test_cell_capture_through_the_port():
    """``tools/check_operands.py`` builds a cell's step through the port's
    own entry and captures its one `bvp_operands` call: the eigen lanes'
    shapes, the beam's operands, no launch on the CPU, the wrapper put
    back."""
    from pythonic_disort_torch.tools import check_operands

    ops, launched = check_operands.cell_operands("tiny", device="cpu", cells={"tiny": (3, 4, 8, 3, 9)})
    assert batch_solve.bvp_operands is operands.bvp_operands and launched == 0
    assert (ops["L"], ops["S"]) == (4, 3) and ops["X"].shape == (4, 4, 3 * 4 * 3)
    assert ops["X"].dtype == torch.float64 and ops["mu0"].shape == (3,) and ops["xp"].shape == (4, 36)
    Gt, B_l = operands.bvp_operands_plain(**ops)
    assert Gt.shape == (4, 8, 8, 9) and B_l.shape == (8, 36)
    assert check_operands.as_kwargs((1, 2, 3, 4, 5, 6, 7)) == dict(
        X=1, Y=2, P=3, Q=4, K_full=5, L=6, S=7, xp=None, xn=None, mu0=None)
    ops32, _ = check_operands.cell_operands("tiny", device="cpu", cells={"tiny": (3, 4, 8, 3, 9)},
                                            dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in ops32.values() if isinstance(v, torch.Tensor))
    assert ops32["X"].shape == ops["X"].shape and batch_solve.bvp_operands is operands.bvp_operands


def test_card_check_sets_pole_lanes_apart():
    """The card check's comparison of ``B_l`` (``tools/check_operands.py``)
    sets no lane apart: the solve moves mu0 off the beam's pole before it
    builds the operands, so a lane at the pole (``1/mu0 + K`` exactly 0,
    not finite in the plain code) reads infinite and fails the check, on
    either route."""
    from pythonic_disort_torch.tools import check_operands

    ops = random_operands()
    N, lanes = ops["X"].shape[0], ops["X"].shape[2]
    ops["mu0"] = ops["mu0"].clone()
    ops["mu0"][1] = 0.5
    K_full = ops["K_full"].clone()
    K_full[2, ops["S"] + 1] = -2.0        # lane (m 0, l 1, s 1): 1/mu0 + K = 0
    K_full[N + 2, ops["S"] + 1] = 2.0
    ops["K_full"] = K_full
    _, B = operands.bvp_operands_plain(**ops)
    bad = ~torch.isfinite(B).all(dim=0)
    assert bad.sum() == 1 and bad[ops["S"] + 1]
    finite = torch.where(torch.isfinite(B), B, torch.zeros_like(B))
    assert check_operands.lane_rel(B, B) == float("inf")
    assert check_operands.lane_rel(finite, B) == float("inf") == check_operands.lane_rel(B, finite)
    assert check_operands.lane_rel(finite, finite) == 0.0
    off = finite.clone()
    off[0, 0] += 1e-3 * off[:, 0].abs().max()
    assert check_operands.lane_rel(off, finite) == pytest.approx(1e-3)
