"""Where the rows of a sharded float32 solve part from the unsharded ones, on one GPU.

    python3 -m pythonic_disort_torch.tools.check_shard_rows

``bench.py``'s flux sweep of 16 columns x 128 bands (2048 solves, float32)
is solved whole and in two halves of 1024 solves, as two ranks solve it.
The tool prints whether the whole solve repeats bit for bit, whether the
kernels' operands (the eigen stage's At and Bt, the fused boundary-value
solve's four operands) of the second half equal the whole solve's on the
same lanes bit for bit, the largest difference of each half's fluxes and
the rows that carry it, and for those rows their distance to the beam
pole (min |K mu0 - 1|, float64 on the CPU) and the error of the whole,
the half and an 8-row solve against float64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .check_bvp import batched_problem, bench_arrays
from .mesh_worker import problem_rows

ROWS, HALF, L = 2048, 1024, 64


def operands(problem):
    """The operands the eigen stage and the fused boundary-value solve get."""
    import pythonic_disort_torch as pt
    from ..models.disort import batch_solve
    from ..ops import eig

    seen = {}
    stage, bvp = eig.eig_stage_lanes, batch_solve.solve_bvp_fused

    def keep(name, fn):
        def run(*ops):
            seen[name] = tuple(x.clone() for x in ops)
            return fn(*ops)
        return run

    eig.eig_stage_lanes, batch_solve.solve_bvp_fused = keep("eig", stage), keep("bvp", bvp)
    try:
        pt.solve_fluxes(problem, problem.tau_arr)
    finally:
        eig.eig_stage_lanes, batch_solve.solve_bvp_fused = stage, bvp
    return seen


def main():
    import pythonic_disort_torch as pt
    from ..models.disort.batch_solve import solve_batched

    if not torch.cuda.is_available():
        raise SystemExit("check_shard_rows: CUDA is not available")
    arrs = bench_arrays(ROWS // 128)
    full = batched_problem(arrs, 32, torch.float32, "cuda")
    whole = [x.cpu().numpy() for x in pt.solve_fluxes(full, full.tau_arr)]
    again = [x.cpu().numpy() for x in pt.solve_fluxes(full, full.tau_arr)]
    print("the whole solve twice, bit for bit:", all(np.array_equal(a, b) for a, b in zip(whole, again)))
    halves = [[x.cpu().numpy() for x in pt.solve_fluxes(problem_rows(full, a, a + HALF), full.tau_arr[a:a + HALF])]
              for a in (0, HALF)]
    of_whole, of_half = operands(full), operands(problem_rows(full, HALF, ROWS))
    lanes = (torch.arange(L, device="cuda")[:, None] * ROWS + HALF + torch.arange(HALF, device="cuda")).reshape(-1)
    print("eigen operands on the second half's lanes, bit for bit:",
          all(torch.equal(x[..., lanes], y) for x, y in zip(of_whole["eig"], of_half["eig"])))
    print("boundary-value operands on the second half's lanes, bit for bit:",
          all(torch.equal(x[..., HALF:], y) for x, y in zip(of_whole["bvp"], of_half["bvp"])))
    worst = set()
    for h, a in enumerate((0, HALF)):
        for k, name in enumerate(("flux_up", "flux_down_diffuse", "flux_down_direct")):
            d = np.abs(halves[h][k] - whole[k][a:a + HALF]).max(axis=1)
            top = np.argsort(d)[::-1][:3]
            worst |= {int(a + i) for i in top[:2] if d[i] > 0}
            print(f"half {h} {name}: max difference {d.max():.3e}, rows {[(int(a + i), float(d[i])) for i in top]}")
    worst = sorted(worst)
    sub = {k: v[worst] for k, v in arrs.items()}
    p64 = batched_problem(sub, 32, torch.float64, "cpu")
    ref = pt.solve_fluxes(p64, p64.tau_arr)[0].numpy()
    K = solve_batched(p64).K[:, 0, :, 16:]
    dist = (K * p64.mu0[:, None, None] - 1).abs().amin(dim=(1, 2))
    small = batched_problem(sub, 32, torch.float32, "cuda")
    alone = pt.solve_fluxes(small, small.tau_arr)[0].cpu().numpy()
    for j, row in enumerate(worst):
        half = halves[row // HALF][0][row % HALF]
        print(f"row {row}: pole distance {dist[j].item():.3e}; flux_up against float64: whole "
              f"{np.abs(whole[0][row] - ref[j]).max():.3e}, half {np.abs(half - ref[j]).max():.3e}, "
              f"{len(worst)}-row solve {np.abs(alone[j] - ref[j]).max():.3e}; max |flux_up| {np.abs(ref[j]).max():.3e}")


if __name__ == "__main__":
    main()
