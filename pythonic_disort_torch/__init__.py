"""pythonic-disort-torch: the PyTorch/CUDA port of pythonic-disort-tpu.

The discrete-ordinates radiative-transfer solver on an NVIDIA H100, on
two paths: the batched solve over columns x bands (`solve_fluxes`,
`solve_intensity`, `solve_actinic`) and the single-column solve behind
the drop-in `pydisort` API.  The JAX package beside it is the
reference; this package imports neither JAX nor it.  Six stages run
eight CUDA kernels written for Hopper (``csrc/``), built with nvcc at
first use and launched through ``ops/_build.py``:

- the fused eigen stage at even N <= 32 (kernel 1, ``eig_stage.cu``;
  both paths);
- the fused boundary-value solve of the batched path: kernel 7
  (``bvp_fused_wide.cu``) at every even 2N <= 64;
- the generic block-Thomas solve: kernel 3 (``blocktri.cu``) at n <= 64,
  kernel 6 (``blocktri_wide.cu``) above; the single-column path, the
  batched path above 2N = 64 and the transposed solve of every gradient;
- the batched two-sided Jacobi eigendecomposition: kernel 4
  (``jacobi_eigh.cu``) at even n <= 32, kernel 5 (``jacobi_eigh_wide.cu``)
  at odd n and n > 32; the eigen stage of every gradient and of the
  widths kernel 1 does not take.
- the Legendre series of the NT correction (``legendre_series.cu``), one
  launch a series where no gradient or tangent is taken;
- the boundary-value operands of the batched path (``bvp_operands.cu``):
  the eigenvector blocks in the BVP's layout and the beam's particular
  solution, one launch a solve where no gradient or tangent is taken.

Both paths take first-order reverse-mode gradients through
``torch.autograd``.  The reference-compatible ``subroutines`` namespace
holds the host utilities (Planck and source polynomials, BDRF helpers,
mu interpolation, actinic fluxes); ``ops.planck`` integrates Planck
bands on the device.
"""

import torch

# Full-precision float32 products: TF32 keeps about three decimal digits,
# and reduced-precision f32 matmuls cost the flux path about 15x in
# downwelling-flux accuracy (the JAX package's matmul-precision default,
# pythonic_disort_tpu/config.py, exists for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .convert import problem_from_arrays, solution_to_arrays  # noqa: E402
from .models.disort.api import build_problem, pydisort  # noqa: E402
from .models.disort.batch_solve import solve_batched, solve_batched_probes  # noqa: E402
from .models.disort.solve import solve  # noqa: E402
from .models.disort.types import (  # noqa: E402
    DisortConfig, DisortProblem, DisortSolution,
)
from .ops.blocktri import solve_block_tridiag  # noqa: E402
from .ops.eig import disort_eigh  # noqa: E402
from .ops.jacobi import jacobi_eigh  # noqa: E402
from .parallel.batch import (  # noqa: E402
    actinic_at, fluxes_at, make_batched_problem, solve_actinic, solve_fluxes, solve_intensity, u0_at, u_at,
    u_corrected_at,
)
from . import subroutines  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DisortConfig", "DisortProblem", "DisortSolution",
    "make_batched_problem", "solve_batched", "solve_batched_probes", "fluxes_at", "solve_fluxes",
    "u0_at", "u_at", "u_corrected_at", "solve_intensity", "actinic_at", "solve_actinic",
    "build_problem", "pydisort", "solve", "solve_block_tridiag", "disort_eigh", "jacobi_eigh",
    "problem_from_arrays", "solution_to_arrays", "subroutines",
]
