"""pythonic-disort-torch: the PyTorch/CUDA port of pythonic-disort-tpu.

The batched flux solve of the discrete-ordinates radiative-transfer
solver on an NVIDIA H100.  The JAX package beside it is the reference;
this package imports neither JAX nor it.  Its two hot stages, the fused
eigen stage and the fused boundary-value solve, are CUDA kernels written
for Hopper (``csrc/``), built with nvcc at first use.
"""

import torch

# Full-precision float32 products: TF32 keeps about three decimal digits,
# and reduced-precision f32 matmuls cost the flux path about 15x in
# downwelling-flux accuracy (the JAX package's matmul-precision default,
# pythonic_disort_tpu/config.py, exists for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .convert import problem_from_arrays  # noqa: E402
from .models.disort.batch_solve import solve_batched  # noqa: E402
from .models.disort.types import (  # noqa: E402
    DisortConfig, DisortProblem, DisortSolution,
)
from .parallel.batch import (  # noqa: E402
    fluxes_at, make_batched_problem, solve_fluxes,
)

__version__ = "0.1.0"

__all__ = [
    "DisortConfig", "DisortProblem", "DisortSolution",
    "make_batched_problem", "solve_batched", "fluxes_at", "solve_fluxes",
    "problem_from_arrays",
]
