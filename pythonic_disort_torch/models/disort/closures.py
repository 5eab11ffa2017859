"""The closures `pydisort` returns: numpy in, numpy out.

Counterpart of the closure layer of ``pythonic_disort_tpu/models/disort/
api.py`` (reference ``_assemble_intensity_and_fluxes.py:166-619``).  Each
closure takes tau (and phi) as numbers, arrays or tensors, evaluates the
solution on its own device, and returns numpy arrays squeezed the way the
reference squeezes them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import eval as ev
from .types import DisortSolution


def _numpy(x: torch.Tensor):
    return np.squeeze(x.cpu().numpy())[()]


class Probes:
    """Validation and transfer of probe points for one solution; one
    instance serves all the closures of a solution (it holds the host copy
    of ``tau_arr``, and fetching that synchronizes the stream)."""

    def __init__(self, sol: DisortSolution):
        self.dtype, self.device = sol.tau_arr.dtype, sol.tau_arr.device
        self.tau_np = sol.tau_arr.cpu().numpy()

    def tau(self, tau) -> torch.Tensor:
        tau = torch.atleast_1d(torch.as_tensor(tau, dtype=self.dtype))
        if bool((tau < 0).any()) or bool((tau > self.tau_np[-1]).any()):
            raise ValueError(
                "tau input outside the tau range specified for the atmosphere (check `tau_arr`)."
            )
        return tau.to(self.device)

    def phi(self, phi) -> torch.Tensor:
        return torch.atleast_1d(torch.as_tensor(phi, dtype=self.dtype, device=self.device))


def flux_up_closure(sol: DisortSolution, probes: Probes):
    def flux_up(tau, is_antiderivative_wrt_tau=False, return_tau_arr=False):
        out = _numpy(ev.flux_up(sol, probes.tau(tau), bool(is_antiderivative_wrt_tau)))
        return (out, probes.tau_np) if return_tau_arr else out

    return flux_up


def flux_down_closure(sol: DisortSolution, probes: Probes):
    def flux_down(tau, is_antiderivative_wrt_tau=False, return_tau_arr=False):
        diffuse, direct = ev.flux_down(sol, probes.tau(tau), bool(is_antiderivative_wrt_tau))
        outputs = (_numpy(diffuse), _numpy(direct))
        return outputs + (probes.tau_np,) if return_tau_arr else outputs

    return flux_down


def u0_closure(sol: DisortSolution, probes: Probes):
    def u0(tau, is_antiderivative_wrt_tau=False, return_tau_arr=False,
           _return_act_dscale_for_reclass=False):
        tau = probes.tau(tau)
        anti = bool(is_antiderivative_wrt_tau)
        outputs = (_numpy(ev.u0(sol, tau, anti)),)
        if return_tau_arr:
            outputs += (probes.tau_np,)
        if _return_act_dscale_for_reclass:
            outputs += (ev.act_dscale_reclassification(sol, tau, anti).cpu().numpy(),)
        return outputs[0] if len(outputs) == 1 else outputs

    return u0


def u_closure(sol: DisortSolution, probes: Probes, u_eval=ev.u):
    """The intensity closure over ``u_eval`` (`eval.u`, or its NT-corrected
    counterpart `nt.u_corrected`)."""
    def u(tau, phi, is_antiderivative_wrt_tau=False, return_Fourier_error=False,
          return_tau_arr=False):
        res = u_eval(sol, probes.tau(tau), probes.phi(phi),
                     bool(is_antiderivative_wrt_tau), bool(return_Fourier_error))
        if return_Fourier_error:
            outputs = (_numpy(res[0]), float(res[1]))
        else:
            outputs = (_numpy(res),)
        if return_tau_arr:
            outputs += (probes.tau_np,)
        return outputs[0] if len(outputs) == 1 else outputs

    return u
