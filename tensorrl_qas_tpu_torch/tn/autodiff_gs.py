"""Gradient-descent MPS ground-state solver (autodiff alternative to DMRG).

Counterpart of the reference's ``gs_autodiff``
(``dmrg-to-qc/mps2qc.py:156-216``), which minimizes the global energy of a
random chi-bounded MPS against a Hamiltonian MPO with quimb's TNOptimizer
(autodiff_backend="jax", default L-BFGS-B).  The reference never calls it
from its driver (``dmrg_to_qc.py`` uses ``gs_dmrg``); it stays an
alternative, fully differentiable ground-state path that cross-validates
the sweeping solver.

The port of the JAX package's ``tn/autodiff_gs.py``:

- Adam on the MPS site tensors, one torch autograd step an iteration on
  the tensors' device (the JAX package scans the steps in one jitted
  ``lax.scan``); the energy history stays on the device until the end;
- complex site tensors are carried as explicit (real, imag) float64 pairs,
  so the energy is a real function of real leaves;
- normalization is folded into the loss, E = <psi|H|psi> / <psi|psi>,
  instead of the reference's explicit ``norm_fn`` re-scaling; the returned
  MPS is normalized once at the end.

The MPS/MPO index conventions match ``tn/mps.py`` / ``tn/mpo.py``
(site tensor (chi_l, 2, chi_r); MPO tensor (bond_l, bond_r, s_out, s_in)).
Precision is complex128 / float64 on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.tn.mpo import MPO
from tensorrl_qas_tpu_torch.tn.mps import MPS


def _energy(res, ims, w_tensors):
    """Rayleigh quotient <psi|H|psi> / <psi|psi> of an MPS (real output)."""
    dev = w_tensors[0].device
    env = torch.ones((1, 1, 1), dtype=torch.complex128, device=dev)
    nrm = torch.ones((1, 1), dtype=torch.complex128, device=dev)
    for re, im, w in zip(res, ims, w_tensors):
        a = torch.complex(re, im)
        ac = a.conj()
        # "bud,usr,bcst,dtm->crm" and "ud,usr,dtm,st->rm" one pair at a
        # time: a many-operand torch.einsum searches its contraction path
        # on every call
        env = torch.einsum("bdsr,bcst->drct",
                           torch.einsum("bud,usr->bdsr", env, ac), w)
        env = torch.einsum("drct,dtm->crm", env, a)
        nrm = torch.einsum("dsr,dsm->rm", torch.einsum("ud,usr->dsr", nrm,
                                                        ac), a)
    return env[0, 0, 0].real / nrm[0, 0].real


def gs_autodiff(mpo: MPO, chi: int = 2, opt_steps: int = 2000,
                lr: float = 5e-2, seed: int = 0, device=None):
    """Minimize the MPS energy by Adam on ``device`` (the card unless
    given).

    Returns ``(energy, mps, loss_history)`` with ``energy`` the best value
    seen (the reference reports ``tnopt.loss_best``), ``mps`` the
    normalized final state, and ``loss_history`` the per-step energies.
    """
    dev = as_device(device)
    n = mpo.n_sites
    psi0 = MPS.random(n, chi, seed=seed)
    params = [torch.as_tensor(np.ascontiguousarray(part(t)),
                              dtype=torch.float64, device=dev)
              for part in (np.real, np.imag) for t in psi0.tensors]
    w_tensors = [torch.as_tensor(t, dtype=torch.complex128, device=dev)
                 for t in mpo.tensors]

    def loss(ps):
        return _energy(ps[:n], ps[n:], w_tensors)

    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    hist = torch.empty(opt_steps, dtype=torch.float64, device=dev)
    for i in range(opt_steps):
        leaves = [p.detach().requires_grad_(True) for p in params]
        e = loss(leaves)
        grads = torch.autograd.grad(e, leaves)
        with torch.no_grad():
            hist[i] = e.detach()
            t = i + 1.0
            # Adam over every leaf at once: p -= lr mhat / (sqrt(vhat) + eps)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(params, m, denom,
                                    value=-lr / (1 - b1 ** t))

    with torch.no_grad():
        final_e = float(loss(params))
    hist = hist.cpu().numpy()
    best_e = float(min(hist.min(), final_e))

    tensors = [r.cpu().numpy() + 1j * im.cpu().numpy()
               for r, im in zip(params[:n], params[n:])]
    mps = MPS(tensors)
    mps.normalize()
    return best_e, mps, hist
