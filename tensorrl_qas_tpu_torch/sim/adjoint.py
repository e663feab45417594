"""Adjoint-mode energy gradients for the eager statevector path.

Every tape gate is unitary, so the backward pass un-applies gates instead
of storing one statevector per gate:

    E(x)      = <psi_G | H | psi_G> / <psi_G | psi_G>
    lam^{(G)} = dE/d psi_G^*
    for g = G .. 1:
        dE/dtheta_g = Im <lam^{(g)} | P_g | psi^{(g)}>      (U = e^{-i t P/2})
        psi^{(g-1)} = U_g^dagger psi^{(g)}
        lam^{(g-1)} = U_g^dagger lam^{(g)}

Three statevectors of memory whatever the gate count.  ``adjoint_energy``
wraps the sweep in a ``torch.autograd.Function``, so ``backward()`` on the
energy fills ``x.grad`` (and ``psi0.grad``) like any other torch op.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.sim.apply import apply_gate, apply_tape
from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
from tensorrl_qas_tpu_torch.utils.bits import parity

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_RXX, _RYY = int(GateKind.RXX), int(GateKind.RYY)


def apply_pauli_sum(psi, weights, flip, sign_mask, iphase):
    """H |psi> for a mask-form Pauli sum (operator form of
    ``pauli_expectation``'s signed gather)."""
    dim = psi.shape[-1]
    idx = torch.arange(dim, device=psi.device)
    out = torch.zeros_like(psi)
    for k in range(weights.shape[0]):
        signs = (1.0 - 2.0 * parity(idx & sign_mask[k])).to(psi.dtype)
        out = out + (weights[k] * iphase[k]) * signs * psi[..., idx ^ flip[k]]
    return out


def _generator_apply(psi, kind: int, t: int, c: int):
    """G_g |psi> for the generator of a rotation kind: X/Y/Z on the
    target, or the Pauli pair on (t, c) for RXX/RYY/RZZ.  A controlled
    1q rotation's generator is P restricted to the control-set subspace
    (c >= 0 and kind < RXX)."""
    dim = psi.shape[-1]
    idx = torch.arange(dim, device=psi.device)
    pair = kind >= _RXX
    axis = 0 if kind in (_RX, _RXX) else (1 if kind in (_RY, _RYY) else 2)
    m = (1 << t) | ((1 << c) if pair else 0)
    f = 0 if axis == 2 else m
    sm = 0 if axis == 0 else m
    signs = (1.0 - 2.0 * parity(idx & sm)).to(psi.dtype)
    ip = (-1.0 if pair else -1j) if axis == 1 else 1.0
    out = ip * signs * psi[..., idx ^ f]
    if c >= 0 and not pair:
        out = out * ((idx >> c) & 1).to(psi.dtype)
    return out


class _AdjointEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi0, x, tape, pauli):
        psi = apply_tape(psi0, *tape, x)
        e = pauli_expectation(psi, *pauli)
        ctx.tape = tape
        ctx.pauli = pauli
        ctx.save_for_backward(psi, x)
        return e

    @staticmethod
    def backward(ctx, ct):
        psi, x = ctx.saved_tensors
        kind, tq, cq, slot = (np.asarray(torch.as_tensor(a).cpu())
                              for a in ctx.tape)
        lam = apply_pauli_sum(psi, *ctx.pauli)
        # dE/dpsi* of the Rayleigh quotient: (H psi - E psi) / <psi|psi>.
        # The -E psi term adds nothing to the angle gradients (for a Pauli
        # generator, Im<psi|P|psi> = 0); it makes the psi0 gradient exact.
        n2 = torch.sum(psi.real ** 2 + psi.imag ** 2)
        e_val = torch.sum(torch.real(psi.conj() * lam)) / n2
        lam = (lam - e_val * psi) / n2
        grad = torch.zeros_like(x)
        p, l = psi, lam
        for g in reversed(range(len(kind))):
            k, t, c, s = int(kind[g]), int(tq[g]), int(cq[g]), int(slot[g])
            if k == int(GateKind.NONE):
                continue
            theta = x[s] if s >= 0 else torch.zeros((), dtype=x.dtype,
                                                    device=x.device)
            if s >= 0:
                pg = _generator_apply(p, k, t, c)
                grad[s] += torch.imag(torch.sum(l.conj() * pg))
            z = apply_gate(torch.stack([p, l]), k, t, c, -theta)
            p, l = z[0], z[1]
        # torch's convention for a real loss of a complex input: the
        # gradient is 2 dE/dpsi0^*
        return 2.0 * ct * l, ct * grad, None, None


def adjoint_energy(psi0, kind, tq, cq, slot, x, weights, flip, sign_mask,
                   iphase):
    """<psi(x)|H|psi(x)> / <psi(x)|psi(x)> for one angle vector x (R,),
    differentiable in x and psi0 through the adjoint sweep.  Same value
    as ``apply_tape`` + ``pauli_expectation``."""
    return _AdjointEnergy.apply(psi0, x, (kind, tq, cq, slot),
                                (weights, flip, sign_mask, iphase))
