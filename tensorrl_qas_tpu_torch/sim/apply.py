"""Eager statevector gate application (the port's oracle).

Plain PyTorch: one Python loop over the tape, each gate an (optionally
controlled) 2x2 unitary on the target bit applied through an XOR-partner
gather.  This is the slow, exact path the tests hold the CUDA kernel and
the JAX reference against; the training hot path runs the whole
optimization in one kernel launch instead (ops/fused_adam.py).

The statevector is little-endian: qubit q is bit q of the flat index.
Rotation signs follow qiskit: RX(t) = exp(-i t X / 2), etc.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind

_RXX, _RYY, _RZZ = int(GateKind.RXX), int(GateKind.RYY), int(GateKind.RZZ)


def zero_state(n_qubits: int, dtype=torch.complex128, device="cpu"):
    """|0...0> as a tensor."""
    psi = torch.zeros(1 << n_qubits, dtype=dtype, device=device)
    psi[0] = 1.0
    return psi


def gate_matrix(kind: int, theta):
    """2x2 unitary entries (u00, u01, u10, u11) for one gate kind.

    ``theta`` is a real tensor (any shape); the entries broadcast with it.
    Kinds without an angle ignore it.  RXX/RYY/RZZ are not 2x2 gates and
    go through ``_apply_two_pauli_rot``.
    """
    c = torch.cos(0.5 * theta)
    s = torch.sin(0.5 * theta)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    k = GateKind(kind)
    if k == GateKind.RX:
        return (c + 0j, -1j * s, -1j * s, c + 0j)
    if k == GateKind.RY:
        return (c + 0j, -s + 0j, s + 0j, c + 0j)
    if k == GateKind.RZ:
        return (c - 1j * s, zero + 0j, zero + 0j, c + 1j * s)
    if k in (GateKind.CX, GateKind.X):
        return (zero + 0j, one + 0j, one + 0j, zero + 0j)
    if k == GateKind.Y:
        return (zero + 0j, -1j * one, 1j * one, zero + 0j)
    if k == GateKind.Z:
        return (one + 0j, zero + 0j, zero + 0j, -one + 0j)
    if k == GateKind.H:
        r = one / math.sqrt(2.0)
        return (r + 0j, r + 0j, r + 0j, -r + 0j)
    return (one + 0j, zero + 0j, zero + 0j, one + 0j)


def _apply_controlled_1q(psi, u, target: int, control: int):
    """out[i] = u[b,b] psi[i] + u[b,1-b] psi[i ^ 2^t] where the control
    bit is set (all i when control < 0); b is the target bit of i."""
    dim = psi.shape[-1]
    idx = torch.arange(dim, device=psi.device)
    b = ((idx >> target) & 1).bool()
    u00, u01, u10, u11 = (x.to(psi.dtype)[..., None] for x in u)
    diag = torch.where(b, u11, u00)
    off = torch.where(b, u10, u01)
    out = diag * psi + off * psi[..., idx ^ (1 << target)]
    if control < 0:
        return out
    act = ((idx >> control) & 1).bool()
    return torch.where(act, out, psi)


def _apply_two_pauli_rot(psi, kind: int, theta, qa: int, qb: int):
    """exp(-i theta (P_a P_b) / 2) for the RXX/RYY/RZZ kinds."""
    dim = psi.shape[-1]
    idx = torch.arange(dim, device=psi.device)
    par = ((idx >> qa) & 1) ^ ((idx >> qb) & 1)
    sign = (1.0 - 2.0 * par).to(psi.dtype)
    if kind == _RZZ:
        pp = sign * psi
    else:
        flipped = psi[..., idx ^ ((1 << qa) | (1 << qb))]
        pp = flipped if kind == _RXX else -sign * flipped
    c = torch.cos(0.5 * theta).to(psi.dtype)[..., None]
    s = torch.sin(0.5 * theta).to(psi.dtype)[..., None]
    return c * psi - 1j * s * pp


def apply_gate(psi, kind: int, target: int, control: int, theta):
    """One tape gate on psi (..., D); theta broadcasts with psi[..., 0]."""
    if kind == int(GateKind.NONE):
        return psi
    if kind >= _RXX:
        return _apply_two_pauli_rot(psi, kind, theta, target, max(control, 0))
    return _apply_controlled_1q(psi, gate_matrix(kind, theta), target,
                                control)


def apply_tape(psi, kind, tq, cq, angle_slot, angles):
    """Apply a padded gate tape to statevector(s).

    Args:
      psi: (..., 2^n) complex tensor.
      kind, tq, cq, angle_slot: (G,) integer arrays (see GateTape).
      angles: (..., R) real tensor; rotation gate g reads
        ``angles[..., angle_slot[g]]``.  Leading dims broadcast with psi's.

    Returns the evolved statevector(s).
    """
    kind, tq, cq, slot = (np.asarray(torch.as_tensor(a).cpu())
                          for a in (kind, tq, cq, angle_slot))
    rdt = torch.float32 if psi.dtype == torch.complex64 else torch.float64
    angles = torch.as_tensor(angles, device=psi.device).to(rdt)
    zero = torch.zeros(angles.shape[:-1], dtype=rdt, device=psi.device)
    for g in range(len(kind)):
        s = int(slot[g])
        theta = angles[..., s] if s >= 0 else zero
        psi = apply_gate(psi, int(kind[g]), int(tq[g]), int(cq[g]), theta)
    return psi


def apply_tape_batched(psi0, kind, tq, cq, angle_slot, angles_batch):
    """(B, R) angle vectors sharing one initial state -> (B, 2^n) states."""
    psi = psi0.expand(angles_batch.shape[0], psi0.shape[-1])
    return apply_tape(psi, kind, tq, cq, angle_slot, angles_batch)
