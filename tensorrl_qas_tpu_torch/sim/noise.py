"""Depolarizing noise: trajectories, the counter-based draw, shot noise.

Counterpart of ``tensorrl_qas_tpu/sim/noise.py``.  Reference semantics
(``environments/VQAs/VQE_qulacs_noise.py:25-54``): a
TwoQubitDepolarizingNoise(p2) follows every CNOT and a
DepolarizingNoise(p1) every rotation; qulacs realizes them by trajectory
sampling, so each energy call returns one stochastic sample:

- after a rotation on q, with probability p1 one of X/Y/Z (uniform) on q;
- after a CX, with probability p2 one of the 15 non-identity Pauli pairs
  (uniform): code j in 1..15, Pauli ``j % 4`` on the target and ``j // 4``
  on the control (0 = none, 1..3 = X/Y/Z, i.e. gate kind ``X - 1 + code``).

Two sources of draws:

- ``sample_depolarizing_kinds`` / ``apply_tape_depolarizing`` draw from an
  explicit ``torch.Generator`` (eager trajectories, the quenched per-step
  realization of ``AngleOptimizer``);
- ``depolarizing_draw`` is THE draw of the fused Adam step, shared by the
  CUDA kernels (``csrc/philox.cuh``) and their plain versions
  (``ops/fused_adam.py``).  It is Philox4x32-10 (Salmon et al., SC'11;
  Random123's constants) with
      key     = (seeds[e, 0], seeds[e, 1]) as uint32,
      counter = (gate position g, tag, 0, 0),
  tag = ``it`` for Adam iteration ``it``, ``iters`` for the final
  re-check and ``iters + 1`` for e_new (the tags of
  ``tensorrl_qas_tpu/ops/pallas_opt.py:218/246/273``).  From the words
  w0, w1, w2: the gate's channel fires iff ``(w0 >> 8) < ceil(p 2^24)``
  (exactly ``u < p`` for the 24-bit uniform ``u = (w0 >> 8) 2^-24`` of the
  TPU kernels; the threshold is computed once in float64 on the host), and
  the codes are ``c3 = ((w1 >> 8) * 3 >> 24) + 1`` and
  ``c15 = ((w2 >> 8) * 15 >> 24) + 1``, in integers, so that no float
  rounding can split a kernel from its plain version.  All of an env's
  starts share its realization.  The TPU kernels draw from the TPU's own
  generator; no other device reproduces those bits, so the two agree in
  distribution only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.sim.apply import apply_gate

_RX, _RZ, _CX = int(GateKind.RX), int(GateKind.RZ), int(GateKind.CX)
_X, _Y, _Z = int(GateKind.X), int(GateKind.Y), int(GateKind.Z)

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10


# -- Philox4x32-10 over int64 tensors holding uint32 values ----------------

def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m, a in [0, 2^32), without the 64-bit
    product (which overflows int64): a = ah 2^16 + al."""
    t = (a & 0xFFFF) * m                          # < 2^48
    u = (a >> 16) * m + (t >> 16)                 # < 2^48 + 2^32
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(ctr, key, rounds: int = PHILOX_ROUNDS):
    """Philox4x32 on int64 tensors: ``ctr`` four words, ``key`` two, each
    broadcastable, values in [0, 2^32).  Returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c).long() & _MASK32 for c in ctr)
    k0, k1 = (torch.as_tensor(k).long() & _MASK32 for k in key)
    for r in range(rounds):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seeds, n_gates: int, tag: int):
    """The words (w0, w1, w2), each (E, G) int64, of the fused step's draw
    for every env e (key ``seeds[e]``) and gate position g < ``n_gates``
    (counter (g, tag, 0, 0))."""
    key = seeds.long() & _MASK32                              # (E, 2)
    g = torch.arange(n_gates, device=seeds.device)[None, :]
    zero = torch.zeros_like(g)
    return philox4x32((g, zero + tag, zero, zero),
                      (key[:, :1], key[:, 1:]))[:3]


def noise_thresholds(p1: float, p2: float):
    """Integer fire thresholds ceil(p 2^24) of the two channels."""
    return tuple(int(math.ceil(float(p) * (1 << 24))) for p in (p1, p2))


# -- from draws to error-gate kinds -----------------------------------------

def kinds_from_codes(kind, fire1, fire2, code3, code15):
    """(k_t, k_c) error-gate kinds after each gate (0 = none), from the
    channels' fire flags (for rotations / for CX) and codes (1..3 / 1..15);
    all tensors broadcast with ``kind``."""
    is_rot = (kind >= _RX) & (kind <= _RZ)
    f1 = is_rot & fire1
    f2 = (kind == _CX) & fire2
    zero = torch.zeros_like(kind)
    code_t = torch.where(f1, code3, torch.where(f2, code15 % 4, zero))
    code_c = torch.where(f2, code15 // 4, zero)

    def to_kind(code):
        return torch.where(code > 0, _X - 1 + code, zero)
    return to_kind(code_t), to_kind(code_c)


def depolarizing_draw(kind, seeds, tag: int, thresholds, draw=philox_words):
    """The fused step's error kinds (k_t, k_c), each (E, G), for tapes of
    kinds ``kind`` (E, G) at ``tag`` (module docstring).  ``draw`` gives
    the words; tests inject all-zero words to match the JAX kernels in
    interpret mode, whose generator returns zeros."""
    kind = kind.long()
    w0, w1, w2 = (w.long() for w in draw(seeds, kind.shape[-1], tag))
    u = w0 >> 8
    code3 = (((w1 >> 8) * 3) >> 24) + 1
    code15 = (((w2 >> 8) * 15) >> 24) + 1
    return kinds_from_codes(kind, u < thresholds[0], u < thresholds[1],
                            code3, code15)


def sample_depolarizing_kinds(kind, generator, p1: float, p2: float):
    """Per-gate depolarizing realization as error-gate kinds (k_t, k_c)
    shaped like ``kind``, drawn from ``generator`` (on ``kind``'s device);
    the distribution of ``tensorrl_qas_tpu/optim/angle_opt.py:
    sample_depolarizing_kinds``."""
    kind = torch.as_tensor(kind).long()
    kw = dict(generator=generator, device=kind.device)
    u = torch.rand(kind.shape, dtype=torch.float64, **kw)
    code3 = torch.randint(1, 4, kind.shape, **kw)
    code15 = torch.randint(1, 16, kind.shape, **kw)
    return kinds_from_codes(kind, u < p1, u < p2, code3, code15)


def apply_pauli(re, im, kind, q, transpose: bool = False):
    """Pauli ``kind`` (X/Y/Z; 0 or any other kind: identity) on qubit ``q``
    of the planes (..., D); ``kind`` and ``q`` broadcast with re[..., 0].
    ``transpose`` applies P^T (Y^T = -Y; X and Z are symmetric), which
    carries an adjoint cotangent back through P.  Exact: swaps and signs."""
    col = torch.arange(re.shape[-1], device=re.device)
    k = torch.as_tensor(kind, device=re.device)[..., None]
    q = torch.as_tensor(q, device=re.device)[..., None]
    sign = 1 - 2 * ((col >> q) & 1)
    is_y = k == _Y
    flip = (k == _X) | is_y
    idx = (col ^ (flip.long() << q)).expand(re.shape)
    pre, pim = re.gather(-1, idx), im.gather(-1, idx)
    pr = torch.where(is_y, 0, torch.where(k == _Z, sign, 1)).to(re.dtype)
    pi = torch.where(is_y, sign if transpose else -sign, 0).to(re.dtype)
    return pr * pre - pi * pim, pr * pim + pi * pre


# -- eager trajectories and shot noise --------------------------------------

def apply_tape_depolarizing(psi, kind, tq, cq, angle_slot, angles,
                            generator, p1: float, p2: float):
    """Apply a tape with a depolarizing error draw after every gate.

    psi: (..., D) complex; every leading row gets its own realization
    from ``generator`` (one row: one trajectory, as the JAX function).
    Tape arrays and ``angles`` as in ``sim.apply.apply_tape``.
    """
    kind, tq, cq, slot = (np.asarray(torch.as_tensor(a).cpu())
                          for a in (kind, tq, cq, angle_slot))
    rdt = torch.float32 if psi.dtype == torch.complex64 else torch.float64
    angles = torch.as_tensor(angles, device=psi.device).to(rdt)
    zero = torch.zeros(angles.shape[:-1], dtype=rdt, device=psi.device)
    lead = psi.shape[:-1]
    k_t, k_c = sample_depolarizing_kinds(
        torch.as_tensor(kind, device=psi.device).expand(*lead, len(kind)),
        generator, p1, p2)
    fired = torch.stack([k_t != 0, k_c != 0]).reshape(2, -1, len(kind))
    fired = fired.any(1).cpu()
    for g in range(len(kind)):
        s = int(slot[g])
        theta = angles[..., s] if s >= 0 else zero
        psi = apply_gate(psi, int(kind[g]), int(tq[g]), int(cq[g]), theta)
        for kk, q, f in ((k_t[..., g], int(tq[g]), fired[0, g]),
                         (k_c[..., g], max(int(cq[g]), 0), fired[1, g])):
            if f:
                psi = torch.complex(*apply_pauli(psi.real, psi.imag, kk, q))
    return psi


def shot_noise(weights, n_shots: int, generator):
    """Per-term Gaussian sampling noise sum_k w_k N(0, n_shots^-1/2)
    (reference ``VQE_qulacs_TN_notin_RL_noise_restricted.py:61-62,
    91-96``)."""
    eps = torch.randn(weights.shape[:1], generator=generator,
                      dtype=weights.dtype, device=weights.device)
    return torch.dot(weights, eps) * n_shots ** -0.5


def depolarizing_energy_exact(psi0, kind, tq, cq, angle_slot, angles,
                              h_dense, p1: float, p2: float) -> float:
    """Tr(H rho) for the exact channel that the trajectories sample: the
    density matrix of psi0 through the tape, with the 1-qubit channel
    (1 - p1) rho + p1/3 sum_P P rho P after each rotation and the 15-term
    2-qubit channel after each CX.  complex128, small n only (D x D)."""
    kind, tq, cq, slot = (np.asarray(torch.as_tensor(a).cpu())
                          for a in (kind, tq, cq, angle_slot))
    psi0 = torch.as_tensor(psi0, dtype=torch.complex128)
    angles = torch.as_tensor(angles, dtype=torch.float64)
    rho = psi0[:, None] * psi0.conj()[None, :]

    def left(m, k, t, c, theta):       # op @ m, op acting on the row index
        return apply_gate(m.transpose(0, 1), k, t, c, theta).transpose(0, 1)

    def conj(m, k, t, c, theta):       # op m op^H for Hermitian m
        a = left(m, k, t, c, theta)
        return left(a.conj().transpose(0, 1), k, t, c, theta)

    none = int(GateKind.NONE)
    zero = torch.zeros((), dtype=torch.float64)
    for g in range(len(kind)):
        k, t, c = int(kind[g]), int(tq[g]), int(cq[g])
        if k == none:
            continue
        theta = angles[int(slot[g])] if slot[g] >= 0 else zero
        rho = conj(rho, k, t, c, theta)
        if _RX <= k <= _RZ:
            mix = sum(conj(rho, pk, t, -1, zero) for pk in (_X, _Y, _Z))
            rho = (1 - p1) * rho + (p1 / 3) * mix
        elif k == _CX:
            mix = 0
            for ka in (none, _X, _Y, _Z):
                for kb in (none, _X, _Y, _Z):
                    if ka == none and kb == none:
                        continue
                    mix = mix + conj(conj(rho, ka, c, -1, zero), kb, t, -1,
                                     zero)
            rho = (1 - p2) * rho + (p2 / 15) * mix
    h = torch.as_tensor(h_dense, dtype=torch.complex128)
    return float(torch.real(torch.trace(h @ rho)))
