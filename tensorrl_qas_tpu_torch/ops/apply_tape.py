"""Each env's own gate tape applied to its block of states, forward and
adjoint: the composed engine's two kernels.

Counterpart of ``tensorrl_qas_tpu/ops/pallas_apply.py``.  Env e applies
its tape (row e of kind / tq / cq / slot, (E, G) int32) to its (S, D)
block of float re / im planes, with an angle vector per row (angles
(E, S, R)):

    psi[e, s] <- tape_e(angles[e, s]) psi[e, s]

over every gate kind of ``circuits/tape.py``: the 1-qubit gates (RX, RY,
RZ, X, Y, Z, H; controlled when cq >= 0), CX, and the su4 gate set's
two-qubit Pauli rotations RXX / RYY / RZZ, for which cq is the SECOND
QUBIT of the rotation, not a control.  A gate reads angles[..., slot] when
slot >= 0, angle 0 otherwise.

The adjoint pass (``custom_vjp`` of the JAX function
``apply_tape_pallas_ri``) starts from the forward OUTPUT planes and the
real-plane cotangents (gre, gim).  The complex cotangent is lambda =
gre - i gim (d theta = Re[(d psi / d theta)^T lambda]); each gate, last
first, adds 1/2 Im[(P psi)^T lambda] to dang[e, s, slot] (P its generator,
psi the state after it; skipped for slot < 0), is undone on psi (U^H) and
carries lambda back (U^T).  It returns the psi0 cotangents in the same
real-plane convention, (Re lambda, -Im lambda), and dang.

``apply_tape_fwd`` / ``apply_tape_bwd`` launch the CUDA kernels of
``csrc/apply_tape.cu`` on CUDA tensors (float32) and run
``apply_tape_fwd_plain`` / ``apply_tape_bwd_plain``, the plain PyTorch
versions of the same arithmetic, on CPU tensors; ``ApplyTape`` is the
``torch.autograd.Function`` over the two, which saves the output planes,
not one state per gate.  Up to 9 qubits the register kernels read the
tapes as given; from 10 the wide kernels read a schedule of each tape
(where every qubit sits as the gates go, the swaps that bring a gate's
qubits into registers or lanes), which ``tape_schedule`` builds on the
card once for all the launches on those tapes -- a composed step makes
iters + 2 forward and iters adjoint launches on two tapes -- and whose
plain twin is ``tape_schedule_plain``.  Tapes woven with error Paulis
(``optim/angle_opt.py:extend_tape_arrays``, ``weave`` 3) are read under
the schedule of their noiseless gates.  Each wrapper counts its launches
(``launches``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops.fused_adam import (
    _coeff_basis,
    check_smem,
    launch,
)

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_RXX, _RYY, _RZZ = int(GateKind.RXX), int(GateKind.RYY), int(GateKind.RZZ)

MAX_QUBITS = 16          # the JAX composed path's ceiling (D <= 65536)
# where the work above that ceiling is queued
ABOVE_CAP = "ROADMAP.md, A6: the composed engine above 16 qubits"
WIDE_MIN_QUBITS = 10     # the wide kernels, which read a schedule, from here


# -- plain PyTorch version ---------------------------------------------------

class _Gate:
    """Gate position g of a batch of tapes at angles (E, S, R), as
    psi'[i] = d[i] psi[i] + f[i] psi[p[i]] where ``act`` (a controlled
    1-qubit gate's control bit), and its generator as
    (P psi)[i] = gd[i] psi[i] + gf[i] psi[p[i]].  Complex coefficients are
    (re, im) pairs of (E, S, D) or (E, 1, D) tensors."""

    def __init__(self, tape, g, angles, col):
        kind, tq, cq, slot = (a[:, g].long().view(-1, 1, 1) for a in tape)
        self.slot = slot.view(-1)
        self.has_grad = ((kind >= _RX) & (kind <= _RZ)) | (kind >= _RXX)
        s = slot.clamp(min=0).expand(-1, angles.shape[1], 1)
        theta = torch.where(slot >= 0, angles.gather(2, s), 0.0)
        cos, sin = torch.cos(0.5 * theta), torch.sin(0.5 * theta)
        two_q = kind >= _RXX
        c2 = cq.clamp(min=0)
        bt = (col >> tq) & 1
        bc = (col >> c2) & 1
        b0 = bt == 0
        self.partner = col ^ (1 << tq) ^ torch.where(
            two_q & (kind != _RZZ), 1 << c2, 0)
        self.act = two_q | (cq < 0) | (bc == 1)
        one, zero = torch.ones_like(theta), torch.zeros_like(theta)
        sgn = (1 - 2 * bt).to(theta.dtype)            # (-1)^(bit t)
        z = (1 - 2 * (bt ^ bc)).to(theta.dtype)       # ZZ eigenvalue
        # 1-qubit kinds: the 2x2 unitary's entries (kinds beyond H get the
        # identity's, and are overwritten below)
        k1 = torch.where(two_q, 0, kind).view(-1, 1)
        basis = _coeff_basis(k1, theta.dtype)
        u = [a * cos + b * sin + c
             for a, b, c in zip(*basis)]              # 8 x (E, S, 1)
        dr = torch.where(b0, u[0], u[6])
        di = torch.where(b0, u[1], u[7])
        fr = torch.where(b0, u[2], u[4])
        fi = torch.where(b0, u[3], u[5])
        # RZZ: gd = z; RXX: gf = 1; RYY: gf = -z; U = cos - i sin (P)
        gd2 = torch.where(kind == _RZZ, z, 0.0)
        gf2 = torch.where(kind == _RXX, 1.0, torch.where(kind == _RYY, -z,
                                                         0.0))
        self.d = (torch.where(two_q, cos * one, dr),
                  torch.where(two_q, -sin * gd2, di))
        self.f = (torch.where(two_q, zero, fr),
                  torch.where(two_q, -sin * gf2, fi))
        # generators of RX (X), RY (Y: -i (-1)^b on the partner), RZ (Z)
        self.gd = torch.where(two_q, gd2, torch.where(kind == _RZ, sgn, 0.0))
        self.gf = (torch.where(two_q, gf2, torch.where(kind == _RX, 1.0,
                                                       0.0)),
                   torch.where(kind == _RY, -sgn, 0.0))

    def apply(self, re, im, d, f):
        """d psi + f psi[p] where act, psi elsewhere."""
        idx = self.partner.expand(re.shape)
        pre, pim = re.gather(2, idx), im.gather(2, idx)
        nre = d[0] * re - d[1] * im + f[0] * pre - f[1] * pim
        nim = d[0] * im + d[1] * re + f[0] * pim + f[1] * pre
        return torch.where(self.act, nre, re), torch.where(self.act, nim, im)

    def at_partner(self, c):
        """c[p[i]] of a coefficient pair."""
        idx = self.partner.expand(*c[0].shape[:2], -1)
        return tuple(x.expand(idx.shape).gather(2, idx) for x in c)


def _live(kind):
    """Tape positions that hold a gate in some env (NONE is the identity)."""
    return (kind != 0).any(dim=0).nonzero().flatten().tolist()


def apply_tape_fwd_plain(re, im, kind, tq, cq, slot, angles):
    """B3f in plain PyTorch: (E, S, D) planes of any float dtype, (E, G)
    integer tapes, (E, S, R) angles -> the output planes."""
    col = torch.arange(re.shape[-1], device=re.device)
    tape = (kind, tq, cq, slot)
    for g in _live(kind):
        gate = _Gate(tape, g, angles, col)
        re, im = gate.apply(re, im, gate.d, gate.f)
    return re, im


def apply_tape_bwd_plain(ore, oim, gre, gim, kind, tq, cq, slot, angles):
    """B3b in plain PyTorch: from the forward output planes and the
    real-plane cotangents (gre, gim) -> (dre, dim, dang), the psi0
    cotangents (Re lambda, -Im lambda) and the angle gradients (E, S, R)."""
    col = torch.arange(ore.shape[-1], device=ore.device)
    tape = (kind, tq, cq, slot)
    re, im, lre, lim = ore, oim, gre, -gim
    dang = torch.zeros_like(angles)
    for g in reversed(_live(kind)):
        gate = _Gate(tape, g, angles, col)
        idx = gate.partner.expand(re.shape)
        pre, pim = re.gather(2, idx), im.gather(2, idx)
        qr = gate.gd * re + gate.gf[0] * pre - gate.gf[1] * pim   # P psi
        qi = gate.gd * im + gate.gf[0] * pim + gate.gf[1] * pre
        row = 0.5 * torch.sum(torch.where(gate.act, qr * lim + qi * lre, 0.0),
                              dim=-1)                             # (E, S)
        row = torch.where(gate.has_grad.view(-1, 1) & (gate.slot >= 0)
                          .view(-1, 1), row, 0.0)
        sidx = gate.slot.clamp(min=0).view(-1, 1, 1).expand(*row.shape, 1)
        dang.scatter_add_(2, sidx, row[..., None])
        fp = gate.at_partner(gate.f)
        re, im = gate.apply(re, im, (gate.d[0], -gate.d[1]),
                            (fp[0], -fp[1]))                      # U^H
        lre, lim = gate.apply(lre, lim, gate.d, fp)               # U^T
    return lre, -lim, dang


# -- the wide kernels' schedule (10-16 qubits) -------------------------------

# csrc/apply_tape.cu's constants: a schedule row's header words and map
# width, the swap op's kind, the gradient bit, the cases past
# regs.cuh:gate_case, and the layout (4 register bits, 5 lane bits holding
# logical qubits 0..4, warp and cluster bits above)
SCHED_HEADER, MAP_WORDS = 36, 16
SWAP_OP, GRAD_BIT = 15, 1 << 14
_CASE_RZZ, _CASE_ROT2 = 30, 32
_RB, _LANES = 4, 5
FIRST_WARP_BIT = _RB + _LANES


def schedule_words(g: int, r: int) -> int:
    """Words of one env's schedule row for G gates and R angles."""
    return (SCHED_HEADER + 12 * g + r + g + 3) & ~3


def _local_needs(k, t, c):
    """The qubits gate (k, t, c) needs on a register or lane bit."""
    if k in (0, _RZZ):
        return ()
    return (t, c) if k in (_RXX, _RYY) else (t,)


def _op_case(k, p, q, rb=_RB):
    """The case an op dispatches on (apply_tape.cu:op_case)."""
    if k == _RZZ:
        return _CASE_RZZ
    if k >= _RXX:
        m = (1 << p) | (1 << q)
        return _CASE_ROT2 + (m & ((1 << rb) - 1)) + (16 if m >> rb else 0)
    form = 0 if k in (_RZ, int(GateKind.Z)) else (
        2 if k in (_RX, int(GateKind.Y)) else 1)
    return 10 * form + 5 * (q >= 0) + (p if p < rb else 4)


def _has_grad(k, sl):
    return k != 0 and sl >= 0 and (_RX <= k <= _RZ or k >= _RXX)


def tape_schedule_plain(kind, tq, cq, slot, n: int, r: int):
    """The wide kernels' schedule of (E, G) integer tapes with R = ``r``
    angles at ``n`` qubits, as ``csrc/apply_tape.cu:build_wide_schedule``
    writes it (its twin: the same rows word for word) -> (E,
    schedule_words(G, r)) int32 numpy.

    A row: [0] the op count, [1, 17) map0 (the logical qubit at each
    physical bit where the forward pass begins), [17, 33) map1 (where it
    ends), [33] n; from word 36 the ops, 4 words each, (bits, case, slot,
    gate); then each angle's last gradient gate and each gate's previous
    one of the same angle.  Lane bits (physical 4..8) hold qubits 0..4 for
    good; the register bits (0..3) start with the four other qubits needed
    first, the warp and cluster bits (from 9) with the rest in ascending
    order.  Before each gate, every qubit it needs on a register or lane
    bit (a 1-qubit gate's or CX's target, both qubits of RXX / RYY; none
    for RZZ) that sits higher is swapped into the register bit whose qubit
    is needed furthest ahead (ties: the lowest), never one the gate
    needs."""
    kind, tq, cq, slot = (np.asarray(torch.as_tensor(a).cpu(), np.int64)
                          for a in (kind, tq, cq, slot))
    n_env, g_n = kind.shape
    out = np.zeros((n_env, schedule_words(g_n, r)), np.int32)
    for e in range(n_env):
        out[e] = _schedule_row(*(a[e].tolist() for a in (kind, tq, cq, slot)),
                               n, r, out.shape[1])
    return out


def _schedule_row(kind, tq, cq, slot, n, r, words):
    g_n = len(kind)
    row = [0] * words
    first = [g_n] * n
    after = [[g_n, g_n] for _ in range(g_n)]
    for g in reversed(range(g_n)):
        for j, q in enumerate(_local_needs(kind[g], tq[g], cq[g])):
            after[g][j] = first[q]
            first[q] = g
    occ = [0] * n
    placed = set()
    for a in range(_RB):
        best = -1
        for q in range(_LANES, n):
            if q not in placed and (best < 0 or first[q] < first[best]):
                best = q
        occ[a] = best
        placed.add(best)
    for lane in range(_LANES):
        occ[_RB + lane] = lane
    rest = [q for q in range(_LANES, n) if q not in placed]
    occ[FIRST_WARP_BIT:] = rest
    pos = [0] * n
    for p, q in enumerate(occ):
        pos[q] = p
    row[1:1 + n] = occ
    nu = list(first)
    ops = []
    for g in range(g_n):
        k = kind[g]
        if k == 0:
            continue
        need = _local_needs(k, tq[g], cq[g])
        for q in need:
            b = pos[q]
            if b < FIRST_WARP_BIT:
                continue
            a = -1
            for reg in range(_RB):
                if occ[reg] in need:
                    continue
                if a < 0 or nu[occ[reg]] > nu[occ[a]]:
                    a = reg
            qa = occ[a]
            ops.append((SWAP_OP | (a << 4) | ((b + 1) << 9), 0, -1, g))
            occ[a], occ[b] = q, qa
            pos[q], pos[qa] = a, b
        p = pos[tq[g]]
        qq = pos[cq[g]] if cq[g] >= 0 else -1
        ops.append((k | (p << 4) | ((qq + 1) << 9)
                    | (GRAD_BIT if _has_grad(k, slot[g]) else 0),
                    _op_case(k, p, qq), slot[g], g))
        for j, q in enumerate(need):
            nu[q] = after[g][j]
    row[0] = len(ops)
    row[1 + MAP_WORDS:1 + MAP_WORDS + n] = occ
    row[1 + 2 * MAP_WORDS] = n
    for i, op in enumerate(ops):
        row[SCHED_HEADER + 4 * i:SCHED_HEADER + 4 * i + 4] = op
    sfirst = SCHED_HEADER + 12 * g_n
    gnext = sfirst + r
    row[sfirst:sfirst + r] = [-1] * r
    for g in range(g_n):
        grad = _has_grad(kind[g], slot[g])
        row[gnext + g] = row[sfirst + slot[g]] if grad else -1
        if grad:
            row[sfirst + slot[g]] = g
    return row


def schedule_ops(row):
    """A schedule row's ops as (kind, a, b, gate) tuples: a swap (kind
    SWAP_OP) of register bit a with warp or cluster bit b, or gate ``gate``
    with its target on physical bit a and its control (second qubit) on b
    (-1: none); and (map0, map1), each physical bit's logical qubit."""
    row = [int(v) for v in row]
    n = row[1 + 2 * MAP_WORDS]
    ops = []
    for i in range(row[0]):
        x, _, _, g = row[SCHED_HEADER + 4 * i:SCHED_HEADER + 4 * i + 4]
        ops.append((x & 15, (x >> 4) & 31, ((x >> 9) & 31) - 1, g))
    return ops, row[1:1 + n], row[1 + MAP_WORDS:1 + MAP_WORDS + n]


# -- CUDA kernels ------------------------------------------------------------

_I32 = ctypes.c_int
_PTR = ctypes.c_void_p


@functools.cache
def _library():
    """The kernels' library (built at first use) with its C signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load

    return bind(load("apply_tape"))


def bind(lib):
    """Set the C signatures of the tape kernels' library ``lib``."""
    lib.apply_tape_fwd_launch.argtypes = [_PTR] * 10 + [_I32] * 7 + [_PTR]
    lib.apply_tape_bwd_launch.argtypes = [_PTR] * 13 + [_I32] * 7 + [_PTR]
    lib.apply_tape_schedule_launch.argtypes = [_PTR] * 5 + [_I32] * 4 + [
        _PTR]
    for fn in (lib.apply_tape_fwd_launch, lib.apply_tape_bwd_launch,
               lib.apply_tape_schedule_launch):
        fn.restype = _I32
    for fn in (lib.apply_tape_fwd_smem_bytes, lib.apply_tape_bwd_smem_bytes):
        fn.argtypes = [_I32] * 5
        fn.restype = ctypes.c_size_t
    lib.apply_tape_schedule_words.argtypes = [_I32] * 2
    lib.apply_tape_error_string.argtypes = [_I32]
    lib.apply_tape_error_string.restype = ctypes.c_char_p
    return lib


def check_tapes(kind, tq, cq, slot, n: int, r: int) -> None:
    """Values a kernel indexes with (one host read): kinds NONE..RZZ,
    targets in [0, n), controls / second qubits in [-1, n) and not the
    target (a two-qubit rotation needs its second qubit), slots in
    [-1, r)."""
    two_q = kind >= _RXX
    bad = ((kind < 0) | (kind > _RZZ)).any()
    bad |= ((tq < 0) | (tq >= n)).any()
    bad |= ((cq < -1) | (cq >= n) | (cq == tq) | (two_q & (cq < 0))).any()
    bad |= ((slot < -1) | (slot >= r)).any()
    if bool(bad):
        raise ValueError(
            f"apply_tape: kinds must lie in [0, {_RZZ}], qubits in [0, {n}), "
            f"controls in [-1, {n}) and not the target (two-qubit rotations "
            f"need a second qubit), slots in [-1, {r})")


def _check(name, planes, tape, angles, tapes_checked, schedule, weave):
    """The wrappers' input checks on CUDA tensors -> (E, S, G, R, n)."""
    dev = angles.device
    for t in (*planes, *tape, angles):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.dtype != torch.int32 for t in tape):
        raise TypeError(f"{name}: tapes must be int32")
    if any(t.dtype != torch.float32 for t in (*planes, angles)):
        raise TypeError(f"{name}: the CUDA kernel takes float32 planes and "
                        "angles")
    n_env, s_n, r = angles.shape
    d = planes[0].shape[-1]
    n = d.bit_length() - 1
    if d < 2 or d != 1 << n or any(p.shape != (n_env, s_n, d)
                                   for p in planes):
        raise ValueError(f"{name}: planes must be (E, S, D), D a power of "
                         "two, and angles (E, S, R)")
    if n > MAX_QUBITS:
        raise ValueError(f"{name}: {n} qubits; the composed engine takes at "
                         f"most {MAX_QUBITS} ({ABOVE_CAP})")
    g = tape[0].shape[-1]
    if any(t.shape != (n_env, g) for t in tape):
        raise ValueError(f"{name}: tapes must all be (E, G)")
    if weave not in (1, 3) or g % weave:
        raise ValueError(f"{name}: weave must be 1 or 3 (a tape of 3 G "
                         "woven positions)")
    if schedule is not None:
        es = schedule.shape[0]
        if (schedule.dtype != torch.int32 or schedule.device != dev
                or not schedule.is_contiguous() or n_env % es
                or schedule.shape[1:] != (schedule_words(g // weave, r),)):
            raise ValueError(f"{name}: the schedule must be a contiguous "
                             "int32 (E_s, schedule_words(G, R)) tensor on "
                             f"{dev}, E a multiple of E_s")
    elif weave != 1 and n >= WIDE_MIN_QUBITS:
        raise ValueError(f"{name}: a woven tape needs its gates' schedule")
    if not tapes_checked:
        check_tapes(*tape, n, r)
    return n_env, s_n, g, r, n



def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _dims(plane, tape, angles):
    """(E, S, G, R, n) of a launch's inputs."""
    n_env, s_n, r = angles.shape
    return n_env, s_n, tape[0].shape[-1], r, plane.shape[-1].bit_length() - 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def run_schedule(lib, tape, n: int, r: int, *, stream=None):
    """One schedule launch of ``lib`` on checked (E, G) tapes (not counted)
    -> (E, schedule_words(G, r)) int32 on the tapes' device."""
    n_env, g = tape[0].shape
    out = torch.empty((n_env, schedule_words(g, r)), dtype=torch.int32,
                      device=tape[0].device)
    launch(lib, "apply_tape_schedule", *(t.data_ptr() for t in tape),
           out.data_ptr(), n_env, g, r, n, stream)
    return out


def _wide_args(lib, tape, n, r, schedule, weave, stream):
    """(schedule, E_s, weave, G) of a launch: from 10 qubits the schedule
    (built here when not given, for an unwoven tape), below it none, and
    the tape read as given."""
    g = tape[0].shape[-1]
    if n < WIDE_MIN_QUBITS:
        return None, 0, 1, g
    if schedule is None:
        if weave != 1:
            raise ValueError("a woven tape needs its gates' schedule")
        schedule = run_schedule(lib, tape, n, r, stream=stream)
    return schedule, schedule.shape[0], weave, g // weave


def run_fwd(lib, re, im, tape, angles, *, schedule=None, weave=1,
            stream=None):
    """One B3f launch of ``lib`` on checked inputs (the wrapper's, or a
    timing's; not counted) -> (ore, oim).  From 10 qubits it reads
    ``schedule`` (``tape_schedule`` of the tapes' gates; built here when
    not given) and ``weave`` (3: the tapes are ``extend_tape_arrays``'
    woven ones)."""
    n_env, s_n, _, r, n = _dims(re, tape, angles)
    sched, es, weave, g = _wide_args(lib, tape, n, r, schedule, weave,
                                     stream)
    check_smem("apply_tape_fwd",
               lib.apply_tape_fwd_smem_bytes(s_n, g, r, n, weave), "CTA")
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    launch(lib, "apply_tape_fwd", *(t.data_ptr() for t in tape),
           angles.data_ptr(), re.data_ptr(), im.data_ptr(), ore.data_ptr(),
           oim.data_ptr(), _ptr(sched), es, weave, n_env, s_n, g, r, n,
           stream)
    return ore, oim


def run_bwd(lib, ore, oim, gre, gim, tape, angles, *, psi0_grad=True,
            schedule=None, weave=1, stream=None):
    """One B3b launch of ``lib`` on checked inputs (not counted) -> (dre,
    dim, dang); without ``psi0_grad`` no psi0 cotangents are written and
    (None, None, dang) is returned.  ``schedule`` and ``weave`` as
    ``run_fwd``'s."""
    n_env, s_n, _, r, n = _dims(ore, tape, angles)
    sched, es, weave, g = _wide_args(lib, tape, n, r, schedule, weave,
                                     stream)
    check_smem("apply_tape_bwd",
               lib.apply_tape_bwd_smem_bytes(s_n, g, r, n, weave), "CTA")
    dre, dim = ((torch.empty_like(ore), torch.empty_like(oim)) if psi0_grad
                else (None, None))
    dang = torch.empty_like(angles)
    launch(lib, "apply_tape_bwd", *(t.data_ptr() for t in tape),
           angles.data_ptr(), ore.data_ptr(), oim.data_ptr(), gre.data_ptr(),
           gim.data_ptr(), _ptr(dre), _ptr(dim), dang.data_ptr(),
           _ptr(sched), es, weave, n_env, s_n, g, r, n, stream)
    return dre, dim, dang


def tape_schedule(kind, tq, cq, slot, n: int, r: int):
    """The wide kernels' schedule of (E, G) int32 tapes with ``r`` angles at
    ``n`` qubits, for the forward and adjoint launches on those tapes (or
    their woven extensions) to read: one launch of the schedule kernel on
    CUDA tensors from 10 qubits (counted in ``tape_schedule.launches``),
    None where no kernel reads one (CPU tensors, below 10 qubits)."""
    if kind.device.type != "cuda" or n < WIDE_MIN_QUBITS:
        return None
    out = run_schedule(_library(), (kind, tq, cq, slot), n, r,
                       stream=_stream(kind.device))
    tape_schedule.launches += 1
    return out


def apply_tape_fwd(re, im, kind, tq, cq, slot, angles, *,
                   tapes_checked: bool = False, schedule=None,
                   weave: int = 1):
    """B3f: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``tapes_checked``: the caller has run ``check_tapes`` on
    these tapes (saves a host read per launch).  From 10 qubits the kernel
    reads ``schedule`` (``tape_schedule`` of the tapes, or of the gates of
    woven tapes, ``weave`` 3; made here for an unwoven tape when not
    given).  Counts launches in ``apply_tape_fwd.launches``."""
    if angles.device.type == "cpu":
        return apply_tape_fwd_plain(re, im, kind, tq, cq, slot, angles)
    if angles.device.type != "cuda":
        raise ValueError(f"apply_tape_fwd: no kernel for device "
                         f"{angles.device}")
    tape = (kind, tq, cq, slot)
    _, _, _, r, n = _check("apply_tape_fwd", (re, im), tape, angles,
                           tapes_checked, schedule, weave)
    if schedule is None:
        schedule = tape_schedule(*tape, n, r)
    out = run_fwd(_library(), re, im, tape, angles, schedule=schedule,
                  weave=weave, stream=_stream(angles.device))
    apply_tape_fwd.launches += 1
    return out


def apply_tape_bwd(ore, oim, gre, gim, kind, tq, cq, slot, angles, *,
                   tapes_checked: bool = False, psi0_grad: bool = True,
                   schedule=None, weave: int = 1):
    """B3b: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; -> (dre, dim, dang), (None, None, dang) without
    ``psi0_grad``; ``schedule`` and ``weave`` as ``apply_tape_fwd``'s.
    Counts launches in ``apply_tape_bwd.launches``."""
    if angles.device.type == "cpu":
        dre, dim, dang = apply_tape_bwd_plain(ore, oim, gre, gim, kind, tq,
                                              cq, slot, angles)
        return (dre, dim, dang) if psi0_grad else (None, None, dang)
    if angles.device.type != "cuda":
        raise ValueError(f"apply_tape_bwd: no kernel for device "
                         f"{angles.device}")
    tape = (kind, tq, cq, slot)
    _, _, _, r, n = _check("apply_tape_bwd", (ore, oim, gre, gim), tape,
                           angles, tapes_checked, schedule, weave)
    if schedule is None:
        schedule = tape_schedule(*tape, n, r)
    out = run_bwd(_library(), ore, oim, gre, gim, tape, angles,
                  psi0_grad=psi0_grad, schedule=schedule, weave=weave,
                  stream=_stream(angles.device))
    apply_tape_bwd.launches += 1
    return out


apply_tape_fwd.launches = 0
apply_tape_bwd.launches = 0
tape_schedule.launches = 0


class ApplyTape(torch.autograd.Function):
    """(re, im, kind, tq, cq, slot, angles, plain, tapes_checked, schedule,
    weave) -> (ore, oim) with B3f, and B3b as its backward; ``plain`` runs
    the plain versions on any device (the card check's reference), which
    read a woven tape's errors as gates and need no schedule."""

    @staticmethod
    def forward(ctx, re, im, kind, tq, cq, slot, angles, plain=False,
                tapes_checked=False, schedule=None, weave=1):
        if plain:
            ore, oim = apply_tape_fwd_plain(re, im, kind, tq, cq, slot,
                                            angles)
        else:
            ore, oim = apply_tape_fwd(re, im, kind, tq, cq, slot, angles,
                                      tapes_checked=tapes_checked,
                                      schedule=schedule, weave=weave)
        ctx.save_for_backward(ore, oim, kind, tq, cq, slot, angles)
        ctx.plain = plain
        ctx.tapes_checked = tapes_checked
        ctx.schedule = schedule
        ctx.weave = weave
        return ore, oim

    @staticmethod
    def backward(ctx, gre, gim):
        ore, oim, kind, tq, cq, slot, angles = ctx.saved_tensors
        gre = torch.zeros_like(ore) if gre is None else gre.contiguous()
        gim = torch.zeros_like(oim) if gim is None else gim.contiguous()
        # the psi0 cotangents only where someone reads them (the composed
        # engine's psi0 planes carry no gradient)
        psi0_grad = any(ctx.needs_input_grad[:2])
        if ctx.plain:
            dre, dim, dang = apply_tape_bwd_plain(ore, oim, gre, gim, kind,
                                                  tq, cq, slot, angles)
        else:
            dre, dim, dang = apply_tape_bwd(ore, oim, gre, gim, kind, tq, cq,
                                            slot, angles,
                                            tapes_checked=ctx.tapes_checked,
                                            psi0_grad=psi0_grad,
                                            schedule=ctx.schedule,
                                            weave=ctx.weave)
        if not psi0_grad:
            dre = dim = None
        return (dre, dim, None, None, None, None, dang, None, None, None,
                None)


def apply_tape_ri(re, im, kind, tq, cq, slot, angles, *, plain=False,
                  tapes_checked=False, schedule=None, weave=1):
    """Differentiable tape application on re / im planes (the port's
    ``apply_tape_pallas_ri``): (E, S, D) planes, (E, G) tapes, (E, S, R)
    angles; ``schedule`` and ``weave`` as ``apply_tape_fwd``'s."""
    return ApplyTape.apply(re, im, kind, tq, cq, slot, angles, plain,
                           tapes_checked, schedule, weave)
