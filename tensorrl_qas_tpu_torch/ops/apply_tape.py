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
``csrc/apply_tape.cu`` on CUDA tensors (float32; float64 planes go to
``csrc/apply_tape_f64.cu``, below) and run
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
the schedule of their noiseless gates.  From 17 to 20 qubits the sweep
kernels of ``csrc/apply_tape_sweep.cu`` take over: every row stays in
device memory and the tape is applied segment by segment (one launch a
call: a persistent grid walks every segment of every row, chunk by
chunk), under a schedule of segments (``tape_schedule``, the rule of
``ops/fused_adam2d.py:sweep_segments``, which is its twin word for word).
Float64 planes and angles (``EnvConfig.sim_dtype = 'complex128'`` on the
card) go to the double-precision kernels of ``csrc/apply_tape_f64.cu`` at
1-20 qubits: the sweep kernels' body (``csrc/tape_sweep.cuh``) in double,
with a chunk of min(n, 12) qubits, so a row of up to 12 qubits is one
chunk and a call one launch with no schedule; above, segments of the same
rule (``tape_schedule(..., dtype=float64)``).  One set of bindings
(``SweepLibrary``, ``run_sweep_*``) drives either instance.
Each wrapper counts its launches (``launches``; ``sweep_launches`` those
that went to the sweep kernels, ``f64_launches`` those that went to the
double-precision ones).
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

# the composed engine's ceiling, as the fused engine's (the JAX package's
# Pallas composed path stops at 16 qubits, D <= 65536, and runs the same
# modes through XLA above it); more qubits run on the sharded path
MAX_QUBITS = 20
ABOVE_CAP = ("EnvConfig.mesh_shape runs more on the sharded path "
             "(optim/sharded_opt.py), a (1, 1) mesh included")
WIDE_MIN_QUBITS = 10     # the wide kernels, which read a schedule, from here
SWEEP_MIN_QUBITS = 17    # the sweep kernels (csrc/apply_tape_sweep.cu)
KERNEL_DTYPES = (torch.float32, torch.float64)


# -- plain PyTorch version ---------------------------------------------------

class _Tape:
    """A batch of tapes at angles (E, S, R), the parts of every gate that
    are not planes, made at once: (E, 1, G) kinds, qubits and slots, and
    (E, S, G) cos and sin of the half angles and the 2x2 unitary entries
    of the 1-qubit kinds (``u``, 8 (re, im) parts).  A gate then takes
    slices of them (``_Gate``): the plain version's time is mostly the
    host's cost of its many small operations."""

    def __init__(self, tape, angles):
        self.kind, self.tq, self.cq, self.slot = (a.long()[:, None, :]
                                                  for a in tape)
        s = self.slot.clamp(min=0).expand(-1, angles.shape[1], -1)
        theta = torch.where(self.slot >= 0, angles.gather(2, s), 0.0)
        self.cos, self.sin = torch.cos(0.5 * theta), torch.sin(0.5 * theta)
        self.two_q = self.kind >= _RXX
        self.has_grad = (((self.kind >= _RX) & (self.kind <= _RZ))
                         | self.two_q)
        # 1-qubit kinds: the 2x2 unitary's entries (kinds beyond H get the
        # identity's, and are overwritten in _Gate)
        k1 = torch.where(self.two_q, 0, self.kind)[:, 0, :]
        self.u = [a * self.cos + b * self.sin + c
                  for a, b, c in zip(*_coeff_basis(k1, theta.dtype))]


class _Gate:
    """Gate position g of a ``_Tape``, as psi'[i] = d[i] psi[i] + f[i]
    psi[p[i]] where ``act`` (a controlled 1-qubit gate's control bit), and
    its generator as (P psi)[i] = gd[i] psi[i] + gf[i] psi[p[i]].  Complex
    coefficients are (re, im) pairs of (E, S, D) or (E, 1, D) tensors."""

    def __init__(self, tape, g, col):
        at = slice(g, g + 1)
        kind, tq, cq = (a[..., at] for a in (tape.kind, tape.tq, tape.cq))
        self.slot = tape.slot[:, 0, g]
        self.has_grad = tape.has_grad[..., at]
        cos, sin, two_q = (a[..., at] for a in (tape.cos, tape.sin,
                                                 tape.two_q))
        c2 = cq.clamp(min=0)
        bt = (col >> tq) & 1
        bc = (col >> c2) & 1
        b0 = bt == 0
        self.partner = col ^ (1 << tq) ^ torch.where(
            two_q & (kind != _RZZ), 1 << c2, 0)
        self.act = two_q | (cq < 0) | (bc == 1)
        sgn = (1 - 2 * bt).to(cos.dtype)              # (-1)^(bit t)
        z = (1 - 2 * (bt ^ bc)).to(cos.dtype)         # ZZ eigenvalue
        u = [p[..., at] for p in tape.u]              # 8 x (E, S, 1)
        dr = torch.where(b0, u[0], u[6])
        di = torch.where(b0, u[1], u[7])
        fr = torch.where(b0, u[2], u[4])
        fi = torch.where(b0, u[3], u[5])
        # RZZ: gd = z; RXX: gf = 1; RYY: gf = -z; U = cos - i sin (P)
        gd2 = torch.where(kind == _RZZ, z, 0.0)
        gf2 = torch.where(kind == _RXX, 1.0, torch.where(kind == _RYY, -z,
                                                         0.0))
        self.d = (torch.where(two_q, cos, dr),
                  torch.where(two_q, -sin * gd2, di))
        self.f = (torch.where(two_q, 0.0, fr),
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
    tape = _Tape((kind, tq, cq, slot), angles)
    for g in _live(kind):
        gate = _Gate(tape, g, col)
        re, im = gate.apply(re, im, gate.d, gate.f)
    return re, im


def apply_tape_bwd_plain(ore, oim, gre, gim, kind, tq, cq, slot, angles):
    """B3b in plain PyTorch: from the forward output planes and the
    real-plane cotangents (gre, gim) -> (dre, dim, dang), the psi0
    cotangents (Re lambda, -Im lambda) and the angle gradients (E, S, R)."""
    col = torch.arange(ore.shape[-1], device=ore.device)
    tape = _Tape((kind, tq, cq, slot), angles)
    re, im, lre, lim = ore, oim, gre, -gim
    dang = torch.zeros_like(angles)
    for g in reversed(_live(kind)):
        gate = _Gate(tape, g, col)
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
    dtype = angles.dtype
    if dtype not in KERNEL_DTYPES or any(p.dtype != dtype for p in planes):
        raise TypeError(f"{name}: the CUDA kernels take float32 or float64 "
                        "planes and angles, all of one dtype")
    n_env, s_n, r = angles.shape
    d = planes[0].shape[-1]
    n = d.bit_length() - 1
    if d < 2 or d != 1 << n or any(p.shape != (n_env, s_n, d)
                                   for p in planes):
        raise ValueError(f"{name}: planes must be (E, S, D), D a power of "
                         "two, and angles (E, S, R)")
    if n > MAX_QUBITS:
        raise ValueError(f"{name}: {n} qubits; the composed engine takes at "
                         f"most {MAX_QUBITS}; {ABOVE_CAP}")
    g = tape[0].shape[-1]
    if any(t.shape != (n_env, g) for t in tape):
        raise ValueError(f"{name}: tapes must all be (E, G)")
    if weave not in (1, 3) or g % weave:
        raise ValueError(f"{name}: weave must be 1 or 3 (a tape of 3 G "
                         "woven positions)")
    f64 = dtype == torch.float64
    # the fewest qubits whose launches read a schedule
    scheduled = (_sweep_library(dtype).chunk_bits() + 1 if f64
                 else WIDE_MIN_QUBITS)
    if schedule is not None:
        es = schedule.shape[0]
        words = (sweep_words(g // weave) if f64 or n >= SWEEP_MIN_QUBITS
                 else schedule_words(g // weave, r))
        if (schedule.dtype != torch.int32 or schedule.device != dev
                or not schedule.is_contiguous() or n_env % es
                or schedule.shape[1:] != (words,)):
            raise ValueError(f"{name}: the schedule must be a contiguous "
                             f"int32 (E_s, {words}) tensor on {dev} (the "
                             "tapes' tape_schedule), E a multiple of E_s")
    elif weave != 1 and n >= scheduled:
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


# -- the sweep kernels: float32 at 17-20 qubits, float64 at 1-20 ------------

# the sources of the sweep kernels' two instances (csrc/tape_sweep.cuh's
# body in float and in double), by the planes' dtype; each exports the same
# C functions under its own name as prefix
SWEEP_SOURCES = {torch.float32: "apply_tape_sweep",
                 torch.float64: "apply_tape_f64"}


def sweep_words(g: int) -> int:
    """Words of one env's segment schedule for G gates (``csrc/
    tape_sweep.cuh``; ``ops/fused_adam2d.py:sweep_segments``)."""
    return 3 * g + 2


class SweepLibrary:
    """A library of the sweep tape kernels, one instance of ``csrc/
    tape_sweep.cuh`` (``SWEEP_SOURCES``), with the C signatures of its
    functions; ``lib.<name>`` is its function ``<prefix>_<name>``
    (``lib.chunk_bits()``, ``lib.max_segments(G, n)``, ...)."""

    def __init__(self, lib, prefix: str):
        self.lib, self.prefix = lib, prefix
        self.fwd_launch.argtypes = [_PTR] * 10 + [_I32] * 7 + [_PTR] * 2
        self.bwd_launch.argtypes = ([_PTR] * 13 + [_I32] * 2 + [_PTR] * 5
                                    + [_I32] * 5 + [_PTR] * 2)
        self.schedule_launch.argtypes = [_PTR] * 4 + [_I32] * 3 + [_PTR]
        for name, n_args in (("fwd_launch", None), ("bwd_launch", None),
                             ("schedule_launch", None), ("min_qubits", 0),
                             ("max_qubits", 0), ("chunk_bits", 0),
                             ("max_segments", 2),
                             ("threads", 2), ("stages", 1),
                             ("sync_words", 1), ("ctas_per_sm", 2),
                             ("resident_ctas", 2)):
            fn = getattr(self, name)
            if n_args is not None:
                fn.argtypes = [_I32] * n_args
            fn.restype = _I32
        self.smem_bytes.argtypes = [_I32] * 2
        self.grad_smem_bytes.argtypes = [_I32]
        for fn in (self.smem_bytes, self.grad_smem_bytes):
            fn.restype = ctypes.c_size_t
        self.error_string.argtypes = [_I32]
        self.error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        if name in ("lib", "prefix"):
            raise AttributeError(name)
        return getattr(self.lib, f"{self.prefix}_{name}")


@functools.cache
def _sweep_library(dtype=torch.float32) -> SweepLibrary:
    """The sweep kernels' library for planes of ``dtype`` (built at first
    use)."""
    from tensorrl_qas_tpu_torch.ops.build import load

    return SweepLibrary(load(SWEEP_SOURCES[dtype]), SWEEP_SOURCES[dtype])


# (library, qubits, device) -> the CTAs of the forward and the adjoint
# kernel an SM holds (each >= 1), asked once
_sweep_fit: dict = {}


def check_sweep_fit(lib: SweepLibrary, n: int, device=None):
    """CTAs of the forward and the adjoint kernel of ``lib`` one SM of the
    card (``device``) holds at once at ``n`` qubits, as the runtime reports
    them for their threads and shared memory; raises where one does not
    fit, or where the card holds no grid for a call above the chunk's
    qubits (no fallback to another kernel).  A row-a-CTA launch needs no
    more; a call above takes at most ``lib.resident_ctas`` CTAs, which need
    not be resident at once to finish (``csrc/tape_sweep.cuh``)."""
    key = (lib, n, device)
    if key not in _sweep_fit:
        fits = []
        for adjoint in (0, 1):
            ctas = lib.ctas_per_sm(adjoint, n)
            if n > lib.chunk_bits() and ctas > 0:
                ctas = min(ctas, lib.resident_ctas(adjoint, n))
            if ctas < 1:
                why = (f"CUDA error {-ctas} "
                       f"({lib.error_string(-ctas).decode()})"
                       if ctas < 0 else "none fits")
                raise RuntimeError(
                    f"{lib.prefix}: the card cannot hold a CTA of "
                    f"{lib.smem_bytes(adjoint, n)} B of shared memory: "
                    f"{why}")
            fits.append(ctas)
        _sweep_fit[key] = tuple(fits)
    return _sweep_fit[key]


def _launch_sweep(lib: SweepLibrary, kernel: str, *args):
    """Call ``<prefix>_<kernel>_launch`` of ``lib``; raise on a CUDA
    error."""
    rc = getattr(lib, f"{kernel}_launch")(*args)
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{lib.prefix}_{kernel} launch failed: CUDA "
                           f"error {rc} ({msg})")


def run_sweep_schedule(lib: SweepLibrary, tape, n: int, *, stream=None):
    """One launch of ``lib``'s segment kernel on checked (E, G) noiseless
    tapes above its chunk's qubits (not counted) -> (E, 3 G + 2) int32."""
    n_env, g = tape[0].shape
    out = torch.empty((n_env, sweep_words(g)), dtype=torch.int32,
                      device=tape[0].device)
    _launch_sweep(lib, "schedule", *(t.data_ptr() for t in tape[:3]),
                  out.data_ptr(), n_env, g, n, stream)
    return out


def _sweep_args(lib, tape, n, schedule, weave, stream):
    """(schedule, E_s, weave, G) of a sweep launch: above the chunk's
    qubits the segments (built here when not given, for an unwoven tape),
    else none (a row is one chunk)."""
    g = tape[0].shape[-1] // weave
    if n <= lib.chunk_bits():
        return None, 0, weave, g
    if schedule is None:
        if weave != 1:
            raise ValueError("a woven tape needs its gates' schedule")
        schedule = run_sweep_schedule(lib, tape, n, stream=stream)
    return schedule, schedule.shape[0], weave, g


def _sweep_sync(lib, n_env, s_n, n, device):
    """A sweep call's sync words (int32, zeroed by the call), or None where
    a row is one chunk."""
    if n <= lib.chunk_bits():
        return None
    return torch.empty(lib.sync_words(n_env * s_n), dtype=torch.int32,
                       device=device)


def run_sweep_fwd(lib: SweepLibrary, re, im, tape, angles, *, schedule=None,
                  weave=1, stream=None):
    """One sweep B3f call of ``lib`` on checked inputs of its dtype (not
    counted): one launch -> (ore, oim).  ``schedule`` and ``weave`` as
    ``run_fwd``'s."""
    n_env, s_n, _, r, n = _dims(re, tape, angles)
    sched, es, weave, g = _sweep_args(lib, tape, n, schedule, weave, stream)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    sync = _sweep_sync(lib, n_env, s_n, n, re.device)
    _launch_sweep(lib, "fwd", *(t.data_ptr() for t in tape),
                  angles.data_ptr(), re.data_ptr(), im.data_ptr(),
                  ore.data_ptr(), oim.data_ptr(), _ptr(sched), es, weave,
                  n_env, s_n, g, r, n, _ptr(sync), stream)
    return ore, oim


def run_sweep_bwd(lib: SweepLibrary, ore, oim, gre, gim, tape, angles, *,
                  psi0_grad=True, schedule=None, weave=1, stream=None):
    """One sweep B3b call of ``lib`` on checked inputs of its dtype (not
    counted): the segment launch and the gradient launch -> (dre, dim,
    dang), as ``run_bwd``.  Scratch: above the chunk's qubits psi and mu
    planes (4 x E S D values) and the sync words; the gradient rows' chunk
    partials."""
    n_env, s_n, _, r, n = _dims(ore, tape, angles)
    sched, es, weave, g = _sweep_args(lib, tape, n, schedule, weave, stream)
    dre, dim = ((torch.empty_like(ore), torch.empty_like(oim)) if psi0_grad
                else (None, None))
    dang = torch.empty_like(angles)
    cb = lib.chunk_bits()
    scratch = ([torch.empty_like(ore) for _ in range(4)] if n > cb
               else [None] * 4)
    gpart = torch.empty((n_env * s_n, g, 1 << max(0, n - cb)),
                        dtype=ore.dtype, device=ore.device)
    sync = _sweep_sync(lib, n_env, s_n, n, ore.device)
    _launch_sweep(lib, "bwd", *(t.data_ptr() for t in tape),
                  angles.data_ptr(), ore.data_ptr(), oim.data_ptr(),
                  gre.data_ptr(), gim.data_ptr(), _ptr(dre), _ptr(dim),
                  dang.data_ptr(), _ptr(sched), es, weave,
                  *(_ptr(t) for t in scratch), gpart.data_ptr(), n_env, s_n,
                  g, r, n, _ptr(sync), stream)
    return dre, dim, dang


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


def tape_schedule(kind, tq, cq, slot, n: int, r: int,
                  dtype=torch.float32):
    """The schedule of (E, G) int32 tapes with ``r`` angles at ``n`` qubits,
    for the forward and adjoint launches on those tapes (or their woven
    extensions) on planes of ``dtype`` to read: on CUDA tensors one launch
    of the wide kernels' schedule kernel at 10-16 qubits, of the sweep
    kernels' segment kernel at 17-20; for float64 planes of the
    double-precision kernels' segment kernel above their chunk's 12 qubits
    (counted in ``tape_schedule.launches``); None where no kernel reads one
    (CPU tensors, below 10 qubits, float64 up to 12)."""
    if kind.device.type != "cuda":
        return None
    tape = (kind, tq, cq, slot)
    if dtype == torch.float64:
        lib = _sweep_library(dtype)
        if n <= lib.chunk_bits():
            return None
        out = run_sweep_schedule(lib, tape, n, stream=_stream(kind.device))
        tape_schedule.launches += 1
        return out
    if n < WIDE_MIN_QUBITS:
        return None
    if n >= SWEEP_MIN_QUBITS:
        out = run_sweep_schedule(_sweep_library(), tape, n,
                                 stream=_stream(kind.device))
    else:
        out = run_schedule(_library(), tape, n, r,
                           stream=_stream(kind.device))
    tape_schedule.launches += 1
    return out


def _run_kernel(direction, args, kw, n, dev, dtype):
    """One counted call of the forward or adjoint kernel: the
    double-precision kernels on float64 planes; on float32 the sweep
    kernels from 17 qubits, else apply_tape.cu's."""
    stream = _stream(dev)
    f64 = dtype == torch.float64
    sweep = not f64 and n >= SWEEP_MIN_QUBITS
    if f64 or sweep:
        lib = _sweep_library(dtype)
        check_sweep_fit(lib, n, dev)
        run = run_sweep_fwd if direction == "fwd" else run_sweep_bwd
        out = run(lib, *args, stream=stream, **kw)
    else:
        run = run_fwd if direction == "fwd" else run_bwd
        out = run(_library(), *args, stream=stream, **kw)
    wrapper = apply_tape_fwd if direction == "fwd" else apply_tape_bwd
    wrapper.launches += 1
    wrapper.sweep_launches += sweep
    wrapper.f64_launches += f64
    return out


def apply_tape_fwd(re, im, kind, tq, cq, slot, angles, *,
                   tapes_checked: bool = False, schedule=None,
                   weave: int = 1):
    """B3f: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``tapes_checked``: the caller has run ``check_tapes`` on
    these tapes (saves a host read per launch).  From 10 qubits the kernel
    reads ``schedule`` (``tape_schedule`` of the tapes, or of the gates of
    woven tapes, ``weave`` 3; made here for an unwoven tape when not
    given).  Float32 planes and angles run the float kernels, float64 the
    double-precision ones (``csrc/apply_tape_f64.cu``).  Counts launches in
    ``apply_tape_fwd.launches``, those of the sweep kernels (17-20 qubits,
    float32) also in ``apply_tape_fwd.sweep_launches``, those of the
    double-precision kernels in ``apply_tape_fwd.f64_launches``; each a
    call, one device launch (B3b's: two)."""
    if angles.device.type == "cpu":
        return apply_tape_fwd_plain(re, im, kind, tq, cq, slot, angles)
    if angles.device.type != "cuda":
        raise ValueError(f"apply_tape_fwd: no kernel for device "
                         f"{angles.device}")
    tape = (kind, tq, cq, slot)
    _, _, _, r, n = _check("apply_tape_fwd", (re, im), tape, angles,
                           tapes_checked, schedule, weave)
    if schedule is None:
        schedule = tape_schedule(*tape, n, r, angles.dtype)
    return _run_kernel("fwd", (re, im, tape, angles),
                       dict(schedule=schedule, weave=weave), n, angles.device,
                       angles.dtype)


def apply_tape_bwd(ore, oim, gre, gim, kind, tq, cq, slot, angles, *,
                   tapes_checked: bool = False, psi0_grad: bool = True,
                   schedule=None, weave: int = 1):
    """B3b: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; -> (dre, dim, dang), (None, None, dang) without
    ``psi0_grad``; ``schedule`` and ``weave`` as ``apply_tape_fwd``'s.
    Counts launches in ``apply_tape_bwd.launches`` and, as the forward,
    ``apply_tape_bwd.sweep_launches`` / ``f64_launches``."""
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
        schedule = tape_schedule(*tape, n, r, angles.dtype)
    return _run_kernel("bwd", (ore, oim, gre, gim, tape, angles),
                       dict(psi0_grad=psi0_grad, schedule=schedule,
                            weave=weave), n, angles.device, angles.dtype)


apply_tape_fwd.launches = 0
apply_tape_bwd.launches = 0
apply_tape_fwd.sweep_launches = 0
apply_tape_bwd.sweep_launches = 0
apply_tape_fwd.f64_launches = 0
apply_tape_bwd.f64_launches = 0
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
