"""The register layout of the v2 kernel (7 <= n <= 12), emulated in numpy.

``csrc/fused_adam_v2.cu:fused_adam_v2_reg_kernel`` keeps 2^r amplitudes of
psi (and of lambda in the adjoint) in each thread's registers and maps the
logical qubits onto physical bits: r register bits, up to 5 lane bits, the
warp bits above them.  A gate's target must sit on a register or lane bit;
a target on a warp bit is first swapped with a register bit, per the
schedule that ``ops/fused_adam2d.py:swap_schedule`` (the twin of the
kernel's ``build_schedule``) computes once per tape.

The emulation below moves data the way the kernel does -- a register pair
inside a thread, a lane partner across the warp, a swap as the trade of
half a thread's amplitudes with the partner across the warp bit, an error
Pauli on any bit -- on (threads, registers) arrays in complex128, runs
random tapes forward, computes lambda = 2 conj(H psi) at the logical
indices of the end map, and runs the schedule backwards with the angle
gradients.  The tapes take every gate kind, controls and targets on every
qubit class, shared angle slots and error Paulis on targets and controls.
Held, at 7, 10, 11 and 12 qubits: the forward state against the eager
simulator (``sim/apply.py``, errors woven into the tape) and the gradient
against the eager adjoint (``sim/adjoint.py``), both to 1e-12 (float64
arithmetic in another order); the adjoint returns psi0 to 1e-12 and ends on
the map the forward began with (exact).
"""

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops.fused_adam2d import (
    SWAP,
    register_layout,
    swap_schedule,
)
from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays
from tensorrl_qas_tpu_torch.sim.adjoint import adjoint_energy, apply_pauli_sum
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, gate_matrix
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_CX, _X, _Y, _Z = (int(GateKind.CX), int(GateKind.X), int(GateKind.Y),
                   int(GateKind.Z))
TOL = 1e-12


def _random_case(n, n_gates, seed):
    """A tape of every 1-qubit kind and CX (some 1-qubit gates controlled,
    a few rotations sharing an angle slot), its error Paulis (a few
    percent of gates on the target, of CX on the control), angles, a unit
    psi0 and a random Pauli sum.  Where there are warp bits the tape opens
    with a CX whose control sits on one."""
    rng = np.random.default_rng(seed)
    kind, tq, cq, slot = [], [], [], []
    n_slots = 0
    r, lanes, warps = register_layout(n)
    if warps:
        # rotations on the first r non-lane qubits (the registers' start)
        # and a CX controlled from qubit n - 1, on a warp bit then
        for t in range(lanes, lanes + r):
            kind.append(_RX)
            tq.append(t)
            cq.append(-1)
            slot.append(n_slots)
            n_slots += 1
        kind.append(_CX)
        tq.append(0)
        cq.append(n - 1)
        slot.append(-1)
    for _ in range(n_gates):
        k = int(rng.integers(1, 9))                    # RX .. H
        t = int(rng.integers(n))
        c = -1
        if k == _CX or rng.random() < 0.2:
            c = int((t + 1 + rng.integers(n - 1)) % n)
        s = -1
        if k in (_RX, _RY, _RZ):
            if n_slots and rng.random() < 0.1:
                s = int(rng.integers(n_slots))         # a shared slot
            else:
                s, n_slots = n_slots, n_slots + 1
        kind.append(k)
        tq.append(t)
        cq.append(c)
        slot.append(s)
    kind.insert(n_gates // 2, 0)                       # a kNone slot
    tq.insert(n_gates // 2, 0)
    cq.insert(n_gates // 2, -1)
    slot.insert(n_gates // 2, -1)
    arrs = tuple(np.asarray(a, np.int32) for a in (kind, tq, cq, slot))
    rot = np.isin(arrs[0], (_RX, _RY, _RZ))
    kt = np.where((rot | (arrs[0] == _CX)) & (rng.random(len(kind)) < 0.15),
                  rng.integers(_X, _Z + 1, len(kind)), 0)
    kc = np.where((arrs[0] == _CX) & (rng.random(len(kind)) < 0.3),
                  rng.integers(_X, _Z + 1, len(kind)), 0)
    x = rng.normal(size=max(n_slots, 1))
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    strings = ["".join(rng.choice(list("IXYZ"), size=n)) for _ in range(24)]
    pauli = PauliSum.from_strings(strings, rng.normal(size=24), n)
    return arrs, kt.astype(np.int32), kc.astype(np.int32), x, psi0, pauli


class Layout:
    """A CTA's amplitudes as (threads, 2^r) complex arrays: amplitude p of
    the physical order at [p >> r, p & (2^r - 1)]."""

    def __init__(self, n):
        self.n = n
        self.r, self.lanes, self.warps = register_layout(n)
        self.threads = 1 << (n - self.r)
        self.p = np.arange(1 << n).reshape(self.threads, 1 << self.r)

    def bit(self, pos):
        return (self.p >> pos) & 1

    def logical(self, phys_map):
        """Logical index of every amplitude under ``phys_map``."""
        idx = np.zeros_like(self.p)
        for b, q in enumerate(phys_map):
            idx |= self.bit(b) << q
        return idx

    def partner(self, a, pos):
        """The amplitude across physical bit ``pos``: a register of the
        same thread, or the same register of another thread (a lane
        partner by shuffle, a warp partner through shared memory)."""
        if pos < self.r:
            return a[:, np.arange(a.shape[1]) ^ (1 << pos)]
        return a[np.arange(a.shape[0]) ^ (1 << (pos - self.r)), :]

    def swap(self, a, reg, warp):
        """The kernel's swap_bits: each thread trades its amplitudes whose
        register bit ``reg`` differs from its own bit ``warp`` with the
        partner thread across that bit, into the same registers."""
        assert reg < self.r <= warp - self.lanes
        tb = warp - self.r
        t = np.arange(self.threads)
        beta = (t >> tb) & 1
        k = np.arange(1 << (self.r - 1))
        j0 = ((k >> reg) << (reg + 1)) | (k & ((1 << reg) - 1))
        sent = np.where(beta[:, None] == 1, j0, j0 | (1 << reg))
        # staged by rank k: thread t's k-th sent amplitude goes where the
        # partner sent its own k-th
        partner = t ^ (1 << tb)
        out = a.copy()
        out[t[:, None], sent] = a[partner[:, None], sent[partner]]
        return out

    def pauli(self, a, k, pos, transpose=False):
        bit = self.bit(pos)
        if k == _Z:
            return np.where(bit == 1, -a, a)
        q = self.partner(a, pos)
        if k == _X:
            return q
        sg = np.where(bit == 1, -1.0, 1.0) * (-1.0 if transpose else 1.0)
        return sg * q.imag - 1j * sg * q.real           # Y

    def gate(self, a, u, tp, cp):
        assert tp < self.r + self.lanes, "a gate target on a warp bit"
        beta, q = self.bit(tp), self.partner(a, tp)
        (u00, u01), (u10, u11) = u
        new = np.where(beta == 0, u00 * a + u01 * q, u11 * a + u10 * q)
        return np.where(self._on(cp), new, a)

    def gate_adj(self, a, lam, u, k, tp, cp, grad):
        beta, q, ql = self.bit(tp), self.partner(a, tp), self.partner(lam,
                                                                      tp)
        on = self._on(cp)
        gp = 0.0
        if grad:
            a0, a1 = np.where(beta == 0, a, q), np.where(beta == 0, q, a)
            if k == _RX:
                q0, q1 = a1, a0
            elif k == _RY:
                q0, q1 = -1j * a1, 1j * a0
            else:
                q0, q1 = a0, -a1
            own = np.where(beta == 0, q0, q1)
            gp = 0.5 * np.sum(np.where(on, own.real * lam.imag
                                       + own.imag * lam.real, 0.0))
        (u00, u01), (u10, u11) = u
        c = np.conj
        pa = np.where(beta == 0, c(u00) * a + c(u10) * q,
                      c(u11) * a + c(u01) * q)
        pl = np.where(beta == 0, u00 * lam + u10 * ql, u11 * lam + u01 * ql)
        return np.where(on, pa, a), np.where(on, pl, lam), gp

    def _on(self, cp):
        return np.ones(self.p.shape, bool) if cp < 0 else self.bit(cp) == 1


def _emulate(n, arrs, kt, kc, x, psi0, pauli):
    """Forward, H psi at the end map, adjoint along the schedule ->
    (psi (logical), gradient, psi after the adjoint (logical), maps:
    start, end of the forward, end of the adjoint, the schedule)."""
    kind, _, _, slot = arrs
    lay = Layout(n)
    map0, ops, map1 = swap_schedule(*arrs[:3], n)
    u = {g: np.asarray([[complex(v) for v in row] for row in (m[:2], m[2:])])
         for g in range(len(kind)) if kind[g]
         for m in [gate_matrix(int(kind[g]), torch.tensor(
             float(x[slot[g]]) if slot[g] >= 0 else 0.0,
             dtype=torch.float64))]}
    cur = list(map0)
    psi = psi0[lay.logical(cur)]
    for g, p, q in ops:
        if g == SWAP:
            psi = lay.swap(psi, p, q)
            cur[p], cur[q] = cur[q], cur[p]
            continue
        psi = lay.gate(psi, u[g], p, q)
        if kt[g]:
            psi = lay.pauli(psi, kt[g], p)
        if kc[g]:
            psi = lay.pauli(psi, kc[g], q if q >= 0 else lay.r)
    end_fwd = list(cur)
    idx = lay.logical(cur)
    out = np.empty(1 << n, complex)
    out[idx] = psi
    w, f, sm, ip = pauli.tensors("cpu", torch.complex128)
    h = apply_pauli_sum(torch.as_tensor(out), w, f, sm, ip).numpy()
    lam = 2.0 * np.conj(h[idx])
    grad = np.zeros_like(x)
    for g, p, q in reversed(ops):
        if g == SWAP:
            psi, lam = lay.swap(psi, p, q), lay.swap(lam, p, q)
            cur[p], cur[q] = cur[q], cur[p]
            continue
        for k, pos in ((kt[g], p), (kc[g], q if q >= 0 else lay.r)):
            if k:
                psi = lay.pauli(psi, k, pos)
                lam = lay.pauli(lam, k, pos, transpose=True)
        has = slot[g] >= 0 and kind[g] in (_RX, _RY, _RZ)
        psi, lam, gp = lay.gate_adj(psi, lam, u[g], int(kind[g]), p, q, has)
        if has:
            grad[slot[g]] += gp
    back = np.empty(1 << n, complex)
    back[lay.logical(cur)] = psi
    return out, grad, back, (map0, end_fwd, cur, map1), ops


@pytest.mark.parametrize("n", [7, 10, 11, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_mapped_layout_matches_the_eager_simulator(n, seed):
    arrs, kt, kc, x, psi0, pauli = _random_case(n, 48, seed)
    psi, grad, back, maps, ops = _emulate(n, arrs, kt, kc, x, psi0, pauli)
    ext = extend_tape_arrays(tuple(torch.as_tensor(a) for a in arrs),
                             torch.as_tensor(kt), torch.as_tensor(kc))
    want = apply_tape(torch.as_tensor(psi0), *ext, torch.as_tensor(x))
    assert np.abs(psi - want.numpy()).max() <= TOL
    xt = torch.tensor(x, requires_grad=True)
    adjoint_energy(torch.as_tensor(psi0), *ext, xt,
                   *pauli.tensors("cpu", torch.complex128)).backward()
    assert np.abs(grad - xt.grad.numpy()).max() <= TOL
    assert np.abs(back - psi0).max() <= TOL
    map0, end_fwd, end_adj, map1 = maps
    assert end_fwd == map1 and end_adj == map0
    # the tape reached every qubit class it can: gate targets on register
    # and lane bits, controls on every class, swaps once warp bits exist
    r, lanes, warps = register_layout(n)
    gates = [(p, q) for g, p, q in ops if g != SWAP]
    assert {p < r for p, _ in gates} == {True, False}
    assert all(p < r + lanes for p, _ in gates)
    classes = {0 if q < r else 1 if q < r + lanes else 2
               for _, q in gates if q >= 0}
    assert classes == ({0, 1, 2} if warps else {0, 1})
    assert any(g == SWAP for g, _, _ in ops) == bool(warps)


@pytest.mark.parametrize("n", [7, 8, 9, 10, 11, 12])
def test_register_layout_covers_the_state(n):
    """2^r registers of 2^(n - r) threads hold the state; at most 256
    threads a CTA; lane bits fill a warp once there are 32 threads."""
    r, lanes, warps = register_layout(n)
    assert r + lanes + warps == n
    assert 1 << (n - r) <= 256
    assert lanes == min(5, n - r) and warps >= 0


def test_schedule_evicts_the_register_used_furthest_ahead():
    """12 qubits: registers start with the first four targets among
    qubits 5..11 (tape order); a target on a warp bit swaps out the
    register whose qubit is next used furthest ahead (never: furthest;
    ties: the lowest register)."""
    n = 12
    tq = [5, 6, 7, 8, 9, 7, 6, 5, 8]
    kind = [int(GateKind.RX)] * len(tq)
    cq = [-1] * len(tq)
    map0, ops, map1 = swap_schedule(kind, tq, cq, n)
    assert map0[:4] == [5, 6, 7, 8] and map0[4:9] == [0, 1, 2, 3, 4]
    assert map0[9:] == [9, 10, 11]
    # gate 4 (qubit 9): 7, 6, 5 and 8 are next used at gates 5-8
    assert ops[4] == (SWAP, 3, 9)
    assert ops[5] == (4, 3, -1)
    # gate 8 (qubit 8, now on warp bit 9): no register qubit is used
    # again, the lowest register goes
    assert ops[-2] == (SWAP, 0, 9) and ops[-1] == (8, 0, -1)
    assert map1[:4] == [8, 6, 7, 9] and map1[9] == 5


def test_schedule_of_an_empty_tape_is_the_start_map():
    map0, ops, map1 = swap_schedule([0] * 4, [0] * 4, [-1] * 4, 12)
    assert ops == [] and map0 == map1
    assert sorted(map0) == list(range(12))
