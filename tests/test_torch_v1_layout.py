"""The v1 kernel's operands and layout, checked on the CPU.

``csrc/fused_adam_v1.cu`` takes the flip-group planes of H (the v2 kernel's
operands) in place of the dense H^T planes of the JAX v1 kernel: the plain
step through ``flip_h`` equals the plain step through ``dense_h`` in
float64 to 1e-12 (8-qubit H2O, and random complex Pauli sums at 5 and 9
qubits).

The kernel keeps each start in one group of 2^(n - rb) threads of a warp,
2^rb amplitudes a thread (``ops/fused_adam.py:group_layout``): the low
logical qubits on the lane bits, the others on the register bits, so that
the logical index of register j of group thread t is t | (j << lanes).
The emulation below moves data the way the kernel does on a warp of 32
lanes holding 32 / 2^lanes groups -- a register pair inside a thread, a
lane partner by xor of the warp lane (which must stay inside the group),
controls as predicates on the physical index, error Paulis on any bit --
in complex128 with each group at its own angles; H psi as sum_f W_f[i]
psi[i ^ f] at the logical indices; the adjoint with each group's gradient
rows summed over its lanes.  Held at 2 qubits (one thread a start, upper
registers zero), 4 and 5 (groups of 2 and 4 lanes, 16 and 8 a warp), 8
(a warp a start, at 8 and 16 amplitudes a thread) and 9: the forward state
against the eager simulator (``sim/apply.py``, errors woven into the
tape), the gradient against the eager adjoint (``sim/adjoint.py``), and
psi0 after the adjoint, all to 1e-12 (float64 in another order).
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops import fused_adam
from tensorrl_qas_tpu_torch.ops.fused_adam2d import pauli_flip_groups
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    extend_tape_arrays,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import load_problem
from tensorrl_qas_tpu_torch.sim.adjoint import adjoint_energy
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, gate_matrix
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_CX, _X, _Y, _Z = (int(GateKind.CX), int(GateKind.X), int(GateKind.Y),
                   int(GateKind.Z))
H2O = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"
TOL = 1e-12


def _random_pauli(n, n_terms, seed):
    rng = np.random.default_rng(seed)
    strings = ["I" * n] + ["".join(rng.choice(list("IXYZ"), size=n))
                           for _ in range(n_terms - 1)]
    return PauliSum.from_strings(strings, rng.normal(size=n_terms), n)


def _random_tapes(rng, n, n_env, cap):
    """(E, cap) tapes of every 1-qubit kind and CX, some 1-qubit gates
    controlled, NONE padding; the new tape adds one RY; identity map."""
    kind = np.zeros((n_env, cap), np.int32)
    tq = np.zeros_like(kind)
    cq = np.full_like(kind, -1)
    slot = np.full_like(kind, -1)
    for e in range(n_env):
        r = 0
        for g in range(cap - 1 - e):
            k = int(rng.integers(1, 9))
            t = int(rng.integers(n))
            kind[e, g], tq[e, g] = k, t
            if n > 1 and (k == _CX or rng.random() < 0.2):
                cq[e, g] = (t + 1 + rng.integers(n - 1)) % n
            elif k == _CX:
                kind[e, g] = _RY
            if kind[e, g] in (_RX, _RY, _RZ):
                slot[e, g], r = r, r + 1
    new = [a.copy() for a in (kind, tq, cq, slot)]
    last = (kind != 0).sum(1)
    for e in range(n_env):
        new[0][e, last[e]] = _RY
        new[1][e, last[e]] = int(rng.integers(n))
        new[3][e, last[e]] = cap - 1
    to_t = lambda arrs: tuple(torch.as_tensor(a) for a in arrs)  # noqa: E731
    return to_t((kind, tq, cq, slot)), to_t(new)


@pytest.mark.parametrize("problem", ["H2O 8q", "random 5q", "random 9q"])
def test_plain_step_with_flip_groups_equals_dense_h(problem):
    name, nq = problem.split()
    n = int(nq[:-1])
    pauli = (load_problem("H2O", 8, H2O).pauli if name == "H2O"
             else _random_pauli(n, 30, seed=n))
    opt = AngleOptimizer(pauli, device="cpu")
    wre, wim, flips = opt.w_planes()
    if name == "random":
        assert bool((wim != 0).any())          # a complex H
    rng = np.random.default_rng(n)
    n_env, s_n, cap = 2, 3, 12
    old, new = _random_tapes(rng, n, n_env, cap)
    maps = torch.arange(cap, dtype=torch.int32).repeat(n_env, 1)
    psi0 = torch.as_tensor(rng.normal(size=(1, 1 << n))
                           + 1j * rng.normal(size=(1, 1 << n)))
    psi0 = psi0 / psi0.norm()
    active = torch.ones(n_env, 1, cap, dtype=torch.float64)
    starts = torch.as_tensor(rng.normal(size=(n_env, s_n, cap)))
    head = (old, new, maps, psi0.real.contiguous(), psi0.imag.contiguous())
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, (n_env, 2)),
                            dtype=torch.int32)
    for noise in ({}, dict(noise=(0.1, 0.2), seeds=seeds)):
        xf, ef = fused_adam.fused_adam_step(
            *head, wre, wim, flips, starts, active, iters=3, lr=0.1, **noise)
        xd, ed = fused_adam.fused_step_plain(
            *head, fused_adam.dense_h(*opt.h_planes()), starts, active,
            iters=3, lr=0.1, **noise)
        assert (xf - xd).abs().max() <= TOL
        assert (ef - ed).abs().max() <= TOL


# -- the group layout, emulated ----------------------------------------------

class Warp:
    """32 lanes of the kernel's CTA, each with 2^rb registers: lane l is
    thread t = l & (T - 1) of group l // T, register j holds the physical
    amplitude (l << rb) | j, logical index t | (j << lanes)."""

    def __init__(self, n, rb):
        self.n, self.rb = n, rb
        rb_, self.L, self.T, _, _ = fused_adam.group_layout(n, 8, rb)
        assert rb_ == rb
        self.groups = 32 // self.T
        lane = np.arange(32)[:, None]
        j = np.arange(1 << rb)[None, :]
        self.lane, self.j = lane, j
        self.p = (lane << rb) | j
        self.logical = (lane & (self.T - 1)) | (j << self.L)
        self.group = np.broadcast_to(lane // self.T, self.p.shape)
        self.valid = self.logical < (1 << n)

    def phys(self, q):
        return self.rb + q if q < self.L else q - self.L

    def bit(self, pos):
        return (self.p >> pos) & 1

    def partner(self, a, pos):
        if pos < self.rb:
            return a[:, self.j[0] ^ (1 << pos)]
        other = self.lane[:, 0] ^ (1 << (pos - self.rb))
        # a shuffle inside the warp that must stay inside the group
        assert (other // self.T == self.lane[:, 0] // self.T).all()
        return a[other, :]

    def load(self, psi0):
        idx = np.where(self.valid, self.logical, 0)
        return np.where(self.valid, psi0[idx], 0.0)

    def store(self, a):
        """(groups, D) logical states."""
        out = np.zeros((self.groups, 1 << self.n), complex)
        v = self.valid
        out[self.group[v], self.logical[v]] = a[v]
        return out

    def on(self, cp):
        return np.ones(self.p.shape, bool) if cp < 0 else self.bit(cp) == 1

    def gate(self, a, u, tp, cp):
        """u (groups, 2, 2): each group's own matrix."""
        beta, q = self.bit(tp), self.partner(a, tp)
        ug = u[self.group]
        new = np.where(beta == 0, ug[..., 0, 0] * a + ug[..., 0, 1] * q,
                       ug[..., 1, 1] * a + ug[..., 1, 0] * q)
        return np.where(self.on(cp), new, a)

    def gate_adj(self, a, lam, u, k, tp, cp):
        beta, q, ql = self.bit(tp), self.partner(a, tp), self.partner(lam,
                                                                      tp)
        on = self.on(cp)
        a0, a1 = np.where(beta == 0, a, q), np.where(beta == 0, q, a)
        if k == _RX:
            q0, q1 = a1, a0
        elif k == _RY:
            q0, q1 = -1j * a1, 1j * a0
        else:
            q0, q1 = a0, -a1
        own = np.where(beta == 0, q0, q1)
        part = np.where(on, own.real * lam.imag + own.imag * lam.real, 0.0)
        # each lane's partial, then the sum over its group's lanes
        gp = 0.5 * np.bincount(self.group.ravel(), part.ravel(),
                               minlength=self.groups)
        ug = u[self.group]
        c = np.conj
        pa = np.where(beta == 0, c(ug[..., 0, 0]) * a + c(ug[..., 1, 0]) * q,
                      c(ug[..., 1, 1]) * a + c(ug[..., 0, 1]) * q)
        pl = np.where(beta == 0, ug[..., 0, 0] * lam + ug[..., 1, 0] * ql,
                      ug[..., 1, 1] * lam + ug[..., 0, 1] * ql)
        return np.where(on, pa, a), np.where(on, pl, lam), gp

    def pauli(self, a, k, pos, transpose=False):
        bit = self.bit(pos)
        if k == _Z:
            return np.where(bit == 1, -a, a)
        q = self.partner(a, pos)
        if k == _X:
            return q
        sg = np.where(bit == 1, -1.0, 1.0) * (-1.0 if transpose else 1.0)
        return sg * q.imag - 1j * sg * q.real           # Y


def _layout_case(n, seed):
    """One tape (every kind, controls, a shared slot, NONE), its error
    Paulis, a unit psi0, a complex Pauli sum and its flip-group planes."""
    rng = np.random.default_rng(seed)
    kind, tq, cq, slot = [], [], [], []
    n_slots = 0
    for g in range(40):
        k = int(rng.integers(1, 9)) if g != 20 else 0
        t = int(rng.integers(n))
        c = -1
        if n > 1 and (k == _CX or (k and rng.random() < 0.2)):
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
    arrs = tuple(np.asarray(a, np.int32) for a in (kind, tq, cq, slot))
    rot = np.isin(arrs[0], (_RX, _RY, _RZ))
    kt = np.where((rot | (arrs[0] == _CX)) & (rng.random(40) < 0.15),
                  rng.integers(_X, _Z + 1, 40), 0).astype(np.int32)
    kc = np.where((arrs[0] == _CX) & (rng.random(40) < 0.3),
                  rng.integers(_X, _Z + 1, 40), 0).astype(np.int32)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    pauli = _random_pauli(n, 16, seed + 100)
    return arrs, kt, kc, max(n_slots, 1), psi0, pauli, rng


@pytest.mark.parametrize("n,rb", [(2, 3), (4, 3), (5, 3), (8, 3), (8, 4),
                                  (9, 4)])
def test_group_layout_matches_the_eager_simulator(n, rb):
    arrs, kt, kc, n_slots, psi0, pauli, rng = _layout_case(n, seed=n + rb)
    kind, tq, cq, slot = arrs
    w = Warp(n, rb)
    xs = rng.normal(size=(w.groups, n_slots))        # each group's angles
    live = [g for g in range(len(kind)) if kind[g]]

    def mats(g):
        return np.stack([np.asarray(gate_matrix(int(kind[g]), torch.tensor(
            float(x[slot[g]]) if slot[g] >= 0 else 0.0,
            dtype=torch.float64)), complex).reshape(2, 2) for x in xs])

    u = {g: mats(g) for g in live}
    q0 = w.phys(0)
    psi = w.load(psi0)
    for g in live:
        p = w.phys(int(tq[g]))
        c = w.phys(int(cq[g])) if cq[g] >= 0 else -1
        psi = w.gate(psi, u[g], p, c)
        if kt[g]:
            psi = w.pauli(psi, kt[g], p)
        if kc[g]:
            psi = w.pauli(psi, kc[g], c if c >= 0 else q0)
    out = w.store(psi)
    # lambda = 2 conj(sum_f W_f[i] psi[i ^ f]) at each lane's own indices
    wre, wim, flips = pauli_flip_groups(pauli, dtype=np.float64)
    idx = np.arange(1 << n)
    hpsi = sum((wr + 1j * wi)[None] * out[:, idx ^ f]
               for wr, wi, f in zip(wre, wim, flips))
    lam = np.where(w.valid, 2.0 * np.conj(hpsi[w.group, np.where(
        w.valid, w.logical, 0)]), 0.0)
    grad = np.zeros_like(xs)
    for g in reversed(live):
        p = w.phys(int(tq[g]))
        c = w.phys(int(cq[g])) if cq[g] >= 0 else -1
        for k, pos in ((kt[g], p), (kc[g], c if c >= 0 else q0)):
            if k:
                psi = w.pauli(psi, k, pos)
                lam = w.pauli(lam, k, pos, transpose=True)
        psi, lam, gp = w.gate_adj(psi, lam, u[g], int(kind[g]), p, c)
        if slot[g] >= 0 and kind[g] in (_RX, _RY, _RZ):
            grad[:, slot[g]] += gp
    back = w.store(psi)
    ext = extend_tape_arrays(tuple(torch.as_tensor(a) for a in arrs),
                             torch.as_tensor(kt), torch.as_tensor(kc))
    for grp in range(w.groups):
        x = torch.tensor(xs[grp], requires_grad=True)
        want = apply_tape(torch.as_tensor(psi0), *ext, x.detach())
        assert np.abs(out[grp] - want.numpy()).max() <= TOL
        adjoint_energy(torch.as_tensor(psi0), *ext, x,
                       *pauli.tensors("cpu", torch.complex128)).backward()
        assert np.abs(grad[grp] - x.grad.numpy()).max() <= TOL
        assert np.abs(back[grp] - psi0).max() <= TOL


@pytest.mark.parametrize("n", range(1, 10))
def test_group_layout_covers_the_state(n):
    """A group holds the state within one warp; a CTA stays within its
    instance's thread cap; rounds of groups cover the starts."""
    for rb in (3, 4):
        if n - rb > 5:
            with pytest.raises(ValueError, match="cannot hold"):
                fused_adam.group_layout(n, 8, rb)
            continue
        for s_n in (1, 3, 8, 16, 33):
            rb_, lanes, threads, groups, rounds = fused_adam.group_layout(
                n, s_n, rb)
            assert rb_ == rb and threads == 1 << lanes <= 32
            assert threads << rb >= 1 << n
            assert groups * threads <= 256
            assert groups * rounds >= s_n > groups * (rounds - 1)
    assert fused_adam.group_layout(n, 8)[0] == (4 if n == 9 else 3)


# -- the kernel's source, run on the host ------------------------------------

CSRC = pathlib.Path(fused_adam.__file__).resolve().parents[1] / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"


@pytest.fixture(scope="module")
def emulated_v1(tmp_path_factory):
    """csrc/fused_adam_v1.cu compiled by the host's C++ compiler against
    tests/cuda_emu/cuda_runtime.h (a launch runs its blocks one after
    another, a thread per CUDA thread), bound like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("emu")
    lib = out / "libfused_adam_v1_emu.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-pthread", "-w", "-x", "c++", f"-I{EMU}", f"-I{CSRC}",
                    "-o", str(lib), str(CSRC / "fused_adam_v1.cu")],
                   check=True, capture_output=True, timeout=300)
    return fused_adam.bind(ctypes.CDLL(str(lib)))


# (qubits, envs, starts, register bits, noise, W in shared memory, per-env
# psi0, Hamiltonian): one thread a start with zero upper registers (2q),
# groups of 2 and 4 lanes (4q, 5q), a warp a start (8q at both widths,
# 9q), 16 starts in one CTA of 16 groups (4q) and in two rounds (9q)
EMULATED = {
    "2q": (2, 2, 3, 0, False, True, False, "random"),
    "4q S=16": (4, 2, 16, 0, False, True, False, "random"),
    "5q noise": (5, 3, 8, 0, True, True, False, "random"),
    "5q per-env psi0": (5, 3, 3, 4, False, True, True, "random"),
    "8q A=8": (8, 2, 8, 3, False, True, False, "H2O"),
    "8q A=16 noise": (8, 2, 8, 4, True, True, False, "H2O"),
    "8q W from global memory": (8, 1, 3, 0, False, False, False, "random"),
    "9q S=16": (9, 1, 16, 0, False, True, False, "random"),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_kernel_matches_plain_version(emulated_v1, case):
    """The kernel's own source, run on the host in float32, held to the
    plain version by the card's rule (``agreement``, 3 Adam iterations,
    1e-5), noise under the same Philox draws."""
    n, n_env, s_n, rb, noisy, w_smem, per_env, ham = EMULATED[case]
    pauli = (load_problem("H2O", 8, H2O).pauli if ham == "H2O"
             else _random_pauli(n, 30, seed=n))
    rng = np.random.default_rng(n + s_n)
    cap = 12
    old, new = _random_tapes(rng, n, n_env, cap)
    ints = lambda arrs: tuple(a.to(torch.int32) for a in arrs)  # noqa: E731
    rows = n_env if per_env else 1
    psi0 = rng.normal(size=(rows, 1 << n)) + 1j * rng.normal(
        size=(rows, 1 << n))
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    f32 = dict(dtype=torch.float32)
    w = AngleOptimizer(pauli, device="cpu").w_planes()
    active = torch.ones(n_env, 1, cap, **f32)
    starts = torch.as_tensor(0.5 * rng.normal(size=(n_env, s_n, cap)), **f32)
    args = (ints(old), ints(new),
            torch.arange(cap, dtype=torch.int32).repeat(n_env, 1),
            torch.as_tensor(psi0.real, **f32),
            torch.as_tensor(psi0.imag, **f32), w[0].float(), w[1].float(),
            w[2], starts, active)
    noise = {}
    if noisy:
        noise = dict(noise=(0.1, 0.2), seeds=torch.as_tensor(
            rng.integers(0, 2**31 - 1, (n_env, 2)), dtype=torch.int32))
    _, xk, ek = fused_adam.run_kernel(
        emulated_v1, *args, iters=3, lr=0.1, reg_bits=rb, stream=None,
        w_smem=w_smem, **(noise or dict(noise=None, seeds=None)))
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, **noise)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         iters=3, **noise)
    assert bool(ok.all()) and bool(strict.all())
