"""The composed engine's tape kernels (``csrc/apply_tape.cu``, B3f / B3b)
run on the host.

The source is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` and ``cooperative_groups.h`` (a fiber
per CUDA thread, switched at every barrier, shuffle and ballot; a
cluster's CTAs run together, a cluster barrier is a rendezvous of all
their threads and ``map_shared_rank`` points into the partner CTA's
shared memory; a rendezvous that cannot complete aborts) and bound like
the card's library (``ops/apply_tape.py:bind``).  In float32 its launches
are held to the plain versions (``apply_tape_fwd_plain`` /
``apply_tape_bwd_plain``): forward planes within 1e-5, psi0 cotangents
and angle gradients within 1e-4 (float32 row sums in another order).

The register kernels at 1 and 2 qubits (one thread a row, upper registers
zero), 5 (groups of 4 lanes, 8 a warp), 8 (a warp a row at 8 amplitudes a
thread) and 9 (16 amplitudes a thread; 9 starts take two rounds): random
tapes hit every gate class on every kind of bit
(``ops/fused_adam.py:group_layout`` puts the low qubits on lane bits):
RXX / RYY / RZZ with both qubits on lane bits, both on register bits and
one of each, controlled rotations and CX with the control on a lane bit
and on a register bit, H and Y, error Paulis X / Y / Z (slot -1), a slot
shared by two gates, NONE padding.

The wide kernels (10-16 qubits, which read the schedule kernel's rows):
register rows at 10 qubits (4 rows a CTA, 5 starts: the second CTA of an
env half idle) and 12 (a CTA a row), clusters of 2 and 4 CTAs a row at 13
and 14 qubits.  Their tapes put RXX / RYY qubits on register, lane, warp
and cluster bits (before the schedule's swaps), controls and RZZ on every
kind of bit; at 12 and 14 qubits the tapes are also woven with error
Paulis (``extend_tape_arrays``: the kernels read the noiseless tape's
schedule, weave 3) whose controls sit on warp and cluster bits.  The
schedule kernel's rows equal the twin's (``tape_schedule_plain``) word
for word at 10, 13 and 16 qubits.

In every case a second launch repeats bit for bit and the adjoint without
psi0 cotangents gives the same angle gradients.  Run it before a card call
that follows an edit of the kernels.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops import apply_tape as at
from tensorrl_qas_tpu_torch.ops.fused_adam import group_layout
from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays

CSRC = pathlib.Path(at.__file__).resolve().parents[1] / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
TOL_FWD, TOL_BWD = 1e-5, 1e-4
K = GateKind


@pytest.fixture(scope="module")
def emulated_tape(tmp_path_factory):
    """csrc/apply_tape.cu compiled for the host against tests/cuda_emu/,
    bound like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("emu")
    lib = out / "libapply_tape_emu.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-w", "-x", "c++", f"-I{EMU}", f"-I{CSRC}",
                    "-o", str(lib), str(CSRC / "apply_tape.cu")],
                   check=True, capture_output=True, timeout=300)
    return at.bind(ctypes.CDLL(str(lib)))


@pytest.fixture
def one_thread():
    """Torch on one thread for the test: the xdist workers share the
    host's cores, and a parallel region of a busy pool waits on threads
    the other workers keep descheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gates(rng, n):
    """(kind, target, control / second qubit) of one env's tape: every
    class on every kind of bit the layout has, then random gates."""
    lanes = max(n - (4 if n > 8 else 3), 0)    # as group_layout's
    on_lane = list(range(lanes))
    on_reg = list(range(lanes, n))
    gates = []

    def two(a, b):
        if a and b:
            t = int(rng.choice(a))
            c = int(rng.choice([q for q in b if q != t]))
            return t, c
        return None
    pairs = [two(on_lane, on_lane) if len(on_lane) > 1 else None,
             two(on_reg, on_reg) if len(on_reg) > 1 else None,
             two(on_lane, on_reg), two(on_reg, on_lane)]
    for pair in filter(None, pairs):
        for k in (K.RXX, K.RYY, K.RZZ):
            gates.append((k, *pair))
        for k in (K.RX, K.RY, K.RZ, K.CX):      # control on the 2nd bit
            gates.append((k, *pair))
    for k in (K.H, K.Y, K.X, K.Z, K.RX, K.RY, K.RZ):
        gates.append((k, int(rng.integers(n)), -1))
    for _ in range(12):
        k = K(int(rng.integers(1, 12)))
        t = int(rng.integers(n))
        if n == 1 and (k == K.CX or k >= K.RXX):
            k = K.RY
        c = -1
        if k == K.CX or k >= K.RXX or (n > 1 and rng.random() < 0.2):
            c = int((t + 1 + rng.integers(n - 1)) % n)
        gates.append((k, t, c))
    order = rng.permutation(len(gates))
    return [gates[i] for i in order]


def _case(n, n_env, s_n, seed):
    """Random tapes (every env its own, with error Paulis X / Y / Z at
    slot -1, a shared slot and NONE padding), unit psi rows, angles and
    cotangents, float32 on the CPU: (planes, tape, angles, cotangents)."""
    rng = np.random.default_rng(seed)
    tapes = [_gates(rng, n) for _ in range(n_env)]
    cap = 2 * max(len(t) for t in tapes) + 4
    arrs = [np.zeros((n_env, cap), np.int32) for _ in range(2)]
    arrs += [np.full((n_env, cap), -1, np.int32) for _ in range(2)]
    r_cap = 0
    for e, gates in enumerate(tapes):
        g, r = 0, 0
        for i, (k, t, c) in enumerate(gates):
            if i == len(gates) // 2:
                g += 1                              # NONE in the middle
            arrs[0][e, g], arrs[1][e, g], arrs[2][e, g] = int(k), t, c
            if k in (K.RX, K.RY, K.RZ, K.RXX, K.RYY, K.RZZ):
                shared = r and rng.random() < 0.1
                arrs[3][e, g] = int(rng.integers(r)) if shared else r
                r += not shared
            g += 1
            if rng.random() < 0.15:                 # an error Pauli
                arrs[0][e, g] = int(rng.integers(int(K.X), int(K.Z) + 1))
                arrs[1][e, g] = t
                g += 1
        r_cap = max(r_cap, r + 1)
    d = 1 << n
    psi = rng.normal(size=(n_env, s_n, d)) + 1j * rng.normal(
        size=(n_env, s_n, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    lam = rng.normal(size=(2, n_env, s_n, d))
    f32 = dict(dtype=torch.float32)
    return ((torch.as_tensor(psi.real, **f32),
             torch.as_tensor(psi.imag, **f32)),
            tuple(torch.as_tensor(a) for a in arrs),
            torch.as_tensor(rng.normal(size=(n_env, s_n, r_cap)), **f32),
            (torch.as_tensor(lam[0], **f32), torch.as_tensor(lam[1], **f32)))


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# (qubits, envs, starts): one thread a row (1q, 2q), 4-lane groups (5q),
# a warp a row at 8 amplitudes a thread (8q) and at 16 in two rounds (9q)
SHAPES = {"1q": (1, 2, 3), "2q": (2, 2, 3), "5q": (5, 2, 3),
          "8q": (8, 2, 3), "9q": (9, 1, 9)}


def _launch(lib, case, **kw):
    planes, tape, angles, cot = case
    out = at.run_fwd(lib, *planes, tape, angles, **kw)
    grads = at.run_bwd(lib, *out, *cot, tape, angles, **kw)
    return out, grads


def _held_to_plain(lib, case, plain_tape=None, **kw):
    """A launch of both kernels against the plain versions (on
    ``plain_tape``, the woven one, when given), a repeat bit for bit and
    the adjoint without psi0 cotangents."""
    planes, tape, angles, cot = case
    out, grads = _launch(lib, case, **kw)
    ref = plain_tape if plain_tape is not None else tape
    out_p = at.apply_tape_fwd_plain(*planes, *ref, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *ref, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD
    out2, grads2 = _launch(lib, case, **kw)
    assert all(torch.equal(a, b) for a, b in zip((*out, *grads),
                                                (*out2, *grads2)))
    lean = at.run_bwd(lib, *out, *cot, tape, angles, psi0_grad=False, **kw)
    assert lean[:2] == (None, None) and torch.equal(lean[2], grads[2])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_register_kernels_match_plain_versions(emulated_tape, shape,
                                               one_thread):
    n, n_env, s_n = SHAPES[shape]
    _held_to_plain(emulated_tape, _case(n, n_env, s_n, seed=n))


def test_every_gate_class_lands_on_every_bit():
    """The tapes above put two-qubit rotations on lane-lane, register-
    register and lane-register pairs and controls on both kinds of bit
    wherever the layout has them."""
    for n in (5, 8, 9):
        lanes = group_layout(n, 8)[1]
        _, tape, _, _ = _case(n, 1, 1, seed=n)
        kind, tq, cq = (a[0].numpy() for a in tape[:3])
        seen = set()
        for k, t, c in zip(kind, tq, cq):
            if c >= 0:
                seen.add((int(k) >= int(K.RXX), t < lanes, c < lanes))
        assert seen >= {(a, b, c) for a in (False, True) for b in (False,
                                                                    True)
                        for c in (False, True)}


# -- the wide kernels (10-16 qubits) ----------------------------------------

# (qubits, envs, starts): register rows (4 a CTA at 10 qubits, 5 starts
# leaving the second CTA half idle; a CTA a row at 12), clusters of 2 and
# 4 CTAs a row (13, 14)
WIDE = {"10q": (10, 2, 5), "12q": (12, 2, 1), "13q": (13, 1, 1),
        "14q": (14, 1, 1)}
_ROT = (K.RX, K.RY, K.RZ)
WOVEN_SEED = 41          # + n: woven tapes with X / Y on the bits named


def _wide_gates(rng, n, n_gates):
    """(kind, target, control / second qubit) of one env's tape: every
    class, qubits drawn over all n (so that, with the schedule's swaps, RXX
    / RYY and targets arrive from every kind of bit, and controls and RZZ
    sit on every kind), CX a fifth of the gates."""
    pool = (K.RXX, K.RYY, K.RZZ, K.RX, K.RY, K.RZ, K.CX, K.CX, K.H, K.Y,
            K.X, K.Z)
    gates = []
    for i in range(n_gates):
        k = pool[i] if i < len(pool) else pool[int(rng.integers(len(pool)))]
        t = int(rng.integers(n))
        c = int((t + 1 + rng.integers(n - 1)) % n)
        ctl = k == K.CX or k >= K.RXX or (k in _ROT and rng.random() < 0.3)
        gates.append((k, t, c if ctl else -1))
    return gates


def _wide_case(n, n_env, s_n, seed, n_gates=40, woven=False):
    """Random wide tapes (a NONE in the middle, a shared slot), unit psi
    rows, angles and cotangents, float32 on the CPU: (planes, tape,
    angles, cotangents), and with ``woven`` also the tape with drawn error
    Paulis woven in (every CX's control error fires, X or Y; rotations'
    and CX's target errors at random)."""
    rng = np.random.default_rng(seed)
    cap = n_gates + 2
    arrs = [np.zeros((n_env, cap), np.int32) for _ in range(2)]
    arrs += [np.full((n_env, cap), -1, np.int32) for _ in range(2)]
    r_cap = 0
    for e in range(n_env):
        g, r = 0, 0
        for i, (k, t, c) in enumerate(_wide_gates(rng, n, n_gates)):
            if i == n_gates // 2:
                g += 1
            arrs[0][e, g], arrs[1][e, g], arrs[2][e, g] = int(k), t, c
            if k in (*_ROT, K.RXX, K.RYY, K.RZZ):
                shared = r and rng.random() < 0.1
                arrs[3][e, g] = int(rng.integers(r)) if shared else r
                r += not shared
            g += 1
        r_cap = max(r_cap, r + 1)
    tape = tuple(torch.as_tensor(a) for a in arrs)
    d = 1 << n
    psi = rng.normal(size=(n_env, s_n, d)) + 1j * rng.normal(
        size=(n_env, s_n, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    lam = rng.normal(size=(2, n_env, s_n, d))
    f32 = dict(dtype=torch.float32)
    case = ((torch.as_tensor(psi.real, **f32),
             torch.as_tensor(psi.imag, **f32)), tape,
            torch.as_tensor(rng.normal(size=(n_env, s_n, r_cap)), **f32),
            (torch.as_tensor(lam[0], **f32), torch.as_tensor(lam[1], **f32)))
    if not woven:
        return case, None
    kind = arrs[0]
    is_rot = (kind >= int(K.RX)) & (kind <= int(K.RZ))
    is_cx = kind == int(K.CX)
    kt = np.where((is_rot | is_cx) & (rng.random(kind.shape) < 0.5),
                  rng.integers(int(K.X), int(K.Z) + 1, kind.shape), 0)
    kc = np.where(is_cx, rng.integers(int(K.X), int(K.Y) + 1, kind.shape),
                  0)
    woven_tape = tuple(a.to(torch.int32).contiguous() for a in
                       extend_tape_arrays(tape, torch.as_tensor(kt),
                                          torch.as_tensor(kc)))
    return case, woven_tape


@pytest.mark.parametrize("shape", list(WIDE))
def test_wide_kernels_match_plain_versions(emulated_tape, shape,
                                           one_thread):
    n, n_env, s_n = WIDE[shape]
    case, _ = _wide_case(n, n_env, s_n, seed=n)
    _held_to_plain(emulated_tape, case)


@pytest.mark.parametrize("n", [12, 14])
def test_wide_kernels_on_woven_tapes(emulated_tape, n, one_thread):
    """A woven tape (weave 3) under its noiseless gates' schedule, held to
    the plain versions on the woven tape, where the errors are gates."""
    case, woven = _wide_case(n, 2, 1, seed=n + WOVEN_SEED, woven=True)
    planes, tape, angles, cot = case
    sched = at.run_schedule(emulated_tape, tape, n, angles.shape[-1])
    _held_to_plain(emulated_tape, (planes, woven, angles, cot),
                   schedule=sched, weave=3)


@pytest.mark.parametrize("n", [10, 13, 16])
def test_schedule_kernel_matches_its_twin(emulated_tape, n):
    case, _ = _wide_case(n, 3, 1, seed=n + 60, n_gates=60)
    _, tape, angles, _ = case
    rows = at.run_schedule(emulated_tape, tape, n, angles.shape[-1])
    assert np.array_equal(rows.numpy(),
                          at.tape_schedule_plain(*tape, n, angles.shape[-1]))


def _bit_class(p):
    return ("register" if p < 4 else "lane" if p < at.FIRST_WARP_BIT
            else "warp" if p < 12 else "cluster")


def _walk(tape, e, n, r):
    """Env e's schedule (the twin's) walked forwards: (ops, map0, map1,
    for each op the physical bit of every qubit before it)."""
    rows = at.tape_schedule_plain(*(a[e:e + 1] for a in tape), n, r)
    ops, map0, map1 = at.schedule_ops(rows[0])
    pos = {q: p for p, q in enumerate(map0)}
    before = []
    for k, a, b, _ in ops:
        before.append(dict(pos))
        if k == at.SWAP_OP:
            at_bit = {p: q for q, p in pos.items()}
            pos[at_bit[a]], pos[at_bit[b]] = b, a
    return ops, map0, map1, before, pos


@pytest.mark.parametrize("n", range(10, 17))
def test_schedule_keeps_every_needed_qubit_local(n):
    """The twin's schedule on random tapes: each gate op names its qubits'
    bits under the map its swaps left; a 1-qubit gate's target and both
    qubits of RXX / RYY sit on register or lane bits, lane bits keep qubits
    0..4, swaps trade a register bit with a higher one; the forward pass
    ends on map1, and the adjoint's (the swaps backwards from map1) on
    map0."""
    case, _ = _wide_case(n, 3, 1, seed=n + 80, n_gates=60)
    tape, r = case[1], case[2].shape[-1]
    for e in range(3):
        ops, map0, map1, before, end = _walk(tape, e, n, r)
        kind, tq, cq = (a[e].tolist() for a in tape[:3])
        assert map0[4:at.FIRST_WARP_BIT] == list(range(5))
        assert sorted(map0) == list(range(n))
        gates = [g for k, _, _, g in ops if k != at.SWAP_OP]
        assert gates == [g for g in range(len(kind)) if kind[g]]
        for (k, a, b, g), pos in zip(ops, before):
            if k == at.SWAP_OP:
                assert a < 4 <= at.FIRST_WARP_BIT <= b < n
                continue
            assert (a, b) == (pos[tq[g]], pos[cq[g]] if cq[g] >= 0 else -1)
            if k != int(K.RZZ):
                assert a < at.FIRST_WARP_BIT
            if k in (int(K.RXX), int(K.RYY)):
                assert b < at.FIRST_WARP_BIT
        assert [q for q, _ in sorted(end.items(), key=lambda x: x[1])] \
            == map1
        pos = {q: p for p, q in enumerate(map1)}
        for k, a, b, _ in reversed(ops):
            if k == at.SWAP_OP:
                at_bit = {p: q for q, p in pos.items()}
                pos[at_bit[a]], pos[at_bit[b]] = b, a
        assert pos == {q: p for p, q in enumerate(map0)}


def test_every_gate_class_lands_on_every_bit_wide():
    """The wide tapes above bring RXX / RYY qubits from register, lane,
    warp and cluster bits (before their swaps), put CX and rotation
    controls and RZZ on every kind of bit, and the woven X / Y errors on
    controls on warp and cluster bits (an exchange)."""
    arrived, seen = set(), set()
    for n, seed, woven in ((12, 12, False), (14, 14, False),
                           (12, 12 + WOVEN_SEED, True),
                           (14, 14 + WOVEN_SEED, True)):
        case, wtape = _wide_case(n, 2, 1, seed=seed, woven=woven)
        tape, r = case[1], case[2].shape[-1]
        for e in range(2):
            ops, _, _, before, _ = _walk(tape, e, n, r)
            kind, tq, cq = (a[e].tolist() for a in tape[:3])
            first = {}
            for (k, a, b, g), pos in zip(ops, before):
                first.setdefault(g, pos)
                if k == at.SWAP_OP:
                    continue
                if k in (int(K.RXX), int(K.RYY)):
                    arrived.update(_bit_class(first[g][q])
                                   for q in (tq[g], cq[g]))
                elif b >= 0:
                    seen.add(("rzz" if k == int(K.RZZ) else "control",
                              _bit_class(b)))
                if wtape is not None and int(wtape[0][e, 3 * g + 2]) in (
                        int(K.X), int(K.Y)):
                    seen.add(("error", _bit_class(b)))
    classes = {"register", "lane", "warp", "cluster"}
    assert arrived == classes
    assert {c for kind, c in seen if kind == "control"} == classes
    assert {c for kind, c in seen if kind == "rzz"} == classes
    assert {"warp", "cluster"} <= {c for kind, c in seen if kind == "error"}
