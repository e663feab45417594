"""The composed engine's tape kernels (``csrc/apply_tape.cu``, B3f / B3b)
run on the host.

The source is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` (a fiber per CUDA thread, switched at
every barrier, shuffle and ballot; a rendezvous that cannot complete
aborts) and bound like the card's library (``ops/apply_tape.py:bind``).
In float32 its launches are held to the plain versions
(``apply_tape_fwd_plain`` / ``apply_tape_bwd_plain``): forward planes
within 1e-5, psi0 cotangents and angle gradients within 1e-4 (float32 row
sums in another order), at 1 and 2 qubits (one thread a row, upper
registers zero), 5 (groups of 4 lanes, 8 a warp), 8 (a warp a row at 8
amplitudes a thread) and 9 (16 amplitudes a thread; 9 starts take two
rounds).  The random tapes hit every gate class on every kind of bit
(``ops/fused_adam.py:group_layout`` puts the low qubits on lane bits):
RXX / RYY / RZZ with both qubits on lane bits, both on register bits and
one of each, controlled rotations and CX with the control on a lane bit
and on a register bit, H and Y, error Paulis X / Y / Z (slot -1), a slot
shared by two gates, NONE padding.  A second launch repeats bit for bit;
the adjoint without psi0 cotangents gives the same angle gradients; the
first design (10-16 qubits, and ``design`` 1 at any width) is held to the
same tolerances.  Run it before a card call
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


def _launch(lib, case, design):
    planes, tape, angles, cot = case
    out = at.run_fwd(lib, *planes, tape, angles, design=design)
    grads = at.run_bwd(lib, *out, *cot, tape, angles, design=design)
    return out, grads


@pytest.mark.parametrize("shape", list(SHAPES))
def test_register_kernels_match_plain_versions(emulated_tape, shape,
                                               one_thread):
    n, n_env, s_n = SHAPES[shape]
    case = _case(n, n_env, s_n, seed=n)
    planes, tape, angles, cot = case
    out, grads = _launch(emulated_tape, case, at.DESIGN_MAIN)
    out_p = at.apply_tape_fwd_plain(*planes, *tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *tape, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD
    out2, grads2 = _launch(emulated_tape, case, at.DESIGN_MAIN)
    assert all(torch.equal(a, b) for a, b in zip((*out, *grads),
                                                (*out2, *grads2)))
    lean = at.run_bwd(emulated_tape, *out, *cot, tape, angles,
                      psi0_grad=False)
    assert lean[:2] == (None, None) and torch.equal(lean[2], grads[2])


@pytest.mark.parametrize("shape", ["2q", "5q", "9q", "10q"])
def test_first_design_matches_plain_versions(emulated_tape, shape,
                                             one_thread):
    """The first design, forced at 2-9 qubits (``design`` 1, the timing's
    comparison) and routed at 10."""
    n, n_env, s_n = SHAPES.get(shape, (10, 1, 1))
    case = _case(n, n_env, s_n, seed=n + 20)
    planes, tape, angles, cot = case
    design = at.DESIGN_FIRST if n <= 9 else at.DESIGN_MAIN
    out, grads = _launch(emulated_tape, case, design)
    out_p = at.apply_tape_fwd_plain(*planes, *tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *tape, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD


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
