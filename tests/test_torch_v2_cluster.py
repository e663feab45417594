"""The v2 kernel's own source run on the host: the cluster kernel (13-16
qubits), the register kernel it shares its body with, and the first
design.

``csrc/fused_adam_v2.cu`` is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` and ``cooperative_groups.h`` (a fiber
per CUDA thread, switched at every barrier, shuffle and ballot; the CTAs
of one cluster run together, a cluster barrier is a rendezvous of all
their threads, ``map_shared_rank`` points into the partner CTA's shared
memory; a rendezvous that cannot complete aborts) and bound like the
card's library (``ops/fused_adam2d.py:bind``).  In float32 it is held to the plain
version by the card's rule (``agreement``, 3 Adam iterations, 1e-5, every
env strict): at 13 qubits (clusters of 2 CTAs) without noise, with noise
(the same Philox draws) and with a psi0 per env, at 14 qubits (4 CTAs),
at 7 qubits (the register kernel) and at 17 (the first design, its state
in the global workspace).  The tapes open with swaps through a
cluster bit and controls on one, and the noisy draws put an X or Y error
on a cluster bit.  A cluster that cannot be scheduled (more shared memory
than a CTA may have) raises, and the wrapper asks the occupancy query
once per shape (a stand-in library counts the queries).  Run it before a
card call that follows an edit of the kernel.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d
from tensorrl_qas_tpu_torch.ops.fused_adam2d import (
    CLUSTER_BIT,
    SWAP,
    swap_schedule,
)
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.sim.noise import (
    depolarizing_draw,
    noise_thresholds,
)

_RX, _RY, _CX = int(GateKind.RX), int(GateKind.RY), int(GateKind.CX)
_X, _Y = int(GateKind.X), int(GateKind.Y)
CSRC = pathlib.Path(fused_adam.__file__).resolve().parents[1] / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
NOISE = (0.2, 0.5)


@pytest.fixture(scope="module")
def emulated_v2(tmp_path_factory):
    """csrc/fused_adam_v2.cu compiled for the host against
    tests/cuda_emu/, bound like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("emu")
    lib = out / "libfused_adam_v2_emu.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-w", "-x", "c++", f"-I{EMU}", f"-I{CSRC}",
                    "-o", str(lib), str(CSRC / "fused_adam_v2.cu")],
                   check=True, capture_output=True, timeout=300)
    return fused_adam2d.bind(ctypes.CDLL(str(lib)))


def heisenberg_chain(n):
    """The open Heisenberg chain: XX, YY and ZZ on each bond, weight 1."""
    strings = []
    for i in range(n - 1):
        for a in "XYZ":
            s = ["I"] * n
            s[i] = s[i + 1] = a
            strings.append("".join(s))
    return PauliSum.from_strings(strings, np.ones(len(strings)), n)


def _tapes(rng, n, n_env, cap):
    """(E, cap) tapes that, from 13 qubits, open with RX on qubits 5-8 (the
    registers' start), two CX controlled from qubit n - 1 (a cluster bit
    then) and an RY on it (a swap through the cluster bit), then go on
    with random 1-qubit gates and CX on every qubit; the new tape adds one
    RY; identity map."""
    kind = np.zeros((n_env, cap), np.int32)
    tq = np.zeros_like(kind)
    cq = np.full_like(kind, -1)
    slot = np.full_like(kind, -1)
    head = [(_RX, q, -1) for q in (5, 6, 7, 8)] + [
        (_CX, 0, n - 1), (_CX, 1, n - 1), (_RY, n - 1, -1)]
    if n <= CLUSTER_BIT:
        head = []
    for e in range(n_env):
        r = 0
        gates = list(head)
        for _ in range(cap - 1 - len(head) - e):
            k = int(rng.integers(1, 9))
            t = int(rng.integers(n))
            c = -1
            if k == _CX or rng.random() < 0.2:
                c = int((t + 1 + rng.integers(n - 1)) % n)
            gates.append((k, t, c))
        for g, (k, t, c) in enumerate(gates):
            kind[e, g], tq[e, g], cq[e, g] = k, t, c
            if k in (_RX, _RY, int(GateKind.RZ)):
                slot[e, g], r = r, r + 1
    new = [a.copy() for a in (kind, tq, cq, slot)]
    last = (kind != 0).sum(1)
    for e in range(n_env):
        new[0][e, last[e]] = _RY
        new[1][e, last[e]] = int(rng.integers(n))
        new[3][e, last[e]] = cap - 1
    to_t = lambda arrs: tuple(torch.as_tensor(a) for a in arrs)  # noqa: E731
    return to_t((kind, tq, cq, slot)), to_t(new)


def _cluster_ops(old, n):
    """Env 0's schedule: (swaps through a cluster bit, the gates whose
    control sits on a cluster bit)."""
    _, ops, _ = swap_schedule(*(a[0].numpy() for a in old[:3]), n)
    swaps = sum(g == SWAP and q >= CLUSTER_BIT for g, _, q in ops)
    ctl = [g for g, _, q in ops if g != SWAP and q >= CLUSTER_BIT]
    return swaps, ctl


# (qubits, envs, starts, noise, per-env psi0)
EMULATED = {
    "7q register kernel": (7, 2, 3, False, False),
    "13q": (13, 2, 2, False, False),
    "13q noise": (13, 2, 2, True, False),
    "13q per-env psi0": (13, 2, 2, False, True),
    "14q": (14, 1, 2, False, False),
    "17q first design": (17, 1, 1, False, False),
}


@pytest.fixture
def one_thread():
    """Torch on one thread for the test: the xdist workers share the
    host's cores, and a parallel region of a busy pool waits on threads
    the other workers keep descheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_kernel_matches_plain_version(emulated_v2, case,
                                               one_thread):
    """The kernel's own source, run on the host in float32, held to the
    plain version by the card's rule (``agreement``, 3 Adam iterations,
    1e-5, every env strict), noise under the same Philox draws."""
    n, n_env, s_n, noisy, per_env = EMULATED[case]
    rng = np.random.default_rng(n + 10 * noisy + 20 * per_env)
    cap = 12
    old, new = _tapes(rng, n, n_env, cap)
    ints = lambda arrs: tuple(a.to(torch.int32) for a in arrs)  # noqa: E731
    rows = n_env if per_env else 1
    psi0 = rng.normal(size=(rows, 1 << n)) + 1j * rng.normal(
        size=(rows, 1 << n))
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    f32 = dict(dtype=torch.float32)
    w = AngleOptimizer(heisenberg_chain(n), device="cpu").w_planes()
    active = torch.ones(n_env, 1, cap, **f32)
    starts = torch.as_tensor(0.5 * rng.normal(size=(n_env, s_n, cap)), **f32)
    args = (ints(old), ints(new),
            torch.arange(cap, dtype=torch.int32).repeat(n_env, 1),
            torch.as_tensor(psi0.real, **f32),
            torch.as_tensor(psi0.imag, **f32), w[0].float(), w[1].float(),
            w[2], starts, active)
    noise = {}
    if noisy:
        noise = dict(noise=NOISE, seeds=torch.as_tensor(
            rng.integers(0, 2**31 - 1, (n_env, 2)), dtype=torch.int32))
    if CLUSTER_BIT < n <= 16:
        swaps, ctl = _cluster_ops(old, n)
        assert swaps >= 1 and {4, 5} <= set(ctl)
    if noisy:
        # an X or Y on the control of a CX controlled from a cluster bit
        # (gates 4 and 5), in some Adam iteration of some env
        hit = False
        for tag in range(3):
            _, kc = depolarizing_draw(old[0], noise["seeds"], tag,
                                      noise_thresholds(*NOISE))
            hit |= bool(torch.isin(kc[:, 4:6], torch.tensor([_X, _Y])).any())
        assert hit
    _, size, xk, ek = fused_adam2d.run_kernel(
        emulated_v2, *args, iters=3, lr=0.1, stream=None,
        **(noise or dict(noise=None, seeds=None)))
    assert size == (1 << (n - CLUSTER_BIT) if CLUSTER_BIT < n <= 16 else 0)
    plain = fused_adam2d.fused_adam_step2d_reference
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=plain,
                                   **noise)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         iters=3, step=plain, **noise)
    assert bool(ok.all()) and bool(strict.all())


def test_unschedulable_cluster_raises(emulated_v2):
    """No fallback: a cluster whose CTAs ask for more shared memory than a
    CTA may have cannot be scheduled, and the check raises."""
    assert fused_adam2d.check_clusters(emulated_v2, 13, 100_000) >= 1
    with pytest.raises(RuntimeError, match="no cluster of 2 CTAs"):
        fused_adam2d.check_clusters(emulated_v2, 13, 300_000)
    assert emulated_v2.fused_adam_v2_cluster_size(12) == 0
    assert [emulated_v2.fused_adam_v2_cluster_size(n)
            for n in (13, 14, 15, 16, 17, 18)] == [2, 4, 8, 16, 0, 0]


class _OccupancyLib:
    """A library whose occupancy query counts its calls: 5 clusters up to
    200,000 B a CTA, none above."""

    def __init__(self):
        self.queries = 0

    def fused_adam_v2_cluster_occupancy(self, n, smem):
        self.queries += 1
        return 5 if smem <= 200_000 else 0

    def fused_adam_v2_cluster_size(self, n):
        return 1 << (n - CLUSTER_BIT)


def test_cluster_check_asks_once_per_shape():
    """A step after the first of its shape asks the CUDA runtime nothing; a
    shape that fits no cluster raises every time (no verdict is kept)."""
    lib = _OccupancyLib()
    for _ in range(3):
        assert fused_adam2d.check_clusters(lib, 14, 139_380) == 5
    assert lib.queries == 1
    assert fused_adam2d.check_clusters(lib, 16, 139_380) == 5
    assert fused_adam2d.check_clusters(lib, 14, 150_000) == 5
    assert lib.queries == 3
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no cluster of 4 CTAs"):
            fused_adam2d.check_clusters(lib, 14, 300_000)
    assert lib.queries == 5
