"""The v2 kernel's own source run on the host: the cluster kernel (13-16
qubits), the group kernel (17-18), and the register kernel they share
their body with.

``csrc/fused_adam_v2.cu`` is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` and ``cooperative_groups.h`` (a fiber
per CUDA thread, switched at every barrier, shuffle, ballot and spin; the
CTAs the emulated card holds at once run together, a cluster barrier is a
rendezvous of all its threads, ``map_shared_rank`` points into the
partner CTA's shared memory, a spin on a global counter yields its fiber;
a rendezvous that cannot complete, or a sweep in which only spinning
fibers ran, aborts) and bound like the card's library
(``ops/fused_adam2d.py:bind``).  In float32 it is held to the plain
version by the card's rule (``agreement``, 3 Adam iterations, 1e-5, every
env strict): at 13 qubits (clusters of 2 CTAs) without noise, with noise
(the same Philox draws) and with a psi0 per env, at 14 qubits (4 CTAs),
at 7 qubits (the register kernel) and at 17 (the group kernel: 32 CTAs a
start in clusters of the default size, trading across clusters through
global memory).  A second build lowers the largest cluster to 2 CTAs
(``FUSED_ADAM_V2_MAX_CLUSTER``), so that the group kernel runs 14 and 15
qubits with 1 and 2 group bits: without noise, with noise and with a psi0
per env.  The tapes open with swaps through a cluster bit (a group bit)
and controls on one, and the noisy draws put an X or Y error on a
cluster (group) bit.  A start that cannot be held whole (more shared
memory than a CTA may have, or fewer clusters than it takes) raises, and
the wrapper asks the occupancy query once per shape (a stand-in library
counts the queries).  Run it before a card call that follows an edit of
the kernel.
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


def _build(out, max_cluster=None):
    """csrc/fused_adam_v2.cu compiled for the host against
    tests/cuda_emu/ (``max_cluster``: the largest cluster a start may
    take), bound like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = out / f"libfused_adam_v2_emu{max_cluster or ''}.so"
    define = ([f"-DFUSED_ADAM_V2_MAX_CLUSTER={max_cluster}"]
              if max_cluster else [])
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-w", "-x", "c++", f"-I{EMU}", f"-I{CSRC}", *define,
                    "-o", str(lib), str(CSRC / "fused_adam_v2.cu")],
                   check=True, capture_output=True, timeout=300)
    return fused_adam2d.bind(ctypes.CDLL(str(lib)))


@pytest.fixture(scope="module")
def emulated_v2(tmp_path_factory):
    """The source as the card builds it."""
    return _build(tmp_path_factory.mktemp("emu"))


@pytest.fixture(scope="module")
def emulated_v2_small(tmp_path_factory):
    """The source with clusters of at most 2 CTAs: the group kernel from
    14 qubits (group bits from bit 13 up)."""
    return _build(tmp_path_factory.mktemp("emu_small"), max_cluster=2)


def heisenberg_chain(n):
    """The open Heisenberg chain: XX, YY and ZZ on each bond, weight 1."""
    strings = []
    for i in range(n - 1):
        for a in "XYZ":
            s = ["I"] * n
            s[i] = s[i + 1] = a
            strings.append("".join(s))
    return PauliSum.from_strings(strings, np.ones(len(strings)), n)


def _tapes(rng, n, n_env, cap, top=None):
    """(E, cap) tapes that, from 13 qubits, open with RX on qubits 5-8 (the
    registers' start), two CX controlled from qubit n - 1 (a cluster bit
    then) and an RY on it (a swap through the cluster bit), then go on
    with random 1-qubit gates and CX on every qubit; the new tape adds one
    RY; identity map.  With group bits (``top``, the first of them, below
    n): RX on qubits 5..n-2 and the two CX controlled from qubit n - 1,
    random gates that never target it, and last an RY on it: qubit n - 1
    is targeted last, so it starts on a group bit, carries the controls
    there and is swapped in through it."""
    kind = np.zeros((n_env, cap), np.int32)
    tq = np.zeros_like(kind)
    cq = np.full_like(kind, -1)
    slot = np.full_like(kind, -1)
    head = [(_RX, q, -1) for q in (5, 6, 7, 8)] + [
        (_CX, 0, n - 1), (_CX, 1, n - 1), (_RY, n - 1, -1)]
    tail = []
    grouped = top is not None and top < n
    if grouped:
        head = [(_RX, q, -1) for q in range(5, n - 1)] + [
            (_CX, 0, n - 1), (_CX, 1, n - 1)]
        tail = [(_RY, n - 1, -1)]
    if n <= CLUSTER_BIT:
        head = []
    targets = n - 1 if grouped else n
    for e in range(n_env):
        r = 0
        gates = list(head)
        for _ in range(cap - 1 - len(head) - len(tail) - e):
            k = int(rng.integers(1, 9))
            t = int(rng.integers(targets))
            c = -1
            if k == _CX or rng.random() < 0.2:
                c = int((t + 1 + rng.integers(n - 1)) % n)
            gates.append((k, t, c))
        gates += tail
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


def _rank_ops(old, n, lo, hi, top=None):
    """Env 0's schedule: (swaps through a bit in [lo, hi), the gates whose
    control sits on one)."""
    _, ops, _ = swap_schedule(*(a[0].numpy() for a in old[:3]), n, top)
    swaps = sum(g == SWAP and lo <= q < hi for g, _, q in ops)
    ctl = [g for g, _, q in ops if g != SWAP and lo <= q < hi]
    return swaps, ctl


# (qubits, envs, starts, noise, per-env psi0, build: "" the card's, "small"
# clusters of at most 2 CTAs; the emulated card's SMs)
EMULATED = {
    "7q register kernel": (7, 2, 3, False, False, "", 132),
    "13q": (13, 2, 2, False, False, "", 132),
    "13q noise": (13, 2, 2, True, False, "", 132),
    "13q per-env psi0": (13, 2, 2, False, True, "", 132),
    "14q": (14, 1, 2, False, False, "", 132),
    "17q group kernel": (17, 1, 1, False, False, "", 132),
    "14q group, clusters of 2": (14, 2, 2, False, False, "small", 132),
    "14q group noise": (14, 2, 2, True, False, "small", 132),
    "14q group per-env psi0": (14, 2, 2, False, True, "small", 132),
    "15q group, clusters of 2": (15, 1, 2, False, False, "small", 132),
    "15q group noise": (15, 1, 2, True, False, "small", 132),
    # a card that holds one start (4 CTAs) at once: one slot walks the 4
    # starts of 2 envs in turn; one that holds two walks 6 in 2 slots
    "14q group, one start at a time": (14, 2, 2, False, False, "small", 4),
    "14q group noise, two at a time": (14, 2, 3, True, False, "small", 8),
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
def test_emulated_kernel_matches_plain_version(emulated_v2, emulated_v2_small,
                                               case, one_thread):
    """The kernel's own source, run on the host in float32, held to the
    plain version by the card's rule (``agreement``, 3 Adam iterations,
    1e-5, every env strict), noise under the same Philox draws."""
    n, n_env, s_n, noisy, per_env, build, sms = EMULATED[case]
    lib = emulated_v2_small if build else emulated_v2
    lib.cuda_emu_set_sms(sms)
    rng = np.random.default_rng(n + 10 * noisy + 20 * per_env)
    ctas = lib.fused_adam_v2_start_ctas(n)
    group = bool(lib.fused_adam_v2_group_band(n))
    size = lib.fused_adam_v2_cluster_size(n, 0)
    top = CLUSTER_BIT + size.bit_length() - 1 if group else None
    cap = 16 if group and n < 17 else 12
    old, new = _tapes(rng, n, n_env, cap, top if n < 17 else None)
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
    ctl_gates = ()
    if CLUSTER_BIT < n < 17:
        # swaps through the bits above the warp bits' (cluster, or group
        # bits where there are), and the CX controlled from qubit n - 1
        lo = top if group else CLUSTER_BIT
        swaps, ctl = _rank_ops(old, n, lo, n, top)
        ctl_gates = (n - 6, n - 5) if group else (4, 5)
        assert swaps >= 1 and set(ctl_gates) <= set(ctl)
    if noisy:
        # an X or Y on the control of a CX controlled from a cluster (group)
        # bit, in some Adam iteration of some env
        hit = False
        for tag in range(3):
            _, kc = depolarizing_draw(old[0], noise["seeds"], tag,
                                      noise_thresholds(*NOISE))
            hit |= bool(torch.isin(kc[:, list(ctl_gates)],
                                   torch.tensor([_X, _Y])).any())
        assert hit
    try:
        _, got_ctas, got_group, xk, ek = fused_adam2d.run_kernel(
            lib, *args, iters=3, lr=0.1, stream=None,
            **(noise or dict(noise=None, seeds=None)))
    finally:
        lib.cuda_emu_set_sms(132)
    assert got_ctas == ctas == (1 << (n - CLUSTER_BIT) if n > CLUSTER_BIT
                                else 1)
    assert got_group == group == (n >= (14 if build else 17))
    plain = fused_adam2d.fused_adam_step2d_reference
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=plain,
                                   **noise)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         iters=3, step=plain, **noise)
    assert bool(ok.all()) and bool(strict.all())


def test_unschedulable_cluster_raises(emulated_v2, emulated_v2_small):
    """No fallback: a cluster whose CTAs ask for more shared memory than a
    CTA may have cannot be scheduled, and the check raises; so does a
    group kernel's start at more shared memory."""
    assert fused_adam2d.check_clusters(emulated_v2, 13, 100_000) >= 1
    with pytest.raises(RuntimeError, match=r"takes 1 cluster\(s\) of 2 CTAs"):
        fused_adam2d.check_clusters(emulated_v2, 13, 300_000)
    with pytest.raises(RuntimeError, match=r"takes 2 cluster\(s\) of 2 CTAs"):
        fused_adam2d.check_clusters(emulated_v2_small, 14, 300_000)
    # a card of 2 SMs holds 1 cluster of 2, not the 14q start's 2
    emulated_v2_small.cuda_emu_set_sms(2)
    try:
        with pytest.raises(RuntimeError, match="1 fit at once"):
            fused_adam2d.check_clusters(emulated_v2_small, 14, 100_001)
    finally:
        emulated_v2_small.cuda_emu_set_sms(132)
    assert emulated_v2.fused_adam_v2_cluster_size(12, 0) == 0
    assert [emulated_v2.fused_adam_v2_start_ctas(n)
            for n in (12, 13, 14, 15, 16, 17, 18)] == [1, 2, 4, 8, 16, 32, 64]
    assert [emulated_v2.fused_adam_v2_cluster_size(n, 0)
            for n in (13, 14, 15, 16)] == [2, 4, 8, 16]
    assert [emulated_v2.fused_adam_v2_group_band(n)
            for n in (12, 13, 16, 17, 18)] == [0, 0, 0, 1, 1]
    assert [emulated_v2_small.fused_adam_v2_group_band(n)
            for n in (13, 14, 18)] == [0, 1, 1]
    # a group kernel's cluster size: a power of 2 up to the largest cluster
    # and the start
    assert emulated_v2.fused_adam_v2_cluster_size(17, 16) == 16
    assert emulated_v2.fused_adam_v2_cluster_occupancy(17, 100_000, 32) < 0
    assert emulated_v2.fused_adam_v2_cluster_occupancy(17, 100_000, 6) < 0


class _OccupancyLib:
    """A library whose occupancy query counts its calls: 5 clusters up to
    200,000 B a CTA, none above; a start of 2^(n - 12) CTAs, in one
    cluster up to 16 qubits, in clusters of 2 above."""

    def __init__(self):
        self.queries = 0

    def fused_adam_v2_cluster_occupancy(self, n, smem, group_cluster):
        self.queries += 1
        return 5 if smem <= 200_000 else 0

    def fused_adam_v2_start_ctas(self, n):
        return 1 << (n - CLUSTER_BIT)

    def fused_adam_v2_cluster_size(self, n, group_cluster):
        return 1 << (n - CLUSTER_BIT) if n <= 16 else group_cluster or 2


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
        with pytest.raises(RuntimeError, match=r"1 cluster\(s\) of 4 CTAs"):
            fused_adam2d.check_clusters(lib, 14, 300_000)
    assert lib.queries == 5


def test_group_check_needs_a_whole_start():
    """The group kernel's start must be resident whole: 5 clusters of 2 do
    not hold the 17-qubit start of 16 clusters of 2, nor the 18-qubit one
    of 32 (the check raises, no fallback); 5 clusters of 16 hold the
    17-qubit start's 2."""
    lib = _OccupancyLib()
    with pytest.raises(RuntimeError, match=r"takes 16 cluster\(s\) of 2 CTAs"):
        fused_adam2d.check_clusters(lib, 17, 139_380)
    assert fused_adam2d.check_clusters(lib, 17, 139_380, group_cluster=16) == 5
    with pytest.raises(RuntimeError, match=r"takes 32 cluster\(s\) of 2 CTAs"
                       r".*5 fit at once"):
        fused_adam2d.check_clusters(lib, 18, 139_380)
