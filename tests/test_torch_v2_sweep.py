"""The sweep kernel (v2 at 19-20 qubits, ``csrc/fused_adam_v2_sweep.cu``)
run on the host, its segment schedule against its Python twin, its
in-kernel W against the flip-group planes, and its residency check.

The source is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` (a fiber per CUDA thread; a cooperative
launch runs its whole grid at once and is refused when the grid exceeds
the emulated card's SMs; a spin on a barrier's counter yields its fiber)
and bound like the card's library (``ops/fused_adam2d.py:bind_sweep``).
Twice: as the card builds it (chunks of 2^12 amplitudes, 19-20 qubits),
held at 19 qubits with a tiny tape, 1 Adam iteration and E = S = 1; and
with chunks of 2^7 amplitudes from 8 qubits, where small states cross
many segments (a segment then holds qubits 0..4 and two others), held at
3 Adam iterations with several envs and
starts, in one slot and in several, with noise (the same Philox draws as
the plain version), with a psi0 per env, at E = 1, at the in_state
capacity G = 388 and on a card of one SM.  Every result is held to the
plain version by the card's rule (``agreement``, 1e-5, every env strict),
and every schedule the kernel builds (old and new tape of every env)
equals ``sweep_segments`` word for word.  A
repeated launch on another grid and other slots, the noise variant at p =
0 against the noiseless launch, and W computed from the terms against W
read from the planes, agree bit for bit; the in-kernel W equals
``pauli_flip_groups``' float32 planes bit for bit.  The residency check
raises where no CTA fits (no fallback), asks the runtime once per shape,
and a grid larger than the card holds at once is refused by the
cooperative launch.  Run it before a card call that follows an edit of
the kernel.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d
from tensorrl_qas_tpu_torch.ops.fused_adam2d import (
    flip_group_terms,
    pauli_flip_groups,
    sweep_segments,
)
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.problems.hamiltonians import load_problem
from tests.test_torch_v2_cluster import _tapes, heisenberg_chain

CSRC = pathlib.Path(fused_adam.__file__).resolve().parents[1] / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
NOISE = (0.2, 0.5)
H2O = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"


def _build(out, chunk_bits=None):
    """csrc/fused_adam_v2_sweep.cu compiled for the host against
    tests/cuda_emu/ (``chunk_bits``: smaller chunks, from 8 qubits), bound
    like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = out / f"libfused_adam_v2_sweep_emu{chunk_bits or ''}.so"
    define = ([f"-DFUSED_ADAM_SWEEP_CHUNK_BITS={chunk_bits}",
               "-DFUSED_ADAM_SWEEP_MIN_QUBITS=8"] if chunk_bits else [])
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
                    "-x", "c++", f"-I{EMU}", f"-I{CSRC}", *define, "-o",
                    str(lib), str(CSRC / "fused_adam_v2_sweep.cu")],
                   check=True, capture_output=True, timeout=300)
    return fused_adam2d.bind_sweep(ctypes.CDLL(str(lib)))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The source as the card builds it."""
    return _build(tmp_path_factory.mktemp("emu_sweep"))


@pytest.fixture(scope="module")
def emulated_small(tmp_path_factory):
    """The source with chunks of 2^7 amplitudes, from 8 qubits."""
    return _build(tmp_path_factory.mktemp("emu_sweep7"), chunk_bits=7)


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(n, n_env, s_n, cap, per_env, noisy, seed, terms=True):
    """Kernel inputs on the open Heisenberg chain: ``_tapes``'s random
    tapes (identity map), a random psi0 (a row per env with ``per_env``),
    random starts, every angle active; the kernel's keywords (noise, and
    the chain's flip-group terms unless ``terms`` is False)."""
    rng = np.random.default_rng(seed)
    old, new = _tapes(rng, n, n_env, cap)
    ints = lambda arrs: tuple(a.to(torch.int32) for a in arrs)  # noqa: E731
    rows = n_env if per_env else 1
    psi0 = rng.normal(size=(rows, 1 << n)) + 1j * rng.normal(
        size=(rows, 1 << n))
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    f32 = dict(dtype=torch.float32)
    opt = AngleOptimizer(heisenberg_chain(n), device="cpu")
    w = opt.w_planes()
    args = (ints(old), ints(new),
            torch.arange(cap, dtype=torch.int32).repeat(n_env, 1),
            torch.as_tensor(psi0.real, **f32),
            torch.as_tensor(psi0.imag, **f32), w[0].float(), w[1].float(),
            w[2], torch.as_tensor(0.5 * rng.normal(size=(n_env, s_n, cap)),
                                  **f32),
            torch.ones(n_env, 1, cap, **f32))
    kw = dict(noise=None, seeds=None, terms=opt.w_terms() if terms else None)
    if noisy:
        kw.update(noise=NOISE, seeds=torch.as_tensor(
            rng.integers(0, 2**31 - 1, (n_env, 2)), dtype=torch.int32))
    return args, kw


def _run(lib, args, kw, iters, sms, slots=None):
    """The kernel on a card of ``sms`` SMs (its residency asked anew)."""
    lib.cuda_emu_set_sms(sms)
    fused_adam2d._resident.clear()
    try:
        return fused_adam2d.run_sweep_kernel(lib, *args, iters=iters, lr=0.1,
                                             stream=None, slots=slots, **kw)
    finally:
        lib.cuda_emu_set_sms(132)


def _twin_schedules(args, n, chunk_bits):
    """(2, E, 3 G + 2) schedule words of both tapes by the twin."""
    return torch.as_tensor([[sweep_segments(*(a[e].numpy() for a in tape[:3]),
                                            n, chunk_bits)
                             for e in range(tape[0].shape[0])]
                            for tape in args[:2]], dtype=torch.int32)


# (qubits, envs, starts, tape capacity, noise, per-env psi0, build: "" the
# card's, "small" chunks of 2^7; the emulated card's SMs, slots (None: the
# library's pick), Adam iterations)
EMULATED = {
    "19q as the card builds it": (19, 1, 1, 16, False, False, "", 2, None,
                                  1),
    "9q": (9, 2, 3, 12, False, False, "small", 3, 1, 3),
    "10q noise": (10, 2, 3, 16, True, False, "small", 3, 2, 3),
    "9q per-env psi0": (9, 3, 2, 12, False, True, "small", 4, 3, 3),
    "11q one SM": (11, 1, 3, 16, False, False, "small", 1, None, 3),
    "10q noise per-env psi0": (10, 2, 2, 14, True, True, "small", 4, None,
                               3),
    "10q E=1": (10, 1, 4, 16, False, False, "small", 4, 2, 3),
    "9q in_state capacity G=388": (9, 2, 2, 388, False, False, "small", 2,
                                   None, 2),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_sweep_kernel_matches_plain_version(
        emulated, emulated_small, case, one_thread):
    """The kernel's own source, run on the host in float32, held to the
    plain version by the card's rule, and its schedules to the twin."""
    (n, n_env, s_n, cap, noisy, per_env, build, sms, slots,
     iters) = EMULATED[case]
    lib = emulated_small if build else emulated
    args, kw = _args(n, n_env, s_n, cap, per_env, noisy,
                     seed=n + 10 * noisy + 20 * per_env)
    stride, ctas, xk, ek, scratch = _run(lib, args, kw, iters, sms, slots)
    assert ctas == sms and stride == (1 << n if per_env and n_env > 1
                                      else 0)
    assert scratch["slots"] == (slots or lib.fused_adam_sweep_slots(
        n, n_env * s_n, min(ctas, n_env * s_n << (
            n - lib.fused_adam_sweep_chunk_bits()))))
    sched = _twin_schedules(args, n, lib.fused_adam_sweep_chunk_bits())
    torch.testing.assert_close(scratch["sched"], sched, rtol=0, atol=0)
    # the small build's tapes cross several segments
    assert int(sched[0, :, 0].max()) >= (2 if n == 19 else 3)
    plain = fused_adam2d.fused_adam_step2d_reference
    nz = dict(noise=kw["noise"], seeds=kw["seeds"]) if noisy else {}
    if build:
        ref = fused_adam.plain_results(args, iters=iters, lr=0.1, step=plain,
                                       **nz)
    else:     # 19q: the plain float32 and float64 runs
        ref = [plain(*a, iters=iters, lr=0.1, **nz)
               for a in (args, fused_adam._to64(args))]
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         iters=iters, step=plain, **nz)
    assert bool(ok.all()) and bool(strict.all())


def test_emulated_sweep_kernel_repeats_bit_for_bit(emulated_small,
                                                   one_thread):
    """Fixed-order sums: a repeated launch of the noise variant on another
    grid in other slots gives the same bits; the noise variant at p = 0
    is the noiseless launch bit for bit; so is W read from the planes
    against W computed from the terms; the barriers of one slot are those
    of three slots together (a slot's are its starts' and its envs'
    e_new)."""
    args, kw = _args(9, 2, 3, 12, False, True, seed=3)
    _, _, x1, e1, s1 = _run(emulated_small, args, kw, 3, 3, 3)
    _, _, x2, e2, s2 = _run(emulated_small, args, kw, 3, 2, 1)
    assert torch.equal(x1, x2) and torch.equal(e1, e2)
    per_slot, grid = s1["barriers"].counts()
    assert grid == 3 and len(per_slot) == 3
    assert s2["barriers"].counts()[0] == [sum(per_slot)]
    quiet = dict(kw, noise=None, seeds=None)
    _, _, x0, e0, _ = _run(emulated_small, args, quiet, 3, 3)
    _, _, xp, ep, _ = _run(emulated_small, args, dict(kw, noise=(0.0, 0.0)),
                           3, 3)
    assert torch.equal(xp, x0) and torch.equal(ep, e0)
    _, _, xw, ew, _ = _run(emulated_small, args, dict(quiet, terms=None), 3,
                           3)
    assert torch.equal(xw, x0) and torch.equal(ew, e0)
    assert not torch.equal(x1, x0)


@pytest.mark.parametrize("problem", ["heisenberg 10q", "H2O 8q"])
def test_in_kernel_w_equals_flip_group_planes(emulated_small, problem):
    """The kernel's W of every group it computes (those of at most
    ``fused_adam_sweep_compute_terms`` terms) equals ``pauli_flip_groups``'
    float32 plane bit for bit, on every group of a Heisenberg chain (XX +
    YY bond groups of 2 terms computed, the diagonal group read) and of
    8q H2O (its -70 Ha identity term off the f = 0 group as the
    optimizer's offset)."""
    if problem.startswith("H2O"):
        pauli = load_problem("H2O", 8, H2O).pauli
    else:
        pauli = heisenberg_chain(10)
    n = pauli.n_qubits
    offset = AngleOptimizer(pauli, device="cpu").offset
    wre, wim, flips = pauli_flip_groups(pauli, offset)
    terms = flip_group_terms(pauli, offset)
    kre, kim, computed = fused_adam2d.sweep_w_planes(
        emulated_small, torch.as_tensor(flips), torch.as_tensor(wim), terms,
        n)
    assert int(computed.sum()) >= 2
    if n == 10:
        assert int((~computed).sum()) == 1
    for f in np.nonzero(computed.numpy())[0]:
        assert np.array_equal(kre[f].numpy(), wre[f]), f
        assert np.array_equal(kim[f].numpy(), wim[f]), f


def test_segment_twin():
    """The twin's words: qubits 0..4 ride every segment free, a gate whose
    qubits would give its segment more than chunk_bits - 5 others starts
    a new one, NONE gates are skipped, and a tape with no live gate has one
    empty segment whose local qubits are the lowest ones."""
    rx, cx = 1, 4
    kind = np.array([rx, cx, 0, rx, rx, cx, rx])
    tq = np.array([0, 8, 0, 9, 12, 3, 13])
    cq = np.array([-1, 2, -1, -1, -1, 14, -1])
    words = sweep_segments(kind, tq, cq, 16, chunk_bits=7)
    g = len(kind)
    low = 0b11111
    # {8}, {9}: full (2 others); {12}, {14}: full; {13}
    assert words[0] == 3
    assert words[1:5] == [0, 3, 5, 6] and words[5:g + 2] == [-1] * 4
    assert words[g + 2:g + 5] == [low | 1 << 8 | 1 << 9,
                                  low | 1 << 12 | 1 << 14,
                                  low | 1 << 5 | 1 << 13]
    assert words[2 * g + 2:] == [0, 1, 3, 4, 5, 6, -1]
    empty = sweep_segments(np.zeros(3, int), np.zeros(3, int),
                           np.full(3, -1), 20)
    assert empty == [1, 0, 0, -1, -1, (1 << 12) - 1, -1, -1, -1, -1, -1]


def test_slots_hold_the_l2_budget(emulated):
    """The library's pick of slots on the card's 396 CTAs: of the counts
    whose starts' psi and lambda (16 B an amplitude) 64 MB holds, no more
    than the starts or the CTAs, the fewest chunk rounds a launch (a
    slot's starts in turn times a pass's rounds), then the fewest slots:
    3 at 20 qubits and 19 with 32 starts (two rounds of 132 CTAs at 20,
    one at 19), 4 at 20 qubits with 4 starts (E = 1), at least one."""
    slots = emulated.fused_adam_sweep_slots
    assert (slots(20, 32, 396), slots(19, 32, 396), slots(20, 4, 396)) == (
        3, 3, 4)
    assert (slots(20, 1, 396), slots(19, 3, 396), slots(20, 32, 1)) == (
        1, 3, 1)


def test_residency_check_raises_where_no_cta_fits(emulated_small):
    """No fallback: a CTA that asks for more shared memory than one may
    have fits nowhere, and the check raises; a fitting one is held once a
    card SM; a grid larger than the card holds at once (a stale count) is
    refused by the cooperative launch."""
    emulated_small.cuda_emu_set_sms(5)
    try:
        assert fused_adam2d.check_residency(emulated_small, 100_000) == 5
        with pytest.raises(RuntimeError, match="cannot hold one: none fits"):
            fused_adam2d.check_residency(emulated_small, 300_000)
        args, kw = _args(10, 1, 4, 8, False, False, seed=1)
        smem = emulated_small.fused_adam_sweep_smem_bytes(
            8, args[7].numel())
        key = (emulated_small, smem, torch.device("cpu"))
        fused_adam2d._resident[key] = 6
        with pytest.raises(RuntimeError, match="fused_adam_sweep launch "
                                               "failed"):
            fused_adam2d.run_sweep_kernel(emulated_small, *args, iters=1,
                                          lr=0.1, stream=None, **kw)
    finally:
        fused_adam2d._resident.clear()
        emulated_small.cuda_emu_set_sms(132)
    assert (emulated_small.fused_adam_sweep_min_qubits(),
            emulated_small.fused_adam_sweep_max_qubits()) == (8, 20)


class _ResidencyLib:
    """A library whose residency query counts its calls: 264 CTAs up to
    100,000 B a CTA, none above 200,000 B, a CUDA error between."""

    def __init__(self):
        self.queries = 0

    def fused_adam_sweep_resident_ctas(self, smem):
        self.queries += 1
        return 264 if smem <= 100_000 else 0 if smem > 200_000 else -1

    def fused_adam_sweep_error_string(self, code):
        return b"invalid value"


def test_residency_check_asks_once_per_shape():
    """A launch after the first of its shape asks the runtime nothing; a
    shape that fits no CTA raises every time (no verdict is kept)."""
    lib = _ResidencyLib()
    try:
        for _ in range(3):
            assert fused_adam2d.check_residency(lib, 88_000) == 264
        assert lib.queries == 1
        for _ in range(2):
            with pytest.raises(RuntimeError, match="none fits"):
                fused_adam2d.check_residency(lib, 300_000)
        with pytest.raises(RuntimeError, match=r"CUDA error 1 \(invalid"):
            fused_adam2d.check_residency(lib, 150_000)
        assert lib.queries == 4
    finally:
        fused_adam2d._resident.clear()


def test_wrapper_dispatches_19_and_20_qubits_to_the_sweep_kernel(
        monkeypatch):
    """On a CUDA tensor at 19 or 20 qubits the wrapper launches the sweep
    kernel alone, with the terms it was given, counted in ``launches`` and
    ``sweep_launches``; at 18 the group kernel's path (``run_kernel``).
    Both kernels are stand-ins here (no card): only the dispatch is
    checked."""
    calls = []

    def sweep(lib, *a, terms=None, **kw):
        calls.append(("sweep", terms))
        return 0, 264, torch.zeros(1, 2), torch.zeros(1), None

    def group(lib, *a, **kw):
        calls.append(("v2", None))
        return 0, 64, True, torch.zeros(1, 2), torch.zeros(1)

    monkeypatch.setattr(fused_adam2d, "run_sweep_kernel", sweep)
    monkeypatch.setattr(fused_adam2d, "run_kernel", group)
    monkeypatch.setattr(fused_adam2d, "_sweep_library", lambda: None)
    monkeypatch.setattr(fused_adam2d, "_library", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    step = fused_adam2d.fused_adam_step2d
    before = (step.launches, step.sweep_launches, step.group_launches)
    for n in (19, 20, 18):
        meta = torch.empty(1, 1, 2, device="meta")
        starts = type("T", (), {"device": torch.device("cuda")})()
        step((), (), None, torch.empty(1, 1 << n, device="meta"), None, None,
             None, None, starts, meta, iters=1, lr=0.1, terms=n)
    assert calls == [("sweep", 19), ("sweep", 20), ("v2", None)]
    assert (step.launches - before[0], step.sweep_launches - before[1],
            step.group_launches - before[2]) == (3, 2, 1)
