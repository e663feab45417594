"""The composed engine's double-precision tape kernels
(``csrc/apply_tape_f64.cu``, the double instance of ``csrc/
tape_sweep.cuh``: B3f / B3b on float64 planes at 1-20 qubits) run on the
host.

The source is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` (a fiber per CUDA thread, switched at
every barrier and shuffle) and bound like the card's library
(``ops/apply_tape.py:SweepLibrary``, the bindings of both instances).
Twice: as the card builds it (chunks of
up to 2^12 amplitudes), where a row of up to 12 qubits is one chunk, one
segment and one launch (3 and 8 qubits here); and with chunks of 2^7
amplitudes (``-DAPPLY_TAPE_F64_CHUNK_BITS=7``), where a segment holds
qubits 0..4 and two others, so that 9- and 10-qubit states cross many
segments.  Every gate class (RX / RY / RZ plain and controlled, CX, H, X,
Y, Z, RXX / RYY / RZZ, a shared angle slot, NONE padding,
tests/test_torch_tape_layout.py:_wide_case), several envs and starts,
each row its own psi0, and tapes woven with error Paulis (weave 3; above
the chunk read under the noiseless tape's segments, 2 trajectories of the
envs, as the composed engine lays them out).  In float64 the launches are
held to the plain versions (``apply_tape_fwd_plain`` /
``apply_tape_bwd_plain``, float64): forward planes within 1e-12 (a few
hundred double roundings of unit-norm amplitudes), psi0 cotangents and
angle gradients within 1e-10 (sums over the row in another order).  The
segment kernel's rows equal ``ops/fused_adam2d.py:sweep_segments`` word
for word; a repeated call agrees bit for bit, and the adjoint without psi0
cotangents gives the same gradients.  Run it before a card call that
follows an edit of the kernels.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.ops import apply_tape as at
from tensorrl_qas_tpu_torch.ops.fused_adam2d import sweep_segments
from tests.test_torch_tape_layout import _max_err, _wide_case

CSRC = pathlib.Path(at.__file__).resolve().parents[1] / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
TOL_FWD, TOL_BWD = 1e-12, 1e-10


def _build(out, chunk_bits=None):
    """csrc/apply_tape_f64.cu compiled for the host against tests/cuda_emu/
    (``chunk_bits``: smaller chunks), bound like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = out / f"libapply_tape_f64_emu{chunk_bits or ''}.so"
    define = ([f"-DAPPLY_TAPE_F64_CHUNK_BITS={chunk_bits}"] if chunk_bits
              else [])
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
                    "-x", "c++", f"-I{EMU}", f"-I{CSRC}", *define, "-o",
                    str(lib), str(CSRC / "apply_tape_f64.cu")],
                   check=True, capture_output=True, timeout=300)
    return at.SweepLibrary(ctypes.CDLL(str(lib)), "apply_tape_f64")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The source as the card builds it."""
    return _build(tmp_path_factory.mktemp("emu_tape_f64"))


@pytest.fixture(scope="module")
def emulated_small(tmp_path_factory):
    """The source with chunks of 2^7 amplitudes."""
    return _build(tmp_path_factory.mktemp("emu_tape_f647"), chunk_bits=7)


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _double(case):
    """A float32 ``_wide_case`` in float64 (the same values)."""
    planes, tape, angles, cot = case
    return (tuple(p.double() for p in planes), tape, angles.double(),
            tuple(c.double() for c in cot))


def _twin(tape, n, chunk_bits):
    """(E, 3 G + 2) segment words of (E, G) noiseless tapes by the twin."""
    kind, tq, cq = (a.numpy() for a in tape[:3])
    return np.asarray([sweep_segments(kind[e], tq[e], cq[e], n, chunk_bits)
                       for e in range(kind.shape[0])], np.int32)


def _launch(lib, planes, tape, angles, cot, **kw):
    out = at.run_sweep_fwd(lib, *planes, tape, angles, **kw)
    grads = at.run_sweep_bwd(lib, *out, *cot, tape, angles, **kw)
    return out, grads


def _held_to_plain(lib, case, n, woven=None):
    """Both kernels against the plain versions in float64 (on ``woven``,
    the woven tape, when given; above the chunk under the noiseless tape's
    segments, checked against their twin), a repeat bit for bit and the
    adjoint without psi0 cotangents.  -> the segments of each env's tape
    (1 where the row is one chunk)."""
    planes, tape, angles, cot = case
    cb = lib.chunk_bits()
    kw, segments = {}, torch.ones(tape[0].shape[0], dtype=torch.int32)
    if n > cb:
        sched = at.run_sweep_schedule(lib, tape, n)
        np.testing.assert_array_equal(sched.numpy(), _twin(tape, n, cb))
        kw, segments = dict(schedule=sched), sched[:, 0]
    run_tape = tape
    if woven is not None:
        run_tape, kw = woven, dict(kw, weave=3)
    out, grads = _launch(lib, planes, run_tape, angles, cot, **kw)
    assert all(t.dtype == torch.float64 for t in (*out, *grads))
    out_p = at.apply_tape_fwd_plain(*planes, *run_tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *run_tape, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD
    assert float(grads[2].abs().max()) > 1e-2          # gradients present
    out2, grads2 = _launch(lib, planes, run_tape, angles, cot, **kw)
    assert all(torch.equal(a, b) for a, b in zip((*out, *grads),
                                                (*out2, *grads2)))
    lean = at.run_sweep_bwd(lib, *out, *cot, run_tape, angles,
                          psi0_grad=False, **kw)
    assert lean[:2] == (None, None) and torch.equal(lean[2], grads[2])
    return segments


# (qubits, envs, starts, gates): one chunk a row in the card's build (3q,
# 8q); the small build's chunks of 2^7 (9q, 10q)
WHOLE = {"3q": (3, 2, 3, 24), "8q": (8, 3, 2, 30)}
SMALL = {"9q": (9, 3, 2, 36), "10q": (10, 1, 2, 40)}


@pytest.mark.parametrize("shape", list(WHOLE))
def test_emulated_f64_kernels_one_chunk_a_row(emulated, shape, one_thread):
    n, n_env, s_n, n_gates = WHOLE[shape]
    assert emulated.chunk_bits() == 12
    assert emulated.max_qubits() == at.MAX_QUBITS
    assert emulated.max_segments(n_gates + 2, n) == 1
    case, _ = _wide_case(n, n_env, s_n, seed=90 + n, n_gates=n_gates)
    segments = _held_to_plain(emulated, _double(case), n)
    assert segments.tolist() == [1] * n_env


@pytest.mark.parametrize("shape", list(SMALL))
def test_emulated_f64_kernels_across_segments(emulated_small, shape,
                                              one_thread):
    n, n_env, s_n, n_gates = SMALL[shape]
    case, _ = _wide_case(n, n_env, s_n, seed=70 + n, n_gates=n_gates)
    segments = _held_to_plain(emulated_small, _double(case), n)
    assert int(segments.max()) >= 3        # states cross many segments


@pytest.mark.parametrize("build,n", [("whole", 8), ("small", 9)])
def test_emulated_f64_kernels_on_woven_tapes(emulated, emulated_small, build,
                                             n, one_thread):
    """Tapes woven with error Paulis on targets and controls, rows of 2
    trajectories x 2 envs (above the chunk row e reads the segments' row e
    % 2), held to the plain versions on the woven tapes."""
    lib = emulated if build == "whole" else emulated_small
    case, woven = _wide_case(n, 2, 2, seed=80 + n, n_gates=30, woven=True)
    planes, tape, angles, cot = _double(case)
    kt = torch.tensor([int(k) for k in woven[0][:, 1::3].flatten()])
    assert int((kt > 0).sum()) > 5                     # errors fire
    rows = tuple(torch.cat([p, p.flip(-1)]) for p in planes)
    case2 = (rows, tape, torch.cat([angles, angles + 0.5]),
             tuple(torch.cat([c, -c]) for c in cot))
    woven2 = tuple(torch.cat([a, a]) for a in woven)
    _held_to_plain(lib, case2, n, woven=woven2)


def test_f64_launch_shapes(emulated, emulated_small):
    """A CTA's threads (a thread a pair, one warp to 256), its shared
    memory (psi, and lambda for the adjoint, 16 B an amplitude of the
    chunk), the segments' bound (one up to the chunk, (G - 1) // 3 + 1 at
    12-bit chunks above), and refused shapes."""
    assert [emulated.threads(n) for n in (1, 6, 8, 9, 12, 20)] == [
        32, 32, 128, 256, 256, 256]
    fwd, bwd = (emulated.smem_bytes(adj, 12) for adj in (0, 1))
    assert bwd - fwd == 16 << 12 and fwd > 16 << 12
    assert bwd < 227 * 1024
    assert emulated.smem_bytes(1, 20) == bwd
    assert emulated.smem_bytes(0, 8) == fwd - (16 << 12) + (16 << 8)
    assert emulated.ctas_per_sm(1, 20) == 1
    for g in (1, 2, 46, 97):
        assert emulated.max_segments(g, 12) == 1
        assert emulated.max_segments(g, 20) == (g - 1) // 3 + 1
    rng = np.random.default_rng(5)
    for _ in range(10):
        g = int(rng.integers(1, 60))
        kinds = rng.integers(1, 12, g)
        tq = rng.integers(0, 20, g)
        cq = np.where(kinds >= 9, (tq + 1 + rng.integers(0, 19, g)) % 20, -1)
        assert sweep_segments(kinds, tq, cq, 20)[0] <= (
            emulated.max_segments(g, 20))
    # above the chunk a launch needs its segments; 21 qubits and mixed
    # dtypes are refused
    planes = tuple(torch.zeros(1, 1, 1 << 9, dtype=torch.float64)
                   for _ in range(2))
    tape = tuple(torch.zeros(1, 2, dtype=torch.int32) for _ in range(4))
    angles = torch.zeros(1, 1, 1, dtype=torch.float64)
    ptrs = [*(t.data_ptr() for t in (*tape, angles, *planes, *planes))]
    with pytest.raises(RuntimeError, match="apply_tape_f64_fwd"):
        at._launch_sweep(emulated_small, "fwd", *ptrs, None, 0, 1, 1, 1,
                         2, 1, 9, None)
    with pytest.raises(TypeError, match="float32 or float64"):
        at._check("apply_tape_fwd", (planes[0].float(), planes[1]), tape,
                  angles, True, None, 1)
    big = tuple(torch.zeros(1, 1, 1 << 21, dtype=torch.float64)
                for _ in range(2))
    with pytest.raises(ValueError, match="EnvConfig.mesh_shape"):
        at._check("apply_tape_fwd", big, tape, angles, True, None, 1)
