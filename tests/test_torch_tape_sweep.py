"""The composed engine's sweep tape kernels (``csrc/apply_tape_sweep.cu``,
B3f / B3b at 17-20 qubits) run on the host.

The source is compiled by the host's C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` (a fiber per CUDA thread, switched at
every barrier and shuffle) and bound like the card's library
(``ops/apply_tape.py:SweepLibrary``).  Twice: as the card builds it (chunks
of 2^12 amplitudes, 17-20 qubits), held at 17 qubits on a tiny tape that
crosses two segments; and with chunks of 2^7 amplitudes from 8 qubits
(``-DAPPLY_TAPE_SWEEP_CHUNK_BITS=7 -DAPPLY_TAPE_SWEEP_MIN_QUBITS=8``),
where a segment holds qubits 0..4 and two others, so that small states
cross many segments: every gate class (RX / RY / RZ plain and controlled,
CX, H, X, Y, Z, RXX / RYY / RZZ, a shared angle slot, NONE padding,
tests/test_torch_tape_layout.py:_wide_case), several envs and starts,
each row its own psi0, and tapes woven with error Paulis (weave 3, read
under the noiseless tape's schedule; 2 trajectories of the envs, as the
composed engine lays them out).  In float32 the launches are held to the
plain versions (``apply_tape_fwd_plain`` / ``apply_tape_bwd_plain``):
forward planes within 1e-5, psi0 cotangents and angle gradients within
1e-4.  The segment kernel's rows equal ``ops/fused_adam2d.py:
sweep_segments`` (the kernels' twin) word for word; a repeated call
agrees bit for bit, and the adjoint without psi0 cotangents gives the
same gradients; more than 20 qubits raise.  Run it before a card call
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
from tensorrl_qas_tpu_torch.ops.fused_adam2d import sweep_segments
from tests.test_torch_tape_layout import _max_err, _wide_case

CSRC = pathlib.Path(at.__file__).resolve().parents[1] / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
# the emulated card's SMs (one CTA each): a call's persistent grid at most
SMS = 6
TOL_FWD, TOL_BWD = 1e-5, 1e-4
K = GateKind


def _build(out, chunk_bits=None):
    """csrc/apply_tape_sweep.cu compiled for the host against
    tests/cuda_emu/ (``chunk_bits``: smaller chunks, from 8 qubits), bound
    like the card's library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = out / f"libapply_tape_sweep_emu{chunk_bits or ''}.so"
    define = ([f"-DAPPLY_TAPE_SWEEP_CHUNK_BITS={chunk_bits}",
               "-DAPPLY_TAPE_SWEEP_MIN_QUBITS=8"] if chunk_bits else [])
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
                    "-x", "c++", f"-I{EMU}", f"-I{CSRC}", *define, "-o",
                    str(lib), str(CSRC / "apply_tape_sweep.cu")],
                   check=True, capture_output=True, timeout=300)
    cdll = ctypes.CDLL(str(lib))
    cdll.cuda_emu_set_sms(SMS)
    return at.SweepLibrary(cdll, "apply_tape_sweep")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The source as the card builds it."""
    return _build(tmp_path_factory.mktemp("emu_tape_sweep"))


@pytest.fixture(scope="module")
def emulated_small(tmp_path_factory):
    """The source with chunks of 2^7 amplitudes, from 8 qubits."""
    return _build(tmp_path_factory.mktemp("emu_tape_sweep7"), chunk_bits=7)


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """Both kernels against the plain versions (on ``woven``, the woven
    tape, when given, under the noiseless tape's schedule), the schedule
    against its twin, a repeat bit for bit and the adjoint without psi0
    cotangents.  -> the segments of each env's tape."""
    planes, tape, angles, cot = case
    sched = at.run_sweep_schedule(lib, tape, n)
    np.testing.assert_array_equal(
        sched.numpy(), _twin(tape, n, lib.chunk_bits()))
    run_tape, kw = tape, dict(schedule=sched)
    if woven is not None:
        run_tape, kw = woven, dict(schedule=sched, weave=3)
    out, grads = _launch(lib, planes, run_tape, angles, cot, **kw)
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
    return sched[:, 0]


# (qubits, envs, starts, gates): the small build's chunks of 2^7
SMALL = {"8q": (8, 2, 3, 30), "9q": (9, 3, 2, 36), "10q": (10, 1, 2, 40)}


@pytest.mark.parametrize("shape", list(SMALL))
def test_emulated_sweep_tape_kernels_match_plain_versions(
        emulated_small, shape, one_thread):
    n, n_env, s_n, n_gates = SMALL[shape]
    case, _ = _wide_case(n, n_env, s_n, seed=70 + n, n_gates=n_gates)
    segments = _held_to_plain(emulated_small, case, n)
    assert int(segments.max()) >= 3        # states cross many segments


@pytest.mark.parametrize("n", [8, 9])
def test_emulated_sweep_tape_kernels_on_woven_tapes(emulated_small, n,
                                                    one_thread):
    """Tapes woven with error Paulis on targets and controls, rows of 2
    trajectories x 2 envs (row e reads the schedule's row e % 2), held to
    the plain versions on the woven tapes."""
    case, woven = _wide_case(n, 2, 2, seed=80 + n, n_gates=30, woven=True)
    planes, tape, angles, cot = case
    kt = torch.tensor([int(k) for k in woven[0][:, 1::3].flatten()])
    assert int((kt > 0).sum()) > 5                     # errors fire
    rows = tuple(torch.cat([p, p.flip(-1)]) for p in planes)
    case2 = (rows, tape, torch.cat([angles, angles + 0.5]),
             tuple(torch.cat([c, -c]) for c in cot))
    woven2 = tuple(torch.cat([a, a]) for a in woven)
    _held_to_plain(emulated_small, case2, n, woven=woven2)


def _tiny_17q():
    """A 17-qubit tape of 7 gates whose two-qubit gates' qubits above qubit
    4 number 8 (two segments of the card's chunks), with a control, RYY,
    RZZ and H; one env, one start."""
    n = 17
    gates = [(K.RXX, 5, 6, 0), (K.RYY, 7, 8, 1), (K.H, 0, -1, -1),
             (K.RY, 9, 10, 2), (K.RZZ, 11, 12, 3), (K.CX, 14, 16, -1),
             (K.RX, 3, -1, 4)]
    arrs = [np.array([[g[i] for g in gates]], np.int32) for i in range(4)]
    rng = np.random.default_rng(17)
    d = 1 << n
    psi = rng.normal(size=(1, 1, d)) + 1j * rng.normal(size=(1, 1, d))
    psi /= np.linalg.norm(psi)
    lam = rng.normal(size=(2, 1, 1, d))
    f32 = dict(dtype=torch.float32)
    return n, ((torch.as_tensor(psi.real, **f32),
                torch.as_tensor(psi.imag, **f32)),
               tuple(torch.as_tensor(a) for a in arrs),
               torch.as_tensor(rng.normal(size=(1, 1, 5)), **f32),
               (torch.as_tensor(lam[0], **f32),
                torch.as_tensor(lam[1], **f32)))


def test_emulated_sweep_tape_kernels_at_17_qubits(emulated, one_thread):
    n, case = _tiny_17q()
    assert emulated.chunk_bits() == 12
    assert (emulated.min_qubits(),
            emulated.max_qubits()) == (17, 20)
    segments = _held_to_plain(emulated, case, n)
    assert segments.tolist() == [2]
    assert emulated.max_segments(7, n) >= 2


def test_max_segments_bounds_every_tape(emulated_small):
    """The segments' bound, which bounds a call's items (its persistent
    grid is at most E S chunks x that), covers the most segments a tape
    can have: one gate a segment at the small build's chunks from 8
    qubits, one segment at most 7 qubits' worth of them; the card's build
    at a third of the gates plus one."""
    case, _ = _wide_case(10, 4, 1, seed=3, n_gates=50)
    tape = case[1]
    words = _twin(tape, 10, 7)
    bound = emulated_small.max_segments(tape[0].shape[1],
                                                         10)
    assert int(words[:, 0].max()) <= bound == tape[0].shape[1]
    for g in (1, 2, 3, 46, 97):
        assert at.sweep_words(g) == 3 * g + 2
        assert emulated_small.max_segments(g, 7) == 1
    # every segment but the last holds 3 live gates or more at 12-bit
    # chunks: random 20-qubit tapes stay inside (G - 1) // 3 + 1
    rng = np.random.default_rng(5)
    for _ in range(20):
        g = int(rng.integers(1, 60))
        kinds = rng.integers(1, 12, g)
        tq = rng.integers(0, 20, g)
        cq = np.where(kinds >= 9, (tq + 1 + rng.integers(0, 19, g)) % 20, -1)
        assert sweep_segments(kinds, tq, cq, 20)[0] <= (g - 1) // 3 + 1


def test_more_than_20_qubits_raise(emulated):
    """The wrappers' check names the sharded path; the launch refuses the
    qubit count."""
    n = 21
    planes = tuple(torch.zeros(1, 1, 1 << n) for _ in range(2))
    tape = tuple(torch.zeros(1, 2, dtype=torch.int32) for _ in range(4))
    angles = torch.zeros(1, 1, 1)
    with pytest.raises(ValueError, match="EnvConfig.mesh_shape"):
        at._check("apply_tape_fwd", planes, tape, angles, True, None, 1)
    sched = torch.zeros(1, at.sweep_words(2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="apply_tape_sweep_fwd"):
        at.run_sweep_fwd(emulated, *planes, tape, angles, schedule=sched)


def test_emulated_sweep_tape_grid_smaller_than_the_items(emulated_small,
                                                         one_thread):
    """A card of 2 SMs: the forward's and the adjoint's grid of 2 CTAs
    walks every item of the call (a launch each, the adjoint's gradient sum
    one more), held to the plain versions, with the bits of a grid of SMS
    CTAs; at 7-bit chunks both keep two chunk buffers (psi; psi and
    mu)."""
    n = 9
    case, _ = _wide_case(n, 3, 2, seed=79, n_gates=36)
    sched = at.run_sweep_schedule(emulated_small, case[1], n)
    items = int(sched[:, 0].sum()) * 2 << (n - 7)
    wide = _launch(emulated_small, case[0], case[1], case[2], case[3],
                   schedule=sched)
    emulated_small.lib.cuda_emu_set_sms(2)
    try:
        assert emulated_small.resident_ctas(0, n) == 2 < items
        _held_to_plain(emulated_small, case, n)
        small = _launch(emulated_small, case[0], case[1], case[2], case[3],
                        schedule=sched)
    finally:
        emulated_small.lib.cuda_emu_set_sms(SMS)
    assert all(torch.equal(a, b) for a, b in zip((*wide[0], *wide[1]),
                                                (*small[0], *small[1])))
    assert [emulated_small.stages(adj) for adj in (0, 1)] == [2, 2]
    assert emulated_small.smem_bytes(1, n) - emulated_small.smem_bytes(
        0, n) == 2 * 2 * 4 << 7
