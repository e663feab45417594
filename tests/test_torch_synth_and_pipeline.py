"""The port's KAK synthesis (``synth/kak.py``) and warm-start pipeline
(``tn/pipeline.py``): twins of the JAX package's
tests/test_synth_and_pipeline.py on the port's modules, and the pipeline
against the JAX package's on the same inputs, on the CPU in complex128.

Parity tolerances (``build_warmstart`` at maxiter 3000, the defaults of
the data tool): ``e_dmrg`` 1e-10 (the same host DMRG; BLAS products in
the MPO compression move the last bits), ``e_circuit`` and the overlap
1e-8 (3000 Stiefel-Adam iterations whose late iterates oscillate in both
packages: what is compared is the best-so-far iterate), equal CNOT
counts.  The twins keep the JAX tests' own tolerances.
"""

import glob
import pathlib

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.problems.hamiltonians import heisenberg_hamiltonian
from tensorrl_qas_tpu_torch.synth.kak import (
    CX01,
    closest_unitary,
    decompose_su4,
    kron,
    makhlin_invariants,
    rx,
    ry,
    rz,
    zyz_angles,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_tn.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_su4(rng):
    from scipy.stats import unitary_group

    return unitary_group.rvs(4, random_state=rng)


# -- twins of tests/test_synth_and_pipeline.py ------------------------------

def test_zyz_reconstruction():
    rng = np.random.default_rng(0)
    from scipy.stats import unitary_group

    for _ in range(20):
        u = unitary_group.rvs(2, random_state=rng)
        alpha, a, b, c = zyz_angles(u)
        rec = np.exp(1j * alpha) * (rz(a) @ ry(b) @ rz(c))
        np.testing.assert_allclose(rec, u, atol=1e-10)
    # edge: diagonal and anti-diagonal
    for u in (np.diag([1, 1j]), np.array([[0, 1], [-1, 0]], dtype=complex)):
        alpha, a, b, c = zyz_angles(u)
        rec = np.exp(1j * alpha) * (rz(a) @ ry(b) @ rz(c))
        np.testing.assert_allclose(rec, u, atol=1e-10)


def test_decompose_su4_random():
    rng = np.random.default_rng(2)
    for _ in range(15):
        u = random_su4(rng)
        gates, phase = decompose_su4(u, 0, 1)   # verification built-in
        assert sum(1 for g in gates if g[0] == "cx") == 3


def test_decompose_special_gates():
    swap = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                     [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
    targets = [CX01, swap, kron(rx(0.3), rz(-1.2)), np.eye(4, dtype=complex)]
    for u in targets:
        gates, _ = decompose_su4(u, 0, 1)
        assert sum(1 for g in gates if g[0] == "cx") <= 3


def test_invariants_local_invariance():
    rng = np.random.default_rng(3)
    u = random_su4(rng)
    from scipy.stats import unitary_group

    l = kron(unitary_group.rvs(2, random_state=rng),
             unitary_group.rvs(2, random_state=rng))
    r = kron(unitary_group.rvs(2, random_state=rng),
             unitary_group.rvs(2, random_state=rng))
    g1a, g2a = makhlin_invariants(u)
    g1b, g2b = makhlin_invariants(l @ u @ r)
    assert g1a == pytest.approx(g1b, abs=1e-10)
    assert g2a == pytest.approx(g2b, abs=1e-10)


def test_closest_unitary():
    rng = np.random.default_rng(4)
    m = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    u = closest_unitary(m)
    np.testing.assert_allclose(u @ u.conj().T, np.eye(4), atol=1e-12)


def test_warmstart_pipeline_heisenberg5(one_thread):
    """Full stage-1 pipeline on the benchmark spin chain: DMRG -> brickwork
    fit -> KAK -> native tape with verified energy round trip."""
    from tensorrl_qas_tpu_torch.tn.pipeline import build_warmstart

    paulis, weights = heisenberg_hamiltonian(5)
    res = build_warmstart(paulis, weights, chi=2, n_layers=2,
                          maxiter=2000, seed=0, device="cpu")
    assert res.e_exact is not None
    # chi=2 warm start should land within ~0.5 Ha of the ground state
    # (comparable to the shipped reference circuit at -8.497 vs -8.712)
    assert res.e_circuit < res.e_exact + 0.3
    assert res.e_circuit >= res.e_exact - 1e-9
    # n=5, 2 brick layers -> 2+2 = 4 bricks, 3 CNOTs per brick (same count
    # as the reference's shipped chi=2 heisenberg circuit: 12 CNOTs)
    assert res.cnot_count == 12
    # round-trip: qasm text parses back to the same energy
    from tensorrl_qas_tpu_torch.circuits.qasm import parse_qasm
    from tensorrl_qas_tpu_torch.circuits.tape import tape_from_gate_list
    from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
    from tensorrl_qas_tpu_torch.sim.expectation import (
        PauliSum,
        pauli_expectation,
    )

    n2, gates = parse_qasm(res.qasm)
    tape2 = tape_from_gate_list(n2, gates)
    ps = PauliSum.from_strings(paulis, weights, 5)
    psi = apply_tape(zero_state(5, torch.complex128), *tape2.arrays(),
                     torch.as_tensor(tape2.x0()))
    e2 = float(pauli_expectation(psi, *ps.tensors("cpu")))
    assert e2 == pytest.approx(res.e_circuit, abs=1e-9)


# -- parity with the JAX package -------------------------------------------

def test_kak_lowering_matches_jax():
    """The port's copy of KAK lowers the same bricks to the same gates
    (names, qubits, angles to 1e-12) in both bases."""
    from tensorrl_qas_tpu.synth import kak as kak_jax

    from tensorrl_qas_tpu_torch.synth import kak

    rng = np.random.default_rng(5)
    for _ in range(4):
        u = random_su4(rng)
        for name in ("decompose_su4", "decompose_su4_pauli"):
            ours, ph_t = getattr(kak, name)(u, 2, 3)
            theirs, ph_j = getattr(kak_jax, name)(u, 2, 3)
            assert [g[:-1] for g in ours] == [g[:-1] for g in theirs]
            np.testing.assert_allclose([g[-1] or 0.0 for g in ours],
                                       [g[-1] or 0.0 for g in theirs],
                                       atol=1e-12)
            assert ph_t == pytest.approx(ph_j, abs=1e-12)


def _h2o_8q():
    path = glob.glob(str(REPO / "data/mol_data/H2O_8q_geom_*.npz"))[0]
    raw = np.load(path, allow_pickle=True)
    return ([str(p) for p in raw["paulis"]],
            np.asarray(np.real(raw["weights"]), dtype=np.float64))


@pytest.mark.parametrize("problem", ["heisenberg5", "h2o8"])
def test_build_warmstart_matches_jax(problem, one_thread):
    """build_warmstart (chi 2, 2 layers, maxiter 3000, seed 0) for the 5q
    Heisenberg chain and for 8q H2O from the shipped npz: e_dmrg to
    1e-10, e_circuit and the overlap to 1e-8, equal CNOT, rotation and
    depth counts, and the same exact ground energy."""
    from tensorrl_qas_tpu.tn.pipeline import build_warmstart as build_jax

    from tensorrl_qas_tpu_torch.tn.pipeline import build_warmstart

    paulis, weights = (heisenberg_hamiltonian(5) if problem == "heisenberg5"
                       else _h2o_8q())
    kw = dict(chi=2, n_layers=2, maxiter=3000, seed=0)
    ours = build_warmstart(paulis, weights, device="cpu", **kw)
    theirs = build_jax(paulis, weights, **kw)
    assert abs(ours.e_dmrg - theirs.e_dmrg) < 1e-10
    assert abs(ours.e_circuit - theirs.e_circuit) < 1e-8
    assert abs(ours.overlap - theirs.overlap) < 1e-8
    assert abs(ours.e_exact - theirs.e_exact) < 1e-10
    assert (ours.cnot_count, ours.rotation_count, ours.depth) == (
        theirs.cnot_count, theirs.rotation_count, theirs.depth)
    assert set(ours.timings) == {"dmrg_s", "exact_s", "fit_s", "synth_s",
                                 "round_trip_s"}


def test_build_warmstart_su4_basis_matches_jax(one_thread):
    """The su4 basis (RXX/RYY/RZZ + rotations) at 5q, 500 iterations: the
    same gate counts and e_circuit to 1e-8; no CNOT, three two-qubit
    rotations a brick, and the round trip inside the pipeline held."""
    from tensorrl_qas_tpu.tn.pipeline import build_warmstart as build_jax

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind
    from tensorrl_qas_tpu_torch.tn.pipeline import build_warmstart

    paulis, weights = heisenberg_hamiltonian(5)
    kw = dict(chi=2, n_layers=2, maxiter=500, seed=0, basis="su4")
    ours = build_warmstart(paulis, weights, device="cpu", **kw)
    theirs = build_jax(paulis, weights, **kw)
    assert ours.cnot_count == 0
    two_q = sum(ours.tape.gate_count(k)
                for k in (GateKind.RXX, GateKind.RYY, GateKind.RZZ))
    assert two_q == 3 * 4
    assert (ours.rotation_count, ours.depth) == (theirs.rotation_count,
                                                 theirs.depth)
    assert abs(ours.e_circuit - theirs.e_circuit) < 1e-8
