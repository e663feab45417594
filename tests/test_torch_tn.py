"""The port's tensor-network layer (``tensorrl_qas_tpu_torch/tn``): twins
of the JAX package's tests/test_tn.py and tests/test_autodiff_gs.py on the
port's modules, and parity with the JAX package on the same numpy-seeded
inputs.

Tolerances: ``gs_dmrg``'s energy and statevector 1e-12 (the same numpy
algorithm; the port's MPO compression takes BLAS products where the JAX
package's copy loops in ``np.einsum``, which moves the last bits; the
near-degenerate TFIM's statevector 1e-7, see its test);
``fit_mps_to_circuit`` at 6 qubits over 500 Stiefel-Adam iterations, loss
history and overlap 1e-10 (both in complex128 on the CPU, the same
starting unitaries; LAPACK solves in another order); ``gs_autodiff`` at 5
qubits, chi 2, over 200 Adam steps, energy history 1e-9.  The twins keep
the JAX tests' own tolerances.
"""

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    heisenberg_hamiltonian,
    tfim_hamiltonian,
)
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.tn.autodiff_gs import gs_autodiff
from tensorrl_qas_tpu_torch.tn.circuit_fit import fit_mps_to_circuit
from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg, gs_exact_diag
from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis
from tensorrl_qas_tpu_torch.tn.mps import MPS


@pytest.fixture
def one_thread():
    """Torch on one thread: these loops are many small operations, which a
    busy worker's thread pool only slows (tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- twins of tests/test_tn.py ---------------------------------------------

def test_mps_statevector_roundtrip():
    rng = np.random.default_rng(0)
    psi = rng.normal(size=32) + 1j * rng.normal(size=32)
    psi /= np.linalg.norm(psi)
    mps = MPS.from_statevector(psi)
    np.testing.assert_allclose(mps.to_statevector(), psi, atol=1e-12)
    # overlap identity
    assert mps.overlap(mps) == pytest.approx(1.0, abs=1e-12)


def test_mps_truncation_fidelity():
    # product state has chi=1 exactly
    psi = np.zeros(16, dtype=complex)
    psi[0b0101] = 1.0
    mps = MPS.from_statevector(psi, chi=1)
    np.testing.assert_allclose(mps.to_statevector(), psi, atol=1e-12)


def test_mpo_dense_matches_pauli_sum():
    """MPO.to_dense must equal the PauliSum dense oracle (the reference's
    MPO-vs-dense check, dmrg_to_qc.py:175-176)."""
    paulis, weights = heisenberg_hamiltonian(4)
    mpo = mpo_from_paulis(paulis, weights)
    ps = PauliSum.from_strings(paulis, weights, 4)
    np.testing.assert_allclose(mpo.to_dense(), ps.to_dense(), atol=1e-10)


def test_mpo_compression_shrinks_bond():
    paulis, weights = heisenberg_hamiltonian(6)
    raw = mpo_from_paulis(paulis, weights, compress=False)
    comp = mpo_from_paulis(paulis, weights, compress=True)
    assert max(comp.bond_dims) < max(raw.bond_dims)
    np.testing.assert_allclose(comp.to_dense(), raw.to_dense(), atol=1e-8)


def test_trie_mpo_is_the_selector_operator():
    """The compressed MPO starts from a suffix trie instead of the
    reference's selector form: on 8q H2O (193 terms) both give the dense
    operator of the Pauli sum (1e-10) and the compressed bond dims are
    the selector form's after its own compression."""
    import glob
    import pathlib

    from tensorrl_qas_tpu_torch.tn.mpo import _trie_mpo

    repo = pathlib.Path(__file__).resolve().parents[1]
    raw = np.load(glob.glob(str(repo / "data/mol_data/H2O_8q_geom_*.npz"))[0],
                  allow_pickle=True)
    paulis = [str(p) for p in raw["paulis"]]
    weights = np.real(raw["weights"])
    dense = PauliSum.from_strings(paulis, weights, 8).to_dense()
    trie = _trie_mpo(paulis, weights)
    selector = mpo_from_paulis(paulis, weights, compress=False)
    comp = mpo_from_paulis(paulis, weights)
    for mpo in (trie, selector, comp):
        np.testing.assert_allclose(mpo.to_dense(), dense, atol=1e-10)
    assert max(trie.bond_dims) < max(selector.bond_dims) == len(paulis)
    assert comp.bond_dims == selector.compress().bond_dims


@pytest.mark.parametrize("ham,n,chi,tol", [
    ("heisenberg", 5, 8, 1e-6),
    ("tfim", 6, 8, 1e-6),
])
def test_dmrg_reaches_ground_state(ham, n, chi, tol):
    if ham == "heisenberg":
        paulis, weights = heisenberg_hamiltonian(n)
    else:
        paulis, weights = tfim_hamiltonian(n)
    mpo = mpo_from_paulis(paulis, weights)
    ps = PauliSum.from_strings(paulis, weights, n)
    e_exact, v_exact = gs_exact_diag(ps.to_dense())
    e_dmrg, mps = gs_dmrg(mpo, chi=chi, max_sweeps=6, seed=1)
    assert e_dmrg == pytest.approx(e_exact, abs=tol)
    # the MPS statevector energy agrees
    psi = mps.to_statevector()
    e_sv = np.real(psi.conj() @ ps.to_dense() @ psi)
    assert e_sv == pytest.approx(e_exact, abs=10 * tol)
    # fidelity with the exact ground state
    fid = abs(np.vdot(v_exact, psi)) ** 2
    assert fid > 0.999


def test_dmrg_chi2_chemical_accuracy_check():
    """chi=2 on the 5q Heisenberg chain: bounded error (the warm-start
    regime — DMRG energy above but near the ground state)."""
    paulis, weights = heisenberg_hamiltonian(5)
    mpo = mpo_from_paulis(paulis, weights)
    ps = PauliSum.from_strings(paulis, weights, 5)
    e_exact, _ = gs_exact_diag(ps.to_dense())
    e_dmrg, _ = gs_dmrg(mpo, chi=2, max_sweeps=6, seed=0)
    assert e_dmrg >= e_exact - 1e-9        # variational
    assert e_dmrg - e_exact < 0.5          # chi=2 quality envelope


# -- twins of tests/test_autodiff_gs.py ------------------------------------

def test_gs_autodiff_exact_at_full_bond(one_thread):
    # n=4 TFIM: chi=4 saturates the Schmidt rank, so the variational
    # minimum IS the exact ground state.
    paulis, weights = tfim_hamiltonian(4)
    mpo = mpo_from_paulis(paulis, weights)
    e0, _ = gs_exact_diag(mpo.to_dense())
    e, mps, hist = gs_autodiff(mpo, chi=4, opt_steps=1500, lr=5e-2, seed=0,
                               device="cpu")
    assert e == pytest.approx(e0, abs=2e-4)
    # the returned state is normalized and achieves (about) the energy
    psi = mps.to_statevector()
    assert np.linalg.norm(psi) == pytest.approx(1.0, abs=1e-9)
    h = mpo.to_dense()
    e_psi = float(np.real(psi.conj() @ h @ psi))
    assert e_psi == pytest.approx(e0, abs=5e-4)
    # monotone-ish: the loss history ends far below where it starts
    assert hist[-1] < hist[0] - 0.5 * abs(hist[0] - e0)


def test_gs_autodiff_matches_dmrg_bound_at_small_chi(one_thread):
    # chi=2 on a 5q Heisenberg chain: the autodiff optimum must come
    # within a hair of the chi=2 DMRG energy (both optimize the same
    # variational class; DMRG is the sharper solver).
    paulis, weights = heisenberg_hamiltonian(5)
    mpo = mpo_from_paulis(paulis, weights)
    e0 = gs_exact_diag(mpo.to_dense())[0]
    e_dmrg = gs_dmrg(mpo, chi=2, max_sweeps=4)[0]
    e_ad, _, _ = gs_autodiff(mpo, chi=2, opt_steps=2500, lr=5e-2, seed=1,
                             device="cpu")
    assert e_ad >= e0 - 1e-6              # variational: cannot beat exact
    assert e_ad == pytest.approx(e_dmrg, abs=5e-2)


# -- the exact check's Lanczos branch ---------------------------------------

def test_exact_diag_lanczos_branch_matches_dense_eigh():
    """From 10 qubits gs_exact_diag solves by Lanczos on the sparse matrix
    (tol 0): the 10-qubit Heisenberg chain's ground energy equals the dense
    eigh's to 1e-12, and the vector is an eigenvector (residual 1e-10)."""
    from tensorrl_qas_tpu_torch.tn.dmrg import LANCZOS_MIN_DIM

    paulis, weights = heisenberg_hamiltonian(10)
    dense = PauliSum.from_strings(paulis, weights, 10).to_dense()
    assert dense.shape[0] >= LANCZOS_MIN_DIM
    e, v = gs_exact_diag(dense)
    assert e == pytest.approx(np.linalg.eigvalsh(dense)[0], abs=1e-12)
    assert np.linalg.norm(dense @ v - e * v) < 1e-10


# -- parity with the JAX package -------------------------------------------

@pytest.mark.parametrize("ham,n,chi,sv_tol", [("heisenberg", 6, 2, 1e-12),
                                              ("heisenberg", 8, 4, 1e-12),
                                              ("tfim", 6, 3, 1e-7)])
def test_gs_dmrg_matches_jax(ham, n, chi, sv_tol):
    """gs_dmrg: the energy equals the JAX package's to 1e-12, the
    statevector (up to a global phase) to 1e-12 on the Heisenberg chains.
    The TFIM at h = 0.05 has its two lowest states 3.1e-8 apart at 6
    sites, so the ground vector amplifies rounding by ~1e8: there the
    statevector is held to 1e-7 (it differs by ~2e-9; the energy, second
    order in that, still to 1e-12)."""
    from tensorrl_qas_tpu.tn.dmrg import gs_dmrg as gs_dmrg_jax
    from tensorrl_qas_tpu.tn.mpo import mpo_from_paulis as mpo_jax

    paulis, weights = (heisenberg_hamiltonian(n) if ham == "heisenberg"
                       else tfim_hamiltonian(n))
    e_t, mps_t = gs_dmrg(mpo_from_paulis(paulis, weights), chi=chi,
                         max_sweeps=6, seed=3)
    e_j, mps_j = gs_dmrg_jax(mpo_jax(paulis, weights), chi=chi,
                             max_sweeps=6, seed=3)
    assert abs(e_t - e_j) < 1e-12
    psi_t, psi_j = mps_t.to_statevector(), mps_j.to_statevector()
    phase = np.vdot(psi_t, psi_j)
    phase /= abs(phase)
    np.testing.assert_allclose(psi_t * phase, psi_j, atol=sv_tol, rtol=0)


def test_circuit_state_matches_jax():
    """circuit_state (the brick chain, each pair moved to the front and
    the axes put back at the end) and apply_2q on a non-adjacent pair
    equal the JAX package's on random unitaries to 1e-13."""
    from scipy.stats import unitary_group

    from tensorrl_qas_tpu.tn import circuit_fit as cf_jax
    from tensorrl_qas_tpu_torch.tn import circuit_fit as cf

    rng = np.random.default_rng(4)
    n = 6
    pairs = cf.brickwork_pairs(n, 3)
    u = unitary_group.rvs(4, size=len(pairs), random_state=rng)
    ours = cf.circuit_state(torch.as_tensor(u), pairs, n).numpy()
    theirs = np.asarray(cf_jax.circuit_state(u, pairs, n))
    np.testing.assert_allclose(ours, theirs, atol=1e-13, rtol=0)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    ours = cf.apply_2q(torch.as_tensor(psi), torch.as_tensor(u[0]), 1, 4, n)
    theirs = np.asarray(cf_jax.apply_2q(psi, u[0], 1, 4, n))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-13, rtol=0)


def test_fit_mps_to_circuit_matches_jax(one_thread):
    """fit_mps_to_circuit at 6 qubits (the chi-2 DMRG state of the
    Heisenberg chain, 2 brick layers) over 500 iterations: the loss
    history and the overlap equal the JAX package's to 1e-10, and the
    best iterates to 1e-8."""
    from tensorrl_qas_tpu.tn.circuit_fit import (
        fit_mps_to_circuit as fit_jax,
    )

    paulis, weights = heisenberg_hamiltonian(6)
    _, mps = gs_dmrg(mpo_from_paulis(paulis, weights), chi=2, seed=0)
    p_t, pairs_t, ov_t, hist_t = fit_mps_to_circuit(
        mps, n_layers=2, maxiter=500, seed=0, device="cpu")
    p_j, pairs_j, ov_j, hist_j = fit_jax(mps, n_layers=2, maxiter=500,
                                         seed=0)
    assert pairs_t == pairs_j
    assert p_t.dtype == torch.complex128
    assert hist_t.shape == (500,) and hist_t.dtype == np.float64
    np.testing.assert_allclose(hist_t, hist_j, atol=1e-10, rtol=0)
    assert abs(ov_t - ov_j) < 1e-10
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-8, rtol=0)


def test_gs_autodiff_matches_jax(one_thread):
    """gs_autodiff at 5 qubits, chi 2, 200 Adam steps: the energy history
    equals the JAX package's to 1e-9, and so do the best energy and the
    normalized final state (up to a global phase)."""
    from tensorrl_qas_tpu.tn.autodiff_gs import gs_autodiff as gs_jax
    from tensorrl_qas_tpu.tn.mpo import mpo_from_paulis as mpo_jax

    paulis, weights = heisenberg_hamiltonian(5)
    e_t, mps_t, hist_t = gs_autodiff(mpo_from_paulis(paulis, weights),
                                     chi=2, opt_steps=200, seed=2,
                                     device="cpu")
    e_j, mps_j, hist_j = gs_jax(mpo_jax(paulis, weights), chi=2,
                                opt_steps=200, seed=2)
    np.testing.assert_allclose(hist_t, hist_j, atol=1e-9, rtol=0)
    assert abs(e_t - e_j) < 1e-9
    psi_t, psi_j = mps_t.to_statevector(), mps_j.to_statevector()
    assert abs(abs(np.vdot(psi_t, psi_j)) - 1.0) < 1e-9
