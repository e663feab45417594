"""The port's copy of the qchem stage 0 (``problems/qchem.py``): twins of
the JAX package's tests/test_qchem.py on the port's module (the two slow
ones stay slow), and parity with the JAX package's ``molecular_hamiltonian``
for H2 and 8-qubit H2O: identical term sets, coefficients to 1e-12 (the
same numpy/scipy code on the same inputs).

As in the JAX package's tests, the from-scratch integrals -> RHF -> CAS ->
Jordan-Wigner pipeline must reproduce the upstream pennylane-generated
Pauli coefficients (vendored in data/mol_data) to numerical-convergence
accuracy, term set identical.
"""

import numpy as np
import pytest

from tensorrl_qas_tpu_torch.problems.hamiltonians import resolve_data_file
from tensorrl_qas_tpu_torch.problems.qchem import (
    ANGSTROM_TO_BOHR,
    _jw_ladder,
    _pauli_mul,
    boys,
    build_basis,
    integral_tensors,
    jordan_wigner_hamiltonian,
    molecular_hamiltonian,
    nuclear_repulsion,
    overlap,
    parse_geometry,
    rhf,
)


def test_pauli_mul_table():
    # masks: X=(1,0) Z=(0,1) Y=(1,1) on qubit 0
    x, z, c = _pauli_mul(1, 0, 1.0, 1, 1, 1.0)   # X.Y = iZ
    assert (x, z, c) == (0, 1, 1j)
    x, z, c = _pauli_mul(1, 1, 1.0, 1, 0, 1.0)   # Y.X = -iZ
    assert (x, z, c) == (0, 1, -1j)
    x, z, c = _pauli_mul(0, 1, 1.0, 1, 1, 1.0)   # Z.Y = -iX
    assert (x, z, c) == (1, 0, -1j)
    x, z, c = _pauli_mul(1, 0, 1.0, 1, 0, 1.0)   # X.X = I
    assert (x, z, c) == (0, 0, 1.0)


def test_jw_number_operator():
    # a+_0 a_0 = (I - Z_0)/2
    acc = {}
    from tensorrl_qas_tpu_torch.problems.qchem import _accumulate_product
    _accumulate_product(acc, [_jw_ladder(0, True), _jw_ladder(0, False)], 1.0)
    assert acc[(0, 0)] == pytest.approx(0.5)
    assert acc[(0, 1)] == pytest.approx(-0.5)


def test_boys_function():
    assert boys(0, 0.0) == pytest.approx(1.0)
    assert boys(2, 0.0) == pytest.approx(1 / 5)
    # F_0(T) = sqrt(pi/(4T)) erf(sqrt(T))
    from scipy.special import erf
    for T in (0.1, 1.0, 7.5):
        assert boys(0, T) == pytest.approx(
            np.sqrt(np.pi / (4 * T)) * erf(np.sqrt(T)), rel=1e-12)


def test_contracted_functions_normalized():
    basis = build_basis(["O"], np.zeros((1, 3)), "sto-3g")
    for bf in basis:
        assert overlap(bf, bf) == pytest.approx(1.0, abs=1e-12)


def test_h2_sto3g_hf_energy():
    # H2 at 0.74 A: E_HF(STO-3G) = -1.11675 Ha (textbook value)
    symbols = ["H", "H"]
    coords = np.array([[0., 0., 0.], [0., 0., 0.74]]) * ANGSTROM_TO_BOHR
    basis = build_basis(symbols, coords, "sto-3g")
    S, Hcore, g = integral_tensors(basis, symbols, coords)
    E, _, _ = rhf(S, Hcore, g, 2)
    assert E + nuclear_repulsion(symbols, coords) == pytest.approx(
        -1.11675, abs=2e-4)


def test_h2_full_space_ground_state():
    # full-CI ground of H2/STO-3G at 0.74 A = -1.13728 Ha; the 4-qubit
    # JW Hamiltonian's minimum eigenvalue must hit it
    symbols = ["H", "H"]
    coords = np.array([[0., 0., 0.], [0., 0., 0.74]])
    mh = molecular_hamiltonian(symbols, coords, units="angstrom")
    from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
    dense = PauliSum.from_strings(mh.paulis, mh.weights, 4).to_dense()
    e0 = np.linalg.eigvalsh(dense)[0]
    assert e0 == pytest.approx(-1.13728, abs=2e-4)


def _compare_with_vendored(mh, relpath, tol):
    raw = np.load(resolve_data_file(relpath), allow_pickle=True)
    ref = dict(zip([str(p) for p in raw["paulis"]],
                   np.real(np.asarray(raw["weights"]))))
    own = dict(zip(mh.paulis, mh.weights))
    assert set(ref) == set(own), (
        f"term sets differ: missing={len(set(ref) - set(own))} "
        f"extra={len(set(own) - set(ref))}")
    err = max(abs(ref[p] - own[p]) for p in ref)
    assert err < tol, f"max coefficient err {err}"


@pytest.mark.slow
def test_beh2_6q_matches_upstream():
    symbols, coords = parse_geometry(
        "H 0.000 0.000 -1.330; Be 0.000 0.000 0.000; H 0.000 0.000 1.330")
    mh = molecular_hamiltonian(symbols, coords, active_electrons=4,
                               active_orbitals=3)
    _compare_with_vendored(
        mh,
        "mol_data/BEH2_6q_geom_H_0.000_0.000_-1.330;_Be_0.000_0.000_0.000;"
        "_H_0.000_0.000_1.330_jordan_wigner.npz", 1e-6)


def test_h2o_8q_matches_upstream():
    symbols, coords = parse_geometry(
        "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000")
    mh = molecular_hamiltonian(symbols, coords, active_electrons=4,
                               active_orbitals=4)
    _compare_with_vendored(
        mh,
        "mol_data/H2O_8q_geom_H_-0.021_-0.002_0.000;_O_0.835_0.452_0.000;"
        "_H_1.477_-0.273_0.000_jordan_wigner.npz", 1e-6)


@pytest.mark.slow
def test_ch2_8q_matches_upstream_exact_angle():
    """The upstream CH2 file was computed from the exact 102-degree bond
    angle; the 3-decimal geometry in the filename is rounded
    (making_molecules.py:44-66). Using the exact angle must match."""
    ang = np.deg2rad(102)
    coords = np.array([[0., 0., 0.], [1.08, 0., 0.],
                       [1.08 * np.cos(ang), 1.08 * np.sin(ang), 0.]])
    mh = molecular_hamiltonian(["C", "H", "H"], coords, active_electrons=6,
                               active_orbitals=4)
    _compare_with_vendored(
        mh,
        "mol_data/CH2_8q_geom_C_0.000_0.000_0.000;_H_1.080_0.000_0.000;"
        "_H_-0.225_1.056_0.000_jordan_wigner.npz", 1e-6)


# -- parity with the JAX package -------------------------------------------

H2O_8Q = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"


@pytest.mark.parametrize("molecule", ["H2", "H2O_8q"])
def test_molecular_hamiltonian_matches_jax(molecule):
    """The same molecule through both packages: identical Pauli term sets,
    every coefficient to 1e-12, and the same HF energy."""
    from tensorrl_qas_tpu.problems import qchem as qchem_jax

    if molecule == "H2":
        args = (["H", "H"], np.array([[0., 0., 0.], [0., 0., 0.74]]))
        kw = dict(units="angstrom")
    else:
        args = parse_geometry(H2O_8Q)
        kw = dict(active_electrons=4, active_orbitals=4)
    ours = molecular_hamiltonian(*args, **kw)
    theirs = qchem_jax.molecular_hamiltonian(*args, **kw)
    assert ours.n_qubits == theirs.n_qubits
    assert list(ours.paulis) == list(theirs.paulis)
    np.testing.assert_allclose(ours.weights, theirs.weights, atol=1e-12,
                               rtol=0)
    assert ours.e_hf == pytest.approx(theirs.e_hf, abs=1e-12)
