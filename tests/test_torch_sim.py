"""Eager simulator of the PyTorch port against the JAX package at 5 qubits
in complex128: statevectors, energies and adjoint gradients agree to
1e-10 (both are exact float64 arithmetic in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu.problems.hamiltonians import load_problem
from tensorrl_qas_tpu.sim.adjoint import adjoint_energy as adjoint_jax
from tensorrl_qas_tpu.sim.apply import apply_tape as apply_jax
from tensorrl_qas_tpu.sim.expectation import pauli_expectation as pexp_jax
from tensorrl_qas_tpu_torch.sim.adjoint import adjoint_energy as adjoint_torch
from tensorrl_qas_tpu_torch.sim.apply import apply_tape as apply_torch
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.sim.expectation import (
    pauli_expectation as pexp_torch,
)

N = 5
TOL = 1e-10


def _random_tape(rng, n_gates=24, two_qubit=False, controlled_rot=False):
    kinds = [GateKind.RX, GateKind.RY, GateKind.RZ, GateKind.CX, GateKind.X,
             GateKind.Y, GateKind.Z, GateKind.H]
    if two_qubit:
        kinds += [GateKind.RXX, GateKind.RYY, GateKind.RZZ]
    tape = GateTape(N, n_gates + 4, n_gates + 4)
    for _ in range(n_gates):
        k = kinds[rng.integers(len(kinds))]
        t = int(rng.integers(N))
        c = int((t + 1 + rng.integers(N - 1)) % N)
        if k in (GateKind.CX, GateKind.RXX, GateKind.RYY, GateKind.RZZ):
            tape.add(k, target=t, control=c, angle=float(rng.normal()))
        elif controlled_rot and k in (GateKind.RX, GateKind.RY, GateKind.RZ):
            tape.add(k, target=t, control=c, angle=float(rng.normal()))
        else:
            tape.add(k, target=t, angle=float(rng.normal()))
    return tape


@pytest.fixture(scope="module")
def problem():
    return load_problem("heisenberg", N)


def _psi0(rng):
    psi = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    return psi / np.linalg.norm(psi)


def _pauli_pair(problem):
    """The problem's Pauli arrays for both packages (JAX: numpy arrays,
    port: tensors)."""
    p = problem.pauli
    pj = p.device_arrays(jnp.complex128)
    pt = PauliSum(p.n_qubits, p.weights, p.flip, p.sign_mask,
                  p.iphase).tensors("cpu", torch.complex128)
    return pj, pt


@pytest.mark.parametrize("two_qubit", [False, True])
def test_statevector_and_energy(problem, two_qubit):
    rng = np.random.default_rng(3 + two_qubit)
    tape = _random_tape(rng, two_qubit=two_qubit)
    psi0 = _psi0(rng)
    pj, pt = _pauli_pair(problem)
    sj = np.asarray(apply_jax(jnp.asarray(psi0), *map(jnp.asarray,
                                                       tape.arrays()),
                              jnp.asarray(tape.x0()), enable_2q=two_qubit))
    st = apply_torch(torch.as_tensor(psi0), *tape.arrays(), tape.x0())
    np.testing.assert_allclose(st.numpy(), sj, atol=TOL)
    ej = float(pexp_jax(jnp.asarray(sj), *pj))
    et = float(pexp_torch(st, *pt))
    assert abs(ej - et) < TOL


@pytest.mark.parametrize("two_qubit", [False, True])
def test_adjoint_gradients(problem, two_qubit):
    rng = np.random.default_rng(11 + two_qubit)
    tape = _random_tape(rng, two_qubit=two_qubit)
    psi0 = _psi0(rng)
    pj, pt = _pauli_pair(problem)
    arrs_j = tuple(map(jnp.asarray, tape.arrays()))
    ej, (gpsi_j, gx_j) = jax.value_and_grad(
        lambda p, x: adjoint_jax(two_qubit, p, *arrs_j, x, *pj),
        argnums=(0, 1))(jnp.asarray(psi0), jnp.asarray(tape.x0()))
    p0 = torch.as_tensor(psi0).requires_grad_(True)
    x = torch.as_tensor(tape.x0()).requires_grad_(True)
    et = adjoint_torch(p0, *tape.arrays(), x, *pt)
    et.backward()
    assert abs(float(ej) - et.item()) < TOL
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_j), atol=TOL)
    # JAX returns 2 conj(dE/dpsi*), torch 2 dE/dpsi*
    np.testing.assert_allclose(p0.grad.numpy(), np.conj(np.asarray(gpsi_j)),
                               atol=TOL)


def test_controlled_rotation_gradient_matches_finite_differences(problem):
    """The generator of a controlled rotation acts on the control-set
    subspace only.  (The JAX package's XLA adjoint applies the full Pauli
    there, sim/adjoint.py:_generator_apply, and so differs from its own
    finite differences on controlled rotations, which the CNOT+rotation
    action set never places.)"""
    rng = np.random.default_rng(5)
    tape = _random_tape(rng, n_gates=16, controlled_rot=True)
    psi0 = torch.as_tensor(_psi0(rng))
    _, pt = _pauli_pair(problem)
    x = torch.as_tensor(tape.x0()).requires_grad_(True)
    adjoint_torch(psi0, *tape.arrays(), x, *pt).backward()

    def energy(xv):
        psi = apply_torch(psi0, *tape.arrays(), torch.as_tensor(xv))
        return float(pexp_torch(psi, *pt))

    h = 1e-6
    x0 = tape.x0()
    fd = [(energy(x0 + h * np.eye(len(x0))[i])
           - energy(x0 - h * np.eye(len(x0))[i])) / (2 * h)
          for i in range(tape.n_rots)]
    np.testing.assert_allclose(x.grad.numpy()[: tape.n_rots], fd, atol=1e-7)
