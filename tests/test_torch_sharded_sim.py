"""The port's amplitude-sharded simulator (``parallel/sharded_sim.py``) on
the CPU, against the JAX package's ``ShardedSimulator`` on the root
conftest's 8 virtual CPU devices (complex128, x64 on) and against the
port's single-device ``sim/``.

The port's shards all live on ``cpu`` (``make_mesh(..., ["cpu"] * N)``);
inputs are drawn from numpy seeds and carried into the shards by
``shard_state``.  Tolerance 1e-10 (complex128 in another summation order)
unless a case says otherwise.  The controlled-rotation gradient is held
to finite differences, not to the JAX package, whose sharded adjoint
applies the bare Pauli there (ROADMAP.md, C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as MeshJax
from jax.sharding import NamedSharding, PartitionSpec as P

import tensorrl_qas_tpu  # noqa: F401  (x64 on)
from tensorrl_qas_tpu.circuits.qasm import load_qasm_tape
from tensorrl_qas_tpu.parallel.mesh import make_mesh as make_mesh_jax
from tensorrl_qas_tpu.parallel.sharded_sim import (
    ShardedSimulator as SimJax,
)
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.parallel.mesh import Mesh, make_mesh
from tensorrl_qas_tpu_torch.parallel.sharded_sim import (
    ShardedSimulator,
    shard_state,
    unshard_state,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    heisenberg_hamiltonian,
    load_problem,
    resolve_data_file,
    warmstart_qasm_name,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.sim.expectation import (
    PauliSum,
    pauli_expectation,
)

TOL = 1e-10
PAULIS5 = (["XZIII", "IIYXI", "ZZZZZ", "XIIIX", "IIIII"],
           [0.3, -1.1, 0.7, 0.4, 0.25])
# terms whose flips cross the device-bit boundary in every combination
# (tests/test_sharded_sim.py), plus Y terms and the identity
PAULIS6 = (["XIIIII", "IIIIIX", "XYIIZX", "ZZZZZZ", "IYIYIY", "XXXXXX",
            "YIIIIY", "IIIIII"],
           [0.5, -0.25, 1.5, 2.0, -0.75, 0.1, 0.3, -0.4])


def cpu_mesh(n_amp, n_dp=1):
    return make_mesh(n_amp, n_dp, ["cpu"] * (n_amp * n_dp))


def jax_amp_mesh(n_dev):
    return MeshJax(np.array(jax.devices()[:n_dev]).reshape(n_dev), ("amp",))


def both_paulis(paulis, weights, n):
    return (PauliSum.from_strings(paulis, weights, n),
            PauliSumJax.from_strings(paulis, weights, n))


def random_tape(n, n_gates, seed, kinds=("RX", "RY", "RZ", "CX"),
                controlled=0.0):
    """Random gates of ``kinds``; a rotation carries a control with
    probability ``controlled``; every fixed kind (X, Y, Z, H) takes a
    target only, RXX / RYY / RZZ a second qubit."""
    rng = np.random.default_rng(seed)
    tape = GateTape(n, n_gates, n_gates)
    for _ in range(n_gates):
        kind = GateKind[kinds[int(rng.integers(len(kinds)))]]
        c, t = (int(q) for q in rng.choice(n, size=2, replace=False))
        if kind == GateKind.CX:
            tape.add_cx(c, t)
        elif kind in (GateKind.RXX, GateKind.RYY, GateKind.RZZ):
            tape.add(kind, t, c, float(rng.uniform(-np.pi, np.pi)))
        elif kind in (GateKind.RX, GateKind.RY, GateKind.RZ):
            tape.add(kind, t, c if rng.random() < controlled else -1,
                     float(rng.uniform(-np.pi, np.pi)))
        else:
            tape.add(kind, t)
    return tape


def jax_arrays(tape):
    return tuple(map(jnp.asarray, tape.arrays()))


def random_states(rows, n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(rows, 1 << n)) + 1j * rng.normal(size=(rows,
                                                                  1 << n))
    return psi / np.linalg.norm(psi, axis=1, keepdims=True)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_apply_and_expectation_match_jax_and_one_device(n_dev):
    """A 6-qubit tape of every fixed and rotation kind from |0>, a third
    of its rotations controlled, on n_dev amp shards: the state against
    the port's ``sim/`` and the JAX ``ShardedSimulator`` (whose forward
    pass is right for controlled rotations), the energy against
    ``pauli_expectation`` and the JAX sharded energy."""
    n = 6
    ps, ps_j = both_paulis(*PAULIS6, n)
    tape = random_tape(n, 40, seed=42 + n_dev,
                       kinds=("RX", "RY", "RZ", "CX", "X", "Y", "Z", "H"),
                       controlled=0.3)
    assert (tape.arrays()[2][np.isin(tape.arrays()[0], [
        int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)])] >= 0).any()
    x = tape.x0()
    sim = ShardedSimulator(cpu_mesh(n_dev), n, ps)
    psi = sim.apply_tape(sim.zero_state(), *tape.arrays(), x)
    out = unshard_state(psi, sim.mesh).numpy()
    ref = apply_tape(zero_state(n), *tape.arrays(), x)
    np.testing.assert_allclose(out, ref.numpy(), atol=TOL)

    sim_j = SimJax(jax_amp_mesh(n_dev), n, ps_j, dtype=jnp.complex128)
    psi_j = sim_j.apply_tape(sim_j.zero_state(), *jax_arrays(tape),
                             jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(psi_j), atol=TOL)
    e = float(sim.expectation(psi))
    assert e == pytest.approx(float(pauli_expectation(
        ref, *ps.tensors("cpu"))), abs=TOL)
    assert e == pytest.approx(float(sim_j.expectation(psi_j)), abs=TOL)


def test_heisenberg_8q_warm_start_energy():
    """The shipped 8-qubit Heisenberg warm start on 8 amp shards: its
    energy against the JAX sharded engine and the single-device
    simulator, above the ground energy and below |0...0>'s."""
    n = 8
    path = resolve_data_file(warmstart_qasm_name("heisenberg", n, 2))
    prob = load_problem("heisenberg", n, keep_dense=False)
    from tensorrl_qas_tpu.problems.hamiltonians import (
        load_problem as load_problem_jax,
    )
    from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape

    tape = load_circuit_tape(path)
    sim = ShardedSimulator(cpu_mesh(8), n, prob.pauli)
    e = float(sim.expectation(sim.apply_tape(sim.zero_state(),
                                             *tape.arrays(), tape.x0())))
    psi1 = apply_tape(zero_state(n), *tape.arrays(), tape.x0())
    e1 = float(pauli_expectation(psi1, *prob.pauli.tensors("cpu")))
    tape_j = load_qasm_tape(path)
    sim_j = SimJax(jax_amp_mesh(8), n, load_problem_jax("heisenberg",
                                                        n).pauli,
                   dtype=jnp.complex128)
    e_j = float(sim_j.expectation(sim_j.apply_tape(
        sim_j.zero_state(), *jax_arrays(tape_j), jnp.asarray(
            tape_j.x0()))))
    assert e == pytest.approx(e1, abs=TOL)
    assert e == pytest.approx(e_j, abs=TOL)
    e_zero = float(sim.expectation(sim.zero_state()))
    assert prob.min_eig - 1e-9 <= e < e_zero


def test_batched_amp_dp_matches_jax():
    """(2 amp x 4 dp): 8 rows from per-row psi0 through the tape at
    per-row angles, states and energies against the JAX mesh's batched
    path and the single-device simulator."""
    n, rows = 5, 8
    ps, ps_j = both_paulis(*PAULIS5, n)
    tape = random_tape(n, 25, seed=5)
    rng = np.random.default_rng(0)
    angles = rng.uniform(-np.pi, np.pi, size=(rows, tape.rot_capacity))
    psi0 = random_states(rows, n, seed=1)
    sim = ShardedSimulator(cpu_mesh(2, 4), n, ps)
    out = sim.apply_tape_batched(shard_state(psi0, sim.mesh),
                                 *tape.arrays(), angles)
    e = sim.expectation_batched(out).numpy()
    mesh_j = make_mesh_jax(n_amp=2, n_dp=4)
    sim_j = SimJax(mesh_j, n, ps_j, dtype=jnp.complex128)
    psi0_j = jax.device_put(psi0, NamedSharding(mesh_j, P("dp", "amp")))
    out_j = sim_j.apply_tape_batched(psi0_j, *jax_arrays(tape),
                                     jnp.asarray(angles))
    e_j = np.asarray(sim_j.expectation_batched(out_j))
    states = unshard_state(out, sim.mesh).numpy()
    np.testing.assert_allclose(states, np.asarray(out_j), atol=TOL)
    np.testing.assert_allclose(e, e_j, atol=TOL)
    for i in range(rows):
        ref = apply_tape(torch.as_tensor(psi0[i]), *tape.arrays(),
                         angles[i])
        np.testing.assert_allclose(states[i], ref.numpy(), atol=TOL)


def _autograd_vag(psi0, tape, angles, ps, enable_2q=False):
    """Energy and angle gradient of each row through the single-device
    simulator and torch autograd."""
    es, gs = [], []
    for i in range(len(angles)):
        x = torch.as_tensor(angles[i]).requires_grad_(True)
        psi = apply_tape(torch.as_tensor(psi0[i]), *tape.arrays(), x)
        e = pauli_expectation(psi, *ps.tensors("cpu"))
        e.backward()
        es.append(float(e.detach()))
        gs.append(x.grad.numpy())
    return np.asarray(es), np.stack(gs)


@pytest.fixture(scope="module")
def vag_case():
    """5q Heisenberg, a CX + rotation tape, 8 rows with a psi0 and an
    angle vector each."""
    n, rows = 5, 8
    ps, ps_j = both_paulis(*heisenberg_hamiltonian(n), n)
    tape = random_tape(n, 14, seed=6)
    rng = np.random.default_rng(3)
    angles = rng.normal(size=(rows, tape.rot_capacity))
    psi0 = random_states(rows, n, seed=2)
    return n, ps, ps_j, tape, angles, psi0


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_value_and_grad_matches_jax_and_autograd(vag_case, mesh_shape):
    """The adjoint sweep on (amp, dp) meshes against torch autograd of the
    single-device energy and the JAX sharded sweep (a tape without
    controlled rotations, where the JAX sweep is right)."""
    n, ps, ps_j, tape, angles, psi0 = vag_case
    sim = ShardedSimulator(cpu_mesh(*mesh_shape), n, ps)
    ev, gr = sim.value_and_grad_batched(shard_state(psi0, sim.mesh),
                                        *tape.arrays(), angles)
    e_ref, g_ref = _autograd_vag(psi0, tape, angles, ps)
    np.testing.assert_allclose(ev.numpy(), e_ref, atol=TOL)
    np.testing.assert_allclose(gr.numpy(), g_ref, atol=TOL)
    mesh_j = make_mesh_jax(*mesh_shape)
    sim_j = SimJax(mesh_j, n, ps_j, dtype=jnp.complex128)
    ev_j, gr_j = sim_j.value_and_grad_batched(
        jax.device_put(psi0, NamedSharding(mesh_j, P("dp", "amp"))),
        *jax_arrays(tape), jnp.asarray(angles))
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), atol=TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(gr_j), atol=TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_controlled_value_and_grad_matches_autograd(mesh_shape):
    """Half of the rotations controlled, targets and controls on local and
    device bits: the adjoint sweep's energy and gradient against torch
    autograd of the single-device energy (1e-10).  Not against the JAX
    sharded sweep, whose generator there is the bare Pauli."""
    n, rows = 5, 8
    ps = PauliSum.from_strings(*heisenberg_hamiltonian(n), n)
    tape = random_tape(n, 24, seed=8, kinds=("RX", "RY", "RZ", "CX", "H"),
                       controlled=0.5)
    angles = np.random.default_rng(12).normal(size=(rows, tape.rot_capacity))
    psi0 = random_states(rows, n, seed=13)
    sim = ShardedSimulator(cpu_mesh(*mesh_shape), n, ps)
    ev, gr = sim.value_and_grad_batched(shard_state(psi0, sim.mesh),
                                        *tape.arrays(), angles)
    e_ref, g_ref = _autograd_vag(psi0, tape, angles, ps)
    np.testing.assert_allclose(ev.numpy(), e_ref, atol=TOL)
    np.testing.assert_allclose(gr.numpy(), g_ref, atol=TOL)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_su4_apply_and_vag(n_dev):
    """RXX / RYY / RZZ (enable_2q) on every local / device-bit placement:
    the state against the JAX sharded engine and the single-device
    simulator; the gradient on (n_dev amp x 1 dp) against torch autograd
    and the JAX sharded sweep."""
    n = 5
    ps, ps_j = both_paulis(*heisenberg_hamiltonian(n), n)
    tape = random_tape(n, 24, seed=11 + n_dev,
                       kinds=("RX", "RY", "RZ", "RXX", "RYY", "RZZ"))
    x = tape.x0()
    sim = ShardedSimulator(cpu_mesh(n_dev), n, ps, enable_2q=True)
    out = unshard_state(sim.apply_tape(sim.zero_state(), *tape.arrays(), x),
                        sim.mesh).numpy()
    np.testing.assert_allclose(
        out, apply_tape(zero_state(n), *tape.arrays(), x).numpy(), atol=TOL)
    mesh_j = make_mesh_jax(n_dev, 1)
    sim_j = SimJax(mesh_j, n, ps_j, dtype=jnp.complex128, enable_2q=True)
    out_j = sim_j.apply_tape(sim_j.zero_state(), *jax_arrays(tape),
                             jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(out_j), atol=TOL)

    rows = 2
    angles = np.random.default_rng(4).normal(size=(rows, len(x)))
    psi0 = random_states(rows, n, seed=9)
    ev, gr = sim.value_and_grad_batched(shard_state(psi0, sim.mesh),
                                        *tape.arrays(), angles)
    e_ref, g_ref = _autograd_vag(psi0, tape, angles, ps)
    np.testing.assert_allclose(ev.numpy(), e_ref, atol=TOL)
    np.testing.assert_allclose(gr.numpy(), g_ref, atol=TOL)
    _, gr_j = sim_j.value_and_grad_batched(
        jax.device_put(psi0, NamedSharding(mesh_j, P("dp", "amp"))),
        *jax_arrays(tape), jnp.asarray(angles))
    np.testing.assert_allclose(gr.numpy(), np.asarray(gr_j), atol=TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (8, 1), (4, 2)])
def test_flip_groups_equal_jax(mesh_shape):
    """``sim.groups``: the JAX package's (g, weights, local flips, sign
    masks, phases), sorted by the device flip mask g, entry by entry."""
    n = 6
    ps, ps_j = both_paulis(*PAULIS6, n)
    sim = ShardedSimulator(cpu_mesh(*mesh_shape), n, ps)
    sim_j = SimJax(make_mesh_jax(*mesh_shape), n, ps_j,
                   dtype=jnp.complex128)
    assert [g[0] for g in sim.groups] == [g[0] for g in sim_j.groups]
    for ours, theirs in zip(sim.groups, sim_j.groups):
        for a, b in zip(ours[1:], theirs[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_controlled_rotation_gradient_matches_finite_differences():
    """Controlled RX / RY / RZ with target and control on local and
    device bits (8 amp shards of 5 qubits: bits 2-4 are device bits; RX
    4 <- 3 has both there, its partner reached by an exchange): the
    adjoint gradient against central differences of the single-device
    energy (1e-7), the generator restricted to the control-set subspace.
    The JAX sharded sweep applies the bare Pauli there and misses."""
    n = 5
    ps, ps_j = both_paulis(*heisenberg_hamiltonian(n), n)
    tape = GateTape(n, 11, 11)
    for q in range(n):
        tape.add(GateKind.RY, q, -1, 0.3 + 0.2 * q)
    for kind, t, c in ((GateKind.RX, 4, 0), (GateKind.RY, 1, 3),
                       (GateKind.RZ, 3, 4), (GateKind.RY, 0, 2),
                       (GateKind.RX, 2, 1), (GateKind.RX, 4, 3)):
        tape.add(kind, t, c, 0.7)
    sim = ShardedSimulator(cpu_mesh(8), n, ps)
    angles = tape.x0()[None]
    psi0 = np.zeros((1, 1 << n), complex)
    psi0[0, 0] = 1.0
    _, gr = sim.value_and_grad_batched(shard_state(psi0, sim.mesh),
                                       *tape.arrays(), angles)

    def energy(x):
        psi = apply_tape(zero_state(n), *tape.arrays(), x)
        return float(pauli_expectation(psi, *ps.tensors("cpu")))

    h = 1e-5
    fd = np.zeros(angles.shape[1])
    for k in range(tape.n_rots):
        step = np.zeros_like(fd)
        step[k] = h
        fd[k] = (energy(angles[0] + step) - energy(angles[0] - step)) / (2 * h)
    np.testing.assert_allclose(gr.numpy()[0], fd, atol=1e-7)
    mesh_j = make_mesh_jax(8, 1)
    sim_j = SimJax(mesh_j, n, ps_j, dtype=jnp.complex128)
    _, gr_j = sim_j.value_and_grad_batched(
        jax.device_put(psi0, NamedSharding(mesh_j, P("dp", "amp"))),
        *jax_arrays(tape), jnp.asarray(angles))
    assert np.abs(np.asarray(gr_j)[0] - fd).max() > 1e-3


def test_make_mesh_needs_the_devices_it_names():
    """Without a device list the mesh takes the host's CUDA devices and
    refuses to reuse one (this host has none); a list may repeat one."""
    if torch.cuda.is_available():
        have = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"need {have + 1} devices, "
                                             f"have {have}"):
            make_mesh(have + 1, 1)
    else:
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            make_mesh(1, 1)
        with pytest.raises(ValueError, match="need 8 devices, have 0"):
            make_mesh(2, 4)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh(2, 4, ["cpu"] * 4)
    mesh = make_mesh(2, 4, ["cpu"] * 8)
    assert mesh.shape == {"amp": 2, "dp": 4} and mesh.size == 8
    assert mesh.axis_names == ("amp", "dp")


def test_collectives():
    """ppermute hands each destination its source's block (zeros where
    no pair names it); psum adds in mesh order and hands the total to
    every shard; neither writes into its inputs."""
    mesh = Mesh([["cpu"] * 2] * 4)
    grid = [[torch.full((3,), 10.0 * a + d) for d in range(2)]
            for a in range(4)]
    out = mesh.ppermute(grid, "amp", [(0, 1), (1, 0), (2, 3)])
    assert [float(out[a][1][0]) for a in range(4)] == [11.0, 1.0, 0.0, 21.0]
    out = mesh.ppermute(grid, "dp", [(0, 1)])
    assert [float(out[2][d][0]) for d in range(2)] == [0.0, 20.0]
    total = mesh.psum(grid, "amp")
    assert all(float(total[a][d][0]) == 60.0 + 4 * d
               for a in range(4) for d in range(2))
    total = mesh.psum(grid, "dp")
    assert float(total[3][0][0]) == float(total[3][1][0]) == 61.0
    assert float(grid[1][1][0]) == 11.0
    with pytest.raises(ValueError, match="axis"):
        mesh.psum(grid, "seed")


def test_shard_state_round_trip():
    psi = random_states(8, 6, seed=3)
    mesh = cpu_mesh(4, 2)
    grid = shard_state(psi, mesh)
    assert len(grid) == 4 and len(grid[0]) == 2
    assert tuple(grid[1][1].shape) == (4, 16)
    np.testing.assert_array_equal(grid[1][1].numpy(), psi[4:, 16:32])
    np.testing.assert_array_equal(unshard_state(grid, mesh).numpy(), psi)
    one = shard_state(psi[0], mesh)
    assert len(one[0]) == 1
    np.testing.assert_array_equal(unshard_state(one, mesh).numpy(), psi[0])
    with pytest.raises(ValueError, match="rows"):
        shard_state(psi[:3], mesh)
