"""The port's sharded training path (``optim/sharded_opt.py`` and
``EnvConfig.mesh_shape``) on the CPU, against the JAX package's
``ShardedAngleOptimizer`` on the root conftest's 8 virtual devices
(complex128, x64 on) and against the port's single-device optimizer.

Starts are deterministic in both packages with ``restart_scale = 0``: the
warm start, copies of it, and exact zeros (``make_multistarts``).

x_opt is held to 1e-8, except on the angles whose exact gradient is 0
from the start (a rotation whose generator leaves the state's energy
unchanged): there the computed gradient is rounding noise of ~1e-16,
which Adam's eps = 1e-8 turns into steps of lr 1e-16 / eps a iteration
that differ between two summation orders (observed: 3.3e-8 after 30
iterations), so those are held to iters * lr * 1e-15 / eps = 3e-7 (the
rule of tests/test_torch_env.py).  e_new is held to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrl_qas_tpu  # noqa: F401  (x64 on)
from tensorrl_qas_tpu.optim.angle_opt import (
    extend_tape_arrays as extend_jax,
)
from tensorrl_qas_tpu.optim.sharded_opt import (
    ShardedAngleOptimizer as OptJax,
)
from tensorrl_qas_tpu.parallel.mesh import make_mesh as make_mesh_jax
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.optim.sharded_opt import ShardedAngleOptimizer
from tensorrl_qas_tpu_torch.parallel.mesh import make_mesh
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    heisenberg_hamiltonian,
)
from tensorrl_qas_tpu_torch.sim.adjoint import adjoint_energy
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.sim.noise import depolarizing_energy_exact

ITERS, LR = 30, 0.1
TOL_X, TOL_E = 1e-8, 1e-10
TOL_FLAT = ITERS * LR * 1e-15 / 1e-8


def cpu_mesh(n_amp, n_dp):
    return make_mesh(n_amp, n_dp, ["cpu"] * (n_amp * n_dp))


def random_tape(n, n_gates, seed):
    """tests/test_pallas_apply.py:random_tape (RX / RY / RZ / CX)."""
    rng = np.random.default_rng(seed)
    tape = GateTape(n, n_gates, n_gates)
    for _ in range(n_gates):
        kind = rng.choice([GateKind.RX, GateKind.RY, GateKind.RZ,
                           GateKind.CX])
        if kind == GateKind.CX:
            c, t = rng.choice(n, size=2, replace=False)
            tape.add_cx(int(c), int(t))
        else:
            tape.add(kind, target=int(rng.integers(n)),
                     angle=float(rng.uniform(-np.pi, np.pi)))
    return tape


def zero_psi(n):
    psi = np.zeros(1 << n, complex)
    psi[0] = 1.0
    return psi


def flat_entries(psi0, tape, ps):
    """Angles whose gradient at the warm start is 0 to rounding."""
    x = torch.as_tensor(tape.x0()).requires_grad_(True)
    adjoint_energy(torch.as_tensor(psi0), *tape.arrays(), x,
                   *ps.tensors("cpu")).backward()
    return x.grad.abs().numpy() < 1e-12


def assert_x_close(x, x_ref, flat):
    np.testing.assert_allclose(x[~flat], x_ref[~flat], atol=TOL_X)
    np.testing.assert_allclose(x[flat], x_ref[flat], atol=TOL_FLAT)


@pytest.fixture(scope="module")
def step_case():
    n = 5
    paulis, weights = heisenberg_hamiltonian(n)
    ps = PauliSum.from_strings(paulis, weights, n)
    ps_j = PauliSumJax.from_strings(paulis, weights, n)
    tape = random_tape(n, 14, seed=2)
    return n, ps, ps_j, tape, np.arange(tape.rot_capacity, dtype=np.int32)


@pytest.fixture(scope="module")
def sharded_result(step_case):
    n, ps, _, tape, map_idx = step_case
    opt = ShardedAngleOptimizer(cpu_mesh(2, 4), n, ps, iters=ITERS,
                                n_starts=4, restart_scale=0.0)
    out = opt.fused_step(torch.as_tensor(zero_psi(n)), tape.arrays(),
                         tape.x0(), tape.n_rots, tape.arrays(), map_idx)
    return opt, out


def test_fused_step_matches_jax(step_case, sharded_result):
    """(2 amp x 4 dp), 5q Heisenberg, 30 iterations, 4 starts: x_opt,
    e_new and nfev against the JAX sharded step; ``energy`` too."""
    n, ps, ps_j, tape, map_idx = step_case
    opt, (x, e, nfev) = sharded_result
    opt_j = OptJax(make_mesh_jax(2, 4), n, ps_j, iters=ITERS, n_starts=4,
                   restart_scale=0.0, dtype=jnp.complex128)
    psi0 = zero_psi(n)
    arrs_j = tuple(map(jnp.asarray, tape.arrays()))
    x_j, e_j, nfev_j = opt_j.fused_step(
        (psi0.real, psi0.imag), arrs_j, tape.x0(), tape.n_rots, arrs_j,
        map_idx, jax.random.PRNGKey(3))
    assert_x_close(x, np.asarray(x_j), flat_entries(psi0, tape, ps))
    assert e == pytest.approx(e_j, abs=TOL_E)
    assert nfev == nfev_j == ITERS * 4
    e_x = opt.energy(torch.as_tensor(psi0), tape.arrays(), x)
    assert e_x == pytest.approx(opt_j.energy(
        (psi0.real, psi0.imag), arrs_j, x), abs=TOL_E)


def test_fused_step_matches_single_device(step_case, sharded_result):
    """The same step on the port's single-device optimizer (the fused
    step's plain version in float64) from the same starts."""
    n, ps, _, tape, map_idx = step_case
    _, (x, e, nfev) = sharded_result
    one = AngleOptimizer(ps, iters=ITERS, n_starts=4, restart_scale=0.0,
                         device="cpu")
    psi0 = torch.as_tensor(zero_psi(n))
    x1, e1, nfev1 = one.fused_step(psi0, tape.arrays(), tape.x0(),
                                   tape.n_rots, tape.arrays(), map_idx)
    assert_x_close(x, x1, flat_entries(zero_psi(n), tape, ps))
    assert e == pytest.approx(e1, abs=TOL_E)
    assert nfev == nfev1


def test_n_starts_round_up_to_dp():
    ps = PauliSum.from_strings(*heisenberg_hamiltonian(4), 4)
    opt = ShardedAngleOptimizer(cpu_mesh(2, 4), 4, ps, n_starts=6)
    assert opt.n_starts == 8 and opt.fresh_starts == 2
    with pytest.raises(NotImplementedError, match="shot noise"):
        ShardedAngleOptimizer(cpu_mesh(1, 1), 4, ps, noise_mode="shot")


def _env_cfg(**kw):
    base = dict(
        num_qubits=10, num_layers=40, ham_type="heisenberg",
        tn_placement="fixed", tn_init=1, tn_bond=2, accept_err=1e-3,
        curriculum_conf={"thresholds": [1e-3], "switch_episodes": [100000],
                         "accept_err": 1e-3},
        optim_alg="adam", global_iters=3, n_starts=4, restart_scale=0.0,
        device="cpu", mesh_devices=("cpu",) * 8, seed=0)
    base.update(kw)
    return EnvConfig(**base)


def _legal_action(env, rng):
    ill = set(env.illegal_action_new())
    legal = [k for k in env.action_dict if k not in ill]
    return env.action_dict[int(rng.choice(legal))]


def _run_env(env, steps, seed=1):
    env.reset()
    energies = [env.prev_energy]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        obs, reward, _ = env.step(_legal_action(env, rng))
        energies.append(env.energy)
        assert env.nfev == env.optimizer.iters * env.optimizer.n_starts
    return np.asarray(energies), obs


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4)])
def test_env_on_mesh_matches_single_device(mesh_shape):
    """A 10q Heisenberg env (fixed warm start) takes three steps on the
    mesh: the same energies and observations as the single-device env on
    the same actions."""
    env = CircuitEnv(_env_cfg(mesh_shape=mesh_shape))
    assert isinstance(env.optimizer, ShardedAngleOptimizer)
    assert env.mesh.shape == {"amp": mesh_shape[0], "dp": mesh_shape[1]}
    e_mesh, obs_mesh = _run_env(env, 3)
    one = CircuitEnv(_env_cfg())
    assert one.mesh is None
    e_one, obs_one = _run_env(one, 3)
    np.testing.assert_allclose(e_mesh, e_one, atol=1e-8)
    np.testing.assert_array_equal(obs_mesh, obs_one)
    assert np.isfinite(e_mesh).all()


def test_vector_env_on_mesh():
    """VectorCircuitEnv on (2 amp x 2 dp): two replicas through
    ``fused_step_batch``, the same energies as on one device."""
    cfg = _env_cfg(mesh_shape=(2, 2), n_starts=2)
    venv = VectorCircuitEnv(cfg, n_envs=2)
    assert venv.envs[0].mesh is not None
    assert all(e.optimizer is venv.optimizer for e in venv.envs)
    one = VectorCircuitEnv(dataclasses.replace(cfg, mesh_shape=None), 2)
    np.testing.assert_array_equal(venv.reset_all(), one.reset_all())
    rng = np.random.default_rng(0)
    for _ in range(2):
        acts = [_legal_action(e, rng) for e in venv.envs]
        obs, rew, done, info = venv.step_all(acts)
        obs1, rew1, done1, info1 = one.step_all(acts)
        np.testing.assert_array_equal(obs, obs1)
        np.testing.assert_allclose(rew, rew1, atol=1e-8)
        np.testing.assert_allclose([i["energy"] for i in info],
                                   [i["energy"] for i in info1], atol=1e-8)


def test_block_coordinate_on_mesh():
    """block_coord_k = 3 (in_state): CircuitEnv runs it on the mesh with
    the frozen-prefix psi0 (the single-device env's energies);
    VectorCircuitEnv refuses it there, since the sharded optimizer takes
    one psi0 for all replicas (the JAX package's broadcasts the replicas'
    prefix states over the starts)."""
    kw = dict(num_qubits=5, num_layers=40, tn_placement="in_state",
              block_coord_k=3, global_iters=2, n_starts=2)
    e_mesh, _ = _run_env(CircuitEnv(_env_cfg(mesh_shape=(2, 2), **kw)), 4)
    e_one, _ = _run_env(CircuitEnv(_env_cfg(**kw)), 4)
    np.testing.assert_allclose(e_mesh, e_one, atol=1e-8)
    with pytest.raises(ValueError, match="CircuitEnv only"):
        VectorCircuitEnv(_env_cfg(mesh_shape=(2, 2), **kw), n_envs=2)
    opt = ShardedAngleOptimizer(cpu_mesh(2, 2), 5, PauliSum.from_strings(
        *heisenberg_hamiltonian(5), 5))
    with pytest.raises(ValueError, match="one psi0"):
        opt.energy(torch.zeros((2, 32), dtype=torch.complex128),
                   random_tape(5, 4, 0).arrays(), np.zeros(4))


def test_env_refuses_what_the_mesh_does_not_run():
    with pytest.raises(NotImplementedError, match="shot noise"):
        CircuitEnv(_env_cfg(mesh_shape=(2, 4), noise_mode="shot",
                            n_shots=128))
    with pytest.raises(NotImplementedError, match="n_traj=1"):
        CircuitEnv(_env_cfg(mesh_shape=(2, 4), noise_mode="depolarizing",
                            n_traj=2))
    with pytest.raises(ValueError, match="Adam only"):
        CircuitEnv(_env_cfg(mesh_shape=(2, 4), optim_alg="cobyla"))


# -- depolarizing noise on the mesh -----------------------------------------

def _noisy_opt(mesh, n, ps, **kw):
    return ShardedAngleOptimizer(mesh, n, ps, noise_mode="depolarizing",
                                 **kw)


def test_noisy_energy_matches_jax_on_injected_kinds():
    """One trajectory's energy with injected error kinds against the JAX
    sharded energy of the same extended tape (errors on targets and on
    controls, on local and device bits)."""
    n = 4
    paulis, weights = heisenberg_hamiltonian(n)
    ps = PauliSum.from_strings(paulis, weights, n)
    ps_j = PauliSumJax.from_strings(paulis, weights, n)
    tape = GateTape(n, 10, 10)
    for k, t, c in ((GateKind.RY, 0, -1), (GateKind.CX, 3, 0),
                    (GateKind.RX, 3, -1), (GateKind.CX, 1, 3),
                    (GateKind.RZ, 2, -1), (GateKind.CX, 0, 2),
                    (GateKind.RY, 1, -1), (GateKind.CX, 2, 1),
                    (GateKind.RX, 0, -1), (GateKind.RZ, 3, -1)):
        tape.add(k, t, c, 0.0 if k == GateKind.CX else 0.3 + 0.1 * t)
    # an error after every gate, X / Y / Z in turn, and Y on every CX's
    # control: on local qubits 0-2 and on qubit 3, the device bit of
    # 4q on 2 amp shards
    kt = (int(GateKind.X) + np.arange(10) % 3).astype(np.int32)
    kc = np.where(tape.kind == int(GateKind.CX), int(GateKind.Y),
                  0).astype(np.int32)
    opt = _noisy_opt(cpu_mesh(2, 4), n, ps, noise_p1=0.5, noise_p2=0.5)
    opt._sample_noise_kinds = lambda kind: (torch.as_tensor(kt),
                                            torch.as_tensor(kc))
    x = tape.x0()
    e = opt.energy(torch.as_tensor(zero_psi(n)), tape.arrays(), x)
    opt_j = OptJax(make_mesh_jax(2, 4), n, ps_j, iters=1, n_starts=4,
                   dtype=jnp.complex128)
    ext = extend_jax(tuple(map(jnp.asarray, tape.arrays())),
                     jnp.asarray(kt), jnp.asarray(kc))
    psi0 = zero_psi(n)
    e_j = opt_j.energy((psi0.real, psi0.imag), ext, x)
    assert e == pytest.approx(e_j, abs=TOL_E)


def test_trajectory_mean_matches_kraus():
    """The mean of 400 one-trajectory energies on the mesh against the
    exact density-matrix channel, within 5 sigma (the rule of
    tests/test_sharded_noise.py)."""
    n, p1, p2 = 3, 0.15, 0.25
    tape = GateTape(n, 4, 4)
    tape.add(GateKind.RY, target=0, angle=0.7)
    tape.add_cx(0, 1)
    tape.add(GateKind.RX, target=2, angle=-1.1)
    tape.add_cx(1, 2)
    ps = PauliSum.from_strings(["ZII", "IZI", "IIZ", "XXI", "IYY"],
                               [1.0, 0.5, -0.7, 0.9, 1.3], n)
    exact = depolarizing_energy_exact(zero_psi(n), *tape.arrays(),
                                      tape.x0(), ps.to_dense(), p1, p2)
    opt = _noisy_opt(cpu_mesh(2, 4), n, ps, iters=1, n_starts=4,
                     noise_p1=p1, noise_p2=p2, seed=5)
    psi0 = torch.as_tensor(zero_psi(n))
    vals = np.array([opt.energy(psi0, tape.arrays(), tape.x0())
                     for _ in range(400)])
    sem = vals.std(ddof=1) / np.sqrt(len(vals))
    assert len(set(np.round(vals, 12))) > 1
    assert abs(vals.mean() - exact) < 5 * sem + 1e-6


@pytest.mark.parametrize("resample", ["iter", "step"])
def test_zero_noise_equals_noiseless(step_case, resample):
    """p1 = p2 = 0 weaves only NONE gates in: the noisy step equals the
    noiseless one bit for bit."""
    n, ps, _, tape, map_idx = step_case
    args = (torch.as_tensor(zero_psi(n)), tape.arrays(), tape.x0(),
            tape.n_rots, tape.arrays(), map_idx)
    mesh = cpu_mesh(2, 4)
    x0, e0, _ = ShardedAngleOptimizer(mesh, n, ps, iters=10,
                                      n_starts=4).fused_step(*args)
    xn, en, _ = _noisy_opt(mesh, n, ps, iters=10, n_starts=4, noise_p1=0.0,
                           noise_p2=0.0,
                           noise_resample=resample).fused_step(*args)
    np.testing.assert_array_equal(xn, x0)
    assert en == e0
