"""COBYLA and ``optimize`` in the port (``optim/angle_opt.py``) against the
JAX package:

- twins of ``tests/test_cobyla_parity.py``: the analytic minimum of
  <RY(t)|Z|RY(t)>, and an env step under COBYLA that cannot end above
  the warm start;
- parity: the same psi0, tape and x0 (complex128 / float64) through the
  JAX ``AngleOptimizer(method='cobyla')`` (its csim) and the port's (its
  own copy of csim, the same source and flags): x and nfev equal bit for
  bit, the energy within 1e-10 (5q Heisenberg, maxiter 60);
- ``optimize(method='adam')`` against the JAX ``_optimize_multistart``
  with its starts injected, within 1e-10 in complex128;
- the noisy COBYLA cost's kernel path (``kernel_energy_fn``; on the CPU
  its launch is the plain version) against the eager simulator on the
  same woven draw within 1e-10 in complex128, for depolarizing and shot
  noise; a noisy COBYLA run on the CPU; more than 16 qubits raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu.optim.angle_opt import AngleOptimizer as OptJax
from tensorrl_qas_tpu.optim.angle_opt import make_multistarts as starts_jax
from tensorrl_qas_tpu.problems.hamiltonians import load_problem
from tensorrl_qas_tpu_torch import native
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.ops import build
from tensorrl_qas_tpu_torch.optim import angle_opt
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    extend_tape_arrays,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    load_problem as load_problem_torch,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.sim.expectation import (
    PauliSum,
    pauli_expectation,
)
from tensorrl_qas_tpu_torch.train.config import get_config

TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def build_dir(tmp_path_factory):
    """The host engine built once for this module, in a temporary build/."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "BUILD_DIR", tmp_path_factory.mktemp("build"))
        native._library.cache_clear()
        yield
    native._library.cache_clear()


def mid_episode_tape(rng, n, cap, n_gates):
    """A tape as an env grows it: CNOTs and rotations at random angles."""
    tape = GateTape(n, cap, cap)
    for _ in range(n_gates):
        t = int(rng.integers(n))
        if rng.random() < 0.4:
            tape.add(GateKind.CX, target=t,
                     control=int((t + 1 + rng.integers(n - 1)) % n))
        else:
            tape.add(GateKind(int(rng.integers(1, 4))), target=t,
                     angle=float(rng.normal()))
    return tape


def random_state(rng, n):
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return psi / np.linalg.norm(psi)


def test_cobyla_finds_analytic_minimum():
    # <0|RY(t)^dag Z RY(t)|0> = cos(t): minimum -1 at t = pi
    ps = PauliSum.from_strings(["Z"], [1.0], 1)
    tape = GateTape(1, 1, 1)
    tape.add(GateKind.RY, target=0, angle=0.3)
    opt = AngleOptimizer(ps, method="cobyla", iters=200, device="cpu")
    x, e, nfev = opt.optimize(zero_state(1, torch.complex128, "cpu"),
                              tape.arrays(), tape.x0(), 1)
    assert e == pytest.approx(-1.0, abs=1e-6)
    assert np.cos(x[0]) == pytest.approx(-1.0, abs=1e-5)
    assert nfev > 0


def test_cobyla_env_step_descends():
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", optim_alg="cobyla",
                              seed=0, device="cpu")
    cfg.global_iters = 60
    env = CircuitEnv(cfg)
    assert env.optimizer.method == "cobyla"
    env.reset()
    e_warm = env.prev_energy
    # rotation actions (ctrl = n disables the CNOT): RY on 2, RX on 1
    n = cfg.num_qubits
    env.step((n, 0, 2, 2))
    e1 = env.energy
    env.step((n, 0, 1, 1))
    e2 = env.energy
    assert np.isfinite([e1, e2]).all()
    assert env.nfev > 0
    # COBYLA re-optimizes the pre-action circuit each step: by step 2 the
    # energy cannot sit above the warm start
    assert e2 <= e_warm + 1e-6


def test_configs_map_cobyla_onto_adam_unless_asked():
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    assert conf["non_local_opt"]["optim_alg"] == "COBYLA"
    assert EnvConfig.from_conf(conf, device="cpu").optim_alg == "adam"
    assert EnvConfig.from_conf(conf, optim_alg="cobyla",
                               device="cpu").optim_alg == "cobyla"
    with pytest.raises(ValueError, match="optim_alg"):
        CircuitEnv(EnvConfig.from_conf(conf, optim_alg="lbfgs",
                                       device="cpu"))


def test_cobyla_bit_for_bit_with_jax_csim():
    n, cap = 5, 24
    rng = np.random.default_rng(7)
    tape = mid_episode_tape(rng, n, cap, 18)
    psi0 = random_state(rng, n)
    x0 = tape.x0().astype(np.float64)
    problem = load_problem("heisenberg", n)
    opt_j = OptJax(problem.pauli.device_arrays(jnp.complex128),
                   method="cobyla", iters=60, dtype=jnp.complex128)
    opt_j._pauli_obj = problem.pauli
    x_j, e_j, nfev_j = opt_j.optimize(
        jnp.asarray(psi0), tuple(map(jnp.asarray, tape.arrays())), x0,
        tape.n_rots, jax.random.PRNGKey(0))
    assert opt_j._csim is not None          # the JAX side ran its csim
    opt_t = AngleOptimizer(load_problem_torch("heisenberg", n).pauli,
                           method="cobyla", iters=60, device="cpu")
    x_t, e_t, nfev_t = opt_t.optimize(torch.as_tensor(psi0), tape.arrays(),
                                      x0, tape.n_rots)
    assert nfev_t == nfev_j > 0
    np.testing.assert_array_equal(x_t, np.asarray(x_j))
    assert abs(e_t - e_j) < TOL
    # no live angle: x0 back at once, no evaluation
    x_z, e_z, nfev_z = opt_t.optimize(torch.as_tensor(psi0), tape.arrays(),
                                      x0, 0)
    assert nfev_z == 0
    np.testing.assert_array_equal(x_z, x0)
    assert abs(e_z - opt_t.energy(torch.as_tensor(psi0), tape.arrays(),
                                  x0)) < TOL


def test_adam_optimize_matches_jax_multistart(monkeypatch):
    n, cap, iters, s_n = 5, 16, 12, 4
    rng = np.random.default_rng(11)
    tape = mid_episode_tape(rng, n, cap, 12)
    psi0 = random_state(rng, n)
    x0 = tape.x0().astype(np.float64)
    active = (np.arange(cap) < tape.n_rots).astype(np.float64)
    problem = load_problem("heisenberg", n)
    opt_j = OptJax(problem.pauli.device_arrays(jnp.complex128), iters=iters,
                   n_starts=s_n, lr=0.1, dtype=jnp.complex128)
    key = jax.random.PRNGKey(3)
    x_j, e_j = opt_j._opt_jit(jnp.asarray(psi0),
                              *map(jnp.asarray, tape.arrays()),
                              jnp.asarray(x0), jnp.asarray(active), key)
    # _optimize_multistart splits key -> (kn, ko) and draws from kn
    starts = np.array(starts_jax(
        jnp.asarray(x0), jnp.asarray(active), jax.random.split(key)[0],
        s_n, opt_j.fresh_starts, opt_j.restart_scale))
    monkeypatch.setattr(angle_opt, "make_multistarts",
                        lambda *a, **k: torch.as_tensor(starts)[None])
    opt_t = AngleOptimizer(load_problem_torch("heisenberg", n).pauli,
                           iters=iters, n_starts=s_n, lr=0.1, device="cpu")
    x_t, e_t, nfev = opt_t.optimize(torch.as_tensor(psi0), tape.arrays(),
                                    x0, tape.n_rots)
    assert nfev == iters * s_n
    np.testing.assert_allclose(x_t, np.asarray(x_j), atol=TOL)
    assert abs(e_t - float(e_j)) < TOL


def _eager_energy(pauli_t, psi0, tape, x, kt, kc):
    """The complex128 eager energy of the tape woven with (k_t, k_c), the
    mean over its realizations."""
    t_n = kt.shape[0]
    woven = extend_tape_arrays(tuple(a.expand(t_n, 1, -1) for a in tape),
                               kt, kc)
    es = [pauli_expectation(apply_tape(psi0, *(a[t, 0] for a in woven), x),
                            *pauli_t) for t in range(t_n)]
    return float(torch.stack(es).mean())


@pytest.mark.parametrize("n_traj", [1, 3])
def test_kernel_cost_matches_eager_on_the_same_draw(n_traj):
    n, cap = 5, 20
    rng = np.random.default_rng(13)
    tape_np = mid_episode_tape(rng, n, cap, 16)
    psi0 = torch.as_tensor(random_state(rng, n))
    pauli = load_problem_torch("heisenberg", n).pauli
    opt = AngleOptimizer(pauli, method="cobyla", device="cpu",
                         noise_mode="depolarizing", noise_p1=0.3,
                         noise_p2=0.5, n_traj=n_traj)
    energy = opt.kernel_energy_fn(psi0, tape_np.arrays(), cap)
    tape = tuple(torch.as_tensor(a, dtype=torch.int32).reshape(1, -1)
                 for a in tape_np.arrays())
    x = tape_np.x0()
    gen = torch.Generator().manual_seed(5)
    fired = 0
    for _ in range(4):
        kt, kc = opt._draw_noise(gen, tape[0], 1, 1)
        fired += int((kt != 0).sum() + (kc != 0).sum())
        want = _eager_energy(opt.pauli_t, psi0, tape, x, kt, kc)
        assert abs(energy(x, (kt, kc)) - want) < TOL
        assert abs(opt.plain_energy(psi0, tape_np.arrays(), x, (kt, kc))
                   - want) < TOL
    assert fired > 0
    # drawn from the optimizer's generator when no realization is given
    assert np.isfinite(energy(x))


def test_kernel_cost_with_shot_noise_adds_the_offset():
    n, cap = 5, 12
    rng = np.random.default_rng(17)
    tape = mid_episode_tape(rng, n, cap, 10)
    psi0 = torch.as_tensor(random_state(rng, n))
    pauli = load_problem_torch("heisenberg", n).pauli
    opt = AngleOptimizer(pauli, method="cobyla", device="cpu",
                         noise_mode="shot", n_shots=256)
    energy = opt.kernel_energy_fn(psi0, tape.arrays(), cap)
    x = tape.x0()
    clean = float(pauli_expectation(apply_tape(psi0, *tape.arrays(), x),
                                    *opt.pauli_t))
    offset = torch.full((1, 1), 0.125, dtype=torch.float64)
    assert abs(energy(x, offset) - (clean + 0.125)) < TOL
    assert abs(opt.plain_energy(psi0, tape.arrays(), x, offset)
               - (clean + 0.125)) < TOL


def test_noisy_cobyla_runs_on_the_cpu():
    n, cap = 5, 12
    rng = np.random.default_rng(19)
    tape = mid_episode_tape(rng, n, cap, 10)
    psi0 = torch.as_tensor(random_state(rng, n))
    pauli = load_problem_torch("heisenberg", n).pauli
    opt = AngleOptimizer(pauli, method="cobyla", iters=30, device="cpu",
                         noise_mode="depolarizing")
    x, e, nfev = opt.optimize(psi0, tape.arrays(), tape.x0(), tape.n_rots)
    assert 0 < nfev <= 30 and np.isfinite(e)
    np.testing.assert_array_equal(x[tape.n_rots:], 0.0)


def test_kernel_cost_refuses_more_than_16_qubits():
    """Past the tape kernels' ceiling -- 20 qubits since their sweep
    design took 17-20 -- the noisy cost raises, naming the sharded path."""
    n = 21
    pauli = PauliSum.from_strings(["Z" + "I" * (n - 1)], [1.0], n)
    opt = AngleOptimizer(pauli, method="cobyla", device="cpu",
                         noise_mode="depolarizing")
    tape = GateTape(n, 2, 2)
    tape.add(GateKind.RY, target=0, angle=0.1)
    with pytest.raises(ValueError, match="at most 20.*mesh_shape"):
        opt.kernel_energy_fn(torch.zeros(1), tape.arrays(), 2)
