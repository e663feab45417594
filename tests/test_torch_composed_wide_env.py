"""The su4 env at 18 qubits on the CPU against the JAX su4 env: the
composed engine above 16 qubits behind ``CircuitEnv``, where the JAX
package runs it through XLA (``tensorrl_qas_tpu/optim/angle_opt.py:
808-845``).

heisenberg_18q_TNbond2 (TensorRL-fixed: the shipped npz, its CNOT warm
start compiled into psi0, as the su4 gate set's fixed placement falls
back to it) with ``--gate_set su4``, 2 Adam iterations and 2 starts,
complex128 on both sides: the reset and two steps (an RY, which enters at
angle 0, then an RYY, before which the step optimizes the RY's angle)
give the same observations, energies, rewards and optimized angles within
1e-7.  The warm start is stationary for both gates (Heisenberg's
symmetries keep every single rotation's and every real two-qubit
rotation's gradient at zero there), so both packages' start rule is
replaced by the same fixed one (``_starts``: start s the warm angles plus
(s + 1) ``START_SHIFT`` on every live angle): the starts leave the warm
start, Adam moves their angles, and the RY's optimized angle and the
energies leave the warm start's and the starts' values, which the test
asserts.
A file of its own: its JAX side compiles for ~14 s.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import tensorrl_qas_tpu.optim.angle_opt as angle_opt_jax
import tensorrl_qas_tpu_torch.optim.angle_opt as angle_opt
from tensorrl_qas_tpu.envs import CircuitEnv as EnvJax
from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu.train.config import get_config as get_config_jax
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.train.config import get_config
from tests.test_torch_composed_wide import one_thread  # noqa: F401

TOL_ENV = 1e-7
START_SHIFT = 0.13


def _env_kw():
    """heisenberg_18q_TNbond2 (TensorRL-fixed) with the su4 gate set, 2
    Adam iterations and 2 starts."""
    return dict(gate_set="su4", global_iters=2, n_starts=2,
                restart_scale=0.0)


def _starts(x0, active, shifts):
    """(..., R) warm angles -> (..., S, R) starts: start s the warm angles
    plus ``shifts[s]`` on every live angle (either package's arrays, the
    arithmetic the same in jnp and torch)."""
    return (x0[..., None, :] + active[..., None, :] * shifts[:, None]
            ) * active[..., None, :]


def _shifts(n_starts):
    """Start s's shift, (s + 1) START_SHIFT."""
    return [START_SHIFT * (s + 1) for s in range(n_starts)]


def test_su4_env_step_at_18_qubits_matches_jax(one_thread, monkeypatch):
    monkeypatch.setattr(
        angle_opt_jax, "make_multistarts",
        lambda x0, active, kn, n_starts, *a, **k: _starts(
            x0, active, jnp.asarray(_shifts(n_starts), x0.dtype)))
    monkeypatch.setattr(
        angle_opt, "make_multistarts",
        lambda x0, active, n_starts, *a, **k: _starts(
            x0, active, torch.tensor(_shifts(n_starts), dtype=x0.dtype,
                                     device=x0.device)))
    conf_t = get_config("TensorRL_fixed/", "heisenberg_18q_TNbond2.cfg")
    conf_j = get_config_jax("TensorRL_fixed/", "heisenberg_18q_TNbond2.cfg")
    cfg_t = dataclasses.replace(
        EnvConfig.from_conf(conf_t, tn_placement="fixed", noise_mode="none"),
        device="cpu", **_env_kw())
    cfg_j = dataclasses.replace(
        EnvConfigJax.from_conf(conf_j, tn_placement="fixed",
                               noise_mode="none"),
        sim_dtype="complex128", **_env_kw())
    env_t, env_j = CircuitEnv(cfg_t), EnvJax(cfg_j)
    assert env_t.optimizer._pick_engine() == "composed"
    np.testing.assert_array_equal(env_t.reset(), env_j.reset())
    assert abs(env_t.prev_energy - env_j.prev_energy) < TOL_ENV
    # an RY on qubit 3 (the 1-qubit actions follow the 3 n (n - 1)
    # two-qubit ones, 3 a qubit), which enters at angle 0, then an RYY on
    # qubits 7 and 10 (action (7 (n - 1) + 2) 3 + 1), before which the step
    # optimizes the RY's angle
    n = 18
    warm = env_t.prev_energy
    for a in (3 * n * (n - 1) + 3 * 3 + 1, (7 * (n - 1) + 2) * 3 + 1):
        obs_j, r_j, d_j = env_j.step(env_j.action_dict[a])
        obs_t, r_t, d_t = env_t.step(env_t.action_dict[a])
        np.testing.assert_array_equal(obs_t, obs_j)
        assert abs(r_t - r_j) < TOL_ENV and d_t == d_j
        assert abs(env_t.energy - env_j.energy) < TOL_ENV
    # the second step's Adam moved the RY's angle off every start and the
    # energy off the warm start's
    ang_t, ang_j = (np.asarray(e.opt_ang_save) for e in (env_t, env_j))
    assert ang_t.shape == ang_j.shape == (1,)
    assert min(abs(ang_t[0] - START_SHIFT * k) for k in (0, 1, 2)) > 1e-3
    np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=TOL_ENV)
    assert abs(env_t.energy - warm) > 1e-4
