"""Env layer of the PyTorch port against the JAX package: one fixed action
sequence on configs/TensorRL_fixed/heisenberg_5q_TNbond2.cfg gives the
same observations, rewards and done flags.  One optimizer start makes the
angle optimization deterministic in both (start 0 is the exact warm
start), and the CPU runs both in complex128.

Energies and rewards agree to 1e-7, not 1e-10: at a symmetric saddle
(a fresh rotation at angle 0 on a real state) the exact gradient is 0 and
the computed one is rounding noise of ~1e-17, which Adam's eps = 1e-8
turns into ~1e-10 angle steps that differ between the two packages; the
saddle then amplifies them over the iterations (observed: 6.6e-9 Ha)."""

TOL = 1e-7

import numpy as np

from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu.envs.vector_env import VectorCircuitEnv as VecJax
from tensorrl_qas_tpu.train.config import get_config
from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv

# (env 0 action id, env 1 action id) per step: rotations and CNOTs on
# both, a repeated rotation, a CNOT pair
ACTIONS = [(30, 5), (3, 31), (33, 12), (12, 34), (31, 31), (0, 2)]


def _conf():
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    conf["env"]["n_starts"] = 1
    conf["non_local_opt"]["global_iters"] = 15
    return conf


def test_fixed_action_sequence_matches_jax():
    conf = _conf()
    cfg_j = EnvConfigJax.from_conf(conf, tn_placement="fixed",
                                   noise_mode="none", seed=3)
    cfg_j.sim_dtype = "complex128"
    venv_j = VecJax(cfg_j, n_envs=2)
    venv_t = VectorCircuitEnv(EnvConfig.from_conf(
        conf, tn_placement="fixed", noise_mode="none", seed=3,
        device="cpu"), n_envs=2)
    np.testing.assert_array_equal(venv_t.reset_all(), venv_j.reset_all())
    for ej, et in zip(venv_j.envs, venv_t.envs):
        assert abs(ej.prev_energy - et.prev_energy) < TOL
    translate = venv_t.envs[0].action_dict
    for step in ACTIONS:
        acts = [translate[a] for a in step]
        assert venv_t.illegal_actions() == venv_j.illegal_actions()
        obs_j, rew_j, done_j, info_j = venv_j.step_all(acts)
        obs_t, rew_t, done_t, info_t = venv_t.step_all(acts)
        np.testing.assert_array_equal(obs_t, obs_j)
        np.testing.assert_allclose(rew_t, rew_j, atol=TOL)
        np.testing.assert_array_equal(done_t, done_j)
        for ij, it in zip(info_j, info_t):
            assert abs(ij["energy"] - it["energy"]) < TOL
            assert ij["steps"] == it["steps"]
    for ej, et in zip(venv_j.envs, venv_t.envs):
        np.testing.assert_allclose(et.state.data, ej.state.data, atol=TOL)
