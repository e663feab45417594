"""The port's 10-18-qubit band (the v2 engine, flip-group H) end to end on
the CPU, on configs/TensorRL_fixed/H2O10q_TNbond2.cfg cut to 3-step
episodes (num_layers = warm-start depth 27 + 3):

- one fixed action sequence gives the same observations, rewards and done
  flags as the JAX env on its XLA path, both in complex128 with one
  optimizer start (tolerance 1e-7, as in tests/test_torch_env.py, whose
  docstring gives the reason);
- ``train_vectorized`` runs 3 vector steps through the v2 engine and
  writes ``summary_<seed>.npy`` and ``events_<seed>.jsonl`` in the schema
  of the JAX package's driver.
"""

import json

import numpy as np

from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu.envs.vector_env import VectorCircuitEnv as VecJax
from tensorrl_qas_tpu.train.saver import _TRAIN_KEYS
from tensorrl_qas_tpu_torch.agents.dqn import make_agent
from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.train.config import get_config
from tensorrl_qas_tpu_torch.train.vector_driver import train_vectorized

TOL = 1e-7
# (env 0 action id, env 1 action id) per step: ids 0-89 are CNOTs, 90-119
# rotations; the third step ends both 3-step episodes
ACTIONS = [(92, 5), (11, 100), (93, 93)]


def _conf():
    conf = get_config("TensorRL_fixed/", "H2O10q_TNbond2.cfg")
    conf["env"]["num_layers"] = 30
    conf["env"]["n_starts"] = 1
    conf["non_local_opt"]["global_iters"] = 6
    return conf


def test_fixed_action_sequence_matches_jax_at_10_qubits():
    conf = _conf()
    cfg_j = EnvConfigJax.from_conf(conf, tn_placement="fixed",
                                   noise_mode="none", seed=3)
    cfg_j.sim_dtype = "complex128"
    cfg_j.use_pallas = "off"
    venv_j = VecJax(cfg_j, n_envs=2)
    venv_t = VectorCircuitEnv(EnvConfig.from_conf(
        conf, tn_placement="fixed", noise_mode="none", seed=3,
        device="cpu"), n_envs=2)
    assert venv_t.optimizer._pick_engine() == "v2"
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
    assert list(done_t) == [1, 1]
    assert venv_t.optimizer._h_planes is None      # nothing dense at 10q


def test_train_vectorized_v2_writes_reference_schema(tmp_path):
    conf = _conf()
    conf["env"]["n_starts"] = 2
    conf["non_local_opt"]["global_iters"] = 3
    conf["agent"].update(neurons=[32, 32], memory_size=64, batch_size=4,
                         n_step=1)
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", noise_mode="none",
                              seed=0, device="cpu")
    venv = VectorCircuitEnv(cfg, n_envs=2)
    agent = make_agent(conf, venv.action_size, venv.state_size, seed=0,
                       device="cpu")
    assert venv.state_size == 30 * 10 * 16
    out = tmp_path / "run"
    summary = train_vectorized(venv, agent, conf, 0, str(out),
                               total_env_steps=2 * 3, loss_fetch_every=1,
                               verbose=False)
    assert summary["steps"] == 6 and summary["episodes"] == 2
    assert np.isfinite(summary["best_step_error"])
    assert venv.optimizer._h_planes is None
    stats = np.load(out / "summary_0.npy", allow_pickle=True).item()
    assert set(stats) == {"train", "test"}
    assert sorted(stats["train"]) == [0, 1]
    for rec in stats["train"].values():
        assert set(rec) == set(_TRAIN_KEYS) | {"done_threshold",
                                               "bond_distance"}
        assert len(rec["actions"]) == len(rec["errors"]) == 3
        assert np.isfinite(rec["errors"]).all()
    events = [json.loads(line) for line in
              (out / "events_0.jsonl").read_text().splitlines()]
    assert [ev["steps"] for ev in events] == [2, 4, 6]
    assert agent.step_counter >= 1                 # the replay ran
