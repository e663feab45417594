"""The port's sequential driver (``train/driver.py``), its CLI without
``--vector``, demonstration seeding and prioritized replay, against the
JAX package where the JAX package fixes the contract:

- twins of ``tests/test_driver.py``'s fast tests: the train loop writes the
  JAX driver's record keys (``summary_<seed>.npy``), checkpoints and the
  events stream; ``agent_test`` is greedy, restores epsilon and keeps the
  best model per threshold; the CLI's overrides reach the config; the CLI
  without ``--vector`` trains sequentially, with Adam and with COBYLA;
- ``collect_demo_transitions`` (the JAX test's gate list) and ``--demo``;
- prioritized replay: twins of ``test_agents.py::
  test_per_priorities_shift_sampling`` and ``test_checkpoint_resume.py::
  test_per_priorities_roundtrip``, the priorities through a checkpoint and
  ``init_net``, and one prioritized replay step against the JAX agent's
  (same buffer, indices, weights, loss and priorities; float32, 1e-5).
"""

import json

import jax
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.agents.dqn import DQN as DQNJax
from tensorrl_qas_tpu.train.saver import Saver as SaverJax
from tensorrl_qas_tpu_torch import native
from tensorrl_qas_tpu_torch.agents.dqn import DQN, make_agent
from tensorrl_qas_tpu_torch.agents.replay import PrioritizedReplayMemory
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.models.qnet import params_from_jax
from tensorrl_qas_tpu_torch.ops import build
from tensorrl_qas_tpu_torch.train import cli
from tensorrl_qas_tpu_torch.train.checkpoint import (
    init_net,
    init_net_prefix,
    load_checkpoint,
    save_checkpoint,
)
from tensorrl_qas_tpu_torch.train.driver import agent_test, train
from tensorrl_qas_tpu_torch.train.saver import Saver
from tensorrl_qas_tpu_torch.train.vector_driver import (
    collect_demo_transitions,
    train_vectorized,
)
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.train.config import get_config

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def build_dir(tmp_path_factory):
    """The host engine (COBYLA runs) built in a temporary build/."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "BUILD_DIR", tmp_path_factory.mktemp("build"))
        native._library.cache_clear()
        yield
    native._library.cache_clear()


def small_conf():
    """``tests/test_driver.py``'s config, with a shorter gate budget."""
    return {
        "general": {"episodes": 3},
        "env": {"num_qubits": 5, "num_layers": 30, "rand_halt": 0,
                "tn_init": 1, "tn_bond": 2, "zero_param_init": 0,
                "n_shots": 0, "accept_err": 1e-3, "thresholds": [1e-3],
                "switch_episodes": [100000],
                "curriculum_type": "VanillaCurriculum",
                "fn_type": "incremental_with_fixed_ends", "n_starts": 2},
        "problem": {"ham_type": "heisenberg", "geometry": "0",
                    "mapping": "jordan_wigner"},
        "agent": {"batch_size": 16, "memory_size": 256,
                  "neurons": [32, 32], "dropout": 0.0,
                  "learning_rate": 1e-3, "angles": 0, "en_state": 1,
                  "agent_type": "DeepQNstep", "agent_class": "DQN_Nstep",
                  "n_step": 3, "init_net": 0, "priotitized_replay": 0,
                  "update_target_net": 10, "final_gamma": 0.05,
                  "epsilon_decay": 0.99, "epsilon_min": 0.05,
                  "epsilon_restart": 1.0},
        "non_local_opt": {"global_iters": 5, "method": "scipy_each_step",
                          "optim_alg": "COBYLA"},
    }


def make_env(conf, seed=0, **kw):
    return CircuitEnv(EnvConfig.from_conf(conf, tn_placement="fixed",
                                          seed=seed, device="cpu", **kw))


def test_train_loop_and_saver_schema(tmp_path):
    conf = small_conf()
    env = make_env(conf)
    agent = make_agent(conf, env.action_size, env.state_size, seed=0,
                       device="cpu")
    saver = train(env, agent, conf, seed=0, output_path=str(tmp_path),
                  episodes=3, checkpoint_every=2, verbose=False)
    blob = np.load(tmp_path / "summary_0.npy", allow_pickle=True).item()
    assert set(blob) == {"train", "test"}
    assert set(blob["train"]) == {0, 1, 2}
    rec = blob["train"][0]
    # the JAX driver's record: its Saver's episode keys
    jax_saver = SaverJax(str(tmp_path / "jax"), 0)
    jax_saver.new_episode("train", 0)
    assert set(rec) == set(jax_saver.stats["train"][0])
    assert len(rec["actions"]) == len(rec["errors"]) > 0
    # replay ran once the memory passed batch 16
    assert any(blob["train"][e]["loss"] for e in (1, 2))
    assert all(n == 5 * 2 for n in rec["nfev"])
    for suffix in ("agent.pt", "replay.npz", "env.pkl"):
        assert (tmp_path / f"thresh_0.001_0_{suffix}").exists()
    events = [json.loads(line) for line in
              (tmp_path / "events_0.jsonl").read_text().splitlines()]
    assert [ev["episode"] for ev in events] == [0, 1, 2]
    assert saver.stats is not None


def test_agent_test_greedy_rollout_and_best_model(tmp_path):
    conf = small_conf()
    env = make_env(conf, seed=1)
    agent = make_agent(conf, env.action_size, env.state_size, seed=1,
                       device="cpu")
    saver = Saver(str(tmp_path), 1)
    eps = agent.epsilon
    reward, steps, error = agent_test(0, env, agent, conf, saver,
                                      output_path=str(tmp_path))
    assert agent.epsilon == eps                 # restored after the rollout
    assert reward is not None and steps <= env.num_layers
    assert np.isfinite(error)
    assert len(saver.stats["test"][0]["actions"]) == steps + 1
    best = (tmp_path / f"thresh_0.001_1_best_geo_"
            f"{env.current_bond_distance}_agent.pt")
    assert best.exists()
    # an earlier test episode at the same threshold did better: no save
    best.unlink()
    saver.new_episode("test", 1)
    saver.append("test", 1, actions=0, errors=0.0, errors_noiseless=0.0,
                 nfev=0, opt_ang=0, time=0.0)
    saver.set("test", 1, done_threshold=env.done_threshold)
    agent_test(2, env, agent, conf, saver, output_path=str(tmp_path))
    assert not best.exists()


def test_cli_overrides_reach_the_config():
    args = cli.build_parser().parse_args(
        ["--config", "heisenberg_5q_TNbond2", "--global_iters", "321",
         "--n_starts", "5", "--num_layers", "44", "--eps_decay", "0.5",
         "--eps_min", "0.2", "--init_eps", "0.7", "--accept_err", "0.01",
         "--optim", "cobyla", "--topology", "hexagon", "--gpu_id", "2",
         "--batch_size", "64"])
    conf, cfg = cli.configure(args)
    assert (cfg.global_iters, cfg.n_starts, cfg.num_layers) == (321, 5, 44)
    assert (cfg.optim_alg, cfg.topology, cfg.device) == ("cobyla",
                                                          "hexagon", "cuda:2")
    assert cfg.accept_err == 0.01
    assert conf["env"]["thresholds"] == [0.01]
    assert conf["agent"]["epsilon_decay"] == 0.5
    assert conf["agent"]["epsilon_min"] == 0.2
    assert conf["agent"]["init_epsilon"] == 0.7
    assert conf["agent"]["batch_size"] == 64
    _, cfg = cli.configure(cli.build_parser().parse_args(
        ["--config", "heisenberg_5q_TNbond2", "--device", "cpu",
         "--gpu_id", "1"]))
    assert (cfg.optim_alg, cfg.device) == ("adam", "cpu")
    assert cli.infer_modes("TensorRL_fixed/", "x_noise_restricted")[1:] == (
        "shot", "hexagon")


@pytest.mark.parametrize("optim", ["adam", "cobyla"])
def test_cli_without_vector_trains_sequentially(tmp_path, optim):
    summary = cli.run([
        "--device", "cpu", "--config", "heisenberg_5q_TNbond2",
        "--episodes", "2", "--global_iters", "4", "--n_starts", "2",
        "--num_layers", "30", "--batch_size", "8", "--test_every", "1",
        "--optim", optim, "--results_path", str(tmp_path) + "/"])
    assert summary["episodes"] == 2 and summary["test_episodes"] == 1
    assert summary["steps"] > 0 and summary["test_steps"] > 0
    assert np.isfinite(summary["best_error"])
    if optim == "adam":
        assert summary["nfev"] == summary["steps"] * 4 * 2
    out = tmp_path / "TensorRL_fixed" / "heisenberg_5q_TNbond2"
    stats = np.load(out / "summary_0.npy", allow_pickle=True).item()
    assert set(stats["train"]) == {0, 1} and set(stats["test"]) == {1}
    assert (out / "thresh_0.001_0_agent.pt").exists()


def test_cli_resumes_with_init_net(tmp_path, monkeypatch):
    conf = small_conf()
    env = make_env(conf)
    agent = make_agent(conf, env.action_size, env.state_size, seed=0,
                       device="cpu")
    agent.epsilon = 0.4321
    prefix = init_net_prefix(str(tmp_path) + "/", "heisenberg_5q_TNbond2",
                             conf, 0)
    assert prefix.endswith("finalize/heisenberg_5q_TNbond2/thresh_0.001_0")
    save_checkpoint(prefix, agent, env)
    fresh = make_agent(conf, env.action_size, env.state_size, seed=3,
                       device="cpu")
    init_net(prefix, conf, fresh, make_env(conf))
    assert fresh.epsilon == pytest.approx(0.4321)     # epsilon_restart set
    conf["agent"]["epsilon_restart"] = 0
    init_net(prefix, conf, fresh)
    assert fresh.epsilon == fresh.epsilon_min


def test_collect_demo_transitions_and_seeding(tmp_path):
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    conf["non_local_opt"]["global_iters"] = 3
    conf["env"]["n_starts"] = 2
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", seed=0,
                              device="cpu")
    gates = [[2, 1, -1], [4, 2, 0], [1, 3, -1], [3, 0, -1]]
    trans, final_err = collect_demo_transitions(cfg, conf, gates)
    assert len(trans) == 5                  # 4 gates + a trailing rotation
    s0, a0, r0, ns0, d0 = trans[0]
    assert s0.shape == ns0.shape
    assert np.isfinite(final_err)
    assert all(np.isfinite(t[2]) for t in trans)
    assert all(0 <= t[1] < 35 for t in trans)
    # seeded into the replay buffer, flagged as demonstrations
    conf["agent"]["batch_size"] = 4
    venv = VectorCircuitEnv(cfg, n_envs=2)
    agent = make_agent(conf, venv.action_size, venv.state_size, seed=0,
                       device="cpu")
    train_vectorized(venv, agent, conf, 0, str(tmp_path),
                     total_env_steps=4, verbose=False,
                     demo_transitions=trans, demo_copies=2)
    agent.memory.flush()
    # n_step 5 folds each copy's 5 transitions into one
    assert float(agent.memory.demos.sum()) == 2.0


def per_conf():
    conf = small_conf()
    conf["agent"].update(agent_class="DQN", priotitized_replay=1,
                         batch_size=8, update_target_net=5)
    return conf


def test_per_priorities_shift_sampling():
    mem = PrioritizedReplayMemory(32, state_size=1, seed=0, alpha=1.0)
    for i in range(10):
        mem.push(np.full(1, i, np.float32), i, 0.0, np.zeros(1, np.float32),
                 0.0)
    mem.update_priorities(np.arange(10), np.full(10, 1e-6))
    mem.update_priorities(np.array([7]), np.array([100.0]))
    idx, batch, w = mem.sample(64, frame_idx=1)
    assert np.mean(idx == 7) > 0.9  # the dominant priority dominates
    assert w.shape == (64,) and batch[0].shape == (64, 1)
    np.testing.assert_array_equal(batch[1].numpy(), idx)


def test_per_priorities_roundtrip(tmp_path):
    mem = PrioritizedReplayMemory(64, 4, seed=1)
    rng = np.random.default_rng(0)
    for i in range(10):
        mem.push(rng.normal(size=4), i % 3, float(i), rng.normal(size=4),
                 float(i == 9))
    mem.flush()
    np.testing.assert_array_equal(mem.priorities[:10], 1.0)
    mem.priorities[:10] = np.linspace(0.1, 1.0, 10)
    d = mem.state_dict()
    mem2 = PrioritizedReplayMemory(64, 4, seed=2)
    mem2.load_state_dict({k: np.asarray(v) if not np.isscalar(v) else v
                          for k, v in d.items()})
    np.testing.assert_allclose(mem2.priorities[:10], mem.priorities[:10])
    idx, w = mem2.sample_weighted(4)
    assert len(idx) == 4 and np.all(np.asarray(w) > 0)
    # a new transition enters at the largest priority so far
    mem2.push(rng.normal(size=4), 0, 0.0, rng.normal(size=4), 0.0)
    mem2.flush()
    assert mem2.priorities[10] == pytest.approx(1.0)


def _fill(agents, rng, n=24, action_size=15):
    s_dim = agents[0].state_size
    for _ in range(n):
        s, ns = rng.normal(size=(2, s_dim)).astype(np.float32)
        a, r = int(rng.integers(action_size)), float(rng.normal())
        d = float(rng.random() < 0.2)
        for agent in agents:
            agent.remember(s, a, r, ns, d)


def test_per_priorities_through_checkpoint_and_init_net(tmp_path):
    conf = per_conf()
    agent = make_agent(conf, 15, 4 * 30 * 11, seed=1, device="cpu")
    assert isinstance(agent.memory, PrioritizedReplayMemory)
    _fill([agent], np.random.default_rng(0))
    agent.replay(8)
    prefix = str(tmp_path / "finalize" / "ck")
    save_checkpoint(prefix, agent)
    fresh = make_agent(conf, 15, 4 * 30 * 11, seed=2, device="cpu")
    init_net(prefix, conf, fresh)
    n = len(agent.memory)
    np.testing.assert_array_equal(fresh.memory.priorities[:n],
                                  agent.memory.priorities[:n])
    np.testing.assert_array_equal(fresh.memory.sample_weighted(8, 3)[0],
                                  agent.memory.sample_weighted(8, 3)[0])
    fresh2 = make_agent(conf, 15, 4 * 30 * 11, seed=2, device="cpu")
    load_checkpoint(prefix, fresh2)
    assert fresh2.epsilon == agent.epsilon


def test_per_replay_steps_match_jax():
    conf = per_conf()
    state_size, action_size = 4 * 30 * 11, 15
    agent_j = DQNJax(conf, action_size, state_size, seed=4)
    agent_t = make_agent(conf, action_size, state_size, seed=4,
                         device="cpu")
    assert type(agent_t) is DQN and agent_t.prioritized_replay
    agent_t.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, agent_j.params)))
    _fill([agent_j, agent_t], np.random.default_rng(9))
    for _ in range(3):
        loss_j = agent_j.replay(8)
        loss_t = agent_t.replay(8)
        assert loss_t == pytest.approx(loss_j, abs=TOL)
        n = len(agent_t.memory)
        np.testing.assert_allclose(agent_t.memory.priorities[:n],
                                   agent_j.memory.priorities[:n], atol=TOL)
    after = params_from_jax(jax.tree.map(np.asarray, agent_j.params))
    for name, value in agent_t.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                   atol=TOL, err_msg=name)


def test_act_one_state_masks_and_matches_act_batch():
    conf = small_conf()
    conf["agent"]["init_epsilon"] = 0.0
    conf["agent"]["epsilon_min"] = 0.0
    agent = make_agent(conf, 15, 4 * 30 * 11, seed=2, device="cpu")
    states = np.random.default_rng(3).normal(
        size=(4, agent.state_size)).astype(np.float32)
    illegal = [[0, 1], [], [14], list(range(14))]
    greedy, _ = agent.act_batch(states, illegal)
    for state, ill, want in zip(states, illegal, greedy):
        a, explored = agent.act(state, ill)
        assert (a, explored) == (want, False)
    agent.epsilon = 1.0
    for _ in range(50):
        a, explored = agent.act(states[0], list(range(14)))
        assert (a, explored) == (14, True)
    assert torch.is_tensor(agent.memory.states)
