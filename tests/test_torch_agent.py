"""Agent layer of the PyTorch port against the JAX package: Flax
``QNetwork`` parameters carried over by ``params_from_jax`` give the same
Q-values, and one double-DQN replay step from the same buffer gives the
same loss and updated parameters (float32: within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.agents.dqn import DQN_Nstep as DQNJax
from tensorrl_qas_tpu.models.qnet import QNetwork as QNetJax
from tensorrl_qas_tpu_torch.agents.dqn import DQN_Nstep, make_agent
from tensorrl_qas_tpu_torch.models.qnet import QNetwork, params_from_jax

TOL = 1e-5


def small_conf():
    return {"env": {"num_qubits": 3, "num_layers": 4},
            "agent": {"batch_size": 16, "memory_size": 64,
                      "neurons": [48, 32, 40], "dropout": 0.0,
                      "learning_rate": 1e-3, "angles": 0, "en_state": 1,
                      "agent_type": "DeepQNstep", "agent_class": "DQN_Nstep",
                      "n_step": 3, "init_net": 0, "priotitized_replay": 0,
                      "update_target_net": 5, "final_gamma": 0.05,
                      "epsilon_decay": 0.9, "epsilon_min": 0.05,
                      "epsilon_restart": 1.0}}


def _np_params(params):
    return jax.tree.map(np.asarray, params)


def test_qnetwork_params_from_jax_same_q_values():
    rng = np.random.default_rng(0)
    net_j = QNetJax(hidden=(64, 32), n_actions=11)
    params = net_j.init(jax.random.PRNGKey(1), jnp.zeros((1, 20)))
    x = rng.normal(size=(7, 20)).astype(np.float32)
    q_j = np.asarray(net_j.apply(params, jnp.asarray(x)))
    net_t = QNetwork(20, (64, 32), 11)
    net_t.load_state_dict(params_from_jax(_np_params(params)))
    with torch.no_grad():
        q_t = net_t(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=TOL)


def test_qnetwork_params_from_jax_at_12q_state_width():
    """The carried-over MLP at the input width of the 12-qubit LiH config
    (137 layers x 12 qubits x 18 = 29,592 features, 12 x 14 actions)."""
    rng = np.random.default_rng(1)
    width, n_actions = 137 * 12 * 18, 12 * 14
    net_j = QNetJax(hidden=(64, 32), n_actions=n_actions)
    params = net_j.init(jax.random.PRNGKey(2), jnp.zeros((1, width)))
    x = (rng.random(size=(5, width)) < 0.05).astype(np.float32)
    q_j = np.asarray(net_j.apply(params, jnp.asarray(x)))
    net_t = QNetwork(width, (64, 32), n_actions)
    net_t.load_state_dict(params_from_jax(_np_params(params)))
    with torch.no_grad():
        q_t = net_t(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=TOL)


def test_one_replay_step_matches_jax():
    conf = small_conf()
    state_size, action_size = 4 * 3 * 9, 15
    agent_j = DQNJax(conf, action_size, state_size, seed=4)
    agent_t = make_agent(conf, action_size, state_size, seed=4, device="cpu")
    assert isinstance(agent_t, DQN_Nstep)
    assert agent_t.gamma == agent_j.gamma
    assert agent_t.state_size == agent_j.state_size
    agent_t.model.load_state_dict(params_from_jax(_np_params(
        agent_j.params)))
    rng = np.random.default_rng(9)
    s_dim = agent_t.state_size
    for env_id in (1, 2):
        s = rng.normal(size=s_dim).astype(np.float32)
        for _ in range(12):
            ns = rng.normal(size=s_dim).astype(np.float32)
            a = int(rng.integers(action_size))
            r = float(rng.normal())
            d = float(rng.random() < 0.2)
            agent_j.remember(s, a, r, ns, d, env_id=env_id)
            agent_t.remember(s, a, r, ns, d, env_id=env_id)
            s = ns
    assert len(agent_t.memory) == len(agent_j.memory)
    loss_j = agent_j.replay(conf["agent"]["batch_size"])
    loss_t = agent_t.replay(conf["agent"]["batch_size"])
    assert loss_t == pytest.approx(loss_j, abs=TOL)
    after = params_from_jax(_np_params(agent_j.params))
    for name, value in agent_t.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                   atol=TOL, err_msg=name)
    assert agent_t.epsilon == pytest.approx(agent_j.epsilon)


def test_act_batch_masks_and_matches_greedy_jax():
    conf = small_conf()
    conf["agent"]["init_epsilon"] = 0.0
    conf["agent"]["epsilon_min"] = 0.0
    agent_j = DQNJax(conf, 15, 108, seed=2)
    agent_t = make_agent(conf, 15, 108, seed=2, device="cpu")
    agent_t.model.load_state_dict(params_from_jax(_np_params(
        agent_j.params)))
    states = np.random.default_rng(3).normal(
        size=(5, agent_t.state_size)).astype(np.float32)
    illegal = [[0, 1], [], [14], list(range(14)), [3]]
    a_j, _ = agent_j.act_batch(states, illegal)
    a_t, explore = agent_t.act_batch(states, illegal)
    assert not explore.any()
    np.testing.assert_array_equal(a_t, a_j)
    assert a_t[3] == 14


def test_checkpoint_roundtrip(tmp_path):
    """torch.save checkpoint of agent + replay buffer restores the same
    networks, Adam state, epsilon, step counter and sampling stream."""
    from tensorrl_qas_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    conf = small_conf()
    agent = make_agent(conf, 15, 108, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(30):
        s, ns = rng.normal(size=(2, agent.state_size)).astype(np.float32)
        agent.remember(s, int(rng.integers(15)), float(rng.normal()), ns,
                       0.0, env_id=1)
    agent.replay(8)
    save_checkpoint(str(tmp_path / "ck"), agent)
    fresh = make_agent(conf, 15, 108, seed=2, device="cpu")
    load_checkpoint(str(tmp_path / "ck"), fresh)
    for a, b in zip(agent.model.parameters(), fresh.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fresh.epsilon == agent.epsilon
    assert fresh.step_counter == agent.step_counter
    assert len(fresh.memory) == len(agent.memory)
    np.testing.assert_array_equal(fresh.memory.sample_indices(8),
                                  agent.memory.sample_indices(8))
    assert fresh.replay(8) == pytest.approx(agent.replay(8), abs=1e-6)
