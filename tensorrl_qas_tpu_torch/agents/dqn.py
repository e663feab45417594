"""Double-DQN agents (PyTorch).

Same behaviour as the JAX package's ``agents/dqn.py`` and the reference
agents (``agents/DeepQ.py:14-155``, ``agents/DeepQNstep.py:13-55``):

- epsilon-greedy policy over a masked action space (illegal ids -> -inf),
- per-step discount gamma = round(final_gamma^(1/num_layers), 2)
  (``DeepQ.py:55``, rounding included: it changes learning dynamics),
- double-DQN TD targets (policy-net argmax, target-net evaluation),
- SmoothL1 (Huber) loss + Adam, plus the DQfD margin term on samples
  flagged as demonstrations (zero without demonstrations),
- hard target-net sync every ``update_target_net`` replays,
- epsilon decay per replay call,
- uniform, prioritized (``priotitized_replay``, one-step agents only, as
  in the JAX package) or n-step replay, resident on the agent's device.

The network's matrix products run on cuBLAS through ``nn.Linear``; no
hand-written kernel is involved.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.agents.replay import (
    DeviceReplay,
    PrioritizedReplayMemory,
    restore_rng,
    rng_state_json,
)
from tensorrl_qas_tpu_torch.circuits.actions import action_dictionary
from tensorrl_qas_tpu_torch.models.qnet import QNetwork


class DQN:
    """Double DQN with uniform or prioritized replay."""

    n_step_key = None      # config key of the n-step horizon, if any

    def __init__(self, conf: dict, action_size: int, state_size: int,
                 seed: int = 0, device=None):
        env_c, agent_c = conf["env"], conf["agent"]
        self.device = as_device(device)
        self.num_qubits = env_c["num_qubits"]
        self.num_layers = env_c["num_layers"]
        self.action_size = action_size
        self.final_gamma = agent_c["final_gamma"]
        self.epsilon = float(agent_c.get("init_epsilon", 1.0))
        self.epsilon_min = agent_c["epsilon_min"]
        self.epsilon_decay = agent_c["epsilon_decay"]
        self.update_target_net = agent_c["update_target_net"]
        self.with_angles = int(agent_c.get("angles", 0))
        # the reference's memory reset (read by the sequential driver)
        self.memory_reset_switch = agent_c.get("memory_reset_switch", False)
        self.memory_reset_threshold = agent_c.get("memory_reset_threshold",
                                                  False)
        self.memory_reset_counter = 0 if self.memory_reset_switch else False

        # observation size: strip the angle block, optionally append the
        # energy and threshold scalars (reference ``DeepQ.py:43-46``); the
        # su4 gate set carries a (3n+3)-row angle block instead of 3
        gate_set = env_c.get("gate_set", "cnot")
        angle_rows = 3 * self.num_qubits + 3 if gate_set == "su4" else 3
        s = state_size
        if not self.with_angles:
            s -= self.num_layers * self.num_qubits * angle_rows
        if agent_c.get("en_state", 0):
            s += 1
        if agent_c.get("threshold_in_state", 0):
            s += 1
        self.state_size = s

        topology = env_c.get("topology", "all_to_all")
        self.translate = action_dictionary(self.num_qubits, topology,
                                           gate_set=gate_set)

        # per-step discount; the reference rounds to 2 decimals (DeepQ.py:55)
        self.gamma = float(np.round(self.final_gamma
                                    ** (1.0 / self.num_layers), 2))

        self.model = QNetwork(self.state_size, tuple(agent_c["neurons"]),
                              action_size,
                              dropout=float(agent_c.get("dropout", 0.0)))
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        self.target = copy.deepcopy(self.model)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=agent_c["learning_rate"])
        self.step_counter = 0
        self.rng = np.random.default_rng(seed)

        # DQfD margin-loss hyperparameters (active only on samples whose
        # demo flag is set)
        self.demo_margin = float(agent_c.get("demo_margin", 0.8))
        self.demo_lambda = float(agent_c.get("demo_lambda", 1.0))
        n_step = int(agent_c[self.n_step_key]) if self.n_step_key else 0
        self.prioritized_replay = (bool(int(agent_c.get("priotitized_replay",
                                                        0)))
                                   and not n_step)
        if self.prioritized_replay:
            self.memory = PrioritizedReplayMemory(
                agent_c["memory_size"], self.state_size, seed=seed + 1,
                device=self.device)
        else:
            self.memory = DeviceReplay(agent_c["memory_size"],
                                       self.state_size, seed=seed + 1,
                                       n_step=n_step, gamma=self.gamma,
                                       device=self.device)

    # -- acting --------------------------------------------------------------

    @torch.no_grad()
    def _greedy(self, states, masks):
        q = self.model(torch.as_tensor(states, dtype=torch.float32,
                                       device=self.device))
        q = q.masked_fill(torch.as_tensor(masks, device=self.device),
                          -torch.inf)
        return torch.argmax(q, dim=1).cpu().numpy()

    def act(self, state: np.ndarray, illegal: list[int]):
        """epsilon-greedy with illegal-action masking for one state
        (reference ``DeepQ.py:76-89``), on ``act_batch``'s generator:
        -> (action, explored)."""
        if self.rng.random() <= self.epsilon:
            a = int(self.rng.integers(self.action_size))
            while a in illegal:
                a = int(self.rng.integers(self.action_size))
            return a, True
        mask = np.zeros((1, self.action_size), dtype=bool)
        if illegal:
            mask[0, np.asarray(illegal, dtype=np.int64)] = True
        return int(self._greedy(np.asarray(state)[None], mask)[0]), False

    def act_batch(self, states: np.ndarray, illegal: list[list[int]]):
        """epsilon-greedy with illegal-action masking (reference
        ``DeepQ.py:76-89``) over B env replicas: one device call covers
        every greedy replica; exploring replicas sample on the host."""
        b = states.shape[0]
        explore = self.rng.random(b) <= self.epsilon
        actions = np.zeros(b, dtype=np.int64)
        masks = np.zeros((b, self.action_size), dtype=bool)
        for i, ill in enumerate(illegal):
            if ill:
                masks[i, np.asarray(ill, dtype=np.int64)] = True
        if not explore.all():
            actions[:] = self._greedy(states, masks)
        for i in np.nonzero(explore)[0]:
            a = int(self.rng.integers(self.action_size))
            while masks[i, a]:
                a = int(self.rng.integers(self.action_size))
            actions[i] = a
        return actions, explore

    def remember(self, state, action, reward, next_state, done,
                 env_id=0, is_demo: float = 0.0) -> None:
        self.memory.push(state, action, reward, next_state, done,
                         env_id=env_id, is_demo=is_demo)

    # -- learning ---------------------------------------------------------

    def loss(self, states, actions, rewards, next_states, dones, demos,
             weights=None):
        """Double-DQN SmoothL1 loss plus the DQfD margin term; with
        importance ``weights`` (prioritized replay) the loss of the
        weighted Q values against the weighted targets, as the JAX package
        weighs them.  -> (loss, |TD error| (B,), detached)."""
        q = self.model(states)
        q_sa = q.gather(1, actions[:, None])[:, 0]
        with torch.no_grad():
            a_star = torch.argmax(self.model(next_states), dim=1)
            q_next = self.target(next_states).gather(1, a_star[:, None])[:, 0]
            target = rewards + self.gamma * q_next * (1.0 - dones)
        if weights is None:
            loss = torch.nn.functional.smooth_l1_loss(q_sa, target)
        else:
            loss = torch.nn.functional.smooth_l1_loss(q_sa * weights,
                                                      target * weights)
        onehot = torch.nn.functional.one_hot(actions, q.shape[1]).to(q.dtype)
        sup = torch.max(q + self.demo_margin * (1.0 - onehot), dim=1).values
        loss = loss + self.demo_lambda * torch.mean(demos * (sup - q_sa))
        return loss, (target - q_sa).detach().abs()

    def replay(self, batch_size: int, fetch_loss: bool = True):
        if self.step_counter % self.update_target_net == 0:
            self.target.load_state_dict(self.model.state_dict())
        self.step_counter += 1
        weights = None
        if self.prioritized_replay:
            idx, w = self.memory.sample_weighted(batch_size,
                                                 frame_idx=self.step_counter)
            weights = torch.as_tensor(w, device=self.device)
        else:
            idx = self.memory.sample_indices(batch_size)
        at = torch.as_tensor(idx, device=self.device)
        loss, td = self.loss(*(buf[at] for buf in self.memory.buffers()),
                             weights=weights)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.prioritized_replay:
            self.memory.update_priorities(idx, td.cpu().numpy())
        if self.epsilon > self.epsilon_min:
            self.epsilon = max(self.epsilon * self.epsilon_decay,
                               self.epsilon_min)
        # fetch_loss=False leaves the loss on the device (no host sync)
        return loss.item() if fetch_loss else loss.detach()

    def replay_burst(self, batch_size: int, k: int):
        """k sequential replay updates; returns the last loss (device)."""
        loss = None
        for _ in range(k):
            loss = self.replay(batch_size, fetch_loss=False)
        return loss

    # -- checkpointing ----------------------------------------------------

    def state_dict(self):
        return {
            "params": self.model.state_dict(),
            "target_params": self.target.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "epsilon": self.epsilon,
            "step_counter": self.step_counter,
            "rng_state": rng_state_json(self.rng),
        }

    def load_state_dict(self, d):
        self.model.load_state_dict(d["params"])
        self.target.load_state_dict(d["target_params"])
        self.optimizer.load_state_dict(d["opt_state"])
        self.epsilon = float(d["epsilon"])
        self.step_counter = int(d["step_counter"])
        restore_rng(self.rng, d["rng_state"])


class DQN_Nstep(DQN):
    """DQN with n-step returns (reference ``agents/DeepQNstep.py``)."""

    n_step_key = "n_step"


_AGENT_CLASSES = {"DQN": DQN, "DQN_Nstep": DQN_Nstep}


def make_agent(conf: dict, action_size: int, state_size: int, seed: int = 0,
               device=None):
    """Factory keyed by the config's ``agent_class`` (the reference
    resolves it by reflection, ``TensorRL_fixed_noiseless.py:236``)."""
    name = conf["agent"]["agent_class"]
    if name not in _AGENT_CLASSES:
        raise ValueError(f"unknown agent_class {name!r}; "
                         f"available: {sorted(_AGENT_CLASSES)}")
    return _AGENT_CLASSES[name](conf, action_size, state_size, seed=seed,
                                device=device)
