"""Checkpoint / resume.

Reference behaviour (``TensorRL_fixed_noiseless.py:179-183, 239-252``):
save the policy net, optimizer state and replay buffer; ``init_net``
reloads all three and optionally skips the epsilon restart.  The agent's
state (both networks, the Adam state, epsilon, step counter and the numpy
RNG state) goes through ``torch.save``; the replay buffer (the priorities
of prioritized replay included) through compressed npz, as in the JAX
package; the env's curriculum and RNG through pickle.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def save_checkpoint(path_prefix: str, agent, env=None) -> None:
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    torch.save(agent.state_dict(), path_prefix + "_agent.pt")
    np.savez_compressed(path_prefix + "_replay.npz",
                        **agent.memory.state_dict())
    if env is not None:
        payload = {"curricula": env.curriculum_state(),
                   "np_rng": getattr(env, "_np_rng", None)}
        with open(path_prefix + "_env.pkl", "wb") as f:
            pickle.dump(payload, f)


def load_checkpoint(path_prefix: str, agent, env=None,
                    restore_replay: bool = True) -> None:
    agent.load_state_dict(torch.load(path_prefix + "_agent.pt",
                                     map_location=agent.device))
    if restore_replay and os.path.exists(path_prefix + "_replay.npz"):
        data = np.load(path_prefix + "_replay.npz", allow_pickle=True)
        agent.memory.load_state_dict({k: data[k] for k in data.files})
    if env is not None and os.path.exists(path_prefix + "_env.pkl"):
        with open(path_prefix + "_env.pkl", "rb") as f:
            payload = pickle.load(f)
        env.load_curriculum_state(payload["curricula"])
        if payload.get("np_rng") is not None:
            env._np_rng = payload["np_rng"]


def init_net_prefix(results_path: str, config: str, conf: dict,
                    seed: int) -> str:
    """Where ``init_net`` reads its checkpoint: the JAX CLI's
    ``results/finalize/<config>/thresh_<accept_err>_<seed>`` under
    ``results_path`` (reference ``TensorRL_fixed_noiseless.py:239-245``)."""
    return (f"{results_path}finalize/{config}/"
            f"thresh_{conf['env']['accept_err']}_{seed}")


def init_net(prefix: str, conf: dict, agent, env=None) -> None:
    """The reference's ``init_net`` warm start
    (``TensorRL_fixed_noiseless.py:239-252``): the agent, its replay
    buffer and the env's curriculum and RNG from ``prefix``; epsilon drops
    to epsilon_min unless the config's ``epsilon_restart`` is set."""
    load_checkpoint(prefix, agent, env)
    if not conf["agent"].get("epsilon_restart"):
        agent.epsilon = agent.epsilon_min
