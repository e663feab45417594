"""Sequential training: episodes of masked epsilon-greedy circuit
construction, one env step at a time.

The port of ``tensorrl_qas_tpu/train/driver.py``, with the reference
driver's semantics (``TensorRL_fixed_noiseless.py:105-183``): per step a
mask query, ``act``, ``env.step``, ``remember`` and a replay (once the
memory holds more than batch_size transitions, optionally every
``replay_ratio`` steps); the reference's memory reset; metrics in the
reference's ``summary_<seed>.npy`` schema; a checkpoint every
``checkpoint_every`` episodes.  As in the JAX package, the greedy
evaluation rollout (``agent_test``, dead code in the reference's drivers at
``TensorRL_fixed_noiseless.py:66-102``) runs every ``test_every`` episodes
and keeps the best model per threshold.  Each step's angle optimization is
the env's: the fused Adam step on a batch of one, or COBYLA.
"""

from __future__ import annotations

import time

import numpy as np

from tensorrl_qas_tpu_torch.train.checkpoint import save_checkpoint
from tensorrl_qas_tpu_torch.train.saver import Saver


def modify_state(state: np.ndarray, env, conf: dict) -> np.ndarray:
    """Append prev_energy and (optionally) the done threshold to the
    observation (reference ``TensorRL_fixed_noiseless.py:53-63``)."""
    extra = []
    if conf["agent"].get("en_state", 0):
        extra.append(np.float32(env.prev_energy))
    if conf["agent"].get("threshold_in_state", 0):
        extra.append(np.float32(env.done_threshold))
    if extra:
        state = np.concatenate([state, np.asarray(extra, dtype=np.float32)])
    return state


def one_episode(episode: int, env, agent, conf: dict, saver: Saver) -> dict:
    """One training episode; -> {'steps', 'done', 'error', 'reward',
    'time', 'epsilon'}."""
    t0 = time.time()
    saver.new_episode("train", episode)
    state = env.reset()
    saver.set("train", episode, bond_distance=env.current_prob,
              done_threshold=env.done_threshold)
    state = modify_state(state, env, conf)
    batch_size = conf["agent"]["batch_size"]
    replay_ratio = conf["agent"].get("replay_ratio")
    summary = {"steps": 0, "done": 0, "error": None, "reward": 0.0}

    for itr in range(env.num_layers + 1):
        illegal = env.illegal_action_new()
        action, _ = agent.act(state, illegal)
        saver.append("train", episode, actions=action)

        next_state, reward, done = env.step(agent.translate[action])
        next_state = modify_state(next_state, env, conf)
        agent.remember(state, action, reward, next_state, float(done))
        state = next_state

        saver.append("train", episode, errors=env.error,
                     errors_noiseless=env.error_noiseless,
                     opt_ang=env.opt_ang_save, save_circ=env.save_circ,
                     nfev=env.nfev, reward=env.rwd,
                     time=time.time() - t0)

        if agent.memory_reset_switch:
            if env.error < agent.memory_reset_threshold:
                agent.memory_reset_counter += 1
            if agent.memory_reset_counter == agent.memory_reset_switch:
                agent.memory.clean_memory()
                agent.memory_reset_switch = False
                agent.memory_reset_counter = False

        if done:
            summary.update(steps=itr, done=1, error=env.error,
                           reward=float(reward))
            break

        if len(agent.memory) > batch_size:
            if replay_ratio is None or itr % replay_ratio == 0:
                loss = agent.replay(batch_size)
                saver.append("train", episode, loss=loss)
                saver.validate("train", episode)

    summary["time"] = time.time() - t0
    summary["epsilon"] = agent.epsilon
    return summary


def agent_test(episode: int, env, agent, conf: dict, saver: Saver,
               output_path: str | None = None,
               threshold: float | None = None):
    """Greedy (epsilon = 0) evaluation rollout; returns (reward, steps,
    error), reward None when the rollout did not finish.

    With ``output_path`` the agent is saved as the best model of its
    threshold whenever this rollout beats every earlier test episode at
    the same done_threshold (``TensorRL_fixed_noiseless.py:94-98``; the
    reference's comparison includes the current episode, so its save never
    fires: this one excludes it, as the JAX package does)."""
    saver.new_episode("test", episode)
    state = modify_state(env.reset(), env, conf)
    eps = agent.epsilon
    agent.epsilon = 0.0
    try:
        for t in range(env.num_layers + 1):
            illegal = env.illegal_action_new()
            action, _ = agent.act(state, illegal)
            saver.append("test", episode, actions=action)
            next_state, reward, done = env.step(agent.translate[action],
                                                train_flag=False)
            state = modify_state(next_state, env, conf)
            saver.append("test", episode, errors=env.error,
                         errors_noiseless=env.error_noiseless,
                         opt_ang=env.opt_ang_save, nfev=env.nfev,
                         time=0.0)
            if done:
                saver.set("test", episode, done_threshold=env.done_threshold,
                          bond_distance=env.current_bond_distance)
                saver.validate("test", episode)
                if output_path is not None:
                    prev_best = [rec["errors"][-1]
                                 for ep, rec in saver.stats["test"].items()
                                 if ep != episode and rec["errors"]
                                 and rec["done_threshold"]
                                 == env.done_threshold]
                    if not prev_best or min(prev_best) > env.error:
                        thr = (threshold if threshold is not None
                               else conf["env"]["accept_err"])
                        save_checkpoint(
                            f"{output_path}/thresh_{thr}_{saver.seed}"
                            f"_best_geo_{env.current_bond_distance}", agent)
                return float(reward), t, env.error
    finally:
        agent.epsilon = eps
    return None, env.num_layers, env.error


def train(env, agent, conf: dict, seed: int, output_path: str,
          episodes: int | None = None, threshold: float | None = None,
          checkpoint_every: int = 5, test_every: int = 0,
          verbose: bool = True, stop_on_success: int = 0) -> Saver:
    """The training loop: ``episodes`` episodes (the config's by default),
    each logged to ``events_<seed>.jsonl``; a checkpoint every
    ``checkpoint_every`` episodes and at the end, a greedy test rollout
    every ``test_every`` (0: none); ``stop_on_success`` > 0 stops after
    that many episodes ended below the threshold.  Returns the Saver with
    the accumulated stats."""
    saver = Saver(output_path, seed)
    episodes = episodes if episodes is not None \
        else conf["general"]["episodes"]
    threshold = threshold if threshold is not None \
        else conf["env"]["accept_err"]
    ckpt_prefix = f"{output_path}/thresh_{threshold}_{seed}"
    successes = 0

    for e in range(episodes):
        summary = one_episode(e, env, agent, conf, saver)
        saver.save_jsonl_event({"episode": e, **summary})
        if verbose:
            err = summary["error"]
            print(f"episode: {e}/{episodes}, steps: {summary['steps']}, "
                  f"err: {'n/a' if err is None else f'{err:.3e}'}, "
                  f"e: {agent.epsilon:.2f}, "
                  f"rwd: {summary['reward']:.2f}, "
                  f"t: {summary['time']:.2f}s", flush=True)
        if summary["done"] and summary["error"] is not None \
                and summary["error"] < threshold:
            successes += 1
            if stop_on_success and successes >= stop_on_success:
                break
        if checkpoint_every and e % checkpoint_every == 0 and e > 0:
            saver.save()
            save_checkpoint(ckpt_prefix, agent, env)
        if test_every and e % test_every == 0 and e > 0:
            agent_test(e, env, agent, conf, saver,
                       output_path=output_path, threshold=threshold)

    saver.save()
    save_checkpoint(ckpt_prefix, agent, env)
    return saver
