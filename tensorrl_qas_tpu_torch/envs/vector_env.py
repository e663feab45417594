"""Vectorized environment: B replicas, one device call per step.

B independent episodes advance together; their per-step device work
(multi-start angle optimization + post-action energy) is one launch of
the fused kernel for the whole batch (with a psi0 per replica in
block-coordinate trainable mode); on a mesh (``EnvConfig.mesh_shape``)
the sharded optimizer runs the replicas one after another, each on the
whole mesh.  Episode bookkeeping stays per-replica host logic, and
replicas auto-reset on done, so the wrapper hands the agent a
fixed-width stream of transitions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tensorrl_qas_tpu_torch import real_of
from tensorrl_qas_tpu_torch.envs.circuit_env import (
    CircuitEnv,
    EnvConfig,
    bc_prefix_states,
    make_optimizer,
)


class VectorCircuitEnv:
    """B synchronized CircuitEnv replicas sharing one batched device call."""

    def __init__(self, cfg: EnvConfig, n_envs: int):
        if cfg.optim_alg != "adam" or cfg.optim_method != "scipy_each_step":
            raise ValueError("VectorCircuitEnv requires the fused adam path")
        if (cfg.mesh_shape and cfg.block_coord_k > 1
                and cfg.tn_placement == "in_state"):
            # each replica's frozen steps start from its own prefix state,
            # and the sharded optimizer takes one psi0 for all (the JAX
            # package's broadcasts the (B, D) batch over the starts)
            raise ValueError(
                "block_coord_k > 1 on a mesh runs in CircuitEnv only: the "
                "sharded optimizer takes one psi0 shared by the replicas")
        self.n_envs = n_envs
        first = CircuitEnv(cfg)
        # all replicas share one optimizer (same shapes and problem); its
        # start generator is seeded per vector env
        self.optimizer = make_optimizer(cfg, first.problem.pauli,
                                        cfg.device, cfg.seed ^ 0xBEEF)
        first.optimizer = self.optimizer
        self.envs = [first] + [
            CircuitEnv(dataclasses.replace(cfg, seed=cfg.seed + i),
                       optimizer=self.optimizer)
            for i in range(1, n_envs)]
        # one batched call takes one precision: the shared optimizer's
        dtypes = {e.dtype for e in self.envs}
        if len(dtypes) != 1 or real_of(first.dtype) != self.optimizer.rdtype:
            raise ValueError(
                "VectorCircuitEnv: the replicas and their optimizer must "
                f"share one dtype, got {sorted(map(str, dtypes))} and "
                f"{self.optimizer.rdtype}")

    @property
    def action_size(self) -> int:
        return self.envs[0].action_size

    @property
    def state_size(self) -> int:
        return self.envs[0].state_size

    @property
    def num_layers(self) -> int:
        return self.envs[0].num_layers

    def reset_all(self) -> np.ndarray:
        # the replicas start from one state: its energy is taken once
        energies = {}
        return np.stack([e.reset(energies) for e in self.envs])

    def illegal_actions(self) -> list[list[int]]:
        return [e.illegal_action_new() for e in self.envs]

    def step_all(self, actions, train_flag: bool = True,
                 auto_reset: bool = True):
        """Advance every replica by one action.

        Returns (obs (B, S), rewards (B,), dones (B,), infos list).  Done
        replicas are reset (their obs row is the post-reset observation)
        when ``auto_reset``.
        """
        payloads = [env.step_begin(a) for env, a in zip(self.envs, actions)]
        old_arrs_b = tuple(np.stack([p[0][k] for p in payloads])
                           for k in range(4))
        x0_b = np.stack([p[1] for p in payloads])
        n_active_b = np.asarray([p[2] for p in payloads])
        new_arrs_b = tuple(np.stack([p[3][k] for p in payloads])
                           for k in range(4))
        map_idx_b = np.stack([p[4] for p in payloads])
        if self.envs[0]._bc_active():
            # block-coordinate trainable mode: each replica brings this
            # step's own psi0 (the cached prefix state on frozen steps,
            # |0...0> on joint ones), (B, D)
            bc_prefix_states(self.envs)
            psi0 = torch.stack([env.step_psi0() for env in self.envs])
        else:
            psi0 = self.envs[0].psi0
        x_opt_b, e_new_b, nfev = self.optimizer.fused_step_batch(
            psi0, old_arrs_b, x0_b, n_active_b, new_arrs_b, map_idx_b)

        obs, rewards, dones, infos = [], [], [], []
        for env, x_opt, e in zip(self.envs, x_opt_b, e_new_b):
            o, r, d = env.step_finish(x_opt, float(e), nfev, train_flag)
            info = {"error": env.error, "energy": env.energy,
                    "nfev": env.nfev, "steps": env.step_counter}
            if d and auto_reset:
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            infos.append(info)
        return np.stack(obs), np.asarray(rewards), np.asarray(dones), infos
