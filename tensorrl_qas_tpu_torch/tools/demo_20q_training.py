"""20-qubit multi-step training demonstration, sharded or on one device.

The port's twin of the JAX package's ``scripts/demo_20q_training.py``,
with the same flags, per-step lines and record plus ``--device``.  It runs
real training episodes -- a DQN agent with masked epsilon-greedy actions,
replay learning, and per-step multi-start Adam re-optimization of all
angles (``global_iters`` x ``n_starts`` evaluations) -- at 20 qubits
(``heisenberg_5q_TNbond2.cfg`` of TensorRL_trainable raised to 20 qubits,
the warm start in psi0, complex64).  Neither CLI takes a mesh, so this is
the entry point that trains a DQN on the sharded path.

``--mesh amp,dp`` (default 2,4) runs the optimizer on an (amp, dp) mesh
(``EnvConfig.mesh_shape``, ``optim/sharded_opt.py``).  The JAX script fakes
eight devices on the host CPU when it lacks them; here the mesh's shards
are laid over the cards the host has, in turn (on one card all eight on
``cuda:0``), or over the CPU with ``--device cpu``; the layout is
printed.  ``--mesh none`` runs one device: on the card the fused v2
engine's sweep kernel (``csrc/fused_adam_v2_sweep.cu``, every start's
state in device memory), one launch an env step.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.demo_20q_training \
      [--episodes 2] [--global_iters 20] [--n_starts 4] [--mesh 2,4|none] \
      [--device cpu] [--out results_longrun_r3/demo20q.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.agents.dqn import make_agent
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.train.config import get_config
from tensorrl_qas_tpu_torch.train.driver import modify_state


def mesh_devices(mesh_shape, device) -> tuple:
    """The devices of an (amp, dp) mesh's shards in row-major order: the
    host's cards in turn (all on ``cuda:0`` with one card), or the CPU for
    every shard."""
    need = mesh_shape[0] * mesh_shape[1]
    dev = as_device(device)
    if dev.type != "cuda":
        return (dev,) * need
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("--mesh on the card: no CUDA device (use "
                           "--device cpu for a CPU mesh)")
    return tuple(torch.device("cuda", i % count) for i in range(need))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="demo_20q_training")
    p.add_argument("--episodes", type=int, default=2)
    p.add_argument("--num_layers", type=int, default=30)
    p.add_argument("--global_iters", type=int, default=20)
    p.add_argument("--n_starts", type=int, default=4)
    p.add_argument("--tn_placement", choices=["fixed", "in_state"],
                   default="fixed",
                   help="fixed = warm start compiled to a statevector "
                        "once, per-step tape is the RL gates only (the "
                        "reference's 20q mode); in_state re-optimizes "
                        "the ~250 embedded warm-start angles every step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default="2,4",
                   help="'amp,dp' sharded mesh (default 2,4) or 'none' "
                        "for one device (on the card the fused v2 engine's "
                        "sweep kernel)")
    p.add_argument("--device", default="cuda",
                   help="where the env and agent run (cuda: the card, the "
                        "mesh's shards over the host's cards; cpu: the "
                        "host, a CPU mesh)")
    p.add_argument("--out", default="results_longrun_r3/demo20q.json")
    args = p.parse_args(argv)

    conf = get_config("TensorRL_trainable/", "heisenberg_5q_TNbond2.cfg")
    conf["env"].update(num_qubits=20, num_layers=args.num_layers)
    conf["agent"]["batch_size"] = 32   # tiny replay for the demo budget

    mesh_shape = (None if args.mesh == "none" else
                  tuple(int(v) for v in args.mesh.split(",")))
    cfg = EnvConfig(
        num_qubits=20, num_layers=args.num_layers, ham_type="heisenberg",
        tn_placement=args.tn_placement, tn_init=1, tn_bond=2,
        accept_err=1e-3,
        curriculum_conf={"thresholds": [1e-3], "switch_episodes": [100000],
                         "accept_err": 1e-3},
        optim_alg="adam", global_iters=args.global_iters,
        n_starts=args.n_starts, sim_dtype="complex64",
        device=str(as_device(args.device)), mesh_shape=mesh_shape,
        mesh_devices=(None if mesh_shape is None
                      else mesh_devices(mesh_shape, args.device)),
        seed=args.seed)
    t0 = time.time()
    env = CircuitEnv(cfg)
    if mesh_shape is None:
        assert env.mesh is None
        mesh_desc = f"single-device ({cfg.device})"
    else:
        assert env.mesh is not None, "sharded path not active"
        mesh_desc = dict(env.mesh.shape)
        layout = [[str(d) for d in row] for row in env.mesh.devices]
        print(f"mesh layout (amp rows x dp columns): {layout}", flush=True)
    agent = make_agent(conf, env.action_size, env.state_size,
                       seed=args.seed, device=cfg.device)
    print(f"setup: {time.time()-t0:.1f}s; mesh: {mesh_desc}", flush=True)

    record = {"n_qubits": 20, "mesh": str(mesh_desc),
              "global_iters": args.global_iters, "n_starts": args.n_starts,
              "min_eig_bound": float(env.min_eig), "episodes": []}
    for ep in range(args.episodes):
        state = env.reset()
        state = modify_state(state, env, conf)
        traj = [float(env.prev_energy)]
        t_ep = time.time()
        steps = 0
        for itr in range(env.num_layers_termination + 1):
            ill = env.illegal_action_new()
            a, _ = agent.act(state, ill)
            t_s = time.time()
            next_state, reward, done = env.step(agent.translate[int(a)])
            dt_s = time.time() - t_s
            next_state = modify_state(next_state, env, conf)
            agent.remember(state, int(a), float(reward), next_state,
                           float(done))
            if len(agent.memory) > conf["agent"]["batch_size"]:
                agent.replay(conf["agent"]["batch_size"], fetch_loss=False)
            state = next_state
            traj.append(float(env.energy))
            steps += 1
            print(f"ep {ep} step {itr}: E={env.energy:.6f} "
                  f"err={env.error:.4f} reward={reward:.2f} "
                  f"nfev={env.nfev} {dt_s:.1f}s", flush=True)
            if done:
                break
        record["episodes"].append({
            "steps": steps, "wall_s": time.time() - t_ep,
            "energies": traj, "best": float(min(traj)),
            "warmstart": traj[0]})

    best = min(e["best"] for e in record["episodes"])
    record["best_energy"] = best
    record["best_error_vs_dmrg_bound"] = best - float(env.min_eig)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({k: v for k, v in record.items()
                      if k != "episodes"}), flush=True)
    print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
