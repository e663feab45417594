"""Command-line entry point of the PyTorch port.

Same invocation shape as the JAX package's CLI and the reference
(``python3 <script>.py --seed N --config NAME --experiment_name DIR/``,
``TensorRL_fixed_noiseless.py:185-192``), e.g.

    python -m tensorrl_qas_tpu_torch.train.cli --config H2O8q_TNbond2 \
        --experiment_name TensorRL_fixed/ --episodes 2
    python -m tensorrl_qas_tpu_torch.train.cli --config H2O8q_TNbond2 \
        --experiment_name TensorRL_fixed/ --vector 128 --total_steps 2560

Runs on the CUDA card unless ``--device cpu`` (``--gpu_id N``: card N).
Without ``--vector`` it runs the reference's sequential episodes
(``train/driver.py``): one env, one step at a time, with a greedy test
rollout every ``--test_every`` episodes; with ``--vector N`` the
vectorized trainer (``train/vector_driver.py``): N replicas, one device
call a step, optionally seeded with a demonstration (``--demo``).  The
per-step angle optimizer is multi-start Adam, or with ``--optim cobyla``
(sequential only, as in the JAX package) the reference's COBYLA: csim on
the host, noiseless, or the tape kernel under noise.  All three config
families run: TensorRL-fixed (the warm start compiled into psi0),
TensorRL-trainable and StructureRL (the warm start embedded in the RL
state, its angles re-optimized with the agent's; ``--experiment_name
TensorRL_trainable/`` or ``StructureRL/``, or ``--tn_placement
in_state``), with block-coordinate optimization of the embedded block
(``--block_coord K``); noiseless, with depolarizing noise (``--config
H2O8q_TNbond2_noise``, or ``--noise depolarizing``) or with shot noise on
the hexagon topology (the ``_restricted`` configs, inferred from the name;
``--noise shot``); with the CNOT or the su4 gate set (``--gate_set su4``:
RXX/RYY/RZZ actions, noiseless).  A config with ``init_net`` resumes from
``<results_path>finalize/<config>/`` (``train/checkpoint.py:init_net``).
``--sim_dtype`` sets the statevector precision as in the JAX package
('auto': complex64 on the card, complex128 on the CPU); ``--sim_dtype
complex128`` on the card runs every Adam mode through the composed engine
on the double-precision tape kernels.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

from tensorrl_qas_tpu_torch.agents.dqn import make_agent
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.train.checkpoint import init_net, init_net_prefix
from tensorrl_qas_tpu_torch.train.config import get_config
from tensorrl_qas_tpu_torch.train.driver import train
from tensorrl_qas_tpu_torch.train.vector_driver import (
    collect_demo_transitions,
    train_vectorized,
)


def infer_modes(experiment_name: str, config_name: str):
    """Map the reference's entry-script choice onto (tn_placement,
    noise_mode, topology), as the JAX package's CLI does."""
    exp = experiment_name.lower()
    cfgn = config_name.lower()
    tn_placement = "fixed" if "fixed" in exp else "in_state"
    if "restricted" in cfgn or "restricted" in exp:
        return tn_placement, "shot", "hexagon"
    if "noise" in cfgn or "noise" in exp:
        return tn_placement, "depolarizing", "all_to_all"
    return tn_placement, "none", "all_to_all"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="trlqas-torch",
        description="PyTorch/CUDA TensorRL-QAS training driver")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", type=str, default="heisenberg_5q_TNbond2",
                   help="config file name without .cfg")
    p.add_argument("--experiment_name", type=str, default="TensorRL_fixed/",
                   help="config family directory (with trailing slash)")
    p.add_argument("--tn_placement", choices=["fixed", "in_state"],
                   default=None,
                   help="override the warm-start placement inferred from "
                        "the experiment name")
    p.add_argument("--noise", choices=["none", "depolarizing", "shot"],
                   default=None,
                   help="override the noise mode inferred from the names")
    p.add_argument("--topology",
                   choices=["all_to_all", "hexagon", "hexagon_full"],
                   default=None,
                   help="override the action topology inferred from the "
                        "names")
    p.add_argument("--gate_set", choices=["cnot", "su4"], default=None,
                   help="action gate set: CNOT+rotations (default) or the "
                        "SU(4) Pauli-rotation set RXX/RYY/RZZ+rotations")
    p.add_argument("--optim", choices=["adam", "cobyla"], default=None,
                   help="per-step angle optimizer (default: multi-start "
                        "Adam; cobyla: the reference's, sequential only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the simulation and the agent")
    p.add_argument("--gpu_id", type=int, default=None,
                   help="the card to run on (cuda:N); with --device cuda")
    p.add_argument("--episodes", type=int, default=None,
                   help="override [general] episodes")
    p.add_argument("--results_path", type=str, default="results/")
    p.add_argument("--test_every", type=int, default=0,
                   help="sequential mode: greedy test rollout every N "
                        "episodes (0 = none)")
    p.add_argument("--stop_on_success", type=int, default=0,
                   help="sequential mode: stop after N successful episodes "
                        "(0 = run all)")
    p.add_argument("--sim_dtype", type=str, default="auto",
                   choices=["auto", "complex64", "complex128"],
                   help="statevector precision ('auto': complex64 on the "
                        "card, complex128 on the CPU)")
    p.add_argument("--vector", type=int, default=0,
                   help="number of env replicas of the vectorized trainer "
                        "(0 = the reference's sequential episodes)")
    p.add_argument("--total_steps", type=int, default=0,
                   help="env-step budget of the vectorized trainer "
                        "(default: episodes x num_layers)")
    p.add_argument("--replays_per_iter", type=int, default=1,
                   help="replay train steps per vectorized iteration")
    p.add_argument("--eps_per_step", type=int, default=1,
                   help="rescale epsilon_decay so epsilon follows the "
                        "reference's per-env-step schedule (DeepQ.py:134-137)")
    p.add_argument("--global_iters", type=int, default=0,
                   help="override [non_local_opt] global_iters (0 = config)")
    p.add_argument("--n_starts", type=int, default=0,
                   help="override the multi-start count (0 = default 8)")
    p.add_argument("--stop_at_error", type=float, default=0.0,
                   help="vectorized mode: stop once best_error is at or "
                        "below this and --stop_min_successes episodes "
                        "succeeded (0 = run the whole budget)")
    p.add_argument("--stop_min_successes", type=int, default=0)
    p.add_argument("--demo", type=str, default="",
                   help="vectorized mode: JSON file with a demonstration "
                        "gate list ([kind, target, control] each, or "
                        "{'gates': [...]}) to seed the replay buffer with")
    p.add_argument("--demo_copies", type=int, default=20)
    p.add_argument("--num_layers", type=int, default=0,
                   help="override [env] num_layers, the episode's gate "
                        "budget (0 = config)")
    p.add_argument("--eps_decay", type=float, default=0.0,
                   help="override [agent] epsilon_decay (0 = config)")
    p.add_argument("--eps_min", type=float, default=-1.0,
                   help="override [agent] epsilon_min (< 0 = config)")
    p.add_argument("--init_eps", type=float, default=-1.0,
                   help="override [agent] init_epsilon, the exploration "
                        "rate at step 0 (< 0 = config / 1.0)")
    p.add_argument("--accept_err", type=float, default=0.0,
                   help="override [env] accept_err and the curriculum "
                        "thresholds with one value (0 = config)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override [agent] batch_size (0 = config)")
    p.add_argument("--block_coord", type=int, default=0,
                   help="trainable (in_state) mode: re-optimize the "
                        "embedded warm-start block only every K-th step; "
                        "the steps between carry only the agent's gates on "
                        "a cached prefix statevector (0 = joint "
                        "optimization every step, the reference's)")
    return p


def sequential_summary(saver, wall_s: float, threshold: float) -> dict:
    """The sequential run's summary from its Saver: train episodes,
    successes (episodes that ended below ``threshold``), best final error,
    env steps of the train and test episodes, COBYLA's or Adam's
    evaluations (nfev), wall time and env steps a second."""
    train_eps = saver.stats["train"].values()
    test_eps = saver.stats["test"].values()
    finals = [rec["errors"][-1] for rec in train_eps if rec["errors"]]
    steps = sum(len(rec["errors"]) for rec in train_eps)
    test_steps = sum(len(rec["errors"]) for rec in test_eps)
    return {"episodes": len(finals),
            "successes": sum(err < threshold for err in finals),
            "best_error": float(min(finals, default=np.inf)),
            "steps": steps, "test_steps": test_steps,
            "nfev": int(sum(sum(rec["nfev"]) for rec in train_eps)),
            "test_episodes": len(saver.stats["test"]),
            "steps_per_sec": (steps + test_steps) / wall_s,
            "wall_s": wall_s}


def configure(args) -> tuple[dict, EnvConfig]:
    """The config of parsed ``args`` with their overrides applied, and the
    env's ``EnvConfig`` (modes inferred from the names unless the flags
    set them; ``--gpu_id N`` puts ``--device cuda`` on card N)."""
    conf = get_config(args.experiment_name, f"{args.config}.cfg")
    tn_placement, noise_mode, topology = infer_modes(args.experiment_name,
                                                     args.config)
    tn_placement = args.tn_placement or tn_placement
    noise_mode = args.noise or noise_mode
    conf["env"]["topology"] = args.topology or topology
    if args.gate_set:
        conf["env"]["gate_set"] = args.gate_set
    overrides = [
        (args.global_iters, "non_local_opt", "global_iters"),
        (args.n_starts, "env", "n_starts"),
        (args.num_layers, "env", "num_layers"),
        (args.eps_decay, "agent", "epsilon_decay"),
        (args.batch_size, "agent", "batch_size"),
        (args.block_coord, "env", "block_coord_k"),
    ]
    for value, section, key in overrides:
        if value:
            conf[section][key] = value
    if args.eps_min >= 0.0:
        conf["agent"]["epsilon_min"] = args.eps_min
    if args.init_eps >= 0.0:
        conf["agent"]["init_epsilon"] = args.init_eps
    if args.accept_err:
        conf["env"]["accept_err"] = args.accept_err
        conf["env"]["thresholds"] = [args.accept_err]
    device = args.device
    if args.gpu_id is not None and device == "cuda":
        device = f"cuda:{args.gpu_id}"
    env_cfg = EnvConfig.from_conf(conf, tn_placement=tn_placement,
                                  noise_mode=noise_mode, seed=args.seed,
                                  optim_alg=args.optim, device=device)
    env_cfg.sim_dtype = args.sim_dtype
    return conf, env_cfg


def run(argv=None) -> dict:
    """Parse ``argv``, build the env and agent, train; returns the
    trainer's summary (``sequential_summary`` without ``--vector``)."""
    args = build_parser().parse_args(argv)
    conf, env_cfg = configure(args)
    device = env_cfg.device
    np.random.seed(args.seed)
    output_path = f"{args.results_path}{args.experiment_name}{args.config}"
    pathlib.Path(output_path).mkdir(parents=True, exist_ok=True)

    if args.vector:
        venv = VectorCircuitEnv(env_cfg, n_envs=args.vector)
        agent = make_agent(conf, venv.action_size, venv.state_size,
                           seed=args.seed, device=device)
        demo = None
        if args.demo:
            with open(args.demo) as f:
                spec = json.load(f)
            gates = spec["gates"] if isinstance(spec, dict) else spec
            demo, demo_err = collect_demo_transitions(env_cfg, conf, gates)
            print(f"demo episode: {len(demo)} transitions, final error "
                  f"{demo_err:.3e}", flush=True)
        episodes = args.episodes or conf["general"]["episodes"]
        total = args.total_steps or episodes * env_cfg.num_layers
        return train_vectorized(venv, agent, conf, args.seed, output_path,
                                total_env_steps=total,
                                replays_per_iter=args.replays_per_iter,
                                eps_per_step=bool(args.eps_per_step),
                                stop_at_error=args.stop_at_error,
                                stop_min_successes=args.stop_min_successes,
                                demo_transitions=demo,
                                demo_copies=args.demo_copies)

    env = CircuitEnv(env_cfg)
    agent = make_agent(conf, env.action_size, env.state_size,
                       seed=args.seed, device=device)
    if conf["agent"].get("init_net"):
        init_net(init_net_prefix(args.results_path, args.config, conf,
                                 args.seed), conf, agent, env)
    print(json.dumps({
        "config": args.config, "experiment": args.experiment_name,
        "seed": args.seed, "tn_placement": env_cfg.tn_placement,
        "noise_mode": env_cfg.noise_mode, "topology": env_cfg.topology,
        "optim": env_cfg.optim_alg, "n_qubits": env_cfg.num_qubits,
        "num_layers": env_cfg.num_layers, "device": device,
        "action_size": env.action_size, "state_size": env.state_size,
    }), flush=True)
    t0 = time.perf_counter()
    saver = train(env, agent, conf, args.seed, output_path,
                  episodes=args.episodes, test_every=args.test_every,
                  stop_on_success=args.stop_on_success)
    return sequential_summary(saver, time.perf_counter() - t0,
                              conf["env"]["accept_err"])


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
