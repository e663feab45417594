"""Command-line entry point of the PyTorch port (vectorized trainer).

Same invocation shape as the JAX package's CLI and the reference
(``python3 <script>.py --seed N --config NAME --experiment_name DIR/``,
``TensorRL_fixed_noiseless.py:185-192``), e.g.

    python -m tensorrl_qas_tpu_torch.train.cli --config H2O8q_TNbond2 \
        --experiment_name TensorRL_fixed/ --vector 128 --total_steps 2560

Runs on the CUDA card unless ``--device cpu``.  The port covers the
vectorized trainer in the three config families: TensorRL-fixed (the warm
start compiled into psi0), TensorRL-trainable and StructureRL (the warm
start embedded in the RL state, its angles re-optimized with the agent's;
``--experiment_name TensorRL_trainable/`` or ``StructureRL/``, or
``--tn_placement in_state``), with block-coordinate optimization of the
embedded block (``--block_coord K``); noiseless, with depolarizing noise
(``--config H2O8q_TNbond2_noise``, or ``--noise depolarizing``) or with
shot noise on the hexagon topology (the ``_restricted`` configs, inferred
from the name; ``--noise shot``); with the CNOT or the su4 gate set
(``--gate_set su4``: RXX/RYY/RZZ actions, noiseless).  The sequential
driver, COBYLA and most override flags of the JAX CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

from tensorrl_qas_tpu_torch.agents.dqn import make_agent
from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.train.config import get_config
from tensorrl_qas_tpu_torch.train.vector_driver import train_vectorized


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
        description="PyTorch/CUDA TensorRL-QAS vectorized training driver")
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
    p.add_argument("--gate_set", choices=["cnot", "su4"], default=None,
                   help="action gate set: CNOT+rotations (default) or the "
                        "SU(4) Pauli-rotation set RXX/RYY/RZZ+rotations")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the simulation and the agent")
    p.add_argument("--episodes", type=int, default=None,
                   help="override [general] episodes")
    p.add_argument("--results_path", type=str, default="results/")
    p.add_argument("--vector", type=int, default=0,
                   help="number of env replicas of the vectorized trainer "
                        "(required: the sequential driver is not ported)")
    p.add_argument("--total_steps", type=int, default=0,
                   help="env-step budget (default: episodes x num_layers)")
    p.add_argument("--replays_per_iter", type=int, default=1,
                   help="replay train steps per vectorized iteration")
    p.add_argument("--eps_per_step", type=int, default=1,
                   help="rescale epsilon_decay so epsilon follows the "
                        "reference's per-env-step schedule (DeepQ.py:134-137)")
    p.add_argument("--global_iters", type=int, default=0,
                   help="override [non_local_opt] global_iters (0 = config)")
    p.add_argument("--n_starts", type=int, default=0,
                   help="override the multi-start count (0 = default 8)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override [agent] batch_size (0 = config)")
    p.add_argument("--block_coord", type=int, default=0,
                   help="trainable (in_state) mode: re-optimize the "
                        "embedded warm-start block only every K-th step; "
                        "the steps between carry only the agent's gates on "
                        "a cached prefix statevector (0 = joint "
                        "optimization every step, the reference's)")
    return p


def run(argv=None) -> dict:
    """Parse ``argv``, build the vectorized env and agent, train; returns
    the trainer's summary."""
    args = build_parser().parse_args(argv)
    if args.vector <= 0:
        raise SystemExit("only the vectorized trainer is ported: pass "
                         "--vector N")
    conf = get_config(args.experiment_name, f"{args.config}.cfg")
    tn_placement, noise_mode, topology = infer_modes(args.experiment_name,
                                                     args.config)
    if args.tn_placement:
        tn_placement = args.tn_placement
    if args.noise:
        noise_mode = args.noise
    conf["env"]["topology"] = topology
    if args.gate_set:
        conf["env"]["gate_set"] = args.gate_set
    np.random.seed(args.seed)

    overrides = [
        (args.global_iters, "non_local_opt", "global_iters"),
        (args.n_starts, "env", "n_starts"),
        (args.batch_size, "agent", "batch_size"),
        (args.block_coord, "env", "block_coord_k"),
    ]
    for value, section, key in overrides:
        if value:
            conf[section][key] = value
    env_cfg = EnvConfig.from_conf(conf, tn_placement=tn_placement,
                                  noise_mode=noise_mode, seed=args.seed,
                                  device=args.device)

    venv = VectorCircuitEnv(env_cfg, n_envs=args.vector)
    agent = make_agent(conf, venv.action_size, venv.state_size,
                       seed=args.seed, device=args.device)
    output_path = f"{args.results_path}{args.experiment_name}{args.config}"
    pathlib.Path(output_path).mkdir(parents=True, exist_ok=True)
    episodes = args.episodes or conf["general"]["episodes"]
    total = args.total_steps or episodes * env_cfg.num_layers
    summary = train_vectorized(venv, agent, conf, args.seed, output_path,
                               total_env_steps=total,
                               replays_per_iter=args.replays_per_iter,
                               eps_per_step=bool(args.eps_per_step))
    return summary


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
