"""The port's main path end to end on the CPU, at a small size:
``train_vectorized`` on configs/TensorRL_fixed/heisenberg_5q_TNbond2.cfg
with 4 env replicas (narrow MLP, few Adam iterations, short episodes),
writing ``summary_<seed>.npy`` and ``events_<seed>.jsonl`` in the schema
of the JAX package's driver."""

import json

import numpy as np
import pytest

from tensorrl_qas_tpu.train.saver import _TRAIN_KEYS
from tensorrl_qas_tpu_torch.agents.dqn import make_agent
from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.train.config import get_config
from tensorrl_qas_tpu_torch.train.vector_driver import train_vectorized

EVENT_KEYS = {"iter", "steps", "episodes", "successes", "best_error",
              "best_step_error", "epsilon", "t"}


@pytest.mark.parametrize("vector_steps", [3, 6])
def test_train_vectorized_writes_reference_schema(tmp_path, vector_steps):
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    depth = load_circuit_tape(resolve_warmstart_qasm(
        "heisenberg", 5, conf["env"]["tn_bond"])).depth()
    conf["env"]["num_layers"] = depth + 2        # 2-step episodes
    conf["non_local_opt"]["global_iters"] = 4
    conf["agent"].update(neurons=[32, 32], memory_size=64, batch_size=4)
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", noise_mode="none",
                              seed=0, device="cpu")
    venv = VectorCircuitEnv(cfg, n_envs=4)
    agent = make_agent(conf, venv.action_size, venv.state_size, seed=0,
                       device="cpu")
    out = tmp_path / "run"
    summary = train_vectorized(venv, agent, conf, 0, str(out),
                               total_env_steps=4 * vector_steps,
                               loss_fetch_every=1, verbose=False)
    assert summary["steps"] == 4 * vector_steps
    assert summary["episodes"] == 4 * (vector_steps // 2)
    assert np.isfinite(summary["best_step_error"])
    stats = np.load(out / "summary_0.npy", allow_pickle=True).item()
    assert set(stats) == {"train", "test"}
    assert sorted(stats["train"]) == list(range(summary["episodes"]))
    for rec in stats["train"].values():
        assert set(rec) == set(_TRAIN_KEYS) | {"done_threshold",
                                               "bond_distance"}
        assert len(rec["actions"]) == len(rec["errors"]) == 2
        assert np.isfinite(rec["errors"]).all()
    events = [json.loads(line) for line in
              (out / "events_0.jsonl").read_text().splitlines()]
    assert len(events) == vector_steps
    assert all(EVENT_KEYS <= set(ev) for ev in events)
    assert events[-1]["steps"] == 4 * vector_steps
    # replay starts once the 5-step windows hold more than a batch: the
    # first 4 transitions fold at iteration 5, the buffer passes 4 at 6
    assert agent.step_counter == max(0, vector_steps - 5)
    assert (out / "vec_0_agent.pt").exists()
