"""The 20-qubit training demonstration (``tools/demo_20q_training.py``) on
the CPU, against the JAX package's ``scripts/demo_20q_training.py``: one
episode of the DQN loop on a (2, 2) CPU mesh (the sharded optimizer) and
on one device (``--mesh none``: the fused v2 engine's plain version), one
Adam iteration of one start a step.

The warm start's 22 layers count against ``--num_layers`` in both
packages (``num_layers_termination``), so 24 layers give an episode of
two steps.  The record has the script's keys (``scripts/
demo_20q_training.py:104-140``); the warm-start energy (complex64, as the
script configures it) is within 1e-5 Ha of the JAX ``CircuitEnv``'s
``prev_energy`` at reset (20q fixed, CPU, no mesh) and the lower bound
equals its ``min_eig``; the two runs take the same actions (the agent is
seeded) and their per-step energies agree within 1e-4 Ha (float32 sums in
another order, and the mesh's second start: one start per dp column)."""

import json

import pytest
import torch

from tensorrl_qas_tpu_torch.tools import demo_20q_training

RECORD_KEYS = {"n_qubits", "mesh", "global_iters", "n_starts",
               "min_eig_bound", "episodes", "best_energy",
               "best_error_vs_dmrg_bound"}
EPISODE_KEYS = {"steps", "wall_s", "energies", "best", "warmstart"}
LAYERS = 24          # the warm start's depth 22 + 2 steps


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_reset():
    from tensorrl_qas_tpu.envs.circuit_env import CircuitEnv, EnvConfig

    cfg = EnvConfig(
        num_qubits=20, num_layers=LAYERS, ham_type="heisenberg",
        tn_placement="fixed", tn_init=1, tn_bond=2, accept_err=1e-3,
        curriculum_conf={"thresholds": [1e-3], "switch_episodes": [100000],
                         "accept_err": 1e-3},
        optim_alg="adam", global_iters=1, n_starts=1, sim_dtype="complex64",
        seed=0)
    env = CircuitEnv(cfg)
    env.reset()
    return float(env.prev_energy), float(env.min_eig)


def test_demo_on_a_cpu_mesh_and_one_device(tmp_path, one_thread, capsys):
    records = {}
    for mesh in ("2,2", "none"):
        out = tmp_path / f"demo_{mesh}.json"
        records[mesh] = demo_20q_training.main([
            "--device", "cpu", "--mesh", mesh, "--episodes", "1",
            "--num_layers", str(LAYERS), "--global_iters", "1",
            "--n_starts", "1", "--out", str(out)])
        assert json.loads(out.read_text()) == json.loads(
            json.dumps(records[mesh]))
    printed = capsys.readouterr().out
    assert "mesh layout (amp rows x dp columns): [['cpu', 'cpu'], " \
        "['cpu', 'cpu']]" in printed
    assert printed.count("ep 0 step ") == 4
    sharded, single = records["2,2"], records["none"]
    assert sharded["mesh"] == "{'amp': 2, 'dp': 2}"
    for rec in records.values():
        assert set(rec) == RECORD_KEYS
        (ep,) = rec["episodes"]
        assert set(ep) == EPISODE_KEYS
        assert ep["steps"] == 2 and len(ep["energies"]) == 3
        assert rec["best_energy"] == ep["best"] == min(ep["energies"])
        assert rec["best_error_vs_dmrg_bound"] == pytest.approx(
            rec["best_energy"] - rec["min_eig_bound"], abs=1e-12)
    warm_jax, min_eig_jax = _jax_reset()
    for rec in records.values():
        assert abs(rec["episodes"][0]["warmstart"] - warm_jax) < 1e-5
        assert rec["min_eig_bound"] == pytest.approx(min_eig_jax, abs=1e-9)
    for e_mesh, e_one in zip(sharded["episodes"][0]["energies"],
                             single["episodes"][0]["energies"]):
        assert abs(e_mesh - e_one) < 1e-4
