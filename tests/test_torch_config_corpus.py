"""The config corpus under ``configs/`` in the port, twins of
``tests/test_config_corpus.py::test_config_loads_and_makes_env_config``
and ``::test_data_backed_config_builds_env``, held to the JAX package on
the same files.

Every ``.cfg`` loads to the JAX loader's dict, infers the same modes, and
makes an ``EnvConfig`` whose fields equal the JAX ``EnvConfig``'s (the
port's ``device`` and ``mesh_devices`` and the JAX package's TPU switches
aside).  One config per family and distinct problem of at most 8 qubits
whose data ships in ``data/`` builds the port's ``CircuitEnv`` on the
CPU: its reset observation has the JAX env's shape and values, and,
without noise, its warm-start energy is the JAX env's within 1e-9 Ha
(both complex128).
``CH210q_TNbond2_elec4.cfg`` is left out: it asks for a Hamiltonian file
that ``data/`` lacks and a geometry that neither package parses
(ROADMAP.md, C)."""

import dataclasses
import pathlib

import numpy as np
import pytest

from tensorrl_qas_tpu.envs.circuit_env import CircuitEnv as EnvJax
from tensorrl_qas_tpu.envs.circuit_env import EnvConfig as ConfigJax
from tensorrl_qas_tpu.train.cli import infer_modes as infer_modes_jax
from tensorrl_qas_tpu.train.config import load_config_file as load_jax
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    problem_npz_name,
    resolve_data_file,
    warmstart_qasm_name,
)
from tensorrl_qas_tpu_torch.train.cli import infer_modes
from tensorrl_qas_tpu_torch.train.config import load_config_file

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
ALL_CFGS = sorted(p for p in CONFIGS.rglob("*.cfg")
                  if p.stem != "CH210q_TNbond2_elec4")
assert len(ALL_CFGS) >= 46
PORT_ONLY = {"device", "mesh_devices"}
JAX_ONLY = {"use_pallas", "err_mitig", "cnot_rwd_weight"}


def _configs(cfg_path):
    """(port EnvConfig, JAX EnvConfig, conf) of one file, as both CLIs
    build them (modes inferred from the family and file names)."""
    conf = load_config_file(str(cfg_path))
    family = cfg_path.parent.name + "/"
    modes = infer_modes(family, cfg_path.stem)
    assert modes == infer_modes_jax(family, cfg_path.stem)
    tn_placement, noise_mode, topology = modes
    conf["env"]["topology"] = topology
    conf_jax = load_jax(str(cfg_path))
    conf_jax["env"]["topology"] = topology
    assert conf == conf_jax
    kw = dict(tn_placement=tn_placement, noise_mode=noise_mode, seed=0)
    return (EnvConfig.from_conf(conf, device="cpu", **kw),
            ConfigJax.from_conf(conf_jax, **kw), conf)


@pytest.mark.parametrize(
    "cfg_path", ALL_CFGS, ids=[f"{p.parent.name}/{p.stem}" for p in ALL_CFGS])
def test_config_loads_and_makes_env_config(cfg_path):
    ours, theirs, conf = _configs(cfg_path)
    assert isinstance(conf["env"]["num_qubits"], int)
    assert isinstance(conf["agent"]["neurons"], list)
    assert conf["env"]["zero_param_init"] == int(
        cfg_path.parent.name == "StructureRL")
    mine = dataclasses.asdict(ours)
    other = dataclasses.asdict(theirs)
    assert set(mine) - set(other) == PORT_ONLY
    assert set(other) - set(mine) == JAX_ONLY
    for key in set(mine) & set(other):
        assert mine[key] == other[key], key
    assert ours.num_qubits == conf["env"]["num_qubits"]


def _data_present(conf) -> bool:
    try:
        resolve_data_file(problem_npz_name(
            conf["problem"]["ham_type"], conf["env"]["num_qubits"],
            conf["problem"]["geometry"], conf["problem"]["mapping"]))
        resolve_data_file(warmstart_qasm_name(
            conf["problem"]["ham_type"], conf["env"]["num_qubits"],
            conf["env"]["tn_bond"], conf["problem"]["geometry"],
            conf["problem"]["mapping"]))
        return True
    except FileNotFoundError:
        return False


def _distinct_data_backed_cfgs():
    """One config per family and distinct (ham, qubits, bond, mapping,
    geometry) of at most 8 qubits whose data ships in data/ (the JAX
    test's pick, in each family: the warm start in psi0, embedded, and
    embedded at angle 0)."""
    seen, out = set(), []
    for p in ALL_CFGS:
        conf = load_config_file(str(p))
        key = (p.parent.name, conf["problem"]["ham_type"],
               conf["env"]["num_qubits"],
               conf["env"]["tn_bond"], conf["problem"]["mapping"],
               conf["problem"]["geometry"])
        if key in seen or conf["env"]["num_qubits"] > 8:
            continue
        if _data_present(conf):
            seen.add(key)
            out.append(p)
    return out


ENV_CFGS = _distinct_data_backed_cfgs()


def test_data_backed_problem_count():
    assert len(ENV_CFGS) >= 18


@pytest.mark.parametrize(
    "cfg_path", ENV_CFGS,
    ids=[f"{p.parent.name}/{p.stem}" for p in ENV_CFGS])
def test_data_backed_config_builds_env(cfg_path):
    ours, theirs, conf = _configs(cfg_path)
    env = CircuitEnv(ours)
    state = env.reset()
    n, layers = ours.num_qubits, ours.num_layers
    expected = env.state_size - (0 if conf["agent"]["angles"]
                                 else layers * n * 3)
    assert state.shape == (expected,)
    env_jax = EnvJax(dataclasses.replace(theirs, sim_dtype="complex128"))
    state_jax = np.asarray(env_jax.reset())
    assert env.state_size == env_jax.state_size
    assert env.action_size == env_jax.action_size
    np.testing.assert_array_equal(state, state_jax)
    if ours.noise_mode == "none":
        assert abs(env.prev_energy - float(env_jax.prev_energy)) < 1e-9
