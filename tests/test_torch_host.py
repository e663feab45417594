"""Host layer of the PyTorch port against the JAX package, on the main
path's configuration (configs/TensorRL_fixed/H2O8q_TNbond2.cfg): the
config dict, the warm-start tape, the action dictionary, the Pauli arrays
and min_eig must be identical (exact equality: numpy-only code)."""

import numpy as np
import pytest

from tensorrl_qas_tpu.circuits import actions as actions_jax
from tensorrl_qas_tpu.circuits.qasm import load_circuit_tape as tape_jax
from tensorrl_qas_tpu.problems import hamiltonians as ham_jax
from tensorrl_qas_tpu.train.config import get_config as config_jax
from tensorrl_qas_tpu_torch.circuits import actions as actions_torch
from tensorrl_qas_tpu_torch.circuits.qasm import (
    load_circuit_tape as tape_torch,
)
from tensorrl_qas_tpu_torch.problems import hamiltonians as ham_torch
from tensorrl_qas_tpu_torch.train.config import get_config as config_torch

CFG = ("TensorRL_fixed/", "H2O8q_TNbond2.cfg")


def _problem_args(conf):
    p = conf["problem"]
    return (p["ham_type"], conf["env"]["num_qubits"], p["geometry"],
            p["mapping"])


def test_config_dict_identical():
    assert config_torch(*CFG) == config_jax(*CFG)


def test_warmstart_tape_identical():
    conf = config_jax(*CFG)
    ham, n, geom, mapping = _problem_args(conf)
    bond = conf["env"]["tn_bond"]
    path_j = ham_jax.resolve_warmstart_qasm(ham, n, bond, geom, mapping)
    path_t = ham_torch.resolve_warmstart_qasm(ham, n, bond, geom, mapping)
    assert path_t == path_j
    tj, tt = tape_jax(path_j), tape_torch(path_t)
    for a, b in zip(tj.arrays(), tt.arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tj.x0(), tt.x0())
    assert tj.depth() == tt.depth()


@pytest.mark.parametrize("topology", ["all_to_all", "hexagon"])
def test_action_dictionary_identical(topology):
    n = config_jax(*CFG)["env"]["num_qubits"]
    assert (actions_torch.action_dictionary(n, topology)
            == actions_jax.action_dictionary(n, topology))


def test_pauli_arrays_and_spectrum_identical():
    conf = config_jax(*CFG)
    pj = ham_jax.load_problem(*_problem_args(conf))
    pt = ham_torch.load_problem(*_problem_args(conf))
    for name in ("weights", "flip", "sign_mask", "iphase"):
        np.testing.assert_array_equal(getattr(pt.pauli, name),
                                      getattr(pj.pauli, name))
    assert pt.min_eig == pj.min_eig
    assert pt.max_eig == pj.max_eig
    np.testing.assert_array_equal(pt.pauli.to_dense(), pj.pauli.to_dense())
