"""The port's data tools (``tensorrl_qas_tpu_torch/tools``): the warm-start
generator on the CPU into a temporary data tree, the port's trainer run
from that tree, and both tools against their twins in the JAX package's
``scripts/``.

Tolerances: the .npz files the twins write are equal (the same host
numpy code: term strings, weights, eigenvalues and the dense matrix to
1e-12); the warm-start .qasm files hold the same gates on the same
qubits, and their states overlap to 1 - 1e-12 (KAK's angles are fixed only
up to branches, which the last bits of the fitted bricks may pick
differently); the trainer's
warm-start gap equals |e_circuit - E_min| of the generated files to 1e-9.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tensorrl_qas_tpu_torch.circuits.qasm import parse_qasm
from tensorrl_qas_tpu_torch.tools import generate_data, generate_molecules

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(args, **env):
    proc = subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _same_npz(a, b):
    ra, rb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(ra.files) == sorted(rb.files)
    for key in ra.files:
        x, y = ra[key], rb[key]
        if x.dtype.kind in "fc":
            np.testing.assert_allclose(x, y, atol=1e-12, rtol=0)
        else:
            assert (x == y).all(), key


def _state(n, gates):
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import tape_from_gate_list
    from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state

    tape = tape_from_gate_list(n, gates)
    return apply_tape(zero_state(n), *tape.arrays(),
                      torch.as_tensor(tape.x0())).numpy()


def test_generate_data_then_train_from_it(tmp_path):
    """The tool writes the 5q Heisenberg npz and warm start (200 fit
    iterations, so the circuit is not the shipped one) into tmp_path on
    the CPU; the CLI then trains 2 vector steps from them in a process
    with TRLQAS_DATA_DIR set: its warm-start gap is the generated
    circuit's, not the shipped one's."""
    data = tmp_path / "data"
    out = generate_data.run(["--ham", "heisenberg", "--qubits", "5",
                             "--maxiter", "200", "--out", str(data),
                             "--device", "cpu", "--pickle"])
    res = out["result"]
    assert out["npz"] == data / "mol_data/heisenberg_5q.npz"
    assert out["qasm"] == (data / "init_state_circ/"
                           "init_heisenberg_5q_TNbond2.qasm")
    assert out["pickle"].exists() and res.cnot_count == 12
    gap = res.e_circuit - res.e_exact
    shipped = (REPO / "data/init_state_circ/"
               "init_heisenberg_5q_TNbond2.qasm").read_text()
    assert res.qasm != shipped

    results = tmp_path / "results"
    stdout = _run(["-m", "tensorrl_qas_tpu_torch.train.cli", "--device",
                   "cpu", "--config", "heisenberg_5q_TNbond2", "--vector",
                   "2", "--total_steps", "4", "--global_iters", "3",
                   "--n_starts", "2", "--batch_size", "4",
                   "--results_path", str(results) + "/"],
                  TRLQAS_DATA_DIR=str(data))
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert summary["steps"] == 4
    assert summary["warm_start_gap"] == pytest.approx(gap, abs=1e-9)


def test_generate_data_matches_jax_script(tmp_path):
    """``tools/generate_data.py`` and the JAX package's
    ``scripts/generate_data.py`` with the same flags (5q Heisenberg, the
    .p twin too) write equal npz and pickle files and the same warm-start
    gates."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    flags = ["--ham", "heisenberg", "--qubits", "5", "--pickle"]
    generate_data.run([*flags, "--out", str(ours), "--device", "cpu"])
    _run(["scripts/generate_data.py", *flags, "--out", str(theirs)],
         JAX_PLATFORMS="cpu")
    _same_npz(ours / "mol_data/heisenberg_5q.npz",
              theirs / "mol_data/heisenberg_5q.npz")
    import pickle

    with open(ours / "mol_data/heisenberg_5q.p", "rb") as f:
        p_ours = pickle.load(f)
    with open(theirs / "mol_data/heisenberg_5q.p", "rb") as f:
        p_theirs = pickle.load(f)
    assert p_ours.keys() == p_theirs.keys()
    assert p_ours["paulis"] == p_theirs["paulis"]
    np.testing.assert_allclose(p_ours["hamiltonian"], p_theirs["hamiltonian"],
                               atol=1e-12, rtol=0)
    rel = "init_state_circ/init_heisenberg_5q_TNbond2.qasm"
    n_o, g_o = parse_qasm((ours / rel).read_text())
    n_t, g_t = parse_qasm((theirs / rel).read_text())
    assert n_o == n_t == 5
    assert [g[:2] for g in g_o] == [g[:2] for g in g_t]
    # KAK's angles are fixed only up to branches (np.angle near +-pi, a
    # ZYZ pair shifted by pi): the circuits are compared by their states
    states = [_state(n_o, g) for g in (g_o, g_t)]
    assert abs(np.vdot(*states)) == pytest.approx(1.0, abs=1e-12)


def test_generate_data_above_13_qubits_stores_dmrg_extremes(tmp_path):
    """Above 13 qubits the npz holds DMRG's chi-8 extremal pair
    (``eigvals_method = dmrg_chi8``), equal to the shipped 14q file's to
    1e-10 (the shipped file is the JAX package's script's output); the fit
    is cut to 5 iterations here."""
    out = generate_data.run(["--ham", "heisenberg", "--qubits", "14",
                             "--maxiter", "5", "--out", str(tmp_path),
                             "--device", "cpu"])
    raw = np.load(out["npz"], allow_pickle=True)
    shipped = np.load(REPO / "data/mol_data/heisenberg_14q.npz",
                      allow_pickle=True)
    assert str(raw["eigvals_method"]) == "dmrg_chi8"
    assert "hamiltonian" not in raw.files
    np.testing.assert_allclose(raw["eigvals"], shipped["eigvals"],
                               atol=1e-10, rtol=0)
    assert out["result"].e_exact is None
    assert out["result"].cnot_count == 3 * 13


def test_generate_molecules_matches_jax_script(tmp_path):
    """``tools/generate_molecules.py --preset H2O_8q`` and the JAX
    package's script write equal npz files, whose term set is the shipped
    (upstream) file's."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert generate_molecules.main(["--preset", "H2O_8q", "--out",
                                    str(ours)]) == 0
    _run(["scripts/generate_molecules.py", "--preset", "H2O_8q", "--out",
          str(theirs)], JAX_PLATFORMS="cpu")
    (name,) = [p.name for p in ours.iterdir()]
    _same_npz(ours / name, theirs / name)
    shipped = np.load(REPO / "data/mol_data" / name, allow_pickle=True)
    raw = np.load(ours / name, allow_pickle=True)
    assert set(raw["paulis"]) == set(shipped["paulis"])
