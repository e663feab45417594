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


# -- the analysis, search and launch tools (tools/analyze_longrun.py,
# structure_search.py, train_multiseed.py) against the JAX package's
# scripts; twins of tests/test_analyze_longrun.py and
# tests/test_structure_search.py.  Counts and picks are equal; --f64's
# complex128 error within 1e-12 Ha of the script's (two eager complex128
# simulators, the same gates in the same order).

def _jax_analyze():
    """The JAX package's script as a module (it puts JAX on the CPU in
    x64 when imported, as its own test does)."""
    sys.path.insert(0, str(REPO / "scripts"))
    import analyze_longrun as script

    return script


def _ids(acts, n, keys):
    rev = {tuple(v): k for k, v in acts.items()}
    return [rev[k] for k in keys]


def test_analyze_circuit_stats_match_script():
    """Counts and depth of a replayed action list (the script test's two
    cases: a bare circuit, and one with an embedded warm-start tape)."""
    from tensorrl_qas_tpu.circuits.tape import GateKind as KindJax
    from tensorrl_qas_tpu.circuits.tape import GateTape as TapeJax
    from tensorrl_qas_tpu_torch.circuits.actions import all_to_all_actions
    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
    from tensorrl_qas_tpu_torch.tools import analyze_longrun as ours

    script = _jax_analyze()
    n = 4
    acts = all_to_all_actions(n)
    ids = _ids(acts, n, [(0, 1, n, 0), (n, 0, 2, 1), (2, 1, n, 0),
                         (n, 0, 2, 2)])
    out = ours.circuit_stats(ids, n, 10, acts)
    assert out == script.circuit_stats(ids, n, 10, acts)
    assert out == {"depth": 3, "cnots": 2, "rots": 2}
    n = 3
    acts = all_to_all_actions(n)
    tapes = []
    for kind, tape_cls in ((GateKind, GateTape), (KindJax, TapeJax)):
        tn = tape_cls(n, 4, 4)
        tn.add_cx(0, 1)
        tn.add(kind.RY, target=2, angle=0.3)
        tapes.append(tn)
    ids = _ids(acts, n, [(n, 0, 0, 1)])
    out = ours.circuit_stats(ids, n, 10, acts, tn_tape=tapes[0])
    assert out == script.circuit_stats(ids, n, 10, acts, tn_tape=tapes[1])
    assert out["cnots"] == 1 and out["rots"] == 2


def test_analyze_summary_matches_script(tmp_path):
    """``analyze`` picks the same best (episode, step) and scores its
    circuit as the script does, on the script test's summary."""
    from tensorrl_qas_tpu_torch.circuits.actions import all_to_all_actions
    from tensorrl_qas_tpu_torch.tools import analyze_longrun as ours

    script = _jax_analyze()
    n = 4
    acts = all_to_all_actions(n)
    summary = {"train": {
        0: {"errors": [0.5, 0.2], "reward": [0.0, 0.1],
            "actions": _ids(acts, n, [(0, 1, n, 0), (n, 0, 2, 1)])},
        1: {"errors": [0.4, 1e-4], "reward": [0.0, 5.0],
            "actions": _ids(acts, n, [(1, 1, n, 0), (n, 0, 0, 3)])},
    }, "test": {}}
    p = tmp_path / "summary_7.npy"
    np.save(p, summary, allow_pickle=True)
    conf = {"env": {"num_qubits": n, "num_layers": 10, "accept_err": 1.6e-3,
                    "tn_init": 0},
            "problem": {"ham_type": "x"}}
    out = ours.analyze(p, conf, tn_placement="fixed")
    assert out == script.analyze(p, conf, tn_placement="fixed")
    assert (out["episodes"], out["successes"]) == (2, 1)
    assert out["best"]["episode"] == 1 and out["best"]["error"] == 1e-4
    assert out["best"]["cnots"] == 1 and out["best"]["rots"] == 1
    assert out["best_done"]["episode"] == 1


def test_analyze_f64_matches_script(tmp_path):
    """``--f64`` on a recorded 5q Heisenberg step (TensorRL-fixed, the warm
    start in psi0): an RY, a CNOT, then an RZ, with the pre-action
    circuit's optimized RY angle stored; the complex128 error through the
    main function, from the results directory as the CLI writes it,
    against the script's ``f64_error`` within 1e-12 Ha."""
    from tensorrl_qas_tpu_torch.circuits.actions import all_to_all_actions
    from tensorrl_qas_tpu_torch.tools import analyze_longrun as ours
    from tensorrl_qas_tpu_torch.train.config import get_config

    script = _jax_analyze()
    n = 5
    acts = all_to_all_actions(n)
    ids = _ids(acts, n, [(n, 0, 1, 2), (1, 2, n, 0), (n, 0, 3, 3)])
    rec = {"errors": [0.3, 0.2, 0.1], "reward": [0.0, 0.1, 0.1],
           "actions": ids, "opt_ang": [[], [0.0], [0.4321]]}
    results = tmp_path / "TensorRL_fixed" / "heisenberg_5q_TNbond2"
    results.mkdir(parents=True)
    np.save(results / "summary_3.npy", {"train": {0: rec}, "test": {}},
            allow_pickle=True)
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    num_layers = conf["env"]["num_layers"]
    theirs = script.f64_error(ids, [0.4321], conf, "fixed", num_layers,
                              acts)
    mine = ours.f64_error(ids, [0.4321], conf, "fixed", num_layers, acts,
                          device="cpu")
    assert abs(mine - theirs) < 1e-12
    assert mine > 0.0                        # above the ground state
    out = json.loads(_run(["-m", "tensorrl_qas_tpu_torch.tools."
                           "analyze_longrun", str(results), "--seed", "3",
                           "--f64", "--device", "cpu"]))
    assert abs(out["best"]["error_f64"] - theirs) < 1e-12
    assert out["family"] == "TensorRL_fixed/"
    assert out["config"] == "heisenberg_5q_TNbond2.cfg"


def test_structure_search_smoke(tmp_path):
    """The search on the CPU (5q, pop 8, 4 generations, 20 iterations, 2
    starts) within the output's own rules, as the script's slow-gated
    test checks them."""
    from tensorrl_qas_tpu_torch.tools import structure_search

    out_path = tmp_path / "ss.json"
    res = structure_search.main([
        "--device", "cpu", "--config", "heisenberg_5q_TNbond2", "--pop", "8",
        "--gens", "4", "--max_gates", "10", "--global_iters", "20",
        "--n_starts", "2", "--polish_iters", "20", "--out", str(out_path)])
    assert json.loads(out_path.read_text()) == json.loads(json.dumps(res))
    assert res["best_err"] >= -1e-6
    assert res["gens"] == 4
    assert len(res["gates"]) <= 10
    assert res["depth"] >= 1
    assert res["polished_err"] <= res["best_err"] + 1e-9


def test_train_multiseed_two_seeds(tmp_path):
    """Two seeds of a tiny CPU run of the port's CLI, the flags passed
    through; each writes its summary."""
    out = _run(["-m", "tensorrl_qas_tpu_torch.tools.train_multiseed",
                "--seeds", "0", "1", "--max_parallel", "2", "--device",
                "cpu", "--config", "heisenberg_5q_TNbond2", "--vector", "2",
                "--total_steps", "4", "--global_iters", "2", "--n_starts",
                "2", "--batch_size", "4", "--results_path",
                str(tmp_path) + "/"])
    assert "all seeds completed" in out
    run_dir = tmp_path / "TensorRL_fixed" / "heisenberg_5q_TNbond2"
    assert sorted(p.name for p in run_dir.glob("summary_*.npy")) == [
        "summary_0.npy", "summary_1.npy"]


# -- the complex128 polish tools (tools/polish_best.py, polish_champion.py)
# against the JAX package's scripts on the CPU, one start (start 0 is the
# exact warm start: no random draw in either package) and 30 iterations:
# the polished errors within 1e-9 Ha (two float64 Adam runs, sums in
# another order).

POLISH = ["--iters", "30", "--n_starts", "1"]


def _summary_dir(tmp_path):
    """A hand-written 5q Heisenberg summary (TensorRL-fixed, as
    ``test_analyze_f64_matches_script`` builds one) with four episodes,
    two of which share their best step's action prefix."""
    from tensorrl_qas_tpu_torch.circuits.actions import all_to_all_actions

    n = 5
    acts = all_to_all_actions(n)
    a = _ids(acts, n, [(n, 0, 1, 2), (1, 2, n, 0), (n, 0, 3, 3)])
    b = _ids(acts, n, [(n, 0, 0, 1), (0, 1, n, 0), (n, 0, 2, 2),
                       (n, 0, 4, 3)])
    train = {
        0: {"errors": [0.3, 0.2, 0.1], "reward": [0.0, 0.1, 0.1],
            "actions": a, "opt_ang": [[], [0.0], [0.4321]]},
        1: {"errors": [0.3, 0.25, 0.15, 0.2], "reward": [0.0] * 4,
            "actions": b, "opt_ang": [[], [0.1], [0.2], [0.2, -0.3]]},
        2: {"errors": [0.5, 0.12], "reward": [0.0, 0.1], "actions": a[:2],
            "opt_ang": [[], [0.05]]},
        3: {"errors": [0.4, 0.3, 0.11], "reward": [0.0, 0.1, 0.0],
            "actions": a, "opt_ang": [[], [0.07], [0.3]]},
    }
    results = tmp_path / "TensorRL_fixed" / "heisenberg_5q_TNbond2"
    results.mkdir(parents=True)
    np.save(results / "summary_1.npy", {"train": train, "test": {}},
            allow_pickle=True)
    return results


def test_polish_best_matches_script(tmp_path, capsys):
    """``--topk 2``: the same two steps of distinct action prefixes are
    picked (episode 3's best step repeats episode 0's prefix and is
    passed over for episode 2's), with the
    script's keys, and each polished error within 1e-9 Ha of the
    script's."""
    from tensorrl_qas_tpu_torch.tools import polish_best

    results = _summary_dir(tmp_path)
    flags = [str(results), *POLISH, "--restarts", "2", "--topk", "2"]
    theirs = [json.loads(line) for line in _run(
        ["scripts/polish_best.py", *flags],
        JAX_PLATFORMS="cpu").strip().splitlines()]
    ours = polish_best.main([*flags, "--device", "cpu"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == ours
    assert [(r["episode"], r["step"]) for r in ours] == [
        (r["episode"], r["step"]) for r in theirs] == [(0, 2), (2, 1)]
    for mine, script in zip(ours, theirs):
        assert set(mine) == set(script)
        err = mine.pop("polished_f64_error")
        assert abs(err - script.pop("polished_f64_error")) < 1e-9
        assert mine == script
        assert err > 0.0


def test_polish_best_candidates_best_done():
    """``--which best_done`` takes an episode's last step when its last
    reward is >= 5, as the script does."""
    from tensorrl_qas_tpu_torch.tools.polish_best import candidates

    train = {0: {"errors": [0.3, 0.2], "reward": [0.0, 5.0],
                 "actions": [1, 2], "opt_ang": [[], [0.5]]},
             1: {"errors": [0.1, 0.4], "reward": [0.0, 0.0],
                 "actions": [3, 4], "opt_ang": [[], [0.6]]},
             2: {"errors": [], "reward": [], "actions": []}}
    (done,) = candidates(train, "best_done", 3)
    assert (done["episode"], done["step"], done["angles"]) == (0, 1, [0.5])
    best = candidates(train, "best", 3)
    assert [(c["episode"], c["step"]) for c in best] == [(1, 0), (0, 1)]


def test_polish_champion_matches_script(tmp_path, capsys):
    """A hand-written 5q Heisenberg champion (rotations and CNOTs after the
    warm start) polished for two seeds: ``f64_polished_err`` within 1e-9
    Ha of the script's, the other keys equal."""
    from tensorrl_qas_tpu_torch.tools import polish_champion

    art = tmp_path / "champion.json"
    art.write_text(json.dumps({
        "config": "heisenberg_5q_TNbond2", "polished_err": 1.5e-3,
        "gates": [[2, 0, -1], [4, 1, 0], [3, 1, -1], [1, 2, -1],
                  [4, 3, 2], [2, 4, -1], [2, 3, -1], [3, 0, -1]]}))
    flags = [str(art), *POLISH, "--seeds", "2"]
    theirs = json.loads(_run(["scripts/polish_champion.py", *flags],
                             JAX_PLATFORMS="cpu").strip().splitlines()[-1])
    ours = polish_champion.main([*flags, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines[:-1]] == ["seed 0",
                                                          "seed 1"]
    assert json.loads(lines[-1]) == ours
    err = ours.pop("f64_polished_err")
    assert abs(err - theirs.pop("f64_polished_err")) < 1e-9
    assert ours == theirs
    assert err > 0.0
