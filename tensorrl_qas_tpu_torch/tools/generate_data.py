"""Generate problem data + warm-start circuits into a data/ tree.

The port's twin of the JAX package's ``scripts/generate_data.py``: the
reference's offline stages 0 and 1 (``dmrg-to-qc/heisenberg_model.py``,
``dmrg-to-qc/dmrg_to_qc.py``) without their interactive prompts.  Emits
the same .npz schema and native-gate .qasm warm-start circuits under
<out>/mol_data and <out>/init_state_circ, with the same flags, plus
``--device`` (the card unless ``--device cpu``): DMRG, KAK and the exact
check run on the host, the circuit fit on the device in complex128.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.generate_data --ham heisenberg \\
      --qubits 5 --tn_bond 2
  python -m tensorrl_qas_tpu_torch.tools.generate_data --ham tfim_j1_h0.05 \\
      --qubits 6 --tn_bond 2 --device cpu
  python -m tensorrl_qas_tpu_torch.tools.generate_data --ham H2O --qubits 8 \\
      --tn_bond 2 --from-npz <existing .npz with paulis/weights>

Train from the result by putting <out> first on the data search path:
``TRLQAS_DATA_DIR=<out> python -m tensorrl_qas_tpu_torch.train.cli ...``
(the .npz of a molecule, which ``--from-npz`` does not rewrite, is still
found under the repository's data/).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import logging
import pathlib
import sys

import numpy as np

from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    heisenberg_hamiltonian,
    pauli_decompose,
    problem_npz_name,
    save_problem_npz,
    save_problem_pickle,
    tfim_hamiltonian,
    warmstart_qasm_name,
)
from tensorrl_qas_tpu_torch.utils.bits import bit_reversal_permutation


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tensorrl_qas_tpu_torch.tools.generate_data",
        description="problem .npz and warm-start .qasm (DMRG -> brickwork "
                    "fit -> KAK)")
    p.add_argument("--ham", type=str, default="heisenberg")
    p.add_argument("--qubits", type=int, default=5)
    p.add_argument("--tn_bond", type=int, default=2)
    p.add_argument("--layers", type=int, default=2,
                   help="brickwork layers for the warm-start circuit")
    p.add_argument("--maxiter", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--geometry", type=str, default="")
    p.add_argument("--mapping", type=str, default="jordan_wigner")
    p.add_argument("--from-npz", type=str, default=None,
                   help="use paulis/weights from an existing .npz")
    p.add_argument("--out", type=str, default="data")
    p.add_argument("--basis", choices=["cnot", "su4"], default="cnot",
                   help="warm-start gate basis: 3 CNOTs/brick vs "
                        "RXX/RYY/RZZ (the reference driver's SU4 flag)")
    p.add_argument("--pickle", action="store_true",
                   help="also emit the reference's .p pickle twin "
                        "(making_molecules.py:138-140 dumps both)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the circuit fit runs (default: the card)")
    return p


def problem_terms(args):
    """(paulis, weights, the --from-npz file or None) for the arguments."""
    if args.from_npz:
        raw = np.load(args.from_npz, allow_pickle=True)
        if "paulis" in raw.files:
            paulis = [str(x) for x in raw["paulis"]]
            weights = np.asarray(np.real(raw["weights"]), dtype=np.float64)
        else:
            # dense-only schema (e.g. LIH_4q parity file)
            dense = np.asarray(raw["hamiltonian"]).astype(np.complex128)
            perm = bit_reversal_permutation(args.qubits)
            paulis, weights = pauli_decompose(dense[np.ix_(perm, perm)])
        return paulis, weights, raw
    if args.ham == "heisenberg":
        return (*heisenberg_hamiltonian(args.qubits), None)
    if args.ham.startswith("tfim"):
        h = float(args.ham.split("_h")[-1]) if "_h" in args.ham else 0.05
        return (*tfim_hamiltonian(args.qubits, j=1.0, h=h), None)
    raise SystemExit(
        f"unknown --ham {args.ham!r}; for molecules pass --from-npz "
        "(python -m tensorrl_qas_tpu_torch.tools.generate_molecules "
        "writes one)")


def dmrg_extremes(paulis, weights, tn_bond: int, seed: int):
    """(E_min, E_max, chi) by DMRG, for sizes where dense diagonalization
    is infeasible.

    chi caps the local two-site problem: chi_e = clip(4*tn_bond, 8, 16),
    i.e. chi 8 for the shipped tn_bond=2 problems and at most 16 — the
    dense eigh per site stays seconds even at n ~ 24 (chi = 32 would mean
    4096-dim solves: hours).  E_min is a variational *upper bound* at that
    chi, still far tighter than the chi = 2 warm start it normalizes
    rewards against; the chi is recorded in the npz (eigvals_method)."""
    from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg
    from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis

    chi_e = min(max(tn_bond * 4, 8), 16)
    e_min = gs_dmrg(mpo_from_paulis(paulis, weights), chi=chi_e,
                    seed=seed)[0]
    e_max = -gs_dmrg(mpo_from_paulis(paulis, [-w for w in weights]),
                     chi=chi_e, seed=seed)[0]
    return e_min, e_max, chi_e


def write_problem(args, paulis, weights, raw, npz_path) -> dict:
    """The problem's npz (unless it came from ``--from-npz``) and, with
    ``--pickle``, its .p twin; -> {"npz", "pickle": the paths written}."""
    written = {"npz": None, "pickle": None}
    extremes = None
    if raw is None:
        if args.qubits > 13:   # n=14 dense eigvalsh is ~4e12 flops: hours
            # partial eigvals are schema-legal: min/max_eig is all the
            # loader consumes
            *extremes, chi_e = dmrg_extremes(paulis, weights, args.tn_bond,
                                             args.seed)
            save_problem_npz(str(npz_path), paulis, weights,
                             eigvals=extremes,
                             eigvals_method=f"dmrg_chi{chi_e}")
        else:
            save_problem_npz(str(npz_path), paulis, weights)
        written["npz"] = npz_path
        print(f"wrote {npz_path}")
    if args.pickle:
        p_path = pathlib.Path(str(npz_path)[:-len(".npz")] + ".p")
        kw = {}
        if raw is not None and "eigvals" in raw.files:
            kw["eigvals"] = np.real(np.asarray(raw["eigvals"]))
        elif extremes is not None:
            kw["eigvals"] = extremes  # DMRG extremal pair from above
        save_problem_pickle(str(p_path), paulis, weights, **kw)
        written["pickle"] = p_path
        print(f"wrote {p_path}")
    return written


def run(argv=None) -> dict:
    """Parse ``argv``, write the files; -> {"result": WarmStartResult,
    "npz", "pickle", "qasm": the paths written (None where not)}.

    The problem files (host numpy: above 13 qubits two DMRG runs at chi
    8) are written in a thread while the warm start is built, whose fit
    leaves the host mostly idle on a card."""
    from tensorrl_qas_tpu_torch.tn.pipeline import build_warmstart

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    out = pathlib.Path(args.out)
    (out / "mol_data").mkdir(parents=True, exist_ok=True)
    (out / "init_state_circ").mkdir(parents=True, exist_ok=True)

    paulis, weights, raw = problem_terms(args)
    npz_path = out / problem_npz_name(args.ham, args.qubits, args.geometry,
                                      args.mapping)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        problem = pool.submit(write_problem, args, paulis, weights, raw,
                              npz_path)
        res = build_warmstart(paulis, weights, chi=args.tn_bond,
                              n_layers=args.layers, maxiter=args.maxiter,
                              seed=args.seed, basis=args.basis,
                              device=args.device)
        written = problem.result()
    qasm_rel = warmstart_qasm_name(args.ham, args.qubits, args.tn_bond,
                                   args.geometry, args.mapping)
    if args.basis == "su4":
        qasm_rel = qasm_rel.replace(".qasm", "_su4.qasm")
    qasm_path = out / qasm_rel
    qasm_path.write_text(res.qasm)
    print(f"wrote {qasm_path}")
    print(f"E_dmrg={res.e_dmrg:.8f} E_circuit={res.e_circuit:.8f} "
          f"E_exact={res.e_exact} overlap={res.overlap:.6f} "
          f"cnots={res.cnot_count} rots={res.rotation_count} "
          f"depth={res.depth} fit_s={res.timings['fit_s']:.2f}")
    return {"result": res, "qasm": qasm_path, **written}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
