"""Generate molecular problem .npz files from scratch (stage 0).

The port's twin of the JAX package's ``scripts/generate_molecules.py``, an
owned replacement for the reference's ``dmrg-to-qc/making_molecules.py``
(pennylane qchem): STO-3G / 6-31G integrals -> RHF -> active space ->
Jordan-Wigner, all in the port's ``problems/qchem.py`` (numpy and scipy on
the host; no external qchem package). Emits the interchange .npz schema
under data/mol_data.

Presets reproduce the reference's published problems bit-for-bit where the
upstream file survives (H2O 8q / BEH2 6q / CH2 8q verified to <2e-7 per
coefficient, tests/test_qchem.py) and regenerate the ones stripped from
the upstream distribution (H2O 10q/12q, CH2 10q, LIH 12q); the JAX
package's tests/test_qchem.py holds them, and tests/test_torch_qchem.py
holds this copy to it.

Two upstream quirks are reproduced deliberately:
- coordinates are interpreted in BOHR (pennylane's unit) even though the
  values are Angstrom-shaped — see qchem.py module docstring;
- CH2's geometry *string* carries 3-decimal rounded coordinates while the
  Hamiltonian is computed from the exact 102-degree bond angle
  (making_molecules.py:44-66).

For n_qubits >= 10 the dense matrix is omitted from the .npz (16 MB at
10q, 268 MB at 12q); full eigvals are stored so min/max-eig reward
normalization works unchanged. Pass --with-dense to force it.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.generate_molecules --preset H2O_8q
  python -m tensorrl_qas_tpu_torch.tools.generate_molecules --preset all \
      --out /tmp/mol_data
  python -m tensorrl_qas_tpu_torch.tools.generate_molecules \
      --geometry "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; ..." \
      --active_electrons 4 --active_orbitals 4 --basis sto-3g
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from tensorrl_qas_tpu_torch.problems.qchem import (
    molecular_hamiltonian,
    parse_geometry,
)
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.utils.bits import bit_reversal_permutation

_CH2_ANGLE = np.deg2rad(102)
_CH2_COORDS = np.array([
    [0.0, 0.0, 0.0],
    [1.08, 0.0, 0.0],
    [1.08 * np.cos(_CH2_ANGLE), 1.08 * np.sin(_CH2_ANGLE), 0.0]])

# name -> (ham_type, symbols, exact coords, geometry string, active_e,
#          active_o, basis)
PRESETS = {
    "BEH2_6q": ("BEH2", ["H", "Be", "H"],
                np.array([[0., 0., -1.33], [0., 0., 0.], [0., 0., 1.33]]),
                "H 0.000 0.000 -1.330; Be 0.000 0.000 0.000; "
                "H 0.000 0.000 1.330", 4, 3, "sto-3g"),
    "H2O_8q": ("H2O", ["H", "O", "H"],
               np.array([[-0.021, -0.002, 0.], [0.835, 0.452, 0.],
                         [1.477, -0.273, 0.]]),
               "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; "
               "H 1.477 -0.273 0.000", 4, 4, "sto-3g"),
    "H2O_10q": ("H2O", ["H", "O", "H"],
                np.array([[-0.021, -0.002, 0.], [0.835, 0.452, 0.],
                          [1.477, -0.273, 0.]]),
                "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; "
                "H 1.477 -0.273 0.000", 4, 5, "6-31g"),
    "H2O_12q": ("H2O", ["H", "O", "H"],
                np.array([[-0.021, -0.002, 0.], [0.835, 0.452, 0.],
                          [1.477, -0.273, 0.]]),
                "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; "
                "H 1.477 -0.273 0.000", 4, 6, "6-31g"),
    "CH2_8q": ("CH2", ["C", "H", "H"], _CH2_COORDS,
               "C 0.000 0.000 0.000; H 1.080 0.000 0.000; "
               "H -0.225 1.056 0.000", 6, 4, "sto-3g"),
    # active_electrons=4 (not the 6 in the surviving making_molecules.py —
    # that script was edited between runs): the upstream TNbond{2,3,5}
    # warm-start circuits all land 8 mHa above the (4e,5o) ground state but
    # 1.85 Ha above the (6e,5o) one, so the shipped data is (4e,5o).
    "CH2_10q": ("CH2", ["C", "H", "H"], _CH2_COORDS,
                "C 0.000 0.000 0.000; H 1.080 0.000 0.000; "
                "H -0.225 1.056 0.000", 4, 5, "sto-3g"),
    "LIH_12q": ("LIH", ["Li", "H"],
                np.array([[0., 0., 0.], [0., 0., 3.4]]),
                "Li 0.000 0.000 0.000; H 0.000 0.000 3.400", 4, 6, "sto-3g"),
}


def emit(name, out_dir, with_dense=None):
    ham_type, symbols, coords, geom_str, ae, ao, basis = PRESETS[name]
    n_q = 2 * ao
    mh = molecular_hamiltonian(symbols, coords, active_electrons=ae,
                               active_orbitals=ao, basis=basis)
    assert mh.n_qubits == n_q, (mh.n_qubits, n_q)
    ps = PauliSum.from_strings(mh.paulis, mh.weights, n_q)
    dense_le = ps.to_dense()
    eigvals = np.linalg.eigvalsh(dense_le)
    out = {
        "eigvals": eigvals,
        "weights": np.asarray(mh.weights, dtype=np.float64),
        "paulis": np.asarray(mh.paulis),
        "energy_shift": 0,
    }
    if with_dense if with_dense is not None else n_q < 10:
        perm = bit_reversal_permutation(n_q)
        out["hamiltonian"] = dense_le[np.ix_(perm, perm)]
    fname = (f"{ham_type}_{n_q}q_geom_"
             f"{geom_str.replace(' ', '_')}_jordan_wigner.npz")
    path = out_dir / fname
    np.savez(path, **out)
    print(f"wrote {path.name}: {len(mh.paulis)} terms, "
          f"E_HF={mh.e_hf:.8f}, ground={eigvals[0]:.8f}")
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", type=str, default=None,
                   help=f"one of {list(PRESETS)} or 'all'")
    p.add_argument("--symbols", type=str, default=None,
                   help="comma-separated, for custom molecules")
    p.add_argument("--geometry", type=str, default=None)
    p.add_argument("--ham_type", type=str, default=None)
    p.add_argument("--active_electrons", type=int, default=None)
    p.add_argument("--active_orbitals", type=int, default=None)
    p.add_argument("--basis", type=str, default="sto-3g")
    p.add_argument("--units", type=str, default="bohr",
                   choices=["bohr", "angstrom"])
    p.add_argument("--with-dense", action="store_true", default=None)
    p.add_argument("--out", type=str,
                   default=str(pathlib.Path(__file__).resolve().parents[2]
                               / "data" / "mol_data"))
    args = p.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.preset == "all":
        for name in PRESETS:
            emit(name, out_dir, args.with_dense)
        return 0
    if args.preset:
        emit(args.preset, out_dir, args.with_dense)
        return 0
    if not (args.geometry and args.active_orbitals):
        raise SystemExit("pass --preset or --geometry/--active_orbitals")
    symbols, coords = parse_geometry(args.geometry)
    ham_type = args.ham_type or "".join(symbols)
    name = f"_custom_{ham_type}"
    PRESETS[name] = (ham_type, symbols, coords, args.geometry,
                     args.active_electrons, args.active_orbitals, args.basis)
    emit(name, out_dir, args.with_dense)
    return 0


if __name__ == "__main__":
    sys.exit(main())
