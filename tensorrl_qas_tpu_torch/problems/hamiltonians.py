"""Problem Hamiltonians and .npz interchange.

Reads and writes the reference's .npz schema verbatim (keys ``hamiltonian`` (dense,
big-endian/kron order), ``eigvals``, ``weights``, ``paulis``,
``energy_shift`` — ``dmrg-to-qc/heisenberg_model.py:91-111``,
``dmrg-to-qc/making_molecules.py:105-140``) and locates the warm-start
circuits.  Internally everything is little-endian Pauli-sum form (see
sim/expectation.py); the stored dense matrix is endianness-converted at
load time.  The spin-model generators and the writers are the port's own
copies of the JAX package's (``problems/hamiltonians.py``); the warm-start
tool (``tools/generate_data.py``) uses them.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np

from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.utils.bits import bit_reversal_permutation

# Where to look for problem data (.npz) and warm-start circuits (.qasm).
# First match wins; $TRLQAS_DATA_DIR takes priority so the same configs run
# against generated data or a repo-local data/ dir. A TensorRL-QAS checkout's
# dmrg-to-qc/ directory can be added explicitly via $TRLQAS_REFERENCE_DATA —
# nothing resolves outside the repo by default (the shipped data/ tree is
# self-contained; scripts/vendor_mol_data.py re-emits upstream data files).
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA_SEARCH_PATHS = [
    os.environ.get("TRLQAS_DATA_DIR", ""),
    str(_REPO_ROOT / "data"),
    os.environ.get("TRLQAS_REFERENCE_DATA", ""),
]


@dataclasses.dataclass
class Problem:
    """A loaded Hamiltonian problem instance."""

    name: str
    n_qubits: int
    pauli: PauliSum
    eigvals: np.ndarray
    energy_shift: float
    dense: np.ndarray | None = None  # little-endian, oracle only

    @property
    def min_eig(self) -> float:
        return float(np.min(self.eigvals))

    @property
    def max_eig(self) -> float:
        return float(np.max(self.eigvals))


def heisenberg_hamiltonian(n: int):
    """XXX Heisenberg chain + uniform Z field (reference
    ``dmrg-to-qc/heisenberg_model.py:7-74``): sum_i XX+YY+ZZ + sum_i Z_i.

    Returns (paulis, weights) in the reference string convention.
    """
    paulis, weights = [], []
    for i in range(n - 1):
        # reference strings index the chain left-to-right from char 0, which
        # we mirror here: site i of the chain = qubit n-1-i in little-endian.
        for ch in "XYZ":
            s = ["I"] * n
            s[i] = ch
            s[i + 1] = ch
            paulis.append("".join(s))
            weights.append(1.0)
    for i in range(n):
        s = ["I"] * n
        s[i] = "Z"
        paulis.append("".join(s))
        weights.append(1.0)
    return paulis, weights


def tfim_hamiltonian(n: int, j: float = 1.0, h: float = 0.05):
    """Transverse-field Ising chain: -J sum ZZ - h sum X (open chain)."""
    paulis, weights = [], []
    for i in range(n - 1):
        s = ["I"] * n
        s[i] = "Z"
        s[i + 1] = "Z"
        paulis.append("".join(s))
        weights.append(-j)
    for i in range(n):
        s = ["I"] * n
        s[i] = "X"
        paulis.append("".join(s))
        weights.append(-h)
    return paulis, weights


def dense_from_paulis(paulis, weights) -> np.ndarray:
    """Dense matrix in the reference's kron order (char 0 = MSB)."""
    n = len(paulis[0])
    ps = PauliSum.from_strings(paulis, weights, n_qubits=n)
    dense_le = ps.to_dense()
    perm = bit_reversal_permutation(n)
    return dense_le[np.ix_(perm, perm)]


def _schema_spectrum(out: dict, paulis, weights, with_dense: bool,
                     eigvals) -> None:
    """The ``eigvals`` (and ``hamiltonian``) keys of the schema: the given
    eigenvalues, or the dense spectrum (and matrix, in kron order)."""
    if eigvals is not None:
        out["eigvals"] = np.asarray(eigvals, dtype=np.float64)
        return
    n = len(paulis[0])
    dense_le = PauliSum.from_strings(paulis, weights, n_qubits=n).to_dense()
    out["eigvals"] = np.linalg.eigvalsh(dense_le)
    if with_dense:
        perm = bit_reversal_permutation(n)
        out["hamiltonian"] = dense_le[np.ix_(perm, perm)]


def save_problem_npz(path: str, paulis, weights, energy_shift: float = 0.0,
                     with_dense: bool = True, eigvals=None,
                     eigvals_method: str | None = None) -> None:
    """Emit the reference .npz schema for a Pauli-sum problem.

    ``eigvals``: pass precomputed (possibly partial) eigenvalues for sizes
    where dense diagonalization is infeasible (n >~ 14; DMRG extremal
    values suffice — min/max_eig are all the loader consumes, and the
    schema explicitly allows partial spectra, see load_problem).
    ``eigvals_method``: provenance of a partial spectrum (e.g. "dmrg_chi8")
    stored as an extra key so downstream error metrics against min_eig are
    interpretable; ignored by the reference schema consumers."""
    out = {
        "weights": np.asarray(weights, dtype=np.float64),
        "paulis": np.asarray(paulis),
        "energy_shift": energy_shift,
    }
    if eigvals_method is not None:
        out["eigvals_method"] = np.asarray(eigvals_method)
    _schema_spectrum(out, paulis, weights, with_dense, eigvals)
    np.savez(path, **out)


def save_problem_pickle(path: str, paulis, weights,
                        energy_shift: float = 0.0,
                        with_dense: bool = True, eigvals=None) -> None:
    """Emit the reference's ``.p`` pickle twin of the .npz schema.

    The reference's ``making_molecules.py:105-140`` dumps the SAME
    ``complete_dict`` both ways — ``pickle.dump`` to ``<stem>.p`` and
    ``np.savez`` to ``<stem>.npz`` — with keys ``hamiltonian`` (dense, in
    its kron order, char 0 = MSB), ``eigvals`` (real parts), ``weights``,
    ``paulis`` and ``energy_shift``.  Dense/eigvals follow the same
    feasibility rules as :func:`save_problem_npz`.
    """
    import pickle

    out = {
        "weights": [float(w) for w in np.asarray(weights, dtype=np.float64)],
        "paulis": [str(p) for p in paulis],
        "energy_shift": energy_shift,
    }
    _schema_spectrum(out, paulis, weights, with_dense, eigvals)
    with open(path, "wb") as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)


def pauli_decompose(dense_le: np.ndarray, tol: float = 1e-8):
    """Exact Pauli-basis decomposition of a little-endian Hermitian matrix.

    Returns (paulis, weights) with weight_P = Tr(P H)/2^n over the 4^n Pauli
    strings, dropping |w|<=tol. Used for .npz files that ship only the dense
    matrix (the reference's LIH_4q parity-mapped file has no 'paulis' key —
    its env consumes the dense 'hamiltonian' directly,
    ``environment_qulacs.py:106``; our simulator wants the Pauli-sum form).
    Brute force over 4^n strings — guarded to small n where that is exact
    and cheap.
    """
    dim = dense_le.shape[0]
    n = int(np.log2(dim))
    if n > 7:
        raise ValueError(f"pauli_decompose is O(16^n); n={n} too large")
    import itertools

    paulis, weights = [], []
    for chars in itertools.product("IXYZ", repeat=n):
        s = "".join(chars)
        p_dense = PauliSum.from_strings([s], [1.0], n_qubits=n).to_dense()
        w = np.einsum("ij,ji->", p_dense, dense_le) / dim  # Tr(P H)/2^n
        if abs(w) > tol:
            paulis.append(s)
            weights.append(float(np.real(w)))  # Hermitian H => real weights
    return paulis, np.asarray(weights, dtype=np.float64)


def resolve_data_file(relpath: str) -> str:
    """Locate a data file across the search paths."""
    for base in DATA_SEARCH_PATHS:
        if not base:
            continue
        cand = os.path.join(base, relpath)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"{relpath} not found under any of {DATA_SEARCH_PATHS}; set "
        "TRLQAS_DATA_DIR or run tools/generate_data.py"
    )


def problem_npz_name(ham_type: str, n_qubits: int, geometry: str = "",
                     mapping: str = "jordan_wigner") -> str:
    """Reference file-naming scheme (``environment_qulacs.py:100-104``)."""
    if ham_type in ("heisenberg",) or ham_type.startswith("tfim"):
        return f"mol_data/{ham_type}_{n_qubits}q.npz"
    geom = geometry.replace(" ", "_")
    return f"mol_data/{ham_type}_{n_qubits}q_geom_{geom}_{mapping}.npz"


class _PickleProblemDict:
    """NpzFile-shaped view over the reference's ``.p`` complete_dict."""

    def __init__(self, d: dict):
        self._d = d

    @property
    def files(self):
        return list(self._d.keys())

    def __getitem__(self, key):
        return np.asarray(self._d[key])


def load_problem(ham_type: str, n_qubits: int, geometry: str = "",
                 mapping: str = "jordan_wigner",
                 keep_dense: bool = True) -> Problem:
    """Load a problem from the .npz corpus (reference schema).

    Falls back to the reference's ``.p`` pickle twin when no ``.npz``
    exists (``making_molecules.py:138-140`` dumps both from the same
    dict, so a pickle-only artifact is drop-in loadable).
    """
    relpath = problem_npz_name(ham_type, n_qubits, geometry, mapping)
    try:
        path = resolve_data_file(relpath)
        raw = np.load(path, allow_pickle=True)
    except FileNotFoundError:
        import pickle

        path = resolve_data_file(relpath[:-len(".npz")] + ".p")
        with open(path, "rb") as fh:
            raw = _PickleProblemDict(pickle.load(fh))
    dense = None
    if keep_dense and "hamiltonian" in raw.files and n_qubits <= 12:
        perm = bit_reversal_permutation(n_qubits)
        dense = np.asarray(raw["hamiltonian"])[np.ix_(perm, perm)]
    if "paulis" in raw.files:
        paulis = [str(p) for p in raw["paulis"]]
        weights = np.asarray(raw["weights"], dtype=np.float64)
    else:
        # dense-only schema (reference LIH_4q parity file): recover the
        # Pauli-sum form exactly from the stored matrix.
        if dense is None:
            perm = bit_reversal_permutation(n_qubits)
            dense = np.asarray(raw["hamiltonian"])[np.ix_(perm, perm)]
        paulis, weights = pauli_decompose(dense.astype(np.complex128))
    ps = PauliSum.from_strings(paulis, weights, n_qubits=n_qubits)
    # Use the STORED eigvals: the reference defines min_eig/max_eig from them
    # (``environment_qulacs.py:106-112``), and for some files they are partial
    # sparse-solver output — recomputing could silently change the reward
    # normalization and break parity.
    eigvals = np.real(np.asarray(raw["eigvals"]).astype(np.complex128))
    shift = float(raw["energy_shift"]) if "energy_shift" in raw.files else 0.0
    return Problem(name=f"{ham_type}_{n_qubits}q", n_qubits=n_qubits,
                   pauli=ps, eigvals=eigvals, energy_shift=shift, dense=dense)


def warmstart_qasm_name(ham_type: str, n_qubits: int, tn_bond: int,
                        geometry: str = "",
                        mapping: str = "jordan_wigner") -> str:
    """Reference warm-start circuit naming (``environment_qulacs.py:75-82``)."""
    if ham_type in ("heisenberg",) or ham_type.startswith("tfim"):
        return f"init_state_circ/init_{ham_type}_{n_qubits}q_TNbond{tn_bond}.qasm"
    geom = geometry.replace(" ", "_")
    return (f"init_state_circ/init_{ham_type}_{n_qubits}q_geom_{geom}_"
            f"{mapping}_TNbond{tn_bond}.qasm")


def resolve_warmstart_qasm(ham_type: str, n_qubits: int, tn_bond: int,
                           geometry: str = "",
                           mapping: str = "jordan_wigner", *,
                           gate_set: str = "cnot",
                           tn_placement: str = "fixed") -> str:
    """Locate the warm-start qasm, including the su4-basis resolution rule.

    ``gate_set='su4'`` prefers the RXX/RYY/RZZ-basis warm start
    (``init_*_su4.qasm``, reference dmrg_to_qc.py's SU4 flag).
    ``tn_placement='in_state'`` NEEDS it (a CNOT tape cannot embed into
    an SU4StateTensor), so a missing su4 qasm raises there; ``'fixed'``
    placement only compiles the warm start to a statevector, which is
    basis-independent, so the CNOT qasm is an acceptable fallback.

    A missing ``.qasm`` falls back to its ``.qpy`` twin at every lookup
    (the reference ingests qpy, ``environment_qulacs.py:75-82``; load the
    result with ``circuits.qasm.load_circuit_tape``, which dispatches on
    the extension).

    The single resolver for CircuitEnv, analyze_longrun and polish_best
    — the rule must not drift between training and analysis."""
    rel = warmstart_qasm_name(ham_type, n_qubits, tn_bond, geometry,
                              mapping)
    if gate_set != "su4":
        return _resolve_qasm_or_qpy(rel)
    su4_rel = rel.replace(".qasm", "_su4.qasm")
    try:
        return _resolve_qasm_or_qpy(su4_rel)
    except FileNotFoundError:
        if tn_placement == "in_state":
            raise FileNotFoundError(
                f"gate_set='su4' with tn_placement='in_state' requires "
                f"an su4-basis warm start ({su4_rel}); generate one with "
                f"tools/generate_data.py --basis su4")
        return _resolve_qasm_or_qpy(rel)


def _resolve_qasm_or_qpy(rel: str) -> str:
    try:
        return resolve_data_file(rel)
    except FileNotFoundError:
        try:
            return resolve_data_file(rel[:-len(".qasm")] + ".qpy")
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{rel} (or its .qpy twin) not found under any of "
                f"{DATA_SEARCH_PATHS}; set TRLQAS_DATA_DIR or run "
                "tools/generate_data.py") from None
