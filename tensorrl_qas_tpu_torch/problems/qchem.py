"""Self-contained molecular Hamiltonian generation (stage 0).

Replaces the reference's pennylane-qchem pipeline
(``dmrg-to-qc/making_molecules.py:70-140``: STO-3G/6-31G integrals ->
RHF -> active-space reduction -> Jordan-Wigner) with an owned numpy/scipy
implementation:

- Gaussian-basis one/two-electron integrals via McMurchie-Davidson Hermite
  expansion (s and p shells; STO-3G + 6-31G data embedded),
- restricted Hartree-Fock with DIIS,
- active-space (CAS) reduction with frozen-core folding,
- Jordan-Wigner transform through an exact symplectic Pauli algebra.

Conventions match the reference's outputs so regenerated .npz files are
drop-in: interleaved spin orbitals (alpha=even wires), Pauli-string char j
acts on wire j, the constant (core + nuclear repulsion) lives in the
identity coefficient with ``energy_shift=0``.

Geometry units: the reference passes Angstrom-valued coordinates into
pennylane, which interprets them as **Bohr** (making_molecules.py:26 — the
H2O "O-H bond" is 0.97 Bohr = 0.51 A). ``units="bohr"`` (default)
reproduces that behavior; pass ``units="angstrom"`` for physical runs.

This module is plain numpy/scipy host code by design — it is an offline
data-generation stage, not a training-loop component; nothing here touches
torch or the card.  It is the port's own copy of the JAX package's
``problems/qchem.py``.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
from scipy.special import gammainc, gammaln

ANGSTROM_TO_BOHR = 1.8897259886

ATOMIC_NUMBER = {"H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6,
                 "N": 7, "O": 8, "F": 9, "Ne": 10}

# ---------------------------------------------------------------------------
# basis-set data (standard published exponents/contraction coefficients)
# ---------------------------------------------------------------------------
# shells: list of (angmom_letter, [exponents], [coefficients])
_STO3G_1S_COEF = [0.15432897, 0.53532814, 0.44463454]
_STO3G_2S_COEF = [-0.09996723, 0.39951283, 0.70011547]
_STO3G_2P_COEF = [0.15591627, 0.60768372, 0.39195739]

STO3G = {
    "H": [("s", [3.42525091, 0.62391373, 0.16885540], _STO3G_1S_COEF)],
    "Li": [("s", [16.1195750, 2.9362007, 0.7946505], _STO3G_1S_COEF),
           ("s", [0.6362897, 0.1478601, 0.0480887], _STO3G_2S_COEF),
           ("p", [0.6362897, 0.1478601, 0.0480887], _STO3G_2P_COEF)],
    "Be": [("s", [30.1678710, 5.4951153, 1.4871927], _STO3G_1S_COEF),
           ("s", [1.3148331, 0.3055389, 0.0993707], _STO3G_2S_COEF),
           ("p", [1.3148331, 0.3055389, 0.0993707], _STO3G_2P_COEF)],
    "C": [("s", [71.6168370, 13.0450960, 3.5305122], _STO3G_1S_COEF),
          ("s", [2.9412494, 0.6834831, 0.2222899], _STO3G_2S_COEF),
          ("p", [2.9412494, 0.6834831, 0.2222899], _STO3G_2P_COEF)],
    "N": [("s", [99.1061690, 18.0523120, 4.8856602], _STO3G_1S_COEF),
          ("s", [3.7804559, 0.8784966, 0.2857144], _STO3G_2S_COEF),
          ("p", [3.7804559, 0.8784966, 0.2857144], _STO3G_2P_COEF)],
    "O": [("s", [130.7093200, 23.8088610, 6.4436083], _STO3G_1S_COEF),
          ("s", [5.0331513, 1.1695961, 0.3803890], _STO3G_2S_COEF),
          ("p", [5.0331513, 1.1695961, 0.3803890], _STO3G_2P_COEF)],
}

G631 = {
    "H": [("s", [18.7311370, 2.8253937, 0.6401217],
           [0.03349460, 0.23472695, 0.81375733]),
          ("s", [0.1612778], [1.0])],
    "O": [("s", [5484.6717, 825.23495, 188.04696, 52.964500, 16.897570,
                 5.7996353],
           [0.0018311, 0.0139501, 0.0684451, 0.2327143, 0.4701930,
            0.3585209]),
          ("s", [15.539616, 3.5999336, 1.0137618],
           [-0.1107775, -0.1480263, 1.1307670]),
          ("p", [15.539616, 3.5999336, 1.0137618],
           [0.0708743, 0.3397528, 0.7271586]),
          ("s", [0.2700058], [1.0]),
          ("p", [0.2700058], [1.0])],
}

BASIS_SETS = {"sto-3g": STO3G, "6-31g": G631}


@dataclasses.dataclass
class BasisFunction:
    """One contracted Cartesian Gaussian: sum_k c_k N_k x^i y^j z^k e^-a r^2."""

    center: np.ndarray           # (3,)
    lmn: tuple[int, int, int]    # Cartesian powers
    exps: np.ndarray
    coefs: np.ndarray            # includes primitive + contraction norms

    @classmethod
    def make(cls, center, lmn, exps, coefs):
        exps = np.asarray(exps, dtype=np.float64)
        coefs = np.asarray(coefs, dtype=np.float64)
        i, j, k = lmn
        L = i + j + k
        # primitive normalization
        norm = ((2 * exps / np.pi) ** 0.75 * (4 * exps) ** (L / 2)
                / np.sqrt(_dfact(2 * i - 1) * _dfact(2 * j - 1)
                          * _dfact(2 * k - 1)))
        bf = cls(np.asarray(center, dtype=np.float64), lmn, exps,
                 coefs * norm)
        # contracted normalization (self-overlap -> 1)
        s = overlap(bf, bf)
        bf.coefs = bf.coefs / np.sqrt(s)
        return bf


def _dfact(n: int) -> float:
    """(2k-1)!! with (-1)!! = 1."""
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def build_basis(symbols, coords_bohr, basis_name="sto-3g"):
    """AO basis in the reference's ordering: per atom, per shell, with p
    shells expanded x,y,z."""
    data = BASIS_SETS[basis_name.lower()]
    basis = []
    for sym, xyz in zip(symbols, coords_bohr):
        for ang, exps, coefs in data[sym]:
            if ang == "s":
                basis.append(BasisFunction.make(xyz, (0, 0, 0), exps, coefs))
            elif ang == "p":
                for lmn in [(1, 0, 0), (0, 1, 0), (0, 0, 1)]:
                    basis.append(BasisFunction.make(xyz, lmn, exps, coefs))
            else:
                raise NotImplementedError(f"shell {ang}")
    return basis


# ---------------------------------------------------------------------------
# McMurchie-Davidson integrals
# ---------------------------------------------------------------------------

def _E(i, j, t, Q, a, b):
    """Hermite expansion coefficient E_t^{ij} (1D)."""
    p = a + b
    q = a * b / p
    if t < 0 or t > i + j:
        return 0.0
    if i == j == t == 0:
        return np.exp(-q * Q * Q)
    if j == 0:
        return (_E(i - 1, j, t - 1, Q, a, b) / (2 * p)
                - q * Q / a * _E(i - 1, j, t, Q, a, b)
                + (t + 1) * _E(i - 1, j, t + 1, Q, a, b))
    return (_E(i, j - 1, t - 1, Q, a, b) / (2 * p)
            + q * Q / b * _E(i, j - 1, t, Q, a, b)
            + (t + 1) * _E(i, j - 1, t + 1, Q, a, b))


def _overlap_prim(a, lmn1, A, b, lmn2, B):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    s = (_E(l1, l2, 0, A[0] - B[0], a, b)
         * _E(m1, m2, 0, A[1] - B[1], a, b)
         * _E(n1, n2, 0, A[2] - B[2], a, b))
    return s * (np.pi / (a + b)) ** 1.5


def overlap(f1: BasisFunction, f2: BasisFunction) -> float:
    out = 0.0
    for a, ca in zip(f1.exps, f1.coefs):
        for b, cb in zip(f2.exps, f2.coefs):
            out += ca * cb * _overlap_prim(a, f1.lmn, f1.center,
                                           b, f2.lmn, f2.center)
    return out


def _kinetic_prim(a, lmn1, A, b, lmn2, B):
    l2, m2, n2 = lmn2
    term0 = b * (2 * (l2 + m2 + n2) + 3) * _overlap_prim(a, lmn1, A, b,
                                                         lmn2, B)
    term1 = -2 * b * b * (
        _overlap_prim(a, lmn1, A, b, (l2 + 2, m2, n2), B)
        + _overlap_prim(a, lmn1, A, b, (l2, m2 + 2, n2), B)
        + _overlap_prim(a, lmn1, A, b, (l2, m2, n2 + 2), B))
    term2 = -0.5 * (
        l2 * (l2 - 1) * _overlap_prim(a, lmn1, A, b, (l2 - 2, m2, n2), B)
        + m2 * (m2 - 1) * _overlap_prim(a, lmn1, A, b, (l2, m2 - 2, n2), B)
        + n2 * (n2 - 1) * _overlap_prim(a, lmn1, A, b, (l2, m2, n2 - 2), B))
    return term0 + term1 + term2


def kinetic(f1: BasisFunction, f2: BasisFunction) -> float:
    out = 0.0
    for a, ca in zip(f1.exps, f1.coefs):
        for b, cb in zip(f2.exps, f2.coefs):
            out += ca * cb * _kinetic_prim(a, f1.lmn, f1.center,
                                           b, f2.lmn, f2.center)
    return out


def boys(m, T):
    """Boys function F_m(T), scalar, stable at small T."""
    if T < 1e-12:
        return 1.0 / (2 * m + 1)
    # F_m(T) = Gamma(m+1/2) P(m+1/2, T) / (2 T^(m+1/2))
    a = m + 0.5
    return float(np.exp(gammaln(a)) * gammainc(a, T) / (2 * T ** a))


def _hermite_coulomb(t, u, v, n, p, PC):
    """R^n_{tuv} auxiliary Hermite Coulomb integrals (recursive)."""
    if t == u == v == 0:
        return (-2 * p) ** n * boys(n, p * float(PC @ PC))
    if t > 0:
        out = 0.0
        if t > 1:
            out += (t - 1) * _hermite_coulomb(t - 2, u, v, n + 1, p, PC)
        out += PC[0] * _hermite_coulomb(t - 1, u, v, n + 1, p, PC)
        return out
    if u > 0:
        out = 0.0
        if u > 1:
            out += (u - 1) * _hermite_coulomb(t, u - 2, v, n + 1, p, PC)
        out += PC[1] * _hermite_coulomb(t, u - 1, v, n + 1, p, PC)
        return out
    out = 0.0
    if v > 1:
        out += (v - 1) * _hermite_coulomb(t, u, v - 2, n + 1, p, PC)
    out += PC[2] * _hermite_coulomb(t, u, v - 1, n + 1, p, PC)
    return out


def _nuclear_prim(a, lmn1, A, b, lmn2, B, C):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    p = a + b
    P = (a * A + b * B) / p
    PC = P - C
    out = 0.0
    for t in range(l1 + l2 + 1):
        Et = _E(l1, l2, t, A[0] - B[0], a, b)
        if Et == 0.0:
            continue
        for u in range(m1 + m2 + 1):
            Eu = _E(m1, m2, u, A[1] - B[1], a, b)
            if Eu == 0.0:
                continue
            for v in range(n1 + n2 + 1):
                Ev = _E(n1, n2, v, A[2] - B[2], a, b)
                if Ev == 0.0:
                    continue
                out += Et * Eu * Ev * _hermite_coulomb(t, u, v, 0, p, PC)
    return 2 * np.pi / p * out


def nuclear(f1, f2, symbols, coords) -> float:
    out = 0.0
    for a, ca in zip(f1.exps, f1.coefs):
        for b, cb in zip(f2.exps, f2.coefs):
            for sym, C in zip(symbols, coords):
                out -= (ATOMIC_NUMBER[sym] * ca * cb
                        * _nuclear_prim(a, f1.lmn, f1.center,
                                        b, f2.lmn, f2.center, C))
    return out


def _eri_prim(a, lmn1, A, b, lmn2, B, c, lmn3, C, d, lmn4, D):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    l3, m3, n3 = lmn3
    l4, m4, n4 = lmn4
    p = a + b
    q = c + d
    alpha = p * q / (p + q)
    P = (a * A + b * B) / p
    Q = (c * C + d * D) / q
    PQ = P - Q

    E1x = [_E(l1, l2, t, A[0] - B[0], a, b) for t in range(l1 + l2 + 1)]
    E1y = [_E(m1, m2, u, A[1] - B[1], a, b) for u in range(m1 + m2 + 1)]
    E1z = [_E(n1, n2, v, A[2] - B[2], a, b) for v in range(n1 + n2 + 1)]
    E2x = [_E(l3, l4, t, C[0] - D[0], c, d) for t in range(l3 + l4 + 1)]
    E2y = [_E(m3, m4, u, C[1] - D[1], c, d) for u in range(m3 + m4 + 1)]
    E2z = [_E(n3, n4, v, C[2] - D[2], c, d) for v in range(n3 + n4 + 1)]

    out = 0.0
    for t, Et in enumerate(E1x):
        if Et == 0.0:
            continue
        for u, Eu in enumerate(E1y):
            if Eu == 0.0:
                continue
            for v, Ev in enumerate(E1z):
                if Ev == 0.0:
                    continue
                for t2, Et2 in enumerate(E2x):
                    if Et2 == 0.0:
                        continue
                    for u2, Eu2 in enumerate(E2y):
                        if Eu2 == 0.0:
                            continue
                        for v2, Ev2 in enumerate(E2z):
                            if Ev2 == 0.0:
                                continue
                            out += (Et * Eu * Ev * Et2 * Eu2 * Ev2
                                    * (-1) ** (t2 + u2 + v2)
                                    * _hermite_coulomb(t + t2, u + u2,
                                                       v + v2, 0, alpha, PQ))
    return out * 2 * np.pi ** 2.5 / (p * q * np.sqrt(p + q))


def eri(f1, f2, f3, f4) -> float:
    """Chemist-notation (12|34) contracted two-electron integral."""
    out = 0.0
    for a, ca in zip(f1.exps, f1.coefs):
        for b, cb in zip(f2.exps, f2.coefs):
            for c, cc in zip(f3.exps, f3.coefs):
                for d, cd in zip(f4.exps, f4.coefs):
                    out += (ca * cb * cc * cd
                            * _eri_prim(a, f1.lmn, f1.center,
                                        b, f2.lmn, f2.center,
                                        c, f3.lmn, f3.center,
                                        d, f4.lmn, f4.center))
    return out


def integral_tensors(basis, symbols, coords):
    """(S, Hcore, ERI) AO-basis tensors with 8-fold ERI symmetry reuse."""
    n = len(basis)
    S = np.zeros((n, n))
    T = np.zeros((n, n))
    V = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            S[i, j] = S[j, i] = overlap(basis[i], basis[j])
            T[i, j] = T[j, i] = kinetic(basis[i], basis[j])
            V[i, j] = V[j, i] = nuclear(basis[i], basis[j], symbols, coords)
    g = np.zeros((n, n, n, n))
    done = np.zeros((n, n, n, n), dtype=bool)
    for i in range(n):
        for j in range(i + 1):
            for k in range(n):
                for l_ in range(k + 1):
                    if (i * (i + 1) // 2 + j) < (k * (k + 1) // 2 + l_):
                        continue
                    if done[i, j, k, l_]:
                        continue
                    val = eri(basis[i], basis[j], basis[k], basis[l_])
                    for (p, q, r, s) in [(i, j, k, l_), (j, i, k, l_),
                                         (i, j, l_, k), (j, i, l_, k),
                                         (k, l_, i, j), (l_, k, i, j),
                                         (k, l_, j, i), (l_, k, j, i)]:
                        g[p, q, r, s] = val
                        done[p, q, r, s] = True
    return S, T + V, g


def nuclear_repulsion(symbols, coords) -> float:
    out = 0.0
    for (s1, c1), (s2, c2) in itertools.combinations(
            zip(symbols, coords), 2):
        out += (ATOMIC_NUMBER[s1] * ATOMIC_NUMBER[s2]
                / np.linalg.norm(np.asarray(c1) - np.asarray(c2)))
    return out


# ---------------------------------------------------------------------------
# restricted Hartree-Fock
# ---------------------------------------------------------------------------

def rhf(S, Hcore, g, n_electrons, max_iter=200, tol=1e-11):
    """Closed-shell SCF with DIIS. Returns (E_elec, C, eps)."""
    n = S.shape[0]
    nocc = n_electrons // 2
    # symmetric orthogonalization
    sval, svec = np.linalg.eigh(S)
    X = svec @ np.diag(sval ** -0.5) @ svec.T

    def fock(D):
        J = np.einsum("pqrs,rs->pq", g, D)
        K = np.einsum("prqs,rs->pq", g, D)
        return Hcore + 2 * J - K

    def density(F):
        Fp = X.T @ F @ X
        eps, Cp = np.linalg.eigh(Fp)
        C = X @ Cp
        Cocc = C[:, :nocc]
        return Cocc @ Cocc.T, C, eps

    D, C, eps = density(Hcore)
    errs, focks = [], []
    E_old = 0.0
    for _ in range(max_iter):
        F = fock(D)
        # DIIS
        err = F @ D @ S - S @ D @ F
        errs.append(err)
        focks.append(F)
        if len(errs) > 8:
            errs.pop(0)
            focks.pop(0)
        if len(errs) > 1:
            m = len(errs)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for i in range(m):
                for j in range(m):
                    B[i, j] = np.einsum("pq,pq->", errs[i], errs[j])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(B, rhs)[:m]
                F = sum(wi * Fi for wi, Fi in zip(w, focks))
            except np.linalg.LinAlgError:
                pass
        D, C, eps = density(F)
        E = np.einsum("pq,pq->", D, Hcore + fock(D))
        if abs(E - E_old) < tol and np.max(np.abs(err)) < 1e-8:
            break
        E_old = E
    return E, C, eps


# ---------------------------------------------------------------------------
# active space + spin orbitals
# ---------------------------------------------------------------------------

def active_space_integrals(Hcore_mo, g_mo, n_electrons, active_electrons,
                           active_orbitals):
    """Fold frozen-core contributions; return (E_core, h_act, g_act)."""
    ncore = (n_electrons - active_electrons) // 2
    act = list(range(ncore, ncore + active_orbitals))
    core = list(range(ncore))
    E_core = 0.0
    for i in core:
        E_core += 2 * Hcore_mo[i, i]
        for j in core:
            E_core += 2 * g_mo[i, i, j, j] - g_mo[i, j, j, i]
    h_act = Hcore_mo[np.ix_(act, act)].copy()
    for a_i, p in enumerate(act):
        for a_j, q in enumerate(act):
            for i in core:
                h_act[a_i, a_j] += (2 * g_mo[p, q, i, i]
                                    - g_mo[p, i, i, q])
    g_act = g_mo[np.ix_(act, act, act, act)]
    return E_core, h_act, g_act


# ---------------------------------------------------------------------------
# Jordan-Wigner via symplectic Pauli algebra
# ---------------------------------------------------------------------------

def _pauli_mul(x1, z1, c1, x2, z2, c2):
    """Product of two Pauli-mask terms -> (x, z, coeff)."""
    plus = ((x1 & ~z1 & x2 & z2).bit_count()       # X.Y -> +i
            + (x1 & z1 & ~x2 & z2).bit_count()     # Y.Z -> +i
            + (~x1 & z1 & x2 & ~z2).bit_count())   # Z.X -> +i
    minus = ((x1 & ~z1 & ~x2 & z2).bit_count()     # X.Z -> -i
             + (x1 & z1 & x2 & ~z2).bit_count()    # Y.X -> -i
             + (~x1 & z1 & x2 & z2).bit_count())   # Z.Y -> -i
    phase = (1j) ** ((plus + 3 * minus) % 4)
    return x1 ^ x2, z1 ^ z2, c1 * c2 * phase


def _jw_ladder(j: int, dagger: bool):
    """a_j (or a_j^dagger) as two Pauli-mask terms."""
    zlow = (1 << j) - 1
    xj = 1 << j
    sgn = -0.5j if dagger else 0.5j
    return [(xj, zlow, 0.5), (xj, zlow | xj, sgn)]


def _accumulate_product(acc, ops, coeff):
    """acc += coeff * product(ops) where each op is a list of mask-terms."""
    terms = [(0, 0, coeff)]
    for op in ops:
        new = []
        for (x1, z1, c1) in terms:
            for (x2, z2, c2) in op:
                new.append(_pauli_mul(x1, z1, c1, x2, z2, c2))
        terms = new
    for x, z, c in terms:
        key = (x, z)
        acc[key] = acc.get(key, 0.0) + c


def jordan_wigner_hamiltonian(E_const, h, g, tol=1e-10):
    """JW-map E + sum h_pq a+_p a_q + 1/2 sum (pq|rs) a+_ps a+_rt a_st a_qs.

    h, g are *spatial* active-space integrals (chemist notation for g);
    spin orbitals interleave alpha(even)/beta(odd) as in pennylane.
    Returns (paulis, weights) with char j acting on wire j.
    """
    n_sp = h.shape[0]
    n_q = 2 * n_sp
    acc = {(0, 0): complex(E_const)}
    for p in range(n_sp):
        for q in range(n_sp):
            if abs(h[p, q]) < tol:
                continue
            for s in range(2):
                _accumulate_product(
                    acc, [_jw_ladder(2 * p + s, True),
                          _jw_ladder(2 * q + s, False)], h[p, q])
    for p in range(n_sp):
        for q in range(n_sp):
            for r in range(n_sp):
                for s_ in range(n_sp):
                    w = g[p, q, r, s_]
                    if abs(w) < tol:
                        continue
                    for s1 in range(2):
                        for s2 in range(2):
                            _accumulate_product(
                                acc,
                                [_jw_ladder(2 * p + s1, True),
                                 _jw_ladder(2 * r + s2, True),
                                 _jw_ladder(2 * s_ + s2, False),
                                 _jw_ladder(2 * q + s1, False)], 0.5 * w)
    paulis, weights = [], []
    for (x, z), c in acc.items():
        if abs(c) < 1e-8:
            continue
        chars = []
        for qbit in range(n_q):
            xb = (x >> qbit) & 1
            zb = (z >> qbit) & 1
            chars.append("IXZY"[xb + 2 * zb])
        paulis.append("".join(chars))
        # hermitian H -> real coefficients
        weights.append(float(np.real(c)))
    return paulis, np.asarray(weights), n_q


# ---------------------------------------------------------------------------
# top-level driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MolecularHamiltonian:
    paulis: list
    weights: np.ndarray
    n_qubits: int
    e_hf: float
    e_nuc: float
    e_core: float


def parse_geometry(geometry: str):
    """'H -0.021 -0.002 0.000; O ...' -> (symbols, coords array)."""
    symbols, coords = [], []
    for atom in geometry.split(";"):
        parts = atom.split()
        symbols.append(parts[0])
        coords.append([float(v) for v in parts[1:4]])
    return symbols, np.asarray(coords, dtype=np.float64)


def molecular_hamiltonian(symbols, coords, active_electrons=None,
                          active_orbitals=None, basis="sto-3g",
                          units="bohr") -> MolecularHamiltonian:
    """Full stage-0 pipeline: integrals -> RHF -> CAS -> Jordan-Wigner.

    ``units="bohr"`` (default) feeds coordinates straight in, matching the
    reference's pennylane call (which treats its Angstrom-valued numbers as
    Bohr — see module docstring).
    """
    coords = np.asarray(coords, dtype=np.float64)
    if units == "angstrom":
        coords = coords * ANGSTROM_TO_BOHR
    elif units != "bohr":
        raise ValueError(f"units must be bohr|angstrom, got {units}")
    n_electrons = sum(ATOMIC_NUMBER[s] for s in symbols)
    if active_electrons is None:
        active_electrons = n_electrons
    basis_fns = build_basis(symbols, coords, basis)
    if active_orbitals is None:
        active_orbitals = len(basis_fns)
    S, Hcore, g_ao = integral_tensors(basis_fns, symbols, coords)
    e_nuc = nuclear_repulsion(symbols, coords)
    E_elec, C, _ = rhf(S, Hcore, g_ao, n_electrons)
    # AO -> MO transforms
    Hmo = C.T @ Hcore @ C
    g_mo = np.einsum("pqrs,pi,qj,rk,sl->ijkl", g_ao, C, C, C, C,
                     optimize=True)
    E_core, h_act, g_act = active_space_integrals(
        Hmo, g_mo, n_electrons, active_electrons, active_orbitals)
    paulis, weights, n_q = jordan_wigner_hamiltonian(
        E_core + e_nuc, h_act, g_act)
    return MolecularHamiltonian(paulis=paulis, weights=weights,
                                n_qubits=n_q, e_hf=E_elec + e_nuc,
                                e_nuc=e_nuc, e_core=E_core)
