"""Two-qubit gate synthesis: SU(4) -> 3 CNOTs + single-qubit rotations.

Replaces the reference's dependency on the qiskit transpiler
(``dmrg-to-qc/tnqc_ansatze.py:38``: ``qk.transpile(optimization_level=3,
basis_gates=['cx','rx','ry','rz'])``) for lowering the brickwork SU(4)
warm-start gates to the RL gate set.

Method: local-invariant matching.  Two two-qubit unitaries are equivalent
up to single-qubit gates iff their Makhlin invariants (G1 complex, G2 real)
agree.  We use a universal 3-CNOT template

    T(p) = CX . (Rz(p1) x Ry(p2)) . CX . (I x Ry(p3)) . CX

(Vatan-Williams form), solve invariants(T(p)) = invariants(U) with a
damped Newton iteration from a coarse grid, and then compute the exact
local corrections by KAK-decomposing U and T(p) with a shared deterministic
convention (same sorted Weyl phases => identical canonical middle factor).
The result is verified to machine precision and asserted against a distance
tolerance — the reference instead relied on an energy round-trip check at
1e-6 (``dmrg_to_qc.py:303-315``), which we also keep at the pipeline level.

All matrices here are little-endian 4x4 on (q1 q0): basis index = 2*b1+b0.

Host numpy: the port's own copy of the JAX package's ``synth/kak.py``.
"""

from __future__ import annotations

import numpy as np

_I = np.eye(2, dtype=complex)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
_Z = np.array([[1, 0], [0, -1]], dtype=complex)

# CX with control q0 (low bit), target q1 (high bit): |b1 b0> basis
CX01 = np.array([[1, 0, 0, 0],
                 [0, 0, 0, 1],
                 [0, 0, 1, 0],
                 [0, 1, 0, 0]], dtype=complex)

# CX with control q1 (high bit), target q0 (low bit)
CX10 = np.array([[1, 0, 0, 0],
                 [0, 1, 0, 0],
                 [0, 0, 0, 1],
                 [0, 0, 1, 0]], dtype=complex)

# magic (Bell) basis
_B = np.array([[1, 0, 0, 1j],
               [0, 1j, 1, 0],
               [0, 1j, -1, 0],
               [1, 0, 0, -1j]], dtype=complex) / np.sqrt(2)


def rz(t):
    return np.array([[np.exp(-0.5j * t), 0], [0, np.exp(0.5j * t)]])


def ry(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


def rx(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def kron(a, b):
    """a on q1 (high bit), b on q0 (low bit)."""
    return np.kron(a, b)


def closest_unitary(m: np.ndarray) -> np.ndarray:
    """Polar projection onto U(n) (reference ``tnqc_ansatze.py:11-19``)."""
    u, _, vh = np.linalg.svd(m)
    return u @ vh


def makhlin_invariants(u: np.ndarray):
    """Local invariants (G1 complex, G2 real) of a two-qubit unitary."""
    m = _B.conj().T @ u @ _B
    mm = m.T @ m
    det = np.linalg.det(u)
    g1 = np.trace(mm) ** 2 / (16 * det)
    g2 = (np.trace(mm) ** 2 - np.trace(mm @ mm)) / (4 * det)
    return g1, np.real(g2)


def template(p):
    """Universal 3-CNOT template (Vatan-Williams form, alternating CNOT
    directions).  Application order: CX(q0->q1); Rz(p1) q1, Ry(p2) q0;
    CX(q1->q0); Ry(p3) q0; CX(q0->q1).  Coverage of the full Weyl chamber
    verified empirically over random SU(4) samples in tests."""
    p1, p2, p3 = p
    return (CX01 @ kron(_I, ry(p3)) @ CX10 @ kron(rz(p1), ry(p2)) @ CX01)


def _inv_vec(u):
    g1, g2 = makhlin_invariants(u)
    return np.array([np.real(g1), np.imag(g1), g2])


def _solve_template(u, tol=1e-11, max_starts=24, seed=0):
    """Find p with invariants(T(p)) == invariants(U) (Levenberg-Marquardt
    from random starts; the invariant map is smooth away from chamber
    walls)."""
    from scipy.optimize import least_squares

    target = _inv_vec(u)

    def f(p):
        return _inv_vec(template(p)) - target

    rng = np.random.default_rng(seed)
    best_p, best_r = None, np.inf
    for _ in range(max_starts):
        p0 = rng.uniform(-np.pi, np.pi, 3)
        res = least_squares(f, p0, method="lm", max_nfev=400)
        r = np.linalg.norm(res.fun)
        if r < best_r:
            best_p, best_r = res.x, r
        if best_r < tol:
            break
    return best_p


def _weyl_factor(u):
    """Deterministic KAK factorization U = phase * L @ A @ R.

    Returns (phase, L, A, R) with L, R in SU(2)xSU(2) and
    A = B diag(exp(i phi_k / 2)) B^H built from a deterministically sorted,
    det-consistent phase vector — so two locally-equivalent unitaries get
    the *same* A.
    """
    det = np.linalg.det(u)
    alpha = det ** 0.25
    v = u / alpha
    m = _B.conj().T @ v @ _B
    mm = m.T @ m

    # joint diagonalization of the commuting real/imag parts by a real
    # orthogonal P (random-combination trick handles degeneracies)
    rng = np.random.default_rng(7)
    for _ in range(40):
        mu = rng.normal()
        h = np.real(mm) + mu * np.imag(mm)
        _, p = np.linalg.eigh((h + h.T) / 2)
        d = p.T @ mm @ p
        if np.max(np.abs(d - np.diag(np.diag(d)))) < 1e-10:
            break
    else:
        raise np.linalg.LinAlgError("joint diagonalization failed")

    # Deterministic ordering keyed on the *eigenvalues* lambda_k of M^T M
    # (exact complex invariants of the local-equivalence class — two
    # locally-equivalent unitaries share the multiset, so sorting by
    # rounded (Re, Im) gives both the SAME ordered list and hence the same
    # canonical middle factor A).  Phase branches would not be stable.
    lam = np.diag(d)
    lam = lam / np.abs(lam)

    def sort_keys(vals):
        # 6-decimal keys: coarser than the ~1e-8 numerical noise of the
        # template solve, so near-degenerate eigenvalues tie (and equal
        # eigenvalues give identical phases whatever their tie order)
        ks = [(round(x.real, 6), round(x.imag, 6)) for x in vals]
        order = sorted(range(4), key=lambda k: ks[k])
        return order, [ks[k] for k in order]

    # det(U)^{1/4} is branch-ambiguous up to i^k, which flips the lambda
    # multiset sign; canonicalize by choosing the lexicographically smaller
    # of {lambda} and {-lambda} so locally-equivalent inputs agree.
    order_p, keys_p = sort_keys(lam)
    order_n, keys_n = sort_keys(-lam)
    if keys_n < keys_p:
        lam = -lam
        m = 1j * m
        alpha = alpha * (-1j)
        order = order_n
    else:
        order = order_p
    lam = lam[order]
    p = p[:, order]
    if np.linalg.det(p) < 0:
        p[:, 0] = -p[:, 0]

    # Fixed sqrt branch per eigenvalue.  The branch decision is taken on
    # the *snapped* (6-decimal) eigenvalue so that noise near the -1 branch
    # cut cannot flip it between locally-equivalent inputs; the exact phase
    # is then the snapped angle plus a small branch-safe correction.
    snapped = np.array([complex(round(x.real, 6) + 0.0, round(x.imag, 6) + 0.0)
                        for x in lam])
    theta_s = np.angle(snapped)
    corr = np.angle(lam * np.exp(-1j * theta_s))
    phases = 0.5 * (theta_s + corr)
    dhalf = np.exp(1j * phases)
    kp = m @ p @ np.diag(1.0 / dhalf)
    if np.linalg.det(np.real(kp)) < 0:
        # land K' in SO(4): flip the sqrt branch of the first eigenvalue
        # (deterministic, hence identical for locally-equivalent inputs)
        phases[0] += np.pi
        dhalf = np.exp(1j * phases)
        kp = m @ p @ np.diag(1.0 / dhalf)
    if np.max(np.abs(np.imag(kp))) > 1e-7:
        raise np.linalg.LinAlgError("kak: K' not real — branch inconsistency")
    kp = np.real(kp)

    a = _B @ np.diag(dhalf) @ _B.conj().T
    left = _B @ kp @ _B.conj().T
    right = _B @ p.T @ _B.conj().T
    return alpha, left, a, right, phases


def su2_kron_factor(w: np.ndarray):
    """Factor W = A (x) B with A on q1, B on q0, up to phase."""
    t = w.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    uu, ss, vv = np.linalg.svd(t)
    a = uu[:, 0].reshape(2, 2) * np.sqrt(ss[0])
    b = vv[0].reshape(2, 2) * np.sqrt(ss[0])
    # push determinant phases into a global phase
    return a, b


def zyz_angles(u: np.ndarray):
    """u = exp(i alpha) Rz(a) Ry(b) Rz(c); returns (alpha, a, b, c)."""
    det = np.linalg.det(u)
    alpha = 0.5 * np.angle(det)
    su = u * np.exp(-1j * alpha)
    b = 2 * np.arctan2(abs(su[1, 0]), abs(su[0, 0]))
    if abs(su[0, 0]) > 1e-12 and abs(su[1, 0]) > 1e-12:
        apc = 2 * np.angle(su[1, 1])
        amc = 2 * np.angle(su[1, 0])
        a = (apc + amc) / 2
        c = (apc - amc) / 2
    elif abs(su[0, 0]) <= 1e-12:
        a = 2 * np.angle(su[1, 0])
        c = 0.0
    else:
        a = 2 * np.angle(su[1, 1])
        c = 0.0
    return alpha, a, b, c


def _gates_for_1q(u: np.ndarray, qubit: int):
    """ZYZ lowering of a 1q unitary -> [(name, qubit, angle)], phase."""
    alpha, a, b, c = zyz_angles(u)
    gates = []
    if abs(c) > 1e-12:
        gates.append(("rz", qubit, c))
    if abs(b) > 1e-12:
        gates.append(("ry", qubit, b))
    if abs(a) > 1e-12:
        gates.append(("rz", qubit, a))
    return gates, alpha


def decompose_su4(u: np.ndarray, q0: int, q1: int, atol: float = 5e-7):
    """Lower a 4x4 unitary on (q0=low bit, q1=high bit) to the RL gate set.

    Returns (gates, phase): gates is a list of ('cx', ctrl, targ, None) and
    ('rz'/'ry', qubit, angle) tuples in application order; the circuit
    equals u up to the returned global phase (verified to ``atol``).
    """
    u = closest_unitary(np.asarray(u, dtype=complex))
    p = _solve_template(u)
    t = template(p)
    if np.linalg.norm(_inv_vec(t) - _inv_vec(u)) > 1e-9:
        raise ValueError("template matching failed for SU(4) gate")

    au, lu, canu, ru, phu = _weyl_factor(u)
    at, lt, cant, rt, pht = _weyl_factor(t)
    if np.linalg.norm(phu - pht) > 1e-5:
        raise ValueError("Weyl phase mismatch after invariant matching")
    # U = au * lu @ can @ ru ; T = at * lt @ can @ rt
    # => U = (au/at) * (lu lt^H) T (rt^H ru)
    pre = rt.conj().T @ ru          # applied first
    post = lu @ lt.conj().T        # applied last

    gates = []
    total_phase = np.angle(au / at)

    def add_local(mat4):
        """Append ZYZ gates for a kron-factorable local layer."""
        nonlocal total_phase
        a_mat, b_mat = su2_kron_factor(mat4)
        # phase residue of the factorization: mat4 = e^{id} a (x) b
        approx = kron(a_mat, b_mat)
        total_phase += np.angle(np.vdot(approx.reshape(-1),
                                        mat4.reshape(-1)))
        for mat, qubit in ((b_mat, q0), (a_mat, q1)):
            gs, ph = _gates_for_1q(mat, qubit)
            gates.extend(gs)
            total_phase += ph

    add_local(pre)
    # template body in application order (see template())
    p1, p2, p3 = p
    gates.append(("cx", q0, q1))
    gates.append(("ry", q0, p2))
    gates.append(("rz", q1, p1))
    gates.append(("cx", q1, q0))
    gates.append(("ry", q0, p3))
    gates.append(("cx", q0, q1))
    add_local(post)

    # verify against the input to machine precision
    m = np.eye(4, dtype=complex)
    for g in gates:
        if g[0] == "cx":
            m = (CX01 if (g[1], g[2]) == (q0, q1) else CX10) @ m
        else:
            one = {"rz": rz, "ry": ry}[g[0]](g[2])
            m = (kron(one, _I) if g[1] == q1 else kron(_I, one)) @ m
    m = m * np.exp(1j * total_phase)
    err = np.linalg.norm(m - u)
    if err > atol:
        raise ValueError(f"decomposition verification failed: |T-U| = {err:.2e}")
    return gates, total_phase


# -- SU(4)-basis synthesis (RXX/RYY/RZZ instead of 3 CNOTs) -----------------

def _rpp(pauli2, t):
    """exp(-i t (P (x) P) / 2) as a 4x4 matrix."""
    return np.cos(t / 2) * np.eye(4) - 1j * np.sin(t / 2) * pauli2


def decompose_su4_pauli(u: np.ndarray, q0: int, q1: int, atol: float = 5e-7):
    """Lower a 4x4 unitary to the SU(4) action gate set.

    The reference's stage-1 driver can emit rxx/ryy/rzz-basis warm-start
    circuits (``dmrg-to-qc/dmrg_to_qc.py:203-206, 239``).  Here that drops
    straight out of the Weyl factorization U = phase * L @ A @ R: the
    canonical factor A commutes with {XX, YY, ZZ} (all diagonal in the
    magic basis), so its phase vector is a linear system in the three
    interaction angles, and A = e^{i d} RXX(tx) RYY(ty) RZZ(tz) exactly —
    no 3-CNOT template needed.

    Returns (gates, phase): ('rz'/'ry', qubit, angle) and
    ('rxx'/'ryy'/'rzz', q0, q1, angle) tuples in application order.
    """
    import itertools

    u = closest_unitary(np.asarray(u, dtype=complex))
    alpha, left, a, right, phases = _weyl_factor(u)

    xx, yy, zz = kron(_X, _X), kron(_Y, _Y), kron(_Z, _Z)
    sigs = [np.real(np.diag(_B.conj().T @ m @ _B)) for m in (xx, yy, zz)]
    # phases_k = d - (tx s1k + ty s2k + tz s3k)/2  (mod 2pi)
    m4 = np.column_stack([np.ones(4)] + [-0.5 * s for s in sigs])
    sol = None
    for ks in itertools.product((0, 1, -1, 2), repeat=3):
        rhs = phases + 2 * np.pi * np.array([0, *ks])
        cand = np.linalg.solve(m4, rhs)
        d, tx, ty, tz = cand
        a_try = np.exp(1j * d) * (_rpp(xx, tx) @ _rpp(yy, ty) @ _rpp(zz, tz))
        if np.linalg.norm(a_try - a) < 1e-9:
            sol = cand
            break
    if sol is None:
        raise ValueError("su4-basis phase solve failed")
    d, tx, ty, tz = sol

    gates = []
    total_phase = np.angle(alpha) + d

    def add_local(mat4):
        nonlocal total_phase
        a_mat, b_mat = su2_kron_factor(mat4)
        approx = kron(a_mat, b_mat)
        total_phase += np.angle(np.vdot(approx.reshape(-1),
                                        mat4.reshape(-1)))
        for mat, qubit in ((b_mat, q0), (a_mat, q1)):
            gs, ph = _gates_for_1q(mat, qubit)
            gates.extend(gs)
            total_phase += ph

    add_local(right)
    gates.append(("rzz", q0, q1, tz))
    gates.append(("ryy", q0, q1, ty))
    gates.append(("rxx", q0, q1, tx))
    add_local(left)

    # verify against the input
    m = np.eye(4, dtype=complex)
    two_q = {"rxx": xx, "ryy": yy, "rzz": zz}
    for g in gates:
        if g[0] in two_q:
            m = _rpp(two_q[g[0]], g[3]) @ m
        else:
            one = {"rz": rz, "ry": ry}[g[0]](g[2])
            m = (kron(one, _I) if g[1] == q1 else kron(_I, one)) @ m
    m = m * np.exp(1j * total_phase)
    err = np.linalg.norm(m - u)
    if err > atol:
        raise ValueError(f"su4-basis verification failed: |T-U| = {err:.2e}")
    return gates, total_phase
