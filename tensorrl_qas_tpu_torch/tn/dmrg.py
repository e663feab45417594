"""Two-site DMRG ground-state solver.

Replaces the reference's quimb DMRG (``dmrg-to-qc/mps2qc.py:102-153``:
``qtn.DMRG(bond_dims=[chi], cutoffs=0).solve(max_sweeps=2)``).  Design
differences from quimb's generic sweeper:

- fixed target bond dimension chi (cutoffs=0 semantics) with *dense*
  effective-Hamiltonian eigensolves: the two-site effective problem has
  dimension (chi_l * 2) * (2 * chi_r) <= 4 chi^2, which for the warm-start
  regime (chi <= 8) is a <= 256-dim hermitian eigh — cheaper and more
  robust than iterative Lanczos at this scale;
- environments are rebuilt incrementally left/right per sweep.

Includes the chemical-accuracy cross-check against exact diagonalization
that the reference logs (``mps2qc.py:136-151``).

Host numpy, as in the JAX package's ``tn/dmrg.py``, of which this is the
port's own copy.
"""

from __future__ import annotations

import numpy as np

from tensorrl_qas_tpu_torch.tn.mpo import MPO
from tensorrl_qas_tpu_torch.tn.mps import MPS


# from this dimension on the ground state comes from Lanczos on the sparse
# matrix (converged to machine precision): a dense eigh of a 12-qubit
# molecule's 4096-dim matrix would dominate that warm start's host time,
# and its matrix holds a few hundred nonzeros a row
LANCZOS_MIN_DIM = 1024


def gs_exact_diag(dense_h: np.ndarray):
    """Exact ground state (oracle; reference ``mps2qc.py:86-100``).

    Below ``LANCZOS_MIN_DIM`` a dense ``eigh``, as in the JAX package;
    from it, ARPACK's Lanczos on the matrix in CSR form with ``tol=0``
    (machine precision) from a seeded random start (a symmetric start
    could be orthogonal to the ground state)."""
    dim = dense_h.shape[0]
    if dim < LANCZOS_MIN_DIM:
        vals, vecs = np.linalg.eigh(dense_h)
        return float(vals[0]), vecs[:, 0]
    from scipy.sparse import csr_matrix
    from scipy.sparse.linalg import eigsh

    rng = np.random.default_rng(0)
    v0 = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    vals, vecs = eigsh(csr_matrix(dense_h), k=1, which="SA", tol=0, v0=v0)
    return float(vals[0]), vecs[:, 0]


def _left_env(env, a, w):
    # env: (bw, ku, kd); a: (kl, s, kr) bra/ket site; w: (bl, br, so, si)
    tmp = np.einsum("buk,usr->bksr", env, a.conj())
    tmp = np.einsum("bksr,bcst->kcrt", tmp, w)
    return np.einsum("kcrt,ktm->crm", tmp, a)


def _right_env(env, a, w):
    tmp = np.einsum("buk,rsu->brsk", env, a.conj())
    tmp = np.einsum("brsk,cbst->crtk", tmp, w)
    return np.einsum("crtk,mtk->crm", tmp, a)


def _effective_h(le, w1, w2, re):
    """Two-site effective Hamiltonian.

    le: (b, u, d) left environment; w1/w2: MPO site tensors; re: (b, u, d).
    Returns H of shape (u, s, t, ur, d, s', t', dr) flattened to a matrix.
    """
    m = np.einsum("bud,bcsS->ucsSd", le, w1)
    m = np.einsum("ucsSd,cetT->usteSTd", m, w2)
    # m: (u, s, t, e, S, T, d) -> attach right env (e, ur, dr)
    m = np.einsum("usteSTd,exy->ustxSTdy", m, re)
    dim_u, _, _, dim_x = m.shape[0], 2, 2, m.shape[3]
    dim_d, dim_y = m.shape[6], m.shape[7]
    m = np.transpose(m, (0, 1, 2, 3, 6, 4, 5, 7))   # (u,s,t,x, d,S,T,y)
    return m.reshape(dim_u * 4 * dim_x, dim_d * 4 * dim_y)


def gs_dmrg(mpo: MPO, chi: int, max_sweeps: int = 4, seed: int = 0,
            tol: float = 1e-10, verbose: bool = False):
    """Ground-state MPS at fixed bond dimension chi.

    Returns (energy, MPS).
    """
    n = mpo.n_sites
    mps = MPS.random(n, chi, seed=seed)
    mps.left_canonicalize()
    mps.normalize()
    W = mpo.tensors

    # right environments for sites i..n-1; renv[i] pairs with bond left of i
    def build_renvs(mps):
        renv = [None] * (n + 1)
        renv[n] = np.ones((1, 1, 1), dtype=np.complex128)
        for i in range(n - 1, 0, -1):
            renv[i] = _right_env(renv[i + 1], mps.tensors[i], W[i])
        return renv

    energy = np.inf
    lenv = [None] * (n + 1)
    lenv[0] = np.ones((1, 1, 1), dtype=np.complex128)

    for sweep in range(max_sweeps):
        renv = build_renvs(mps)
        prev_energy = energy
        # left-to-right
        for i in range(n - 1):
            a, b = mps.tensors[i], mps.tensors[i + 1]
            dl, _, _ = a.shape
            _, _, dr = b.shape
            h = _effective_h(lenv[i], W[i], W[i + 1], renv[i + 2])
            vals, vecs = np.linalg.eigh(h)
            energy = float(vals[0])
            theta = vecs[:, 0].reshape(dl * 2, 2 * dr)
            u, s, vh = np.linalg.svd(theta, full_matrices=False)
            keep = min(chi, len(s))
            u, s, vh = u[:, :keep], s[:keep], vh[:keep]
            s = s / np.linalg.norm(s)
            mps.tensors[i] = u.reshape(dl, 2, keep)
            mps.tensors[i + 1] = (s[:, None] * vh).reshape(keep, 2, dr)
            lenv[i + 1] = _left_env(lenv[i], mps.tensors[i], W[i])
        # right-to-left
        for i in range(n - 2, -1, -1):
            a, b = mps.tensors[i], mps.tensors[i + 1]
            dl = a.shape[0]
            dr = b.shape[2]
            re = renv[i + 2] if i + 2 <= n else np.ones((1, 1, 1),
                                                        dtype=np.complex128)
            h = _effective_h(lenv[i], W[i], W[i + 1], re)
            vals, vecs = np.linalg.eigh(h)
            energy = float(vals[0])
            theta = vecs[:, 0].reshape(dl * 2, 2 * dr)
            u, s, vh = np.linalg.svd(theta, full_matrices=False)
            keep = min(chi, len(s))
            u, s, vh = u[:, :keep], s[:keep], vh[:keep]
            s = s / np.linalg.norm(s)
            mps.tensors[i] = (u * s[None, :]).reshape(dl, 2, keep)
            mps.tensors[i + 1] = vh.reshape(keep, 2, dr)
            renv[i + 1] = _right_env(renv[i + 2], mps.tensors[i + 1],
                                     W[i + 1])
        if verbose:
            print(f"DMRG sweep {sweep}: E = {energy:.10f}")
        if abs(prev_energy - energy) < tol:
            break

    mps.normalize()
    return energy, mps
