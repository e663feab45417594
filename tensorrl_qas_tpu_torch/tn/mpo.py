"""Matrix-product operators from Pauli sums.

The reference builds a diagonal-selector MPO with bond dimension = number of
Pauli terms (``dmrg-to-qc/mps2qc.py:24-75``).  We build the same selector
form (it is exact and simple) and, by default, SVD-compress the operator,
which the reference never does — for molecular Hamiltonians compression
typically shrinks the bond by 3-10x, which quadratically reduces DMRG
environment cost.

Site tensor shape: (bond_left, bond_right, s_out, s_in).  Pauli char j acts
on site j = circuit qubit j.

Host numpy: the port's own copy of the JAX package's ``tn/mpo.py``, with
one difference: the compressed MPO starts from a suffix trie of the
strings instead of the selector form (the same operator, cheaper SVDs).
"""

from __future__ import annotations

import numpy as np

_P = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


class MPO:
    def __init__(self, tensors: list[np.ndarray]):
        self.tensors = tensors

    @property
    def n_sites(self) -> int:
        return len(self.tensors)

    @property
    def bond_dims(self) -> list[int]:
        return [t.shape[1] for t in self.tensors[:-1]]

    def to_dense(self) -> np.ndarray:
        """Dense little-endian matrix (oracle, n <= ~12)."""
        acc = self.tensors[0]                        # (1, b, s, s')
        for t in self.tensors[1:]:
            acc = np.einsum("lb...,brst->lr...st", acc, t)
        # acc: (1, 1, s0, s0', s1, s1', ...)
        n = self.n_sites
        acc = acc.reshape([2, 2] * n)
        # out indices at even positions, in at odd; site 0 first
        out_axes = list(range(0, 2 * n, 2))[::-1]   # site n-1 ... site 0
        in_axes = list(range(1, 2 * n, 2))[::-1]
        acc = np.transpose(acc, axes=out_axes + in_axes)
        return acc.reshape(2 ** n, 2 ** n)

    def compress(self, cutoff: float = 1e-12) -> "MPO":
        """Left-to-right SVD sweep dropping negligible singular values."""
        tensors = [t.copy() for t in self.tensors]
        for i in range(len(tensors) - 1):
            bl, br, s, si = tensors[i].shape
            m = tensors[i].transpose(0, 2, 3, 1).reshape(bl * s * si, br)
            u, sv, vh = np.linalg.svd(m, full_matrices=False)
            keep = max(1, int(np.sum(sv > cutoff * sv[0])))
            u, sv, vh = u[:, :keep], sv[:keep], vh[:keep]
            tensors[i] = u.reshape(bl, s, si, keep).transpose(0, 3, 1, 2)
            carry = sv[:, None] * vh                  # (keep, br)
            # one BLAS product (np.einsum would loop in C over a raw bond
            # of hundreds of terms)
            tensors[i + 1] = np.tensordot(carry, tensors[i + 1], axes=1)
        # right-to-left pass
        for i in range(len(tensors) - 1, 0, -1):
            bl, br, s, si = tensors[i].shape
            m = tensors[i].transpose(0, 1, 2, 3).reshape(bl, br * s * si)
            u, sv, vh = np.linalg.svd(m, full_matrices=False)
            keep = max(1, int(np.sum(sv > cutoff * sv[0])))
            u, sv, vh = u[:, :keep], sv[:keep], vh[:keep]
            tensors[i] = vh.reshape(keep, br, s, si)
            carry = u * sv[None, :]                   # (bl, keep)
            tensors[i - 1] = np.moveaxis(
                np.tensordot(tensors[i - 1], carry, axes=([1], [0])), -1, 1)
        return MPO(tensors)


def mpo_from_paulis(paulis, weights, compress: bool = True,
                    cutoff: float = 1e-12) -> MPO:
    """Exact MPO for sum_k w_k P_k.

    ``compress=False``: the reference's selector construction, bond = the
    number of terms.  ``compress=True``: the same operator from a suffix
    trie (a bond index per distinct suffix of the strings, ``_trie_mpo``),
    then SVD-compressed.  The selector form's left-to-right sweep meets
    (4 bond, K) matrices of rank up to K at the middle cuts (hundreds for
    the 631-term 12q LiH Hamiltonian), whose SVDs dominated its DMRG; the
    trie's bonds are already small where the suffixes are short."""
    paulis = list(paulis)
    if compress:
        return _trie_mpo(paulis, weights).compress(cutoff)
    n = len(paulis[0])
    K = len(paulis)
    w = np.asarray(weights, dtype=np.complex128)
    tensors = []
    for j in range(n):
        bl = 1 if j == 0 else K
        br = 1 if j == n - 1 else K
        t = np.zeros((bl, br, 2, 2), dtype=np.complex128)
        for k in range(K):
            op = _P[paulis[k][j].upper()]
            if n == 1:
                t[0, 0] += w[k] * op
            elif j == 0:
                t[0, k] = w[k] * op
            elif j == n - 1:
                t[k, 0] = op
            else:
                t[k, k] = op
        tensors.append(t)
    return MPO(tensors)


def _trie_mpo(paulis, weights) -> MPO:
    """Exact MPO for sum_k w_k P_k whose bond at the cut before site j
    indexes the distinct suffixes s[j:] of the strings: site 0 sums each
    suffix's weighted first operators, site j maps a suffix to its first
    operator and the suffix after it."""
    n = len(paulis[0])
    strings = [p.upper() for p in paulis]
    ids = [{}] + [{} for _ in range(1, n)]
    for s in strings:
        for j in range(1, n):
            ids[j].setdefault(s[j:], len(ids[j]))
    dims = [1] + [len(ids[j]) for j in range(1, n)] + [1]
    tensors = [np.zeros((dims[j], dims[j + 1], 2, 2), dtype=np.complex128)
               for j in range(n)]
    for s, wk in zip(strings, np.asarray(weights, dtype=np.complex128)):
        right = ids[1].get(s[1:], 0) if n > 1 else 0
        tensors[0][0, right] += wk * _P[s[0]]
    for j in range(1, n):
        for suffix, row in ids[j].items():
            right = ids[j + 1][suffix[1:]] if j + 1 < n else 0
            tensors[j][row, right] = _P[suffix[0]]
    return MPO(tensors)
