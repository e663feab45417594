"""Matrix-product states.

Replaces the reference's quimb MPS usage (``dmrg-to-qc/mps2qc.py``).  Site
tensors have shape (chi_left, 2, chi_right); site 0 corresponds to pauli
char 0 = circuit qubit 0 (see sim/expectation.py for the convention chain).

Statevector conversion uses the little-endian layout: qubit q = bit q, so
site 0 is the *fastest-varying* bit.

Host numpy: the port's own copy of the JAX package's ``tn/mps.py``.
"""

from __future__ import annotations

import numpy as np


class MPS:
    def __init__(self, tensors: list[np.ndarray]):
        self.tensors = tensors

    @property
    def n_sites(self) -> int:
        return len(self.tensors)

    @property
    def bond_dims(self) -> list[int]:
        return [t.shape[2] for t in self.tensors[:-1]]

    @staticmethod
    def random(n: int, chi: int, seed: int = 0, dtype=np.complex128) -> "MPS":
        rng = np.random.default_rng(seed)
        tensors = []
        for i in range(n):
            dl = min(chi, 2 ** i, 2 ** (n - i))
            dr = min(chi, 2 ** (i + 1), 2 ** (n - i - 1))
            t = rng.normal(size=(dl, 2, dr)) + 1j * rng.normal(size=(dl, 2, dr))
            tensors.append(t.astype(dtype))
        mps = MPS(tensors)
        mps.normalize()
        return mps

    @staticmethod
    def from_statevector(psi: np.ndarray, chi: int | None = None,
                         cutoff: float = 0.0) -> "MPS":
        """Exact (or chi-truncated) MPS from a little-endian statevector."""
        n = int(np.log2(psi.size))
        # index bits: site 0 = fastest bit -> reshape with site 0 innermost;
        # we build left-to-right over sites, so bring site order to
        # (site0, site1, ..., site_{n-1}) row-major: that is bit-reversal.
        amps = psi.reshape([2] * n)           # axes: bit n-1 ... bit 0
        amps = np.transpose(amps, axes=list(range(n))[::-1])  # site 0 first
        tensors = []
        chi_l = 1
        rest = amps.reshape(chi_l * 2, -1)
        for i in range(n - 1):
            u, s, vh = np.linalg.svd(rest, full_matrices=False)
            keep = len(s)
            if cutoff > 0.0:
                keep = max(1, int(np.sum(s > cutoff * s[0])))
            if chi is not None:
                keep = min(keep, chi)
            u, s, vh = u[:, :keep], s[:keep], vh[:keep]
            tensors.append(u.reshape(chi_l, 2, keep))
            chi_l = keep
            rest = (s[:, None] * vh).reshape(chi_l * 2, -1)
        tensors.append(rest.reshape(chi_l, 2, 1))
        return MPS(tensors)

    def to_statevector(self) -> np.ndarray:
        acc = self.tensors[0]                  # (1, 2, chi)
        for t in self.tensors[1:]:
            acc = np.einsum("l...r,rsk->l...sk", acc, t)
        vec = acc.reshape(-1)                   # site-0-major order
        n = self.n_sites
        amps = vec.reshape([2] * n)             # axes: site0 ... site_{n-1}
        amps = np.transpose(amps, axes=list(range(n))[::-1])
        return amps.reshape(-1)

    def overlap(self, other: "MPS") -> complex:
        """<self|other>."""
        env = np.ones((1, 1), dtype=np.complex128)
        for a, b in zip(self.tensors, other.tensors):
            env = np.einsum("lk,lsr,ksm->rm", env, a.conj(), b)
        return complex(env[0, 0])

    def norm(self) -> float:
        return float(np.sqrt(np.real(self.overlap(self))))

    def normalize(self) -> None:
        nrm = self.norm()
        self.tensors[0] = self.tensors[0] / nrm

    def left_canonicalize(self) -> None:
        for i in range(self.n_sites - 1):
            t = self.tensors[i]
            dl, d, dr = t.shape
            q, r = np.linalg.qr(t.reshape(dl * d, dr))
            self.tensors[i] = q.reshape(dl, d, q.shape[1])
            self.tensors[i + 1] = np.einsum(
                "ab,bsc->asc", r, self.tensors[i + 1])

    def copy(self) -> "MPS":
        return MPS([t.copy() for t in self.tensors])
