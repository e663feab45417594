"""Hamiltonian expectation values.

Pauli-sum form: for a Pauli string P with X-mask x, Y-mask y, Z-mask z
(disjoint little-endian bit masks) and flip mask f = x | y,

    (P psi)[i] = (-i)^{|y|} * (-1)^{popcount(i & (y|z))} * psi[i ^ f]

so <psi|P|psi> is a signed gather-dot.  ``PauliSum`` is the host half
(numpy, built once per problem); ``pauli_expectation`` evaluates it on
torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tensorrl_qas_tpu_torch.utils.bits import parity


@dataclasses.dataclass(frozen=True)
class PauliSum:
    """Static Pauli-sum Hamiltonian in mask form.

    Attributes:
      n_qubits: number of qubits.
      weights: (K,) real coefficients.
      flip: (K,) int32, x|y mask per term (amplitude index XOR).
      sign_mask: (K,) int32, y|z mask per term (phase parity).
      iphase: (K,) complex, (-i)^{#Y} global phase per term.
    """

    n_qubits: int
    weights: np.ndarray
    flip: np.ndarray
    sign_mask: np.ndarray
    iphase: np.ndarray

    @staticmethod
    def from_strings(paulis, weights, n_qubits: int | None = None,
                     char0_is_qubit0: bool = True) -> "PauliSum":
        """Build from strings like 'XXIII'.

        ``char0_is_qubit0=True``: string position j acts on circuit qubit j
        (little-endian bit j), which is how the reference pairs its stored
        Pauli strings with little-endian statevectors
        (``environment_qulacs_TN_notin_agent.py:162``).
        """
        paulis = list(paulis)
        if n_qubits is None:
            n_qubits = len(paulis[0])
        K = len(paulis)
        flip = np.zeros(K, dtype=np.int32)
        sign = np.zeros(K, dtype=np.int32)
        ny = np.zeros(K, dtype=np.int64)
        for k, s in enumerate(paulis):
            if len(s) != n_qubits:
                raise ValueError(f"pauli string {s!r} length != {n_qubits}")
            for j, ch in enumerate(s.upper()):
                q = j if char0_is_qubit0 else (n_qubits - 1 - j)
                if ch == "I":
                    continue
                if ch in "XY":
                    flip[k] |= 1 << q
                if ch in "YZ":
                    sign[k] |= 1 << q
                if ch == "Y":
                    ny[k] += 1
        iphase = (-1j) ** (ny % 4)
        return PauliSum(n_qubits, np.asarray(weights, dtype=np.float64),
                        flip, sign, iphase.astype(np.complex128))

    def to_dense(self) -> np.ndarray:
        """Dense little-endian matrix (n <= ~12 only)."""
        dim = 1 << self.n_qubits
        idx = np.arange(dim)
        H = np.zeros((dim, dim), dtype=np.complex128)
        for k in range(len(self.weights)):
            col = idx ^ self.flip[k]
            v = parity(idx & self.sign_mask[k])
            phase = self.iphase[k] * np.where(v, -1.0, 1.0)
            H[idx, col] += self.weights[k] * phase
        return H

    def identity_weight(self) -> float:
        """Coefficient of the all-identity term (0 if there is none)."""
        ident = (self.flip == 0) & (self.sign_mask == 0)
        return float(np.sum(self.weights[ident].real))

    def tensors(self, device, dtype: torch.dtype = torch.complex128):
        """(weights, flip, sign_mask, iphase) as tensors on ``device``:
        real weights and complex phases in the precision of ``dtype``."""
        rdt = torch.float32 if dtype == torch.complex64 else torch.float64
        return (torch.as_tensor(self.weights, dtype=rdt, device=device),
                torch.as_tensor(self.flip, dtype=torch.int64, device=device),
                torch.as_tensor(self.sign_mask, dtype=torch.int64,
                                device=device),
                torch.as_tensor(self.iphase, dtype=dtype, device=device))


def pauli_expectation(psi, weights, flip, sign_mask, iphase,
                      normalize: bool = True):
    """Real <psi|H|psi> / <psi|psi> for a Pauli sum in mask form.

    psi: (..., 2^n) complex tensor; the Pauli arrays are (K,) tensors from
    ``PauliSum.tensors``.  Returns a real tensor of shape (...).

    ``normalize=True`` (default) evaluates the Rayleigh quotient: float32
    gate application drifts ||psi||^2 by O(1e-6), which at molecular energy
    scales (|E| ~ 73 Ha for 8q H2O) biases the raw bilinear form by
    O(1e-4) Ha; dividing by the norm cancels the drift to first order.
    """
    dim = psi.shape[-1]
    idx = torch.arange(dim, device=psi.device)
    perm = idx[None, :] ^ flip[:, None]                        # (K, D)
    signs = 1.0 - 2.0 * parity(idx[None, :] & sign_mask[:, None])
    permuted = psi[..., perm]                                  # (..., K, D)
    acc = torch.sum(psi.conj()[..., None, :] * signs.to(psi.dtype)
                    * permuted, dim=-1)                        # (..., K)
    e = torch.sum(weights * torch.real(iphase * acc), dim=-1)
    if normalize:
        e = e / torch.sum(psi.real ** 2 + psi.imag ** 2, dim=-1)
    return e
