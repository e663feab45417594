"""Bit-twiddling helpers for statevector index arithmetic."""

def parity(v):
    """Popcount parity of each element of an integer array (<= 32 bits)."""
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


def bit(v, b):
    """Bit ``b`` of each element (b may be a traced scalar)."""
    return (v >> b) & 1


def bit_reversal_permutation(n_qubits: int):
    """Index permutation that reverses qubit order (endianness flip).

    ``psi_le = psi_be[perm]`` where bit 0 of the little-endian index equals
    bit n-1 of the big-endian index.  Used to convert the reference's stored
    dense Hamiltonians (kron order: pauli-string char 0 = most significant
    bit, ``dmrg-to-qc/heisenberg_model.py:22-72``) into the little-endian
    convention; the reference does the same via qiskit's
    ``Operator(...).reverse_qargs()``
    (``environment_qulacs_TN_notin_agent.py:162``).
    """
    import numpy as np

    idx = np.arange(1 << n_qubits)
    out = np.zeros_like(idx)
    for b in range(n_qubits):
        out |= ((idx >> b) & 1) << (n_qubits - 1 - b)
    return out
