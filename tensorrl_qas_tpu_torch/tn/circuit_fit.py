"""Brickwork circuit-TN fitting: compile an MPS into a shallow PQC.

The reference fits a brickwork of SU(4) gates to the DMRG MPS by minimizing
1 - |<qc(params)|mps>| with quimb TN contraction + jitted JAX gradients
(``dmrg-to-qc/mps2qc.py:242-339``, ``tnqc_ansatze.py:46-98``).  As in the
JAX package's ``tn/circuit_fit.py``, of which this is the port, the overlap
is computed *exactly* on the statevector for n <= ~22: the circuit is a
chain of 2-qubit contractions on static axes, differentiated by torch
autograd, and the Stiefel-Adam loop runs on the parameters' device (on the
card, one CUDA graph replayed per iteration: ``tn/stiefel.py``).

Stage 1 keeps complex128 on every device: the target, the state and the
unitaries are complex128 whatever the trainer's dtype policy.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.tn.mps import MPS
from tensorrl_qas_tpu_torch.tn.stiefel import StiefelAdam

DTYPE = torch.complex128


def brickwork_pairs(n: int, n_layers: int) -> list[tuple[int, int]]:
    """(q_hi, q_lo) pairs, even/odd brick pattern (reference
    ``tnqc_ansatze.py:46-98``: layer 0 on (0,1),(2,3),...; layer 1 on
    (1,2),(3,4),...)."""
    pairs = []
    for layer in range(n_layers):
        start = layer % 2
        for i in range(start, n - 1, 2):
            pairs.append((i + 1, i))
    return pairs


def apply_2q(psi, u, q_hi: int, q_lo: int, n: int):
    """Apply a 4x4 unitary (basis 2*b_hi + b_lo) on static qubits."""
    ax_hi, ax_lo = n - 1 - q_hi, n - 1 - q_lo
    t = torch.movedim(psi.reshape((2,) * n), (ax_hi, ax_lo), (0, 1))
    out = (u.to(psi.dtype) @ t.reshape(4, -1)).reshape(t.shape)
    return torch.movedim(out, (0, 1), (ax_hi, ax_lo)).reshape(-1)


# bricks on disjoint pairs applied as one product: the Kronecker product
# of up to this many 4x4 unitaries, (4^k, 4^k) x (4^k, 2^n / 4^k)
BRICKS_PER_PRODUCT = 3


def _groups(pairs):
    """Runs of consecutive bricks on disjoint pairs (which commute), at
    most BRICKS_PER_PRODUCT a run: [(first brick, pairs)]."""
    groups = []
    for g, pair in enumerate(pairs):
        if groups:
            first, run = groups[-1]
            used = {q for p in run for q in p}
            if len(run) < BRICKS_PER_PRODUCT and not used & set(pair):
                run.append(pair)
                continue
        groups.append((g, [pair]))
    return groups


def _chain(params, pairs, n: int, dtype=DTYPE):
    """The bricks applied to |0...0>, a run of bricks on disjoint pairs
    (``_groups``) at a time: the run's qubits moved to the front of the
    (2,) * n state (one copy) and one product with the Kronecker product
    of its bricks, the result left in that axis order: fewer passes
    over the state, and products that cuBLAS runs nearer the memory rate
    than a brick's skinny (4, 4) x (4, 2^(n-2)) one (``python3
    chip_smoke.py --warm-start`` times both at 20 qubits).  -> (the state
    as a flat vector, the qubit on each axis)."""
    psi = torch.zeros((2,) * n, dtype=dtype, device=params.device)
    # a fill with the scalar as the kernel's argument: ``psi[0] = 1.0``
    # would copy a host tensor, which a CUDA graph capture refuses
    psi.view(-1).narrow(0, 0, 1).fill_(1.0)
    order = _chain_order([], n)
    for first, run in _groups(pairs):
        qubits = [q for pair in run for q in pair]
        u = params[first].to(dtype)
        for k in range(1, len(run)):
            u = torch.kron(u, params[first + k].to(dtype))
        t = torch.movedim(psi, [order.index(q) for q in qubits],
                          list(range(len(qubits))))
        psi = (u @ t.reshape(u.shape[0], -1)).reshape((2,) * n)
        order = _chain_order(run, n, order)
    return psi.reshape(-1), order


def _chain_order(pairs, n: int, order=None):
    """The qubit on each axis after the runs of ``_groups(pairs)`` (from
    ``order``, by default the little-endian one: axis i holds qubit
    n - 1 - i)."""
    order = [n - 1 - axis for axis in range(n)] if order is None else order
    for _, run in _groups(pairs):
        qubits = [q for pair in run for q in pair]
        order = qubits + [q for q in order if q not in qubits]
    return order


def _to_order(vec, order, n: int):
    """A little-endian 2^n vector with its axes in ``order`` (axis i
    holds qubit order[i]), flat."""
    return vec.reshape((2,) * n).permute([n - 1 - q for q in order]
                                         ).reshape(-1)


def circuit_state(params, pairs, n: int, dtype=DTYPE):
    """|psi(params)> = prod_g U_g |0...0>, on the parameters' device."""
    psi, order = _chain(params, pairs, n, dtype)
    back = [order.index(n - 1 - axis) for axis in range(n)]
    return psi.reshape((2,) * n).permute(back).reshape(-1)


def initial_params(n_gates: int, seed: int = 0, init: str = "identity"):
    """The fit's starting unitaries (host numpy, complex128), drawn as the
    JAX package draws them: identity bricks with a tiny unitary jitter from
    ``default_rng(seed)`` through ``scipy.linalg.expm``, or Haar bricks from
    ``unitary_group.rvs``."""
    if init == "identity":
        from scipy.linalg import expm

        params0 = np.tile(np.eye(4, dtype=np.complex128), (n_gates, 1, 1))
        # tiny unitary jitter so the identity saddle is left immediately
        rng = np.random.default_rng(seed)
        h = (rng.normal(size=(n_gates, 4, 4))
             + 1j * rng.normal(size=(n_gates, 4, 4)))
        h = (h + np.conj(np.swapaxes(h, 1, 2))) / 2
        jitter = np.stack([expm(1j * 1e-2 * hk) for hk in h])
        return params0 @ jitter
    if init == "haar":
        from scipy.stats import unitary_group

        return np.asarray(unitary_group.rvs(
            4, size=n_gates, random_state=seed)).reshape(n_gates, 4, 4)
    raise ValueError(init)


def target_state(mps: MPS, device=None):
    """The MPS's normalized statevector, built once on the host and moved
    to ``device`` in complex128."""
    target = mps.to_statevector()
    return torch.as_tensor(target / np.linalg.norm(target), dtype=DTYPE,
                           device=as_device(device))


def overlap_loss(target, pairs, n: int):
    """1 - |<target|psi(params)>| as a function of the (G, 4, 4) bricks;
    the target is put once into the axis order in which the brick chain
    leaves the state."""
    target = _to_order(target, _chain_order(pairs, n), n)

    def loss_fn(params):
        psi, _ = _chain(params, pairs, n, dtype=target.dtype)
        return 1.0 - torch.abs(torch.vdot(target, psi))
    return loss_fn


def fit_mps_to_circuit(mps: MPS, n_layers: int, maxiter: int = 2000,
                       lr: float = 1e-2, seed: int = 0,
                       init: str = "identity", device=None,
                       graph: bool = True):
    """Fit a brickwork PQC to the target MPS.

    Returns (params (G,4,4) complex128 on ``device`` (the card unless
    given), pairs, overlap, loss_history).  ``init='identity'`` matches the reference's
    identity-initialized bricks (``tnqc_ansatze.py:60``); 'haar' matches
    ``mps2qc.py:299-300``.  The target statevector is built once on the
    host and moved to ``device``.
    """
    n = mps.n_sites
    target = target_state(mps, device)
    pairs = brickwork_pairs(n, n_layers)
    params0 = torch.as_tensor(initial_params(len(pairs), seed, init),
                              dtype=DTYPE, device=target.device)
    loss_fn = overlap_loss(target, pairs, n)
    opt = StiefelAdam(lr=lr, maxiter=maxiter, graph=graph)
    params = opt.minimize(loss_fn, params0)
    with torch.no_grad():
        overlap = 1.0 - float(loss_fn(params))
    return params, pairs, overlap, opt.loss_history
