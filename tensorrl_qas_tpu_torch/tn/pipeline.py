"""DMRG -> brickwork PQC -> native-gate QASM: the warm-start pipeline.

Non-interactive equivalent of the reference's stage-1 driver
(``dmrg-to-qc/dmrg_to_qc.py:137-223``): load a Pauli-sum Hamiltonian,
DMRG the ground state at bond dimension chi, fit a brickwork SU(4) circuit
to the MPS by Riemannian overlap maximization, lower every SU(4) brick to
3 CNOTs + rotations with the KAK synthesizer (replacing qiskit transpile),
and verify the emitted circuit's energy round-trips against the fitted
state (the reference's 1e-6 sanity check, ``dmrg_to_qc.py:303-315``).

The port of the JAX package's ``tn/pipeline.py``.  DMRG, the exact-diag
check and KAK run on the host in numpy; the fit and both energies of the
round trip run on ``device`` (the card unless given) in complex128, the
energies on the eager simulator (``sim/apply.py``,
``sim/expectation.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.circuits.qasm import dump_qasm
from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum, pauli_expectation
from tensorrl_qas_tpu_torch.synth.kak import (
    decompose_su4,
    decompose_su4_pauli,
)
from tensorrl_qas_tpu_torch.tn.circuit_fit import (
    DTYPE,
    circuit_state,
    fit_mps_to_circuit,
)
from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg, gs_exact_diag
from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis

log = logging.getLogger(__name__)

CHEMICAL_ACCURACY = 1.6e-3  # Ha (reference mps2qc.py:147)
ROUND_TRIP_TOL = 1e-6       # Ha (reference dmrg_to_qc.py:303-315)


@dataclasses.dataclass
class WarmStartResult:
    tape: GateTape
    qasm: str
    e_dmrg: float
    e_circuit: float
    e_exact: float | None
    overlap: float
    cnot_count: int
    rotation_count: int
    depth: int
    # the fitted SU(4) circuit's energy, which e_circuit round-trips to
    e_fit: float = float("nan")
    # wall seconds of each stage ("dmrg_s", "exact_s", "fit_s", "synth_s",
    # "round_trip_s") and, on a card, "fit_device_ms": the fit's span on
    # the device's stream between two CUDA events
    timings: dict = dataclasses.field(default_factory=dict)


def su4_circuit_to_tape(params, pairs, n_qubits: int,
                        atol: float = 5e-7, basis: str = "cnot") -> GateTape:
    """Lower a list of SU(4) gates to a native-gate tape via KAK.

    ``basis='cnot'`` emits 3 CNOTs + rotations per brick; ``'su4'`` emits
    RXX/RYY/RZZ + local rotations (the reference's ``SU4`` stage-1 flag,
    ``dmrg-to-qc/dmrg_to_qc.py:203-206``)."""
    lower = decompose_su4 if basis == "cnot" else decompose_su4_pauli
    two_q = {"rxx": GateKind.RXX, "ryy": GateKind.RYY, "rzz": GateKind.RZZ}
    gates = []
    for u, (q_hi, q_lo) in zip(np.asarray(params), pairs):
        gs, _ = lower(u, q0=q_lo, q1=q_hi, atol=atol)
        gates.extend(gs)
    n_rot = sum(1 for g in gates if g[0] != "cx")
    tape = GateTape(n_qubits, max(len(gates), 1), max(n_rot, 1))
    for g in gates:
        if g[0] == "cx":
            tape.add_cx(g[1], g[2])
        elif g[0] in two_q:
            tape.add(two_q[g[0]], target=g[2], control=g[1], angle=g[3])
        else:
            tape.add({"rx": GateKind.RX, "ry": GateKind.RY,
                      "rz": GateKind.RZ}[g[0]], target=g[1], angle=g[2])
    return tape


def tape_energy(tape: GateTape, ps: PauliSum, device=None) -> float:
    """<H> of a tape applied to |0...0> on the eager simulator, in
    complex128 on ``device`` (the card unless given)."""
    dev = as_device(device)
    psi = apply_tape(zero_state(tape.n_qubits, DTYPE, dev), *tape.arrays(),
                     torch.as_tensor(tape.x0(), device=dev))
    return float(pauli_expectation(psi, *ps.tensors(dev, DTYPE)))


def build_warmstart(paulis, weights, chi: int, n_layers: int,
                    maxiter: int = 2000, lr: float = 1e-2, seed: int = 0,
                    dmrg_sweeps: int = 6, check_exact: bool = True,
                    basis: str = "cnot", device=None) -> WarmStartResult:
    dev = as_device(device)
    n = len(paulis[0])
    ps = PauliSum.from_strings(paulis, weights, n)
    timings = {}

    def clock(key, device_ms=None):
        return _timed(timings, key, dev, device_ms)

    with clock("dmrg_s"):
        mpo = mpo_from_paulis(paulis, weights)
        e_dmrg, mps = gs_dmrg(mpo, chi=chi, max_sweeps=dmrg_sweeps,
                              seed=seed)

    e_exact = None
    if check_exact and n <= 12:
        with clock("exact_s"):
            e_exact, _ = gs_exact_diag(ps.to_dense())
        gap = e_dmrg - e_exact
        log.info("DMRG(chi=%d) E=%.8f, exact E=%.8f, gap=%.2e (%schemical "
                 "accuracy)", chi, e_dmrg, e_exact, gap,
                 "within " if gap < CHEMICAL_ACCURACY else "above ")

    with clock("fit_s", device_ms="fit_device_ms"):
        params, pairs, overlap, _ = fit_mps_to_circuit(
            mps, n_layers=n_layers, maxiter=maxiter, lr=lr, seed=seed,
            device=dev)
    log.info("circuit fit: %d SU(4) bricks, overlap |<qc|mps>| = %.6f",
             len(pairs), overlap)

    with clock("synth_s"):
        tape = su4_circuit_to_tape(params.cpu().numpy(), pairs, n,
                                   basis=basis)
    with clock("round_trip_s"):
        # energy of the fitted SU(4) circuit (pre-synthesis) and of the
        # synthesized tape
        with torch.no_grad():
            psi_fit = circuit_state(params, pairs, n)
            e_fit = float(pauli_expectation(psi_fit,
                                            *ps.tensors(dev, DTYPE)))
        e_circ = tape_energy(tape, ps, dev)
    if abs(e_circ - e_fit) > ROUND_TRIP_TOL:
        raise RuntimeError(
            f"energy round-trip failed: fit {e_fit:.9f} vs synthesized "
            f"{e_circ:.9f} (reference tolerance 1e-6)")

    return WarmStartResult(
        tape=tape, qasm=dump_qasm(tape), e_dmrg=e_dmrg, e_circuit=e_circ,
        e_exact=e_exact, overlap=overlap, cnot_count=tape.cnot_count,
        rotation_count=tape.rotation_count, depth=tape.depth(),
        e_fit=e_fit, timings=timings)


@contextlib.contextmanager
def _timed(timings: dict, key: str, device, device_ms: str | None = None):
    """The block's wall seconds into ``timings[key]`` (a card synchronized
    at both ends); with ``device_ms`` also its span on the card's stream
    between two CUDA events, in ms."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    yield
    if cuda:
        events[1].record()
        torch.cuda.synchronize(device)
        if device_ms:
            timings[device_ms] = events[0].elapsed_time(events[1])
    timings[key] = time.perf_counter() - t0
