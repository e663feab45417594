"""Gate tapes: the fixed-shape circuit encoding.

A tape is a struct-of-arrays encoding of a gate sequence, padded to a static
capacity so that one kernel launch shape (`sim.apply_tape`) serves *every*
circuit the RL agent can build.  This replaces the reference's per-step
rebuild of a qulacs ``ParametricQuantumCircuit``
(``environments/VQAs/VQE_qulacs.py:12-44``), which paid a Python->C++
boundary per gate per optimizer evaluation.

Conventions
-----------
- little-endian: qubit ``q`` is bit ``q`` of the statevector index (the
  qiskit ``Statevector`` convention).
- rotation sign: ``RX(t) = exp(-i t X / 2)`` etc (qiskit convention; qulacs
  uses the opposite sign, which is why the reference negates angles when
  embedding qiskit circuits, ``environments/environment_qulacs.py:305``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class GateKind(enum.IntEnum):
    NONE = 0
    RX = 1
    RY = 2
    RZ = 3
    CX = 4
    X = 5
    Y = 6
    Z = 7
    H = 8
    # two-qubit Pauli rotations (SU(4) action-set variant,
    # reference environments/VQAs/VQE_qulacs_su4.py): gate acts on
    # (target, control-slot-as-second-qubit)
    RXX = 9
    RYY = 10
    RZZ = 11


ROTATION_KINDS = (GateKind.RX, GateKind.RY, GateKind.RZ,
                  GateKind.RXX, GateKind.RYY, GateKind.RZZ)
TWO_QUBIT_ROTATIONS = (GateKind.RXX, GateKind.RYY, GateKind.RZZ)
_QASM_NAMES = {"rx": GateKind.RX, "ry": GateKind.RY, "rz": GateKind.RZ,
               "x": GateKind.X, "y": GateKind.Y, "z": GateKind.Z,
               "h": GateKind.H}
_QASM_2Q_NAMES = {"rxx": GateKind.RXX, "ryy": GateKind.RYY,
                  "rzz": GateKind.RZZ}


@dataclasses.dataclass
class GateTape:
    """Mutable host-side tape builder (numpy); convert with `.arrays()`."""

    n_qubits: int
    capacity: int
    rot_capacity: int

    def __post_init__(self):
        c = self.capacity
        self.kind = np.zeros(c, dtype=np.int32)
        self.tq = np.zeros(c, dtype=np.int32)
        self.cq = np.full(c, -1, dtype=np.int32)
        # angle_slot maps a rotation gate to its index in the flat angle
        # vector handed to the optimizer; -1 for non-parametric gates.
        self.angle_slot = np.full(c, -1, dtype=np.int32)
        self.angles = np.zeros(self.rot_capacity, dtype=np.float64)
        self.n_gates = 0
        self.n_rots = 0

    def add(self, kind: GateKind, target: int, control: int = -1,
            angle: float = 0.0) -> None:
        g = self.n_gates
        if g >= self.capacity:
            raise ValueError(f"tape capacity {self.capacity} exceeded")
        self.kind[g] = int(kind)
        self.tq[g] = target
        self.cq[g] = control
        if kind in ROTATION_KINDS:
            if self.n_rots >= self.rot_capacity:
                raise ValueError(f"rotation capacity {self.rot_capacity} exceeded")
            self.angle_slot[g] = self.n_rots
            self.angles[self.n_rots] = angle
            self.n_rots += 1
        self.n_gates = g + 1

    def add_cx(self, control: int, target: int) -> None:
        self.add(GateKind.CX, target=target, control=control)

    # -- views ------------------------------------------------------------

    def arrays(self):
        """(kind, tq, cq, angle_slot) padded numpy arrays (static shapes)."""
        return self.kind, self.tq, self.cq, self.angle_slot

    def x0(self) -> np.ndarray:
        """Initial angle vector, padded to rot_capacity."""
        return self.angles.copy()

    def gate_count(self, kind: GateKind) -> int:
        return int(np.sum(self.kind[: self.n_gates] == int(kind)))

    @property
    def cnot_count(self) -> int:
        return self.gate_count(GateKind.CX)

    @property
    def rotation_count(self) -> int:
        return self.n_rots

    def depth(self) -> int:
        """Circuit depth over the gates present (moments per qubit)."""
        level = np.zeros(self.n_qubits, dtype=np.int64)
        for g in range(self.n_gates):
            k = self.kind[g]
            if k == GateKind.NONE:
                continue
            if self.cq[g] >= 0:
                m = max(level[self.tq[g]], level[self.cq[g]]) + 1
                level[self.tq[g]] = m
                level[self.cq[g]] = m
            else:
                level[self.tq[g]] += 1
        return int(level.max(initial=0))


def trim_to_depth(tape: GateTape, max_depth: int) -> GateTape:
    """Truncate a tape to its first ``max_depth`` depth layers.

    Counterpart of the reference's ``trimmed_circuit``
    (``dmrg-to-qc/dmrg_to_qc.py:93-123``), which rebuilds a qiskit circuit
    from the first ``max_depth`` DAG layers.  Here a gate's layer is the
    greedy moment assignment used by :meth:`GateTape.depth` (identical to
    DAG layering for a serial gate list): gates whose moment exceeds
    ``max_depth`` are dropped; everything earlier is kept in order.
    """
    out = GateTape(tape.n_qubits, tape.capacity, tape.rot_capacity)
    # layer every gate of the ORIGINAL tape first: a successor of a dropped
    # gate must itself be dropped (it lives in a later DAG layer), so the
    # kept set is exactly {gates with original moment <= max_depth}.
    level = np.zeros(tape.n_qubits, dtype=np.int64)
    for g in range(tape.n_gates):
        k = GateKind(tape.kind[g])
        if k == GateKind.NONE:
            continue
        qubits = [int(tape.tq[g])]
        if tape.cq[g] >= 0:
            qubits.append(int(tape.cq[g]))
        moment = max(level[q] for q in qubits) + 1
        for q in qubits:
            level[q] = moment
        if moment > max_depth:
            continue
        angle = (float(tape.angles[tape.angle_slot[g]])
                 if tape.angle_slot[g] >= 0 else 0.0)
        out.add(k, target=int(tape.tq[g]),
                control=int(tape.cq[g]), angle=angle)
    return out


def tape_from_gate_list(n_qubits: int, gates, capacity: int | None = None,
                        rot_capacity: int | None = None) -> GateTape:
    """Build a tape from ``(name, qubits, angle)`` tuples (e.g. QASM import)."""
    gates = list(gates)
    n_rot = sum(1 for g in gates
                if g[0] in ("rx", "ry", "rz", "rxx", "ryy", "rzz"))
    tape = GateTape(n_qubits,
                    capacity if capacity is not None else max(len(gates), 1),
                    rot_capacity if rot_capacity is not None else max(n_rot, 1))
    for name, qubits, angle in gates:
        if name == "cx":
            tape.add_cx(qubits[0], qubits[1])
        elif name in _QASM_2Q_NAMES:
            tape.add(_QASM_2Q_NAMES[name], target=qubits[1],
                     control=qubits[0], angle=angle or 0.0)
        elif name in _QASM_NAMES:
            tape.add(_QASM_NAMES[name], target=qubits[0], angle=angle or 0.0)
        else:
            raise ValueError(f"unsupported gate {name!r}")
    return tape
