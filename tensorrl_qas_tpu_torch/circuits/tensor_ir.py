"""State-tensor circuit IR.

The RL observation *is* the circuit: a ``(num_layers, n+6, n)`` array
(reference: ``environments/environment_qulacs.py:281``):

- rows ``0..n-1``:   CNOT one-hots, ``state[l, targ, ctrl] = 1``
- rows ``n..n+2``:   rotation one-hots, ``state[l, n+axis, qubit] = 1``
  with axis 0/1/2 = X/Y/Z
- rows ``n+3..n+5``: rotation angles, ``state[l, n+3+axis, qubit]``

Gate order within a layer (must match the reference simulator,
``environments/VQAs/VQE_qulacs.py:12-44``): all CNOTs in row-major
``(targ, ctrl)`` order, then all rotations in row-major ``(axis, qubit)``
order.  Angles are stored in qiskit rotation-sign convention (see
circuits/tape.py); the reference's mirror/negate dance when embedding TN
circuits (``environment_qulacs.py:285-328``) is unnecessary under a single
little-endian convention.
"""

from __future__ import annotations

import numpy as np

from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape


class StateTensor:
    """Host-side wrapper around the (L, n+6, n) circuit encoding."""

    def __init__(self, num_layers: int, n_qubits: int,
                 data: np.ndarray | None = None):
        self.num_layers = num_layers
        self.n = n_qubits
        if data is None:
            data = np.zeros((num_layers, n_qubits + 6, n_qubits), dtype=np.float64)
        self.data = data

    def copy(self) -> "StateTensor":
        return StateTensor(self.num_layers, self.n, self.data.copy())

    # -- gate placement ----------------------------------------------------

    def place_cnot(self, layer: int, ctrl: int, targ: int) -> None:
        self.data[layer, targ, ctrl] = 1.0

    def place_rotation(self, layer: int, axis: int, qubit: int,
                       angle: float = 0.0) -> None:
        """axis: 0/1/2 = X/Y/Z."""
        self.data[layer, self.n + axis, qubit] = 1.0
        self.data[layer, self.n + 3 + axis, qubit] = angle

    # -- views ---------------------------------------------------------------

    @property
    def thetas(self) -> np.ndarray:
        """(L, 3, n) angle block."""
        return self.data[:, self.n + 3:, :]

    @thetas.setter
    def thetas(self, value: np.ndarray) -> None:
        self.data[:, self.n + 3:, :] = value

    def rot_positions(self):
        """Indices of rotation one-hots in reference scan order.

        Returns (layers, axes, qubits) such that zipping them enumerates
        rotations exactly like ``(state[:, n:n+3] == 1).nonzero()``
        (``environment_qulacs.py:420``) — row-major over (layer, axis, qubit).
        """
        return np.nonzero(self.data[:, self.n:self.n + 3, :] == 1)

    def rot_angles(self) -> np.ndarray:
        """Flat angle vector at rotation positions in scan order."""
        ls, axs, qs = self.rot_positions()
        return self.thetas[ls, axs, qs]

    def set_rot_angles(self, angles: np.ndarray) -> None:
        ls, axs, qs = self.rot_positions()
        self.data[ls, self.n + 3 + axs, qs] = angles

    def observation(self, with_angles: bool) -> np.ndarray:
        """Flattened observation, optionally stripping the angle block."""
        if with_angles:
            return self.data.reshape(-1).astype(np.float32)
        return self.data[:, : self.n + 3].reshape(-1).astype(np.float32)

    # -- conversion ----------------------------------------------------------

    def to_tape(self, capacity: int, rot_capacity: int) -> GateTape:
        """Lower to a gate tape in reference evaluation order.

        Fully vectorized (this runs once per env step per replica, so the
        per-layer python loop version was the host bottleneck of the
        vectorized trainer): one nonzero scan for CNOTs and one for
        rotations, merged by (layer, cnots-first) with a stable sort —
        which reproduces the reference's per-layer CNOTs-then-rotations
        order (``environments/VQAs/VQE_qulacs.py:12-44``).
        """
        n = self.n
        ls_c, targs, ctrls = np.nonzero(self.data[:, :n] == 1)
        ls_r, axes, qubits = np.nonzero(self.data[:, n:n + 3] == 1)
        n_cx, n_rot = len(ls_c), len(ls_r)
        n_gates = n_cx + n_rot
        if n_gates > capacity or n_rot > rot_capacity:
            raise ValueError("tape capacity exceeded")

        tape = GateTape(n, capacity, rot_capacity)
        if n_gates:
            keys = np.concatenate([2 * ls_c, 2 * ls_r + 1])
            kinds = np.concatenate([
                np.full(n_cx, int(GateKind.CX), np.int32),
                (int(GateKind.RX) + axes).astype(np.int32)])
            tqs = np.concatenate([targs, qubits]).astype(np.int32)
            cqs = np.concatenate([ctrls,
                                  np.full(n_rot, -1)]).astype(np.int32)
            slots = np.concatenate([np.full(n_cx, -1),
                                    np.arange(n_rot)]).astype(np.int32)
            order = np.argsort(keys, kind="stable")
            tape.kind[:n_gates] = kinds[order]
            tape.tq[:n_gates] = tqs[order]
            tape.cq[:n_gates] = cqs[order]
            tape.angle_slot[:n_gates] = slots[order]
            tape.angles[:n_rot] = self.data[ls_r, n + 3 + axes, qubits]
            tape.n_gates = n_gates
            tape.n_rots = n_rot
        return tape

    def gate_counts(self):
        """(cnots, rotations, depth) summary of the encoded circuit."""
        n = self.n
        cnots = int(np.sum(self.data[:, :n] == 1))
        rots = int(np.sum(self.data[:, n:n + 3] == 1))
        level = np.zeros(n, dtype=np.int64)
        for l in range(self.num_layers):
            layer = self.data[l]
            targs, ctrls = np.nonzero(layer[:n] == 1)
            for t, c in zip(targs, ctrls):
                m = max(level[t], level[c]) + 1
                level[t] = m
                level[c] = m
            axes, qubits = np.nonzero(layer[n:n + 3] == 1)
            for _, q in zip(axes, qubits):
                level[q] += 1
        return cnots, rots, int(level.max(initial=0))


class SU4StateTensor(StateTensor):
    """SU(4)-gate-set state tensor: ``(L, 6n+6, n)``.

    Row layout per layer (reference ``environments/VQAs/VQE_qulacs_su4.py:
    15-48``): rows ``0..n-1`` XX one-hots ``[targ, ctrl]``, ``n..2n-1`` YY,
    ``2n..3n-1`` ZZ, ``3n..3n+2`` 1q rotation one-hots, then the matching
    angle rows ``3n+3..4n+2`` XX, ``4n+3..5n+2`` YY, ``5n+3..6n+2`` ZZ,
    ``6n+3..6n+5`` 1q.  Gate order within a layer follows the reference's
    construct_ansatz scan: XX (row-major targ, ctrl), YY, ZZ, then 1q
    rotations (axis, qubit).  Every gate is parametric.
    """

    def __init__(self, num_layers: int, n_qubits: int,
                 data: np.ndarray | None = None):
        self.num_layers = num_layers
        self.n = n_qubits
        if data is None:
            data = np.zeros((num_layers, 6 * n_qubits + 6, n_qubits),
                            dtype=np.float64)
        self.data = data

    def copy(self) -> "SU4StateTensor":
        return SU4StateTensor(self.num_layers, self.n, self.data.copy())

    def place_cnot(self, layer: int, ctrl: int, targ: int) -> None:
        raise ValueError("su4 gate set has no CNOT; use place_two_rotation")

    def place_two_rotation(self, layer: int, axis: int, ctrl: int, targ: int,
                           angle: float = 0.0) -> None:
        """axis: 0/1/2 = XX/YY/ZZ."""
        n = self.n
        self.data[layer, axis * n + targ, ctrl] = 1.0
        self.data[layer, (3 + axis) * n + 3 + targ, ctrl] = angle

    def place_rotation(self, layer: int, axis: int, qubit: int,
                       angle: float = 0.0) -> None:
        n = self.n
        self.data[layer, 3 * n + axis, qubit] = 1.0
        self.data[layer, 6 * n + 3 + axis, qubit] = angle

    @property
    def thetas(self) -> np.ndarray:
        """(L, 3n+3, n) angle block."""
        return self.data[:, 3 * self.n + 3:, :]

    @thetas.setter
    def thetas(self, value: np.ndarray) -> None:
        self.data[:, 3 * self.n + 3:, :] = value

    def rot_positions(self):
        """One-hot indices over the whole (2q + 1q) parametric block in
        reference scan order: row-major over (layer, row, col) of rows
        ``0..3n+2`` — XX before YY before ZZ before 1q within each layer."""
        return np.nonzero(self.data[:, : 3 * self.n + 3, :] == 1)

    def rot_angles(self) -> np.ndarray:
        ls, rows, cols = self.rot_positions()
        return self.data[ls, 3 * self.n + 3 + rows, cols]

    def set_rot_angles(self, angles: np.ndarray) -> None:
        ls, rows, cols = self.rot_positions()
        self.data[ls, 3 * self.n + 3 + rows, cols] = angles

    def observation(self, with_angles: bool) -> np.ndarray:
        if with_angles:
            return self.data.reshape(-1).astype(np.float32)
        return self.data[:, : 3 * self.n + 3].reshape(-1).astype(np.float32)

    def to_tape(self, capacity: int, rot_capacity: int) -> GateTape:
        n = self.n
        ls, rows, cols = self.rot_positions()
        n_gates = len(ls)
        if n_gates > capacity or n_gates > rot_capacity:
            raise ValueError("tape capacity exceeded")
        tape = GateTape(n, capacity, rot_capacity)
        if n_gates:
            is_2q = rows < 3 * n
            axis = np.where(is_2q, rows // n, rows - 3 * n)
            targ = np.where(is_2q, rows % n, cols)
            ctrl = np.where(is_2q, cols, -1)
            kinds = np.where(is_2q, int(GateKind.RXX) + axis,
                             int(GateKind.RX) + axis).astype(np.int32)
            tape.kind[:n_gates] = kinds
            tape.tq[:n_gates] = targ.astype(np.int32)
            tape.cq[:n_gates] = ctrl.astype(np.int32)
            tape.angle_slot[:n_gates] = np.arange(n_gates, dtype=np.int32)
            tape.angles[:n_gates] = self.data[ls, 3 * n + 3 + rows, cols]
            tape.n_gates = n_gates
            tape.n_rots = n_gates
        return tape

    def gate_counts(self):
        """(two_qubit_rots, rotations_total, depth)."""
        n = self.n
        two_q = int(np.sum(self.data[:, : 3 * n] == 1))
        rots = int(np.sum(self.data[:, : 3 * n + 3] == 1))
        level = np.zeros(n, dtype=np.int64)
        for l in range(self.num_layers):
            layer = self.data[l]
            rows, cols = np.nonzero(layer[: 3 * n] == 1)
            for r, c in zip(rows % n, cols):
                m = max(level[r], level[c]) + 1
                level[r] = m
                level[c] = m
            _, qubits = np.nonzero(layer[3 * n: 3 * n + 3] == 1)
            for q in qubits:
                level[q] += 1
        return two_q, rots, int(level.max(initial=0))


def embed_tape(state: StateTensor, tape: GateTape, zero_params: bool = False,
               layer_offset: int = 0) -> int:
    """Embed a warm-start circuit tape into the leading layers of ``state``.

    Replacement for the reference's fragile qiskit-DAG/qargs
    string parsing re-embedding (``environment_qulacs.py:285-328``).  Gates
    are packed depth-wise (one moment per state-tensor layer).  Returns the
    number of layers consumed (= circuit depth).

    ``zero_params=True`` keeps the structure but zeroes the angles
    (StructureRL; reference ``environment_qulacs.py:299-302``).
    """
    n = state.n
    level = np.zeros(n, dtype=np.int64)
    axis_of = {GateKind.RX: 0, GateKind.RY: 1, GateKind.RZ: 2}
    axis2_of = {GateKind.RXX: 0, GateKind.RYY: 1, GateKind.RZZ: 2}
    for g in range(tape.n_gates):
        kind = GateKind(tape.kind[g])
        if kind == GateKind.CX:
            c, t = int(tape.cq[g]), int(tape.tq[g])
            m = max(level[c], level[t])
            state.place_cnot(layer_offset + m, c, t)
            level[c] = m + 1
            level[t] = m + 1
        elif kind in axis2_of:
            if not isinstance(state, SU4StateTensor):
                raise ValueError(f"cannot embed {kind} into a CNOT-set state")
            c, t = int(tape.cq[g]), int(tape.tq[g])
            angle = (0.0 if zero_params
                     else float(tape.angles[tape.angle_slot[g]]))
            m = max(level[c], level[t])
            state.place_two_rotation(layer_offset + m, axis2_of[kind], c, t,
                                     angle)
            level[c] = m + 1
            level[t] = m + 1
        elif kind in axis_of:
            q = int(tape.tq[g])
            angle = 0.0 if zero_params else float(tape.angles[tape.angle_slot[g]])
            state.place_rotation(layer_offset + level[q], axis_of[kind], q, angle)
            level[q] += 1
        elif kind != GateKind.NONE:
            raise ValueError(f"cannot embed gate kind {kind}")
    return int(level.max(initial=0))
