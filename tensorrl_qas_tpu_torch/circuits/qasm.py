"""Minimal OpenQASM 2 reader/writer.

Covers the gate set used by the reference's shipped warm-start circuits
(``dmrg-to-qc/init_state_circ/*.qasm``: rz/ry/rx/cx only, plus constant-pi
angle expressions like ``-3*pi/2``) and our own emitted circuits.  Replaces
the reference's dependency on qiskit qasm2/qpy serialization
(``dmrg-to-qc/dmrg_to_qc.py:291-301``).
"""

from __future__ import annotations

import math
import re

from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape, tape_from_gate_list

_GATE_RE = re.compile(
    r"^\s*(?P<name>[a-z_][a-z0-9_]*)\s*"
    r"(\((?P<args>[^)]*)\))?\s*"
    r"(?P<qubits>[^;]+);"
)
_QREG_RE = re.compile(r"^\s*qreg\s+(?P<name>\w+)\s*\[\s*(?P<size>\d+)\s*\]\s*;")
_QUBIT_RE = re.compile(r"\w+\[(\d+)\]")

# Safe evaluator for constant angle expressions: digits, pi, + - * / . ( )
_ANGLE_TOKEN_RE = re.compile(r"^[\d\s+\-*/().eE]*$")


def _eval_angle(expr: str) -> float:
    expr = expr.strip()
    cleaned = expr.replace("pi", "")
    if not _ANGLE_TOKEN_RE.match(cleaned):
        raise ValueError(f"unsupported angle expression {expr!r}")
    return float(eval(expr, {"__builtins__": {}}, {"pi": math.pi}))  # noqa: S307


def parse_qasm(text: str):
    """Parse QASM 2 text -> (n_qubits, [(name, [qubits], angle|None), ...])."""
    n_qubits = None
    gates = []
    for raw in text.splitlines():
        line = raw.split("//")[0].strip()
        if not line:
            continue
        if line.startswith(("OPENQASM", "include", "creg", "barrier")):
            continue
        m = _QREG_RE.match(line)
        if m:
            n_qubits = int(m.group("size"))
            continue
        m = _GATE_RE.match(line)
        if not m:
            raise ValueError(f"cannot parse QASM line: {raw!r}")
        name = m.group("name")
        if name == "measure":
            continue
        angle = None
        if m.group("args"):
            angle = _eval_angle(m.group("args"))
        qubits = [int(q) for q in _QUBIT_RE.findall(m.group("qubits"))]
        gates.append((name, qubits, angle))
    if n_qubits is None:
        raise ValueError("no qreg declaration found")
    return n_qubits, gates


def load_qasm_tape(path: str, capacity: int | None = None,
                   rot_capacity: int | None = None) -> GateTape:
    with open(path) as f:
        n, gates = parse_qasm(f.read())
    return tape_from_gate_list(n, gates, capacity, rot_capacity)


def load_circuit_tape(path: str, capacity: int | None = None,
                      rot_capacity: int | None = None) -> GateTape:
    """Load a circuit tape from ``.qasm`` or ``.qpy`` (by extension).

    The reference's envs ingest warm starts from qiskit's binary qpy
    format (``environment_qulacs.py:75-82``); every shipped circuit has a
    qasm twin, but a qpy-only artifact must work drop-in too."""
    if path.endswith(".qpy"):
        from tensorrl_qas_tpu_torch.circuits.qpy_reader import load_qpy_tape

        return load_qpy_tape(path, capacity, rot_capacity)
    return load_qasm_tape(path, capacity, rot_capacity)


_KIND_TO_QASM = {GateKind.RX: "rx", GateKind.RY: "ry", GateKind.RZ: "rz",
                 GateKind.X: "x", GateKind.Y: "y", GateKind.Z: "z",
                 GateKind.H: "h", GateKind.RXX: "rxx", GateKind.RYY: "ryy",
                 GateKind.RZZ: "rzz"}


def dump_qasm(tape: GateTape) -> str:
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";',
             f"qreg q[{tape.n_qubits}];"]
    for g in range(tape.n_gates):
        kind = GateKind(tape.kind[g])
        if kind == GateKind.NONE:
            continue
        if kind == GateKind.CX:
            lines.append(f"cx q[{tape.cq[g]}],q[{tape.tq[g]}];")
        elif kind in (GateKind.RXX, GateKind.RYY, GateKind.RZZ):
            theta = float(tape.angles[tape.angle_slot[g]])
            lines.append(f"{_KIND_TO_QASM[kind]}({theta!r}) "
                         f"q[{tape.cq[g]}],q[{tape.tq[g]}];")
        elif kind in (GateKind.RX, GateKind.RY, GateKind.RZ):
            theta = float(tape.angles[tape.angle_slot[g]])
            lines.append(f"{_KIND_TO_QASM[kind]}({theta!r}) q[{tape.tq[g]}];")
        else:
            lines.append(f"{_KIND_TO_QASM[kind]} q[{tape.tq[g]}];")
    return "\n".join(lines) + "\n"
