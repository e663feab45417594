"""Minimal QPY (qiskit binary circuit format) reader.

The reference loads its TN warm-start circuits from ``.qpy`` files
(reference ``environments/environment_qulacs.py:75-82``); every
shipped circuit also has a ``.qasm`` twin, but drop-in compatibility with
a qpy-only artifact needs a reader.  This is a standalone parser (no
qiskit dependency) covering exactly the subset the warm-start circuits
use — flat gate-only circuits over one quantum register with the gate set
{rx, ry, rz, cx, rxx, ryy, rzz} and plain float parameters — for QPY
versions 10-14 (the shipped files span qiskit 0.46 / 1.1 / 2.0).

Format notes (verified byte-by-byte against the 13 shipped files):
  * all struct fields are big-endian; instruction parameter floats are
    little-endian raw doubles; the global phase double is big-endian
  * the circuit header gained a ``num_vars`` u32 field in QPY v12
  * the instruction record layout (33-byte fixed struct + name + label +
    condition-register name + 5-byte qarg entries + typed params) is
    unchanged across v10-v14

Anything outside this subset (custom gate definitions, symbolic
parameters, conditions, classical registers) raises ``ValueError`` rather
than guessing.
"""

from __future__ import annotations

import struct

from tensorrl_qas_tpu_torch.circuits.tape import GateTape, tape_from_gate_list

_GATE_NAMES = {
    "RXGate": "rx", "RYGate": "ry", "RZGate": "rz",
    "CXGate": "cx", "CnotGate": "cx",
    "RXXGate": "rxx", "RYYGate": "ryy", "RZZGate": "rzz",
    "XGate": "x", "YGate": "y", "ZGate": "z", "HGate": "h",
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated QPY payload")
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def parse_qpy(data: bytes):
    """Parse QPY bytes -> (n_qubits, gates, global_phase).

    ``gates`` is ``[(name, [qubits], angle | None), ...]`` — the same
    shape ``qasm.parse_qasm`` returns, so both feed
    ``tape_from_gate_list`` identically.
    """
    r = _Reader(data)
    magic, qpy_version = r.unpack("!6sB")
    if magic != b"QISKIT":
        raise ValueError("not a QPY file (bad magic)")
    if not 10 <= qpy_version <= 14:
        raise ValueError(f"unsupported QPY version {qpy_version} "
                         "(reader covers 10-14)")
    r.unpack("!BBB")                      # qiskit major/minor/patch
    (num_programs,) = r.unpack("!Q")
    r.take(1)                             # symbolic encoding ('p'/'e')
    if num_programs != 1:
        raise ValueError(f"expected 1 program, found {num_programs}")
    prog_type = r.take(1)
    if prog_type != b"q":
        raise ValueError(f"not a QuantumCircuit program ({prog_type!r})")

    # --- circuit header -------------------------------------------------
    (name_size, gp_type, gp_size, num_qubits, num_clbits, metadata_size,
     num_registers) = r.unpack("!H1sHIIQI")
    (num_instructions,) = r.unpack("!Q")
    if qpy_version >= 12:
        r.unpack("!I")                    # num_vars
    r.take(name_size)                     # circuit name
    if gp_type == b"f":
        (global_phase,) = struct.unpack("!d", r.take(gp_size))
    elif gp_type == b"i":
        (global_phase,) = struct.unpack("!q", r.take(gp_size))
        global_phase = float(global_phase)
    else:
        raise ValueError(f"unsupported global phase type {gp_type!r}")
    r.take(metadata_size)
    if num_clbits:
        raise ValueError("classical bits unsupported")

    # --- registers (parsed for the qubit-index map, then discarded:
    # the shipped circuits all use one standalone full-width qreg) -------
    for _ in range(num_registers):
        (_rtype, _standalone, size, reg_name_size,
         _in_circuit) = r.unpack("!1s?IH?")
        r.take(reg_name_size)
        r.take(8 * size)                  # int64 circuit-index array

    # --- custom instruction definitions ---------------------------------
    (n_custom,) = r.unpack("!Q")
    if n_custom:
        raise ValueError("custom gate definitions unsupported "
                         "(warm-start circuits are basis gates only)")

    # --- instructions -----------------------------------------------------
    gates = []
    for _ in range(num_instructions):
        (gname_size, label_size, num_params, num_qargs, num_cargs,
         _conditional, cond_reg_size, _cond_value, _num_ctrl,
         _ctrl_state) = r.unpack("!HHHIIBHqII")
        gate_cls = r.take(gname_size).decode()
        r.take(label_size)
        r.take(cond_reg_size)
        qubits = []
        for _ in range(num_qargs + num_cargs):
            (bit_type, idx) = r.unpack("!1sI")
            if bit_type != b"q":
                raise ValueError(f"unsupported bit type {bit_type!r}")
            qubits.append(int(idx))
        angle = None
        for _ in range(num_params):
            (ptype, psize) = r.unpack("!1sQ")
            payload = r.take(psize)
            if ptype != b"f":
                raise ValueError(
                    f"unsupported parameter type {ptype!r} on {gate_cls}")
            # qiskit writes param floats as raw (little-endian) doubles,
            # unlike every other field in the format
            (angle,) = struct.unpack("<d", payload)
        name = _GATE_NAMES.get(gate_cls)
        if name is None:
            raise ValueError(f"unsupported gate {gate_cls!r}")
        gates.append((name, qubits, angle))
    # trailing sections (calibrations, layout) are irrelevant to the tape
    return num_qubits, gates, global_phase


def load_qpy_tape(path: str, capacity: int | None = None,
                  rot_capacity: int | None = None) -> GateTape:
    with open(path, "rb") as f:
        n, gates, _phase = parse_qpy(f.read())
    return tape_from_gate_list(n, gates, capacity, rot_capacity)
