"""The port's QPY reader (``tensorrl_qas_tpu_torch/circuits/qpy_reader.py``)
and the warm-start resolver's ``.qpy`` fallback (``problems/
hamiltonians.py``), twins of ``tests/test_qpy.py`` held to the JAX
package's reader on the same bytes:

  1. a hand-packed QPY stream (``test_qpy.write_qpy``, versions 10, 12
     and 14, with and without a global phase) parses to what the JAX
     reader gives, and to the same tape;
  2. a shipped warm start (5q Heisenberg, 8q H2O) packed as QPY loads to
     its ``.qasm`` twin's tape exactly, and its state's energy under the
     port's simulator equals the JAX simulator's on the same file within
     1e-12 Ha;
  3. the resolver falls back to ``.qpy`` when no ``.qasm`` exists,
     ``load_circuit_tape`` dispatches on the extension, and malformed
     streams raise as in the JAX reader.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_qpy import SYNTH_GATES, write_qpy

from tensorrl_qas_tpu.circuits import qpy_reader as qpy_jax
from tensorrl_qas_tpu.circuits.qasm import load_circuit_tape as load_jax
from tensorrl_qas_tpu_torch.circuits import qpy_reader
from tensorrl_qas_tpu_torch.circuits.qasm import (
    load_circuit_tape,
    load_qasm_tape,
    parse_qasm,
)
from tensorrl_qas_tpu_torch.problems import hamiltonians as H

WARM = (("heisenberg", 5, ""), ("H2O", 8, "H_-0.021_-0.002_0.000;"
                                 "_O_0.835_0.452_0.000;_H_1.477_-0.273_"
                                 "0.000"))


def _same_tape(a, b):
    assert (a.n_qubits, a.n_gates, a.n_rots) == (b.n_qubits, b.n_gates,
                                                 b.n_rots)
    for x, y in zip(a.arrays(), b.arrays()):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert np.array_equal(a.x0(), b.x0())


@pytest.mark.parametrize("phase", [0.0, 0.25])
@pytest.mark.parametrize("version", [10, 12, 14])
def test_synthetic_stream_matches_jax_reader(version, phase, tmp_path):
    data = write_qpy(3, SYNTH_GATES, version=version, global_phase=phase)
    ours = qpy_reader.parse_qpy(data)
    assert ours == qpy_jax.parse_qpy(data)
    n, gates, got_phase = ours
    assert n == 3 and got_phase == phase
    assert gates == [(g[0], g[1], g[2]) for g in SYNTH_GATES]
    path = tmp_path / "c.qpy"
    path.write_bytes(data)
    _same_tape(qpy_reader.load_qpy_tape(str(path)),
               qpy_jax.load_qpy_tape(str(path)))


def test_malformed_streams_raise_as_in_jax():
    bad_magic = b"NOTQPY" + b"\x00" * 40
    old = bytearray(write_qpy(2, [("rz", [0], 1.0)]))
    old[6] = 9                                    # too-old version byte
    for data, match in ((bad_magic, "magic"), (bytes(old), "version")):
        for reader in (qpy_reader, qpy_jax):
            with pytest.raises(ValueError, match=match):
                reader.parse_qpy(data)


def _energy_jax(path, ham, n, geometry):
    from tensorrl_qas_tpu.problems.hamiltonians import load_problem
    from tensorrl_qas_tpu.sim.apply import apply_tape, zero_state
    from tensorrl_qas_tpu.sim.expectation import pauli_expectation

    tape = load_jax(path)
    psi = apply_tape(zero_state(n, jnp.complex128),
                     *map(jnp.asarray, tape.arrays()),
                     jnp.asarray(tape.x0()))
    prob = load_problem(ham, n, geometry)
    return float(pauli_expectation(psi, *prob.pauli.device_arrays(
        jnp.complex128)))


def _energy(path, ham, n, geometry):
    from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
    from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation

    tape = load_circuit_tape(path)
    psi = apply_tape(zero_state(n), *tape.arrays(), tape.x0())
    prob = H.load_problem(ham, n, geometry, keep_dense=False)
    return float(pauli_expectation(psi, *prob.pauli.tensors(
        "cpu", torch.complex128)))


@pytest.mark.parametrize("ham,n,geometry", WARM,
                         ids=[f"{w[0]}_{w[1]}q" for w in WARM])
def test_shipped_warm_start_as_qpy(ham, n, geometry, tmp_path):
    qasm = H.resolve_warmstart_qasm(ham, n, 2, geometry)
    with open(qasm) as f:
        n_q, gates = parse_qasm(f.read())
    path = tmp_path / "warm.qpy"
    path.write_bytes(write_qpy(n_q, gates))
    tape = load_circuit_tape(str(path))
    _same_tape(tape, load_qasm_tape(qasm))
    _same_tape(tape, load_jax(str(path)))
    e = _energy(str(path), ham, n, geometry)
    assert abs(e - _energy_jax(str(path), ham, n, geometry)) < 1e-12
    assert abs(e - _energy(qasm, ham, n, geometry)) == 0.0


def test_resolver_qpy_fallback(tmp_path, monkeypatch):
    d = tmp_path / "init_state_circ"
    d.mkdir()
    qpy_path = d / "init_heisenberg_3q_TNbond2.qpy"
    qpy_path.write_bytes(write_qpy(3, SYNTH_GATES))
    monkeypatch.setattr(H, "DATA_SEARCH_PATHS", [str(tmp_path)])
    resolved = H.resolve_warmstart_qasm("heisenberg", 3, 2)
    assert resolved == str(qpy_path)
    tape = load_circuit_tape(resolved)
    assert tape.n_qubits == 3 and tape.n_gates == len(SYNTH_GATES)
    _same_tape(tape, load_jax(resolved))
    # a qasm beside it wins
    (d / "init_heisenberg_3q_TNbond2.qasm").write_text(
        "OPENQASM 2.0;\nqreg q[3];\nrz(0.5) q[1];\n")
    assert H.resolve_warmstart_qasm("heisenberg", 3, 2).endswith(".qasm")
    with pytest.raises(FileNotFoundError, match="qpy twin"):
        H.resolve_warmstart_qasm("heisenberg", 4, 2)
