"""ctypes binding of csim, the host statevector engine (``csrc/csim.cpp``).

The port's counterpart of ``tensorrl_qas_tpu/native``: the same C++
source, built with the same g++ flags at first use, here into ``build/``
through ``ops/build.py:build_host`` (never next to a package's source).
It is the noiseless COBYLA optimizer's cost on the host, in float64, and
an oracle for the simulators.  A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F64P = ctypes.POINTER(ctypes.c_double)
_TAPE = [ctypes.c_int32, _I32P, _I32P, _I32P, _I32P, ctypes.c_int32, _F64P]
_PAULI = [ctypes.c_int32, _U32P, _U32P, _I32P, _F64P]
_NOISE = [ctypes.c_double, ctypes.c_double, ctypes.c_uint64]


@functools.cache
def _library():
    """The engine's library (built at first use) with its C signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load_host

    lib = load_host("csim")
    lib.csim_apply_tape.argtypes = [*_TAPE, _F64P]
    lib.csim_apply_tape.restype = None
    lib.csim_pauli_expectation.argtypes = [ctypes.c_int32, _F64P, *_PAULI]
    lib.csim_pauli_expectation.restype = ctypes.c_double
    lib.csim_tape_energy.argtypes = [*_TAPE, _F64P, *_PAULI, _F64P]
    lib.csim_tape_energy.restype = ctypes.c_double
    lib.csim_apply_tape_depolarizing.argtypes = [*_TAPE, *_NOISE, _F64P]
    lib.csim_apply_tape_depolarizing.restype = None
    lib.csim_tape_energy_depolarizing.argtypes = [*_TAPE, *_NOISE, _F64P,
                                                  *_PAULI, _F64P]
    lib.csim_tape_energy_depolarizing.restype = ctypes.c_double
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _state(psi) -> np.ndarray:
    """A (2^n,) statevector (numpy or torch, any device) as an interleaved
    float64 (re, im) host array of its own."""
    if hasattr(psi, "detach"):
        psi = psi.detach().cpu().numpy()
    return np.array(psi, dtype=np.complex128).view(np.float64)


class _Tape:
    """A tape's (kind, tq, cq, slot) as contiguous int32 host arrays and the
    pointers the engine takes."""

    def __init__(self, kind, tq, cq, slot):
        def host(a):
            if hasattr(a, "detach"):
                a = a.detach().cpu().numpy()
            return np.ascontiguousarray(a, dtype=np.int32)
        self.arrays = tuple(host(a) for a in (kind, tq, cq, slot))
        self.n_gates = len(self.arrays[0])
        self.ptrs = tuple(_ptr(a, ctypes.c_int32) for a in self.arrays)


def _angles(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


class CsimEngine:
    """Host statevector engine bound to one ``PauliSum``."""

    def __init__(self, pauli):
        self._lib = _library()
        self.n = pauli.n_qubits
        self.flip = np.ascontiguousarray(pauli.flip, dtype=np.uint32)
        self.sign = np.ascontiguousarray(pauli.sign_mask, dtype=np.uint32)
        # (-i)^ny: ny mod 4 from the stored phase
        ph = np.asarray(pauli.iphase)
        ny = np.zeros(len(ph), dtype=np.int32)
        ny[np.isclose(ph, -1j)] = 1
        ny[np.isclose(ph, -1)] = 2
        ny[np.isclose(ph, 1j)] = 3
        self.ny = np.ascontiguousarray(ny)
        self.w = np.ascontiguousarray(pauli.weights, dtype=np.float64)
        self._pauli = (len(self.w), _ptr(self.flip, ctypes.c_uint32),
                       _ptr(self.sign, ctypes.c_uint32),
                       _ptr(self.ny, ctypes.c_int32),
                       _ptr(self.w, ctypes.c_double))
        self._scratch = np.zeros(2 * (1 << self.n), dtype=np.float64)

    def apply_tape(self, psi, kind, tq, cq, slot, angles) -> np.ndarray:
        """psi (2^n,) -> the evolved state, a complex128 copy."""
        state = _state(psi)
        tape, x = _Tape(kind, tq, cq, slot), _angles(angles)
        self._lib.csim_apply_tape(self.n, *tape.ptrs, tape.n_gates,
                                  _ptr(x, ctypes.c_double),
                                  _ptr(state, ctypes.c_double))
        return state.view(np.complex128)

    def expectation(self, psi) -> float:
        state = _state(psi)
        return float(self._lib.csim_pauli_expectation(
            self.n, _ptr(state, ctypes.c_double), *self._pauli))

    def energy_fn(self, psi0, kind, tq, cq, slot):
        """The energy of this tape applied to psi0 as a function of its
        angles ((R,) float64): psi0 and the tape are copied to the host
        once here, not once an evaluation (the COBYLA cost)."""
        p0 = _state(psi0)
        tape = _Tape(kind, tq, cq, slot)

        def energy(angles) -> float:
            x = _angles(angles)
            return float(self._lib.csim_tape_energy(
                self.n, *tape.ptrs, tape.n_gates, _ptr(x, ctypes.c_double),
                _ptr(p0, ctypes.c_double), *self._pauli,
                _ptr(self._scratch, ctypes.c_double)))
        return energy

    def tape_energy(self, psi0, kind, tq, cq, slot, angles) -> float:
        """The tape applied to psi0, then <H> (one engine call)."""
        return self.energy_fn(psi0, kind, tq, cq, slot)(angles)

    def apply_tape_depolarizing(self, psi, kind, tq, cq, slot, angles,
                                p1: float, p2: float,
                                seed: int) -> np.ndarray:
        """One depolarizing trajectory (the reference's
        ``VQE_qulacs_noise.py`` channel placement; csim.cpp's splitmix64
        draw, seeded with ``seed``)."""
        state = _state(psi)
        tape, x = _Tape(kind, tq, cq, slot), _angles(angles)
        self._lib.csim_apply_tape_depolarizing(
            self.n, *tape.ptrs, tape.n_gates, _ptr(x, ctypes.c_double),
            float(p1), float(p2), int(seed) & (2**64 - 1),
            _ptr(state, ctypes.c_double))
        return state.view(np.complex128)

    def tape_energy_depolarizing(self, psi0, kind, tq, cq, slot, angles,
                                 p1: float, p2: float, seed: int) -> float:
        """One depolarizing trajectory's energy (one engine call)."""
        p0 = _state(psi0)
        tape, x = _Tape(kind, tq, cq, slot), _angles(angles)
        return float(self._lib.csim_tape_energy_depolarizing(
            self.n, *tape.ptrs, tape.n_gates, _ptr(x, ctypes.c_double),
            float(p1), float(p2), int(seed) & (2**64 - 1),
            _ptr(p0, ctypes.c_double), *self._pauli,
            _ptr(self._scratch, ctypes.c_double)))
