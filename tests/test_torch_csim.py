"""The port's csim (``tensorrl_qas_tpu_torch/native``, ``csrc/csim.cpp``
built by ``ops/build.py:build_host``) against the JAX package's
simulator, in complex128 / float64:

- statevectors and energies of random tapes (every gate kind, RXX / RYY /
  RZZ and a controlled rotation among them) against the JAX ``apply_tape``
  and ``pauli_expectation`` at 3-8 qubits, within 1e-10;
- the depolarizing entries at p = 0 equal the noiseless ones bit for bit;
- the mean of 2000 depolarizing trajectories against the exact Kraus
  channel (``sim/noise.py:depolarizing_energy_exact``), within 5 sigma of
  the mean + 1e-3 (the rule of ``tests/test_noise_pallas.py``);
- a missing compiler, or a source that does not compile, makes the build
  raise.

Each test builds into a temporary ``build/``."""

import jax.numpy as jnp
import numpy as np
import pytest

from tensorrl_qas_tpu.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu.sim.apply import apply_tape as apply_tape_jax
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu.sim.expectation import (
    pauli_expectation as pauli_expectation_jax,
)
from tensorrl_qas_tpu_torch import native
from tensorrl_qas_tpu_torch.ops import build
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.sim.noise import depolarizing_energy_exact

TOL = 1e-10
KINDS = [GateKind.RX, GateKind.RY, GateKind.RZ, GateKind.CX, GateKind.X,
         GateKind.Y, GateKind.Z, GateKind.H, GateKind.RXX, GateKind.RYY,
         GateKind.RZZ]


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A fresh build/ for the host engine, and its library reloaded."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    native._library.cache_clear()
    yield tmp_path / "build"
    native._library.cache_clear()


def random_paulis(rng, n, n_terms):
    strings = ["".join(rng.choice(list("IXYZ"), size=n))
               for _ in range(n_terms)]
    return strings, rng.normal(size=n_terms)


def random_tape(rng, n, n_gates):
    """Every gate kind, a controlled RY among them."""
    tape = GateTape(n, n_gates + 1, n_gates + 1)
    for _ in range(n_gates):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        a, b = (int(q) for q in rng.choice(n, size=2, replace=False))
        two = kind in (GateKind.CX, GateKind.RXX, GateKind.RYY,
                       GateKind.RZZ)
        tape.add(kind, target=a, control=b if two else -1,
                 angle=float(rng.uniform(-np.pi, np.pi)))
    tape.add(GateKind.RY, target=0, control=n - 1, angle=0.7)
    return tape


def random_state(rng, n):
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return psi / np.linalg.norm(psi)


@pytest.mark.parametrize("n", [3, 5, 8])
def test_csim_matches_jax_complex128(build_dir, n):
    rng = np.random.default_rng(n)
    strings, weights = random_paulis(rng, n, 12)
    engine = native.CsimEngine(PauliSum.from_strings(strings, weights, n))
    pauli_jax = PauliSumJax.from_strings(strings, weights, n)
    tape = random_tape(rng, n, 40)
    psi0 = random_state(rng, n)
    x = tape.x0()

    psi_c = engine.apply_tape(psi0, *tape.arrays(), x)
    psi_j = np.asarray(apply_tape_jax(
        jnp.asarray(psi0), *map(jnp.asarray, tape.arrays()), jnp.asarray(x),
        enable_2q=True))
    np.testing.assert_allclose(psi_c, psi_j, atol=TOL)
    e_j = float(pauli_expectation_jax(
        jnp.asarray(psi_j), *pauli_jax.device_arrays(jnp.complex128)))
    assert abs(engine.expectation(psi_c) - e_j) < TOL
    assert abs(engine.tape_energy(psi0, *tape.arrays(), x) - e_j) < TOL
    # the prepared cost gives the same bits as the one-call entry
    assert (engine.energy_fn(psi0, *tape.arrays())(x)
            == engine.tape_energy(psi0, *tape.arrays(), x))
    assert list(build_dir.glob("libcsim_*.so"))


def test_depolarizing_at_p0_is_noiseless_bit_for_bit(build_dir):
    rng = np.random.default_rng(3)
    n = 5
    strings, weights = random_paulis(rng, n, 10)
    engine = native.CsimEngine(PauliSum.from_strings(strings, weights, n))
    tape = random_tape(rng, n, 30)
    psi0 = random_state(rng, n)
    x = tape.x0()
    np.testing.assert_array_equal(
        engine.apply_tape_depolarizing(psi0, *tape.arrays(), x, 0.0, 0.0,
                                       99),
        engine.apply_tape(psi0, *tape.arrays(), x))
    assert (engine.tape_energy_depolarizing(psi0, *tape.arrays(), x, 0.0,
                                            0.0, 99)
            == engine.tape_energy(psi0, *tape.arrays(), x))


def test_trajectory_mean_matches_kraus(build_dir):
    rng = np.random.default_rng(5)
    n, n_samp, p1, p2 = 4, 2000, 0.15, 0.25
    strings, weights = random_paulis(rng, n, 8)
    pauli = PauliSum.from_strings(strings, weights, n)
    engine = native.CsimEngine(pauli)
    tape = GateTape(n, 8, 8)
    tape.add(GateKind.CX, target=1, control=0)
    tape.add(GateKind.RY, target=1, angle=0.3)
    tape.add(GateKind.CX, target=2, control=1)
    tape.add(GateKind.RX, target=3, angle=-0.7)
    tape.add(GateKind.RZ, target=0, angle=0.2)
    tape.add(GateKind.CX, target=3, control=2)
    psi0 = random_state(rng, n)
    es = np.asarray([engine.tape_energy_depolarizing(
        psi0, *tape.arrays(), tape.x0(), p1, p2, 1000 + i)
        for i in range(n_samp)])
    exact = depolarizing_energy_exact(psi0, *tape.arrays(), tape.x0(),
                                      pauli.to_dense(), p1, p2)
    sigma = es.std() / np.sqrt(n_samp)
    assert es.std() > 0
    assert abs(es.mean() - exact) < 5 * sigma + 1e-3


def test_missing_compiler_raises(build_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build_host("csim")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.CsimEngine(PauliSum.from_strings(["Z"], [1.0], 1))
    assert not list(build_dir.glob("*.so"))


def test_failed_build_raises(build_dir, tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "csim.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", src)
    with pytest.raises(RuntimeError, match="failed building csim"):
        native.CsimEngine(PauliSum.from_strings(["Z"], [1.0], 1))
    assert not list(build_dir.glob("*.so"))
