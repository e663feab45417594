"""The composed engine above 16 qubits on the CPU: su4, shot noise and the
noisy COBYLA cost at 17-20 qubits, where the JAX package runs the same
modes through XLA (``tensorrl_qas_tpu/optim/angle_opt.py:808-845``).

- The composed step on the plain versions (float64, the port's CPU
  dtype, with the H psi a flip group at a time, ``flip_h_blocked``)
  against the JAX package's XLA composed path (``AngleOptimizer(
  use_pallas=False).fused_step_batch``, complex128) at 17 qubits on the
  open Heisenberg chain: su4 tapes (``enable_2q``) and shot mode at
  ``n_shots = 0`` on CNOT tapes.  Identical starts (``restart_scale=0``,
  two starts: no fresh zero start, see tests/test_torch_su4.py); x_opt
  and e_new within 1e-8 (float64 in another summation order; 2 Adam
  iterations).
- (The su4 env at 18 qubits against the JAX su4 env: tests/
  test_torch_composed_wide_env.py, a file of its own for the time its
  JAX side compiles.)
- ``_pick_engine`` returns 'composed' for su4, shot noise and ``n_traj >
  1`` at 17-20 qubits and raises above 20, naming the sharded path.
- ``kernel_energy_fn`` (the noisy COBYLA cost: on CPU tensors the tape
  kernel's plain version and the blocked H psi) at 17 qubits against the
  eager complex128 simulator (``plain_energy``) on the same depolarizing
  draw, within 1e-10 (both float64 here; the card holds the float32
  kernel to 1e-5).
- The H psi above 16 qubits (``flip_h_blocked``: a flip group at a time)
  against ``flip_h_batched`` for a real and a complex H, values and
  gradients within 1e-12; ``flip_h_for`` takes the one gather up to 16
  qubits (faster there on the card: chip_smoke.py --h-psi) and the blocks
  from 17.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.optim.angle_opt import AngleOptimizer as OptJax
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.ops.fused_adam import _h_energy
from tensorrl_qas_tpu_torch.optim import angle_opt
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    flip_h_batched,
    flip_h_blocked,
    flip_h_for,
)
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tests.test_torch_su4 import CNOT_KINDS, SU4_KINDS, _batch, _pauli

TOL_STEP = 1e-8


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chain(n):
    """The open Heisenberg chain's Pauli strings (no config ships at 17
    qubits) for both packages."""
    strings, weights = [], []
    for i in range(n - 1):
        for p in "XYZ":
            s = ["I"] * n
            s[i] = s[i + 1] = p
            strings.append("".join(s))
            weights.append(1.0)
    weights = np.asarray(weights)
    return (PauliSum.from_strings(strings, weights, n),
            PauliSumJax.from_strings(strings, weights, n))


@pytest.mark.parametrize("mode", ["su4", "shot"])
def test_composed_step_matches_jax_xla_at_17_qubits(mode, one_thread):
    n, n_env, s_n, cap, iters = 17, 1, 2, 8, 2
    rng = np.random.default_rng({"su4": 21, "shot": 22}[mode])
    old, new, maps, x0, n_rots = _batch(
        rng, n, n_env, cap, SU4_KINDS if mode == "su4" else CNOT_KINDS)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    ps_t, ps_j = _chain(n)
    kw = dict(iters=iters, n_starts=s_n, restart_scale=0.0)
    kw.update({"su4": dict(enable_2q=True),
               "shot": dict(noise_mode="shot", n_shots=0)}[mode])
    opt_j = OptJax(ps_j.device_arrays(jnp.complex128), dtype=jnp.complex128,
                   use_pallas=False, **kw)
    x_j, e_j, _ = opt_j.fused_step_batch(
        (jnp.asarray(psi0.real), jnp.asarray(psi0.imag)), old, x0, n_rots,
        new, maps, jax.random.split(jax.random.PRNGKey(0), n_env))
    opt_t = AngleOptimizer(ps_t, device="cpu", **kw)
    assert opt_t._pick_engine(old[0], new[0]) == "composed"
    x_t, e_t, _ = opt_t.fused_step_batch(torch.as_tensor(psi0), old, x0,
                                         n_rots, new, maps)
    np.testing.assert_allclose(x_t, np.asarray(x_j), atol=TOL_STEP, rtol=0)
    np.testing.assert_allclose(e_t, np.asarray(e_j), atol=TOL_STEP, rtol=0)
    assert float(np.abs(x_t - x0).max()) > 0.05        # Adam moved x


@pytest.mark.parametrize("n", [17, 18, 20])
@pytest.mark.parametrize("mode", ["su4", "shot", "traj2"])
def test_pick_engine_composed_up_to_20_qubits(mode, n):
    kw = {"su4": dict(enable_2q=True),
          "shot": dict(noise_mode="shot", n_shots=100),
          "traj2": dict(noise_mode="depolarizing", n_traj=2)}[mode]
    kind = torch.full((1, 4), int(GateKind.RXX if mode == "su4"
                                  else GateKind.CX), dtype=torch.int32)
    ps, _ = _chain(n)
    assert AngleOptimizer(ps, device="cpu", **kw)._pick_engine(
        kind, kind) == "composed"
    ps, _ = _chain(21)
    with pytest.raises(ValueError, match="EnvConfig.mesh_shape"):
        AngleOptimizer(ps, device="cpu", **kw)._pick_engine(kind, kind)


def test_noisy_cobyla_cost_at_17_qubits(one_thread):
    n = 17
    ps, _ = _chain(n)
    opt = AngleOptimizer(ps, device="cpu", noise_mode="depolarizing",
                         noise_p1=0.3, noise_p2=0.5, n_traj=2, seed=3)
    tape = GateTape(n, 10, 10)
    rng = np.random.default_rng(4)
    for i in range(8):
        t = int(rng.integers(n))
        if i % 2:
            tape.add_cx(t, (t + 1 + int(rng.integers(n - 1))) % n)
        else:
            tape.add(GateKind(1 + i % 3), t, angle=float(rng.normal()))
    psi0 = torch.zeros(1 << n, dtype=torch.complex128)
    psi0[0] = 1.0
    arrs = tape.arrays()
    energy = opt.kernel_energy_fn(psi0, arrs, 10)
    x = np.asarray(tape.x0()) + 0.3
    kinds = torch.as_tensor(arrs[0], dtype=torch.int32).reshape(1, -1)
    fired = 0
    for seed in range(3):
        noise = opt._draw_noise(torch.Generator().manual_seed(seed), kinds,
                                1, 1)
        fired += int((noise[0] > 0).sum() + (noise[1] > 0).sum())
        assert abs(energy(x, noise) - opt.plain_energy(psi0, arrs, x,
                                                       noise)) < 1e-10
    assert fired > 0
    assert abs(energy(x) - opt.plain_energy(psi0, arrs, x)) > 1e-6


@pytest.mark.parametrize("complex_h", [False, True])
def test_blocked_h_matches_one_gather(complex_h):
    """The H psi above 16 qubits (one flip group at a time, partners by a
    flip of axes) against ``flip_h_batched``'s one gather, values and
    autograd gradients, on the chain (real H) and on a random Pauli sum
    with Y terms (complex planes); and every flip plan is the XOR."""
    n = 10
    ps = _pauli(n, seed=5, k=30)[0] if complex_h else _chain(n)[0]
    wre, wim, flips = AngleOptimizer(ps, device="cpu").w_planes()
    assert bool((wim != 0).any()) == complex_h
    col = torch.arange(1 << n)
    for f in [*flips.tolist(), 0b1000000001, 0b0110110011]:
        x = col.double()
        assert torch.equal(angle_opt._partner(x, angle_opt.flip_plan(f, n)),
                           (col ^ f).double())
    rng = np.random.default_rng(n)
    psi = rng.normal(size=(3, 2, 1 << n)) + 1j * rng.normal(
        size=(3, 2, 1 << n))
    outs = []
    for h in (flip_h_blocked(wre, wim, flips),
              flip_h_batched(wre, wim, flips)):
        re = torch.as_tensor(psi.real).requires_grad_()
        im = torch.as_tensor(psi.imag).requires_grad_()
        hre, him, ev = _h_energy(re, im, h)
        g = torch.autograd.grad(ev.sum() + (hre * 0.3 - him).sum(), (re, im))
        outs.append((hre.detach(), him.detach(), ev.detach(), *g))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-12


@pytest.mark.parametrize("n", [10, 16, 17, 20])
def test_h_psi_by_size(n):
    """``flip_h_for`` (the composed energy's H psi, ``_h_apply`` and
    ``composed_step``) is the one gather up to 16 qubits, the blocks
    above."""
    wre = torch.zeros((1, 1 << n))
    h = flip_h_for(wre, wre, torch.zeros(1, dtype=torch.int32))
    want = flip_h_blocked if n >= 17 else flip_h_batched
    assert h.__qualname__ == f"{want.__name__}.<locals>.apply"
