"""The composed engine's tape kernels (``ops/apply_tape.py``, B3f / B3b)
in their plain versions, on the CPU.

- Against the JAX package's Pallas kernels ``apply_tape_pallas_ri`` in
  interpret mode (as tests/test_pallas_apply.py runs them), forward and
  through their ``custom_vjp`` with ``jax.vjp`` and random real-plane
  cotangents (so the psi0 cotangent's -gim convention is held too), in
  float32: every gate class of ``_gate_class`` (NONE, RZ / Z, X / CX, RX,
  RY, the generic H / Y / controlled rotations, RZZ, RXX / RYY), the error
  Paulis of an extended tape, and controlled rotations, whose generator
  the Pallas kernel masks by the control (the JAX XLA adjoint does not:
  ROADMAP.md, C).  Tolerance 1e-5: float32 in another summation order.
- In float64 against the eager simulator (``sim/apply.py``, 1e-10) and
  finite differences (1e-7: central differences at h = 1e-5), and
  ``torch.autograd.gradcheck`` of ``ApplyTape``.
- The wrappers on CPU tensors run the plain versions (no launch counted),
  refuse a device without a kernel and tapes a kernel would index out of
  range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.ops.pallas_apply import apply_tape_pallas_ri
from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops.apply_tape import (
    apply_tape_bwd,
    apply_tape_bwd_plain,
    apply_tape_fwd,
    apply_tape_fwd_plain,
    apply_tape_ri,
    check_tapes,
)
from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays
from tensorrl_qas_tpu_torch.sim.apply import apply_tape

TOL_F32 = 1e-5
TOL_F64 = 1e-10
TOL_FD = 1e-7

ONE_Q = (GateKind.RX, GateKind.RY, GateKind.RZ, GateKind.X, GateKind.Y,
         GateKind.Z, GateKind.H)
TWO_Q = (GateKind.RXX, GateKind.RYY, GateKind.RZZ)
ROT = (GateKind.RX, GateKind.RY, GateKind.RZ, *TWO_Q)


def _tapes(rng, n, n_env, n_gates, p_ctrl=0.25, padding=2):
    """(E, G) int32 tapes of every gate kind: 1-qubit gates (rotations
    controlled with probability ``p_ctrl``), CX, RXX / RYY / RZZ, and
    trailing NONE padding; slots for the rotations only.  -> (tape, R)."""
    g_cap = n_gates + padding
    kind = np.zeros((n_env, g_cap), np.int32)
    tq = np.zeros((n_env, g_cap), np.int32)
    cq = np.full((n_env, g_cap), -1, np.int32)
    slot = np.full((n_env, g_cap), -1, np.int32)
    pool = (*ONE_Q, GateKind.CX, *TWO_Q)
    r_max = 0
    for e in range(n_env):
        r = 0
        for g in range(n_gates):
            k = pool[int(rng.integers(len(pool)))] if g >= len(pool) \
                else pool[(g + e) % len(pool)]
            t = int(rng.integers(n))
            other = int((t + 1 + rng.integers(n - 1)) % n)
            kind[e, g], tq[e, g] = int(k), t
            if k in (GateKind.CX, *TWO_Q) or (
                    k in ROT and rng.random() < p_ctrl):
                cq[e, g] = other
            if k in ROT:
                slot[e, g] = r
                r += 1
        r_max = max(r_max, r)
    return (kind, tq, cq, slot), r_max + 1


def _extended(rng, tape):
    """``tape`` with drawn error Paulis woven in (3G long, slot -1): X / Y
    / Z after rotations and CX on the target and the CX's control."""
    kind = torch.as_tensor(tape[0])
    fire = torch.as_tensor(rng.random(kind.shape) < 0.5)
    is_rot = (kind >= int(GateKind.RX)) & (kind <= int(GateKind.RZ))
    code = torch.as_tensor(rng.integers(1, 4, size=(2, *kind.shape)))
    kt = torch.where(fire & (is_rot | (kind == int(GateKind.CX))),
                     int(GateKind.X) - 1 + code[0], 0)
    kc = torch.where(fire & (kind == int(GateKind.CX)),
                     int(GateKind.X) - 1 + code[1], 0)
    return tuple(a.numpy() for a in extend_tape_arrays(
        tuple(torch.as_tensor(a) for a in tape), kt, kc))


def _planes(rng, shape, dtype=np.float32):
    psi = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return psi.real.astype(dtype), psi.imag.astype(dtype)


def _case(seed, n=4, n_env=3, s_n=2, n_gates=22, extend=False, ctrl=0.25):
    rng = np.random.default_rng(seed)
    tape, r = _tapes(rng, n, n_env, n_gates, ctrl)
    if extend:
        tape = _extended(rng, tape)
    re, im = _planes(rng, (n_env, s_n, 1 << n))
    angles = rng.normal(size=(n_env, s_n, r)).astype(np.float32)
    gre, gim = (rng.normal(size=re.shape).astype(np.float32)
                for _ in range(2))
    return tape, re, im, angles, gre, gim


@pytest.mark.parametrize("extend", [False, True])
def test_plain_matches_pallas_interpret_forward_and_vjp(extend):
    tape, re, im, angles, gre, gim = _case(1, extend=extend)
    jt = tuple(jnp.asarray(a) for a in tape)

    def fwd(re, im, angles):
        return apply_tape_pallas_ri(re, im, *jt, angles, True)

    (ore_j, oim_j), vjp = jax.vjp(fwd, jnp.asarray(re), jnp.asarray(im),
                                  jnp.asarray(angles))
    dre_j, dim_j, dang_j = vjp((jnp.asarray(gre), jnp.asarray(gim)))

    tt = tuple(torch.as_tensor(a) for a in tape)
    re_t, im_t, ang_t = (torch.as_tensor(a).requires_grad_()
                         for a in (re, im, angles))
    ore, oim = apply_tape_ri(re_t, im_t, *tt, ang_t)
    dre, dim, dang = torch.autograd.grad(
        (ore, oim), (re_t, im_t, ang_t),
        (torch.as_tensor(gre), torch.as_tensor(gim)))
    for mine, ref in ((ore, ore_j), (oim, oim_j), (dre, dre_j),
                      (dim, dim_j), (dang, dang_j)):
        np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                                   atol=TOL_F32)
    assert float(np.abs(np.asarray(dang_j)).max()) > 0.1


def test_controlled_rotation_gradient_matches_pallas_interpret():
    """Controlled RX / RY / RZ only: the generic class, whose generator is
    masked by the control."""
    rng = np.random.default_rng(4)
    n, n_env = 3, 2
    kinds = [GateKind.RX, GateKind.RY, GateKind.RZ, GateKind.H]
    tape = tuple(np.zeros((n_env, 4), np.int32) for _ in range(4))
    for e in range(n_env):
        for g, k in enumerate(kinds):
            tape[0][e, g], tape[1][e, g] = int(k), (g + e) % n
            tape[2][e, g] = (g + e + 1) % n if k != GateKind.H else -1
            tape[3][e, g] = g if k != GateKind.H else -1
    re, im = _planes(rng, (n_env, 2, 1 << n))
    angles = rng.normal(size=(n_env, 2, 3)).astype(np.float32)
    gre, gim = (rng.normal(size=re.shape).astype(np.float32)
                for _ in range(2))
    jt = tuple(jnp.asarray(a) for a in tape)
    _, vjp = jax.vjp(lambda a: apply_tape_pallas_ri(
        jnp.asarray(re), jnp.asarray(im), *jt, a, True), jnp.asarray(angles))
    dang_j, = vjp((jnp.asarray(gre), jnp.asarray(gim)))
    tt = tuple(torch.as_tensor(a) for a in tape)
    ore, oim = apply_tape_fwd_plain(torch.as_tensor(re), torch.as_tensor(im),
                                    *tt, torch.as_tensor(angles))
    _, _, dang = apply_tape_bwd_plain(ore, oim, torch.as_tensor(gre),
                                      torch.as_tensor(gim), *tt,
                                      torch.as_tensor(angles))
    np.testing.assert_allclose(dang.numpy(), np.asarray(dang_j), atol=TOL_F32)


def _loss(tape, re, im, angles, gre, gim):
    ore, oim = apply_tape_fwd_plain(re, im, *tape, angles)
    return float((gre * ore + gim * oim).sum())


@pytest.mark.parametrize("extend", [False, True])
def test_plain_float64_matches_eager_simulator_and_finite_differences(
        extend):
    tape, re, im, angles, gre, gim = _case(2, extend=extend)
    tt = tuple(torch.as_tensor(a) for a in tape)
    re, im, angles, gre, gim = (torch.as_tensor(a, dtype=torch.float64)
                                for a in (re, im, angles, gre, gim))
    ore, oim = apply_tape_fwd_plain(re, im, *tt, angles)
    for e in range(re.shape[0]):
        for s in range(re.shape[1]):
            psi = apply_tape(torch.complex(re[e, s], im[e, s]),
                             *(a[e] for a in tape), angles[e, s])
            assert float((psi.real - ore[e, s]).abs().max()) < TOL_F64
            assert float((psi.imag - oim[e, s]).abs().max()) < TOL_F64
    dre, dim, dang = apply_tape_bwd_plain(ore, oim, gre, gim, *tt, angles)
    h = 1e-5
    rng = np.random.default_rng(0)
    for arg, grad in ((2, dang), (0, dre), (1, dim)):
        for _ in range(6):
            idx = tuple(int(rng.integers(k)) for k in grad.shape)
            args = [re, im, angles]
            up, dn = (a.clone() for a in (args[arg], args[arg]))
            up[idx] += h
            dn[idx] -= h
            fd = (_loss(tt, *(up if i == arg else a for i, a in
                              enumerate(args)), gre, gim)
                  - _loss(tt, *(dn if i == arg else a for i, a in
                                enumerate(args)), gre, gim)) / (2 * h)
            assert abs(fd - float(grad[idx])) < TOL_FD, (arg, idx)


def test_apply_tape_gradcheck():
    tape, re, im, angles, _, _ = _case(3, n=3, n_env=1, n_gates=11)
    tt = tuple(torch.as_tensor(a) for a in tape)
    inputs = tuple(torch.as_tensor(a, dtype=torch.float64).requires_grad_()
                   for a in (re, im, angles))
    assert torch.autograd.gradcheck(
        lambda a, b, c: apply_tape_ri(a, b, *tt, c), inputs)


def test_wrappers_run_the_plain_versions_on_the_cpu_and_check_inputs():
    tape, re, im, angles, gre, gim = _case(5, n=3, n_env=2, n_gates=10)
    tt = tuple(torch.as_tensor(a) for a in tape)
    re, im, angles, gre, gim = (torch.as_tensor(a) for a in
                                (re, im, angles, gre, gim))
    before = (apply_tape_fwd.launches, apply_tape_bwd.launches)
    ore, oim = apply_tape_fwd(re, im, *tt, angles)
    dre, dim, dang = apply_tape_bwd(ore, oim, gre, gim, *tt, angles)
    ref = apply_tape_fwd_plain(re, im, *tt, angles)
    assert torch.equal(ore, ref[0]) and torch.equal(oim, ref[1])
    assert dang.shape == angles.shape and dre.shape == re.shape
    assert (apply_tape_fwd.launches, apply_tape_bwd.launches) == before
    meta = [t.to("meta") for t in (re, im, *tt, angles)]
    with pytest.raises(ValueError, match="no kernel"):
        apply_tape_fwd(*meta)
    n, r = 3, angles.shape[-1]
    check_tapes(*tt, n, r)
    for field, value in ((0, 12), (1, n), (2, n), (3, r)):
        bad = [a.clone() for a in tt]
        bad[field][0, 0] = value
        with pytest.raises(ValueError, match="slots"):
            check_tapes(*bad, n, r)
    rxx = [a.clone() for a in tt]
    rxx[0][0, 0], rxx[2][0, 0] = int(GateKind.RXX), -1
    with pytest.raises(ValueError, match="second qubit"):
        check_tapes(*rxx, n, r)
