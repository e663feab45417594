"""The flip-group fused Adam env step of the PyTorch port
(ops/fused_adam2d.py, the v2 engine) against the JAX package.

- Flip-group planes vs ``pauli_flip_groups``: exact (the same float64 sums
  cast to float32); with the identity weight taken off, the planes sum to
  the dense H - c0 I to 1e-12.
- Plain v2 step vs ``fused_adam_step_pallas2d(..., interpret=True)`` at 7
  qubits in float32, 3 Adam iterations: within 1e-5 (f32 rounding and
  summation order; the port works on H - c0 I and adds c0 back).
- Plain v2 step vs the XLA path (``use_pallas=False``) in complex128 with
  the JAX starts injected: within 1e-10 at 7 and 8 qubits, and at 13 (the
  Heisenberg chain: the cluster kernel's band, whose card check holds the
  kernel to this plain step).
- Plain v2 step vs plain v1 step (dense H) at 8-qubit H2O in float64:
  within 1e-10.
- Engine choice: v1 up to 9 qubits, v2 from 10 to 20, nothing above, and
  no fused engine for RXX/RYY/RZZ tapes.
- ``operands2d_from_jax``: the JAX v2 operands in the port's layout; on
  them the port computes the XLA path's x_opt and e_new to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.envs import CircuitEnv as EnvJax
from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu.ops.pallas_opt2d import (
    fused_adam_step_pallas2d,
)
from tensorrl_qas_tpu.ops.pallas_opt2d import (
    pauli_flip_groups as flip_groups_jax,
)
from tensorrl_qas_tpu.optim.angle_opt import AngleOptimizer as OptJax
from tensorrl_qas_tpu.optim.angle_opt import make_multistarts as starts_jax
from tensorrl_qas_tpu.problems.hamiltonians import heisenberg_hamiltonian
from tensorrl_qas_tpu.problems.hamiltonians import load_problem as load_jax
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    operands2d_from_jax,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import load_problem
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tests.test_torch_fused_adam import _ints, _random_batch

H2O = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"


def _heisenberg(n):
    paulis, weights = heisenberg_hamiltonian(n)
    return (PauliSumJax.from_strings(paulis, weights, n),
            PauliSum.from_strings(paulis, weights, n))


def _random_paulis(n, n_terms, seed):
    """A Pauli sum with X, Y and Z letters and an identity term."""
    rng = np.random.default_rng(seed)
    paulis = ["I" * n] + ["".join(rng.choice(list("IXYZ"), size=n))
                          for _ in range(n_terms - 1)]
    weights = rng.normal(size=n_terms)
    return (PauliSumJax.from_strings(paulis, weights, n),
            PauliSum.from_strings(paulis, weights, n))


def _problem(name):
    if name.startswith("heisenberg"):
        return _heisenberg(int(name[len("heisenberg"):]))
    return (load_jax("H2O", 8, H2O).pauli, load_problem("H2O", 8, H2O).pauli)


def _psi(rng, n):
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return psi0 / np.linalg.norm(psi0)


@pytest.fixture
def one_thread():
    """Torch on one thread for the test: the xdist workers share the
    host's cores, and a parallel region of a busy pool waits on threads
    the other workers keep descheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["heisenberg7", "h2o8"])
def test_flip_groups_equal_the_jax_planes(name):
    ps_j, ps_t = _problem(name)
    wre_j, wim_j, flips_j = flip_groups_jax(ps_j)
    wre, wim, flips = fused_adam2d.pauli_flip_groups(ps_t)
    d = 1 << ps_t.n_qubits
    np.testing.assert_array_equal(flips, np.asarray(flips_j, np.int32))
    np.testing.assert_array_equal(wre, wre_j.reshape(len(flips), d))
    np.testing.assert_array_equal(wim, wim_j.reshape(len(flips), d))
    # with the identity weight off the f = 0 plane: H - c0 I
    c0 = ps_t.identity_weight()
    wre, wim, flips = fused_adam2d.pauli_flip_groups(ps_t, c0, np.float64)
    h = np.zeros((d, d), complex)
    idx = np.arange(d)
    for f, w in zip(flips, wre + 1j * wim):
        h[idx, idx ^ f] += w
    np.testing.assert_allclose(h, ps_t.to_dense() - c0 * np.eye(d),
                               atol=1e-12)


def test_plain_version_matches_pallas_v2_interpret():
    n, n_env, s_n, cap, iters = 7, 2, 3, 10, 3
    rng = np.random.default_rng(0)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    ps_j, ps_t = _random_paulis(n, 24, seed=1)
    psi0 = _psi(rng, n)
    active = (np.arange(cap)[None, None, :]
              < n_rots[:, None, None]).astype(np.float32)
    starts = (x0[:, None, :] + 0.3 * rng.normal(size=(n_env, s_n, cap))
              ).astype(np.float32) * active
    wre_j, wim_j, flips_j = flip_groups_jax(ps_j)
    f32 = jnp.float32
    xj, ej = fused_adam_step_pallas2d(
        tuple(map(jnp.asarray, old)), tuple(map(jnp.asarray, new)),
        jnp.asarray(maps), jnp.asarray(psi0.real.reshape(1, 128), f32),
        jnp.asarray(psi0.imag.reshape(1, 128), f32), jnp.asarray(wre_j),
        jnp.asarray(wim_j), flips_j, jnp.asarray(starts),
        jnp.asarray(active), iters=iters, lr=0.1, interpret=True)

    opt = AngleOptimizer(ps_t, device="cpu")
    wre, wim, flips = (t.float() if t.is_floating_point() else t
                       for t in opt.w_planes())

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    xt, et = fused_adam2d.fused_adam_step2d(
        _ints(old), _ints(new), torch.as_tensor(maps), t32(psi0.real[None]),
        t32(psi0.imag[None]), wre, wim, flips, t32(starts), t32(active),
        iters=iters, lr=0.1)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(et.numpy() + opt.offset, np.asarray(ej),
                               atol=1e-5)


def _xla_reference(ps_j, psi0, old, new, maps, x0, n_rots, *, iters, s_n,
                   key):
    """x_opt, e_new of the JAX XLA path in complex128 and its starts."""
    n_env, cap = x0.shape
    opt_j = OptJax(ps_j.device_arrays(jnp.complex128), iters=iters,
                   n_starts=s_n, lr=0.1, dtype=jnp.complex128)
    keys = jax.random.split(jax.random.PRNGKey(key), n_env)
    xj, ej, _ = opt_j.fused_step_batch(
        (psi0.real, psi0.imag), old, x0, n_rots, new, maps, keys)
    # the XLA path's starts: _fused_step splits key -> (ko, ke), then
    # _optimize_multistart splits ko -> (kn, ko2) and draws from kn
    active = (np.arange(cap)[None, :] < n_rots[:, None]).astype(np.float64)
    starts = np.stack([np.asarray(starts_jax(
        jnp.asarray(x0[e]), jnp.asarray(active[e]),
        jax.random.split(jax.random.split(keys[e])[0])[0],
        opt_j.n_starts, opt_j.fresh_starts, opt_j.restart_scale))
        for e in range(n_env)])
    return xj, ej, torch.as_tensor(starts), torch.as_tensor(
        active[:, None, :])


# (envs, starts) of the XLA-path parity cases (13 qubits: fewer, as the
# XLA path's cost grows with the state)
XLA_SIZES = {"heisenberg13": (1, 2)}


@pytest.mark.parametrize("name", ["heisenberg7", "h2o8", "heisenberg13"])
def test_plain_version_matches_xla_path_complex128(name, one_thread):
    ps_j, ps_t = _problem(name)
    (n_env, s_n), cap, iters = XLA_SIZES.get(name, (2, 4)), 12, 8
    n = ps_t.n_qubits
    rng = np.random.default_rng(n)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    psi0 = _psi(rng, n)
    xj, ej, starts, active = _xla_reference(
        ps_j, psi0, old, new, maps, x0, n_rots, iters=iters, s_n=s_n, key=5)
    opt = AngleOptimizer(ps_t, iters=iters, n_starts=s_n, device="cpu")
    p0 = torch.as_tensor(psi0)
    xt, et = fused_adam2d.fused_adam_step2d(
        _ints(old), _ints(new), torch.as_tensor(maps),
        p0.real[None].contiguous(), p0.imag[None].contiguous(),
        *opt.w_planes(), starts, active, iters=iters, lr=0.1)
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-10)
    np.testing.assert_allclose(et.numpy() + opt.offset, ej, atol=1e-10)


def test_plain_v2_equals_plain_v1_float64():
    n, n_env, s_n, cap = 8, 3, 4, 16
    rng = np.random.default_rng(4)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    opt = AngleOptimizer(load_problem("H2O", n, H2O).pauli, device="cpu")
    p0 = torch.as_tensor(_psi(rng, n))
    active = torch.as_tensor(
        np.arange(cap)[None, None, :] < n_rots[:, None, None],
        dtype=torch.float64)
    starts = torch.as_tensor(
        x0[:, None, :] + 0.2 * rng.normal(size=(n_env, s_n, cap))) * active
    common = (_ints(old), _ints(new), torch.as_tensor(maps),
              p0.real[None].contiguous(), p0.imag[None].contiguous())
    # the dense H^T planes of the JAX v1 kernel through the plain step
    x1, e1 = fused_adam.fused_step_plain(
        *common, fused_adam.dense_h(*opt.h_planes()), starts, active,
        iters=6, lr=0.1)
    x2, e2 = fused_adam2d.fused_adam_step2d(
        *common, *opt.w_planes(), starts, active, iters=6, lr=0.1)
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), atol=1e-10)
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), atol=1e-10)


@pytest.mark.parametrize("n,engine", [(3, "v1"), (9, "v1"), (10, "v2"),
                                      (12, "v2"), (18, "v2"), (19, "v2"),
                                      (20, "v2"), (21, None)])
def test_engine_choice(n, engine):
    ps = PauliSum.from_strings(["Z" * n, "X" * n], [1.0, 0.5], n)
    opt = AngleOptimizer(ps, device="cpu")
    kinds = np.array([[int(GateKind.RX), int(GateKind.CX), 0]], np.int32)
    if engine is None:
        with pytest.raises(ValueError,
                           match="no fused Adam engine.*mesh_shape"):
            opt._pick_engine(kinds)
        return
    assert opt._pick_engine(kinds) == engine
    assert opt._h_planes is None and opt._w_planes is None
    for two_qubit in (GateKind.RXX, GateKind.RYY, GateKind.RZZ):
        with pytest.raises(ValueError, match="RXX/RYY/RZZ"):
            opt._pick_engine(kinds, np.where(kinds == int(GateKind.RX),
                                             int(two_qubit), kinds))


def test_wrapper_checks_and_launch_count():
    """CPU tensors take the plain version (no launch counted); a device
    without a kernel raises; RXX/RYY/RZZ are rejected on every device; the
    CUDA-only checks reject what the kernel does not take before anything
    is built."""
    n, n_env, cap = 7, 2, 6
    rng = np.random.default_rng(2)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    d = 1 << n
    ps = PauliSum.from_strings(["Z" + "I" * (n - 1), "X" * n], [1.0, 0.5], n)
    wre, wim, flips = (torch.as_tensor(a) for a in
                       fused_adam2d.pauli_flip_groups(ps))
    args = (_ints(old), _ints(new), torch.as_tensor(maps),
            torch.zeros(1, d), torch.zeros(1, d), wre, wim, flips,
            torch.zeros(n_env, 2, cap), torch.ones(n_env, 1, cap))
    before = fused_adam2d.fused_adam_step2d.launches
    x, e = fused_adam2d.fused_adam_step2d(*args, iters=2, lr=0.1)
    assert x.shape == (n_env, cap) and e.shape == (n_env,)
    assert fused_adam2d.fused_adam_step2d.launches == before
    meta = tuple(tuple(t.to("meta") for t in a) if isinstance(a, tuple)
                 else a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no kernel"):
        fused_adam2d.fused_adam_step2d(*meta, iters=2, lr=0.1)
    rzz = tuple(a.clone() for a in args[0])
    rzz[0][0, 0] = int(GateKind.RZZ)
    with pytest.raises(ValueError, match="RXX/RYY/RZZ"):
        fused_adam2d.fused_adam_step2d(rzz, *args[1:], iters=2, lr=0.1)
    ints = (*args[0], *args[1])
    floats = (*args[3:7], *args[8:])

    def check(ints=ints, floats=floats, flips=flips, starts=args[8]):
        fused_adam2d._check_inputs(ints, (*floats[:4], starts, floats[5]),
                                   args[2], flips, starts, args[9])

    check()
    with pytest.raises(TypeError, match="float32"):
        check(floats=(*floats[:2], wre.double(), *floats[3:]))
    with pytest.raises(TypeError, match="int32"):
        check(flips=flips.long())
    # any number of starts: one CTA per (env, start)
    check(starts=torch.zeros(n_env, 16, cap))
    with pytest.raises(ValueError, match="seeds"):
        fused_adam.noise_args("fused_adam_step2d", (0.01, 0.05),
                              torch.zeros(n_env, 3, dtype=torch.int32),
                              n_env, torch.device("cpu"))
    small = (torch.zeros(1, 64), torch.zeros(1, 64), wre[:, :64].clone(),
             wim[:, :64].clone(), *floats[4:])
    with pytest.raises(ValueError, match="7 <= n <= 20"):
        check(floats=small)


def test_operands2d_from_jax_carry_the_step():
    """The JAX v2 operands of the 10-qubit H2O env (flip-group planes in
    (G_f, D / 128, 128) tiles, psi0 as real planes) in the port's layout:
    float32 planes equal the port's own to float32 rounding and psi0 to
    1e-12; on float64 planes the port's fused step gives the XLA path's
    x_opt and e_new to 1e-10.  The step runs from a random complex psi0:
    from the real warm-start state, fresh rotations at angle 0 sit on
    symmetric saddles where rounding noise of either package decides the
    first Adam steps (see tests/test_torch_env.py)."""
    n = 10
    kw = dict(num_qubits=n, num_layers=30, ham_type="H2O", geometry=H2O,
              tn_placement="fixed", tn_bond=2,
              curriculum_conf={"thresholds": [1e-3], "accept_err": 1e-3,
                               "switch_episodes": [100000]})
    env_j = EnvJax(EnvConfigJax(sim_dtype="complex128", use_pallas="off",
                                **kw))
    env_t = CircuitEnv(EnvConfig(device="cpu", **kw))
    opt_t = env_t.optimizer
    ps_j = env_j.optimizer._pauli_obj
    assert env_j.optimizer._mega2d_ready()
    wre_j, wim_j, flips_j = env_j.optimizer._w2d
    (wre, wim, flips), psi0 = operands2d_from_jax(
        wre_j, wim_j, flips_j, *env_j._psi0(), n, offset=opt_t.offset,
        device="cpu")
    ref = opt_t.w_planes()
    torch.testing.assert_close(flips, ref[2], rtol=0, atol=0)
    for a, b in zip((wre, wim), ref[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(psi0.numpy(), env_t.psi0.numpy(), atol=1e-12)

    wre64, wim64, flips64 = flip_groups_jax(ps_j, dtype=np.float64)
    (wre, wim, flips), _ = operands2d_from_jax(
        wre64, wim64, flips64, *env_j._psi0(), n, offset=opt_t.offset,
        device="cpu")
    rng = np.random.default_rng(6)
    old, new, maps, x0, n_rots = _random_batch(rng, n, 2, 8)
    psi0 = _psi(rng, n)
    xj, ej, starts, active = _xla_reference(
        ps_j, psi0, old, new, maps, x0, n_rots, iters=3, s_n=2, key=2)
    p0 = torch.as_tensor(psi0)
    xt, et = fused_adam2d.fused_adam_step2d(
        _ints(old), _ints(new), torch.as_tensor(maps),
        p0.real[None].contiguous(), p0.imag[None].contiguous(), wre, wim,
        flips, starts, active, iters=3, lr=0.1)
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-10)
    np.testing.assert_allclose(et.numpy() + opt_t.offset, ej, atol=1e-10)
