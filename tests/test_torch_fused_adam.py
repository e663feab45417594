"""The fused Adam env step of the PyTorch port (ops/fused_adam.py) against
the JAX package's v1 kernel and XLA path.

- Plain step vs ``fused_adam_step_pallas(..., interpret=True)`` at 3
  qubits in float32, both with dense H^T planes (``dense_h``; the port's
  kernel takes flip-group planes): within 1e-5 (same arithmetic,
  different f32 rounding and summation order over 5 Adam iterations).
- Plain version vs the XLA path (``use_pallas=False``) at 5 qubits in
  float64/complex128: within 1e-10, with the JAX starts injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu.ops.pallas_opt import fused_adam_step_pallas
from tensorrl_qas_tpu.optim.angle_opt import AngleOptimizer as OptJax
from tensorrl_qas_tpu.optim.angle_opt import make_multistarts as starts_jax
from tensorrl_qas_tpu.problems.hamiltonians import load_problem
from tensorrl_qas_tpu.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.ops import fused_adam
from tensorrl_qas_tpu.envs import CircuitEnv as EnvJax
from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    make_multistarts,
    operands_from_jax,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    load_problem as load_problem_torch,
)


def _random_batch(rng, n, n_env, cap):
    """Per env: an old tape of CNOTs / rotations / fixed gates, a new tape
    (old plus one gate) and the angle remap, as the env builds them."""
    olds, news, maps, x0s, n_rots = [], [], [], [], []
    for _ in range(n_env):
        old = GateTape(n, cap, cap)
        new = GateTape(n, cap, cap)
        for _ in range(cap - 2):
            r = rng.random()
            t = int(rng.integers(n))
            if r < 0.3:
                c = int((t + 1 + rng.integers(n - 1)) % n)
                gate = (GateKind.CX, t, c, 0.0)
            elif r < 0.4:
                gate = (GateKind(int(rng.integers(5, 9))), t, -1, 0.0)
            else:
                gate = (GateKind(int(rng.integers(1, 4))), t, -1,
                        float(rng.normal()))
            old.add(*gate)
            new.add(*gate)
        new.add(GateKind.RY, int(rng.integers(n)))
        olds.append(old.arrays())
        news.append(new.arrays())
        maps.append(np.where(np.arange(cap) < old.n_rots, np.arange(cap),
                             -1).astype(np.int32))
        x0s.append(old.x0())
        n_rots.append(old.n_rots)

    def stack(t):
        return tuple(np.stack([a[k] for a in t]) for k in range(4))

    return (stack(olds), stack(news), np.stack(maps), np.stack(x0s),
            np.asarray(n_rots))


def _ints(arrs):
    return tuple(torch.as_tensor(a, dtype=torch.int32) for a in arrs)


def test_plain_version_matches_pallas_v1_interpret():
    n, n_env, s_n, cap, iters = 3, 2, 3, 10, 5
    rng = np.random.default_rng(0)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    ps = PauliSum.from_strings(["ZII", "IZI", "IIZ", "XXI", "IYY", "XZY"],
                               [1.0, 0.5, -0.7, 0.9, 1.3, 0.4], n)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    active = (np.arange(cap)[None, None, :]
              < n_rots[:, None, None]).astype(np.float32)
    starts = (x0[:, None, :] + 0.3 * rng.normal(size=(n_env, s_n, cap))
              ).astype(np.float32) * active
    ht = ps.to_dense().T
    # the TPU kernel wants 128 lanes: zero-pad state and H (as
    # AngleOptimizer._mega_ready does); padded lanes never mix in
    pad = 128
    htp = np.zeros((pad, pad), complex)
    htp[: 1 << n, : 1 << n] = ht
    p0 = np.zeros(pad, complex)
    p0[: 1 << n] = psi0
    f32 = jnp.float32
    xj, ej = fused_adam_step_pallas(
        tuple(map(jnp.asarray, old)), tuple(map(jnp.asarray, new)),
        jnp.asarray(maps), jnp.asarray(p0.real[None], f32),
        jnp.asarray(p0.imag[None], f32), jnp.asarray(htp.real, f32),
        jnp.asarray(htp.imag, f32), jnp.asarray(starts), jnp.asarray(active),
        iters=iters, lr=0.1, interpret=True)

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    xt, et = fused_adam.fused_step_plain(
        _ints(old), _ints(new), torch.as_tensor(maps), t32(psi0.real[None]),
        t32(psi0.imag[None]), fused_adam.dense_h(t32(ht.real), t32(ht.imag)),
        t32(starts), t32(active), iters=iters, lr=0.1)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-5)


def test_plain_version_matches_xla_path_complex128():
    n, n_env, cap = 5, 3, 14
    rng = np.random.default_rng(1)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    problem = load_problem("heisenberg", n)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    opt_j = OptJax(problem.pauli.device_arrays(jnp.complex128), iters=12,
                   n_starts=4, lr=0.1, dtype=jnp.complex128)
    keys = jax.random.split(jax.random.PRNGKey(5), n_env)
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

    opt_t = AngleOptimizer(load_problem_torch("heisenberg", n).pauli,
                           iters=12, n_starts=4, lr=0.1, device="cpu")
    p0 = torch.as_tensor(psi0)
    xt, et = fused_adam.fused_adam_step(
        _ints(old), _ints(new), torch.as_tensor(maps),
        p0.real[None].contiguous(), p0.imag[None].contiguous(),
        *opt_t.w_planes(), torch.as_tensor(starts),
        torch.as_tensor(active[:, None, :]), iters=12, lr=0.1)
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-10)
    np.testing.assert_allclose(et.numpy() + opt_t.offset, ej, atol=1e-10)


def test_wrapper_dispatch_and_launch_count():
    """CPU tensors take the plain version (no launch counted); a device
    without a kernel raises; CUDA-only checks reject what the kernel does
    not take before anything is built."""
    n, n_env, cap = 3, 2, 6
    rng = np.random.default_rng(2)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    d = 1 << n
    # H = Z on qubit 0: one flip group (f = 0)
    args = (_ints(old), _ints(new), torch.as_tensor(maps),
            torch.zeros(1, d), torch.zeros(1, d),
            1.0 - 2.0 * (torch.arange(d) & 1).float()[None],
            torch.zeros(1, d), torch.zeros(1, dtype=torch.int32),
            torch.zeros(n_env, 2, cap), torch.ones(n_env, 1, cap))
    before = fused_adam.fused_adam_step.launches
    x, e = fused_adam.fused_adam_step(*args, iters=2, lr=0.1)
    assert x.shape == (n_env, cap) and e.shape == (n_env,)
    assert fused_adam.fused_adam_step.launches == before
    meta = tuple(tuple(t.to("meta") for t in a) if isinstance(a, tuple)
                 else a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no kernel"):
        fused_adam.fused_adam_step(*meta, iters=2, lr=0.1)
    ints = (*args[0], *args[1])
    floats = (*args[3:7], *args[8:])

    def check(ints=ints, floats=floats, flips=args[7], starts=args[8]):
        return fused_adam._check_inputs(
            ints, (*floats[:4], starts, floats[5]), args[2], flips, starts,
            args[9])

    with pytest.raises(TypeError, match="float32"):
        check(floats=(*floats[:-1], floats[-1].double()))
    with pytest.raises(TypeError, match="int32"):
        check(flips=args[7].long())
    # any number of starts: the kernel takes them in rounds of groups
    assert check(starts=torch.zeros(n_env, 16, cap))[1] == 16
    big = tuple(torch.zeros(1, 1024) for _ in range(2))
    with pytest.raises(ValueError, match="1 <= n <= 9"):
        check(floats=(*big, torch.zeros(1, 1024), torch.zeros(1, 1024),
                      *floats[4:]))
    seeds = torch.zeros(n_env, 2, dtype=torch.int32)
    assert fused_adam.noise_args("fused_adam_step", None, None, n_env,
                                 seeds.device) == (None, 0, 0)
    assert fused_adam.noise_args("fused_adam_step", (0.01, 0.05), seeds,
                                 n_env, seeds.device)[1:] == (167773, 838861)
    with pytest.raises(ValueError, match="seeds"):
        fused_adam.noise_args("fused_adam_step", (0.01, 0.05),
                              seeds.long(), n_env, seeds.device)
    bad_kind = tuple(a.clone() for a in ints)
    bad_kind[0][0, 0] = int(GateKind.RXX)
    with pytest.raises(ValueError, match="RXX"):
        check(ints=bad_kind)


def _agreement_case():
    """float32 fused-step inputs at 5 qubits (6 envs, 4 starts, G = R =
    10, numpy seed 3) and each env's live angle count."""
    n, n_env, cap = 5, 6, 10
    rng = np.random.default_rng(3)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    w_planes = AngleOptimizer(load_problem_torch("heisenberg", n).pauli,
                              device="cpu").w_planes()
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    f32 = dict(dtype=torch.float32)
    active = torch.as_tensor(
        np.arange(cap)[None, :] < n_rots[:, None], **f32)
    starts = torch.as_tensor(
        x0[:, None, :] + 0.1 * rng.normal(size=(n_env, 4, cap)),
        **f32) * active[:, None, :]
    args = (_ints(old), _ints(new), torch.as_tensor(maps),
            torch.as_tensor(psi0.real[None], **f32),
            torch.as_tensor(psi0.imag[None], **f32),
            *(w.float() for w in w_planes[:2]), w_planes[2],
            starts.contiguous(), active[:, None, :].contiguous())
    return args, n_rots


def _wrong_results(args):
    """Two wrong results: Adam's rate off by 1%, and the RY angles'
    gradients dropped; and the envs that have RY angles."""
    wrong = [fused_adam.fused_adam_step_reference(*args, iters=3, lr=0.101)]
    ry = (args[0][0] == int(GateKind.RY)) & (args[0][3] >= 0)
    keep = torch.ones_like(args[9])
    for env, g in ry.nonzero().tolist():
        keep[env, 0, args[0][3][env, g]] = 0.0
    wrong.append(fused_adam.fused_adam_step_reference(
        *args[:9], (args[9] * keep).contiguous(), iters=3, lr=0.1))
    return wrong, ry.any(dim=1)


def test_agreement_accepts_the_plain_version_and_rejects_wrong_results():
    """The kernel check (``agreement``) on float32 inputs: the plain
    version's own result and one computed with the H planes rounded
    differently agree in every env; a result with Adam's rate off by 1%
    is rejected in the envs with several angles, and one with the RY
    angles' gradients dropped in exactly the envs that have RY angles."""
    args, n_rots = _agreement_case()
    ref = fused_adam.plain_results(args, iters=3, lr=0.1)
    assert len(ref) == 6
    for x, e in (ref[0], ref[-1]):
        ok, _, _ = fused_adam.agreement(args, ref, x, e, tol=1e-5)
        assert bool(ok.all())
    ((x, e), (x_ry, e_ry)), has_ry = _wrong_results(args)
    ok, _, _ = fused_adam.agreement(args, ref, x, e, tol=1e-5)
    assert bool((~ok)[torch.as_tensor(n_rots) >= 4].all())
    ok, _, _ = fused_adam.agreement(args, ref, x_ry, e_ry, tol=1e-5)
    assert torch.equal(~ok, has_ry)             # every env with an RY angle


def test_agreement_cache_gives_what_no_cache_gives():
    """``agreement`` with a ``cache`` shared by a result and its controls
    gives what it gives without one, the float64 energies of the
    reference's runs computed once (one per run: (runs, envs))."""
    args, _ = _agreement_case()
    ref = fused_adam.plain_results(args, iters=3, lr=0.1)
    wrong, _ = _wrong_results(args)
    cache = {}
    for x, e in (ref[-1], *wrong):
        plain = fused_adam.agreement(args, ref, x, e, tol=1e-5)
        cached = fused_adam.agreement(args, ref, x, e, tol=1e-5,
                                      cache=cache)
        assert torch.equal(plain[0], cached[0])
        assert torch.equal(plain[1], cached[1])
        assert plain[2] == cached[2]
    assert set(cache) == {"e_old"} and cache["e_old"].shape == (6, 6)

def test_operands_from_jax_match_the_port():
    """The JAX v1 operands (H^T planes padded to 128 lanes, psi0 as real
    planes) converted to the port's layout equal the port's own: the H
    planes to float32 rounding (JAX keeps them in float32), the warm-start
    psi0 of the 5q env to 1e-12 (both complex128)."""
    kw = dict(num_qubits=5, num_layers=12, ham_type="heisenberg",
              tn_placement="fixed", tn_bond=2,
              curriculum_conf={"thresholds": [1e-3], "accept_err": 1e-3,
                               "switch_episodes": [100000]})
    env_j = EnvJax(EnvConfigJax(sim_dtype="complex128", **kw))
    env_t = CircuitEnv(EnvConfig(device="cpu", **kw))
    opt_j = env_j.optimizer
    assert opt_j._mega_ready() and opt_j._hre_t.shape == (128, 128)
    (hre_t, him_t), psi0 = operands_from_jax(
        opt_j._hre_t, opt_j._him_t, *env_j._psi0(), 5,
        offset=env_t.optimizer.offset, device="cpu")
    ref_re, ref_im = env_t.optimizer.h_planes()
    np.testing.assert_allclose(hre_t.numpy(), ref_re.numpy(), atol=1e-5)
    np.testing.assert_allclose(him_t.numpy(), ref_im.numpy(), atol=1e-5)
    np.testing.assert_allclose(psi0.numpy(), env_t.psi0.numpy(), atol=1e-12)


def test_optimizer_takes_sixteen_starts():
    """Sixteen starts (the kernel takes them in one CTA, in rounds where
    its thread cap requires): the optimizer steps with 16, and the winner
    is chosen over all of them at once --
    x_opt is the result of the start whose best old-tape energy is least
    (each start's Adam run is independent of the others)."""
    n, n_env, cap = 5, 2, 8
    rng = np.random.default_rng(7)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    opt = AngleOptimizer(load_problem_torch("heisenberg", n).pauli, iters=6,
                         n_starts=16, lr=0.1, device="cpu", seed=4)
    psi0 = torch.as_tensor(rng.normal(size=1 << n)
                           + 1j * rng.normal(size=1 << n))
    psi0 = psi0 / psi0.norm()
    x_opt, e_new, nfev = opt.fused_step_batch(psi0, old, x0, n_rots, new,
                                              maps)
    assert x_opt.shape == (n_env, cap) and np.isfinite(e_new).all()
    assert nfev == 6 * 16
    # the same starts, one at a time
    gen = torch.Generator().manual_seed(4)
    active = torch.as_tensor(np.arange(cap)[None, :] < n_rots[:, None],
                             dtype=torch.float64)
    starts = make_multistarts(torch.as_tensor(x0), active, 16, 4, 0.1, gen)
    head = (_ints(old), _ints(new), torch.as_tensor(maps),
            psi0.real[None].contiguous(), psi0.imag[None].contiguous(),
            *opt.w_planes())
    ident = torch.arange(cap, dtype=torch.int32).repeat(n_env, 1)
    singles, energies = [], []
    for s in range(16):
        xs, _ = fused_adam.fused_adam_step(
            *head, starts[:, s:s + 1].contiguous(), active[:, None, :],
            iters=6, lr=0.1)
        _, es = fused_adam.fused_adam_step(
            head[0], head[0], ident, *head[3:], xs[:, None, :],
            active[:, None, :], iters=0, lr=0.0)
        singles.append(xs)
        energies.append(es)
    best = torch.stack(energies).argmin(0)
    want = torch.stack(singles)[best, torch.arange(n_env)]
    np.testing.assert_allclose(x_opt, want.numpy(), atol=1e-12)
