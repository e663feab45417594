"""Depolarizing noise in the PyTorch port (sim/noise.py, the noise variant of
the fused step, the noisy optimizer, env and CLI) against the JAX package
and the exact Kraus channel, on the CPU.

- Philox4x32-10 reproduces Random123's known-answer vectors: exact.
- Fire rates and codes of both draws (generator and Philox) within 5
  sigma of p1, p2 and the uniform code distributions.
- ``extend_tape_arrays`` equals the JAX function on the same kinds: exact.
- The plain noisy v1 / v2 steps with all-zero draws equal
  ``fused_adam_step_pallas(2d)(..., noise=...)`` in interpret mode (whose
  generator returns zero bits: every error fires as X on the target), f32,
  within 1e-5; at p = 0 the noisy steps equal the noiseless ones bit for
  bit.
- Trajectory means (the plain step's Philox draws, ``apply_tape_depolarizing``)
  lie within 5 sigma + 1e-3 of the Kraus channel of
  ``tests/test_noise_pallas.py:_kraus_expectation``, which the port's own
  ``depolarizing_energy_exact`` matches to 1e-12.
- The noisy env on configs/TensorRL_fixed/H2O8q_TNbond2_noise.cfg steps
  and reports error == error_noiseless; shot noise and n_traj > 1 run in
  the composed engine (tests/test_torch_su4.py) and are refused with the
  su4 gate set, which is noiseless-only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorrl_qas_tpu.ops.pallas_opt import fused_adam_step_pallas
from tensorrl_qas_tpu.ops.pallas_opt2d import fused_adam_step_pallas2d
from tensorrl_qas_tpu.ops.pallas_opt2d import (
    pauli_flip_groups as flip_groups_jax,
)
from tensorrl_qas_tpu.optim.angle_opt import (
    extend_tape_arrays as extend_jax,
)
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    extend_tape_arrays,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.sim.expectation import (
    PauliSum,
    pauli_expectation,
)
from tensorrl_qas_tpu_torch.sim.noise import (
    apply_tape_depolarizing,
    depolarizing_draw,
    depolarizing_energy_exact,
    noise_thresholds,
    philox4x32,
    philox_words,
    sample_depolarizing_kinds,
)
from tensorrl_qas_tpu_torch.train.cli import infer_modes
from tensorrl_qas_tpu_torch.train.config import get_config
from tests.test_noise_pallas import _kraus_expectation, _test_tape
from tests.test_torch_fused_adam import _ints, _random_batch

PAULIS = ["ZII", "IZI", "IIZ", "XXI", "IYY", "XZY"]
WEIGHTS = [1.0, 0.5, -0.7, 0.9, 1.3, 0.4]
NOISE = (0.3, 0.5)


def _zero_draw(seeds, n_gates, tag):
    z = torch.zeros((seeds.shape[0], n_gates), dtype=torch.int64)
    return z, z, z


def _t32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, expect):
    words = philox4x32(ctr, key)
    assert " ".join(f"{int(w):08x}" for w in words) == expect


@pytest.mark.parametrize("source", ["generator", "philox"])
def test_draw_rates_and_codes(source):
    """Fire rates within 5 sigma of p1 (rotations) and p2 (CX); the codes
    of the fired errors uniform over 1..3 and over the 15 Pauli pairs."""
    p1, p2 = 0.2, 0.3
    n_env, n_gates = 4000, 50
    kind = torch.full((n_env, n_gates), int(GateKind.RX))
    kind[:, 1::2] = int(GateKind.CX)
    if source == "generator":
        gen = torch.Generator().manual_seed(0)
        k_t, k_c = sample_depolarizing_kinds(kind, gen, p1, p2)
    else:
        seeds = torch.randint(0, 2**31 - 1, (n_env, 2),
                              generator=torch.Generator().manual_seed(0),
                              dtype=torch.int32)
        k_t, k_c = depolarizing_draw(kind, seeds, 7, noise_thresholds(p1, p2))
    x = int(GateKind.X)
    code_t = torch.where(k_t > 0, k_t - x + 1, 0)
    code_c = torch.where(k_c > 0, k_c - x + 1, 0)
    rot, cx = kind == int(GateKind.RX), kind == int(GateKind.CX)
    assert not bool((k_c[rot] != 0).any())
    for mask, p, fired in ((rot, p1, code_t[rot] > 0),
                           (cx, p2, (code_t[cx] + code_c[cx]) > 0)):
        n = int(mask.sum())
        sigma = np.sqrt(p * (1 - p) / n)
        assert abs(float(fired.float().mean()) - p) < 5 * sigma
    for codes, n_codes in ((code_t[rot][code_t[rot] > 0], 3),
                           ((4 * code_c + code_t)[cx][
                               (4 * code_c + code_t)[cx] > 0], 15)):
        counts = torch.bincount(codes, minlength=n_codes + 1)[1:].double()
        n, q = float(counts.sum()), 1.0 / n_codes
        assert counts.numel() == n_codes
        assert bool(((counts / n - q).abs()
                     < 5 * np.sqrt(q * (1 - q) / n)).all())


def test_extend_tape_arrays_matches_jax():
    rng = np.random.default_rng(4)
    old, _, _, _, _ = _random_batch(rng, 4, 3, 9)
    kt = rng.choice([0, 5, 6, 7], size=old[0].shape).astype(np.int32)
    kc = rng.choice([0, 5, 6, 7], size=old[0].shape).astype(np.int32)
    ref = extend_jax(tuple(map(jnp.asarray, old)), jnp.asarray(kt),
                     jnp.asarray(kc))
    got = extend_tape_arrays(tuple(map(torch.as_tensor, old)),
                             torch.as_tensor(kt), torch.as_tensor(kc))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _batch_v1(seed=0, n=3, n_env=2, s_n=3, cap=10):
    rng = np.random.default_rng(seed)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    active = (np.arange(cap)[None, None, :]
              < n_rots[:, None, None]).astype(np.float32)
    starts = (x0[:, None, :] + 0.3 * rng.normal(size=(n_env, s_n, cap))
              ).astype(np.float32) * active
    seeds = rng.integers(0, 2**31 - 1, size=(n_env, 2)).astype(np.int32)
    return old, new, maps, psi0, starts, active, seeds


def test_plain_noisy_v1_with_zero_draws_matches_pallas_interpret():
    iters = 4
    old, new, maps, psi0, starts, active, seeds = _batch_v1()
    ht = PauliSum.from_strings(PAULIS, WEIGHTS, 3).to_dense().T
    pad = 128       # the TPU kernel's lane minimum; padded lanes never mix
    htp = np.zeros((pad, pad), complex)
    htp[:8, :8] = ht
    p0 = np.zeros(pad, complex)
    p0[:8] = psi0
    f32 = jnp.float32
    jax_args = (tuple(map(jnp.asarray, old)), tuple(map(jnp.asarray, new)),
                jnp.asarray(maps), jnp.asarray(p0.real[None], f32),
                jnp.asarray(p0.imag[None], f32), jnp.asarray(htp.real, f32),
                jnp.asarray(htp.imag, f32), jnp.asarray(starts),
                jnp.asarray(active))
    xj, ej = fused_adam_step_pallas(*jax_args, iters=iters, lr=0.1,
                                    interpret=True, noise=NOISE,
                                    seeds=jnp.asarray(seeds))
    xc, ec = fused_adam_step_pallas(*jax_args, iters=iters, lr=0.1,
                                    interpret=True)
    # the premise: the interpreter's zero bits do fire errors
    assert np.abs(np.asarray(xj) - np.asarray(xc)).max() > 1e-2
    args = (_ints(old), _ints(new), torch.as_tensor(maps),
            _t32(psi0.real[None]), _t32(psi0.imag[None]), _t32(ht.real),
            _t32(ht.imag), _t32(starts), _t32(active))
    # the JAX kernel takes dense H^T planes: the plain step with dense_h
    xt, et = fused_adam.fused_step_plain(
        *args[:5], fused_adam.dense_h(*args[5:7]), *args[7:], iters=iters,
        lr=0.1, noise=NOISE, seeds=torch.as_tensor(seeds), draw=_zero_draw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-5)


def test_plain_noisy_v2_with_zero_draws_matches_pallas_interpret():
    n, iters = 7, 3
    old, new, maps, psi0, starts, active, seeds = _batch_v1(seed=1, n=n)
    rng = np.random.default_rng(1)
    paulis = ["I" * n] + ["".join(rng.choice(list("IXYZ"), size=n))
                          for _ in range(23)]
    weights = rng.normal(size=24)
    ps_j = PauliSumJax.from_strings(paulis, weights, n)
    wre_j, wim_j, flips_j = flip_groups_jax(ps_j)
    f32 = jnp.float32
    jax_args = (tuple(map(jnp.asarray, old)), tuple(map(jnp.asarray, new)),
                jnp.asarray(maps), jnp.asarray(psi0.real.reshape(1, 128), f32),
                jnp.asarray(psi0.imag.reshape(1, 128), f32),
                jnp.asarray(wre_j), jnp.asarray(wim_j), flips_j,
                jnp.asarray(starts), jnp.asarray(active))
    xj, ej = fused_adam_step_pallas2d(*jax_args, iters=iters, lr=0.1,
                                      interpret=True, noise=NOISE,
                                      seeds=jnp.asarray(seeds))
    opt = AngleOptimizer(PauliSum.from_strings(paulis, weights, n),
                         device="cpu")
    wre, wim, flips = (t.float() if t.is_floating_point() else t
                       for t in opt.w_planes())
    args = (_ints(old), _ints(new), torch.as_tensor(maps),
            _t32(psi0.real[None]), _t32(psi0.imag[None]), wre, wim, flips,
            _t32(starts), _t32(active))
    xc, _ = fused_adam2d.fused_adam_step2d_reference(*args, iters=iters,
                                                     lr=0.1)
    xt, et = fused_adam2d.fused_adam_step2d_reference(
        *args, iters=iters, lr=0.1, noise=NOISE,
        seeds=torch.as_tensor(seeds), draw=_zero_draw)
    assert (xt - xc).abs().max() > 1e-2        # the zero draws fire errors
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(et.numpy() + opt.offset, np.asarray(ej),
                               atol=1e-5)


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_noisy_step_at_p0_is_the_noiseless_step(engine):
    n = 3 if engine == "v1" else 7
    old, new, maps, psi0, starts, active, seeds = _batch_v1(seed=2, n=n)
    rng = np.random.default_rng(n)
    paulis = ["".join(rng.choice(list("IXYZ"), size=n)) for _ in range(12)]
    opt = AngleOptimizer(PauliSum.from_strings(paulis, rng.normal(size=12),
                                               n), device="cpu")
    step = (fused_adam.fused_adam_step if engine == "v1"
            else fused_adam2d.fused_adam_step2d)
    args = (_ints(old), _ints(new), torch.as_tensor(maps),
            torch.as_tensor(psi0.real[None]), torch.as_tensor(psi0.imag[None]),
            *opt.w_planes(), torch.as_tensor(starts, dtype=torch.float64),
            torch.as_tensor(active, dtype=torch.float64))
    x0, e0 = step(*args, iters=5, lr=0.1)
    xp, ep = step(*args, iters=5, lr=0.1, noise=(0.0, 0.0),
                  seeds=torch.as_tensor(seeds))
    assert torch.equal(x0, xp) and torch.equal(e0, ep)


def _kraus_problem():
    p1, p2 = 0.15, 0.25
    tape = _test_tape(3)
    ps_j = PauliSumJax.from_strings(PAULIS[:5], WEIGHTS[:5], 3)
    exact = _kraus_expectation(tape, ps_j, p1, p2, 3)
    return tape, PauliSum.from_strings(PAULIS[:5], WEIGHTS[:5], 3), exact, \
        (p1, p2)


def test_exact_channel_matches_the_jax_test_oracle():
    tape, ps, exact, (p1, p2) = _kraus_problem()
    got = depolarizing_energy_exact(zero_state(3), *tape.arrays(), tape.x0(),
                                    ps.to_dense(), p1, p2)
    assert abs(got - exact) < 1e-12


def test_plain_step_trajectories_match_kraus():
    """lr = 0 and an identity map keep x_new = x0, so each env's e_new is
    one trajectory sample under its Philox stream."""
    tape, ps, exact, p = _kraus_problem()
    n_env = 1500
    arrs = tuple(torch.as_tensor(a).repeat(n_env, 1).to(torch.int32)
                 for a in tape.arrays())
    r = len(tape.x0())
    x0 = torch.as_tensor(tape.x0()).repeat(n_env, 1, 1)
    maps = torch.arange(r, dtype=torch.int32).repeat(n_env, 1)
    opt = AngleOptimizer(ps, device="cpu")
    psi0 = zero_state(3)
    seeds = torch.randint(0, 2**31 - 1, (n_env, 2), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(3))
    _, e_new = fused_adam.fused_adam_step(
        arrs, arrs, maps, psi0.real[None], psi0.imag[None], *opt.w_planes(),
        x0, torch.ones(n_env, 1, r, dtype=torch.float64), iters=1, lr=0.0,
        noise=p, seeds=seeds)
    es = e_new.numpy() + opt.offset
    sigma = es.std() / np.sqrt(n_env)
    assert es.std() > 0.0
    assert abs(es.mean() - exact) < 5 * sigma + 1e-3


def test_apply_tape_depolarizing_matches_kraus_and_p0():
    tape, ps, exact, (p1, p2) = _kraus_problem()
    n_traj = 1500
    psi = zero_state(3).expand(n_traj, -1)
    gen = torch.Generator().manual_seed(5)
    out = apply_tape_depolarizing(psi, *tape.arrays(), tape.x0(), gen, p1, p2)
    es = pauli_expectation(out, *ps.tensors("cpu")).numpy()
    sigma = es.std() / np.sqrt(n_traj)
    assert es.std() > 0.0
    assert abs(es.mean() - exact) < 5 * sigma + 1e-3
    clean = apply_tape(zero_state(3), *tape.arrays(), tape.x0())
    quiet = apply_tape_depolarizing(zero_state(3), *tape.arrays(), tape.x0(),
                                    gen, 0.0, 0.0)
    assert torch.equal(quiet, clean)


def _opt_inputs(n=5, n_env=3, cap=8, seed=6):
    rng = np.random.default_rng(seed)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    paulis = ["".join(rng.choice(list("IXYZ"), size=n)) for _ in range(10)]
    ps = PauliSum.from_strings(paulis, rng.normal(size=10), n)
    psi0 = torch.as_tensor(rng.normal(size=1 << n)
                           + 1j * rng.normal(size=1 << n))
    return ps, (psi0 / psi0.norm(), old, x0, n_rots, new, maps)


@pytest.mark.parametrize("resample", ["iter", "step"])
def test_optimizer_noise_at_p0_is_noiseless(resample):
    """Both resample modes at p = 0 give the noiseless step exactly: the
    starts come first from the same generator, and no error fires."""
    ps, inputs = _opt_inputs()
    clean = AngleOptimizer(ps, iters=4, n_starts=3, device="cpu", seed=2)
    noisy = AngleOptimizer(ps, iters=4, n_starts=3, device="cpu", seed=2,
                           noise_mode="depolarizing", noise_p1=0.0,
                           noise_p2=0.0, noise_resample=resample)
    xc, ec, _ = clean.fused_step_batch(*inputs)
    xn, en, _ = noisy.fused_step_batch(*inputs)
    np.testing.assert_array_equal(xn, xc)
    np.testing.assert_array_equal(en, ec)


@pytest.mark.parametrize("resample", ["iter", "step"])
def test_optimizer_noise_changes_the_step(resample):
    ps, inputs = _opt_inputs()
    clean = AngleOptimizer(ps, iters=4, n_starts=3, device="cpu", seed=2)
    noisy = AngleOptimizer(ps, iters=4, n_starts=3, device="cpu", seed=2,
                           noise_mode="depolarizing", noise_p1=0.5,
                           noise_p2=0.5, noise_resample=resample)
    _, ec, _ = clean.fused_step_batch(*inputs)
    _, en, _ = noisy.fused_step_batch(*inputs)
    assert np.isfinite(en).all() and np.abs(en - ec).max() > 1e-6


def test_noise_config_env_steps_on_the_cpu():
    conf = get_config("TensorRL_fixed/", "H2O8q_TNbond2_noise.cfg")
    conf["non_local_opt"]["global_iters"] = 3
    conf["env"]["n_starts"] = 2
    placement, noise_mode, _ = infer_modes("TensorRL_fixed/",
                                           "H2O8q_TNbond2_noise")
    cfg = EnvConfig.from_conf(conf, tn_placement=placement,
                              noise_mode=noise_mode, seed=1, device="cpu")
    assert cfg.noise_mode == "depolarizing" and cfg.noise_values == ()
    venv = VectorCircuitEnv(cfg, n_envs=2)
    opt = venv.optimizer
    assert (opt.noise_p1, opt.noise_p2) == (0.01, 0.05)
    venv.reset_all()
    for acts in ([(0, 1, 8, 0), (8, 0, 2, 2)], [(1, 2, 8, 0), (8, 0, 3, 1)]):
        _, rewards, _, infos = venv.step_all(acts)
        assert np.isfinite(rewards).all()
        assert all(np.isfinite(i["energy"]) for i in infos)
    for env in venv.envs:
        assert env.error == env.error_noiseless


@pytest.mark.parametrize("setting", [dict(noise_mode="shot", n_shots=100),
                                     dict(noise_mode="depolarizing",
                                          n_traj=2)])
def test_composed_engine_settings_are_refused(setting):
    """Shot noise and n_traj > 1 take the composed engine (no longer
    refused since it is ported) and run; the env refuses them with the
    su4 gate set, noiseless-only as in the JAX package."""
    ps, inputs = _opt_inputs()
    opt = AngleOptimizer(ps, iters=2, n_starts=2, device="cpu", **setting)
    assert opt._pick_engine(inputs[1][0]) == "composed"
    x_opt, e_new, _ = opt.fused_step_batch(*inputs)
    assert np.isfinite(x_opt).all() and np.isfinite(e_new).all()
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed",
                              noise_mode=setting["noise_mode"], device="cpu")
    cfg.n_traj = setting.get("n_traj", 1)
    VectorCircuitEnv(cfg, n_envs=1)
    cfg.gate_set = "su4"
    with pytest.raises(NotImplementedError, match="noiseless-only"):
        VectorCircuitEnv(cfg, n_envs=1)


def test_philox_words_follow_the_draw_definition():
    """The (E, G) words are Philox at key seeds[e], counter (g, tag, 0, 0)
    (the CUDA kernels' layout)."""
    seeds = torch.tensor([[5, 9], [-1, 2**31 - 1]], dtype=torch.int32)
    w = philox_words(seeds, 3, 11)
    for e in range(2):
        for g in range(3):
            ref = philox4x32((g, 11, 0, 0), (int(seeds[e, 0]) & 0xFFFFFFFF,
                                             int(seeds[e, 1])))
            assert [int(x[e, g]) for x in w] == [int(r) for r in ref[:3]]
