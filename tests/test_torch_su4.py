"""The composed engine (``AngleOptimizer._fused_step_composed``) and the
modes it serves, on the CPU: the su4 gate set, shot noise and
depolarizing noise averaged over ``n_traj > 1`` trajectories.

- The composed step on the plain kernels against the JAX package's
  ``AngleOptimizer._fused_step_pallas`` with ``pallas_interpret=True``,
  float32, identical starts (``restart_scale=0`` and three starts: the
  warm start three times; a zero start would sit on symmetric saddles
  whose first Adam step float32 rounding decides): su4 tapes, shot mode at ``n_shots=0``, and depolarizing
  noise with ``n_traj=2``, where both draw the same injected error kinds
  (the JAX optimizer's ``_sample_noise_kinds`` patched on the instance).
  Tolerance 1e-5 on x_opt and e_new: float32 in another summation order.
- Shot noise: mean 0 and standard deviation ||w|| / sqrt(n_shots), each
  within 5 sigma; the trajectory mean of ``n_traj`` realizations against
  ``depolarizing_energy_exact`` within 5 sigma + 1e-3 (the rule of
  tests/test_noise_pallas.py).
- The su4 env (5 qubits, no warm start, complex128, one start) against
  the JAX su4 env of tests/test_su4_env.py:_su4_env: energies and rewards
  to 1e-7 (Adam's eps amplifies rounding at symmetric saddles, as in
  tests/test_torch_env.py), observations exact; the su4 agent's state size
  and action table against the JAX agent's; ``--gate_set su4`` and the
  shot-noise ``_restricted`` config through the CLI.
- The fixed placement's su4 psi0 for 8-qubit H2O is the su4 warm start
  with its two-qubit rotations applied (about -73.2915 Ha), not the JAX
  env's -70.3655 Ha, which drops them (ROADMAP.md, C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.agents.dqn import make_agent as make_agent_jax
from tensorrl_qas_tpu.envs import CircuitEnv as EnvJax
from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu.optim.angle_opt import AngleOptimizer as OptJax
from tensorrl_qas_tpu.sim.apply import apply_tape as apply_tape_jax
from tensorrl_qas_tpu.sim.apply import zero_state as zero_state_jax
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu.sim.expectation import pauli_expectation as pexp_jax
from tensorrl_qas_tpu_torch.agents.dqn import make_agent
from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.ops.fused_adam import _h_energy, flip_h
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    flip_h_batched,
    make_multistarts,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.sim.expectation import (
    PauliSum,
    pauli_expectation,
)
from tensorrl_qas_tpu_torch.sim.noise import (
    depolarizing_energy_exact,
    kinds_from_codes,
)
from tensorrl_qas_tpu_torch.train import cli
from tensorrl_qas_tpu_torch.train.config import get_config

TOL_F32 = 1e-5
TOL_ENV = 1e-7
H2O = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"
SU4_KINDS = (GateKind.RXX, GateKind.RYY, GateKind.RZZ, GateKind.RX,
             GateKind.RY, GateKind.RZ)
CNOT_KINDS = (GateKind.CX, GateKind.RX, GateKind.RY, GateKind.RZ)


def _pauli(n, seed=0, k=12):
    rng = np.random.default_rng(seed)
    strings = ["I" * n] + ["".join(rng.choice(list("IXYZ"), size=n))
                           for _ in range(k)]
    weights = np.concatenate([[0.3], rng.normal(size=k)])
    return (PauliSum.from_strings(strings, weights, n),
            PauliSumJax.from_strings(strings, weights, n))


def _batch(rng, n, n_env, cap, kinds):
    """Random mid-episode tapes (old, new = old plus one rotation), the
    identity angle map, warm starts and live-angle counts."""
    olds, news, x0s, n_rots = [], [], [], []
    for _ in range(n_env):
        old, new = GateTape(n, cap, cap), GateTape(n, cap, cap)
        for _ in range(int(rng.integers(cap // 2, cap))):
            k = kinds[int(rng.integers(len(kinds)))]
            t = int(rng.integers(n))
            c = (int((t + 1 + rng.integers(n - 1)) % n)
                 if k in (GateKind.CX, GateKind.RXX, GateKind.RYY,
                          GateKind.RZZ) else -1)
            ang = float(rng.normal()) if k != GateKind.CX else 0.0
            old.add(k, t, c, ang)
            new.add(k, t, c, ang)
        new.add(GateKind.RY, int(rng.integers(n)))
        olds.append(old.arrays())
        news.append(new.arrays())
        x0s.append(old.x0())
        n_rots.append(old.n_rots)
    maps = np.stack([np.where(np.arange(cap) < k, np.arange(cap), -1)
                     for k in n_rots]).astype(np.int32)

    def stack(tapes):
        return tuple(np.stack([t[k] for t in tapes]).astype(np.int32)
                     for k in range(4))
    return stack(olds), stack(news), maps, np.stack(x0s), np.asarray(n_rots)


def _draws(n_traj, shape, seed=9):
    """Fixed error draws per trajectory: (u, code3, code15) numpy arrays."""
    rng = np.random.default_rng(seed)
    return [(rng.random(shape), rng.integers(1, 4, shape),
             rng.integers(1, 16, shape)) for _ in range(n_traj)]


def _jax_kinds(draws, p1, p2):
    """A ``_sample_noise_kinds`` for the JAX optimizer that returns the
    fixed draws of trajectory t on its t-th call (modulo n_traj: every
    trace evaluates the trajectories in order)."""
    calls = [0]
    x_kind, none = int(GateKind.X), int(GateKind.NONE)

    def sample(kind, key):
        u, c3, c15 = (jnp.asarray(a) for a in draws[calls[0] % len(draws)])
        calls[0] += 1
        is_rot = (kind >= int(GateKind.RX)) & (kind <= int(GateKind.RZ))
        fire1 = is_rot & (u < p1)
        fire2 = (kind == int(GateKind.CX)) & (u < p2)

        def pk(code):
            return jnp.where(code == 0, none, x_kind + code - 1)
        kt = jnp.where(fire1, pk(c3), jnp.where(fire2, pk(c15 % 4), none))
        kc = jnp.where(fire2, pk(c15 // 4), none)
        return kt.astype(kind.dtype), kc.astype(kind.dtype)
    return sample


def _torch_kinds(draws, p1, p2):
    def sample(kind, n_traj, generator):
        out = [kinds_from_codes(kind.long(), torch.as_tensor(u < p1),
                                torch.as_tensor(u < p2), torch.as_tensor(c3),
                                torch.as_tensor(c15))
               for u, c3, c15 in draws[:n_traj]]
        return tuple(torch.stack([o[i] for o in out]) for i in range(2))
    return sample


@pytest.mark.parametrize(
    "mode, n", [(m, n) for n in (4, 10) for m in ("su4", "shot", "traj2")],
    ids=[f"{m}{'' if n == 4 else f'-{n}q'}" for n in (4, 10)
         for m in ("su4", "shot", "traj2")])
def test_composed_step_matches_jax_pallas_interpret(mode, n):
    """At 4 qubits (H psi through the dense planes) and at 10 (through the
    flip groups in one gather, ``flip_h_batched``)."""
    n_env, s_n, cap, iters = 3, 3, 10, 3
    rng = np.random.default_rng({"su4": 1, "shot": 2, "traj2": 3}[mode]
                                + (n > 4) * 10)
    old, new, maps, x0, n_rots = _batch(
        rng, n, n_env, cap, SU4_KINDS if mode == "su4" else CNOT_KINDS)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    ps_t, ps_j = _pauli(n)
    p1, p2 = 0.3, 0.5
    kw = dict(iters=iters, n_starts=s_n, restart_scale=0.0, noise_p1=p1,
              noise_p2=p2)
    kw.update({"su4": dict(enable_2q=True),
               "shot": dict(noise_mode="shot", n_shots=0),
               "traj2": dict(noise_mode="depolarizing", n_traj=2)}[mode])
    opt_j = OptJax(ps_j.device_arrays(jnp.complex64), dtype=jnp.complex64,
                   use_pallas=True, **kw)
    opt_j.pallas_interpret = True
    opt_t = AngleOptimizer(ps_t, device="cpu", **kw)
    if mode == "traj2":
        draws = _draws(2, old[0].shape)
        opt_j._sample_noise_kinds = _jax_kinds(draws, p1, p2)
        opt_t._sample_noise_kinds = _torch_kinds(draws, p1, p2)
    active = (np.arange(cap)[None, :] < n_rots[:, None]).astype(np.float32)
    x_j, e_j = opt_j._fused_pallas_jit(
        (jnp.asarray(psi0.real, jnp.float32),
         jnp.asarray(psi0.imag, jnp.float32)),
        tuple(map(jnp.asarray, old)), jnp.asarray(x0, jnp.float32),
        jnp.asarray(active), tuple(map(jnp.asarray, new)),
        jnp.asarray(maps), jax.random.PRNGKey(0))

    assert opt_t._pick_engine(old[0], new[0]) == "composed"
    act_t = torch.as_tensor(active)
    starts = make_multistarts(torch.as_tensor(x0, dtype=torch.float32),
                              act_t, s_n, s_n // 4, 0.0,
                              torch.Generator().manual_seed(0))
    p0 = torch.as_tensor(psi0[None])
    x_t, e_t = opt_t._fused_step_composed(
        tuple(map(torch.as_tensor, old)), tuple(map(torch.as_tensor, new)),
        torch.as_tensor(maps), p0.real, p0.imag,
        opt_t._h_apply(torch.float32), starts, act_t[:, None, :],
        iters=iters, lr=opt_t.lr, plain=True)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=TOL_F32)
    np.testing.assert_allclose(e_t.double().numpy() + opt_t.offset,
                               np.asarray(e_j), atol=TOL_F32)
    assert float(np.abs(x_t.numpy() - x0).max()) > 0.05   # Adam moved x


def test_batched_flip_h_matches_flip_h_and_jax():
    """The composed energy's H psi above 9 qubits (one gather over the flip
    groups, ``flip_h_batched``) against the fused kernels' plain group loop
    (``flip_h``) in float64, products and the autograd backward within
    1e-12, and its Rayleigh quotient (plus the identity weight) against
    the JAX package's ``pauli_expectation`` within 1e-10; for a complex and
    a real H."""
    n = 10
    rng = np.random.default_rng(7)
    d = 1 << n
    for seed, k in ((5, 30), (6, 20)):
        ps_t, ps_j = _pauli(n, seed=seed, k=k)
        if seed == 6:                     # real: an even count of Y
            strings = ["I" * n] + ["".join(rng.choice(list("IXZ"), size=n))
                                   for _ in range(k)]
            weights = np.concatenate([[0.3], rng.normal(size=k)])
            ps_t = PauliSum.from_strings(strings, weights, n)
            ps_j = PauliSumJax.from_strings(strings, weights, n)
        opt = AngleOptimizer(ps_t, device="cpu")
        wre, wim, flips = opt.w_planes()
        assert wre.dtype == torch.float64
        assert bool((wim != 0).any()) == (seed == 5)
        psi = rng.normal(size=(3, 2, d)) + 1j * rng.normal(size=(3, 2, d))
        re = torch.as_tensor(psi.real).requires_grad_()
        im = torch.as_tensor(psi.imag).requires_grad_()
        outs, grads = [], []
        for h in (flip_h_batched(wre, wim, flips), flip_h(wre, wim, flips)):
            hre, him, ev = _h_energy(re, im, h)
            g = torch.autograd.grad((ev.sum() + (hre * 0.3 - him).sum()),
                                    (re, im))
            outs.append((hre.detach(), him.detach(), ev.detach()))
            grads.append(g)
        for a, b in zip((*outs[0], *grads[0]), (*outs[1], *grads[1])):
            assert float((a - b).abs().max()) <= 1e-12
        ej = np.asarray(pexp_jax(jnp.asarray(psi),
                                 *ps_j.device_arrays(jnp.complex128)))
        np.testing.assert_allclose(outs[0][2].numpy() + opt.offset, ej,
                                   atol=1e-10, rtol=0)


def _one_tape(n):
    tape = GateTape(n, 6, 6)
    tape.add(GateKind.RY, 0, angle=0.7)
    tape.add_cx(0, 1)
    tape.add(GateKind.RX, 2, angle=-1.1)
    tape.add_cx(1, 2)
    tape.add(GateKind.RZ, 1, angle=0.4)
    return tape


def _energy_rows(opt, tape, n_env, n):
    """The composed engine's energies of one tape copied into n_env envs
    (one start each), and the noiseless energy."""
    arrs = tuple(torch.as_tensor(a, dtype=torch.int32).repeat(n_env, 1)
                 for a in tape.arrays())
    x = torch.as_tensor(tape.x0()).repeat(n_env, 1, 1)
    d = 1 << n
    psi0 = torch.zeros(1, 1, d, dtype=torch.float64)
    psi0[..., 0] = 1.0
    h = opt._h_apply(torch.float64)
    ev = opt._composed_energy(x, arrs, psi0, torch.zeros_like(psi0), h,
                              True, opt._noise_generator(1, 0))[:, 0]
    return ev.numpy() + opt.offset


def test_shot_noise_statistics():
    n, n_env, shots = 3, 4000, 64
    ps, _ = _pauli(n, seed=1)
    noisy = AngleOptimizer(ps, device="cpu", noise_mode="shot",
                           n_shots=shots, seed=4)
    exact = _energy_rows(AngleOptimizer(ps, device="cpu"), _one_tape(n), 1,
                         n)[0]
    es = _energy_rows(noisy, _one_tape(n), n_env, n) - exact
    sigma = np.linalg.norm(ps.weights) / np.sqrt(shots)
    assert abs(es.mean()) < 5 * sigma / np.sqrt(n_env)
    assert abs(es.std() - sigma) < 5 * sigma / np.sqrt(2 * n_env)


def test_trajectory_mean_matches_the_exact_channel():
    n, n_env, n_traj, p = 3, 1000, 4, (0.15, 0.25)
    ps, _ = _pauli(n, seed=2)
    tape = _one_tape(n)
    opt = AngleOptimizer(ps, device="cpu", noise_mode="depolarizing",
                         n_traj=n_traj, noise_p1=p[0], noise_p2=p[1], seed=5)
    es = _energy_rows(opt, tape, n_env, n)
    psi0 = np.zeros(1 << n, complex)
    psi0[0] = 1.0
    exact = depolarizing_energy_exact(psi0, *tape.arrays(), tape.x0(),
                                      ps.to_dense(), *p)
    sigma = es.std() / np.sqrt(n_env)
    assert es.std() > 0
    assert abs(es.mean() - exact) < 5 * sigma + 1e-3


def _su4_cfg_kw():
    """tests/test_su4_env.py:_su4_env's configuration, one start."""
    return dict(num_qubits=5, num_layers=20, ham_type="heisenberg",
                tn_placement="fixed", tn_init=0, tn_bond=0, accept_err=1e-3,
                curriculum_conf={"thresholds": [1e-3],
                                 "switch_episodes": [100000],
                                 "accept_err": 1e-3},
                optim_alg="adam", global_iters=8, n_starts=1, seed=3,
                gate_set="su4")


def test_su4_env_action_sequence_matches_jax():
    env_j = EnvJax(EnvConfigJax(sim_dtype="complex128", **_su4_cfg_kw()))
    env_t = CircuitEnv(EnvConfig(device="cpu", **_su4_cfg_kw()))
    n = 5
    assert env_t.action_size == env_j.action_size == 3 * n * n
    assert env_t.state_size == env_j.state_size
    assert env_t.rot_capacity == env_t.tape_capacity == env_j.rot_capacity
    np.testing.assert_array_equal(env_t.reset(), env_j.reset())
    assert abs(env_t.prev_energy - env_j.prev_energy) < TOL_ENV
    acts = env_t.action_dict
    # 2q rotations of each axis, 1q rotations, a repeated pair
    for a in (0, 4, 65, 11, 62, 5, 73, 1):
        obs_j, r_j, d_j = env_j.step(acts[a])
        obs_t, r_t, d_t = env_t.step(acts[a])
        np.testing.assert_array_equal(obs_t, obs_j)
        assert abs(r_t - r_j) < TOL_ENV and d_t == d_j
        assert abs(env_t.energy - env_j.energy) < TOL_ENV
        assert env_t.illegal_action_new() == env_j.illegal_action_new()
    assert env_t.energy < env_t.prev_energy + 1.0      # finite, moved


def test_su4_agent_state_size_and_actions_match_jax():
    env = CircuitEnv(EnvConfig(device="cpu", **_su4_cfg_kw()))
    conf = {"env": {"num_qubits": 5, "num_layers": 20, "gate_set": "su4"},
            "agent": {"batch_size": 8, "memory_size": 64, "neurons": [32],
                      "dropout": 0.0, "learning_rate": 1e-3, "angles": 0,
                      "en_state": 1, "priotitized_replay": 0,
                      "update_target_net": 5, "final_gamma": 0.05,
                      "epsilon_decay": 0.9, "epsilon_min": 0.05,
                      "agent_class": "DQN"}}
    a_t = make_agent(conf, env.action_size, env.state_size, device="cpu")
    a_j = make_agent_jax(conf, env.action_size, env.state_size, seed=0)
    assert a_t.state_size == a_j.state_size == env.reset().size + 1
    assert a_t.translate == a_j.translate == env.action_dict


@pytest.mark.parametrize("args", [
    ["--config", "heisenberg_5q_TNbond2", "--gate_set", "su4"],
    ["--config", "H2O8q_TNbond2_noise_restricted"]])
def test_cli_runs_the_composed_engine(args, tmp_path, monkeypatch):
    calls = []
    step = AngleOptimizer._fused_step_composed

    def counted(self, *a, **k):
        calls.append(self)
        return step(self, *a, **k)
    monkeypatch.setattr(AngleOptimizer, "_fused_step_composed", counted)
    summary = cli.run([*args, "--device", "cpu", "--vector", "2",
                       "--total_steps", "6", "--global_iters", "2",
                       "--n_starts", "2", "--batch_size", "4",
                       "--results_path", f"{tmp_path}/"])
    assert summary["steps"] == 6 and len(calls) == 3
    opt = calls[0]
    if "su4" in args:
        assert opt.enable_2q and opt.noise_mode == "none"
    else:
        assert opt.noise_mode == "shot" and not opt.enable_2q
    assert np.isfinite(summary["best_step_error"])


def test_fixed_su4_psi0_applies_the_two_qubit_rotations():
    """The port's fixed-placement psi0 under gate_set='su4' is the su4 warm
    start with RXX/RYY/RZZ applied; the JAX env compiles it without
    ``enable_2q`` and drops them (2.93 Ha higher)."""
    conf = get_config("TensorRL_fixed/", "H2O8q_TNbond2.cfg")
    conf["env"]["gate_set"] = "su4"
    env = CircuitEnv(EnvConfig.from_conf(conf, tn_placement="fixed",
                                         noise_mode="none", device="cpu"))
    pauli = env.problem.pauli
    e_port = float(pauli_expectation(env.psi0, *pauli.tensors("cpu")))
    tape = load_circuit_tape(resolve_warmstart_qasm(
        "H2O", 8, 2, H2O, gate_set="su4", tn_placement="fixed"))
    assert int(GateKind.RXX) in tape.kind.tolist()
    arrs = tuple(map(jnp.asarray, tape.arrays()))
    ps_j = PauliSumJax(pauli.n_qubits, pauli.weights, pauli.flip,
                       pauli.sign_mask, pauli.iphase)
    dense = ps_j.to_dense()
    energies = {}
    for flag in (True, False):          # the JAX package runs in x64 here
        psi = np.asarray(apply_tape_jax(
            zero_state_jax(8, jnp.complex128), *arrs,
            jnp.asarray(tape.x0()), enable_2q=flag))
        energies[flag] = float(np.real(psi.conj() @ dense @ psi))
        if flag:
            np.testing.assert_allclose(env.psi0.numpy(), psi, atol=1e-10)
    assert abs(e_port - energies[True]) < 1e-9
    assert abs(e_port - (-73.2915)) < 1e-3
    assert abs(energies[False] - (-70.3655)) < 1e-3


def test_composed_step_agreement_rejects_wrong_results():
    """The card check of the composed engine (``composed_step`` under
    ``agreement``, noise keyword ``seed``) accepts the plain version's own
    result and rejects a 1% Adam rate and a result under other draws."""
    from tensorrl_qas_tpu_torch.ops import fused_adam
    from tensorrl_qas_tpu_torch.optim.angle_opt import composed_step

    n, n_env, s_n, cap = 4, 6, 3, 10
    rng = np.random.default_rng(8)
    old, new, maps, x0, n_rots = _batch(rng, n, n_env, cap, CNOT_KINDS)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    ps_t, _ = _pauli(n)
    opt = AngleOptimizer(ps_t, device="cpu", noise_mode="shot", n_shots=64)
    active = (torch.arange(cap)[None, :]
              < torch.as_tensor(n_rots)[:, None]).float()
    starts = make_multistarts(torch.as_tensor(x0, dtype=torch.float32),
                              active, s_n, 0, 0.1,
                              torch.Generator().manual_seed(0))
    f32 = dict(dtype=torch.float32)
    args = (tuple(map(torch.as_tensor, old)), tuple(map(torch.as_tensor, new)),
            torch.as_tensor(maps), torch.as_tensor(psi0.real[None], **f32),
            torch.as_tensor(psi0.imag[None], **f32),
            *(p.float() for p in opt.h_planes()), starts,
            active[:, None, :].contiguous())
    step = composed_step(opt, plain=True)
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=step, seed=5)
    for lr, seed, passes in ((0.1, 5, True), (0.101, 5, False),
                             (0.1, 6, False)):
        x, e = step(*args, iters=3, lr=lr, seed=seed)
        ok, _, _ = fused_adam.agreement(args, ref, x, e, tol=TOL_F32,
                                        step=step, iters=3, seed=5)
        assert bool(ok.all()) == passes, (lr, seed)
