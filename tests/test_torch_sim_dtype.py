"""The statevector precision (``EnvConfig.sim_dtype``, the CLI's
``--sim_dtype``) on the CPU.

- The port's ``CircuitEnv`` at complex64 and complex128 against the JAX
  package's at the same ``sim_dtype`` (its XLA path), on
  TensorRL_fixed/H2O8q_TNbond2 (the v1 engine) and H2O10q_TNbond2 (v2),
  cut to 2-step episodes with 10 Adam iterations and 3 starts: the
  warm-start psi0 and the reset energy, then two steps (an RZ, which
  enters at angle 0, then a CNOT, before which the step optimizes it) with
  the same injected starts in both packages (start 0 the incoming angles
  exactly, start 1 shifted, start 2 the fresh start at zero): energies
  within 1e-10 Ha in complex128 (double roundings in two summation
  orders), 1e-4 in complex64 (float32 roundings over 10 Adam iterations),
  the rewards within twice those over the reward's denominator |E_prev -
  E_min|; psi0 within 1e-10 / 1e-5; the reset energy within 1e-10 / 1e-4
  of the JAX package's and of the exact energy of its psi0 (in complex64
  a float32 sum at |E| ~ 74 Ha, whose ulp is 7.6e-6: either package's
  lands up to 2.3e-5 from the exact value).  The optimized angles are not
  compared: where the energy is flat in an angle (the 8q step) the best
  start is picked by rounding.
- The composed engine's plain run (the route every Adam mode takes in
  complex128 on the card) against the fused engines' plain runs (v1 at 8
  qubits, v2 at 10) in float64, through ``fused_step_batch`` with the same
  generator seed: e_new within 1e-9 and x_opt within 1.2e-8 (an angle on a
  flat direction moves by ~lr x 1e-16 / eps an Adam iteration between two
  summation orders, 12 iterations here), noiseless and with
  depolarizing noise under ``noise_resample='step'`` (one realization
  quenched into both tapes, drawn in the same order on both routes).
- The CLI's flag, an unknown string refused, two envs of different
  dtypes on one warm start each with their own psi0, the sharded
  optimizer at the env's dtype, and a vector env whose replicas and
  optimizer differ in dtype refused.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrl_qas_tpu.optim.angle_opt as angle_opt_jax
import tensorrl_qas_tpu_torch.optim.angle_opt as angle_opt
from tensorrl_qas_tpu.envs import CircuitEnv as EnvJax
from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu_torch import sim_dtypes
from tensorrl_qas_tpu_torch.envs import circuit_env
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.ops.fused_adam import EPS
from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
from tensorrl_qas_tpu_torch.train import cli
from tensorrl_qas_tpu_torch.train.config import get_config

TOL = {"complex128": (1e-10, 1e-10), "complex64": (1e-5, 1e-4)}
TOL_ROUTE = 1e-9
# x_opt: an angle whose exact gradient is ~0 moves by ~lr x 1e-16 / eps an
# Adam iteration between two summation orders (eps = 1e-8): 12 iterations
TOL_ROUTE_X = 12 * 0.1 * 1e-16 / EPS
KEEP = [1.0, 1.0, 0.0]          # start 0 exact, 1 shifted, 2 fresh at zero
SHIFT = [0.0, -0.13, 0.0]
# config, warm-start depth, the qubit of the RZ the second step optimizes
# (one where the optimum is not the RZ's entry angle 0)
CONFIGS = {"8q": ("H2O8q_TNbond2", 22, 7), "10q": ("H2O10q_TNbond2", 27, 5)}


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _starts(x0, active, keep, shift):
    """(..., R) angles -> (..., S, R) starts: start s is keep[s] x0 +
    shift[s] on every live angle (either package's arrays)."""
    return ((keep[:, None] * x0[..., None, :] + shift[:, None])
            * active[..., None, :])


def _conf(config, depth):
    conf = get_config("TensorRL_fixed/", f"{config}.cfg")
    conf["env"]["num_layers"] = depth + 2
    return conf


def _env_kw():
    return dict(global_iters=10, n_starts=3)


@pytest.mark.parametrize("sim_dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("size", list(CONFIGS))
def test_env_matches_jax_at_sim_dtype(size, sim_dtype, monkeypatch,
                                      one_thread):
    monkeypatch.setattr(
        angle_opt_jax, "make_multistarts",
        lambda x0, active, kn, n_starts, *a, **k: _starts(
            x0, active, jnp.asarray(KEEP, x0.dtype),
            jnp.asarray(SHIFT, x0.dtype)))
    monkeypatch.setattr(
        angle_opt, "make_multistarts",
        lambda x0, active, n_starts, *a, **k: _starts(
            x0, active, *(torch.tensor(v, dtype=x0.dtype)
                          for v in (KEEP, SHIFT))))
    config, depth, q = CONFIGS[size]
    conf = _conf(config, depth)
    cfg_t = dataclasses.replace(
        EnvConfig.from_conf(conf, tn_placement="fixed", noise_mode="none",
                            seed=3, device="cpu"),
        sim_dtype=sim_dtype, **_env_kw())
    cfg_j = dataclasses.replace(
        EnvConfigJax.from_conf(conf, tn_placement="fixed",
                               noise_mode="none", seed=3),
        sim_dtype=sim_dtype, use_pallas="off", **_env_kw())
    env_t, env_j = CircuitEnv(cfg_t), EnvJax(cfg_j)
    tol_psi, tol_e = TOL[sim_dtype]
    cdt = sim_dtypes(sim_dtype, "cpu")[0]
    assert env_t.dtype == env_t.psi0.dtype == env_t.optimizer.cdtype == cdt
    assert env_t.optimizer._pick_engine() == ("v1" if size == "8q" else "v2")
    psi_j = np.asarray(env_j._tn_psi)
    assert psi_j.dtype == np.dtype(sim_dtype)
    assert np.abs(env_t.psi0.numpy() - psi_j).max() < tol_psi
    np.testing.assert_array_equal(env_t.reset(), env_j.reset())
    exact = float(pauli_expectation(
        torch.as_tensor(psi_j).to(torch.complex128),
        *env_t.problem.pauli.tensors("cpu", torch.complex128)))
    assert abs(env_t.prev_energy - exact) < tol_e
    assert abs(env_t.prev_energy - env_j.prev_energy) < tol_e
    n = env_t.num_qubits
    rot = next(a for a, v in env_t.action_dict.items()
               if v[0] == n and v[2] == q and v[3] == 3)  # RZ on qubit q
    cnot = next(a for a, v in env_t.action_dict.items()
                if v[0] == q)                             # CX from q
    for a in (rot, cnot):
        denom = abs(env_j.prev_energy - env_j.min_eig)
        obs_j, r_j, d_j = env_j.step(env_j.action_dict[a])
        obs_t, r_t, d_t = env_t.step(env_t.action_dict[a])
        np.testing.assert_array_equal(obs_t, obs_j)
        assert abs(env_t.energy - env_j.energy) < tol_e
        assert abs(r_t - r_j) < 2 * tol_e / denom and d_t == d_j
    assert np.asarray(env_t.opt_ang_save).shape == (1,)


def _batch(rng, n, n_env, cap, n_gates):
    """Random CNOT-set tapes (rotations and CNOTs, a NONE pad) with their
    angles, as a vector env hands them to ``fused_step_batch``."""
    kind = np.zeros((n_env, cap), np.int32)
    tq = np.zeros((n_env, cap), np.int32)
    cq = np.full((n_env, cap), -1, np.int32)
    slot = np.full((n_env, cap), -1, np.int32)
    n_rot = np.zeros(n_env, np.int64)
    for e in range(n_env):
        r = 0
        for g in range(n_gates):
            if rng.random() < 0.4:
                t = int(rng.integers(n))
                kind[e, g], tq[e, g] = 4, t
                cq[e, g] = (t + 1 + int(rng.integers(n - 1))) % n
            else:
                kind[e, g] = int(rng.integers(1, 4))
                tq[e, g] = int(rng.integers(n))
                slot[e, g] = r
                r += 1
        n_rot[e] = r
    x0 = rng.normal(size=(n_env, cap)) * (np.arange(cap) < n_rot[:, None])
    return (kind, tq, cq, slot), x0, n_rot


@pytest.mark.parametrize("noise", ["none", "step"])
@pytest.mark.parametrize("size", list(CONFIGS))
def test_composed_route_matches_fused_plain_runs_in_float64(size, noise,
                                                            one_thread):
    config = CONFIGS[size][0]
    conf = get_config("TensorRL_fixed/", f"{config}.cfg")
    cfg = dataclasses.replace(
        EnvConfig.from_conf(conf, tn_placement="fixed",
                            noise_mode="none" if noise == "none"
                            else "depolarizing", device="cpu"),
        global_iters=12, n_starts=4, noise_resample="step",
        noise_values=(0.05, 0.1))
    env = CircuitEnv(cfg)
    n = env.num_qubits
    rng = np.random.default_rng(7 + n)
    arrs, x0, n_rot = _batch(rng, n, 3, 16, 12)
    ident = np.tile(np.arange(16, dtype=np.int32), (3, 1))
    out = {}
    for route in ("fused", "composed"):
        opt = circuit_env.make_optimizer(cfg, env.problem.pauli, "cpu", 11)
        assert opt.rdtype == torch.float64
        if route == "composed":
            opt._pick_engine = lambda *kinds: "composed"
        out[route] = opt.fused_step_batch(env.psi0, arrs, x0, n_rot, arrs,
                                          ident)
    (x_f, e_f, _), (x_c, e_c, _) = out["fused"], out["composed"]
    np.testing.assert_allclose(x_c, x_f, rtol=0, atol=TOL_ROUTE_X)
    np.testing.assert_allclose(e_c, e_f, rtol=0, atol=TOL_ROUTE)
    assert np.abs(x_f - x0).max() > 1e-2         # Adam moved the angles


def test_cli_flag_and_unknown_dtypes():
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--sim_dtype", "complex64"])
    _, env_cfg = cli.configure(args)
    assert env_cfg.sim_dtype == "complex64"
    _, env_cfg = cli.configure(cli.build_parser().parse_args([]))
    assert env_cfg.sim_dtype == "auto"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--sim_dtype", "complex256"])
    assert sim_dtypes("auto", "cpu") == (torch.complex128, torch.float64)
    assert sim_dtypes("auto", "cuda") == (torch.complex64, torch.float32)
    assert sim_dtypes("complex128", "cuda") == (torch.complex128,
                                                torch.float64)
    with pytest.raises(ValueError, match="sim_dtype must be one of"):
        sim_dtypes("float64", "cpu")
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    cfg = dataclasses.replace(EnvConfig.from_conf(conf, device="cpu"),
                              sim_dtype="complex32")
    with pytest.raises(ValueError, match="sim_dtype must be one of"):
        CircuitEnv(cfg)


def test_two_dtypes_on_one_warm_start_get_their_own_psi0(monkeypatch):
    monkeypatch.setattr(circuit_env, "_TN_PSI_CACHE", {})
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    base = EnvConfig.from_conf(conf, tn_placement="fixed", device="cpu")
    envs = {d: CircuitEnv(dataclasses.replace(base, sim_dtype=d))
            for d in ("complex64", "complex128", "auto")}
    assert envs["complex64"].psi0.dtype == torch.complex64
    assert envs["complex128"].psi0.dtype == torch.complex128
    assert envs["auto"].psi0 is envs["complex128"].psi0      # one memo
    assert len(circuit_env._TN_PSI_CACHE) == 2
    diff = (envs["complex64"].psi0.to(torch.complex128)
            - envs["complex128"].psi0).abs().max()
    assert 0 < float(diff) < 1e-6


def test_optimizers_and_vector_env_take_the_env_dtype(monkeypatch):
    """``sim_dtype`` reaches the sharded optimizer (a (1, 1) mesh on the
    CPU) as the JAX env passes its dtype; a vector env whose replicas and
    shared optimizer differ in dtype is refused."""
    from tensorrl_qas_tpu_torch.envs import vector_env

    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    base = EnvConfig.from_conf(conf, tn_placement="fixed", device="cpu")
    for d, cdt in (("complex64", torch.complex64),
                   ("complex128", torch.complex128)):
        cfg = dataclasses.replace(base, sim_dtype=d, mesh_shape=(1, 1),
                                  mesh_devices=("cpu",))
        opt = circuit_env.make_optimizer(cfg, CircuitEnv(
            dataclasses.replace(base, sim_dtype=d)).problem.pauli, "cpu", 0)
        assert opt.dtype == opt.sim.dtype == cdt
    cfg = dataclasses.replace(base, sim_dtype="complex128")
    real = vector_env.make_optimizer
    monkeypatch.setattr(vector_env, "make_optimizer", lambda c, *a: real(
        dataclasses.replace(c, sim_dtype="complex64"), *a))
    with pytest.raises(ValueError, match="share one dtype"):
        vector_env.VectorCircuitEnv(cfg, n_envs=2)
