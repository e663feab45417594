"""TensorRL-trainable and StructureRL in the PyTorch port (warm start
embedded in the RL state, ``tn_placement='in_state'``), block-coordinate
mode, and per-env psi0 in the plain versions of both fused kernels, held
to the JAX package on the CPU.

- ``embed_tape``: the same state tensor and layer offset as the JAX
  function, with and without ``zero_params``, on the 5q and 8q warm
  starts (exact).
- One action sequence gives the same observations, rewards, done flags
  and energies as the JAX env (XLA path), at 5 qubits (plain v1) and 10
  (plain v2), for both families and in block-coordinate mode, in
  complex128 with one optimizer start: within 1e-7 (the reason is in
  tests/test_torch_env.py's docstring).  The angles themselves agree to
  1e-6: the embedded RZ gates of layer 0 act on |0...0> and change only
  the global phase, so their exact gradient is 0 and the rounding-noise
  steps Adam takes there drift apart freely (observed 2.0e-7 after six
  steps of 8 iterations) without moving any energy.
- Block-coordinate identities (mirrors of tests/test_block_coord.py): the
  masked tape from the prefix state has the energy of the full tape from
  |0...0> (1e-10 in complex128); frozen steps keep the prefix angles bit
  for bit and joint steps move them; the mode descends like joint
  optimization; noise is refused; the vectorized env steps.
- Per-env psi0 (E, D) in the plain v1 and v2 steps: identical rows give
  the shared-plane result bit for bit, distinct rows the per-env single
  calls (1e-12 in float64), and the plain v2 step equals the JAX v2 kernel
  with ``per_env_psi0`` in interpret mode within 1e-5 in float32.
- The CLI trains both families on the CPU.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.circuits.qasm import load_circuit_tape as load_tape_jax
from tensorrl_qas_tpu.circuits.tensor_ir import StateTensor as StateJax
from tensorrl_qas_tpu.circuits.tensor_ir import embed_tape as embed_jax
from tensorrl_qas_tpu.envs import EnvConfig as EnvConfigJax
from tensorrl_qas_tpu.envs.vector_env import VectorCircuitEnv as VecJax
from tensorrl_qas_tpu.ops.pallas_opt2d import fused_adam_step_pallas2d
from tensorrl_qas_tpu.ops.pallas_opt2d import (
    pauli_flip_groups as flip_groups_jax,
)
from tensorrl_qas_tpu.problems.hamiltonians import (
    resolve_warmstart_qasm as resolve_jax,
)
from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
from tensorrl_qas_tpu_torch.circuits.tensor_ir import StateTensor, embed_tape
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.train import cli
from tensorrl_qas_tpu_torch.train.config import get_config
from tests.test_torch_fused_adam import _ints, _random_batch
from tests.test_torch_fused_adam2d import _psi, _random_paulis

TOL = 1e-7
TOL_ANGLES = 1e-6
H2O = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"
TRAINABLE, STRUCTURE = "TensorRL_trainable/", "StructureRL/"


@pytest.mark.parametrize("zero_params", [False, True])
@pytest.mark.parametrize("problem", [("heisenberg", 5, ""), ("H2O", 8, H2O)])
def test_embed_tape_matches_jax(problem, zero_params):
    ham, n, geometry = problem
    layers = 40
    state_j, state_t = StateJax(layers, n), StateTensor(layers, n)
    off_j = embed_jax(state_j, load_tape_jax(resolve_jax(ham, n, 2,
                                                         geometry)),
                      zero_params=zero_params)
    off_t = embed_tape(state_t, load_circuit_tape(
        resolve_warmstart_qasm(ham, n, 2, geometry)), zero_params=zero_params)
    assert off_t == off_j > 0
    np.testing.assert_array_equal(state_t.data, state_j.data)
    assert (state_t.rot_angles() == 0).all() == zero_params


def _conf(family, config, iters, **env_edits):
    conf = get_config(family, f"{config}.cfg")
    conf["env"].update(n_starts=1, **env_edits)
    conf["non_local_opt"]["global_iters"] = iters
    return conf


def _venvs(conf, n_envs=2):
    cfg_j = EnvConfigJax.from_conf(conf, tn_placement="in_state",
                                   noise_mode="none", seed=3)
    cfg_j.sim_dtype = "complex128"
    cfg_j.use_pallas = "off"
    venv_t = VectorCircuitEnv(EnvConfig.from_conf(
        conf, tn_placement="in_state", noise_mode="none", seed=3,
        device="cpu"), n_envs=n_envs)
    return VecJax(cfg_j, n_envs=n_envs), venv_t


def _run_parity(venv_j, venv_t, actions):
    np.testing.assert_array_equal(venv_t.reset_all(), venv_j.reset_all())
    for ej, et in zip(venv_j.envs, venv_t.envs):
        assert abs(ej.prev_energy - et.prev_energy) < TOL
    translate = venv_t.envs[0].action_dict
    dones = []
    for step in actions:
        acts = [translate[a] for a in step]
        assert venv_t.illegal_actions() == venv_j.illegal_actions()
        obs_j, rew_j, done_j, info_j = venv_j.step_all(acts)
        obs_t, rew_t, done_t, info_t = venv_t.step_all(acts)
        np.testing.assert_array_equal(obs_t, obs_j)
        np.testing.assert_allclose(rew_t, rew_j, atol=TOL)
        np.testing.assert_array_equal(done_t, done_j)
        for ij, it in zip(info_j, info_t):
            assert abs(ij["energy"] - it["energy"]) < TOL
            assert ij["steps"] == it["steps"]
        for ej, et in zip(venv_j.envs, venv_t.envs):
            assert et._bc_frozen == ej._bc_frozen
        dones.append(list(done_t))
    for ej, et in zip(venv_j.envs, venv_t.envs):
        np.testing.assert_allclose(et.state.data, ej.state.data,
                                   atol=TOL_ANGLES)
    return dones


# (env 0 action id, env 1 action id) per step at 5 qubits: ids 0-19 are
# CNOTs, 20-34 rotations
ACTIONS_5Q = [(30, 5), (3, 31), (33, 12), (12, 34), (31, 31), (0, 2)]


@pytest.mark.parametrize("block_coord", [0, 3])
@pytest.mark.parametrize("family", [TRAINABLE, STRUCTURE])
def test_in_state_action_sequence_matches_jax_at_5_qubits(family,
                                                          block_coord):
    conf = _conf(family, "heisenberg_5q_TNbond2", 8,
                 block_coord_k=block_coord)
    venv_j, venv_t = _venvs(conf)
    assert venv_t.envs[0].cfg.zero_param_init == (family == STRUCTURE)
    assert venv_t.optimizer._pick_engine() == "v1"
    _run_parity(venv_j, venv_t, ACTIONS_5Q)
    frozen = [e._bc_frozen for e in venv_t.envs]
    assert frozen == [bool(block_coord)] * 2      # step 5 of 6: 5 % 3 != 0


# at 10 qubits ids 0-89 are CNOTs, 90-119 rotations; the third step ends
# both 3-step episodes
ACTIONS_10Q = [(92, 5), (11, 100), (93, 93)]


@pytest.mark.parametrize("family", [TRAINABLE, STRUCTURE])
def test_in_state_action_sequence_matches_jax_at_10_qubits(family):
    """H2O 10q cut to 3-step episodes (num_layers = warm-start depth 27
    + 3): the plain v2 step on tapes of 192 embedded gates plus 4."""
    conf = _conf(family, "H2O10q_TNbond2", 4, num_layers=30)
    venv_j, venv_t = _venvs(conf)
    assert venv_t.optimizer._pick_engine() == "v2"
    env = venv_t.envs[0]
    assert (env.tape_capacity, env.rot_capacity) == (196, 169)
    dones = _run_parity(venv_j, venv_t, ACTIONS_10Q)
    assert dones[-1] == [1, 1]


@pytest.mark.parametrize("family, config, caps", [
    (TRAINABLE, "H2O8q_TNbond2", (172, 151)),
    (STRUCTURE, "H2O8q_TNbond2", (152, 131)),
    (TRAINABLE, "H2O10q_TNbond2", (223, 196)),
    (TRAINABLE, "LIH12q_TNbond2", (244, 211)),
    (STRUCTURE, "LIH12q_TNbond2", (244, 211)),
])
def test_in_state_capacities_follow_the_reference_rule(family, config,
                                                       caps):
    """G = embedded gates + max steps, R = embedded rotations + max steps
    (reference ``envs/circuit_env.py:257-266``)."""
    cfg = EnvConfig.from_conf(get_config(family, f"{config}.cfg"),
                              tn_placement="in_state", device="cpu")
    env = CircuitEnv(cfg)
    assert (env.tape_capacity, env.rot_capacity) == caps
    max_steps = env.num_layers_termination + 1
    assert caps == (env.tn_tape.n_gates + max_steps,
                    env.tn_tape.n_rots + max_steps)
    env.reset()
    assert env.layer_offset == env.tn_depth
    if cfg.zero_param_init:
        assert (env.state.rot_angles() == 0).all()


# -- block-coordinate mode (mirrors of tests/test_block_coord.py) -----------

def _bc_cfg(block_k=0, n_starts=2, iters=5):
    conf = get_config(TRAINABLE, "heisenberg_5q_TNbond2.cfg")
    conf["non_local_opt"]["global_iters"] = iters
    cfg = EnvConfig.from_conf(conf, tn_placement="in_state", seed=3,
                              device="cpu")
    return dataclasses.replace(cfg, n_starts=n_starts, block_coord_k=block_k)


def _acts(n):
    return [[n, 0, 1, 2], [0, 1, n, 0], [n, 0, 0, 3], [n, 0, 2, 1],
            [1, 1, n, 0], [n, 0, 3, 2], [n, 0, 1, 1], [2, 1, n, 0]]


def test_masked_prefix_energy_identity():
    env = CircuitEnv(_bc_cfg(block_k=3))
    env.reset()
    for a in _acts(env.num_qubits)[:4]:
        env.step(a)
    tape = env._tape(env.state)
    x = tape.x0()
    e_full = env.optimizer.energy(env.psi0, tape.arrays(), x)
    env._bc_frozen = True
    env._bc_cache = None
    masked = env._bc_mask_prefix(tape.arrays())
    assert (masked[0][: env._bc_n_gates] == 0).all()
    e_masked = env.optimizer.energy(env.step_psi0(), masked, x)
    assert abs(e_full - e_masked) < 1e-10, (e_full, e_masked)


def test_prefix_angles_frozen_then_updated():
    env = CircuitEnv(_bc_cfg(block_k=4))
    env.reset()
    n = env.num_qubits
    n_rots_e = env._bc_n_rots
    assert n_rots_e == env.tn_tape.n_rots > 0
    env.step(_acts(n)[0])                 # step 0: joint
    assert not env._bc_frozen
    after_joint = env._tape(env.state).x0()[:n_rots_e].copy()
    for a in _acts(n)[1:4]:               # steps 1-3: frozen
        env.step(a)
        assert env._bc_frozen and env._bc_cache is not None
        np.testing.assert_array_equal(
            env._tape(env.state).x0()[:n_rots_e], after_joint,
            err_msg="frozen step moved the embedded prefix angles")
    env.step(_acts(n)[4])                 # step 4: joint again
    assert not env._bc_frozen
    assert env._bc_cache is None, "a joint step must drop the cache"


def test_block_coord_descends_like_joint():
    """The same action script with and without block_coord: both track
    the same energy scale (an optimization schedule, not another
    objective)."""
    errs = {}
    for k in (0, 3):
        env = CircuitEnv(_bc_cfg(block_k=k, iters=15, n_starts=2))
        env.reset()
        for a in _acts(env.num_qubits):
            env.step(a)
        errs[k] = env.error
    assert errs[3] < max(3.0 * errs[0], errs[0] + 0.5), errs


def test_block_coord_rejects_noise():
    with pytest.raises(ValueError, match="block_coord_k"):
        CircuitEnv(dataclasses.replace(_bc_cfg(block_k=4),
                                       noise_mode="depolarizing"))


def test_vectorized_block_coord_smoke():
    """Per-env psi0 through the batched plain v1 step: frozen and joint
    replicas in one call once their step counters differ."""
    venv = VectorCircuitEnv(_bc_cfg(block_k=2), n_envs=2)
    venv.reset_all()
    n = venv.envs[0].num_qubits
    seen = set()
    for i, a in enumerate(_acts(n)[:5]):
        _, _, _, infos = venv.step_all([a, a])
        assert np.all(np.isfinite([info["error"] for info in infos]))
        if i == 1:      # replica 1 restarts its episode: counters differ
            venv.envs[1].reset()
        seen.add(tuple(e._bc_frozen for e in venv.envs))
    assert {(True, False), (False, True)} & seen
    for e in venv.envs:
        assert e._bc_n_rots > 0


# -- per-env psi0 in the plain versions --------------------------------------

def _v1_args(n_env=3, n_starts=2, n=5, cap=12, seed=0):
    rng = np.random.default_rng(seed)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    opt = AngleOptimizer(_random_paulis(n, 12, seed=2)[1], device="cpu")
    active = torch.as_tensor(np.arange(cap)[None, None, :]
                             < n_rots[:, None, None], dtype=torch.float64)
    starts = (torch.as_tensor(x0)[:, None, :]
              + 0.3 * torch.as_tensor(rng.normal(size=(n_env, n_starts,
                                                       cap)))) * active
    psi = torch.as_tensor(np.stack([_psi(rng, n) for _ in range(n_env)]))
    return ((_ints(old), _ints(new), torch.as_tensor(maps)), psi,
            opt.w_planes(), (starts, active))


def _with_psi0(head, psi, h_ops, tail):
    return (*head, psi.real.contiguous(), psi.imag.contiguous(), *h_ops,
            *tail)


def _rows(args, e):
    """The arguments of env e alone (its psi0 row as a (1, D) plane)."""
    def one(a):
        if isinstance(a, tuple):
            return tuple(t[e:e + 1] for t in a)
        return a[e:e + 1]
    return (one(args[0]), one(args[1]), one(args[2]), args[3][e:e + 1],
            args[4][e:e + 1], *args[5:-2], one(args[-2]), one(args[-1]))


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_plain_step_takes_per_env_psi0(engine):
    head, psi, h_ops, tail = _v1_args(n=7 if engine == "v2" else 5)
    step = fused_adam.fused_adam_step
    if engine == "v2":
        h_ops = AngleOptimizer(_random_paulis(7, 12, seed=2)[1],
                               device="cpu").w_planes()
        step = fused_adam2d.fused_adam_step2d
    kw = dict(iters=4, lr=0.1)
    n_env = psi.shape[0]
    shared = step(*_with_psi0(head, psi[:1], h_ops, tail), **kw)
    same = step(*_with_psi0(head, psi[:1].expand(n_env, -1), h_ops, tail),
                **kw)
    for a, b in zip(same, shared):
        assert torch.equal(a, b)
    args = _with_psi0(head, psi, h_ops, tail)
    x_p, e_p = step(*args, **kw)
    assert not torch.equal(e_p, shared[1])
    for e in range(n_env):
        x_e, e_e = step(*_rows(args, e), **kw)
        np.testing.assert_allclose(x_p[e].numpy(), x_e[0].numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(float(e_p[e]), float(e_e[0]), atol=1e-12)


def test_plain_v2_per_env_psi0_matches_pallas_interpret():
    """The JAX v2 kernel with ``per_env_psi0`` takes psi0 as (E, D / 128,
    128) blocks; the port takes (E, D) planes."""
    n, n_env, s_n, cap, iters = 7, 2, 3, 10, 3
    rng = np.random.default_rng(4)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    ps_j, ps_t = _random_paulis(n, 24, seed=1)
    psi = np.stack([_psi(rng, n) for _ in range(n_env)])
    active = (np.arange(cap)[None, None, :]
              < n_rots[:, None, None]).astype(np.float32)
    starts = (x0[:, None, :] + 0.3 * rng.normal(size=(n_env, s_n, cap))
              ).astype(np.float32) * active
    wre_j, wim_j, flips_j = flip_groups_jax(ps_j)
    f32 = jnp.float32
    xj, ej = fused_adam_step_pallas2d(
        tuple(map(jnp.asarray, old)), tuple(map(jnp.asarray, new)),
        jnp.asarray(maps), jnp.asarray(psi.real.reshape(n_env, 1, 128), f32),
        jnp.asarray(psi.imag.reshape(n_env, 1, 128), f32),
        jnp.asarray(wre_j), jnp.asarray(wim_j), flips_j,
        jnp.asarray(starts), jnp.asarray(active), iters=iters, lr=0.1,
        interpret=True)

    opt = AngleOptimizer(ps_t, device="cpu")
    wre, wim, flips = (t.float() if t.is_floating_point() else t
                       for t in opt.w_planes())

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    xt, et = fused_adam2d.fused_adam_step2d(
        _ints(old), _ints(new), torch.as_tensor(maps), t32(psi.real),
        t32(psi.imag), wre, wim, flips, t32(starts), t32(active),
        iters=iters, lr=0.1)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(et.numpy() + opt.offset, np.asarray(ej),
                               atol=1e-5)


def test_kernel_input_checks_take_per_env_psi0():
    """The checks both CUDA kernels share accept (1, D) and (E, D) psi0
    planes and nothing else; the kernels' psi0 stride is 0 or D."""
    head, psi, h_ops, tail = _v1_args(n_env=3)
    ints = (*head[0], *head[1])
    d = psi.shape[-1]

    def check(p):
        planes = (p.real.float().contiguous(), p.imag.float().contiguous())
        floats = (*planes, *(t.float() for t in h_ops[:2]),
                  *(t.float().contiguous() for t in tail))
        return fused_adam.check_step_inputs("fused_adam_step", ints,
                                            head[2], floats, floats[4],
                                            floats[5])

    assert check(psi)[:2] == check(psi[:1])[:2] == (3, 2)
    with pytest.raises(ValueError, match=r"\(E, D\)"):
        check(psi[:2])
    with pytest.raises(ValueError, match=r"\(E, D\)"):
        check(psi[0])
    assert fused_adam.psi0_stride(psi.real[:1]) == 0
    assert fused_adam.psi0_stride(psi.real) == d


def test_optimizer_steps_with_per_env_psi0():
    """``fused_step_batch`` takes a (B, D) psi0 and keeps its engine: the
    result per env is that of a batch of one from the same row, starts
    drawn alike (one start: the exact warm start)."""
    head, psi, _, _ = _v1_args(n_env=3)
    rng = np.random.default_rng(0)
    old, new, maps, x0, n_rots = _random_batch(rng, 5, 3, 12)

    def opt():
        return AngleOptimizer(_random_paulis(5, 12, seed=2)[1], iters=3,
                              n_starts=1, device="cpu")
    x_b, e_b, _ = opt().fused_step_batch(psi, old, x0, n_rots, new, maps)
    for e in range(3):
        x_e, e_e, _ = opt().fused_step_batch(
            psi[e], tuple(a[e:e + 1] for a in old), x0[e:e + 1],
            n_rots[e:e + 1], tuple(a[e:e + 1] for a in new), maps[e:e + 1])
        np.testing.assert_allclose(x_b[e], x_e[0], atol=1e-12)
        np.testing.assert_allclose(e_b[e], e_e[0], atol=1e-12)


# -- CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("family, extra", [(TRAINABLE, ["--block_coord", "3"]),
                                           (STRUCTURE, [])])
def test_cli_trains_in_state_families_on_the_cpu(tmp_path, family, extra):
    summary = cli.run([
        "--device", "cpu", "--config", "heisenberg_5q_TNbond2",
        "--experiment_name", family, "--vector", "2", "--total_steps", "8",
        "--global_iters", "2", "--n_starts", "2", "--batch_size", "4",
        "--results_path", f"{tmp_path}/", *extra])
    assert summary["steps"] == 8
    assert np.isfinite(summary["best_step_error"])
    run_dir = tmp_path / family / "heisenberg_5q_TNbond2"
    stats = np.load(run_dir / "summary_0.npy", allow_pickle=True).item()
    assert set(stats) == {"train", "test"}
    events = [json.loads(line) for line in
              (run_dir / "events_0.jsonl").read_text().splitlines()]
    assert [ev["steps"] for ev in events] == [2, 4, 6, 8]


def test_cli_tn_placement_flag_overrides_the_family(tmp_path, monkeypatch):
    seen = {}

    class Spy(VectorCircuitEnv):
        def __init__(self, cfg, n_envs):
            seen["cfg"] = cfg
            super().__init__(cfg, n_envs)

    monkeypatch.setattr(cli, "VectorCircuitEnv", Spy)
    cli.run(["--device", "cpu", "--config", "heisenberg_5q_TNbond2",
             "--experiment_name", "TensorRL_fixed/", "--tn_placement",
             "in_state", "--block_coord", "2", "--vector", "2",
             "--total_steps", "4", "--global_iters", "2", "--n_starts", "2",
             "--batch_size", "4", "--results_path", f"{tmp_path}/"])
    cfg = seen["cfg"]
    assert (cfg.tn_placement, cfg.block_coord_k) == ("in_state", 2)
    assert cli.infer_modes(TRAINABLE, "H2O8q_TNbond2")[0] == "in_state"
    assert cli.infer_modes(STRUCTURE, "H2O8q_TNbond2")[0] == "in_state"


@pytest.mark.parametrize("noise_mode", ["none", "depolarizing"])
def test_reset_all_takes_the_shared_start_energy_once(noise_mode):
    """The replicas of a vector env start from one embedded warm start:
    noiseless, ``reset_all`` takes its energy once and hands every
    replica the value a replica's own evaluation gives; under noise,
    where each evaluation draws, every replica draws its own."""
    conf = _conf(TRAINABLE, "heisenberg_5q_TNbond2", 8)
    venv = VectorCircuitEnv(EnvConfig.from_conf(
        conf, tn_placement="in_state", noise_mode=noise_mode, seed=3,
        device="cpu"), n_envs=3)
    calls = []
    energy = venv.optimizer.energy
    venv.optimizer.energy = lambda *a: calls.append(1) or energy(*a)
    venv.reset_all()
    assert len(calls) == (1 if noise_mode == "none" else 3)
    if noise_mode == "none":
        for env in venv.envs:
            assert env.prev_energy == env._energy_of_state(env.state)
