"""The port's multi-device dry run (``parallel/dryrun.py``, the twin of
``__graft_entry__.py:dryrun_multichip``) on an 8-shard CPU mesh.

- The whole run: its summary line, the env half's mean energy against
  the JAX package's energy of the same tape (1e-10, complex128).
- The DQN half in float64: the step with the batch split over dp equals
  the unsplit step (loss and updated weights, 1e-10), and its loss equals
  the JAX dry run's loss on the same weights, carried from the JAX
  package's Flax parameters by ``models/qnet.py:params_from_jax``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrl_qas_tpu  # noqa: F401  (x64 on)
from tensorrl_qas_tpu.models.qnet import QNetwork as QNetworkJax
from tensorrl_qas_tpu.sim import apply_tape as apply_tape_jax
from tensorrl_qas_tpu.sim import pauli_expectation as expectation_jax
from tensorrl_qas_tpu.sim import zero_state as zero_state_jax
from tensorrl_qas_tpu.sim.expectation import PauliSum as PauliSumJax
from tensorrl_qas_tpu_torch.models.qnet import params_from_jax
from tensorrl_qas_tpu_torch.parallel import dryrun
from tensorrl_qas_tpu_torch.parallel.mesh import make_mesh
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    heisenberg_hamiltonian,
)

TOL = 1e-10


def test_dryrun_on_eight_cpu_shards(capsys):
    out = dryrun.dryrun_multichip(8, ["cpu"] * 8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(8): mesh=(2 amp x 4 dp), E=")
    assert "dqn_loss=" in line and "fused_step E=" in line
    assert "env_traj E=" in line and line.endswith("OK")
    assert out["mesh"] == (2, 4)
    assert np.isfinite([out["dqn_loss"], out["fused_step_e"]]).all()
    # the env half: every row is the tape at its warm-start angles
    n = 4
    tape = dryrun.random_tape(n, 12, seed=3)
    ps = PauliSumJax.from_strings(*heisenberg_hamiltonian(n), n)
    psi = apply_tape_jax(zero_state_jax(n, jnp.complex128),
                         *map(jnp.asarray, tape.arrays()),
                         jnp.asarray(tape.x0()))
    e_j = float(expectation_jax(psi, *ps.device_arrays(jnp.complex128)))
    assert out["energy"] == pytest.approx(e_j, abs=TOL)


def _jax_loss(params, target_params, batch):
    """The JAX dry run's loss_fn (``__graft_entry__.py``)."""
    model = QNetworkJax(hidden=dryrun.HIDDEN, n_actions=dryrun.N_ACTIONS)
    states, actions, rewards, next_states, dones = batch
    q = model.apply(params, states)
    q_sa = jnp.take_along_axis(q, actions[:, None], axis=1)[:, 0]
    a_star = jnp.argmax(model.apply(params, next_states), axis=1)
    qt = model.apply(target_params, next_states)
    q_next = jnp.take_along_axis(qt, a_star[:, None], axis=1)[:, 0]
    target = rewards + dryrun.GAMMA * q_next * (1.0 - dones)
    return jnp.mean((q_sa - target) ** 2)


def test_dqn_split_step_equals_unsplit_and_jax():
    mesh = make_mesh(2, 4, ["cpu"] * 8)
    flax_params = QNetworkJax(hidden=dryrun.HIDDEN,
                              n_actions=dryrun.N_ACTIONS).init(
        jax.random.PRNGKey(0), jnp.zeros((1, dryrun.STATE_SIZE)))
    model = dryrun.make_qnet(torch.float64, "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       flax_params)))
    target = copy.deepcopy(model)
    with torch.no_grad():               # a target net apart from the model
        for p in target.parameters():
            p.mul_(0.9)
    batch = dryrun.dqn_batch(16, torch.Generator().manual_seed(1),
                             torch.float64, "cpu")

    unsplit = copy.deepcopy(model)
    start = copy.deepcopy(model)
    loss_1 = dryrun.dqn_step(unsplit, target, batch, torch.optim.Adam(
        unsplit.parameters(), lr=dryrun.DQN_LR))
    loss_s = dryrun.dqn_step_split(mesh, model, target, batch,
                                   torch.optim.Adam(model.parameters(),
                                                    lr=dryrun.DQN_LR))
    assert loss_s == pytest.approx(loss_1, abs=TOL)
    for p, q, p0 in zip(model.parameters(), unsplit.parameters(),
                        start.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=TOL)
        assert not torch.equal(p, p0)        # the Adam step moved them

    def flax_of(module):
        params = {}
        names = [f"hidden.{i}" for i in range(len(dryrun.HIDDEN))] + ["head"]
        for i, name in enumerate(names):
            params[f"Dense_{i}"] = {
                "kernel": jnp.asarray(module.state_dict()[
                    f"{name}.weight"].numpy().T),
                "bias": jnp.asarray(module.state_dict()[
                    f"{name}.bias"].numpy())}
        return {"params": params}

    batch_j = tuple(jnp.asarray(t.numpy()) for t in batch)
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            flax_params)
    loss_j = float(_jax_loss(params64, flax_of(target), batch_j))
    assert loss_1 == pytest.approx(loss_j, abs=TOL)
