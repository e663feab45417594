"""A dry run of the training step on an (amp, dp) mesh of devices.

Counterpart of ``__graft_entry__.py:dryrun_multichip`` and its
``_dryrun_env_trajectory``, at the same tiny shapes:

1. the env half: one gradient step of the mean energy of a batch of
   angle vectors, the 4-qubit statevectors sharded over (dp, amp)
   (``ShardedSimulator.value_and_grad_batched``);
2. the agent half: the double-DQN replay step with its batch split over
   dp: the Q-network replicated to each dp column's device, each shard's
   rows there, the gradients summed on the lead device in mesh order
   (``Mesh.psum``) and one Adam step, which equals the unsplit step;
3. the sharded fused step (``ShardedAngleOptimizer.fused_step``) and a
   short trajectory of a mesh-sharded 5-qubit Heisenberg
   ``VectorCircuitEnv`` with the port's agent: act, sharded step,
   reward, remember, replay.

    python -m tensorrl_qas_tpu_torch.parallel.dryrun 8 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import numpy as np
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.models.qnet import QNetwork
from tensorrl_qas_tpu_torch.optim.sharded_opt import ShardedAngleOptimizer
from tensorrl_qas_tpu_torch.parallel.mesh import make_mesh
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    heisenberg_hamiltonian,
)
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum

GAMMA = 0.95           # the JAX dry run's TD discount
DQN_LR = 1e-3
STATE_SIZE, N_ACTIONS, HIDDEN = 64, 24, (32, 32)
TRAJECTORY_STEPS = 6   # n_step = 5 holds transitions back five steps


def random_tape(n_qubits: int, n_gates: int, seed: int = 0) -> GateTape:
    """The JAX dry run's tape: random RX / RY / RZ / CX gates."""
    rng = np.random.default_rng(seed)
    tape = GateTape(n_qubits, n_gates, n_gates)
    for _ in range(n_gates):
        kind = rng.choice([GateKind.RX, GateKind.RY, GateKind.RZ,
                           GateKind.CX])
        if kind == GateKind.CX:
            c, t = rng.choice(n_qubits, size=2, replace=False)
            tape.add_cx(int(c), int(t))
        else:
            tape.add(kind, target=int(rng.integers(n_qubits)),
                     angle=float(rng.uniform(-np.pi, np.pi)))
    return tape


def dqn_loss(model, target, batch, scale=None):
    """The dry run's double-DQN loss: squared TD errors over ``batch``
    (states, actions, rewards, next states, dones), summed and divided by
    ``scale`` (default: the rows' count, a mean)."""
    s, a, r, s2, d = batch
    q_sa = model(s).gather(1, a[:, None])[:, 0]
    with torch.no_grad():
        a_star = torch.argmax(model(s2), dim=1)
        q_next = target(s2).gather(1, a_star[:, None])[:, 0]
        td_target = r + GAMMA * q_next * (1.0 - d)
    return torch.sum((q_sa - td_target) ** 2) / (scale or len(q_sa))


def dqn_step(model, target, batch, optimizer):
    """One unsplit replay step: the loss over the whole batch, backward,
    one Adam step.  -> the loss."""
    loss = dqn_loss(model, target, batch)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return float(loss.detach())


def dqn_step_split(mesh, model, target, batch, optimizer):
    """The same step with the batch split over the mesh's dp axis: a
    replica of both networks on each dp column's device computes its
    rows' share of the loss (squared errors over the whole batch's size)
    and its gradients; ``Mesh.psum`` adds them on the lead device in
    mesh order, and the lead model takes one Adam step.  -> the loss."""
    n_dp = mesh.shape["dp"]
    rows = batch[0].shape[0]
    if rows % n_dp:
        raise ValueError(f"{rows} rows do not split over {n_dp} dp shards")
    b = rows // n_dp
    losses, grads = [], []
    for d in range(n_dp):
        dev = mesh.devices[0][d]
        replica = copy.deepcopy(model).to(dev)
        target_d = copy.deepcopy(target).to(dev)
        part = tuple(t[d * b:(d + 1) * b].to(dev) for t in batch)
        loss = dqn_loss(replica, target_d, part, scale=rows)
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, list(replica.parameters())))
    total = mesh.psum([losses], "dp")[0][0]
    summed = [mesh.psum([[g[i] for g in grads]], "dp")[0][0]
              for i in range(len(grads[0]))]
    optimizer.zero_grad(set_to_none=True)
    for p, g in zip(model.parameters(), summed):
        p.grad = g.to(p.device)
    optimizer.step()
    return float(total)


def dqn_batch(batch: int, generator: torch.Generator, dtype, device):
    """Random replay rows: (states, actions, rewards, next states,
    dones)."""
    kw = dict(generator=generator, dtype=dtype)
    return tuple(t.to(device) for t in (
        torch.randn((batch, STATE_SIZE), **kw),
        torch.randint(0, N_ACTIONS, (batch,), generator=generator),
        torch.randn((batch,), **kw),
        torch.randn((batch, STATE_SIZE), **kw),
        torch.zeros((batch,), dtype=dtype)))


def make_qnet(dtype, device, seed: int = 0) -> QNetwork:
    model = QNetwork(STATE_SIZE, HIDDEN, N_ACTIONS)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


def env_trajectory(n_amp: int, n_dp: int, devices=None) -> str:
    """Production training steps on a mesh-sharded 5q Heisenberg vector
    env: act, sharded fused step, reward, remember, replay."""
    from tensorrl_qas_tpu_torch.agents.dqn import make_agent
    from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
    from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
    from tensorrl_qas_tpu_torch.train.config import get_config
    from tensorrl_qas_tpu_torch.train.vector_driver import modify_states

    mesh = make_mesh(n_amp, n_dp, devices)
    conf = get_config("TensorRL_fixed/", "heisenberg_5q_TNbond2.cfg")
    # tiny shapes on the production path
    conf["agent"]["batch_size"] = 2
    conf["agent"]["neurons"] = [64, 64]
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", seed=0,
                              device=str(mesh.lead))
    cfg = dataclasses.replace(
        cfg, mesh_shape=(n_amp, n_dp), global_iters=2, n_starts=2,
        mesh_devices=tuple(str(d) for row in mesh.devices for d in row))
    venv = VectorCircuitEnv(cfg, n_envs=2)
    agent = make_agent(conf, venv.action_size, venv.state_size, seed=0,
                       device=mesh.lead)
    states = modify_states(venv.reset_all(), venv, conf)
    energies, losses = [], []
    for _ in range(TRAJECTORY_STEPS):
        actions, _ = agent.act_batch(states, venv.illegal_actions())
        acts4 = [agent.translate[int(a)] for a in actions]
        next_states, rewards, dones, _ = venv.step_all(acts4)
        next_states = modify_states(next_states, venv, conf)
        for i in range(venv.n_envs):
            agent.remember(states[i], int(actions[i]), float(rewards[i]),
                           next_states[i], float(dones[i]), env_id=i + 1)
        states = next_states
        energies.append(float(venv.envs[0].energy))
        if len(agent.memory) > conf["agent"]["batch_size"]:
            losses.append(float(agent.replay(conf["agent"]["batch_size"])))
    if not all(np.isfinite(e) for e in energies):
        raise RuntimeError(f"env trajectory energies not finite: {energies}")
    if not losses or not all(np.isfinite(lo) for lo in losses):
        raise RuntimeError(f"env trajectory replay losses: {losses}")
    return (f"env_traj E={energies[0]:.4f}->{energies[-1]:.4f} "
            f"replay_loss={losses[-1]:.4f}")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run both halves of the training step, the sharded fused step and
    the env trajectory on an (amp, dp) mesh of ``n_devices`` (of the
    host's CUDA devices, or of ``devices``, which may repeat one); prints
    the JAX dry run's summary line and returns its numbers."""
    n_amp = 2 if n_devices % 2 == 0 else 1
    n_dp = n_devices // n_amp
    mesh = make_mesh(n_amp=n_amp, n_dp=n_dp, devices=devices)

    # -- half 1: a gradient step of the mean batched energy ----------------
    n_qubits = 4
    batch = 2 * n_dp
    pauli = PauliSum.from_strings(*heisenberg_hamiltonian(n_qubits),
                                  n_qubits)
    sim_opt = ShardedAngleOptimizer(mesh, n_qubits, pauli, iters=3,
                                    n_starts=n_dp)
    sim = sim_opt.sim
    tape = random_tape(n_qubits, 12, seed=3)
    arrs = tape.arrays()
    angles = torch.as_tensor(np.tile(tape.x0(), (batch, 1)),
                             dtype=sim.rdtype, device=mesh.lead)
    ev, grad = sim.value_and_grad_batched(sim.zero_state_batched(batch),
                                          *arrs, angles)
    e = ev.mean()
    new_angles = angles - 0.1 * grad / batch
    if not bool(torch.isfinite(new_angles).all()):
        raise RuntimeError("sharded angle step not finite")

    # -- half 2: the dp-split double-DQN replay step -----------------------
    gen = torch.Generator().manual_seed(0)
    rdt = torch.float32
    model = make_qnet(rdt, mesh.lead)
    target = copy.deepcopy(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=DQN_LR)
    loss = dqn_step_split(mesh, model, target,
                          dqn_batch(batch, gen, rdt, mesh.lead), optimizer)

    # -- the sharded fused step (what CircuitEnv runs with mesh_shape) -----
    x0 = tape.x0()
    map_idx = np.arange(len(x0), dtype=np.int32)
    _, e_new, nfev = sim_opt.fused_step(None, arrs, x0, tape.n_rots, arrs,
                                        map_idx)
    if not (np.isfinite(e_new) and nfev > 0):
        raise RuntimeError(f"sharded fused step: e_new {e_new}, nfev {nfev}")

    traj = env_trajectory(n_amp, n_dp, devices)
    print(f"dryrun_multichip({n_devices}): mesh=({n_amp} amp x {n_dp} dp), "
          f"E={float(e):.4f}, dqn_loss={loss:.4f}, "
          f"fused_step E={e_new:.4f}, {traj} OK", flush=True)
    return {"mesh": (n_amp, n_dp), "energy": float(e), "dqn_loss": loss,
            "fused_step_e": e_new, "trajectory": traj}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="put every shard on this device (e.g. cpu, "
                         "cuda:0); default: the host's CUDA devices")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [args.device] * args.n_devices
    dryrun_multichip(args.n_devices, devices)


if __name__ == "__main__":
    main()
