"""Amplitude-sharded per-step angle optimization over an (amp, dp) mesh.

Counterpart of ``tensorrl_qas_tpu/optim/sharded_opt.py``.
``ShardedAngleOptimizer`` takes the hot-path calls of ``AngleOptimizer``
(``fused_step``, ``fused_step_batch``, ``energy``, with the same
signatures) and runs them on ``parallel/sharded_sim.py``: the statevector
sharded over the mesh's ``amp`` axis, the multi-start batch over ``dp``.
The statevector's size is then bounded by the memory of the mesh's
devices (2^n x 8 B / n_amp a device and batch row in complex64), not by
one device, and not by the fused kernels' 20 qubits.

The step is the JAX package's ``_fused_step``: multi-start Adam on the
old tape (one adjoint value-and-gradient sweep an iteration, the best
iterate tracked), a final re-check, the argmin over the starts, the remap
onto the new tape and its energy e_new; the Adam loop is
``optim/angle_opt.py:multistart_adam``, the composed engine's too.  Its
starts come from the port's ``make_multistarts`` and the optimizer's
torch generator; ``n_starts`` rounds up to a multiple of the dp axis.
The sweep runs as eager PyTorch operations on the shards (one dispatch a
gate and shard, no kernel of its own).

Depolarizing noise (``noise_mode='depolarizing'``, one trajectory an
evaluation) is the JAX package's 3G-long tape extension: error Paulis
drawn by ``sim/noise.py:sample_depolarizing_kinds`` woven in by
``optim/angle_opt.py:extend_tape_arrays``; ``noise_resample='iter'``
draws afresh at every evaluation, ``'step'`` quenches one draw a step.
The draws come from a CPU generator: the sharded simulator dispatches
each gate on the host, so the woven tape is read there.  Shot noise and
``n_traj > 1`` are refused, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrl_qas_tpu_torch.optim.angle_opt import (
    NOISE_RESAMPLE,
    extend_tape_arrays,
    make_multistarts,
    multistart_adam,
)
from tensorrl_qas_tpu_torch.parallel.sharded_sim import (
    ShardedSimulator,
    shard_state,
)
from tensorrl_qas_tpu_torch.sim.noise import sample_depolarizing_kinds


class ShardedAngleOptimizer:
    """Fixed-iteration multi-start Adam over an (amp, dp) device mesh.

    Args:
      mesh: ``parallel.mesh.Mesh``.
      n_qubits: problem size; 2^n splits over the amp axis.
      pauli: the problem's ``PauliSum``.
      iters / n_starts / lr / restart_scale / seed: as ``AngleOptimizer``.
      dtype: the complex statevector dtype, passed to ``ShardedSimulator``
        (None: its default, the port's policy for the mesh's lead
        device), as the JAX env passes its own.
      noise_mode / noise_p1 / noise_p2 / noise_resample: 'none' or
        'depolarizing' one-trajectory tape-extension noise.
      enable_2q: tapes may hold RXX / RYY / RZZ (the su4 gate set).
    """

    def __init__(self, mesh, n_qubits: int, pauli, iters: int = 100,
                 n_starts: int = 8, lr: float = 0.1,
                 restart_scale: float = 0.1, seed: int = 0,
                 noise_mode: str = "none", noise_p1: float = 0.01,
                 noise_p2: float = 0.05, noise_resample: str = "iter",
                 enable_2q: bool = False, dtype=None):
        if noise_mode not in ("none", "depolarizing"):
            raise NotImplementedError(
                f"sharded path supports noise_mode none/depolarizing, "
                f"got {noise_mode!r} (shot noise is single-chip only)")
        if noise_resample not in NOISE_RESAMPLE:
            raise ValueError(f"noise_resample must be one of "
                             f"{NOISE_RESAMPLE}, got {noise_resample!r}")
        self.mesh = mesh
        self.n = n_qubits
        self.pauli = pauli
        self.sim = ShardedSimulator(mesh, n_qubits, pauli, dtype=dtype,
                                    enable_2q=enable_2q)
        self.dtype, self.rdtype = self.sim.dtype, self.sim.rdtype
        self.device = mesh.lead
        self.iters = iters
        self.lr = lr
        self.restart_scale = restart_scale
        self.noise_mode = noise_mode
        self.noise_p1 = float(noise_p1)
        self.noise_p2 = float(noise_p2)
        self.noise_resample = noise_resample
        # the starts ride dp: round up to a multiple of its size
        n_dp = mesh.shape["dp"]
        self.n_starts = max(n_starts, n_dp)
        if self.n_starts % n_dp:
            self.n_starts += n_dp - self.n_starts % n_dp
        if self.n_starts != n_starts:
            print(f"ShardedAngleOptimizer: n_starts {n_starts} -> "
                  f"{self.n_starts} (rounded up to dp axis {n_dp})",
                  flush=True)
        self.fresh_starts = self.n_starts // 4
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.noise_generator = torch.Generator().manual_seed(seed)
        # the placed psi0 batch and the tensor it was placed from, with
        # that tensor's version: reused while the caller hands in the same,
        # unchanged tensor (no read of its values, no host sync)
        self._psi0_cache = (None, None, None)

    # -- states and tapes --------------------------------------------------

    def _psi0_batched(self, psi0):
        """The (n_starts, 2^n) sharded batch of psi0 ((D,) complex tensor,
        or None for |0...0>), placed once a warm start: re-placing a 2^n
        batch every step would dominate."""
        if psi0 is not None and psi0.dim() != 1:
            raise ValueError(
                "the sharded optimizer takes one psi0 (D,) shared by the "
                f"envs, got shape {tuple(psi0.shape)}")
        version = None if psi0 is None else psi0._version
        src, src_version, out = self._psi0_cache
        if out is not None and src is psi0 and src_version == version:
            return out
        if psi0 is None:
            out = self.sim.zero_state_batched(self.n_starts)
        else:
            out = shard_state(psi0.to(self.dtype).expand(self.n_starts, -1),
                              self.mesh)
        self._psi0_cache = (psi0, version, out)
        return out

    @staticmethod
    def _first_row(grid):
        """Row 0 of a sharded batch as a one-row batch (dp column 0)."""
        return [[line[0][:1]] for line in grid]

    def _sample_noise_kinds(self, kind):
        """One depolarizing realization (k_t, k_c) of the tape ``kind``
        (tests inject their own here)."""
        return sample_depolarizing_kinds(kind, self.noise_generator,
                                         self.noise_p1, self.noise_p2)

    def _extend(self, arrs):
        """One drawn trajectory woven into a 3G-long tape."""
        arrs = tuple(torch.as_tensor(a).cpu() for a in arrs)
        return extend_tape_arrays(arrs, *self._sample_noise_kinds(arrs[0]))

    def _energies(self, psi_b, arrs, x):
        """Per-row energy of the tape at x (rows, R) from the batch."""
        return self.sim.expectation_batched(
            self.sim.apply_tape_batched(psi_b, *arrs, x))

    # -- the fused step ----------------------------------------------------

    def _fused_step(self, psi0_b, old, x0, active, new, map_idx):
        noisy = self.noise_mode == "depolarizing"
        resample = noisy and self.noise_resample == "iter"
        if noisy and not resample:
            # one realization quenched into both tapes for the step
            old, new = self._extend(old), self._extend(new)

        def arrs_at():
            return self._extend(old) if resample else old

        def value_and_grad(x, it):
            ev, g = self.sim.value_and_grad_batched(psi0_b, *arrs_at(), x[0])
            return ev[None], g[None]

        def energy(x):
            return self._energies(psi0_b, arrs_at(), x[0])[None]

        starts = make_multistarts(x0[None], active[None], self.n_starts,
                                  self.fresh_starts, self.restart_scale,
                                  self.generator)
        mi = torch.as_tensor(np.asarray(map_idx), device=starts.device)
        x_opt, x_new = multistart_adam(starts, active, mi[None], self.iters,
                                       self.lr, value_and_grad, energy)
        new = self._extend(new) if resample else new
        e_new = self._energies(self._first_row(psi0_b), new, x_new)
        return x_opt[0], e_new[0]

    def fused_step(self, psi0, old_tape_arrays, x0, n_active_old: int,
                   new_tape_arrays, map_idx):
        """One env's step: ``AngleOptimizer.fused_step``'s signature and
        result (x_opt (R,) numpy, e_new float, nfev)."""
        x0 = torch.as_tensor(np.asarray(x0), dtype=self.rdtype,
                             device=self.device)
        active = (torch.arange(x0.shape[0], device=self.device)
                  < int(n_active_old)).to(self.rdtype)
        x_opt, e_new = self._fused_step(self._psi0_batched(psi0),
                                        old_tape_arrays, x0, active,
                                        new_tape_arrays, map_idx)
        return (x_opt.cpu().numpy(), float(e_new),
                self.iters * self.n_starts)

    def fused_step_batch(self, psi0, old_arrs_b, x0_b, n_active_b,
                         new_arrs_b, map_idx_b):
        """``AngleOptimizer.fused_step_batch``'s signature, so that
        ``VectorCircuitEnv`` runs on the mesh: the envs one after another
        (a gate's work on the sharded state depends on the qubit it hits,
        so envs with different tapes do not share one sweep), each using
        the whole mesh.  psi0: one (D,) state shared by the envs."""
        xs, es = [], []
        for i in range(np.asarray(x0_b).shape[0]):
            x_opt, e_new, _ = self.fused_step(
                psi0, tuple(np.asarray(a)[i] for a in old_arrs_b),
                np.asarray(x0_b)[i], int(np.asarray(n_active_b)[i]),
                tuple(np.asarray(a)[i] for a in new_arrs_b),
                np.asarray(map_idx_b)[i])
            xs.append(x_opt)
            es.append(e_new)
        return np.stack(xs), np.asarray(es), self.iters * self.n_starts

    def energy(self, psi0, tape_arrays, x) -> float:
        """<H> of the tape at angles x: exact when noiseless, one drawn
        depolarizing trajectory with ``noise_mode='depolarizing'``."""
        arrs = (self._extend(tape_arrays)
                if self.noise_mode == "depolarizing" else tape_arrays)
        x = torch.as_tensor(np.asarray(x), dtype=self.rdtype,
                            device=self.device)
        psi_b = self._first_row(self._psi0_batched(psi0))
        return float(self._energies(psi_b, arrs, x[None])[0])
