"""Per-step variational angle optimization (multi-start Adam).

After every environment step the reference re-optimizes all circuit
angles (host COBYLA, ``environment_qulacs.py:220-225, 417-445``).  Here,
as in the JAX package, a fixed-iteration multi-start Adam does it on the
device: S starts per env, the whole batch of envs in one call.  On CUDA
the call is one launch of the fused kernel (``ops/fused_adam.py``); on the
CPU the same arithmetic runs as plain PyTorch in float64.

Start 0 is the incoming angle vector (COBYLA's warm start); the middle
starts add Gaussian noise; the last ``n_starts // 4`` are centered at zero
(one exactly zero).  Random streams come from an explicit
``torch.Generator`` and cannot match the JAX PRNG; parity tests inject
identical starts instead.

Start selection is over all S starts in one launch: the JAX package's
start chunking (``MAX_SR_ROWS``) and env chunking (``MAX_ENV_PER_CALL``)
exist only for TPU memory limits.

The fused step works on H - c0 I, where c0 is H's identity coefficient
(-70 Ha for 8-qubit H2O), and c0 is added back to its energies in
float64.  The gradient is the same (the gates keep <psi|psi> = 1), but
float32 energies and H psi products then round at the scale of the
non-constant part of H instead of |c0|.

Depolarizing noise (``noise_mode='depolarizing'``, one trajectory per
evaluation as in the reference) runs in the fused kernels too:
``noise_resample='iter'`` (the default) hands them ``noise=(p1, p2)`` and
per-call seeds, and they draw a fresh realization every Adam iteration;
``'step'`` quenches one realization per env step into 3G-long tapes
(``extend_tape_arrays``) for the noiseless kernels.  Shot noise and
``n_traj > 1`` need the composed kernels (``tensorrl_qas_tpu/ops/
pallas_apply.py``), which are not ported yet (ROADMAP.md, A4).
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device, complex_dtype, real_dtype
from tensorrl_qas_tpu_torch.ops.fused_adam import (
    check_gate_kinds,
    fused_adam_step,
)
from tensorrl_qas_tpu_torch.ops.fused_adam2d import (
    MAX_QUBITS,
    fused_adam_step2d,
    pauli_flip_groups,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape
from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
from tensorrl_qas_tpu_torch.sim.noise import (
    apply_tape_depolarizing,
    sample_depolarizing_kinds,
    shot_noise,
)

NOISE_MODES = ("none", "depolarizing", "shot")
NOISE_RESAMPLE = ("iter", "step")


def check_noise(noise_mode: str, n_traj: int = 1) -> None:
    """Refuse the noise settings the fused engines do not take: shot noise
    and depolarizing noise averaged over ``n_traj > 1`` trajectories need
    the composed engine (NotImplementedError)."""
    if noise_mode == "shot" or (noise_mode == "depolarizing"
                                and n_traj > 1):
        what = ("noise_mode='shot'" if noise_mode == "shot"
                else f"n_traj={n_traj}")
        raise NotImplementedError(
            f"{what} needs the composed engine over the kernels of "
            "tensorrl_qas_tpu/ops/pallas_apply.py, which is not ported yet "
            "(ROADMAP.md, A4: su4, shot noise and n_traj > 1)")


def extend_tape_arrays(arrs, kt, kc):
    """Interleave error-gate kinds into a 3x-long tape: position 3g is gate
    g, 3g + 1 its error on the target, 3g + 2 its error on the control
    (NONE where no error fired), without angle slots.  (..., G) integer
    tensors; the counterpart of the JAX package's function of this
    name."""
    kind, tq, cq, slot = (torch.as_tensor(a) for a in arrs)
    shape = (*kind.shape[:-1], 3 * kind.shape[-1])
    neg1 = torch.full_like(kind, -1)

    def weave(a, b, c):
        return torch.stack([a, b.to(a.dtype), c.to(a.dtype)],
                           dim=-1).reshape(shape)
    return (weave(kind, kt, kc), weave(tq, tq, cq.clamp(min=0)),
            weave(cq, neg1, neg1), weave(slot, neg1, neg1))


def make_multistarts(x0, active, n_starts: int, fresh_starts: int,
                     restart_scale: float, generator: torch.Generator):
    """(E, R) warm starts -> (E, S, R) start batch: start 0 exact, the
    middle ones warm + Gaussian, the last ``fresh_starts`` zero-centered
    (the first of them exactly zero); inactive slots are zeroed."""
    e_n, r = x0.shape
    s, f = n_starts, fresh_starts
    noise = torch.randn((e_n, s, r), generator=generator, dtype=x0.dtype,
                        device=x0.device) * restart_scale
    noise[:, 0, :] = 0.0
    starts = x0[:, None, :] + noise
    if f:
        fresh = noise[:, s - f:, :].clone()
        fresh[:, 0, :] = 0.0
        starts[:, s - f:, :] = fresh
    return starts * active[:, None, :]


def operands_from_jax(hre_t, him_t, psi0_re, psi0_im, n_qubits: int,
                      offset: float = 0.0, device=None):
    """The JAX optimizer's v1-kernel operands in this port's layout.

    The JAX package keeps the H^T planes zero-padded to at least 128 lanes
    (``AngleOptimizer._mega_ready``) and psi0 as an (re, im) pair of real
    planes; the port takes unpadded (D, D) planes of H - offset I (see
    ``AngleOptimizer.offset``) and a complex (D,) statevector.  Returns
    ((hre_t, him_t), psi0) on ``device``.
    """
    d = 1 << n_qubits
    dev = as_device(device)
    hre = np.array(hre_t, dtype=np.float64)[:d, :d] - offset * np.eye(d)
    planes = tuple(torch.as_tensor(p, dtype=real_dtype(dev), device=dev)
                   for p in (hre, np.array(him_t)[:d, :d]))
    psi0 = np.asarray(psi0_re)[:d] + 1j * np.asarray(psi0_im)[:d]
    return planes, torch.as_tensor(psi0, dtype=complex_dtype(dev),
                                   device=dev)


def operands2d_from_jax(wre, wim, flips, psi0_re, psi0_im, n_qubits: int,
                        offset: float = 0.0, device=None):
    """The JAX optimizer's v2-kernel operands in this port's layout.

    The JAX package keeps the flip-group planes of H in (G_f, D / 128, 128)
    lane tiles (``AngleOptimizer._mega2d_ready``) and psi0 as an (re, im)
    pair of planes; the port takes (G_f, D) planes of H - offset I (the
    offset off the f = 0 plane, see ``AngleOptimizer.offset``), the flips
    as an int32 tensor and a complex (D,) statevector.  Returns
    ((wre, wim, flips), psi0) on ``device``.
    """
    d = 1 << n_qubits
    dev = as_device(device)
    flips = np.asarray(flips, dtype=np.int32)
    wre = np.array(wre, dtype=np.float64).reshape(len(flips), d)
    wre[flips == 0] -= offset
    wim = np.array(wim, dtype=np.float64).reshape(len(flips), d)
    planes = tuple(torch.as_tensor(p, dtype=real_dtype(dev), device=dev)
                   for p in (wre, wim))
    psi0 = (np.asarray(psi0_re).reshape(d)
            + 1j * np.asarray(psi0_im).reshape(d))
    return ((*planes, torch.as_tensor(flips, device=dev)),
            torch.as_tensor(psi0, dtype=complex_dtype(dev), device=dev))


class AngleOptimizer:
    """Multi-start Adam angle optimizer bound to one problem.

    Args:
      pauli: the problem's ``PauliSum``.
      iters: Adam iterations per env step (config ``global_iters``).
      n_starts: starts per env.
      lr: Adam learning rate.
      restart_scale: stddev of the Gaussian start perturbation.
      device: where the statevectors live (CUDA by default).
      seed: seed of the generator of starts and noise draws.
      noise_mode: 'none' | 'depolarizing' | 'shot'.
      noise_p1/noise_p2: depolarizing probabilities after rotations /
        CNOTs (the reference's 0.01 / 0.05, ``VQE_qulacs_noise.py:32,45``).
      n_shots: shot-noise sample count (0: none).
      n_traj: trajectories averaged per depolarizing energy.
      noise_resample: 'iter' (a fresh realization every Adam iteration,
        in the kernels) or 'step' (one per env step, quenched into the
        tapes).
    """

    def __init__(self, pauli, iters: int = 100, n_starts: int = 8,
                 lr: float = 0.1, restart_scale: float = 0.1, device=None,
                 seed: int = 0, noise_mode: str = "none",
                 noise_p1: float = 0.01, noise_p2: float = 0.05,
                 n_shots: int = 0, n_traj: int = 1,
                 noise_resample: str = "iter"):
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode must be one of {NOISE_MODES}, "
                             f"got {noise_mode!r}")
        if noise_resample not in NOISE_RESAMPLE:
            raise ValueError(f"noise_resample must be one of "
                             f"{NOISE_RESAMPLE}, got {noise_resample!r}")
        self.pauli = pauli
        self.iters = iters
        self.n_starts = n_starts
        self.fresh_starts = n_starts // 4
        self.lr = lr
        self.restart_scale = restart_scale
        self.device = as_device(device)
        self.cdtype = complex_dtype(self.device)
        self.rdtype = real_dtype(self.device)
        self.pauli_t = pauli.tensors(self.device, self.cdtype)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.offset = pauli.identity_weight()
        self.noise_mode = noise_mode
        self.noise_p1 = noise_p1
        self.noise_p2 = noise_p2
        self.n_shots = n_shots
        self.n_traj = n_traj
        self.noise_resample = noise_resample
        self._h_planes = None
        self._w_planes = None

    def _pick_engine(self, *kinds) -> str:
        """The fused engine for this problem and tapes of these gate kinds:
        'v1' (dense H^T planes) for D <= 512, 'v2' (flip groups) for
        1024 <= D <= 2^18.  Larger problems and RXX/RYY/RZZ gates have no
        fused engine (ValueError), nor have shot noise and n_traj > 1
        (NotImplementedError), refused here before any H operand is
        built."""
        check_noise(self.noise_mode, self.n_traj)
        check_gate_kinds(*kinds)
        n = self.pauli.n_qubits
        if n <= 9:
            return "v1"
        if n <= MAX_QUBITS:
            return "v2"
        raise ValueError(f"no fused Adam engine for {n} qubits (at most "
                         f"{MAX_QUBITS})")

    def h_planes(self):
        """(hre_t, him_t): real and imaginary planes of (H - offset I)^T,
        (D, D)."""
        if self._h_planes is None:
            ht = self.pauli.to_dense().T
            ht -= self.offset * np.eye(ht.shape[0])
            self._h_planes = tuple(
                torch.as_tensor(np.ascontiguousarray(p), dtype=self.rdtype,
                                device=self.device)
                for p in (ht.real, ht.imag))
        return self._h_planes

    def w_planes(self):
        """(wre, wim, flips): flip-group planes of H - offset I, (G_f, D)
        each, and the flip masks (G_f,) int32."""
        if self._w_planes is None:
            wre, wim, flips = pauli_flip_groups(self.pauli, self.offset,
                                                dtype=np.float64)
            self._w_planes = (
                *(torch.as_tensor(p, dtype=self.rdtype, device=self.device)
                  for p in (wre, wim)),
                torch.as_tensor(flips, device=self.device))
        return self._w_planes

    def energy(self, psi0, tape_arrays, x) -> float:
        """Energy of one tape at angles x (eager path): with depolarizing
        noise the mean over ``n_traj`` trajectories, with shot noise plus
        its Gaussian sample, both drawn from the optimizer's generator."""
        x = torch.as_tensor(np.asarray(x), dtype=self.rdtype,
                            device=self.device)
        if self.noise_mode == "depolarizing":
            psi = apply_tape_depolarizing(
                psi0.expand(self.n_traj, -1), *tape_arrays, x,
                self.generator, self.noise_p1, self.noise_p2)
            return float(pauli_expectation(psi, *self.pauli_t).mean())
        psi = apply_tape(psi0, *tape_arrays, x)
        e = float(pauli_expectation(psi, *self.pauli_t))
        if self.noise_mode == "shot" and self.n_shots:
            e += float(shot_noise(self.pauli_t[0], self.n_shots,
                                  self.generator))
        return e

    def _quench(self, arrs, p):
        """One drawn realization woven into a 3G-long int32 tape."""
        kt, kc = sample_depolarizing_kinds(arrs[0], self.generator, *p)
        return tuple(a.to(torch.int32).contiguous()
                     for a in extend_tape_arrays(arrs, kt, kc))

    def fused_step_batch(self, psi0, old_arrs_b, x0_b, n_active_b,
                         new_arrs_b, map_idx_b):
        """One env step for B env replicas in one device call.

        psi0: complex tensor on the optimizer's device, (D,) shared by the
        batch or (B, D) one per env (block-coordinate trainable mode);
        old/new_arrs_b: tuples of (B, G) int arrays; x0_b (B, R);
        n_active_b (B,); map_idx_b (B, R).  G and R are independent (an
        embedded warm start gives more gates than angles).
        Returns (x_opt (B, R) numpy, e_new (B,) numpy, nfev).

        Both engines take either psi0 layout, so the engine choice does
        not depend on it.  The JAX package differs here: its v1 kernel
        takes a shared psi0 only, and a (B, D) psi0 drops v1 to its XLA
        path (reference ``optim/angle_opt.py:694-699``).
        """
        dev = self.device

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=dev)

        x0 = torch.as_tensor(np.asarray(x0_b), dtype=self.rdtype, device=dev)
        r = x0.shape[1]
        active = (torch.arange(r, device=dev)[None, :]
                  < torch.as_tensor(np.asarray(n_active_b),
                                    device=dev)[:, None]).to(self.rdtype)
        engine = self._pick_engine(old_arrs_b[0], new_arrs_b[0])
        starts = make_multistarts(x0, active, self.n_starts,
                                  self.fresh_starts, self.restart_scale,
                                  self.generator)
        old = tuple(ints(a) for a in old_arrs_b)
        new = tuple(ints(a) for a in new_arrs_b)
        noise = {}
        if self.noise_mode == "depolarizing":
            p = (self.noise_p1, self.noise_p2)
            if self.noise_resample == "iter":
                noise = dict(noise=p, seeds=torch.randint(
                    0, 2**31 - 1, (x0.shape[0], 2), generator=self.generator,
                    dtype=torch.int32, device=dev))
            else:
                old, new = (self._quench(arrs, p) for arrs in (old, new))
        if engine == "v1":
            step, h_ops = fused_adam_step, self.h_planes()
        else:
            step, h_ops = fused_adam_step2d, self.w_planes()
        p0 = psi0.reshape(-1, psi0.shape[-1])
        x_opt, e_new = step(
            old, new, ints(map_idx_b),
            p0.real.to(self.rdtype).contiguous(),
            p0.imag.to(self.rdtype).contiguous(),
            *h_ops, starts.contiguous(), active[:, None, :].contiguous(),
            iters=self.iters, lr=self.lr, **noise)
        return (x_opt.cpu().numpy(),
                e_new.cpu().numpy().astype(np.float64) + self.offset,
                self.iters * self.n_starts)
