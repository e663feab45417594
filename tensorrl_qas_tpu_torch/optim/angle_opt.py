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
(``extend_tape_arrays``) for the noiseless kernels.

The composed engine (``AngleOptimizer._fused_step_composed``, the twin of
the JAX package's ``_fused_step_pallas``) serves what the fused kernels
cannot: the su4 gate set's RXX/RYY/RZZ (``enable_2q``), shot noise, and
depolarizing noise averaged over ``n_traj > 1`` trajectories (re-drawn
every Adam iteration whatever ``noise_resample`` says, as in the JAX
package).  Each Adam iteration is one forward and one adjoint launch of
the tape kernels (``ops/apply_tape.py``), with the energy's H psi between
them: a matrix product up to 9 qubits, one gather over the flip groups
up to 16 (``flip_h_batched``), one group at a time above
(``flip_h_blocked``).  From 10 qubits the kernels read a schedule of each
tape, built once per step (``tape_schedule``); from 17 to 20 they are the
sweep kernels, every row in device memory, the tape in segments.  In
complex128 on the card (``dtype``, the env's ``sim_dtype``) every Adam
mode runs through the composed engine, on the double-precision tape
kernels (one chunk a row up to 12 qubits, segments above), since the
fused kernels hold their state in float32 registers.  On the card the
whole
step (100 iterations, the re-check, the argmin, the remap and e_new)
replays as one CUDA graph (``ComposedGraph``), the counterpart of the JAX
package's ``lax.scan`` under ``jit``; calling ``_fused_step_composed``
runs it eagerly.

``method='cobyla'`` is the reference's own protocol (``optimize``): scipy's
COBYLA, the optimizer the reference calls, over the live angles of one
tape, ``iters`` its maxiter.  Its noiseless cost is csim's float64
energy on the host (``native``), no device round trip per iterate; under
depolarizing or shot noise each evaluation draws a fresh realization and
runs one forward launch of the tape kernel (B3f) on the card
(``kernel_energy_fn``), the eager simulator on the CPU.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from tensorrl_qas_tpu_torch import (
    as_device,
    complex_dtype,
    real_dtype,
    real_of,
)
from tensorrl_qas_tpu_torch.native import CsimEngine
from tensorrl_qas_tpu_torch.ops import apply_tape as tape_ops
from tensorrl_qas_tpu_torch.ops.fused_adam import (
    B1,
    B2,
    EPS,
    _h_energy,
    check_gate_kinds,
    dense_h,
    fused_adam_step,
)
from tensorrl_qas_tpu_torch.ops.fused_adam2d import (
    MAX_QUBITS,
    flip_group_terms,
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

METHODS = ("adam", "cobyla")
NOISE_MODES = ("none", "depolarizing", "shot")
NOISE_RESAMPLE = ("iter", "step")


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


def multistart_adam(starts, active, map_idx, iters: int, lr: float,
                    value_and_grad, energy):
    """Multi-start Adam keeping each start's best iterate: the loop of the
    JAX package's ``_fused_step``, shared by the composed engine and the
    sharded optimizer (``optim/sharded_opt.py``), which differ only in how
    they evaluate.  starts (E, S, R); each iteration ``value_and_grad(x,
    it)`` gives the (E, S) energies at x and their gradient, masked here
    by ``active``; bias-corrected Adam (``B1`` / ``B2`` / ``EPS``); then
    ``energy(x)`` re-checks the last iterate.  Returns x_opt (E, R), each
    env's best start, and x_opt remapped by ``map_idx`` (E, R') onto the
    new tape (map -1 -> 0)."""
    x = starts
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    bx = x.clone()
    be = torch.full(x.shape[:2], float("inf"), dtype=x.dtype,
                    device=x.device)
    for it in range(iters):
        ev, g = value_and_grad(x, it)
        g = g * active
        better = ev < be
        bx = torch.where(better[..., None], x, bx)
        be = torch.where(better, ev, be)
        m = B1 * m + (1 - B1) * g
        v = B2 * v + (1 - B2) * g * g
        t = it + 1.0
        x = x - lr * (m / (1 - B1 ** t)) / (
            torch.sqrt(v / (1 - B2 ** t)) + EPS)
    with torch.no_grad():
        ev = energy(x)
        better = ev < be
        bx = torch.where(better[..., None], x, bx)
        be = torch.where(better, ev, be)
        best = torch.argmin(be, dim=1)
        x_opt = bx[torch.arange(x.shape[0], device=x.device), best]
        mi = map_idx.long()
        x_new = torch.where(mi >= 0, x_opt.gather(-1, mi.clamp(min=0)), 0.0)
    return x_opt, x_new


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


class _FlipGroupH(torch.autograd.Function):
    """(re, im, wre, wim, wtre, wtim, idx, real) -> (hre, him): H psi over
    flip-group planes in one gather, hre[i] + i him[i] = sum_f (wre_f[i] +
    i wim_f[i]) psi[i ^ f], idx the concatenated permutations i ^ f (G_f
    D), the sum over the group axis; ``real``: every wim is zero.  Its
    backward is the same gather of the cotangent through the transposed
    planes (wt_f[i] = w_f[i ^ f]; for a Hermitian H the planes themselves),
    so that no index_add with colliding indices (atomics, not bit for bit
    from run to run) enters the step."""

    @staticmethod
    def forward(ctx, re, im, wre, wim, wtre, wtim, idx, real):
        ctx.save_for_backward(wtre, wtim, idx)
        ctx.real = real
        return _gather_h(re, im, wre, wim, idx, real)

    @staticmethod
    def backward(ctx, ghre, ghim):
        wtre, wtim, idx = ctx.saved_tensors
        dre, dim = _gather_h(ghre.contiguous(), ghim.contiguous(), wtre,
                             -wtim, idx, ctx.real)
        return dre, dim, None, None, None, None, None, None


def _gather_h(re, im, wre, wim, idx, real):
    g_f, d = wre.shape
    pre = re.index_select(-1, idx).unflatten(-1, (g_f, d))
    pim = im.index_select(-1, idx).unflatten(-1, (g_f, d))
    if real:
        return (pre * wre).sum(-2), (pim * wre).sum(-2)
    return ((pre * wre - pim * wim).sum(-2),
            (pim * wre + pre * wim).sum(-2))


class _BlockedFlipH(torch.autograd.Function):
    """(re, im, wre, wim, wtre, wtim, plans, real) -> (hre, him): H psi over
    flip-group planes, one group at a time (``_blocked_h``); its backward
    is the same through the transposed planes, as ``_FlipGroupH``'s."""

    @staticmethod
    def forward(ctx, re, im, wre, wim, wtre, wtim, plans, real):
        ctx.save_for_backward(wtre, wtim)
        ctx.plans = plans
        ctx.real = real
        return _blocked_h(re, im, wre, wim, plans, real)

    @staticmethod
    def backward(ctx, ghre, ghim):
        wtre, wtim = ctx.saved_tensors
        dre, dim = _blocked_h(ghre.contiguous(), ghim.contiguous(), wtre,
                              -wtim, ctx.plans, ctx.real)
        return dre, dim, None, None, None, None, None, None


def flip_plan(flip: int, n: int):
    """x[..., i ^ flip] as a flip of axes of a view of (..., 2^n) planes:
    (the view's sizes, the axes to reverse).  Each run of consecutive set
    bits of ``flip`` is one axis of 2^k amplitudes, whose reversal is the
    XOR with 2^k - 1; the runs of clear bits between them are axes kept as
    they are."""
    sizes, axes = [], []
    q = n - 1
    while q >= 0:
        bit, k = (flip >> q) & 1, 0
        while q >= 0 and (flip >> q) & 1 == bit:
            k, q = k + 1, q - 1
        if bit:
            axes.append(len(sizes))
        sizes.append(1 << k)
    return tuple(sizes), tuple(axes)


def _partner(x, plan):
    """x[..., i ^ f] of (..., D) planes for f's ``flip_plan``."""
    sizes, axes = plan
    if not axes:
        return x
    lead = x.dim() - 1
    return x.reshape(*x.shape[:-1], *sizes).flip(
        [lead + a for a in axes]).reshape(x.shape)


def _blocked_h(re, im, wre, wim, plans, real):
    """sum_f (wre_f + i wim_f) psi[i ^ f] on (..., D) planes, one flip group
    at a time: its partner planes (``_partner``, two planes of the rows'
    size) multiplied into the sums in group order."""
    hre, him = torch.zeros_like(re), torch.zeros_like(im)
    for f, plan in enumerate(plans):
        pre, pim = _partner(re, plan), _partner(im, plan)
        hre.addcmul_(pre, wre[f])
        him.addcmul_(pim, wre[f])
        if not real:
            hre.addcmul_(pim, wim[f], value=-1.0)
            him.addcmul_(pre, wim[f])
    return hre, him


def flip_h_blocked(wre, wim, flips):
    """H psi through flip-group planes (G_f, D), one group at a time
    (``_BlockedFlipH``): the composed energy's H psi above 16 qubits, where
    ``flip_h_batched``'s single gather would write (rows, G_f, D) planes
    (2.7 GB a float32 plane at 20 qubits, 32 rows and the Heisenberg
    chain's 20 groups; 4x that at n_traj = 4).  A block is one group: its
    partners psi[i ^ f] are a flip of axes of a view of the planes
    (``flip_plan``: no index tensor), so that beyond its two sums a call
    holds two partner planes of the rows' size at a time (256 MB at 20
    qubits, 32 rows, float32).  The flips
    are read on the host once, here, so that the step itself reads
    nothing back; the JAX package computes this H psi on XLA
    (``pauli_expectation``), outside its kernels."""
    d = wre.shape[-1]
    n = d.bit_length() - 1
    plans = tuple(flip_plan(int(f), n) for f in flips.tolist())
    wtre = torch.stack([_partner(w, p) for w, p in zip(wre, plans)])
    wtim = torch.stack([_partner(w, p) for w, p in zip(wim, plans)])
    real = not bool((wim != 0).any())

    def apply(re, im):
        return _BlockedFlipH.apply(re, im, wre, wim, wtre, wtim, plans, real)
    return apply


def flip_h_batched(wre, wim, flips):
    """H psi through flip-group planes (G_f, D) as one gather of the
    concatenated permutations, a product with the W planes and a sum over
    the group axis (``_FlipGroupH``): the composed energy's H psi above 9
    qubits, a handful of kernels, with a backward (``ops/fused_adam.py:
    flip_h``, the fused kernels' plain versions', gathers in blocks and
    has none)."""
    d = wre.shape[-1]
    col = torch.arange(d, device=wre.device)
    perm = col[None, :] ^ flips.to(col.dtype)[:, None]     # (G_f, D)
    idx = perm.reshape(-1)
    wtre, wtim = (w.gather(1, perm) for w in (wre, wim))
    real = not bool((wim != 0).any())

    def apply(re, im):
        return _FlipGroupH.apply(re, im, wre, wim, wtre, wtim, idx, real)
    return apply


def flip_h_for(wre, wim, flips):
    """The composed engine's H psi through flip-group planes (G_f, D):
    ``flip_h_batched`` up to 16 qubits, ``flip_h_blocked`` from 17, where
    the single gather's (rows, G_f, D) planes outgrow the card."""
    n = wre.shape[-1].bit_length() - 1
    h = flip_h_batched if n < tape_ops.SWEEP_MIN_QUBITS else flip_h_blocked
    return h(wre, wim, flips)


class AngleOptimizer:
    """Per-step angle optimizer bound to one problem.

    Args:
      pauli: the problem's ``PauliSum``.
      method: 'adam' (multi-start Adam on the device) or 'cobyla' (the
        reference's scipy COBYLA, ``optimize``).
      iters: Adam iterations per env step, or COBYLA's maxiter (config
        ``global_iters``).
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
        tapes); the composed engine re-draws every iteration either way.
      enable_2q: tapes may hold RXX/RYY/RZZ (the su4 gate set), which
        only the composed engine takes.
      dtype: the complex statevector dtype (complex64 or complex128; None:
        the device's default, complex128 on the CPU, complex64 on CUDA).
    """

    def __init__(self, pauli, iters: int = 100, n_starts: int = 8,
                 lr: float = 0.1, restart_scale: float = 0.1, device=None,
                 seed: int = 0, noise_mode: str = "none",
                 noise_p1: float = 0.01, noise_p2: float = 0.05,
                 n_shots: int = 0, n_traj: int = 1,
                 noise_resample: str = "iter", enable_2q: bool = False,
                 method: str = "adam", dtype=None):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got "
                             f"{method!r}")
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode must be one of {NOISE_MODES}, "
                             f"got {noise_mode!r}")
        if noise_resample not in NOISE_RESAMPLE:
            raise ValueError(f"noise_resample must be one of "
                             f"{NOISE_RESAMPLE}, got {noise_resample!r}")
        if n_traj < 1:
            raise ValueError(f"n_traj must be at least 1, got {n_traj}")
        self.pauli = pauli
        self.method = method
        self.iters = iters
        self.n_starts = n_starts
        self.fresh_starts = n_starts // 4
        self.lr = lr
        self.restart_scale = restart_scale
        self.device = as_device(device)
        self.cdtype = dtype or complex_dtype(self.device)
        if self.cdtype not in (torch.complex64, torch.complex128):
            raise ValueError(f"dtype must be complex64 or complex128, got "
                             f"{self.cdtype}")
        self.rdtype = real_of(self.cdtype)
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
        self.enable_2q = enable_2q
        self._h_planes = None
        self._w_planes = None
        self._w_terms = None
        self._graph = None
        self._csim = None

    def _composed_only(self) -> bool:
        """Whether these modes need the composed engine on any device: the
        su4 gate set, shot noise, depolarizing noise over n_traj > 1."""
        return (self.enable_2q or self.noise_mode == "shot"
                or (self.noise_mode == "depolarizing" and self.n_traj > 1))

    def _pick_engine(self, *kinds) -> str:
        """The engine for this problem and tapes of these gate kinds:
        'composed' for the su4 gate set (``enable_2q``), shot noise and
        ``n_traj > 1`` (reference ``optim/angle_opt.py:283-287, 690-693``),
        at most 20 qubits (its tape kernels' sweep design from 17; the JAX
        package runs these modes through XLA above 16, ``optim/
        angle_opt.py:808-845``), and for every mode in float64 on CUDA (the
        fused kernels are float32; the composed engine's tape kernels have
        a double-precision instance); else the fused 'v1' for D <= 512,
        'v2' for 1024 <= D <= 2^20 (both take the flip-group planes,
        ``w_planes``; on the CPU their plain versions at any dtype).
        Larger problems, and RXX/RYY/RZZ gates without ``enable_2q``, raise
        ValueError here, before any H operand is built."""
        n = self.pauli.n_qubits
        composed = self._composed_only()
        if not composed:
            check_gate_kinds(*kinds)
        if composed or (self.device.type == "cuda"
                        and self.rdtype == torch.float64):
            if n > tape_ops.MAX_QUBITS:
                raise ValueError(
                    f"no composed engine for {n} qubits (at most "
                    f"{tape_ops.MAX_QUBITS}); {tape_ops.ABOVE_CAP}")
            return "composed"
        if n <= 9:
            return "v1"
        if n <= MAX_QUBITS:
            return "v2"
        raise ValueError(f"no fused Adam engine for {n} qubits (at most "
                         f"{MAX_QUBITS}); EnvConfig.mesh_shape runs more on "
                         "the sharded path (optim/sharded_opt.py), a (1, 1) "
                         "mesh included")

    def h_planes(self):
        """(hre_t, him_t): real and imaginary planes of (H - offset I)^T,
        (D, D): the composed engine's H psi up to 9 qubits."""
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

    def w_terms(self):
        """``flip_group_terms`` of the planes' H - offset I: from them the
        sweep kernel (19-20 qubits) computes a group's W itself."""
        if self._w_terms is None:
            self._w_terms = flip_group_terms(self.pauli, self.offset)
        return self._w_terms

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

    def _h_apply(self, dtype):
        """H - offset I on (..., D) planes of ``dtype``: the dense H^T
        planes up to 9 qubits, the flip-group planes in one gather up to 16
        (``flip_h_batched``), one group at a time above
        (``flip_h_blocked``)."""
        n = self.pauli.n_qubits
        if n <= 9:
            return dense_h(*(p.to(dtype) for p in self.h_planes()))
        wre, wim, flips = self.w_planes()
        return flip_h_for(wre.to(dtype), wim.to(dtype), flips)

    def _sample_noise_kinds(self, kind, n_traj: int, generator):
        """``n_traj`` depolarizing realizations (k_t, k_c), each
        (n_traj, E, G), of the (E, G) tapes ``kind``, shared by an env's
        starts (tests inject their own here)."""
        return sample_depolarizing_kinds(kind.expand(n_traj, -1, -1),
                                         generator, self.noise_p1,
                                         self.noise_p2)

    def _noise_generator(self, seed: int, tag: int):
        """The composed engine's draws at ``tag`` of a step seeded with
        ``seed``: tag ``it`` for Adam iteration it, ``iters`` for the final
        re-check, ``iters + 1`` for e_new (the fused kernels' tags), so a
        realization does not depend on the draws before it."""
        return torch.Generator(device=self.device).manual_seed(
            (seed << 20) + tag)

    def _noisy(self) -> bool:
        """Whether the composed engine draws noise: depolarizing, or shot
        noise with shots."""
        return (self.noise_mode == "depolarizing"
                or (self.noise_mode == "shot" and self.n_shots > 0))

    def _draw_noise(self, gen, kind, e_n: int, s_n: int):
        """One tag's noise realization, drawn from ``gen``: depolarizing,
        the (k_t, k_c) of ``n_traj`` realizations of the (E, G) tapes
        ``kind``; shot noise, the (E, S) float64 offsets (eps @ w)
        n_shots^-1/2, eps standard normal per (env, start, Pauli term)."""
        if self.noise_mode == "depolarizing":
            return self._sample_noise_kinds(kind, self.n_traj, gen)
        w = self.pauli_t[0].double()
        eps = torch.randn((e_n, s_n, w.shape[0]), generator=gen,
                          dtype=torch.float64, device=kind.device)
        return (eps @ w) * self.n_shots ** -0.5

    def predraw_noise(self, old_kind, new_kind, e_n: int, s_n: int, *,
                      iters: int, seed: int, enew_tag: int | None = None):
        """Every realization a composed step seeded with ``seed`` draws,
        in its order: Adam iterations 0 .. iters - 1 and the re-check on
        ``old_kind``'s tapes, then e_new (tag ``enew_tag``, default iters
        + 1, one start) on ``new_kind``'s; the same generators and calls
        as the step's own draws, so a step fed them (``draws``) gives the
        same result bit for bit.  None without noise."""
        if not self._noisy():
            return None
        tags = [*range(iters + 1), iters + 1 if enew_tag is None
                else enew_tag]
        return [self._draw_noise(self._noise_generator(seed, tag),
                                 new_kind if at > iters else old_kind, e_n,
                                 1 if at > iters else s_n)
                for at, tag in enumerate(tags)]

    def _composed_energy(self, x, tape, re0, im0, h_apply, plain, gen,
                         noise=None, schedule=None, quiet=False):
        """(E, S) energies of H - offset I at angles x (E, S, R) of the
        (E, G) int32 tapes from psi0 planes re0 / im0 ((1 or E, 1, D)):
        one forward launch (``ApplyTape``, differentiable in x; from 10
        qubits reading ``schedule``, the tapes' ``tape_schedule``), then
        the Rayleigh quotient with float64 sums.  ``noise`` is the tag's
        realization (``_draw_noise``), drawn from ``gen`` when not given:
        depolarizing, the mean over the ``n_traj`` realizations, stacked
        along the env axis (still one launch, on the woven tapes under the
        same schedule); shot noise, plus its offsets, on the value only.
        ``quiet``: no noise, whatever the optimizer's mode (the tapes carry a
        quenched realization)."""
        e_n, s_n, _ = x.shape
        mode = "none" if quiet else self.noise_mode
        if noise is None and gen is not None and not quiet and self._noisy():
            noise = self._draw_noise(gen, tape[0], e_n, s_n)
        t_n, weave = 1, 1
        if mode == "depolarizing":
            weave = 3
            t_n = self.n_traj
            kt, kc = noise
            tape = tuple(
                a.reshape(t_n * e_n, -1).to(torch.int32).contiguous()
                for a in extend_tape_arrays(
                    tuple(a.expand(t_n, -1, -1) for a in tape), kt, kc))
            x = x.repeat(t_n, 1, 1)
        d = re0.shape[-1]
        re, im = (p.expand(e_n, s_n, d).repeat(t_n, 1, 1) for p in (re0, im0))
        ore, oim = tape_ops.apply_tape_ri(re, im, *tape, x, plain=plain,
                                          tapes_checked=True,
                                          schedule=schedule, weave=weave)
        _, _, ev = _h_energy(ore, oim, h_apply)
        ev = ev.view(t_n, e_n, s_n).mean(0)
        if mode == "shot" and noise is not None:
            ev = ev + noise.to(ev.dtype)
        return ev

    def _fused_step_composed(self, old, new, map_idx, p0re, p0im, h_apply,
                             starts, active, *, iters: int, lr: float,
                             seed: int = 0, enew_tag: int | None = None,
                             plain: bool = False, draws=None,
                             quiet: bool = False):
        """The composed engine (reference ``_fused_step_pallas``,
        ``optim/angle_opt.py:580-671``), in the fused step's layout: (E, G)
        int32 tapes ``old`` / ``new`` (checked with ``check_tapes``),
        map_idx (E, R), psi0 planes (1, D) shared or (E, D) one per env,
        ``h_apply`` (H - offset I on planes), starts (E, S, R), active
        (E, 1, R); any float dtype.  Multi-start Adam over ``old``, each
        iteration one forward and one adjoint launch at x (gradient masked
        by ``active``), tracking every start's best iterate by its (noisy)
        energy; a final re-check of x; x_opt = the best start; e_new on
        ``new`` at x_opt remapped by ``map_idx`` (map -1 -> 0), S = 1.
        Adam's bias corrections are computed in float64.  From 10 qubits
        the kernels read each tape's schedule, built once here
        (``tape_schedule``: one launch for ``old``, one for ``new``).
        Noise is drawn at tags (``_noise_generator``: ``seed``;
        ``enew_tag`` replaces e_new's tag ``iters + 1``), or read from
        ``draws``, the step's realizations in order (``predraw_noise``: the
        same values, bit for bit; a captured graph reads them from its
        buffers).  The forward
        kernel takes (E, S, D) planes either way, so per-env psi0 (su4
        with block-coordinate mode) costs nothing here (the JAX package
        runs that case on XLA, ``optim/angle_opt.py:818-822``).
        ``plain`` runs the kernels' plain versions on any device (the card
        check's reference).  ``quiet`` runs the step without noise (tapes
        that carry a quenched realization).
        Returns (x_opt (E, R), e_new (E,)) of H - offset I."""
        dtype = starts.dtype
        re0, im0 = (p.to(dtype).reshape(-1, 1, p.shape[-1])
                    for p in (p0re, p0im))
        noisy = self._noisy() and not quiet
        n, r = self.pauli.n_qubits, starts.shape[-1]

        def schedule(tape):
            return (None if plain
                    else tape_ops.tape_schedule(*tape, n, r, dtype))

        def energy(x, tape, tag, at, sched):
            noise = None if draws is None else draws[at]
            gen = (self._noise_generator(seed, tag)
                   if noisy and draws is None else None)
            return self._composed_energy(x, tape, re0, im0, h_apply, plain,
                                         gen, noise, sched, quiet)

        sched_old = schedule(old)

        def value_and_grad(x, it):
            xg = x.detach().requires_grad_()
            with torch.enable_grad():
                ev = energy(xg, old, it, it, sched_old)
                g, = torch.autograd.grad(ev.sum(), xg)
            return ev.detach(), g

        x_opt, x_new = multistart_adam(
            starts, active, map_idx, iters, lr, value_and_grad,
            lambda x: energy(x, old, iters, iters, sched_old))
        with torch.no_grad():
            e_new = energy(x_new[:, None, :], new,
                           iters + 1 if enew_tag is None else enew_tag,
                           iters + 1, schedule(new))
        return x_opt, e_new[:, 0]

    def fused_step_batch(self, psi0, old_arrs_b, x0_b, n_active_b,
                         new_arrs_b, map_idx_b):
        """One env step for B env replicas in one device call (the fused
        engines) or one forward and one adjoint launch per Adam iteration
        (the composed engine; on the card one replay of its graph,
        ``composed_graph``).

        psi0: complex tensor on the optimizer's device, (D,) shared by the
        batch or (B, D) one per env (block-coordinate trainable mode);
        old/new_arrs_b: tuples of (B, G) int arrays; x0_b (B, R);
        n_active_b (B,); map_idx_b (B, R).  G and R are independent (an
        embedded warm start gives more gates than angles).
        Returns (x_opt (B, R) numpy, e_new (B,) numpy, nfev).

        Every engine takes either psi0 layout, so the engine choice does
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
        p0 = psi0.reshape(-1, psi0.shape[-1])
        p0re = p0.real.to(self.rdtype).contiguous()
        p0im = p0.imag.to(self.rdtype).contiguous()
        if engine == "composed":
            quiet = (self.noise_mode == "depolarizing"
                     and self.noise_resample == "step"
                     and not self._composed_only())
            if quiet:
                # a fused mode on the composed engine (float64 on the
                # card): one realization quenched into both tapes, as the
                # fused path does, and the step run without noise
                p = (self.noise_p1, self.noise_p2)
                old, new = (self._quench(arrs, p) for arrs in (old, new))
            for tape in (old, new):
                tape_ops.check_tapes(*tape, self.pauli.n_qubits, r)
            seed = int(torch.randint(0, 2**31 - 1, (1,),
                                     generator=self.generator, device=dev))
            args = (old, new, ints(map_idx_b), p0re, p0im)
            kw = dict(iters=self.iters, lr=self.lr, seed=seed, quiet=quiet)
            if dev.type == "cuda":
                x_opt, e_new = self.composed_graph()(
                    *args, starts, active[:, None, :], **kw)
            else:
                x_opt, e_new = self._fused_step_composed(
                    *args, self._h_apply(self.rdtype), starts,
                    active[:, None, :], **kw)
            return (x_opt.cpu().numpy(),
                    e_new.cpu().numpy().astype(np.float64) + self.offset,
                    self.iters * self.n_starts)
        step_kw = {}
        if self.noise_mode == "depolarizing":
            p = (self.noise_p1, self.noise_p2)
            if self.noise_resample == "iter":
                step_kw = dict(noise=p, seeds=torch.randint(
                    0, 2**31 - 1, (x0.shape[0], 2), generator=self.generator,
                    dtype=torch.int32, device=dev))
            else:
                old, new = (self._quench(arrs, p) for arrs in (old, new))
        step = fused_adam_step if engine == "v1" else fused_adam_step2d
        if engine != "v1":
            step_kw["terms"] = self.w_terms()
        x_opt, e_new = step(
            old, new, ints(map_idx_b), p0re, p0im,
            *self.w_planes(), starts.contiguous(),
            active[:, None, :].contiguous(), iters=self.iters, lr=self.lr,
            **step_kw)
        return (x_opt.cpu().numpy(),
                e_new.cpu().numpy().astype(np.float64) + self.offset,
                self.iters * self.n_starts)

    def fused_step(self, psi0, old_tape_arrays, x0, n_active_old: int,
                   new_tape_arrays, map_idx):
        """One env's step (reference ``optim/angle_opt.py:476-496``): the
        fused step on a batch of one.  (G,) tapes, x0 and map_idx (R,).
        Returns (x_opt (R,) numpy, e_new float, nfev)."""
        def one(arrs):
            return tuple(np.asarray(a)[None] for a in arrs)
        x_opt, e_new, nfev = self.fused_step_batch(
            psi0, one(old_tape_arrays), np.asarray(x0)[None],
            np.asarray([n_active_old]), one(new_tape_arrays),
            np.asarray(map_idx)[None])
        return x_opt[0], float(e_new[0]), nfev

    def optimize(self, psi0, tape_arrays, x0, n_active: int):
        """Optimize the first ``n_active`` angles of x0 (R,) on one tape
        from psi0 ((D,) complex on the optimizer's device); reference
        ``optim/angle_opt.py:840-896``.  Returns (x (R,) numpy, energy
        float, nfev).

        'adam': the fused step with this tape as both the old and the new
        tape and the identity map, so e_new is the energy at x_opt.
        'cobyla': ``scipy.optimize.minimize(method='COBYLA')`` from the
        first ``n_active`` entries of x0 (float64) with maxiter ``iters``
        on ``cobyla_cost``; with no live angle it returns x0 at once (nfev
        0); the energy is ``energy`` at the result."""
        if self.method == "adam":
            ident = np.arange(len(x0), dtype=np.int32)
            return self.fused_step(psi0, tape_arrays, x0, n_active,
                                   tape_arrays, ident)
        import scipy.optimize

        x0 = np.array(x0, dtype=np.float64)
        if n_active == 0:
            return x0, self.energy(psi0, tape_arrays, x0), 0
        res = scipy.optimize.minimize(
            self.cobyla_cost(psi0, tape_arrays, x0, n_active),
            x0=x0[:n_active], method="COBYLA",
            options={"maxiter": self.iters})
        x = x0.copy()
        x[:n_active] = res["x"]
        return x, self.energy(psi0, tape_arrays, x), int(res["nfev"])

    def csim(self) -> CsimEngine:
        """This problem's host engine (``native``, built at first use)."""
        if self._csim is None:
            self._csim = CsimEngine(self.pauli)
        return self._csim

    def cobyla_cost(self, psi0, tape_arrays, x0, n_active: int):
        """COBYLA's cost: the energy of the (G,) tape from psi0 as a function
        of the first ``n_active`` angles, the others held at x0's.
        Noiseless, csim's float64 ``tape_energy`` on the host (psi0 and the
        tape copied there once, here); with depolarizing or shot noise, a
        fresh realization every evaluation: on CUDA one B3f launch
        (``kernel_energy_fn``), on the CPU the eager simulator
        (``energy``)."""
        xa = np.array(x0, dtype=np.float64)
        if self.noise_mode == "none":
            energy = self.csim().energy_fn(psi0, *tape_arrays)
        elif self.device.type == "cuda":
            energy = self.kernel_energy_fn(psi0, tape_arrays, len(xa))
        else:
            def energy(x):
                return self.energy(psi0, tape_arrays, x)

        def cost(xs):
            xa[:n_active] = xs
            return energy(xa)
        return cost

    def kernel_energy_fn(self, psi0, tape_arrays, r: int):
        """The energy of one (G,) tape with ``r`` angles from psi0 through
        the tape kernel, as a function ``energy(x, noise=None) -> float`` of
        its angles (R,): one forward launch (B3f, no adjoint) on the tape
        woven with the realization ``noise`` (``_draw_noise`` at E = S = 1:
        depolarizing, (k_t, k_c) of ``n_traj`` realizations, laid out as
        the composed engine lays them out; shot noise, the offset), drawn
        from the optimizer's generator when not given; then the Rayleigh
        quotient of H - offset I (``_h_apply``), plus the offset.  The
        tape is checked and, from 10 qubits, its schedule built once, here
        (from 17 qubits the sweep kernel's segments); more than
        ``ops/apply_tape.py:MAX_QUBITS`` qubits raise.  On CPU tensors the
        launch is the kernel's plain version."""
        n = self.pauli.n_qubits
        if n > tape_ops.MAX_QUBITS:
            raise ValueError(f"no tape kernel for {n} qubits (at most "
                             f"{tape_ops.MAX_QUBITS}); {tape_ops.ABOVE_CAP}")
        dev = self.device
        tape = tuple(torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                     device=dev).reshape(1, -1)
                     for a in tape_arrays)
        tape_ops.check_tapes(*tape, n, r)
        schedule = tape_ops.tape_schedule(*tape, n, r, self.rdtype)
        p0 = psi0.reshape(1, 1, -1)
        re0 = p0.real.to(self.rdtype).contiguous()
        im0 = p0.imag.to(self.rdtype).contiguous()
        h_apply = self._h_apply(self.rdtype)

        def energy(x, noise=None) -> float:
            xt = torch.as_tensor(np.asarray(x), dtype=self.rdtype,
                                 device=dev).reshape(1, 1, r)
            gen = self.generator if noise is None else None
            with torch.no_grad():
                ev = self._composed_energy(xt, tape, re0, im0, h_apply,
                                           False, gen, noise, schedule)
            return float(ev[0, 0]) + self.offset
        return energy

    def plain_energy(self, psi0, tape_arrays, x, noise=None) -> float:
        """``kernel_energy_fn``'s energy by the eager simulator in
        complex128 on the optimizer's device, under the same realization
        ``noise`` (none: the noiseless energy): the check of the kernel
        path."""
        dev = self.device
        tape = tuple(torch.as_tensor(np.asarray(a), device=dev).reshape(1, -1)
                     for a in tape_arrays)
        rows, shift = [tuple(a[0] for a in tape)], 0.0
        if noise is not None and self.noise_mode == "depolarizing":
            kt, kc = noise
            t_n = kt.shape[0]
            woven = extend_tape_arrays(
                tuple(a.expand(t_n, 1, -1) for a in tape), kt, kc)
            rows = [tuple(a[t, 0] for a in woven) for t in range(t_n)]
        elif noise is not None:
            shift = float(noise.reshape(-1)[0])
        psi0 = psi0.to(torch.complex128)
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)
        pauli = self.pauli.tensors(dev, torch.complex128)
        es = [float(pauli_expectation(apply_tape(psi0, *row, x), *pauli))
              for row in rows]
        return float(np.mean(es)) + shift

    def composed_graph(self) -> "ComposedGraph":
        """This optimizer's graph of the composed step (made at first
        use)."""
        if self._graph is None:
            self._graph = ComposedGraph(self)
        return self._graph


class ComposedGraph:
    """The composed step (``AngleOptimizer._fused_step_composed``) as one
    CUDA graph per shape key, the port's counterpart of the JAX package's
    ``lax.scan`` under ``jit``: 100 Adam iterations, each a B3f launch,
    the energy, the autograd adjoint (B3b) and the Adam update, then the
    re-check, the argmin, the remap and e_new, replayed with one host
    call.

    Call it as the step (without ``h_apply``, the optimizer's own
    ``_h_apply``).  The first call at a key copies its inputs into static
    buffers, runs the step eagerly on them on a side stream -- the
    warm-up capture needs, whose result it returns -- and captures the
    same step on the same buffers.  Every later call at that key copies
    its inputs (the tapes, the map, the psi0 planes, the starts, active)
    and its noise realizations into the buffers, replays the graph and
    returns clones of its outputs.  The realizations are drawn before the
    replay by ``predraw_noise`` (host generators would be frozen into a
    graph), so a replay gives the eager kernel path's x_opt and e_new bit
    for bit under every noise mode.  The key: E, S, G, R, D, psi0 rows,
    iters, lr, dtype, noise mode (none for a ``quiet`` step), n_traj,
    n_shots.  A replay launches
    kernels without the wrappers' Python, so it adds the launches its
    capture recorded to the tape kernels' counters (their sweep and
    double-precision counts too) and the schedule's.  A
    capture or a replay that fails raises: nothing falls back to the eager
    loop."""

    def __init__(self, opt: AngleOptimizer):
        self.opt = opt
        self.entries = {}
        self.captures = 0

    def key(self, old, p0re, starts, iters: int, lr: float, quiet: bool):
        o = self.opt
        return (*starts.shape, old[0].shape[-1], *p0re.shape, iters,
                float(lr), starts.dtype, "none" if quiet else o.noise_mode,
                o.n_traj, o.n_shots)

    def __call__(self, old, new, map_idx, p0re, p0im, starts, active, *,
                 iters: int, lr: float, seed: int = 0,
                 enew_tag: int | None = None, quiet: bool = False):
        inputs = (*old, *new, map_idx, p0re, p0im, starts, active)
        reals = None if quiet else self.opt.predraw_noise(
            old[0], new[0], *starts.shape[:2], iters=iters, seed=seed,
            enew_tag=enew_tag)
        key = self.key(old, p0re, starts, iters, lr, quiet)
        entry = self.entries.get(key)
        if entry is not None:
            entry["load"](inputs, reals)
            return tuple(t.clone() for t in entry["replay"]())
        static = [t.clone() for t in inputs]
        noise = _noise_buffers(reals, iters)
        h_apply = self.opt._h_apply(starts.dtype)

        def run():
            o_, n_ = static[:4], static[4:8]
            return self.opt._fused_step_composed(
                o_, n_, *static[8:11], h_apply, *static[11:], iters=iters,
                lr=lr, draws=None if noise is None else noise["draws"],
                quiet=quiet)

        def load(inputs, reals):
            for dst, src in zip(static, inputs):
                dst.copy_(src)
            if noise is not None:
                noise["fill"](reals)
        first, replay = self._record(run)
        self.entries[key] = {"load": load, "replay": replay,
                             "keep": (static, noise, h_apply)}
        self.captures += 1
        return first

    def _record(self, run):
        """``run`` eagerly on a side stream (the warm-up), then captured:
        -> (the warm-up's outputs, a function that replays the graph and
        returns its static outputs)."""
        dev = self.opt.device
        if dev.type != "cuda":
            raise ValueError(f"ComposedGraph: CUDA graphs need a CUDA "
                             f"device, not {dev}")
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            first = run()
        torch.cuda.current_stream(dev).wait_stream(side)
        first = tuple(t.clone() for t in first)
        counters = [(k, "launches") for k in (tape_ops.apply_tape_fwd,
                                               tape_ops.apply_tape_bwd,
                                               tape_ops.tape_schedule)]
        counters += [(k, attr) for k in (tape_ops.apply_tape_fwd,
                                         tape_ops.apply_tape_bwd)
                     for attr in ("sweep_launches", "f64_launches")]
        before = [getattr(*k) for k in counters]
        graph = torch.cuda.CUDAGraph()
        # a dead graph in a reference cycle (another optimizer's: an
        # optimizer and its ComposedGraph point at each other) that the
        # cyclic collector frees inside this capture would destroy its CUDA
        # graph there, which a capture forbids, and invalidate it: collect
        # before the capture, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = run()
        finally:
            if collecting:
                gc.enable()
        # a capture records its launches without running them
        per_replay = [getattr(*k) - b for k, b in zip(counters, before)]
        for (k, attr), b in zip(counters, before):
            setattr(k, attr, b)

        def replay():
            graph.replay()
            for (k, attr), n in zip(counters, per_replay):
                setattr(k, attr, getattr(k, attr) + n)
            return out
        return first, replay


def _noise_buffers(reals, iters: int):
    """Static buffers for a step's pre-drawn realizations (``reals``, as
    ``predraw_noise`` returns them; None without noise): {"draws": the
    per-tag views a captured step reads, "fill": copies new realizations
    in}.  Depolarizing: (iters + 2, n_traj, E, G) k_t and k_c; shot noise:
    (iters + 2, E, S) offsets, e_new's in column 0 of the last row."""
    if reals is None:
        return None
    if isinstance(reals[0], tuple):
        bufs = [torch.stack([r[i] for r in reals]) for i in (0, 1)]
        draws = [(bufs[0][a], bufs[1][a]) for a in range(iters + 2)]

        def fill(reals):
            for i, buf in enumerate(bufs):
                torch.stack([r[i] for r in reals], out=buf)
    else:
        buf = torch.zeros((iters + 2, *reals[0].shape),
                          dtype=reals[0].dtype, device=reals[0].device)
        draws = [buf[a] for a in range(iters + 1)] + [buf[iters + 1, :, :1]]

        def fill(reals):
            buf[:iters + 1].copy_(torch.stack(reals[:-1]))
            draws[-1].copy_(reals[-1])
        fill(reals)
    return {"draws": draws, "fill": fill}


def composed_step(opt: AngleOptimizer, plain: bool = False):
    """``opt``'s composed engine as a function of the fused step's
    arguments, ``step(old, new, map_idx, p0re, p0im, *h_ops, starts,
    active, *, iters, lr, seed=0, enew_tag=None)`` with the dense H^T
    planes (two H operands) or the flip-group planes and flips (three,
    ``flip_h_for``), so that ``ops/fused_adam.py:plain_results`` and
    ``agreement`` hold the kernels (``plain=False``) to the plain versions
    (``plain=True``)."""

    def step(old, new, map_idx, p0re, p0im, *rest, iters, lr, seed=0,
             enew_tag=None):
        *h_ops, starts, active = rest
        h_apply = dense_h(*h_ops) if len(h_ops) == 2 else flip_h_for(*h_ops)
        return opt._fused_step_composed(
            old, new, map_idx, p0re, p0im, h_apply, starts, active,
            iters=iters, lr=lr, seed=seed, enew_tag=enew_tag, plain=plain)
    return step
