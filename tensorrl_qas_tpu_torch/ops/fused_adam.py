"""One env step of multi-start Adam angle optimization, fused.

Counterpart of ``tensorrl_qas_tpu/ops/pallas_opt.py`` (the v1 kernel).
For each env e of a batch, with S optimizer starts:

    for it in range(iters):                     # Adam over the OLD tape
        psi  = tape_old(x) psi0                 # (S, D)
        Hpsi = psi @ H^T
        E    = Re<psi|H psi> / <psi|psi>        # best-iterate tracking
        dx   = adjoint sweep, lambda = 2 conj(H psi), masked by `active`
        x    = adam(x, dx)
    final re-check; x_opt = best start; x_new = x_opt[map] (map -1 -> 0)
    e_new = E(tape_new, x_new)

``fused_adam_step`` launches the CUDA kernel ``csrc/fused_adam_v1.cu`` on
CUDA tensors and runs ``fused_adam_step_reference``, the plain PyTorch
version of the same arithmetic, on CPU tensors.  Layouts follow the JAX
reference's public function: tapes (E, G) int32, map_idx (E, R) int32,
p0re/p0im (1, D), hre_t/him_t (D, D) planes of H^T, starts (E, S, R),
active (E, 1, R); returns x_opt (E, R) and e_new (E,).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_CX, _X, _Y = int(GateKind.CX), int(GateKind.X), int(GateKind.Y)
_Z, _H = int(GateKind.Z), int(GateKind.H)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_STARTS = 8           # register-blocked H psi in the kernel
MAX_SMEM_BYTES = 232448  # H100: shared memory one block may use


# -- plain PyTorch version -------------------------------------------------

def _gate_coeffs(k, theta):
    """(re, im) parts of the 2x2 unitary entries (u00, u01, u10, u11);
    k (E, 1, 1) gate kinds, theta (E, S, 1) angles."""
    c = torch.cos(0.5 * theta)
    s = torch.sin(0.5 * theta)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    is_rx, is_ry, is_rz = k == _RX, k == _RY, k == _RZ
    is_x = (k == _CX) | (k == _X)
    is_y, is_z, is_h = k == _Y, k == _Z, k == _H
    is_rot_diag = is_rx | is_ry
    is_id = ~(is_rx | is_ry | is_rz | is_x | is_y | is_z | is_h)
    w = torch.where
    r2 = _INV_SQRT2 * one
    u00r = w(is_rot_diag | is_rz, c, w(is_h, r2, w(is_id | is_z, one, zero)))
    u00i = w(is_rz, -s, zero)
    u11r = w(is_rot_diag | is_rz, c,
             w(is_h, -r2, w(is_id, one, w(is_z, -one, zero))))
    u11i = w(is_rz, s, zero)
    u01r = w(is_ry, -s, w(is_x, one, w(is_h, r2, zero)))
    u01i = w(is_rx, -s, w(is_y, -one, zero))
    u10r = w(is_ry, s, w(is_x, one, w(is_h, r2, zero)))
    u10i = w(is_rx, -s, w(is_y, one, zero))
    return (u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i)


class _Gate:
    """Per-env view of tape position g: partner gather index, target bit
    and control mask, all (E, 1, D)."""

    def __init__(self, tape, g, x, col):
        kind, tq, cq, slot = tape
        e_n, s_n, _ = x.shape
        d = col.shape[-1]
        self.k = kind[:, g].view(-1, 1, 1)
        t = tq[:, g].view(-1, 1, 1)
        c = cq[:, g].view(-1, 1, 1)
        self.slot = slot[:, g]
        sidx = self.slot.clamp(min=0).view(-1, 1, 1).expand(e_n, s_n, 1)
        self.theta = torch.where(self.slot.view(-1, 1, 1) >= 0,
                                 x.gather(2, sidx),
                                 torch.zeros_like(x[..., :1]))
        self.partner = (col ^ (1 << t)).expand(e_n, s_n, d)
        self.b = (col >> t) & 1
        self.act = torch.where(c >= 0, (col >> c.clamp(min=0)) & 1,
                               torch.ones_like(self.b)).bool()

    def xor(self, plane):
        return plane.gather(2, self.partner)

    def apply_u(self, re, im, coeffs):
        """One (controlled) 2x2 combine on the re/im planes."""
        u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i = coeffs
        pre, pim = self.xor(re), self.xor(im)
        b0 = self.b == 0
        dr = torch.where(b0, u00r, u11r)
        di = torch.where(b0, u00i, u11i)
        fr = torch.where(b0, u01r, u10r)
        fi = torch.where(b0, u01i, u10i)
        nre = dr * re - di * im + fr * pre - fi * pim
        nim = dr * im + di * re + fr * pim + fi * pre
        return (torch.where(self.act, nre, re), torch.where(self.act, nim, im))


def _forward(tape, x, re, im, col):
    for g in range(tape[0].shape[1]):
        gate = _Gate(tape, g, x, col)
        re, im = gate.apply_u(re, im, _gate_coeffs(gate.k, gate.theta))
    return re, im


def _h_energy(re, im, hre_t, him_t):
    """(H psi planes, Rayleigh quotient per row); sums in float64."""
    hre = re @ hre_t - im @ him_t
    him = re @ him_t + im @ hre_t
    raw = (re.double() * hre.double() + im.double() * him.double()).sum(-1)
    n2 = (re.double() ** 2 + im.double() ** 2).sum(-1)
    return hre, him, (raw / n2).to(re.dtype)


def _backward(tape, x, re, im, lre, lim, col):
    """dx (E, S, R): adjoint sweep from the output state."""
    dx = torch.zeros_like(x)
    for g in reversed(range(tape[0].shape[1])):
        gate = _Gate(tape, g, x, col)
        u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i = _gate_coeffs(
            gate.k, gate.theta)
        sgn = (1 - 2 * gate.b).to(re.dtype)
        pre, pim = gate.xor(re), gate.xor(im)
        is_rx = (gate.k == _RX).to(re.dtype)
        is_ry = (gate.k == _RY).to(re.dtype)
        is_rz = (gate.k == _RZ).to(re.dtype)
        pr = is_rx * pre + is_ry * (sgn * pim) + is_rz * (sgn * re)
        pi = is_rx * pim - is_ry * (sgn * pre) + is_rz * (sgn * im)
        act = gate.act.to(re.dtype)
        cg = 0.5 * torch.sum(act * (pr * lim + pi * lre), dim=-1)  # (E, S)
        has = (gate.slot >= 0).view(-1, 1)
        idx = gate.slot.clamp(min=0).view(-1, 1, 1).expand(*cg.shape, 1)
        dx.scatter_add_(2, idx, torch.where(has, cg, 0.0)[..., None])
        ch = (u00r, -u00i, u10r, -u10i, u01r, -u01i, u11r, -u11i)  # U^H
        ct = (u00r, u00i, u10r, u10i, u01r, u01i, u11r, u11i)      # U^T
        re, im = gate.apply_u(re, im, ch)
        lre, lim = gate.apply_u(lre, lim, ct)
    return dx


def fused_adam_step_reference(old_arrs, new_arrs, map_idx, p0re, p0im,
                              hre_t, him_t, starts, active, *, iters: int,
                              lr: float):
    """Plain PyTorch version of the fused step (same arithmetic as the
    kernel, vectorized over envs and starts).  Any float dtype; the CPU
    parity path runs it in float64."""
    n_env, s_n, _ = starts.shape
    d = p0re.shape[-1]
    dev = starts.device
    col = torch.arange(d, device=dev).view(1, 1, d)
    old = tuple(a.long() for a in old_arrs)
    new = tuple(a.long() for a in new_arrs)
    re0 = p0re.reshape(1, 1, d).expand(n_env, s_n, d)
    im0 = p0im.reshape(1, 1, d).expand(n_env, s_n, d)
    x = starts.clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    bx = x.clone()
    be = torch.full((n_env, s_n), math.inf, dtype=x.dtype, device=dev)

    def track(x, bx, be):
        re, im = _forward(old, x, re0, im0, col)
        hre, him, ev = _h_energy(re, im, hre_t, him_t)
        better = ev < be
        return (re, im, hre, him, torch.where(better[..., None], x, bx),
                torch.where(better, ev, be))

    for it in range(iters):
        re, im, hre, him, bx, be = track(x, bx, be)
        dx = _backward(old, x, re, im, 2.0 * hre, -2.0 * him, col) * active
        m = B1 * m + (1 - B1) * dx
        v = B2 * v + (1 - B2) * dx * dx
        t = it + 1.0
        mhat = m / (1 - B1 ** t)
        vhat = v / (1 - B2 ** t)
        x = x - lr * mhat / (torch.sqrt(vhat) + EPS)
    _, _, _, _, bx, be = track(x, bx, be)

    best = torch.argmin(be, dim=1)
    x_opt = bx[torch.arange(n_env, device=dev), best]          # (E, R)
    mi = map_idx.long()
    x_new = torch.where(mi >= 0, x_opt.gather(1, mi.clamp(min=0)), 0.0)
    re, im = _forward(new, x_new[:, None, :], re0[:, :1], im0[:, :1], col)
    _, _, e_new = _h_energy(re, im, hre_t, him_t)
    return x_opt, e_new[:, 0]


N_PERTURBED = 4          # plain runs with the H planes rounded differently
COND_TOL = 1e-6          # x_opt entries the plain runs agree on
TOL_CONSISTENT = 1e-4    # e_new vs the float64 energy at its own x_opt


def _to64(args):
    return tuple(a if isinstance(a, tuple) or not a.is_floating_point()
                 else a.double() for a in args)


def plain_results(args, *, iters: int, lr: float):
    """Results of the fused step on ``args`` that the plain version gives
    within float32 rounding: in float32 (first, the centre), in float64,
    and in float32 with every entry of the H planes scaled by 1 + u 2^-23
    (u uniform in [-1, 1], N_PERTURBED draws), which stands in for
    the rounding of another summation order.  -> [(x_opt, e_new), ...]."""
    runs = [fused_adam_step_reference(*args, iters=iters, lr=lr),
            fused_adam_step_reference(*_to64(args), iters=iters, lr=lr)]
    gen = torch.Generator(device=args[5].device).manual_seed(0)
    for _ in range(N_PERTURBED):
        wobbled = list(args)
        for i in (5, 6):
            u = torch.rand(args[i].shape, generator=gen, dtype=args[i].dtype,
                           device=args[i].device) * 2 - 1
            wobbled[i] = args[i] * (1 + u * 2.0 ** -23)
        runs.append(fused_adam_step_reference(*wobbled, iters=iters, lr=lr))
    return runs


def agreement(args, ref, x_opt, e_new, *, tol: float, check_x: bool = True):
    """Per-env verdict on a float32 result (x_opt, e_new) of the fused step
    on ``args``, held against ``ref = plain_results(args, ...)``.

    Float32 rounding decides some outputs in any float32 implementation:
    an angle whose gradient is near zero takes a sign-of-noise first Adam
    step of about lr, and the rest of that start's trajectory follows it.
    The plain version's own runs in ``ref`` show where: they disagree
    there.  So an env agrees when
      - e_new is within ``tol`` of the plain float32 version, and so is
        x_opt (if ``check_x``) on the entries where all runs of ``ref``
        agree within COND_TOL; or
      - e_new and the float64 old-tape energy at x_opt both lie within
        ``tol`` of the range that the runs of ``ref`` span (inside the
        plain version's own float32 noise);
    and in both cases e_new is within TOL_CONSISTENT of the float64
    new-tape energy at its own remapped x_opt.

    Returns (ok (E,) bool, strict (E,) bool, stats dict).
    """
    args64 = _to64(args)

    def energy64(x, tape, mapping):
        # the plain version with iters = 0 evaluates its one start
        return fused_adam_step_reference(
            args64[0], tape, mapping, *args64[3:7],
            x.double()[:, None, :].contiguous(), args64[8], iters=0,
            lr=0.0)[1]

    xr, er = ref[0]
    xs = torch.stack([x.double() for x, _ in ref])            # (K, E, R)
    es = torch.stack([e.double() for _, e in ref])            # (K, E)
    determined = ((xs - xr.double()).abs() <= COND_TOL).all(dim=0)
    x_dev = torch.where(determined, (x_opt - xr).abs(), 0.0).amax(dim=1)
    e_dev = (e_new - er).abs()
    strict = (e_dev <= tol) & ((x_dev <= tol) | (not check_x))
    ident = torch.arange(x_opt.shape[1], dtype=torch.int32,
                         device=x_opt.device).expand_as(x_opt).contiguous()
    e_old = torch.stack([energy64(x, args64[0], ident) for x in xs])
    e_old_k = energy64(x_opt, args64[0], ident)
    e_k = e_new.double()
    in_noise = ((e_k >= es.amin(0) - tol) & (e_k <= es.amax(0) + tol)
                & (e_old_k >= e_old.amin(0) - tol)
                & (e_old_k <= e_old.amax(0) + tol))
    consistent = (energy64(x_opt, args64[1], args64[2])
                  - e_k).abs() <= TOL_CONSISTENT
    ok = (strict | in_noise) & consistent
    stats = {"e_new_max_abs_err": float(e_dev.max()),
             "x_opt_max_abs_err": float(x_dev.max()),
             "x_opt_noise_entries": int((~determined).sum()),
             "plain_e_new_spread": float((es.amax(0) - es.amin(0)).max()),
             "envs_within_tol": int(strict.sum()),
             "envs_in_plain_noise": int((~strict & in_noise).sum()),
             "envs_failing": int((~ok).sum())}
    return ok, strict, stats


# -- CUDA kernel -------------------------------------------------------------

_I32 = ctypes.c_int
_F32 = ctypes.c_float
_PTR = ctypes.c_void_p


@functools.cache
def _library():
    """The kernel's library (built at first use) with its C signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load

    lib = load("fused_adam_v1")
    lib.fused_adam_v1_launch.argtypes = (
        [_PTR] * 17 + [_I32] * 6 + [_F32] * 6 + [_PTR])
    lib.fused_adam_v1_launch.restype = _I32
    lib.fused_adam_v1_smem_bytes.argtypes = [_I32] * 4
    lib.fused_adam_v1_smem_bytes.restype = ctypes.c_size_t
    lib.fused_adam_v1_error_string.argtypes = [_I32]
    lib.fused_adam_v1_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(ints, floats, map_idx, p0re, hre_t, starts, active):
    dev = starts.device
    for t in (*ints, map_idx, *floats):
        if t.device != dev:
            raise ValueError("fused_adam_step: all tensors must be on "
                             f"{dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused_adam_step: tensors must be contiguous")
    if any(t.dtype != torch.int32 for t in (*ints, map_idx)):
        raise TypeError("fused_adam_step: tapes and map_idx must be int32")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("fused_adam_step: the CUDA kernel takes float32 "
                        "planes, starts and active")
    n_env, s_n, r = starts.shape
    g = ints[0].shape[-1]
    d = p0re.shape[-1]
    n = d.bit_length() - 1
    if d < 2 or d != 1 << n:
        raise ValueError(f"fused_adam_step: D = {d} is not a power of two")
    if hre_t.shape != (d, d) or p0re.numel() != d:
        raise ValueError("fused_adam_step: H^T planes must be (D, D) and "
                         "psi0 planes (1, D)")
    if any(t.shape != (n_env, g) for t in ints):
        raise ValueError("fused_adam_step: tapes must all be (E, G)")
    if map_idx.shape != (n_env, r) or active.shape != (n_env, 1, r):
        raise ValueError("fused_adam_step: map_idx must be (E, R) and "
                         "active (E, 1, R)")
    if s_n > MAX_STARTS:
        raise ValueError(f"fused_adam_step: S = {s_n} > {MAX_STARTS} starts")
    kinds = torch.stack([ints[0], ints[4]])
    tqs = torch.stack([ints[1], ints[5]])
    cqs = torch.stack([ints[2], ints[6]])
    slots = torch.stack([ints[3], ints[7]])
    bad = ((kinds < 0) | (kinds > _H)).any()
    bad |= ((tqs < 0) | (tqs >= n)).any()
    bad |= ((cqs < -1) | (cqs >= n) | (cqs == tqs)).any()
    bad |= ((slots < -1) | (slots >= r)).any()
    bad |= ((map_idx < -1) | (map_idx >= r)).any()
    if bool(bad):
        raise ValueError(
            "fused_adam_step: the CUDA kernel takes gate kinds NONE..H "
            f"(no RXX/RYY/RZZ), qubits in [0, {n}), control != target and "
            f"slots / map entries in [-1, {r})")
    return n_env, s_n, g, r, n


def fused_adam_step(old_arrs, new_arrs, map_idx, p0re, p0im, hre_t, him_t,
                    starts, active, *, iters: int, lr: float):
    """Fused env step: the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors.  See the module docstring for the
    layouts.  ``fused_adam_step.launches`` counts kernel launches."""
    if starts.device.type == "cpu":
        return fused_adam_step_reference(
            old_arrs, new_arrs, map_idx, p0re, p0im, hre_t, him_t, starts,
            active, iters=iters, lr=lr)
    if starts.device.type != "cuda":
        raise ValueError(f"fused_adam_step: no kernel for device "
                         f"{starts.device}")
    ints = (*old_arrs, *new_arrs)
    floats = (p0re, p0im, hre_t, him_t, starts, active)
    n_env, s_n, g, r, n = _check_inputs(ints, floats, map_idx, p0re, hre_t,
                                        starts, active)
    lib = _library()
    smem = lib.fused_adam_v1_smem_bytes(s_n, g, r, n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_adam_step: one env needs {smem} B of shared "
                         f"memory (> {MAX_SMEM_BYTES}); reduce starts or "
                         "qubits")
    x_opt = torch.empty((n_env, r), dtype=torch.float32, device=starts.device)
    e_new = torch.empty((n_env,), dtype=torch.float32, device=starts.device)
    stream = torch.cuda.current_stream(starts.device).cuda_stream
    rc = lib.fused_adam_v1_launch(
        *(t.data_ptr() for t in ints), map_idx.data_ptr(),
        *(t.data_ptr() for t in floats), x_opt.data_ptr(), e_new.data_ptr(),
        n_env, s_n, g, r, n, int(iters), float(lr), B1, B2, 1.0 - B1,
        1.0 - B2, EPS, stream)
    if rc != 0:
        msg = lib.fused_adam_v1_error_string(rc).decode()
        raise RuntimeError(f"fused_adam_v1 launch failed: CUDA error {rc} "
                           f"({msg})")
    fused_adam_step.launches += 1
    return x_opt, e_new


fused_adam_step.launches = 0
