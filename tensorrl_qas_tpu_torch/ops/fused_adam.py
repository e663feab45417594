"""One env step of multi-start Adam angle optimization, fused.

Counterpart of ``tensorrl_qas_tpu/ops/pallas_opt.py`` (the v1 kernel).
For each env e of a batch, with S optimizer starts:

    for it in range(iters):                     # Adam over the OLD tape
        psi  = tape_old(x) psi0                 # (S, D)
        Hpsi = sum_f W_f * psi[i ^ f]           # flip-group planes
        E    = Re<psi|H psi> / <psi|psi>        # best-iterate tracking
        dx   = adjoint sweep, lambda = 2 conj(H psi), masked by `active`
        x    = adam(x, dx)
    final re-check; x_opt = best start; x_new = x_opt[map] (map -1 -> 0)
    e_new = E(tape_new, x_new)

``fused_adam_step`` launches the CUDA kernel ``csrc/fused_adam_v1.cu`` on
CUDA tensors and runs ``fused_adam_step_reference``, the plain PyTorch
version of the same arithmetic, on CPU tensors.  Layouts: tapes (E, G)
int32, map_idx (E, R) int32, p0re/p0im (1, D) shared by the envs or (E,
D) one per env, wre/wim (G_f, D) flip-group planes of H and flips (G_f,)
int32 (``ops/fused_adam2d.py:pauli_flip_groups``; the v2 kernel takes the
same operands), starts (E, S, R), active (E, 1, R); returns x_opt (E, R)
and e_new (E,).  G (tape capacity) and R (angle capacity) are
independent: tapes that embed a warm-start circuit carry more gates than
angles.  The JAX v1 kernel takes dense (D, D) planes of H^T instead; the
plain step itself (``fused_step_plain``) takes any H operator, so the CPU
tests hold it with ``dense_h`` against that kernel.

``noise=(p1, p2)`` with ``seeds`` (E, 2) int32 is the depolarizing-
trajectory variant (the JAX kernel's ``noise=``): after every gate of the
forward sweeps the error Paulis of ``sim/noise.py:depolarizing_draw`` fire,
a fresh realization per Adam iteration (tag ``it``), for the final
re-check (``iters``) and for e_new (``iters + 1``), shared by an env's
starts; the adjoint sweep undoes them on psi and applies their transposes
to the cotangent before each gate's own adjoint step
(``pallas_opt.py:188-191``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.sim.noise import (
    apply_pauli,
    depolarizing_draw,
    noise_thresholds,
    philox_words,
)

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_CX, _X, _Y = int(GateKind.CX), int(GateKind.X), int(GateKind.Y)
_Z, _H = int(GateKind.Z), int(GateKind.H)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_SMEM_BYTES = 232448  # H100: shared memory one block may use
MAX_QUBITS = 9           # the v1 kernel's largest qubit count
DEFAULT_REG_BITS = 3     # register bits of a kernel thread up to 8 qubits


# -- plain PyTorch version -------------------------------------------------

def _coeff_basis(kind, dtype):
    """(A, B, C), each (8, E, 1, G): the (re, im) parts of the 2x2 unitary
    entries (u00, u01, u10, u11) of every gate are A cos(theta/2) +
    B sin(theta/2) + C.  Kinds beyond H (RXX/RYY/RZZ) are not taken."""
    r2 = _INV_SQRT2
    rows = {                      # kind -> {part: (a, b, c)}
        0: {0: (0, 0, 1), 6: (0, 0, 1)},                 # NONE: identity
        _RX: {0: (1, 0, 0), 3: (0, -1, 0), 5: (0, -1, 0), 6: (1, 0, 0)},
        _RY: {0: (1, 0, 0), 2: (0, -1, 0), 4: (0, 1, 0), 6: (1, 0, 0)},
        _RZ: {0: (1, 0, 0), 1: (0, -1, 0), 6: (1, 0, 0), 7: (0, 1, 0)},
        _CX: {2: (0, 0, 1), 4: (0, 0, 1)},
        _X: {2: (0, 0, 1), 4: (0, 0, 1)},
        _Y: {3: (0, 0, -1), 5: (0, 0, 1)},
        _Z: {0: (0, 0, 1), 6: (0, 0, -1)},
        _H: {0: (0, 0, r2), 2: (0, 0, r2), 4: (0, 0, r2), 6: (0, 0, -r2)},
    }
    table = np.zeros((_H + 1, 3, 8))
    for k, parts in rows.items():
        for part, abc in parts.items():
            table[k, :, part] = abc
    table = torch.as_tensor(table, dtype=dtype, device=kind.device)
    basis = table[kind]                                  # (E, G, 3, 8)
    return basis.permute(2, 3, 0, 1)[:, :, :, None, :].unbind(0)


def check_gate_kinds(*kinds):
    """Reject the gate kinds the fused step does not take: RXX/RYY/RZZ
    (the su4 gate set), which run in the composed engine
    (``AngleOptimizer`` with ``enable_2q``, kernels ``ops/apply_tape.py``)
    as in the JAX package."""
    for k in kinds:
        k = torch.as_tensor(k)
        if bool(((k < 0) | (k > _H)).any()):
            raise ValueError(
                "the fused Adam step takes gate kinds NONE..H only; "
                "RXX/RYY/RZZ (the su4 gate set) run in the composed engine "
                "(AngleOptimizer(enable_2q=True))")


class _Plan:
    """The part of a batch of tapes that does not depend on the angles,
    built once per call: per gate the partner gather index, target-bit and
    control masks, the generator selectors and the coefficient basis.
    The index and masks are (E, G, D): 3.9 GB of int64 and bool at 20
    qubits, E = 8, G = 46 (made once a call, so that a gate takes views
    of them: the plain version's time is mostly the host's cost of its
    many small operations)."""

    def __init__(self, tape, s_n, col, dtype):
        kind, tq, cq, slot = tape                        # (E, G) int64
        e_n = kind.shape[0]
        d = col.shape[-1]
        t = tq[..., None]                                # (E, G, 1)
        c = cq[..., None]
        colg = col.view(1, 1, d)
        self.shape = (e_n, s_n, d)
        # positions where every tape holds NONE are exact identities
        self.live = (kind != 0).any(dim=0).nonzero().flatten().tolist()
        self.slot = slot
        self.has_slot = slot >= 0                        # (E, G)
        self.slot_idx = slot.clamp(min=0)
        self.partner = colg ^ (1 << t)                   # (E, G, D)
        self.b0 = ((colg >> t) & 1) == 0
        self.act = torch.where(c >= 0, ((colg >> c.clamp(min=0)) & 1) == 1,
                               True)
        self.sel = [(kind == k).to(dtype)[:, None, :] for k in (_RX, _RY,
                                                                 _RZ)]
        self.basis = _coeff_basis(kind, dtype)           # 3 x (8, E, 1, G)

    def coeffs(self, x):
        """(8, E, S, G) unitary parts of every gate at angles x (E, S, R)."""
        e_n, s_n, _ = x.shape
        sidx = self.slot.clamp(min=0)[:, None, :].expand(e_n, s_n, -1)
        theta = torch.where(self.slot[:, None, :] >= 0, x.gather(2, sidx),
                            0.0)
        a, b, c = self.basis
        return a * torch.cos(0.5 * theta) + b * torch.sin(0.5 * theta) + c

    def gate(self, g):
        """Partner index (E, S, D), target-bit-0 and control masks
        (E, 1, D) of tape position g."""
        return (self.partner[:, g, None, :].expand(self.shape),
                self.b0[:, g, None, :], self.act[:, g, None, :])


def _u_rows(u):
    """What ``_apply_u`` selects from, gate by gate: u (8, E, S, G) holds
    the (re, im) parts of (u00, u01, u10, u11); -> the rows where the
    target bit is 0 and where it is 1, each a list of G (6, E, S, 1)
    slices: the diagonal entry d and the partner's f (u00, u01 at bit 0;
    u11, u10 at bit 1) as (d_re, -d_im, f_re, -f_im, d_im, f_im)."""
    neg = -u
    return tuple(torch.stack([u[d], neg[d + 1], u[f], neg[f + 1], u[d + 1],
                              u[f + 1]]).split(1, dim=-1)
                 for d, f in ((0, 2), (6, 4)))


def _apply_u(re, im, pre, pim, b0, act, rows):
    """One (controlled) 2x2 combine on the re/im planes; pre/pim are the
    partner amplitudes, ``rows`` one gate's pair of ``_u_rows`` slices.
    The terms are added in the order
      re' = ((d_re re - d_im im) + f_re pre) - f_im pim,
      im' = ((d_re im + d_im re) + f_re pim) + f_im pre,
    a - b as a + (-b), as lists (``torch._foreach_*``: one launch a list
    on the card, where the plain version's time is mostly the host's cost
    of its launches): the same values, bit for bit, as one operation a
    term (tests/test_torch_plain_form.py)."""
    dr, ndi, fr, nfi, di, fi = torch.where(b0, *rows).unbind(0)
    t = torch._foreach_mul([dr, ndi, fr, nfi, dr, di, fr, fi],
                           [re, im, pre, pim, im, re, pim, pre])
    new = torch._foreach_add(t[0::4], t[1::4])
    torch._foreach_add_(new, t[2::4])
    torch._foreach_add_(new, t[3::4])
    return torch.where(act, new[0], re), torch.where(act, new[1], im)


def _noise_ops(arrs, seeds, tags, thresholds, draw):
    """The error Paulis of one tape at each tag: {tag: {g: ((kind (E,),
    qubit (E,)), ...)}}, listing only the tape positions where an error
    fires in some env (one host read for all tags)."""
    kind, tq, cq = arrs[0].long(), arrs[1].long(), arrs[2].long()
    draws = [depolarizing_draw(kind, seeds, t, thresholds, draw)
             for t in tags]
    kts = torch.stack([k for k, _ in draws])                   # (T, E, G)
    kcs = torch.stack([k for _, k in draws])
    fire = torch.stack([(kts != 0).any(1), (kcs != 0).any(1)]).cpu().numpy()
    qubits = (tq, cq.clamp(min=0))
    ops = {}
    for i, tag in enumerate(tags):
        ops[tag] = {
            int(g): tuple((ks[i, :, g], q[:, g]) for ks, q, f
                          in zip((kts, kcs), qubits, fire[:, i, g]) if f)
            for g in np.nonzero(fire[:, i].any(0))[0]}
    return ops


def _forward(plan, u, re, im, errors=None):
    """psi <- tape(x) psi; u = plan.coeffs(x); ``errors`` the error Paulis
    after each gate ({g: ((kind, qubit), ...)}, see ``_noise_ops``)."""
    errors = errors or {}
    rows = _u_rows(u)
    for g in plan.live:
        idx, b0, act = plan.gate(g)
        re, im = _apply_u(re, im, re.gather(2, idx), im.gather(2, idx), b0,
                          act, (rows[0][g], rows[1][g]))
        for k, q in errors.get(g, ()):
            re, im = apply_pauli(re, im, k[:, None], q[:, None])
    return re, im


def dense_h(hre_t, him_t):
    """H psi through dense (D, D) planes of H^T."""
    def apply(re, im):
        return re @ hre_t - im @ him_t, re @ him_t + im @ hre_t
    return apply


# amplitudes of the largest gathered block of flip_h (64 MB in float32)
FLIP_BLOCK = 1 << 24


def flip_h(wre, wim, flips):
    """H psi through flip-group planes, summed in group order (the order
    both kernels follow; float32 rounding decides some trajectories, so
    the plain version keeps it): the partners psi[i ^ f] of a block of
    groups gathered at once (at most FLIP_BLOCK amplitudes), then each
    group's product added; the imaginary planes enter only where one is
    not zero (a real H: none, as the kernels skip them; adding its zero
    products changed no value).  Four operations a group of a real H,
    where a gather a group took ten: the plain version's time is mostly
    the host's cost of its operations."""
    d = wre.shape[-1]
    col = torch.arange(d, device=wre.device)
    perm = col[None, :] ^ flips.to(col.dtype)[:, None]      # (G_f, D)
    real = not bool((wim != 0).any())

    def apply(re, im):
        lead = re.shape[:-1]
        block = max(1, FLIP_BLOCK // max(1, re[..., 0].numel() * d))
        hre = torch.zeros_like(re)
        him = torch.zeros_like(im)
        for g0 in range(0, perm.shape[0], block):
            idx = perm[g0:g0 + block].reshape(-1)
            pres = re.index_select(-1, idx).view(*lead, -1, d)
            pims = im.index_select(-1, idx).view(*lead, -1, d)
            for j in range(pres.shape[-2]):
                wr, pre, pim = wre[g0 + j], pres[..., j, :], pims[..., j, :]
                if real:
                    hre = hre + wr * pre
                    him = him + wr * pim
                else:
                    wi = wim[g0 + j]
                    hre = hre + wr * pre - wi * pim
                    him = him + wr * pim + wi * pre
        return hre, him
    return apply


def _h_energy(re, im, h_apply):
    """(H psi planes, Rayleigh quotient per row); sums in float64."""
    hre, him = h_apply(re, im)
    raw = (re.double() * hre.double() + im.double() * him.double()).sum(-1)
    n2 = (re.double() ** 2 + im.double() ** 2).sum(-1)
    return hre, him, (raw / n2).to(re.dtype)


def _backward(plan, u, x, re, im, lre, lim, errors=None):
    """dx (E, S, R): adjoint sweep from the output state; each gate's error
    Paulis are undone on psi (P^H = P) and carried back on the cotangent
    (P^T) first."""
    errors = errors or {}
    dx = torch.zeros_like(x)
    sel = plan.sel
    # every gate's entries of U^H (conjugated u00, u10, u01, u11) and of U^T
    ut = u[[0, 1, 4, 5, 2, 3, 6, 7]]
    rows_h = _u_rows(ut * torch.tensor([1.0, -1.0] * 4, dtype=u.dtype,
                                       device=u.device).view(8, 1, 1, 1))
    rows_t = _u_rows(ut)
    for g in reversed(plan.live):
        for k, q in errors.get(g, ()):
            re, im = apply_pauli(re, im, k[:, None], q[:, None])
            lre, lim = apply_pauli(lre, lim, k[:, None], q[:, None],
                                   transpose=True)
        idx, b0, act = plan.gate(g)
        sgn = torch.where(b0, 1.0, -1.0).to(re.dtype)
        pre, pim = re.gather(2, idx), im.gather(2, idx)
        rx, ry, rz = (k[..., g:g + 1] for k in sel)
        pr = rx * pre + ry * (sgn * pim) + rz * (sgn * re)
        pi = rx * pim - ry * (sgn * pre) + rz * (sgn * im)
        cg = 0.5 * torch.sum(act.to(re.dtype) * (pr * lim + pi * lre),
                             dim=-1)                             # (E, S)
        has = plan.has_slot[:, g, None]
        sidx = plan.slot_idx[:, g, None, None].expand(*cg.shape, 1)
        dx.scatter_add_(2, sidx, torch.where(has, cg, 0.0)[..., None])
        re, im = _apply_u(re, im, pre, pim, b0, act,
                          (rows_h[0][g], rows_h[1][g]))            # U^H
        lre, lim = _apply_u(lre, lim, lre.gather(2, idx), lim.gather(2, idx),
                            b0, act, (rows_t[0][g], rows_t[1][g]))  # U^T
    return dx


def fused_step_plain(old_arrs, new_arrs, map_idx, p0re, p0im, h_apply,
                     starts, active, *, iters: int, lr: float, noise=None,
                     seeds=None, draw=None, enew_tag=None):
    """The fused step in plain PyTorch for any H operator
    ``h_apply(re, im) -> (H psi re, H psi im)`` on (E, S, D) planes: the
    arithmetic of both kernels (which take ``flip_h``), vectorized over
    envs and starts.  Any float dtype; the CPU parity path runs it in
    float64.

    ``noise=(p1, p2)`` and ``seeds`` (E, 2) draw the depolarizing errors
    of ``sim/noise.py:depolarizing_draw`` (module docstring); ``draw``
    replaces its Philox words (default ``philox_words``), ``enew_tag`` the
    tag of e_new's realization (default ``iters + 1``)."""
    check_gate_kinds(old_arrs[0], new_arrs[0])
    n_env, s_n, _ = starts.shape
    d = p0re.shape[-1]
    dev = starts.device
    col = torch.arange(d, device=dev)
    old = _Plan(tuple(a.long() for a in old_arrs), s_n, col, starts.dtype)
    new = _Plan(tuple(a.long() for a in new_arrs), 1, col, starts.dtype)
    # (1, D) planes broadcast over the envs, (E, D) planes are per env
    re0 = p0re.reshape(-1, 1, d).expand(n_env, s_n, d)
    im0 = p0im.reshape(-1, 1, d).expand(n_env, s_n, d)
    x = starts.clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    bx = x.clone()
    be = torch.full((n_env, s_n), math.inf, dtype=x.dtype, device=dev)
    enew_tag = iters + 1 if enew_tag is None else enew_tag
    err_old, err_new = {}, {}
    if noise is not None:
        thresholds = noise_thresholds(*noise)
        draw = draw or philox_words
        err_old = _noise_ops(old_arrs, seeds, range(iters + 1), thresholds,
                             draw)
        err_new = _noise_ops(new_arrs, seeds, (enew_tag,), thresholds, draw)

    def track(x, bx, be, tag):
        u = old.coeffs(x)
        re, im = _forward(old, u, re0, im0, err_old.get(tag))
        hre, him, ev = _h_energy(re, im, h_apply)
        better = ev < be
        return (u, re, im, hre, him, torch.where(better[..., None], x, bx),
                torch.where(better, ev, be))

    for it in range(iters):
        u, re, im, hre, him, bx, be = track(x, bx, be, it)
        dx = _backward(old, u, x, re, im, 2.0 * hre, -2.0 * him,
                       err_old.get(it)) * active
        m = B1 * m + (1 - B1) * dx
        v = B2 * v + (1 - B2) * dx * dx
        t = it + 1.0
        mhat = m / (1 - B1 ** t)
        vhat = v / (1 - B2 ** t)
        x = x - lr * mhat / (torch.sqrt(vhat) + EPS)
    *_, bx, be = track(x, bx, be, iters)

    best = torch.argmin(be, dim=1)
    x_opt = bx[torch.arange(n_env, device=dev), best]          # (E, R)
    mi = map_idx.long()
    x_new = torch.where(mi >= 0, x_opt.gather(1, mi.clamp(min=0)), 0.0)
    re, im = _forward(new, new.coeffs(x_new[:, None, :]), re0[:, :1],
                      im0[:, :1], err_new.get(enew_tag))
    _, _, e_new = _h_energy(re, im, h_apply)
    return x_opt, e_new[:, 0]


def fused_adam_step_reference(old_arrs, new_arrs, map_idx, p0re, p0im,
                              wre, wim, flips, starts, active, *,
                              iters: int, lr: float, **noise):
    """Plain PyTorch version of both kernels (flip-group planes);
    ``noise``: the noise keywords of ``fused_step_plain``."""
    return fused_step_plain(old_arrs, new_arrs, map_idx, p0re, p0im,
                            flip_h(wre, wim, flips), starts, active,
                            iters=iters, lr=lr, **noise)


N_PERTURBED = 4          # plain runs with the H planes rounded differently
COND_TOL = 1e-6          # x_opt entries the plain runs agree on
TOL_CONSISTENT = 1e-4    # e_new vs the float64 energy at its own x_opt


def _to64(args):
    return tuple(a if isinstance(a, tuple) or not a.is_floating_point()
                 else a.double() for a in args)


def plain_results(args, *, iters: int, lr: float,
                  step=fused_adam_step_reference, **noise):
    """Results of the fused step on ``args`` that the plain version
    ``step`` gives within float32 rounding: in float32 (first, the
    centre), in float64, and in float32 with every entry of the H planes
    (``args[5]`` and ``args[6]``: the flip-group planes of both kernels,
    the dense ones of the composed engine's two-operand form) scaled by
    1 + u 2^-23 (u uniform in [-1, 1], N_PERTURBED draws), which stands in
    for the rounding of another summation order.  ``noise``: the noise
    keywords of ``fused_step_plain`` (every run draws the same errors).
    -> [(x_opt, e_new), ...]."""
    runs = [step(*args, iters=iters, lr=lr, **noise),
            step(*_to64(args), iters=iters, lr=lr, **noise)]
    gen = torch.Generator(device=args[5].device).manual_seed(0)
    for _ in range(N_PERTURBED):
        wobbled = list(args)
        for i in (5, 6):
            u = torch.rand(args[i].shape, generator=gen, dtype=args[i].dtype,
                           device=args[i].device) * 2 - 1
            wobbled[i] = args[i] * (1 + u * 2.0 ** -23)
        runs.append(step(*wobbled, iters=iters, lr=lr, **noise))
    return runs


def agreement(args, ref, x_opt, e_new, *, tol: float, check_x: bool = True,
              step=fused_adam_step_reference, iters: int | None = None,
              cache: dict | None = None, **noise):
    """Per-env verdict on a float32 result (x_opt, e_new) of the fused step
    on ``args``, held against ``ref = plain_results(args, ..., step=step)``.

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

    With ``noise`` (the noise keywords ``ref`` was computed with: the fused
    steps' ``noise`` and ``seeds``, or the composed engine's ``seed``,
    ``optim/angle_opt.py:composed_step``), every float64 energy is taken
    under e_new's realization (tag ``iters + 1``: ``iters`` is then
    required).

    ``cache``: a dict kept across calls on the same ``args`` and ``ref``
    (a result and its controls), which then take the float64 energies of
    ``ref``'s runs from the first.

    Returns (ok (E,) bool, strict (E,) bool, stats dict).
    """
    args64 = _to64(args)
    if noise.get("noise") is not None or noise.get("seed") is not None:
        if iters is None:
            raise ValueError("agreement: a noisy check needs iters")
        noise = dict(noise, enew_tag=iters + 1)

    def energy64(x, tape, mapping):
        # the plain version with iters = 0 evaluates its one start
        return step(args64[0], tape, mapping, *args64[3:-2],
                    x.double()[:, None, :].contiguous(), args64[-1], iters=0,
                    lr=0.0, **noise)[1]

    xr, er = ref[0]
    xs = torch.stack([x.double() for x, _ in ref])            # (K, E, R)
    es = torch.stack([e.double() for _, e in ref])            # (K, E)
    determined = ((xs - xr.double()).abs() <= COND_TOL).all(dim=0)
    x_dev = torch.where(determined, (x_opt - xr).abs(), 0.0).amax(dim=1)
    e_dev = (e_new - er).abs()
    strict = (e_dev <= tol) & ((x_dev <= tol) | (not check_x))
    ident = torch.arange(x_opt.shape[1], dtype=torch.int32,
                         device=x_opt.device).expand_as(x_opt).contiguous()
    e_old = None if cache is None else cache.get("e_old")
    if e_old is None:
        e_old = torch.stack([energy64(x, args64[0], ident) for x in xs])
        if cache is not None:
            cache["e_old"] = e_old
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
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
_F64 = ctypes.c_double
_PTR = ctypes.c_void_p


@functools.cache
def _library():
    """The kernel's library (built at first use) with its C signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load

    return bind(load("fused_adam_v1"))


def bind(lib):
    """Set the C signatures of the v1 kernel's library ``lib``."""
    lib.fused_adam_v1_launch.argtypes = (
        [_PTR] * 20 + [_I32] * 11 + [_F32, _F64, _F64]
        + [_F32] * 3 + [_U32] * 2 + [_PTR])
    lib.fused_adam_v1_launch.restype = _I32
    lib.fused_adam_v1_smem_bytes.argtypes = [_I32] * 9
    lib.fused_adam_v1_smem_bytes.restype = ctypes.c_size_t
    lib.fused_adam_v1_error_string.argtypes = [_I32]
    lib.fused_adam_v1_error_string.restype = ctypes.c_char_p
    return lib


def check_step_inputs(name, ints, map_idx, floats, starts, active):
    """The input checks both CUDA kernels share: one device, contiguous,
    int32 tapes and map, float32 ``floats`` (p0re, p0im, the H planes,
    starts, active), psi0 planes (1, D) or (E, D), D a power of two,
    (E, G) tapes, the gate kinds, and qubits, slots and map entries in
    range.  ``ints`` are the old tape's four arrays, then the new tape's.
    -> (E, S, G, R, n)."""
    dev = starts.device
    for t in (*ints, map_idx, *floats):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.dtype != torch.int32 for t in (*ints, map_idx)):
        raise TypeError(f"{name}: tapes and map_idx must be int32")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: the CUDA kernel takes float32 planes, "
                        "starts and active")
    n_env, s_n, r = starts.shape
    g = ints[0].shape[-1]
    p0re, p0im = floats[:2]
    d = p0re.shape[-1]
    n = d.bit_length() - 1
    if (d < 2 or d != 1 << n or p0re.dim() != 2
            or p0re.shape[0] not in (1, n_env) or p0im.shape != p0re.shape):
        raise ValueError(f"{name}: psi0 planes must be (1, D) or (E, D), "
                         "D a power of two")
    if any(t.shape != (n_env, g) for t in ints):
        raise ValueError(f"{name}: tapes must all be (E, G)")
    if map_idx.shape != (n_env, r) or active.shape != (n_env, 1, r):
        raise ValueError(f"{name}: map_idx must be (E, R) and active "
                         "(E, 1, R)")
    check_gate_kinds(ints[0], ints[4])
    tqs = torch.stack([ints[1], ints[5]])
    cqs = torch.stack([ints[2], ints[6]])
    slots = torch.stack([ints[3], ints[7]])
    bad = ((tqs < 0) | (tqs >= n)).any()
    bad |= ((cqs < -1) | (cqs >= n) | (cqs == tqs)).any()
    bad |= ((slots < -1) | (slots >= r)).any()
    bad |= ((map_idx < -1) | (map_idx >= r)).any()
    if bool(bad):
        raise ValueError(
            f"{name}: qubits must lie in [0, {n}), control != target, "
            f"slots and map entries in [-1, {r})")
    return n_env, s_n, g, r, n


def noise_args(name, noise, seeds, n_env, dev):
    """(seeds pointer or None, threshold 1, threshold 2) for a kernel
    launch; checks ``seeds`` (E, 2) int32 on ``dev`` when ``noise`` is
    given."""
    if noise is None:
        return None, 0, 0
    if (seeds is None or seeds.device != dev or seeds.dtype != torch.int32
            or seeds.shape != (n_env, 2) or not seeds.is_contiguous()):
        raise ValueError(f"{name}: noise needs seeds, a contiguous (E, 2) "
                         f"int32 tensor on {dev}")
    if not all(0.0 <= p <= 1.0 for p in noise):
        raise ValueError(f"{name}: noise probabilities must lie in [0, 1]")
    return (seeds.data_ptr(), *noise_thresholds(*noise))


def check_smem(name, smem, per):
    """Refuse a launch whose CTA needs more shared memory than one block
    may use."""
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: one {per} needs {smem} B of shared "
                         f"memory (> {MAX_SMEM_BYTES})")


def psi0_stride(p0re) -> int:
    """Floats between two envs' psi0 rows: 0 for a (1, D) plane shared by
    the envs, D for (E, D) planes (at E = 1 the two coincide and the
    launch counts as shared)."""
    return 0 if p0re.shape[0] == 1 else p0re.shape[-1]


def launch(lib, kernel, *args):
    """Call ``<kernel>_launch`` of ``lib``; raise on a CUDA error."""
    rc = getattr(lib, f"{kernel}_launch")(*args)
    if rc != 0:
        msg = getattr(lib, f"{kernel}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({msg})")


def check_flip_inputs(name, ints, floats, map_idx, flips, starts, active,
                      qubits):
    """A kernel's own checks (``qubits`` = (least, most) qubit count, the
    flip-group planes ``floats[2:4]`` and ``flips``) before those both
    kernels share (``check_step_inputs``).  -> (E, S, G, R, n, G_f)."""
    p0re, _, wre, wim = floats[:4]
    d = p0re.shape[-1]
    n = d.bit_length() - 1
    if d != 1 << n or not qubits[0] <= n <= qubits[1]:
        raise ValueError(f"{name}: D = {d} is not 2^n for "
                         f"{qubits[0]} <= n <= {qubits[1]}")
    if flips.device != starts.device or not flips.is_contiguous():
        raise ValueError(f"{name}: flips must be contiguous, on "
                         f"{starts.device}")
    if flips.dtype != torch.int32:
        raise TypeError(f"{name}: flips must be int32")
    n_groups = flips.numel()
    if wre.shape != (n_groups, d) or wim.shape != (n_groups, d):
        raise ValueError(f"{name}: W planes must be (G_f, D) and flips "
                         "(G_f,)")
    dims = check_step_inputs(name, ints, map_idx, floats, starts, active)
    if bool(((flips < 0) | (flips >= d)).any()):
        raise ValueError(f"{name}: flips must lie in [0, {d})")
    return (*dims, n_groups)


def group_layout(n: int, n_starts: int, reg_bits: int = 0):
    """How the kernel's CTA holds an env's starts (twin of the kernel's
    ``make_dims``): each start is a group of 2^lanes threads holding
    2^rb amplitudes each, the low ``lanes`` logical qubits on the lane
    bits and the others on the register bits; ``groups`` groups a CTA
    (at most 256 threads) take the starts in ``rounds``.  ``reg_bits`` 0
    picks rb = 4 at 9 qubits (a group must stay within one warp) and
    DEFAULT_REG_BITS below.
    -> (rb, lanes, threads per group, groups, rounds)."""
    rb = reg_bits or (4 if n > 8 else DEFAULT_REG_BITS)
    if rb not in (3, 4) or n - rb > 5:
        raise ValueError(f"fused_adam_step: {1 << rb} amplitudes a thread "
                         f"cannot hold {n} qubits in one warp a start")
    lanes = max(n - rb, 0)
    cap = 256 >> lanes
    rounds = -(-n_starts // cap)
    return rb, lanes, 1 << lanes, -(-n_starts // rounds), rounds


def _check_inputs(ints, floats, map_idx, flips, starts, active):
    """-> (E, S, G, R, n, G_f); 1 <= n <= 9."""
    return check_flip_inputs("fused_adam_step", ints, floats, map_idx,
                             flips, starts, active, (1, MAX_QUBITS))


def fused_adam_step(old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim,
                    flips, starts, active, *, iters: int, lr: float,
                    noise=None, seeds=None):
    """Fused env step: the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors.  See the module docstring for the
    layouts and ``noise`` / ``seeds``.  ``fused_adam_step.launches``
    counts kernel launches, ``fused_adam_step.noise_launches`` those of
    the noise variant and ``fused_adam_step.psi0_launches`` those with
    per-env psi0 planes among them."""
    if starts.device.type == "cpu":
        return fused_adam_step_reference(
            old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim, flips,
            starts, active, iters=iters, lr=lr, noise=noise, seeds=seeds)
    if starts.device.type != "cuda":
        raise ValueError(f"fused_adam_step: no kernel for device "
                         f"{starts.device}")
    stride, x_opt, e_new = run_kernel(
        _library(), old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim, flips,
        starts, active, iters=iters, lr=lr, noise=noise, seeds=seeds,
        stream=torch.cuda.current_stream(starts.device).cuda_stream)
    fused_adam_step.launches += 1
    fused_adam_step.noise_launches += noise is not None
    fused_adam_step.psi0_launches += stride != 0
    return x_opt, e_new


def run_kernel(lib, old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim,
               flips, starts, active, *, iters, lr, noise, seeds, stream,
               reg_bits=0, w_smem=None):
    """Check the inputs and launch the v1 kernel of ``lib`` (bound by
    ``bind``) on ``stream``, uncounted (tests and measurements call it
    directly); ``reg_bits`` (3 or 4) sets the amplitudes a thread holds,
    2^reg_bits (0: ``group_layout``'s choice); ``w_smem`` None reads the W
    planes into shared memory where they fit.
    -> (psi0 stride, x_opt, e_new)."""
    name = "fused_adam_step"
    ints = (*old_arrs, *new_arrs)
    floats = (p0re, p0im, wre, wim, starts, active)
    n_env, s_n, g, r, n, n_groups = _check_inputs(ints, floats, map_idx,
                                                  flips, starts, active)
    dev = starts.device
    seeds_ptr, thr1, thr2 = noise_args(name, noise, seeds, n_env, dev)
    # the groups whose imaginary plane is not zero (none for a real H),
    # numbered: the kernel keeps and reads only those planes
    cplx = (wim != 0).any(dim=1)
    wim_at = torch.where(cplx, torch.cumsum(cplx.int(), 0) - 1,
                         -1).to(torch.int32)
    n_cplx = int(cplx.sum())
    rb = group_layout(n, s_n, reg_bits)[0]
    sizes = [lib.fused_adam_v1_smem_bytes(s_n, g, r, n, n_groups, n_cplx,
                                          noise is not None, rb, w)
             for w in (0, 1)]
    if w_smem is None:
        w_smem = sizes[1] <= MAX_SMEM_BYTES
    check_smem(name, sizes[w_smem], "env")
    x_opt = torch.empty((n_env, r), dtype=torch.float32, device=dev)
    e_new = torch.empty((n_env,), dtype=torch.float32, device=dev)
    stride = psi0_stride(p0re)
    launch(lib, "fused_adam_v1",
           *(t.data_ptr() for t in ints), map_idx.data_ptr(),
           p0re.data_ptr(), p0im.data_ptr(), wre.data_ptr(), wim.data_ptr(),
           flips.data_ptr(), wim_at.data_ptr(), starts.data_ptr(),
           active.data_ptr(), seeds_ptr, x_opt.data_ptr(), e_new.data_ptr(),
           n_env, s_n, g, r, n, n_groups, n_cplx, rb, int(w_smem),
           stride, int(iters), float(lr), B1, B2, 1.0 - B1, 1.0 - B2, EPS,
           thr1, thr2, stream)
    return stride, x_opt, e_new


fused_adam_step.launches = 0
fused_adam_step.noise_launches = 0
fused_adam_step.psi0_launches = 0
