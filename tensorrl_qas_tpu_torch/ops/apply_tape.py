"""Each env's own gate tape applied to its block of states, forward and
adjoint: the composed engine's two kernels.

Counterpart of ``tensorrl_qas_tpu/ops/pallas_apply.py``.  Env e applies
its tape (row e of kind / tq / cq / slot, (E, G) int32) to its (S, D)
block of float re / im planes, with an angle vector per row (angles
(E, S, R)):

    psi[e, s] <- tape_e(angles[e, s]) psi[e, s]

over every gate kind of ``circuits/tape.py``: the 1-qubit gates (RX, RY,
RZ, X, Y, Z, H; controlled when cq >= 0), CX, and the su4 gate set's
two-qubit Pauli rotations RXX / RYY / RZZ, for which cq is the SECOND
QUBIT of the rotation, not a control.  A gate reads angles[..., slot] when
slot >= 0, angle 0 otherwise.

The adjoint pass (``custom_vjp`` of the JAX function
``apply_tape_pallas_ri``) starts from the forward OUTPUT planes and the
real-plane cotangents (gre, gim).  The complex cotangent is lambda =
gre - i gim (d theta = Re[(d psi / d theta)^T lambda]); each gate, last
first, adds 1/2 Im[(P psi)^T lambda] to dang[e, s, slot] (P its generator,
psi the state after it; skipped for slot < 0), is undone on psi (U^H) and
carries lambda back (U^T).  It returns the psi0 cotangents in the same
real-plane convention, (Re lambda, -Im lambda), and dang.

``apply_tape_fwd`` / ``apply_tape_bwd`` launch the CUDA kernels of
``csrc/apply_tape.cu`` on CUDA tensors (float32) and run
``apply_tape_fwd_plain`` / ``apply_tape_bwd_plain``, the plain PyTorch
versions of the same arithmetic, on CPU tensors; ``ApplyTape`` is the
``torch.autograd.Function`` over the two, which saves the output planes,
not one state per gate.  Each wrapper counts its launches (``launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops.fused_adam import (
    _coeff_basis,
    check_smem,
    launch,
)

_RX, _RY, _RZ = int(GateKind.RX), int(GateKind.RY), int(GateKind.RZ)
_RXX, _RYY, _RZZ = int(GateKind.RXX), int(GateKind.RYY), int(GateKind.RZZ)

MAX_QUBITS = 16          # the JAX composed path's ceiling (D <= 65536)


# -- plain PyTorch version ---------------------------------------------------

class _Gate:
    """Gate position g of a batch of tapes at angles (E, S, R), as
    psi'[i] = d[i] psi[i] + f[i] psi[p[i]] where ``act`` (a controlled
    1-qubit gate's control bit), and its generator as
    (P psi)[i] = gd[i] psi[i] + gf[i] psi[p[i]].  Complex coefficients are
    (re, im) pairs of (E, S, D) or (E, 1, D) tensors."""

    def __init__(self, tape, g, angles, col):
        kind, tq, cq, slot = (a[:, g].long().view(-1, 1, 1) for a in tape)
        self.slot = slot.view(-1)
        self.has_grad = ((kind >= _RX) & (kind <= _RZ)) | (kind >= _RXX)
        s = slot.clamp(min=0).expand(-1, angles.shape[1], 1)
        theta = torch.where(slot >= 0, angles.gather(2, s), 0.0)
        cos, sin = torch.cos(0.5 * theta), torch.sin(0.5 * theta)
        two_q = kind >= _RXX
        c2 = cq.clamp(min=0)
        bt = (col >> tq) & 1
        bc = (col >> c2) & 1
        b0 = bt == 0
        self.partner = col ^ (1 << tq) ^ torch.where(
            two_q & (kind != _RZZ), 1 << c2, 0)
        self.act = two_q | (cq < 0) | (bc == 1)
        one, zero = torch.ones_like(theta), torch.zeros_like(theta)
        sgn = (1 - 2 * bt).to(theta.dtype)            # (-1)^(bit t)
        z = (1 - 2 * (bt ^ bc)).to(theta.dtype)       # ZZ eigenvalue
        # 1-qubit kinds: the 2x2 unitary's entries (kinds beyond H get the
        # identity's, and are overwritten below)
        k1 = torch.where(two_q, 0, kind).view(-1, 1)
        basis = _coeff_basis(k1, theta.dtype)
        u = [a * cos + b * sin + c
             for a, b, c in zip(*basis)]              # 8 x (E, S, 1)
        dr = torch.where(b0, u[0], u[6])
        di = torch.where(b0, u[1], u[7])
        fr = torch.where(b0, u[2], u[4])
        fi = torch.where(b0, u[3], u[5])
        # RZZ: gd = z; RXX: gf = 1; RYY: gf = -z; U = cos - i sin (P)
        gd2 = torch.where(kind == _RZZ, z, 0.0)
        gf2 = torch.where(kind == _RXX, 1.0, torch.where(kind == _RYY, -z,
                                                         0.0))
        self.d = (torch.where(two_q, cos * one, dr),
                  torch.where(two_q, -sin * gd2, di))
        self.f = (torch.where(two_q, zero, fr),
                  torch.where(two_q, -sin * gf2, fi))
        # generators of RX (X), RY (Y: -i (-1)^b on the partner), RZ (Z)
        self.gd = torch.where(two_q, gd2, torch.where(kind == _RZ, sgn, 0.0))
        self.gf = (torch.where(two_q, gf2, torch.where(kind == _RX, 1.0,
                                                       0.0)),
                   torch.where(kind == _RY, -sgn, 0.0))

    def apply(self, re, im, d, f):
        """d psi + f psi[p] where act, psi elsewhere."""
        idx = self.partner.expand(re.shape)
        pre, pim = re.gather(2, idx), im.gather(2, idx)
        nre = d[0] * re - d[1] * im + f[0] * pre - f[1] * pim
        nim = d[0] * im + d[1] * re + f[0] * pim + f[1] * pre
        return torch.where(self.act, nre, re), torch.where(self.act, nim, im)

    def at_partner(self, c):
        """c[p[i]] of a coefficient pair."""
        idx = self.partner.expand(*c[0].shape[:2], -1)
        return tuple(x.expand(idx.shape).gather(2, idx) for x in c)


def _live(kind):
    """Tape positions that hold a gate in some env (NONE is the identity)."""
    return (kind != 0).any(dim=0).nonzero().flatten().tolist()


def apply_tape_fwd_plain(re, im, kind, tq, cq, slot, angles):
    """B3f in plain PyTorch: (E, S, D) planes of any float dtype, (E, G)
    integer tapes, (E, S, R) angles -> the output planes."""
    col = torch.arange(re.shape[-1], device=re.device)
    tape = (kind, tq, cq, slot)
    for g in _live(kind):
        gate = _Gate(tape, g, angles, col)
        re, im = gate.apply(re, im, gate.d, gate.f)
    return re, im


def apply_tape_bwd_plain(ore, oim, gre, gim, kind, tq, cq, slot, angles):
    """B3b in plain PyTorch: from the forward output planes and the
    real-plane cotangents (gre, gim) -> (dre, dim, dang), the psi0
    cotangents (Re lambda, -Im lambda) and the angle gradients (E, S, R)."""
    col = torch.arange(ore.shape[-1], device=ore.device)
    tape = (kind, tq, cq, slot)
    re, im, lre, lim = ore, oim, gre, -gim
    dang = torch.zeros_like(angles)
    for g in reversed(_live(kind)):
        gate = _Gate(tape, g, angles, col)
        idx = gate.partner.expand(re.shape)
        pre, pim = re.gather(2, idx), im.gather(2, idx)
        qr = gate.gd * re + gate.gf[0] * pre - gate.gf[1] * pim   # P psi
        qi = gate.gd * im + gate.gf[0] * pim + gate.gf[1] * pre
        row = 0.5 * torch.sum(torch.where(gate.act, qr * lim + qi * lre, 0.0),
                              dim=-1)                             # (E, S)
        row = torch.where(gate.has_grad.view(-1, 1) & (gate.slot >= 0)
                          .view(-1, 1), row, 0.0)
        sidx = gate.slot.clamp(min=0).view(-1, 1, 1).expand(*row.shape, 1)
        dang.scatter_add_(2, sidx, row[..., None])
        fp = gate.at_partner(gate.f)
        re, im = gate.apply(re, im, (gate.d[0], -gate.d[1]),
                            (fp[0], -fp[1]))                      # U^H
        lre, lim = gate.apply(lre, lim, gate.d, fp)               # U^T
    return lre, -lim, dang


# -- CUDA kernels ------------------------------------------------------------

_I32 = ctypes.c_int
_PTR = ctypes.c_void_p

# ``design`` of a launch: the register kernels up to 9 qubits and the first
# design above (what the wrappers launch), or the first design at any
# qubit count (to time it against the register kernels)
DESIGN_MAIN, DESIGN_FIRST = 0, 1


@functools.cache
def _library():
    """The kernels' library (built at first use) with its C signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load

    return bind(load("apply_tape"))


def bind(lib):
    """Set the C signatures of the tape kernels' library ``lib``."""
    lib.apply_tape_fwd_launch.argtypes = [_PTR] * 9 + [_I32] * 6 + [_PTR]
    lib.apply_tape_bwd_launch.argtypes = [_PTR] * 13 + [_I32] * 6 + [_PTR]
    for fn in (lib.apply_tape_fwd_launch, lib.apply_tape_bwd_launch):
        fn.restype = _I32
    for fn in (lib.apply_tape_fwd_smem_bytes, lib.apply_tape_bwd_smem_bytes):
        fn.argtypes = [_I32] * 5
        fn.restype = ctypes.c_size_t
    lib.apply_tape_error_string.argtypes = [_I32]
    lib.apply_tape_error_string.restype = ctypes.c_char_p
    return lib


def check_tapes(kind, tq, cq, slot, n: int, r: int) -> None:
    """Values a kernel indexes with (one host read): kinds NONE..RZZ,
    targets in [0, n), controls / second qubits in [-1, n) and not the
    target (a two-qubit rotation needs its second qubit), slots in
    [-1, r)."""
    two_q = kind >= _RXX
    bad = ((kind < 0) | (kind > _RZZ)).any()
    bad |= ((tq < 0) | (tq >= n)).any()
    bad |= ((cq < -1) | (cq >= n) | (cq == tq) | (two_q & (cq < 0))).any()
    bad |= ((slot < -1) | (slot >= r)).any()
    if bool(bad):
        raise ValueError(
            f"apply_tape: kinds must lie in [0, {_RZZ}], qubits in [0, {n}), "
            f"controls in [-1, {n}) and not the target (two-qubit rotations "
            f"need a second qubit), slots in [-1, {r})")


def _check(name, planes, tape, angles, tapes_checked):
    """The wrappers' input checks on CUDA tensors -> (E, S, G, R, n)."""
    dev = angles.device
    for t in (*planes, *tape, angles):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.dtype != torch.int32 for t in tape):
        raise TypeError(f"{name}: tapes must be int32")
    if any(t.dtype != torch.float32 for t in (*planes, angles)):
        raise TypeError(f"{name}: the CUDA kernel takes float32 planes and "
                        "angles")
    n_env, s_n, r = angles.shape
    d = planes[0].shape[-1]
    n = d.bit_length() - 1
    if d < 2 or d != 1 << n or any(p.shape != (n_env, s_n, d)
                                   for p in planes):
        raise ValueError(f"{name}: planes must be (E, S, D), D a power of "
                         "two, and angles (E, S, R)")
    if n > MAX_QUBITS:
        raise ValueError(f"{name}: {n} qubits; the composed engine takes at "
                         f"most {MAX_QUBITS} (ROADMAP.md, A6)")
    g = tape[0].shape[-1]
    if any(t.shape != (n_env, g) for t in tape):
        raise ValueError(f"{name}: tapes must all be (E, G)")
    if not tapes_checked:
        check_tapes(*tape, n, r)
    return n_env, s_n, g, r, n


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _dims(plane, tape, angles):
    """(E, S, G, R, n) of a launch's inputs."""
    n_env, s_n, r = angles.shape
    return n_env, s_n, tape[0].shape[-1], r, plane.shape[-1].bit_length() - 1


def run_fwd(lib, re, im, tape, angles, *, design=DESIGN_MAIN, stream=None):
    """One B3f launch of ``lib`` on checked inputs (the wrapper's, or a
    timing's with another ``design``; not counted) -> (ore, oim)."""
    n_env, s_n, g, r, n = _dims(re, tape, angles)
    check_smem("apply_tape_fwd",
               lib.apply_tape_fwd_smem_bytes(s_n, g, r, n, design), "CTA")
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    launch(lib, "apply_tape_fwd", *(t.data_ptr() for t in tape),
           angles.data_ptr(), re.data_ptr(), im.data_ptr(), ore.data_ptr(),
           oim.data_ptr(), n_env, s_n, g, r, n, design, stream)
    return ore, oim


def run_bwd(lib, ore, oim, gre, gim, tape, angles, *, psi0_grad=True,
            design=DESIGN_MAIN, stream=None):
    """One B3b launch of ``lib`` on checked inputs (not counted) -> (dre,
    dim, dang); without ``psi0_grad`` the register kernels write no psi0
    cotangents and (None, None, dang) is returned."""
    n_env, s_n, g, r, n = _dims(ore, tape, angles)
    check_smem("apply_tape_bwd",
               lib.apply_tape_bwd_smem_bytes(s_n, g, r, n, design), "CTA")
    skip = (not psi0_grad and design != DESIGN_FIRST
            and n <= lib.apply_tape_reg_max_qubits())
    dre, dim = ((None, None) if skip else
                (torch.empty_like(ore), torch.empty_like(oim)))
    dang = torch.empty_like(angles)
    # the first design above 13 qubits keeps psi in this workspace (lambda
    # in dre / dim)
    first = design == DESIGN_FIRST or n > lib.apply_tape_reg_max_qubits()
    work = (torch.empty((n_env, s_n, 2, 1 << n), dtype=torch.float32,
                        device=angles.device)
            if first and n > lib.apply_tape_smem_state_max_qubits()
            else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    launch(lib, "apply_tape_bwd", *(t.data_ptr() for t in tape),
           angles.data_ptr(), ore.data_ptr(), oim.data_ptr(), gre.data_ptr(),
           gim.data_ptr(), ptr(dre), ptr(dim), dang.data_ptr(), ptr(work),
           n_env, s_n, g, r, n, design, stream)
    return (dre, dim, dang) if psi0_grad else (None, None, dang)


def apply_tape_fwd(re, im, kind, tq, cq, slot, angles, *,
                   tapes_checked: bool = False):
    """B3f: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``tapes_checked``: the caller has run ``check_tapes`` on
    these tapes (saves a host read per launch).  Counts launches in
    ``apply_tape_fwd.launches``."""
    if angles.device.type == "cpu":
        return apply_tape_fwd_plain(re, im, kind, tq, cq, slot, angles)
    if angles.device.type != "cuda":
        raise ValueError(f"apply_tape_fwd: no kernel for device "
                         f"{angles.device}")
    tape = (kind, tq, cq, slot)
    _check("apply_tape_fwd", (re, im), tape, angles, tapes_checked)
    out = run_fwd(_library(), re, im, tape, angles,
                  stream=_stream(angles.device))
    apply_tape_fwd.launches += 1
    return out


def apply_tape_bwd(ore, oim, gre, gim, kind, tq, cq, slot, angles, *,
                   tapes_checked: bool = False, psi0_grad: bool = True):
    """B3b: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; -> (dre, dim, dang), (None, None, dang) without
    ``psi0_grad``.  Counts launches in ``apply_tape_bwd.launches``."""
    if angles.device.type == "cpu":
        dre, dim, dang = apply_tape_bwd_plain(ore, oim, gre, gim, kind, tq,
                                              cq, slot, angles)
        return (dre, dim, dang) if psi0_grad else (None, None, dang)
    if angles.device.type != "cuda":
        raise ValueError(f"apply_tape_bwd: no kernel for device "
                         f"{angles.device}")
    tape = (kind, tq, cq, slot)
    _check("apply_tape_bwd", (ore, oim, gre, gim), tape, angles,
           tapes_checked)
    out = run_bwd(_library(), ore, oim, gre, gim, tape, angles,
                  psi0_grad=psi0_grad, stream=_stream(angles.device))
    apply_tape_bwd.launches += 1
    return out


apply_tape_fwd.launches = 0
apply_tape_bwd.launches = 0


class ApplyTape(torch.autograd.Function):
    """(re, im, kind, tq, cq, slot, angles, plain, tapes_checked) ->
    (ore, oim) with B3f, and B3b as its backward; ``plain`` runs the plain
    versions on any device (the card check's reference)."""

    @staticmethod
    def forward(ctx, re, im, kind, tq, cq, slot, angles, plain=False,
                tapes_checked=False):
        if plain:
            ore, oim = apply_tape_fwd_plain(re, im, kind, tq, cq, slot,
                                            angles)
        else:
            ore, oim = apply_tape_fwd(re, im, kind, tq, cq, slot, angles,
                                      tapes_checked=tapes_checked)
        ctx.save_for_backward(ore, oim, kind, tq, cq, slot, angles)
        ctx.plain = plain
        ctx.tapes_checked = tapes_checked
        return ore, oim

    @staticmethod
    def backward(ctx, gre, gim):
        ore, oim, kind, tq, cq, slot, angles = ctx.saved_tensors
        gre = torch.zeros_like(ore) if gre is None else gre.contiguous()
        gim = torch.zeros_like(oim) if gim is None else gim.contiguous()
        # the psi0 cotangents only where someone reads them (the composed
        # engine's psi0 planes carry no gradient)
        psi0_grad = any(ctx.needs_input_grad[:2])
        if ctx.plain:
            dre, dim, dang = apply_tape_bwd_plain(ore, oim, gre, gim, kind,
                                                  tq, cq, slot, angles)
        else:
            dre, dim, dang = apply_tape_bwd(ore, oim, gre, gim, kind, tq, cq,
                                            slot, angles,
                                            tapes_checked=ctx.tapes_checked,
                                            psi0_grad=psi0_grad)
        if not psi0_grad:
            dre = dim = None
        return dre, dim, None, None, None, None, dang, None, None


def apply_tape_ri(re, im, kind, tq, cq, slot, angles, *, plain=False,
                  tapes_checked=False):
    """Differentiable tape application on re / im planes (the port's
    ``apply_tape_pallas_ri``): (E, S, D) planes, (E, G) tapes, (E, S, R)
    angles."""
    return ApplyTape.apply(re, im, kind, tq, cq, slot, angles, plain,
                           tapes_checked)
