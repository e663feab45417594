"""One env step of multi-start Adam angle optimization with a flip-grouped
Pauli H, fused, for 7 <= n <= 18 qubits.

Counterpart of ``tensorrl_qas_tpu/ops/pallas_opt2d.py`` (the v2 kernel,
with its noise and per-env psi0 variants).  The step is the one of
``ops/fused_adam.py``; only H psi differs.  Pauli terms
that flip the same bits f combine into one coefficient plane W_f, so

    (H psi)[i] = sum_f W_f(i) * psi[i ^ f]

with W_f(i) = sum_{k: flip_k = f} w_k iphase_k (-1)^parity(i & sign_k),
precomputed on the host by ``pauli_flip_groups``: 84 groups for 12-qubit
LiH instead of a dense (4096, 4096) matrix.

``fused_adam_step2d`` launches the CUDA kernel ``csrc/fused_adam_v2.cu``
on CUDA tensors -- for 7 <= n <= 12 with psi in registers, laid out as
``register_layout`` says and moved as ``swap_schedule`` (the plain twin of
the kernel's schedule) says; from 13 with psi in shared memory (13) or a
global workspace -- and runs ``fused_adam_step2d_reference``, the plain
PyTorch version of the same arithmetic, on CPU tensors.  Layouts: tapes
(E, G) int32, map_idx (E, R) int32, p0re/p0im (1, D) shared or (E, D)
one per env (the JAX kernel's ``per_env_psi0``, which takes (E, D / 128,
128) blocks), wre/wim (G_f, D) flip-group planes, flips (G_f,) int32,
starts (E, S, R), active (E, 1, R); returns x_opt (E, R) and e_new (E,).
``noise=(p1, p2)`` with ``seeds`` (E, 2) int32 is the depolarizing-
trajectory variant of ``ops/fused_adam.py``.  The JAX package keeps the
same planes in (G_f, D / 128, 128) lane tiles; ``optim/angle_opt.py:
operands2d_from_jax`` converts them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tensorrl_qas_tpu_torch.ops import fused_adam
from tensorrl_qas_tpu_torch.ops.fused_adam import B1, B2, EPS
from tensorrl_qas_tpu_torch.utils.bits import parity

MIN_QUBITS, MAX_QUBITS = 7, 18


def pauli_flip_groups(pauli, offset: float = 0.0, dtype=np.float32):
    """Flip-group coefficient planes of H - offset I.

    Returns (wre (G_f, D), wim (G_f, D), flips (G_f,) int32), groups in
    increasing flip order.  ``offset`` (the identity weight, see
    ``AngleOptimizer.offset``) comes off the real part of the f = 0 plane
    in float64, before the cast to ``dtype``.
    """
    d = 1 << pauli.n_qubits
    flips_arr = np.asarray(pauli.flip)
    idx = np.arange(d, dtype=np.int64)
    groups = sorted(set(int(f) for f in flips_arr))
    wre = np.zeros((len(groups), d), dtype=dtype)
    wim = np.zeros_like(wre)
    for gi, f in enumerate(groups):
        w = np.zeros(d, dtype=np.complex128)
        for k in np.nonzero(flips_arr == f)[0]:
            signs = 1.0 - 2.0 * np.asarray(
                parity(idx & int(pauli.sign_mask[k])), dtype=np.float64)
            w += pauli.weights[k] * complex(pauli.iphase[k]) * signs
        if f == 0:
            w -= offset
        wre[gi] = np.real(w)
        wim[gi] = np.imag(w)
    return wre, wim, np.asarray(groups, dtype=np.int32)


# the plain PyTorch version of the v2 kernel: the plain step both kernels
# share (flip-group planes)
fused_adam_step2d_reference = fused_adam.fused_adam_step_reference


# -- the register layout of the kernel (7 <= n <= 12) ------------------------

SWAP = -1                # the gate index of a swap in a schedule


def register_layout(n: int):
    """(r, lanes, warps): how the kernel's CTA holds the 2^n amplitudes of
    one start for 7 <= n <= 12.  Amplitude p of the physical order lives
    in thread p >> r, register p & (2^r - 1): physical bits [0, r) pick
    the register, the next ``lanes`` bits the lane of the warp, the rest
    the warp (2^(n - r) threads, 256 at 12 qubits)."""
    r = 4
    lanes = min(5, n - r)
    return r, lanes, n - r - lanes


def swap_schedule(kind, tq, cq, n: int):
    """Twin of the kernel's ``build_schedule``: where each logical qubit
    sits while one tape runs.  Lane bits hold logical qubits 0..lanes-1
    for good.  The registers start with the first r distinct targets among
    the other qubits (in tape order, then the lowest unused), the warp
    bits with the rest in increasing order.  A gate whose target sits on
    a warp bit is preceded by a swap of that bit with the register whose
    qubit is next used as a target furthest ahead (Belady; ties: the
    lowest register).  Controls are predicates on any bit and never move.

    ``kind``, ``tq``, ``cq``: one tape's (G,) arrays.  -> (map0, ops,
    map1): the logical qubit at each physical bit before and after the
    tape, and the ops in order, (g, target bit, control bit or -1) for
    gate g and (SWAP, register bit, warp bit) for a swap."""
    r, lanes, _ = register_layout(n)
    kind, tq, cq = (np.asarray(a).tolist() for a in (kind, tq, cq))
    g_n = len(kind)
    live = [g for g in range(g_n) if kind[g] != 0]
    first, after = [g_n] * n, [g_n] * g_n
    for g in reversed(live):
        after[g], first[tq[g]] = first[tq[g]], g
    rest = sorted(range(lanes, n), key=lambda q: (first[q], q))
    occ = rest[:r] + list(range(lanes)) + sorted(rest[r:])
    pos = {q: p for p, q in enumerate(occ)}
    map0, ops, next_use = list(occ), [], list(first)
    for g in live:
        t = tq[g]
        if pos[t] >= r + lanes:
            a = max(range(r), key=lambda a: (next_use[occ[a]], -a))
            b, qa = pos[t], occ[a]
            ops.append((SWAP, a, b))
            occ[a], occ[b], pos[t], pos[qa] = t, qa, a, b
        ops.append((g, pos[t], pos[cq[g]] if cq[g] >= 0 else -1))
        next_use[t] = after[g]
    return map0, ops, list(occ)


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

    lib = load("fused_adam_v2")
    lib.fused_adam_v2_launch.argtypes = (
        [_PTR] * 24 + [_I32] * 8 + [_F32, _F64, _F64]
        + [_F32] * 3 + [_U32] * 2 + [_PTR])
    lib.fused_adam_v2_launch.restype = _I32
    lib.fused_adam_v2_smem_bytes.argtypes = [_I32] * 5
    lib.fused_adam_v2_smem_bytes.restype = ctypes.c_size_t
    lib.fused_adam_v2_workspace_floats.argtypes = [_I32] * 3
    lib.fused_adam_v2_workspace_floats.restype = ctypes.c_size_t
    lib.fused_adam_v2_error_string.argtypes = [_I32]
    lib.fused_adam_v2_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(ints, floats, map_idx, flips, starts, active):
    """-> (E, S, G, R, n, G_f); 7 <= n <= 18."""
    return fused_adam.check_flip_inputs(
        "fused_adam_step2d", ints, floats, map_idx, flips, starts, active,
        (MIN_QUBITS, MAX_QUBITS))


def fused_adam_step2d(old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim,
                      flips, starts, active, *, iters: int, lr: float,
                      noise=None, seeds=None):
    """Fused env step with flip-group planes: the CUDA kernel for CUDA
    tensors, the plain PyTorch version for CPU tensors.  See the module
    docstring for the layouts and ``noise`` / ``seeds``.
    ``fused_adam_step2d.launches`` counts kernel launches,
    ``fused_adam_step2d.noise_launches`` those of the noise variant and
    ``fused_adam_step2d.psi0_launches`` those with per-env psi0 planes
    among them."""
    if starts.device.type == "cpu":
        return fused_adam_step2d_reference(
            old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim, flips,
            starts, active, iters=iters, lr=lr, noise=noise, seeds=seeds)
    if starts.device.type != "cuda":
        raise ValueError(f"fused_adam_step2d: no kernel for device "
                         f"{starts.device}")
    ints = (*old_arrs, *new_arrs)
    floats = (p0re, p0im, wre, wim, starts, active)
    n_env, s_n, g, r, n, n_groups = _check_inputs(ints, floats, map_idx,
                                                  flips, starts, active)
    dev = starts.device
    seeds_ptr, thr1, thr2 = fused_adam.noise_args(
        "fused_adam_step2d", noise, seeds, n_env, dev)
    lib = _library()
    fused_adam.check_smem(
        "fused_adam_step2d",
        lib.fused_adam_v2_smem_bytes(g, r, n, n_groups, noise is not None),
        "start")
    f32 = dict(dtype=torch.float32, device=dev)
    x_opt = torch.empty((n_env, r), **f32)
    e_new = torch.empty((n_env,), **f32)
    best_x = torch.empty((n_env, s_n, r), **f32)
    best_e = torch.empty((n_env, s_n), **f32)
    arrived = torch.zeros((n_env,), dtype=torch.int32, device=dev)
    n_work = lib.fused_adam_v2_workspace_floats(n_env, s_n, n)
    work = torch.empty((n_work,), **f32) if n_work else None
    stride = fused_adam.psi0_stride(p0re)
    # the groups whose imaginary plane is not zero (none for a real H)
    wim_any = (wim != 0).any(dim=1).to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fused_adam.launch(
        lib, "fused_adam_v2", *(t.data_ptr() for t in ints),
        map_idx.data_ptr(), p0re.data_ptr(), p0im.data_ptr(), wre.data_ptr(),
        wim.data_ptr(), flips.data_ptr(), wim_any.data_ptr(),
        starts.data_ptr(), active.data_ptr(), seeds_ptr, x_opt.data_ptr(),
        e_new.data_ptr(), best_x.data_ptr(), best_e.data_ptr(),
        arrived.data_ptr(),
        None if work is None else work.data_ptr(), n_env, s_n, g, r, n,
        n_groups, stride, int(iters), float(lr), B1, B2, 1.0 - B1, 1.0 - B2,
        EPS, thr1, thr2, stream)
    fused_adam_step2d.launches += 1
    fused_adam_step2d.noise_launches += noise is not None
    fused_adam_step2d.psi0_launches += stride != 0
    return x_opt, e_new


fused_adam_step2d.launches = 0
fused_adam_step2d.noise_launches = 0
fused_adam_step2d.psi0_launches = 0
