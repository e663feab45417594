"""One env step of multi-start Adam angle optimization with a flip-grouped
Pauli H, fused, for 7 <= n <= 20 qubits.

Counterpart of ``tensorrl_qas_tpu/ops/pallas_opt2d.py`` (the v2 kernel,
with its noise and per-env psi0 variants).  The step is the one of
``ops/fused_adam.py``; only H psi differs.  Pauli terms
that flip the same bits f combine into one coefficient plane W_f, so

    (H psi)[i] = sum_f W_f(i) * psi[i ^ f]

with W_f(i) = sum_{k: flip_k = f} w_k iphase_k (-1)^parity(i & sign_k),
precomputed on the host by ``pauli_flip_groups``: 84 groups for 12-qubit
LiH instead of a dense (4096, 4096) matrix.

``fused_adam_step2d`` launches the CUDA kernel ``csrc/fused_adam_v2.cu``
on CUDA tensors, psi in registers at every width: one CTA a start up to
12 qubits, 2^(n - 12) CTAs a start above -- one thread-block cluster up
to 16 qubits, at 17 and 18 a group of clusters that trade through global
memory (``start_ctas``, ``cluster_size``) -- laid out as
``register_layout`` says and moved as ``swap_schedule`` (the plain twin
of the kernel's schedule) says.  At 19 and 20 qubits, where the card
cannot hold a start on chip, it launches ``csrc/fused_adam_v2_sweep.cu``:
a cooperative grid (``check_residency``) in slots, each running one
start at a time, whose psi and lambda are swept chunk by chunk through
L2 along the tape's segments (``sweep_segments``, the plain twin of the
kernel's), W computed from the flip groups' terms
(``flip_group_terms``) where a group has few.  It runs
``fused_adam_step2d_reference``, the plain PyTorch version of the same
arithmetic, on CPU tensors.
Layouts: tapes
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

MIN_QUBITS, MAX_QUBITS = 7, 20
SWEEP_MIN_QUBITS = 19     # from here the sweep kernel
SWEEP_CHUNK_BITS = 12     # its chunk: 2^12 amplitudes


def pauli_flip_groups(pauli, offset: float = 0.0, dtype=np.float32):
    """Flip-group coefficient planes of H - offset I.

    Returns (wre (G_f, D), wim (G_f, D), flips (G_f,) int32), groups in
    increasing flip order, arrays of the caller's own.  ``offset`` (the
    identity weight, see ``AngleOptimizer.offset``) comes off the real
    part of the f = 0 plane in float64, before the cast to ``dtype``.  The
    float64 planes of the last FLIP_GROUPS_KEPT Hamiltonians are kept (by
    their terms and offset): every env, check and trainer that loads a
    problem makes its own optimizer, and at 20 qubits the planes take
    most of a second to make.
    """
    key = (pauli.n_qubits, float(offset),
           *(np.asarray(a).tobytes() for a in (pauli.flip, pauli.sign_mask,
                                                pauli.weights,
                                                pauli.iphase)))
    planes = _FLIP_GROUPS.pop(key, None)
    if planes is None:
        planes = _flip_groups64(pauli, offset)
    _FLIP_GROUPS[key] = planes
    while len(_FLIP_GROUPS) > FLIP_GROUPS_KEPT:
        del _FLIP_GROUPS[next(iter(_FLIP_GROUPS))]
    wre, wim, groups = planes
    return wre.astype(dtype), wim.astype(dtype), groups.copy()


FLIP_GROUPS_KEPT = 2
_FLIP_GROUPS = {}        # key -> float64 planes, least recently used first


def _flip_groups64(pauli, offset):
    """``pauli_flip_groups``' planes in float64."""
    d = 1 << pauli.n_qubits
    flips_arr = np.asarray(pauli.flip)
    idx = np.arange(d, dtype=np.int64)
    groups = sorted(set(int(f) for f in flips_arr))
    wre = np.zeros((len(groups), d))
    wim = np.zeros_like(wre)
    for gi, f in enumerate(groups):
        # the real and imaginary parts of sum_k c_k (-1)^parity(i & s_k),
        # term by term in float64: the same sums as in complex128, without
        # the complex products that took most of the time at 20 qubits (a
        # zero part adds nothing)
        wr = np.zeros(d)
        wi = np.zeros(d)
        for k in np.nonzero(flips_arr == f)[0]:
            signs = np.where(np.bitwise_count(idx & int(pauli.sign_mask[k]))
                             & 1, -1.0, 1.0)
            c = pauli.weights[k] * complex(pauli.iphase[k])
            if c.real:
                wr += c.real * signs
            if c.imag:
                wi += c.imag * signs
        if f == 0:
            wr -= offset
        wre[gi] = wr
        wim[gi] = wi
    return wre, wim, np.asarray(groups, dtype=np.int32)


def flip_group_terms(pauli, offset: float = 0.0):
    """The terms behind ``pauli_flip_groups``' planes, for the sweep
    kernel to compute a group's W_f(i) = sum_k c_k (-1)^popc(i & sign_k)
    itself: groups in increasing flip order, each group's terms in the
    order of ``pauli``, c_k = w_k iphase_k in float64 as the planes take
    it.  -> (gterm (G_f + 1,) int32: group f's terms are [gterm[f],
    gterm[f + 1]); tsign (T,) int32 sign masks; tcoef (T, 2) float64
    (re, im); offset, which comes off the f = 0 group)."""
    flips_arr = np.asarray(pauli.flip)
    groups = sorted(set(int(f) for f in flips_arr))
    gterm, tsign, tcoef = [0], [], []
    for f in groups:
        for k in np.nonzero(flips_arr == f)[0]:
            c = pauli.weights[k] * complex(pauli.iphase[k])
            tsign.append(int(pauli.sign_mask[k]))
            tcoef.append((c.real, c.imag))
        gterm.append(len(tsign))
    return (np.asarray(gterm, np.int32), np.asarray(tsign, np.int32),
            np.asarray(tcoef, np.float64).reshape(-1, 2), float(offset))


# the plain PyTorch version of the v2 kernel: the plain step both kernels
# share (flip-group planes)
fused_adam_step2d_reference = fused_adam.fused_adam_step_reference


# -- the register layout of the kernel --------------------------------------

SWAP = -1                # the gate index of a swap in a schedule
CLUSTER_BIT = 12         # the first cluster bit: 4 register, 5 lane, 3 warp


def register_layout(n: int):
    """(r, lanes, warps, ranks): how the kernel holds the 2^n amplitudes of
    one start.  Amplitude p of the physical order lives in register p &
    (2^r - 1) of the start's thread p >> r: physical bits [0, r) pick the
    register, the next ``lanes`` bits the lane of the warp, the next
    ``warps`` bits the warp of the CTA (2^(n - r) threads, 256 at 12
    qubits), and from 13 qubits the top ``ranks`` bits (bit 12 up) the
    CTA's rank among the start's 2^ranks CTAs of 256 threads: up to 16
    qubits one cluster, at 17 and 18 a group of clusters, whose rank bits
    above the cluster's are the group bits."""
    r = 4
    lanes = min(5, n - r)
    warps = min(3, n - r - lanes)
    return r, lanes, warps, n - r - lanes - warps


def swap_schedule(kind, tq, cq, n: int, top: int | None = None):
    """Twin of the kernel's ``build_schedule``: where each logical qubit
    sits while one tape runs.  Lane bits hold logical qubits 0..lanes-1
    for good.  The registers start with the first r distinct targets among
    the other qubits (in tape order, then the lowest unused), the warp
    and cluster bits (the bits above the lanes) with the rest in
    increasing order.  A gate whose target sits on a warp or cluster bit
    is preceded by a swap of that bit with the register whose qubit is
    next used as a target furthest ahead (Belady; ties: the lowest
    register).  Controls are predicates on any bit and never move.

    Physical bits from ``top`` up (None: none) are group bits, whose swaps
    go through global memory and cost most: they start with the qubits
    whose first target comes last (the rest below them in increasing
    order), and a swap through one sends out the qubit below the group
    bits that is next a target furthest ahead -- where that qubit sits on
    a warp or cluster bit and is used later than every register's, a swap
    of it into the evicted register comes first.

    ``kind``, ``tq``, ``cq``: one tape's (G,) arrays.  -> (map0, ops,
    map1): the logical qubit at each physical bit before and after the
    tape, and the ops in order, (g, target bit, control bit or -1) for
    gate g and (SWAP, register bit, warp, cluster or group bit) for a
    swap."""
    r, lanes, _, _ = register_layout(n)
    top = n if top is None else top
    kind, tq, cq = (np.asarray(a).tolist() for a in (kind, tq, cq))
    g_n = len(kind)
    live = [g for g in range(g_n) if kind[g] != 0]
    first, after = [g_n] * n, [g_n] * g_n
    for g in reversed(live):
        after[g], first[tq[g]] = first[tq[g]], g
    rest = sorted(range(lanes, n), key=lambda q: (first[q], q))
    others = rest[r:]
    late = others[len(others) - (n - top):]     # the last to be targeted
    occ = (rest[:r] + list(range(lanes))
           + sorted(q for q in others if q not in late) + sorted(late))
    pos = {q: p for p, q in enumerate(occ)}
    map0, ops, next_use = list(occ), [], list(first)

    def swap(a, b):
        qa, qb = occ[a], occ[b]
        ops.append((SWAP, a, b))
        occ[a], occ[b], pos[qb], pos[qa] = qb, qa, a, b

    for g in live:
        t = tq[g]
        if pos[t] >= r + lanes:
            a = max(range(r), key=lambda a: (next_use[occ[a]], -a))
            if pos[t] >= top and top > r + lanes:
                v = max(range(r + lanes, top),
                        key=lambda v: (next_use[occ[v]], -v))
                if next_use[occ[v]] > next_use[occ[a]]:
                    swap(a, v)
            swap(a, pos[t])
        ops.append((g, pos[t], pos[cq[g]] if cq[g] >= 0 else -1))
        next_use[t] = after[g]
    return map0, ops, list(occ)


def storage_flip(flip: int, phys_map) -> tuple[int, int]:
    """Twin of the kernel's ``physical_flips`` for one flip group, under
    ``phys_map`` (the logical qubit at each physical bit, the schedule's
    end map): (the xor the group's flip f makes in a CTA's storage of psi
    for H psi -- amplitude j of thread t at j * 256 + t --, the xor it
    makes in the CTA's rank).  psi[i ^ f] of an amplitude is read at the
    first in the CTA of the second."""
    pf = sum(1 << b for b, q in enumerate(phys_map) if (flip >> q) & 1)
    loc = pf & ((1 << CLUSTER_BIT) - 1)
    return ((loc & 15) << 8) | (loc >> 4), pf >> CLUSTER_BIT


# -- CUDA kernel -------------------------------------------------------------

_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
_F64 = ctypes.c_double
_PTR = ctypes.c_void_p


def bind(lib):
    """Set the C signatures of the v2 kernel's library ``lib``."""
    lib.fused_adam_v2_launch.argtypes = (
        [_PTR] * 24 + [_I32] * 10 + [_F32, _F64, _F64]
        + [_F32] * 3 + [_U32] * 2 + [_PTR])
    lib.fused_adam_v2_launch.restype = _I32
    lib.fused_adam_v2_smem_bytes.argtypes = [_I32] * 5
    lib.fused_adam_v2_smem_bytes.restype = ctypes.c_size_t
    lib.fused_adam_v2_exchange_floats.argtypes = [_I32] * 3
    lib.fused_adam_v2_exchange_floats.restype = ctypes.c_size_t
    lib.fused_adam_v2_start_ctas.argtypes = [_I32]
    lib.fused_adam_v2_start_ctas.restype = _I32
    lib.fused_adam_v2_cluster_size.argtypes = [_I32, _I32]
    lib.fused_adam_v2_cluster_size.restype = _I32
    lib.fused_adam_v2_group_band.argtypes = [_I32]
    lib.fused_adam_v2_group_band.restype = _I32
    lib.fused_adam_v2_cluster_occupancy.argtypes = [_I32, ctypes.c_size_t,
                                                    _I32]
    lib.fused_adam_v2_cluster_occupancy.restype = _I32
    lib.fused_adam_v2_error_string.argtypes = [_I32]
    lib.fused_adam_v2_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The kernel's library (built at first use) with its C signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load

    return bind(load("fused_adam_v2"))


def _check_inputs(ints, floats, map_idx, flips, starts, active,
                  qubits=(MIN_QUBITS, MAX_QUBITS)):
    """-> (E, S, G, R, n, G_f); qubits[0] <= n <= qubits[1] (7 and 20)."""
    return fused_adam.check_flip_inputs(
        "fused_adam_step2d", ints, floats, map_idx, flips, starts, active,
        qubits)


# (library, n, smem, device, group cluster) -> the clusters check_clusters
# found (>= 1)
_clusters: dict = {}


def check_clusters(lib, n: int, smem: int, device=None,
                   group_cluster: int = 0) -> int:
    """Clusters of the kernel that runs ``n`` qubits (13-16: the cluster
    kernel; 17-18: the group kernel in clusters of ``group_cluster`` CTAs,
    0 for its default), each CTA with ``smem`` bytes of dynamic shared
    memory, that the card (``device``, the current one when None) can hold
    at once; raises when it can hold none, or, in the group kernel, not
    the clusters of one whole start (no fallback to another kernel).  A
    count found once per shape is kept, so that a step after the first
    asks the CUDA runtime nothing."""
    key = (lib, n, smem, device, group_cluster)
    if key in _clusters:
        return _clusters[key]
    clusters = lib.fused_adam_v2_cluster_occupancy(n, smem, group_cluster)
    size = lib.fused_adam_v2_cluster_size(n, group_cluster)
    per_start = lib.fused_adam_v2_start_ctas(n) // max(size, 1)
    if clusters < per_start:
        why = (f"CUDA error {-clusters} "
               f"({lib.fused_adam_v2_error_string(-clusters).decode()})"
               if clusters < 0 else f"{clusters} fit at once"
               if clusters else "none fits")
        raise RuntimeError(
            f"fused_adam_step2d: a start at {n} qubits takes {per_start} "
            f"cluster(s) of {size} CTAs with {smem} B of shared memory "
            f"each, and the card cannot hold them at once: {why}")
    _clusters[key] = clusters
    return clusters


def run_kernel(lib, old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim,
               flips, starts, active, *, iters, lr, noise, seeds, stream,
               group_cluster=0):
    """Check the inputs and launch the v2 kernel of ``lib`` (bound by
    ``bind``) on ``stream``, uncounted (the host emulation's tests and the
    split's cluster-size comparison call it directly; ``group_cluster``
    sets the group kernel's cluster size, 0 its default).  -> (psi0
    stride, CTAs a start, whether the group kernel ran, x_opt, e_new)."""
    ints = (*old_arrs, *new_arrs)
    floats = (p0re, p0im, wre, wim, starts, active)
    n_env, s_n, g, r, n, n_groups = _check_inputs(
        ints, floats, map_idx, flips, starts, active,
        (MIN_QUBITS, SWEEP_MIN_QUBITS - 1))
    dev = starts.device
    seeds_ptr, thr1, thr2 = fused_adam.noise_args(
        "fused_adam_step2d", noise, seeds, n_env, dev)
    smem = lib.fused_adam_v2_smem_bytes(g, r, n, n_groups, noise is not None)
    fused_adam.check_smem("fused_adam_step2d", smem, "CTA")
    ctas = lib.fused_adam_v2_start_ctas(n)
    group = bool(lib.fused_adam_v2_group_band(n))
    slots, cluster = 0, group_cluster if group else 0
    if ctas > 1:
        clusters = check_clusters(lib, n, smem, dev, cluster)
        # the starts the card holds at once, whole
        slots = (clusters * lib.fused_adam_v2_cluster_size(n, cluster)
                 // ctas if group else 0)
    f32 = dict(dtype=torch.float32, device=dev)
    x_opt = torch.empty((n_env, r), **f32)
    e_new = torch.empty((n_env,), **f32)
    best_x = torch.empty((n_env, s_n, r), **f32)
    best_e = torch.empty((n_env, s_n), **f32)
    # the env counters, then the group kernel's barrier counters
    arrived = torch.zeros((n_env + slots,), dtype=torch.int32, device=dev)
    n_xchg = lib.fused_adam_v2_exchange_floats(n, r, min(slots, n_env * s_n))
    xchg = torch.empty((n_xchg,), **f32) if n_xchg else None
    stride = fused_adam.psi0_stride(p0re)
    # the groups whose imaginary plane is not zero (none for a real H)
    wim_any = (wim != 0).any(dim=1).to(torch.int32)
    fused_adam.launch(
        lib, "fused_adam_v2", *(t.data_ptr() for t in ints),
        map_idx.data_ptr(), p0re.data_ptr(), p0im.data_ptr(), wre.data_ptr(),
        wim.data_ptr(), flips.data_ptr(), wim_any.data_ptr(),
        starts.data_ptr(), active.data_ptr(), seeds_ptr, x_opt.data_ptr(),
        e_new.data_ptr(), best_x.data_ptr(), best_e.data_ptr(),
        arrived.data_ptr(), None if xchg is None else xchg.data_ptr(),
        min(slots, n_env * s_n), cluster, n_env, s_n, g, r, n, n_groups,
        stride, int(iters), float(lr), B1, B2, 1.0 - B1, 1.0 - B2, EPS, thr1,
        thr2, stream)
    return stride, ctas, group, x_opt, e_new


# -- the sweep kernel (19-20 qubits) ------------------------------------------

def sweep_segments(kind, tq, cq, n: int,
                   chunk_bits: int = SWEEP_CHUNK_BITS) -> list[int]:
    """Twin of the sweep kernels' ``segments::build`` (``csrc/
    segments.cuh``, read by B2's sweep kernel and the sweep tape kernels):
    one tape's schedule words, word for word.  Each live gate joins the
    current segment unless its qubits above qubit 4 would give the segment
    more than chunk_bits - 5 of them; then a new segment starts.  A
    segment's local qubits are qubits 0..4, its gates' and the lowest
    others up to chunk_bits; a tape with no live gate has one empty
    segment.  ``kind``, ``tq``,
    ``cq``: one tape's (G,) arrays.  -> 3 G + 2 ints: the segments, each
    segment's first index into the live-gate list and the end, each
    segment's local-qubit mask, the live gates in tape order; -1 where
    unused."""
    kind, tq, cq = (np.asarray(a).tolist() for a in (kind, tq, cq))
    g_n = len(kind)
    low = (1 << 5) - 1
    room = chunk_bits - 5

    def fill(m):
        for q in range(5, n):
            if bin(m).count("1") >= chunk_bits:
                break
            m |= 1 << q
        return m

    begin, masks, live, cur = [0], [], [], 0
    for g in range(g_n):
        if kind[g] == 0:
            continue
        q = (1 << tq[g]) | ((1 << cq[g]) if cq[g] >= 0 else 0)
        q &= ~low
        if len(live) > begin[-1] and bin(cur | q).count("1") > room:
            masks.append(fill(low | cur))
            begin.append(len(live))
            cur = 0
        cur |= q
        live.append(g)
    masks.append(fill(low | cur))
    begin.append(len(live))
    words = [-1] * (3 * g_n + 2)
    words[0] = len(masks)
    words[1:1 + len(begin)] = begin
    words[g_n + 2:g_n + 2 + len(masks)] = masks
    words[2 * g_n + 2:2 * g_n + 2 + len(live)] = live
    return words


def bind_sweep(lib):
    """Set the C signatures of the sweep kernel's library ``lib``."""
    lib.fused_adam_sweep_launch.argtypes = (
        [_PTR] * 32 + [_I32] * 10 + [_F64, _F32, _F64, _F64] + [_F32] * 3
        + [_U32] * 2 + [_PTR])
    lib.fused_adam_sweep_launch.restype = _I32
    for name in ("min_qubits", "max_qubits", "chunk_bits", "compute_terms"):
        getattr(lib, f"fused_adam_sweep_{name}").argtypes = []
        getattr(lib, f"fused_adam_sweep_{name}").restype = _I32
    lib.fused_adam_sweep_smem_bytes.argtypes = [_I32, _I32]
    lib.fused_adam_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.fused_adam_sweep_slots.argtypes = [_I32] * 3
    lib.fused_adam_sweep_slots.restype = _I32
    lib.fused_adam_sweep_resident_ctas.argtypes = [ctypes.c_size_t]
    lib.fused_adam_sweep_resident_ctas.restype = _I32
    lib.fused_adam_sweep_error_string.argtypes = [_I32]
    lib.fused_adam_sweep_error_string.restype = ctypes.c_char_p
    lib.fused_adam_sweep_w_planes.argtypes = (
        [_PTR] * 5 + [_F64] + [_I32] * 2 + [_PTR] * 3)
    lib.fused_adam_sweep_w_planes.restype = _I32
    return lib


@functools.cache
def _sweep_library():
    """The sweep kernel's library (built at first use) with its C
    signatures."""
    from tensorrl_qas_tpu_torch.ops.build import load

    return bind_sweep(load("fused_adam_v2_sweep"))


# (library, smem, device) -> the CTAs check_residency found (>= 1)
_resident: dict = {}


def check_residency(lib, smem: int, device=None) -> int:
    """CTAs of the sweep kernel, each with ``smem`` bytes of dynamic shared
    memory, that the card (``device``, the current one when None) holds at
    once: the grid of its cooperative launch, whose barriers then wait only
    on CTAs that run.  Raises when the card holds none (no fallback to
    another kernel); a count found once per shape is kept."""
    key = (lib, smem, device)
    if key in _resident:
        return _resident[key]
    ctas = lib.fused_adam_sweep_resident_ctas(smem)
    if ctas < 1:
        why = (f"CUDA error {-ctas} "
               f"({lib.fused_adam_sweep_error_string(-ctas).decode()})"
               if ctas < 0 else "none fits")
        raise RuntimeError(
            f"fused_adam_step2d: the sweep kernel's CTA takes {smem} B of "
            f"shared memory, and the card cannot hold one: {why}")
    _resident[key] = ctas
    return ctas


def sweep_terms(terms, n_groups, device):
    """``flip_group_terms``' arrays as the sweep kernel reads them, on
    ``device``: (gterm, tsign, tcoef, offset), or None's (every group's W
    read from its planes) for ``terms`` None."""
    if terms is None:
        return None, None, None, 0.0
    gterm, tsign, tcoef, offset = terms
    if len(gterm) != n_groups + 1:
        raise ValueError(f"fused_adam_step2d: terms of {len(gterm) - 1} "
                         f"groups for {n_groups} W planes")
    # an empty term list still needs a valid pointer
    return (torch.as_tensor(np.asarray(gterm, np.int32), device=device),
            torch.as_tensor(np.asarray(tsign, np.int32).reshape(-1)
                            if len(tsign) else np.zeros(1, np.int32),
                            device=device),
            torch.as_tensor(np.asarray(tcoef, np.float64).reshape(-1)
                            if len(tsign) else np.zeros(2), device=device),
            float(offset))


def run_sweep_kernel(lib, old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim,
                     flips, starts, active, *, iters, lr, noise, seeds,
                     stream, terms=None, slots=None):
    """Check the inputs and launch the sweep kernel of ``lib`` (bound by
    ``bind_sweep``) on ``stream``, uncounted (the host emulation's tests
    call it directly), on a grid of as many CTAs as the card holds at
    once, in ``slots`` slots (None: ``fused_adam_sweep_slots``'s pick).
    ``terms``: ``flip_group_terms`` of the planes' Hamiltonian (arrays or
    tensors), or None to read every group's planes.  -> (psi0 stride,
    CTAs, x_opt, e_new, scratch: a dict of the launch's buffers, among
    them the schedule words (2, E, 3 G + 2) of the old and new tapes, with
    the slots and the barriers each slot passed)."""
    ints = (*old_arrs, *new_arrs)
    floats = (p0re, p0im, wre, wim, starts, active)
    band = (lib.fused_adam_sweep_min_qubits(),
            lib.fused_adam_sweep_max_qubits())
    n_env, s_n, g, r, n, n_groups = _check_inputs(
        ints, floats, map_idx, flips, starts, active, band)
    dev = starts.device
    seeds_ptr, thr1, thr2 = fused_adam.noise_args(
        "fused_adam_step2d", noise, seeds, n_env, dev)
    smem = lib.fused_adam_sweep_smem_bytes(g, n_groups)
    fused_adam.check_smem("fused_adam_step2d", smem, "CTA")
    ctas = check_residency(lib, smem, dev)
    rows, d = n_env * s_n, 1 << n
    chunks = d >> lib.fused_adam_sweep_chunk_bits()
    grid = min(ctas, rows * chunks)
    if slots is None:
        slots = lib.fused_adam_sweep_slots(n, rows, grid)
    if not 1 <= slots <= min(grid, rows):
        raise ValueError(f"fused_adam_step2d: {slots} slots for {rows} "
                         f"starts on {grid} CTAs")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    x_opt = torch.empty((n_env, r), **f32)
    e_new = torch.empty((n_env,), **f32)
    scratch = dict(
        psi=torch.empty((slots, d, 2), **f32),
        lam=torch.empty((slots, d, 2), **f32),
        adam=torch.empty((rows, 4, r), **f32),
        best_e=torch.empty((rows,), **f32),
        gpart=torch.empty((slots, g, chunks), **f32),
        epart=torch.empty((slots, chunks, 2), dtype=torch.float64,
                          device=dev),
        sched=torch.empty((2, n_env, 3 * g + 2), **i32),
        xnew=torch.empty((n_env, r), **f32),
        bar=torch.zeros((slots + 1, 32), **i32))
    stride = fused_adam.psi0_stride(p0re)
    wim_any = (wim != 0).any(dim=1).to(torch.int32)
    gterm, tsign, tcoef, offset = sweep_terms(terms, n_groups, dev)
    fused_adam.launch(
        lib, "fused_adam_sweep", *(t.data_ptr() for t in ints),
        map_idx.data_ptr(), p0re.data_ptr(), p0im.data_ptr(), wre.data_ptr(),
        wim.data_ptr(), flips.data_ptr(), wim_any.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (gterm, tsign, tcoef)),
        starts.data_ptr(), active.data_ptr(), seeds_ptr, x_opt.data_ptr(),
        e_new.data_ptr(), *(t.data_ptr() for t in scratch.values()), grid,
        slots, n_env, s_n, g, r, n, n_groups, stride, int(iters), offset,
        float(lr), B1, B2, 1.0 - B1, 1.0 - B2, EPS, thr1, thr2, stream)
    scratch["slots"] = slots
    scratch["barriers"] = _Barriers(scratch["bar"], slots, grid)
    return stride, ctas, x_opt, e_new, scratch


class _Barriers:
    """The barriers a sweep launch passed, read from its counters once it
    has run: ``per_slot`` (each slot's), ``grid`` (the whole grid's);
    str() the total a CTA passed at most."""

    def __init__(self, bar, slots, grid):
        self.bar, self.slots, self.grid = bar, slots, grid

    def counts(self):
        counts = self.bar[:, 0].cpu().tolist()
        per_slot = [counts[s] // len(range(s, self.grid, self.slots))
                    for s in range(self.slots)]
        return per_slot, counts[self.slots] // self.grid

    def __str__(self):
        per_slot, grid = self.counts()
        return f"{max(per_slot) + grid} (slots {per_slot}, grid {grid})"


def sweep_w_planes(lib, flips, wim, terms, n: int, stream=None):
    """The sweep kernel's own W of every group it computes (``group_w``,
    from ``terms`` = ``flip_group_terms``) as (G_f, 2^n) float32 planes on
    ``flips``' device, NaN in the rows of the groups it reads; and which
    rows those are (a bool per group)."""
    dev = flips.device
    n_groups = flips.numel()
    gterm, tsign, tcoef, offset = sweep_terms(terms, n_groups, dev)
    out = [torch.full((n_groups, 1 << n), float("nan"), dtype=torch.float32,
                      device=dev) for _ in range(2)]
    wim_any = (wim != 0).any(dim=1).to(torch.int32)
    rc = lib.fused_adam_sweep_w_planes(
        flips.data_ptr(), wim_any.data_ptr(), gterm.data_ptr(),
        tsign.data_ptr(), tcoef.data_ptr(), offset, n, n_groups,
        out[0].data_ptr(), out[1].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam_sweep_w_planes failed: CUDA error "
                           f"{rc} ({lib.fused_adam_sweep_error_string(rc)})")
    computed = torch.as_tensor(np.diff(np.asarray(terms[0]))
                               <= lib.fused_adam_sweep_compute_terms())
    return out[0], out[1], computed


def fused_adam_step2d(old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim,
                      flips, starts, active, *, iters: int, lr: float,
                      noise=None, seeds=None, terms=None):
    """Fused env step with flip-group planes: the CUDA kernel for CUDA
    tensors, the plain PyTorch version for CPU tensors.  See the module
    docstring for the layouts and ``noise`` / ``seeds``.  ``terms``
    (``flip_group_terms`` of the same H, optional) lets the sweep kernel
    compute W where a group has few terms; the other kernels and the
    plain version read the planes.
    ``fused_adam_step2d.launches`` counts kernel launches,
    ``fused_adam_step2d.noise_launches`` those of the noise variant,
    ``fused_adam_step2d.psi0_launches`` those with per-env psi0 planes,
    ``fused_adam_step2d.cluster_launches`` those of the cluster kernel
    (13-16 qubits), ``fused_adam_step2d.group_launches`` those of the
    group kernel (17-18) and ``fused_adam_step2d.sweep_launches`` those of
    the sweep kernel (19-20) among them."""
    if starts.device.type == "cpu":
        return fused_adam_step2d_reference(
            old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim, flips,
            starts, active, iters=iters, lr=lr, noise=noise, seeds=seeds)
    if starts.device.type != "cuda":
        raise ValueError(f"fused_adam_step2d: no kernel for device "
                         f"{starts.device}")
    stream = torch.cuda.current_stream(starts.device).cuda_stream
    if p0re.shape[-1] >= 1 << SWEEP_MIN_QUBITS:
        stride, _, x_opt, e_new, _ = run_sweep_kernel(
            _sweep_library(), old_arrs, new_arrs, map_idx, p0re, p0im, wre,
            wim, flips, starts, active, iters=iters, lr=lr, noise=noise,
            seeds=seeds, stream=stream, terms=terms)
        fused_adam_step2d.launches += 1
        fused_adam_step2d.noise_launches += noise is not None
        fused_adam_step2d.psi0_launches += stride != 0
        fused_adam_step2d.sweep_launches += 1
        return x_opt, e_new
    stride, ctas, group, x_opt, e_new = run_kernel(
        _library(), old_arrs, new_arrs, map_idx, p0re, p0im, wre, wim, flips,
        starts, active, iters=iters, lr=lr, noise=noise, seeds=seeds,
        stream=stream)
    fused_adam_step2d.launches += 1
    fused_adam_step2d.noise_launches += noise is not None
    fused_adam_step2d.psi0_launches += stride != 0
    fused_adam_step2d.cluster_launches += ctas > 1 and not group
    fused_adam_step2d.group_launches += group
    return x_opt, e_new


fused_adam_step2d.launches = 0
fused_adam_step2d.noise_launches = 0
fused_adam_step2d.psi0_launches = 0
fused_adam_step2d.cluster_launches = 0
fused_adam_step2d.group_launches = 0
fused_adam_step2d.sweep_launches = 0
