"""Amplitude-sharded statevector simulation over a device mesh.

Counterpart of ``tensorrl_qas_tpu/parallel/sharded_sim.py``.  The 2^n
statevector is sharded over the mesh's ``amp`` axis on its top index
bits: with D = 2^d amp shards, shard r holds the amplitudes whose global
index is r * 2^(n-d) + local.  Qubits 0..n-d-1 are local to a shard,
qubits n-d..n-1 are its "device" bits.  Batch rows (optimizer starts) are
split over the ``dp`` axis.  A sharded value is a grid ``blocks[a][d]``
(``parallel/mesh.py``): block (a, d) holds amp shard a of the rows of dp
column d, (rows, 2^(n-d)) or, for one state, (2^(n-d),) in column 0.

The tape is host numpy, so each gate is dispatched on the host, where
the JAX package selects at run time among exchanges with every device
bit (its ``ppermute`` needs a static permutation and the target is a
traced value):

- a gate on a local qubit is a local update: no exchange;
- a gate whose target is a device bit needs its partner block from
  shard r ^ 2^j: exactly one ``ppermute`` (none for the diagonal RZ and
  Z, whose update is a phase that shard r knows from its own bit);
- a control on a device bit is known on the host for each shard: the
  shard applies the gate or keeps its block;
- RXX / RYY / RZZ (``enable_2q``) flip the bits of both qubits: one
  exchange with shard r ^ (their device bits), none for RZZ.

H psi and the energy group the Pauli terms by the device part g of their
flip mask, sorted by g (``self.groups``, the JAX package's order): a
group costs one exchange with shard r ^ g; within it the terms that flip
the same local bits add into one coefficient plane a shard (the flip
groups of ``ops/fused_adam2d.py:pauli_flip_groups``, cut to the shard),
so a group is a few operations per local flip instead of several per
term.  Partial sums go through ``Mesh.psum`` in mesh order.

``value_and_grad_batched`` is the adjoint sweep of the JAX package's
``_build_vag_batched``: forward, lambda = H psi, then un-apply each gate
on (psi, lambda) while accumulating Im<lambda|G|psi>, over the psum'd
norm (the Rayleigh quotient).  Unlike the JAX package's sweep, whose
generator of a controlled rotation is the bare Pauli (the fault that
``ROADMAP.md``, C records), the generator here is the Pauli restricted
to the control-set subspace, as in ``sim/adjoint.py``.

``shard_state`` / ``unshard_state`` carry a statevector (batch) into the
shards and back (the JAX package's ``device_put`` with ``P("dp",
"amp")``).
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrl_qas_tpu_torch import complex_dtype
from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.sim.apply import gate_matrix
from tensorrl_qas_tpu_torch.utils.bits import parity

_NONE, _RX, _RY, _RZ = (int(GateKind.NONE), int(GateKind.RX),
                        int(GateKind.RY), int(GateKind.RZ))
_CX, _X, _Y, _Z, _H = (int(GateKind.CX), int(GateKind.X), int(GateKind.Y),
                       int(GateKind.Z), int(GateKind.H))
_RXX, _RYY, _RZZ = (int(GateKind.RXX), int(GateKind.RYY),
                    int(GateKind.RZZ))
_DIAGONAL = (_RZ, _Z)
_FLIP = (_CX, _X)
_PAULI_OF = {_RX: _X, _RY: _Y, _RZ: _Z}


def _coeff_table() -> np.ndarray:
    """(kinds, 3, 4) complex: a gate's entries (u00, u01, u10, u11) are
    A cos(theta/2) + B sin(theta/2) + C, read from ``sim/apply.py:
    gate_matrix``: a rotation's A is its entries at 0 and B half their
    change from -pi to pi (exact: the cosine parts cancel), a fixed
    gate's C its entries.  RXX / RYY / RZZ, which ``gate_matrix`` does
    not cover, have (cos, -i sin, 0, 0): the weights of x and of
    (P_t P_c) x."""
    def entries(kind, theta):
        u = gate_matrix(kind, torch.tensor(theta, dtype=torch.float64))
        return np.array([complex(e) for e in u])

    t = np.zeros((_RZZ + 1, 3, 4), dtype=np.complex128)
    for k in range(_RXX):
        if k in _PAULI_OF:
            t[k, 0] = entries(k, 0.0)
            t[k, 1] = (entries(k, np.pi) - entries(k, -np.pi)) / 2
        else:
            t[k, 2] = entries(k, 0.0)
    for k in (_RXX, _RYY, _RZZ):
        t[k, 0] = (1, 0, 0, 0)
        t[k, 1] = (0, -1j, 0, 0)
    return t


_TABLE = _coeff_table()


def _host_tape(kind, tq, cq, slot):
    """The tape's (kind, target, control, slot) per gate as Python ints."""
    arrs = [np.asarray(torch.as_tensor(a).cpu(), dtype=np.int64)
            for a in (kind, tq, cq, slot)]
    return [tuple(int(v) for v in g) for g in zip(*arrs)]


def _split(x, bits, nloc: int):
    """``x`` (..., 2^nloc) viewed with each bit of ``bits`` as an axis of
    size 2; returns (view, those axes as negative dims, highest bit
    first)."""
    shape, prev = [], nloc
    for q in sorted(bits, reverse=True):
        shape += [1 << (prev - q - 1), 2]
        prev = q
    shape.append(1 << prev)
    m = len(shape)
    return (x.reshape(*x.shape[:-1], *shape),
            [i - m for i in range(1, m, 2)])


def _flip(x, bits, nloc: int):
    """x[..., l ^ mask] for the local bits ``bits`` of the mask (a new
    tensor; ``x`` itself when there are none)."""
    if not bits:
        return x
    v, dims = _split(x, bits, nloc)
    return v.flip(dims).reshape(x.shape)


def _bits(mask: int) -> list[int]:
    return [q for q in range(mask.bit_length()) if mask >> q & 1]


def shard_state(psi, mesh, dtype=None):
    """A statevector (2^n,) or a batch (B, 2^n), numpy or a tensor, as a
    sharded grid: amplitudes over ``amp`` (the top bits), rows over ``dp``
    (B divisible by the dp axis); one state lives in dp column 0."""
    psi = torch.as_tensor(psi)
    if dtype is not None:
        psi = psi.to(dtype)
    n_amp, n_dp = mesh.shape["amp"], mesh.shape["dp"]
    dim = psi.shape[-1]
    if dim % n_amp:
        raise ValueError(f"2^n = {dim} does not split over {n_amp} amp "
                         "shards")
    block = dim // n_amp
    if psi.dim() == 1:
        return [[psi[a * block:(a + 1) * block].to(mesh.devices[a][0])]
                for a in range(n_amp)]
    rows = psi.shape[0]
    if rows % n_dp:
        raise ValueError(f"{rows} rows do not split over {n_dp} dp shards")
    b = rows // n_dp
    return [[psi[d * b:(d + 1) * b, a * block:(a + 1) * block].to(
        mesh.devices[a][d]) for d in range(n_dp)] for a in range(n_amp)]


def unshard_state(shards, mesh):
    """The inverse of ``shard_state``: one tensor on the mesh's lead
    device, (2^n,) or (B, 2^n)."""
    lead = mesh.lead
    cols = [torch.cat([shards[a][d].to(lead) for a in range(len(shards))],
                      dim=-1) for d in range(len(shards[0]))]
    return cols[0] if cols[0].dim() == 1 else torch.cat(cols, dim=0)


class ShardedSimulator:
    """Statevector engine over a mesh with an ``amp`` axis.

    Args:
      mesh: ``parallel.mesh.Mesh``; amplitudes over ``amp``, batch rows
        over ``dp``.
      n_qubits: total qubits; the amp axis size must be a power of 2 that
        leaves at least one local qubit.
      pauli: the Hamiltonian (``sim.expectation.PauliSum``), grouped by
        device-bit flip mask at setup.
      dtype: statevector dtype (default: complex128 on a CPU mesh,
        complex64 on CUDA, the port's policy).
      enable_2q: tapes may hold RXX / RYY / RZZ (the su4 gate set).
    """

    def __init__(self, mesh, n_qubits: int, pauli, dtype=None,
                 enable_2q: bool = False):
        self.mesh = mesh
        self.n = n_qubits
        self.dtype = dtype or complex_dtype(mesh.lead)
        self.rdtype = (torch.float32 if self.dtype == torch.complex64
                       else torch.float64)
        self.enable_2q = enable_2q
        self.D = mesh.shape["amp"]
        self.d = int(np.log2(self.D))
        if 2 ** self.d != self.D:
            raise ValueError("amp axis size must be a power of 2")
        self.nloc = n_qubits - self.d
        if self.nloc < 1:
            raise ValueError("statevector too small for this mesh")
        self.block = 1 << self.nloc

        # Pauli terms grouped by device-bit flip mask, sorted by it (the
        # JAX package's groups, entry by entry), and each group's terms at
        # full precision for the planes: (w iphase, local flip, sign mask)
        weights = np.asarray(pauli.weights)
        flip = np.asarray(pauli.flip)
        sign_mask = np.asarray(pauli.sign_mask)
        iphase = np.asarray(pauli.iphase)
        coef = weights.astype(np.float64) * iphase.astype(np.complex128)
        fg = (flip >> self.nloc).astype(np.int32)
        rdt = np.float32 if self.dtype == torch.complex64 else np.float64
        cdt = np.complex64 if self.dtype == torch.complex64 else np.complex128
        self.groups, self._terms = [], []
        for g in sorted(set(fg.tolist())):
            sel = fg == g
            floc = (flip[sel] & (self.block - 1)).astype(np.int32)
            self.groups.append((int(g), weights[sel].astype(rdt), floc,
                                sign_mask[sel].astype(np.int32),
                                iphase[sel].astype(cdt)))
            self._terms.append(list(zip(coef[sel].tolist(), floc.tolist(),
                                        sign_mask[sel].tolist())))
        self._planes = {}      # (shard, device) -> [[(bits, W)]] a group
        self._masks = {}       # (device, bit) -> bool (block,)
        self._signs = {}       # (device, n bits, factor) -> small tensor
        self._table = {}       # device -> the (kinds, 3, 4) table

    # -- states ------------------------------------------------------------

    def zero_state(self):
        """|0...0> sharded over the amp axis (dp column 0)."""
        return self._zeros(())

    def zero_state_batched(self, batch: int):
        """``batch`` rows of |0...0>, rows over dp, amplitudes over amp."""
        n_dp = self.mesh.shape["dp"]
        if batch % n_dp:
            raise ValueError(f"{batch} rows do not split over {n_dp} dp "
                             "shards")
        return self._zeros((batch // n_dp,), n_dp)

    def _zeros(self, rows, n_cols: int = 1):
        grid = []
        for a in range(self.D):
            line = []
            for d in range(n_cols):
                blk = torch.zeros((*rows, self.block), dtype=self.dtype,
                                  device=self.mesh.devices[a][d])
                if a == 0:
                    blk[..., 0] = 1.0
                line.append(blk)
            grid.append(line)
        return grid

    # -- host-side helpers -------------------------------------------------

    def _mask(self, dev, bit: int):
        key = (dev, bit)
        if key not in self._masks:
            idx = torch.arange(self.block, device=dev)
            self._masks[key] = ((idx >> bit) & 1).bool()
        return self._masks[key]

    def _sign(self, x, bits, factor: float):
        """factor * (-1)^(parity of the local ``bits`` of l) * x[..., l]."""
        if not bits:
            return x if factor == 1.0 else -x
        key = (x.device, x.dtype, len(bits), factor)
        s = self._signs.get(key)
        if s is None:
            s = np.full((), factor)
            for _ in bits:
                s = np.multiply.outer(s, [1.0, -1.0])
            s = torch.as_tensor(s.reshape([2, 1] * len(bits)),
                                dtype=x.dtype, device=x.device)
            self._signs[key] = s
        v, _ = _split(x, bits, self.nloc)
        return (v * s).reshape(x.shape)

    def _coeffs(self, angles, tape, dev):
        """Per-gate entries (..., G, 4) of the tape at ``angles`` (..., R)
        and of its inverse (the angles negated): A c + B s + C and
        A c - B s + C."""
        table = self._table.get(dev)
        if table is None:
            table = torch.as_tensor(_TABLE, dtype=self.dtype, device=dev)
            self._table[dev] = table
        kinds = torch.as_tensor([g[0] for g in tape], device=dev)
        slots = torch.as_tensor([g[3] for g in tape], device=dev)
        angles = angles.to(device=dev, dtype=self.rdtype)
        theta = torch.where(slots >= 0, angles[..., slots.clamp(min=0)], 0.0)
        c = torch.cos(0.5 * theta)[..., None]
        s = torch.sin(0.5 * theta)[..., None]
        a, b, k = table[kinds].unbind(-2)                  # (G, 4) each
        return a * c + b * s + k, a * c - b * s + k

    # -- gates on one shard ------------------------------------------------

    def _partner_mask(self, gate) -> int:
        """The device bits whose exchange the gate (its un-apply and its
        generator too) needs: 0 for a local or diagonal gate."""
        kind, t, c, _ = gate
        if kind == _NONE or kind in _DIAGONAL or kind == _RZZ:
            return 0
        if kind >= _RXX:
            return ((1 << t) | (1 << c)) >> self.nloc
        return (1 << t) >> self.nloc

    def _pair(self, x, xp, r: int, gate):
        """(P_t P_c) x for RXX / RYY / RZZ: XX flips both bits, YY flips
        them with -(-1)^parity, ZZ phases by (-1)^parity (the conventions
        of ``sim/apply.py:_apply_two_pauli_rot``); ``xp`` is the block of
        shard r ^ (their device bits)."""
        kind, t, c, _ = gate
        m = (1 << t) | (1 << c)
        loc = _bits(m & (self.block - 1))
        dev_sign = -1.0 if bin(r & (m >> self.nloc)).count("1") & 1 else 1.0
        if kind == _RZZ:
            return self._sign(x, loc, dev_sign)
        flipped = _flip(xp if xp is not None else x, loc, self.nloc)
        if kind == _RXX:
            return flipped
        return self._sign(flipped, loc, -dev_sign)

    def _gate(self, x, xp, r: int, gate, u):
        """One gate on shard r's block ``x`` (..., L) with entries ``u``
        (..., 4) broadcasting with x[..., 0]; ``xp``: the partner block
        when ``_partner_mask`` asks for one.  Never writes into ``x`` or
        ``xp``."""
        kind, t, c, _ = gate
        if kind == _NONE:
            return x
        if kind >= _RXX:
            if not self.enable_2q:
                raise ValueError("RXX/RYY/RZZ need enable_2q=True")
            return (u[..., 0, None] * x
                    + u[..., 1, None] * self._pair(x, xp, r, gate))
        if c >= self.nloc and not (r >> (c - self.nloc)) & 1:
            return x                          # control bit clear on shard r
        if t >= self.nloc:
            b = (r >> (t - self.nloc)) & 1
            diag, off = (u[..., 3], u[..., 2]) if b else (u[..., 0],
                                                          u[..., 1])
            if kind in _DIAGONAL:
                out = diag[..., None] * x
            elif kind in _FLIP:
                out = xp
            else:
                out = diag[..., None] * x + off[..., None] * xp
        else:
            v, _ = _split(x, [t], self.nloc)
            if kind in _FLIP:
                out = v.flip(-2).reshape(x.shape)
            else:
                a0, a1 = v[..., 0, :], v[..., 1, :]
                w = u[..., None, None, :]
                if kind in _DIAGONAL:
                    out = torch.stack((w[..., 0] * a0, w[..., 3] * a1), -2)
                else:
                    out = torch.stack((w[..., 0] * a0 + w[..., 1] * a1,
                                       w[..., 2] * a0 + w[..., 3] * a1), -2)
                out = out.reshape(x.shape)
        if 0 <= c < self.nloc:
            out = torch.where(self._mask(x.device, c), out, x)
        return out

    def _generator(self, p, pp, r: int, gate):
        """G |p> for the generator G of a rotation gate: its Pauli on the
        target restricted to the control-set subspace (the full Pauli
        without a control), or the Pauli pair of RXX / RYY / RZZ; None
        where it is zero on shard r (a clear control bit there)."""
        kind, t, c, _ = gate
        if kind >= _RXX:
            return self._pair(p, pp, r, gate)
        if c >= self.nloc and not (r >> (c - self.nloc)) & 1:
            return None
        pauli = _PAULI_OF[kind]
        if t >= self.nloc:
            sign = -1.0 if (r >> (t - self.nloc)) & 1 else 1.0
            if pauli == _X:
                out = pp
            elif pauli == _Y:
                out = (-1j * sign) * pp
            else:
                out = p if sign > 0 else -p
        elif pauli == _X:
            out = _flip(p, [t], self.nloc)
        elif pauli == _Y:
            out = (-1j) * self._sign(_flip(p, [t], self.nloc), [t], 1.0)
        else:
            out = self._sign(p, [t], 1.0)
        if 0 <= c < self.nloc:
            out = torch.where(self._mask(p.device, c), out, 0.0)
        return out

    # -- tape application --------------------------------------------------

    def _cols(self, grid, angles):
        """Per dp column of ``grid``: the angle rows of that column, (R,)
        for one state or (rows, R)."""
        angles = torch.as_tensor(angles)
        if grid[0][0].dim() == 1:
            return [angles]
        b = grid[0][0].shape[0]
        return [angles[d * b:(d + 1) * b] for d in range(len(grid[0]))]

    def _tables(self, grid, angles, tape):
        """Entries of the tape's gates (and of their inverses) for every
        block of ``grid``, computed once per (column, device)."""
        out, memo = [], {}
        cols = self._cols(grid, angles)
        for a in range(len(grid)):
            line = []
            for d in range(len(grid[0])):
                dev = grid[a][d].device
                if (d, dev) not in memo:
                    memo[d, dev] = self._coeffs(cols[d], tape, dev)
                line.append(memo[d, dev])
            out.append(line)
        return out

    def _exchange(self, grid, mask: int):
        if not mask:
            return None
        return self.mesh.ppermute(
            grid, "amp", [(r, r ^ mask) for r in range(self.D)])

    def _apply(self, grid, tape, tables):
        """The tape on every block."""
        for gi, gate in enumerate(tape):
            if gate[0] == _NONE:
                continue
            part = self._exchange(grid, self._partner_mask(gate))
            grid = [[self._gate(grid[a][d],
                                None if part is None else part[a][d], a,
                                gate, tables[a][d][0][..., gi, :])
                     for d in range(len(grid[0]))]
                    for a in range(len(grid))]
        return grid

    def apply_tape(self, psi, kind, tq, cq, angle_slot, angles):
        """One sharded state through the tape at ``angles`` (R,)."""
        tape = _host_tape(kind, tq, cq, angle_slot)
        return self._apply(psi, tape, self._tables(psi, angles, tape))

    def apply_tape_batched(self, psi_batch, kind, tq, cq, angle_slot,
                           angles_batch):
        """(B, 2^n) sharded states through the tape, row i at
        ``angles_batch[i]`` (B, R)."""
        return self.apply_tape(psi_batch, kind, tq, cq, angle_slot,
                               angles_batch)

    # -- H psi and energies ------------------------------------------------

    def _shard_planes(self, r: int, dev):
        """Shard r's coefficient planes, group by group in ``self.groups``'
        order: [[(local flip bits, W (L,))]], W(l) = sum_k w_k iphase_k
        (-1)^parity((r 2^nloc + l) & sign_k) over the group's terms that
        flip those local bits, summed in float64 before the cast (a real
        plane where every imaginary part is zero)."""
        key = (r, dev)
        if key in self._planes:
            return self._planes[key]
        idx = torch.arange(self.block, device=dev)
        out = []
        for terms in self._terms:
            by_flip = {}
            for coef, f, sm in terms:
                sgn = 1.0 - 2.0 * parity(idx & (sm & (self.block - 1))
                                         ).double()
                if bin(r & (sm >> self.nloc)).count("1") & 1:
                    sgn = -sgn
                acc = by_flip.setdefault(f, [0.0, 0.0])
                acc[0] = acc[0] + coef.real * sgn
                acc[1] = acc[1] + coef.imag * sgn
            planes = []
            for f in sorted(by_flip):
                re, im = by_flip[f]
                if torch.is_tensor(im) and bool((im != 0).any()):
                    plane = torch.complex(re, im).to(self.dtype)
                else:
                    plane = re.to(self.rdtype)
                planes.append((_bits(f), plane))
            out.append(planes)
        self._planes[key] = out
        return out

    def _hpsi(self, grid):
        """Every block's part of H psi: one exchange a flip group."""
        acc = [[None] * len(grid[0]) for _ in grid]
        for gi, (g, *_) in enumerate(self.groups):
            src = grid if g == 0 else self._exchange(grid, g)
            for a in range(len(grid)):
                for d in range(len(grid[0])):
                    x = src[a][d]
                    for bits, w in self._shard_planes(a, x.device)[gi]:
                        term = w * _flip(x, bits, self.nloc)
                        acc[a][d] = (term if acc[a][d] is None
                                     else acc[a][d] + term)
        return acc

    def _energy_parts(self, grid, hpsi):
        """Per block: (Re<psi|H psi> over the block, ||block||^2)."""
        e = [[torch.real(torch.sum(grid[a][d].conj() * hpsi[a][d], -1))
              for d in range(len(grid[0]))] for a in range(len(grid))]
        n2 = [[torch.sum(blk.real ** 2 + blk.imag ** 2, -1) for blk in line]
              for line in grid]
        return e, n2

    def _gather(self, parts):
        """Row 0 of the mesh (every amp shard holds the same psum'd value)
        as one tensor on the lead device, columns in dp order."""
        vals = [parts[0][d].to(self.mesh.lead) for d in range(len(parts[0]))]
        return vals[0] if vals[0].dim() == 0 else torch.cat(vals, 0)

    def expectation(self, psi):
        """<psi|H|psi> / <psi|psi> of one sharded state (0-d, lead
        device)."""
        return self.expectation_batched(psi)

    def expectation_batched(self, psi_batch):
        """Per-row Rayleigh quotient of a sharded batch, (B,) on the lead
        device."""
        e, n2 = self._energy_parts(psi_batch, self._hpsi(psi_batch))
        e, n2 = self.mesh.psum(e, "amp"), self.mesh.psum(n2, "amp")
        return self._gather(e) / self._gather(n2)

    # -- adjoint value and gradient ----------------------------------------

    def value_and_grad_batched(self, psi_batch, kind, tq, cq, slot,
                               angles_batch):
        """Per-row energy (B,) and gradient (B, R) of the tape at
        ``angles_batch`` from the sharded states ``psi_batch``, by the
        adjoint sweep (module docstring), on the lead device."""
        tape = _host_tape(kind, tq, cq, slot)
        angles_batch = torch.as_tensor(angles_batch)
        tables = self._tables(psi_batch, angles_batch, tape)
        psi = self._apply(psi_batch, tape, tables)
        lam = self._hpsi(psi)
        e_loc, n2_loc = self._energy_parts(psi, lam)
        cols = self._cols(psi, angles_batch)
        grads = [[torch.zeros(cols[d].shape, dtype=self.rdtype,
                              device=psi[a][d].device)
                  for d in range(len(psi[0]))] for a in range(len(psi))]
        z = [[torch.stack([psi[a][d], lam[a][d]])
              for d in range(len(psi[0]))] for a in range(len(psi))]
        for gi in reversed(range(len(tape))):
            gate = tape[gi]
            if gate[0] == _NONE:
                continue
            part = self._exchange(z, self._partner_mask(gate))
            new = []
            for a in range(len(z)):
                line = []
                for d in range(len(z[0])):
                    zp = None if part is None else part[a][d]
                    if gate[3] >= 0:
                        gen = self._generator(z[a][d][0], None if zp is None
                                              else zp[0], a, gate)
                        if gen is not None:
                            gval = torch.imag(torch.sum(
                                z[a][d][1].conj() * gen, -1))
                            grads[a][d][..., gate[3]] += gval
                    line.append(self._gate(z[a][d], zp, a, gate,
                                           tables[a][d][1][..., gi, :]))
                new.append(line)
            z = new
        n2 = self._gather(self.mesh.psum(n2_loc, "amp"))
        e = self._gather(self.mesh.psum(e_loc, "amp")) / n2
        grad = self._gather(self.mesh.psum(grads, "amp")) / n2[..., None]
        return e, grad
