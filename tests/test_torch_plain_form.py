"""The plain version's sweeps (``ops/fused_adam.py``), which every fused
kernel is held against, against their term-by-term form, bit for bit.

The plain version takes its products and sums in fewer, larger tensor
operations than one per term, because its time is mostly the host's cost
of launching them: ``flip_h`` gathers the partners of several flip groups
at once, ``_apply_u`` selects and multiplies all eight parts of a gate at
once, and the adjoint sweep takes U^H and U^T once.  Each value is still
the same IEEE operation on the same operands in the same order, so the
results must equal, bit for bit, those of the forms below: one group, one
gate and one term at a time.

The tape kernels' plain versions (``ops/apply_tape.py``) make every
gate's coefficients (angles, cos and sin, the 2x2 entries) for all gates
at once (``_Tape``); a gate then takes slices of them.  They are held, bit
for bit, to the same gates with the coefficients made a gate at a time.
"""

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.ops import apply_tape as at
from tensorrl_qas_tpu_torch.ops import fused_adam as fa
from tensorrl_qas_tpu_torch.sim.noise import apply_pauli, noise_thresholds
from tests.test_torch_apply_tape import _case
from tests.test_torch_fused_adam import _ints, _random_batch


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flip_h_by_group(wre, wim, flips):
    col = torch.arange(wre.shape[-1], device=wre.device)
    perms = [col ^ f for f in flips.tolist()]

    def apply(re, im):
        hre = torch.zeros_like(re)
        him = torch.zeros_like(im)
        for wr, wi, perm in zip(wre, wim, perms):
            pre, pim = re.index_select(-1, perm), im.index_select(-1, perm)
            hre = hre + wr * pre - wi * pim
            him = him + wr * pim + wi * pre
        return hre, him
    return apply


def _apply_u_by_term(re, im, pre, pim, b0, act, coeffs):
    u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i = coeffs
    dr = torch.where(b0, u00r, u11r)
    di = torch.where(b0, u00i, u11i)
    fr = torch.where(b0, u01r, u10r)
    fi = torch.where(b0, u01i, u10i)
    nre = dr * re - di * im + fr * pre - fi * pim
    nim = dr * im + di * re + fr * pim + fi * pre
    return torch.where(act, nre, re), torch.where(act, nim, im)


def _gate(plan, g):
    return (plan.partner[:, g, None, :].expand(plan.shape),
            plan.b0[:, g, None, :], plan.act[:, g, None, :])


def _forward_by_term(plan, u, re, im, errors=None):
    errors = errors or {}
    for g in plan.live:
        idx, b0, act = _gate(plan, g)
        re, im = _apply_u_by_term(re, im, re.gather(2, idx),
                                  im.gather(2, idx), b0, act,
                                  u[..., g:g + 1].unbind(0))
        for k, q in errors.get(g, ()):
            re, im = apply_pauli(re, im, k[:, None], q[:, None])
    return re, im


def _backward_by_term(plan, u, x, re, im, lre, lim, errors=None):
    errors = errors or {}
    dx = torch.zeros_like(x)
    sel = plan.sel
    for g in reversed(plan.live):
        for k, q in errors.get(g, ()):
            re, im = apply_pauli(re, im, k[:, None], q[:, None])
            lre, lim = apply_pauli(lre, lim, k[:, None], q[:, None],
                                   transpose=True)
        idx, b0, act = _gate(plan, g)
        u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i = u[..., g:g + 1
                                                           ].unbind(0)
        sgn = torch.where(b0, 1.0, -1.0).to(re.dtype)
        pre, pim = re.gather(2, idx), im.gather(2, idx)
        rx, ry, rz = (k[..., g:g + 1] for k in sel)
        pr = rx * pre + ry * (sgn * pim) + rz * (sgn * re)
        pi = rx * pim - ry * (sgn * pre) + rz * (sgn * im)
        cg = 0.5 * torch.sum(act.to(re.dtype) * (pr * lim + pi * lre),
                             dim=-1)
        slot = plan.slot[:, g]
        has = (slot >= 0).view(-1, 1)
        sidx = slot.clamp(min=0).view(-1, 1, 1).expand(*cg.shape, 1)
        dx.scatter_add_(2, sidx, torch.where(has, cg, 0.0)[..., None])
        ch = (u00r, -u00i, u10r, -u10i, u01r, -u01i, u11r, -u11i)  # U^H
        ct = (u00r, u00i, u10r, u10i, u01r, u01i, u11r, u11i)      # U^T
        re, im = _apply_u_by_term(re, im, pre, pim, b0, act, ch)
        lre, lim = _apply_u_by_term(lre, lim, lre.gather(2, idx),
                                    lim.gather(2, idx), b0, act, ct)
    return dx


def _tapes(n, n_env, cap, seed):
    """Random tapes (rotations, CNOTs, fixed gates) whose last positions
    are the same gate in every env: a CNOT, a fixed gate and a rotation
    (the in_state families' warm start is such a prefix)."""
    rng = np.random.default_rng(seed)
    old, new, maps, x0, n_rots = _random_batch(rng, n, n_env, cap)
    old = [a.copy() for a in old]
    kind, tq, cq, slot = old
    for g, (k, t, c) in zip((cap - 5, cap - 4, cap - 3),
                            ((GateKind.CX, 0, 1), (GateKind.H, 1, -1),
                             (GateKind.RY, 2, -1))):
        kind[:, g], tq[:, g], cq[:, g] = int(k), t, c
        slot[:, g] = slot[:, g] if k == GateKind.RY else -1
    slot[:, cap - 3] = np.where(slot[:, cap - 3] >= 0, slot[:, cap - 3], 0)
    return _ints(old), _ints(new), torch.as_tensor(maps), x0, n_rots


def _planes(rng, shape, dtype):
    return tuple(torch.as_tensor(rng.normal(size=shape), dtype=dtype)
                 for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("noisy", [False, True])
def test_sweeps_match_the_term_by_term_form(dtype, noisy, one_thread):
    n, n_env, s_n, cap = 5, 4, 3, 16
    old, _, _, _, _ = _tapes(n, n_env, cap, seed=3)
    rng = np.random.default_rng(4)
    d = 1 << n
    plan = fa._Plan(tuple(a.long() for a in old), s_n, torch.arange(d),
                    dtype)
    x = torch.as_tensor(rng.normal(size=(n_env, s_n, cap)), dtype=dtype)
    u = plan.coeffs(x)
    re, im = _planes(rng, (n_env, s_n, d), dtype)
    lre, lim = _planes(rng, (n_env, s_n, d), dtype)
    errors = None
    if noisy:
        seeds = torch.as_tensor(rng.integers(0, 2**31, size=(n_env, 2)),
                                dtype=torch.int32)
        errors = fa._noise_ops(old, seeds, (0,), noise_thresholds(0.2, 0.3),
                               fa.philox_words)[0]
        assert errors, "no error fired: the noisy case would test nothing"
    fwd = fa._forward(plan, u, re, im, errors)
    ref = _forward_by_term(plan, u, re, im, errors)
    for a, b in zip(fwd, ref):
        assert torch.equal(a, b)
    dx = fa._backward(plan, u, x, *fwd, lre, lim, errors)
    dx_ref = _backward_by_term(plan, u, x, *ref, lre, lim, errors)
    assert torch.equal(dx, dx_ref)
    assert bool(dx.abs().sum() > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("real", [True, False])
def test_flip_h_matches_the_group_by_group_loop(dtype, real, monkeypatch,
                                                one_thread):
    n, groups = 6, 7
    d = 1 << n
    rng = np.random.default_rng(5)
    flips = torch.as_tensor(rng.choice(d, size=groups, replace=False))
    wre = torch.as_tensor(rng.normal(size=(groups, d)), dtype=dtype)
    wim = (torch.zeros_like(wre) if real else
           torch.as_tensor(rng.normal(size=(groups, d)), dtype=dtype))
    re, im = _planes(rng, (2, 3, d), dtype)
    ref = _flip_h_by_group(wre, wim, flips)(re, im)
    # blocks of 3 groups, then of 1, then all groups in one block
    for block in (3 * 2 * 3 * d, 1, 1 << 24):
        monkeypatch.setattr(fa, "FLIP_BLOCK", block)
        out = fa.flip_h(wre, wim, flips)(re, im)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("noisy", [False, True])
def test_step_matches_the_term_by_term_form(noisy, monkeypatch, one_thread):
    """The whole plain step (Adam, the best iterate, the remap and e_new)
    on the module's sweeps and on the term-by-term ones."""
    n, n_env, s_n, cap, iters = 4, 3, 2, 12, 3
    old, new, maps, x0, n_rots = _tapes(n, n_env, cap, seed=8)
    rng = np.random.default_rng(9)
    d = 1 << n
    groups = 5
    flips = torch.as_tensor(rng.choice(d, size=groups, replace=False))
    wre = torch.as_tensor(rng.normal(size=(groups, d)), dtype=torch.float32)
    wim = torch.as_tensor(rng.normal(size=(groups, d)), dtype=torch.float32)
    p0re, p0im = _planes(rng, (1, d), torch.float32)
    starts = torch.as_tensor(rng.normal(size=(n_env, s_n, cap)),
                             dtype=torch.float32)
    active = (torch.arange(cap)[None, None, :]
              < torch.as_tensor(n_rots)[:, None, None]).float()
    noise = ({"noise": (0.05, 0.1),
              "seeds": torch.as_tensor([[1, 2], [3, 4], [5, 6]],
                                       dtype=torch.int32)}
             if noisy else {})
    args = (old, new, maps.int(), p0re, p0im, wre, wim, flips, starts, active)
    out = fa.fused_adam_step_reference(*args, iters=iters, lr=0.1, **noise)
    monkeypatch.setattr(fa, "flip_h", _flip_h_by_group)
    monkeypatch.setattr(fa, "_forward", _forward_by_term)
    monkeypatch.setattr(fa, "_backward", _backward_by_term)
    ref = fa.fused_adam_step_reference(*args, iters=iters, lr=0.1, **noise)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


class _RawTape(at._Tape):
    """``_Tape`` that keeps what it was made from."""

    def __init__(self, tape, angles):
        super().__init__(tape, angles)
        self.raw = (tape, angles)


class _GateAlone(at._Gate):
    """``_Gate`` whose coefficients are made for that gate alone."""

    def __init__(self, tape, g, col):
        raw, angles = tape.raw
        super().__init__(_RawTape(tuple(a[:, g:g + 1] for a in raw),
                                  angles), 0, col)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("woven", [False, True])
def test_tape_plain_versions_match_the_gate_at_a_time_form(
        dtype, woven, monkeypatch, one_thread):
    """B3f's and B3b's plain versions on tapes of every gate class
    (controlled rotations, CX, RXX / RYY / RZZ, and with ``woven`` error
    Paulis) against themselves with each gate's coefficients made for that
    gate alone."""
    tape, re, im, angles, gre, gim = _case(7, n=5, n_env=3, s_n=2,
                                           n_gates=26, extend=woven)
    tape = tuple(torch.as_tensor(a) for a in tape)
    re, im, angles, gre, gim = (torch.as_tensor(a, dtype=dtype)
                                for a in (re, im, angles, gre, gim))

    def run():
        out = at.apply_tape_fwd_plain(re, im, *tape, angles)
        return (*out, *at.apply_tape_bwd_plain(*out, gre, gim, *tape,
                                               angles))
    out = run()
    monkeypatch.setattr(at, "_Tape", _RawTape)
    monkeypatch.setattr(at, "_Gate", _GateAlone)
    ref = run()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
