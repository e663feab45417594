"""The composed step as a captured graph (``optim/angle_opt.py:
ComposedGraph``), on the CPU.

- A step fed its pre-drawn noise realizations (``predraw_noise``, the
  buffers a graph replays from) equals the step that draws them itself
  from its per-tag generators, bit for bit, on the plain versions: shot
  noise (e_new's offsets drawn for one start), depolarizing noise over
  two trajectories, and a moved e_new tag.
- The graph's bookkeeping with its capture stubbed (here a "replay" runs
  the step again on the static buffers, which is what a CUDA graph
  replays): one shape key is captured once and reused, every call equals
  the eager step on its own inputs bit for bit (so no call reads another
  call's inputs or realizations from stale buffers), and a new shape
  recaptures; without noise (su4 tapes), with shot noise and with two
  trajectories.  On a device without CUDA graphs the capture raises
  (nothing falls back to the eager loop).
- A float32 and a float64 entry live side by side in one graph, and a
  ``quiet`` step (noise off, for tapes that carry a quenched realization)
  is its own entry, equal to a noiseless optimizer's step bit for bit.
"""

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    ComposedGraph,
    make_multistarts,
)
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum

SU4 = (GateKind.RXX, GateKind.RYY, GateKind.RZZ, GateKind.RX, GateKind.RY,
       GateKind.RZ)
CNOT = (GateKind.CX, GateKind.RX, GateKind.RY, GateKind.RZ)
MODES = {"su4": (dict(enable_2q=True), SU4),
         "shot": (dict(noise_mode="shot", n_shots=64), CNOT),
         "traj2": (dict(noise_mode="depolarizing", n_traj=2, noise_p1=0.2,
                        noise_p2=0.3), CNOT)}
ITERS = 3


def _pauli(n, seed=0, k=10):
    rng = np.random.default_rng(seed)
    strings = ["I" * n] + ["".join(rng.choice(list("IXYZ"), size=n))
                           for _ in range(k)]
    return PauliSum.from_strings(strings, rng.normal(size=k + 1), n)


def _args(n, n_env, s_n, cap, kinds, seed):
    """Step arguments without the H operands: random tapes (old, new = old
    plus an RY), the identity angle map, a random unit psi0 (1, D),
    float32 starts and active."""
    rng = np.random.default_rng(seed)
    olds, news, x0s, n_rots = [], [], [], []
    for _ in range(n_env):
        old, new = GateTape(n, cap, cap), GateTape(n, cap, cap)
        for _ in range(int(rng.integers(cap // 2, cap))):
            k = kinds[int(rng.integers(len(kinds)))]
            t = int(rng.integers(n))
            c = (int((t + 1 + rng.integers(n - 1)) % n)
                 if k in (GateKind.CX, *SU4[:3]) else -1)
            ang = float(rng.normal()) if k != GateKind.CX else 0.0
            old.add(k, t, c, ang)
            new.add(k, t, c, ang)
        new.add(GateKind.RY, int(rng.integers(n)))
        olds.append(old.arrays())
        news.append(new.arrays())
        x0s.append(old.x0())
        n_rots.append(old.n_rots)

    def stack(tapes):
        return tuple(torch.as_tensor(np.stack([t[k] for t in tapes]),
                                     dtype=torch.int32) for k in range(4))
    maps = torch.as_tensor(np.stack([np.where(np.arange(cap) < k,
                                              np.arange(cap), -1)
                                     for k in n_rots]), dtype=torch.int32)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)
    f32 = dict(dtype=torch.float32)
    active = (torch.arange(cap)[None, :]
              < torch.as_tensor(n_rots)[:, None]).float()
    starts = make_multistarts(torch.as_tensor(np.stack(x0s), **f32), active,
                              s_n, s_n // 4, 0.1,
                              torch.Generator().manual_seed(seed))
    return (stack(olds), stack(news), maps,
            torch.as_tensor(psi0.real[None], **f32),
            torch.as_tensor(psi0.imag[None], **f32), starts,
            active[:, None, :].contiguous())


def _eager(opt, args, seed, **kw):
    old, new, maps, p0re, p0im, starts, active = args
    return opt._fused_step_composed(
        old, new, maps, p0re, p0im, opt._h_apply(torch.float32), starts,
        active, iters=ITERS, lr=0.1, seed=seed, plain=True, **kw)


@pytest.mark.parametrize("mode", ["shot", "traj2"])
@pytest.mark.parametrize("enew_tag", [None, 17])
def test_predrawn_realizations_give_the_drawn_step(mode, enew_tag):
    kw, kinds = MODES[mode]
    opt = AngleOptimizer(_pauli(4), device="cpu", **kw)
    args = _args(4, 3, 3, 8, kinds, seed=1)
    draws = opt.predraw_noise(args[0][0], args[1][0], 3, 3, iters=ITERS,
                              seed=5, enew_tag=enew_tag)
    assert len(draws) == ITERS + 2
    x_d, e_d = _eager(opt, args, 5, enew_tag=enew_tag)
    x_p, e_p = _eager(opt, args, 0, draws=draws)
    assert torch.equal(x_d, x_p) and torch.equal(e_d, e_p)
    x_o, e_o = _eager(opt, args, 6, enew_tag=enew_tag)   # other draws
    assert not torch.equal(e_o, e_d)


class HostGraph(ComposedGraph):
    """The graph with its capture stubbed: the warm-up's result, and a
    "replay" that runs the step again on the static buffers."""

    def _record(self, run):
        return run(), run


@pytest.mark.parametrize("mode", list(MODES))
def test_one_capture_per_shape_and_no_stale_buffers(mode):
    kw, kinds = MODES[mode]
    opt = AngleOptimizer(_pauli(4), device="cpu", **kw)
    graph = HostGraph(opt)
    batches = [_args(4, 3, 3, 8, kinds, seed=s) for s in (1, 2, 1)]
    for i, (args, seed) in enumerate(zip(batches, (5, 6, 7))):
        x_g, e_g = graph(*args, iters=ITERS, lr=0.1, seed=seed)
        x_e, e_e = _eager(opt, args, seed)
        assert torch.equal(x_g, x_e) and torch.equal(e_g, e_e), i
        assert graph.captures == 1
    other = _args(4, 3, 2, 8, kinds, seed=3)              # S = 2: a new key
    x_g, e_g = graph(*other, iters=ITERS, lr=0.1, seed=8)
    x_e, e_e = _eager(opt, other, 8)
    assert torch.equal(x_g, x_e) and torch.equal(e_g, e_e)
    assert graph.captures == 2 and len(graph.entries) == 2
    graph(*batches[0], iters=ITERS, lr=0.2, seed=5)       # lr: a new key
    assert graph.captures == 3


def test_capture_needs_a_cuda_device():
    opt = AngleOptimizer(_pauli(4), device="cpu", enable_2q=True)
    args = _args(4, 2, 2, 8, SU4, seed=1)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        ComposedGraph(opt)(*args, iters=ITERS, lr=0.1)


def test_float32_and_float64_graphs_side_by_side():
    """One optimizer's graph holds a float32 and a float64 entry at the
    same shapes (the key carries the starts' dtype): each call equals the
    eager step at its own dtype bit for bit, in that dtype, and a second
    call of either reuses its capture."""
    kw, kinds = MODES["su4"]
    opt = AngleOptimizer(_pauli(4), device="cpu", **kw)
    graph = HostGraph(opt)
    args32 = _args(4, 3, 3, 8, kinds, seed=1)
    args64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                   else a for a in args32)
    for args, dtype in ((args32, torch.float32), (args64, torch.float64),
                        (args32, torch.float32), (args64, torch.float64)):
        old, new, maps, p0re, p0im, starts, active = args
        x_g, e_g = graph(*args, iters=ITERS, lr=0.1, seed=5)
        x_e, e_e = opt._fused_step_composed(
            old, new, maps, p0re, p0im, opt._h_apply(dtype), starts, active,
            iters=ITERS, lr=0.1, seed=5)
        assert x_g.dtype == dtype and e_g.dtype == dtype
        assert torch.equal(x_g, x_e) and torch.equal(e_g, e_e)
    assert graph.captures == 2 and len(graph.entries) == 2


def test_quiet_step_runs_without_noise_as_its_own_entry():
    """``quiet``: the step of an optimizer with depolarizing noise on tapes
    that carry a quenched realization (``noise_resample='step'`` on the
    composed engine) runs without noise -- the graph's call equals the
    eager quiet step and a noiseless optimizer's step on the same inputs
    bit for bit -- and is its own graph entry beside the noisy step at the
    same shapes."""
    pauli = _pauli(4)
    opt = AngleOptimizer(pauli, device="cpu", noise_mode="depolarizing",
                         noise_p1=0.2, noise_p2=0.3)
    plain = AngleOptimizer(pauli, device="cpu")
    graph = HostGraph(opt)
    args = _args(4, 3, 3, 8, CNOT, seed=4)
    old, new, maps, p0re, p0im, starts, active = args
    x_g, e_g = graph(*args, iters=ITERS, lr=0.1, seed=5, quiet=True)
    for o, kw in ((opt, dict(quiet=True)), (plain, {})):
        x_e, e_e = o._fused_step_composed(
            old, new, maps, p0re, p0im, o._h_apply(starts.dtype), starts,
            active, iters=ITERS, lr=0.1, seed=5, **kw)
        assert torch.equal(x_g, x_e) and torch.equal(e_g, e_e)
    x_n, e_n = graph(*args, iters=ITERS, lr=0.1, seed=5)
    assert not torch.equal(e_n, e_g)                 # the noisy step differs
    assert graph.captures == 2 and len(graph.entries) == 2
