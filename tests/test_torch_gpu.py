"""The CUDA fused Adam kernels (v1 up to 9 qubits, v2 from 7; both take
flip-group planes of H) against their plain PyTorch versions, on the
card.  Marked ``gpu``; on a host
without a CUDA card each test skips itself (decided inside the test, so
every worker collects the same tests).  Run on the card's host, which
has no JAX for the root conftest.py, with:
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance 1e-5 on x_opt and e_new after 3 Adam iterations at 8 qubits:
both are float32 with the energy sums in float64; what remains is the
summation order of H psi and of the gradient rows.  Float32 noise decides
some outputs in any float32 implementation, so an env that differs may
instead lie within the plain version's own float32 noise
(``ops/fused_adam.py:agreement``, the rule chip_smoke.py applies);
deliberately wrong kernel results must fail that rule.  The v2 kernel is
held to the same rule at 7, 10, 11 (a random Pauli sum) and 12 qubits
(LiH) -- the register kernel, one CTA a start -- and at 13 (a random
Pauli sum, and the open Heisenberg chain), 14 and 16 (Heisenberg) -- the
cluster kernel, a cluster of 2, 4 and 16 CTAs a start, every launch
counted as its -- and at 17 and 18 (random Pauli sums) -- the group
kernel, a start of 32 and 64 CTAs in clusters that trade through global
memory -- and at 19 and 20 (random Pauli sums, complex W planes) -- the
sweep kernel, every start in device memory, swept by a cooperative grid;
at 12 also with every target and control on the qubits that start on warp
bits, and with 3 starts.  Two v2 launches agree bit for bit at 12, 13, 14
and 20 qubits, as do p = 0 and the noiseless kernel, and identical psi0
rows and the shared plane; the noise variant is held at 12, 14, 19 and
20.  A cluster that cannot be scheduled (more shared memory than a CTA
may have) raises, as does a group kernel's start that the card cannot
hold whole and a sweep kernel's CTA that fits nowhere; ptxas reports no
spills in the v2 kernels and the sweep kernel.  v1 is held at 4, 5, 8 and 9
qubits with 3, 8 and 16 starts (groups of a thread, of a few lanes and of
a warp a start; 16 starts at 9 qubits take two rounds), at 8 and 16
amplitudes a thread, and with a Pauli sum of D complex flip groups whose
planes do not fit in shared memory; at 8 qubits at both widths a
repeated launch, p = 0 and identical psi0 rows are bit for bit.

The noise variants (``noise=(p1, p2)``, seeds per env) are held to the
same rule against their plain versions under the same Philox draws; the
noiseless kernel's result on those inputs must fail it, and at p = 0 the
noise variant must equal the noiseless kernel (bit for bit expected,
1e-6 allowed, the atol of tests/test_noise_pallas.py's p = 0 test).  The
5-qubit Kraus check holds the mean of several thousand trajectory samples
of the v1 noise variant within 5 sigma + 1e-3 of the exact channel.  Both
kernels take 16 starts, and v1 runs at 4 and 5 qubits.

Per-env psi0 ((E, D) planes, block-coordinate trainable mode) is held to
the same rule for v1 and for v2 at 12 and 14 qubits (state in shared
memory, then in the workspace); the shared psi0 of row 0 must fail it, and
identical rows must give the shared launch bit for bit.  Both kernels run
at the trainable configs' capacities, where the tapes embed the warm start
and G != R: v1 at H2O 8q (G = 172, R = 151; noisy at the _noise config),
v2 at LiH 12q (G = 244, R = 211) and at Heisenberg 20q (G = 388, R = 331:
the sweep kernel over some fifty segments a tape).  The one env of
chip_smoke.py's 64-env v1 draw at the 8q trainable capacities that left
the agreement band is kept: the plain version's own float32 runs, rounded
otherwise, reach the kernel's e_new there.

The composed engine's tape kernels (B3f forward, B3b adjoint,
``ops/apply_tape.py``) are held to their plain versions at 1-9 qubits
(the register kernels) and at 10-16 (the wide kernels: register rows up
to 12 qubits, a cluster of 2^(n - 12) CTAs a row above, reading the
schedule kernel's rows, which equal its twin's): forward planes within
1e-5, the psi0 cotangents and angle gradients within 1e-4 (float32 row
sums in another order); RYY's sign flipped and RZZ's gradient dropped must
exceed them; two launches agree bit for bit; woven tapes (error Paulis,
weave 3) under their gates' schedule at 12 and 14 qubits; the sweep
tape kernels at 17 and 20 qubits (every row in device memory, the tape
in segments of 12 local qubits), plainly and on woven tapes, each call
one device kernel forward and two adjoint (the profiler's count), rows
of one and of several segments in one call; more than 20 qubits is
refused; no tape kernel spills in ptxas' report, and the sweep kernels'
CTAs an SM are those their shared memory allows.  The composed step at
20 qubits, float32 and complex128, replays as a graph bit for bit.
The composed step (``AngleOptimizer`` through the kernels against itself
on the plain versions, 3 iterations, ``agreement``) runs for su4 tapes,
shot noise (1024 shots) and depolarizing noise over 4 trajectories, under
the same tagged draws, at 8-qubit H2O and at 12-qubit LiH; its CUDA graph
(``ComposedGraph``) gives the eager kernel path's result bit for bit on
three batches through one capture, the second on other tapes, and
counts each replay's launches.

The sequential trainer: one env step with Adam launches the fused kernel
once at E = 1 (B1 at 8-qubit H2O, B2 at 12-qubit LiH and at 20-qubit
Heisenberg, the sweep kernel), and that kernel at E = 1 agrees with its
plain version; the noisy COBYLA cost
(``AngleOptimizer.kernel_energy_fn``: one B3f launch an evaluation) equals
the eager complex128 simulator on the same woven draw within 1e-5 at 8
and 12 qubits, while a dropped error Pauli or a shifted angle exceeds
it.

The tensor-network warm start's stage 1 on the card (``tn/``): the 8q H2O
warm start with its fit on the card (one CUDA graph an iteration) gives
the CPU's e_circuit and overlap to 1e-8; the graph gives the eager loop's
loss history and unitaries on the card to 1e-12; ``gs_autodiff`` at 8q on
the card gives the CPU's energy history to 1e-8; and no tensor the fit or
``gs_autodiff`` makes on the card is complex64 or float32."""

import numpy as np
import pytest
import torch

from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    make_multistarts,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import load_problem
from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
from tensorrl_qas_tpu_torch.train.config import get_config

H2O = "H -0.021 -0.002 0.000; O 0.835 0.452 0.000; H 1.477 -0.273 0.000"
LIH = "Li 0.000 0.000 0.000; H 0.000 0.000 3.400"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tapes(dev, n, n_env, n_starts, cap, seed, prefix=None, rot_cap=None,
           qubits=None):
    """Random mid-episode tapes, the remap, a random psi0 and the starts:
    (old, new, map_idx, p0re, p0im) and (starts, active) on ``dev``.  A
    ``prefix`` tape (an embedded warm start) opens every tape, whose
    capacities are then ``cap`` gates and ``rot_cap`` angles.  ``qubits``:
    the qubits the random gates' targets and controls are drawn from (all
    n by default)."""
    rng = np.random.default_rng(seed)
    rot_cap = rot_cap or cap
    qubits = list(range(n)) if qubits is None else list(qubits)
    n_q = len(qubits)
    head = []
    if prefix is not None:
        head = [(GateKind(int(prefix.kind[g])), int(prefix.tq[g]),
                 int(prefix.cq[g]), float(prefix.angles[prefix.angle_slot[g]])
                 if prefix.angle_slot[g] >= 0 else 0.0)
                for g in range(prefix.n_gates)]
    olds, news, x0s, n_rots = [], [], [], []
    for _ in range(n_env):
        old, new = GateTape(n, cap, rot_cap), GateTape(n, cap, rot_cap)
        for gate in head:
            old.add(*gate)
            new.add(*gate)
        for _ in range(int(rng.integers(0, cap - len(head)))):
            i = int(rng.integers(n_q))
            t = qubits[i]
            if rng.random() < 0.4:
                c = qubits[(i + 1 + int(rng.integers(n_q - 1))) % n_q]
                gate = (GateKind.CX, t, c, 0.0)
            else:
                gate = (GateKind(int(rng.integers(1, 4))), t, -1,
                        float(rng.normal()))
            old.add(*gate)
            new.add(*gate)
        new.add(GateKind.RX, qubits[int(rng.integers(n_q))])
        olds.append(old.arrays())
        news.append(new.arrays())
        x0s.append(old.x0())
        n_rots.append(old.n_rots)
    maps = np.stack([np.where(np.arange(rot_cap) < k, np.arange(rot_cap), -1)
                     for k in n_rots]).astype(np.int32)
    psi0 = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi0 /= np.linalg.norm(psi0)

    def ints(tapes):
        return tuple(torch.as_tensor(np.stack([t[k] for t in tapes]),
                                     dtype=torch.int32, device=dev)
                     for k in range(4))

    x0 = torch.as_tensor(np.stack(x0s), dtype=torch.float32, device=dev)
    active = (torch.arange(rot_cap, device=dev)[None, :]
              < torch.as_tensor(n_rots, device=dev)[:, None]).float()
    starts = make_multistarts(x0, active, n_starts, n_starts // 4, 0.1,
                              torch.Generator(device=dev).manual_seed(1))
    f32 = dict(dtype=torch.float32, device=dev)
    return ((ints(olds), ints(news), torch.as_tensor(maps, device=dev),
             torch.as_tensor(psi0.real[None], **f32),
             torch.as_tensor(psi0.imag[None], **f32)),
            (starts.contiguous(), active[:, None, :].contiguous()))


def _inputs(dev, n=8, n_env=16, n_starts=8, cap=20, seed=0):
    """v1 arguments at 8-qubit H2O (other n: a random Pauli sum)."""
    head, tail = _tapes(dev, n, n_env, n_starts, cap, seed)
    pauli = load_problem("H2O", n, H2O).pauli if n == 8 else _pauli(n)
    return (*head, *AngleOptimizer(pauli, device=dev).w_planes(), *tail)


def _pauli(n, chain=False):
    if n == 12:
        return load_problem("LIH", 12, LIH).pauli
    if n in (14, 16):
        return load_problem("heisenberg", n).pauli
    if chain:                           # the open Heisenberg chain
        strings = []
        for i in range(n - 1):
            for a in "XYZ":
                word = ["I"] * n
                word[i] = word[i + 1] = a
                strings.append("".join(word))
        return PauliSum.from_strings(strings, np.ones(len(strings)), n)
    rng = np.random.default_rng(n)
    paulis = ["I" * n] + ["".join(rng.choice(list("IXYZ"), size=n))
                          for _ in range(40)]
    return PauliSum.from_strings(paulis, rng.normal(size=41), n)


def _inputs2d(dev, n, n_env=4, n_starts=8, cap=30, seed=0, qubits=None,
              chain=False):
    """v2 arguments: flip-group planes of H - c0 I."""
    head, tail = _tapes(dev, n, n_env, n_starts, cap, seed, qubits=qubits)
    return (*head, *AngleOptimizer(_pauli(n, chain), device=dev).w_planes(),
            *tail)


@pytest.mark.gpu
@pytest.mark.parametrize("n_starts", [8, 3])
def test_kernel_matches_plain_version(n_starts):
    dev = _card()
    args = _inputs(dev, n_starts=n_starts)
    before = fused_adam.fused_adam_step.launches
    xk, ek = fused_adam.fused_adam_step(*args, iters=3, lr=0.1)
    torch.cuda.synchronize()
    assert fused_adam.fused_adam_step.launches == before + 1
    ref = fused_adam.plain_results(args, iters=3, lr=0.1)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5)
    assert bool(ok.all())
    assert strict.float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["lr", "drop_ry"])
def test_check_rejects_a_wrong_kernel_result(fault):
    """The agreement rule has teeth: the kernel with Adam's rate off by 1%,
    or with the RY angles' gradients dropped, fails it."""
    dev = _card()
    args = _inputs(dev)
    lr = 0.101 if fault == "lr" else 0.1
    wrong = list(args)
    if fault == "drop_ry":
        kinds, slots = args[0][0], args[0][3]
        keep = torch.ones_like(args[9])
        for e, g in ((kinds == int(GateKind.RY))
                     & (slots >= 0)).nonzero().tolist():
            keep[e, 0, slots[e, g]] = 0.0
        wrong[9] = (args[9] * keep).contiguous()
    xk, ek = fused_adam.fused_adam_step(*wrong, iters=3, lr=lr)
    ref = fused_adam.plain_results(args, iters=3, lr=0.1)
    ok, _, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5)
    assert not bool(ok.all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_starts", [3, 8, 16])
@pytest.mark.parametrize("n", [4, 5, 8, 9])
def test_v1_kernel_across_qubits_and_starts(n, n_starts):
    """Groups of one thread's registers and two lanes (4q), four lanes
    (5q) and a warp (8 and 9q) a start; 16 starts at 9 qubits take two
    rounds of 8 groups."""
    dev = _card()
    args = _inputs(dev, n=n, n_env=8, n_starts=n_starts, cap=16)
    ok, strict, _ = _held_to_plain(fused_adam.fused_adam_step,
                                   fused_adam.fused_adam_step_reference,
                                   args)
    assert bool(ok.all()) and strict.float().mean() > 0.5


def _v1_at(reg_bits):
    """The v1 kernel with 2^reg_bits amplitudes a thread, through
    ``run_kernel`` on the current stream (uncounted)."""
    def step(*args, iters, lr, noise=None, seeds=None):
        return fused_adam.run_kernel(
            fused_adam._library(), *args, iters=iters, lr=lr, noise=noise,
            seeds=seeds, reg_bits=reg_bits,
            stream=torch.cuda.current_stream().cuda_stream)[1:]
    return step


@pytest.mark.gpu
@pytest.mark.parametrize("reg_bits", [3, 4])
def test_v1_kernel_at_both_register_widths(reg_bits):
    dev = _card()
    args = _inputs(dev)
    xk, ek = _v1_at(reg_bits)(*args, iters=3, lr=0.1)
    ref = fused_adam.plain_results(args, iters=3, lr=0.1)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5)
    assert bool(ok.all()) and strict.float().mean() > 0.5


def _all_flips_pauli(n, seed=5):
    """A Hermitian Pauli sum with every flip mask f, each group complex
    (f > 0: a term with one Y among its flipped qubits beside one with X
    only): 2^(n+1) - 1 planes of W, 523 KB at 8 qubits."""
    rng = np.random.default_rng(seed)
    strings = []
    for f in range(1 << n):
        for with_y in (False, True):
            s = [("X" if (f >> q) & 1 else rng.choice(["I", "Z"]))
                 for q in range(n)]
            if with_y and f:
                s[(f & -f).bit_length() - 1] = "Y"
            strings.append("".join(s))
    return PauliSum.from_strings(strings, rng.normal(size=len(strings)), n)


@pytest.mark.gpu
def test_v1_kernel_reads_w_from_global_memory():
    dev = _card()
    n, n_env, s_n, cap = 8, 4, 8, 16
    head, tail = _tapes(dev, n, n_env, s_n, cap, 2)
    wre, wim, flips = AngleOptimizer(_all_flips_pauli(n),
                                     device=dev).w_planes()
    n_cplx = int((wim != 0).any(dim=1).sum())
    assert flips.numel() == 1 << n and n_cplx == (1 << n) - 1
    smem = fused_adam._library().fused_adam_v1_smem_bytes(
        s_n, cap, cap, n, flips.numel(), n_cplx, 0,
        fused_adam.group_layout(n, s_n)[0], 1)
    assert smem > fused_adam.MAX_SMEM_BYTES
    args = (*head, wre, wim, flips, *tail)
    ok, strict, _ = _held_to_plain(fused_adam.fused_adam_step,
                                   fused_adam.fused_adam_step_reference,
                                   args)
    assert bool(ok.all()) and strict.float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("reg_bits", [3, 4])
def test_v1_bit_for_bit_at_8_qubits(reg_bits):
    """A repeated launch, the noise variant at p = 0 and identical (E, D)
    psi0 rows give the noiseless shared launch bit for bit."""
    dev = _card()
    args = _inputs(dev)
    step = _v1_at(reg_bits)
    kw = dict(iters=5, lr=0.1)
    x0, e0 = step(*args, **kw)
    n_env = args[-1].shape[0]
    rows = (*args[:3], *(p.expand(n_env, -1).contiguous()
                         for p in args[3:5]), *args[5:])
    runs = [step(*args, **kw),
            step(*args, noise=(0.0, 0.0), seeds=_seeds(dev, n_env), **kw),
            step(*rows, **kw)]
    for x, e in runs:
        assert torch.equal(x, x0) and torch.equal(e, e0)


@pytest.mark.gpu
def test_kernel_rejects_two_qubit_rotations():
    dev = _card()
    args = list(_inputs(dev, n_env=2))
    kinds = args[0][0].clone()
    kinds[0, 0] = 9                     # GateKind.RXX
    args[0] = (kinds, *args[0][1:])
    with pytest.raises(ValueError, match="RXX"):
        fused_adam.fused_adam_step(*args, iters=1, lr=0.1)


# the v2 cases: n qubits (the register kernel up to 12, the cluster kernel
# from 13 to 16, the group kernel at 17 and 18), plus at 12 qubits every
# target and control on the qubits that start on warp bits (5..11: a swap
# before most gates) and 3 starts, and the 13-qubit Heisenberg chain
V2_CASES = {f"{n}q": dict(n=n) for n in (7, 10, 11, 12, 13, 14, 16)}
V2_CASES["12q warp qubits"] = dict(n=12, qubits=range(5, 12))
V2_CASES["12q S=3"] = dict(n=12, n_starts=3)
V2_CASES["13q chain"] = dict(n=13, chain=True)
V2_CASES["17q"] = dict(n=17, n_env=2)
V2_CASES["18q"] = dict(n=18, n_env=2)
# the sweep kernel (19-20 qubits): random Pauli sums (complex W planes)
V2_CASES["19q"] = dict(n=19, n_env=2)
V2_CASES["20q"] = dict(n=20, n_env=2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(V2_CASES))
def test_kernel2d_matches_plain_version(case):
    dev = _card()
    args = _inputs2d(dev, **V2_CASES[case])
    step = fused_adam2d.fused_adam_step2d
    before = (step.launches, step.cluster_launches, step.group_launches,
              step.sweep_launches)
    xk, ek = step(*args, iters=3, lr=0.1)
    torch.cuda.synchronize()
    n = V2_CASES[case]["n"]
    assert (step.launches, step.cluster_launches, step.group_launches,
            step.sweep_launches) == (
        before[0] + 1, before[1] + (13 <= n <= 16),
        before[2] + (17 <= n <= 18), before[3] + (n >= 19))
    plain = fused_adam2d.fused_adam_step2d_reference
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=plain)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         step=plain)
    assert bool(ok.all())
    assert strict.float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(V2_CASES))
@pytest.mark.parametrize("fault", ["lr", "drop_ry"])
def test_check_rejects_a_wrong_kernel2d_result(case, fault):
    dev = _card()
    args = _inputs2d(dev, **V2_CASES[case])
    lr = 0.101 if fault == "lr" else 0.1
    wrong = list(args)
    if fault == "drop_ry":
        kinds, slots = args[0][0], args[0][3]
        keep = torch.ones_like(args[9])
        for e, g in ((kinds == int(GateKind.RY))
                     & (slots >= 0)).nonzero().tolist():
            keep[e, 0, slots[e, g]] = 0.0
        wrong[9] = (args[9] * keep).contiguous()
    xk, ek = fused_adam2d.fused_adam_step2d(*wrong, iters=3, lr=lr)
    plain = fused_adam2d.fused_adam_step2d_reference
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=plain)
    ok, _, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5, step=plain)
    assert not bool(ok.all())


@pytest.mark.gpu
def test_kernel2d_rejects_two_qubit_rotations():
    dev = _card()
    args = list(_inputs2d(dev, 7, n_env=2))
    kinds = args[0][0].clone()
    kinds[0, 0] = int(GateKind.RZZ)
    args[0] = (kinds, *args[0][1:])
    with pytest.raises(ValueError, match="RXX/RYY/RZZ"):
        fused_adam2d.fused_adam_step2d(*args, iters=1, lr=0.1)


NOISE = (0.1, 0.2)


def _engine(name):
    """(wrapper, plain version, argument builder) of one kernel: "v1",
    "v2" (12 qubits) or "v2 <n>q"."""
    if name == "v1":
        return (fused_adam.fused_adam_step,
                fused_adam.fused_adam_step_reference, _inputs)
    n = int(name.split()[1][:-1]) if " " in name else 12
    envs = dict(n_env=2) if n >= 19 else {}
    return (fused_adam2d.fused_adam_step2d,
            fused_adam2d.fused_adam_step2d_reference,
            lambda dev, **kw: _inputs2d(dev, n, **{**envs, **kw}))


def _seeds(dev, n_env, seed=0):
    return torch.randint(0, 2**31 - 1, (n_env, 2), dtype=torch.int32,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))


def _held_to_plain(step, plain, args, iters=3, **noise):
    """One launch against the plain version's runs under the same draws
    (``agreement``) -> (ok, strict, wrong) where wrong is the verdict on
    the noiseless kernel's result when noise is given."""
    before = (step.launches, step.noise_launches)
    xk, ek = step(*args, iters=iters, lr=0.1, **noise)
    torch.cuda.synchronize()
    assert step.launches == before[0] + 1
    assert step.noise_launches == before[1] + bool(noise)
    ref = fused_adam.plain_results(args, iters=iters, lr=0.1, step=plain,
                                   **noise)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         step=plain, iters=iters, **noise)
    wrong = None
    if noise:
        xc, ec = step(*args, iters=iters, lr=0.1)
        wrong, _, _ = fused_adam.agreement(args, ref, xc, ec, tol=1e-5,
                                           step=plain, iters=iters, **noise)
    return ok, strict, wrong


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v1", "v2", "v2 14q", "v2 19q", "v2 20q"])
def test_noise_kernel_matches_plain_version(name):
    dev = _card()
    step, plain, build = _engine(name)
    args = build(dev)
    ok, strict, wrong = _held_to_plain(
        step, plain, args, noise=NOISE, seeds=_seeds(dev, args[-1].shape[0]))
    assert bool(ok.all())
    assert strict.float().mean() > 0.5
    # the noiseless kernel's result on the same inputs is flagged
    assert (~wrong).float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v1", "v2", "v2 13q", "v2 14q", "v2 20q"])
def test_kernel_is_deterministic(name):
    """Gradient rows are summed in a fixed order: two launches on the same
    inputs agree bit for bit."""
    dev = _card()
    step, _, build = _engine(name)
    args = build(dev)
    x0, e0 = step(*args, iters=5, lr=0.1)
    x1, e1 = step(*args, iters=5, lr=0.1)
    assert torch.equal(x0, x1) and torch.equal(e0, e1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v1", "v2", "v2 13q", "v2 14q", "v2 20q"])
def test_noise_kernel_at_p0_is_the_noiseless_kernel(name):
    dev = _card()
    step, _, build = _engine(name)
    args = build(dev)
    x0, e0 = step(*args, iters=5, lr=0.1)
    xp, ep = step(*args, iters=5, lr=0.1, noise=(0.0, 0.0),
                  seeds=_seeds(dev, args[-1].shape[0]))
    assert (xp - x0).abs().max() <= 1e-6 and (ep - e0).abs().max() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("n", [13, 14, 15, 16, 17, 18])
def test_cluster_kernel_raises_when_no_cluster_fits(n):
    """The cluster (13-16q) and group (17-18q) kernels' CTAs at the main
    path's shared memory fit on the card, a group kernel's start whole;
    asking for more than a CTA may have leaves no cluster that can be
    scheduled, and the wrapper's check raises (no fallback)."""
    _card()
    lib = fused_adam2d._library()
    size = lib.fused_adam_v2_cluster_size(n, 0)
    per_start = lib.fused_adam_v2_start_ctas(n) // size
    assert size * per_start == 1 << (n - 12)
    assert (per_start > 1) == (n >= 17) == bool(
        lib.fused_adam_v2_group_band(n))
    smem = lib.fused_adam_v2_smem_bytes(46, 46, n, n, 0)
    assert fused_adam2d.check_clusters(lib, n, smem) >= per_start
    match = rf"takes {per_start} cluster\(s\) of {size} CTAs"
    with pytest.raises(RuntimeError, match=match):
        fused_adam2d.check_clusters(lib, n, 300_000)


@pytest.mark.gpu
@pytest.mark.parametrize("g, per_sm, slots", [(46, 3, 3), (388, 2, 1)])
def test_sweep_kernel_residency(g, per_sm, slots):
    """The sweep kernel's CTA at the 20q configs' capacities (fixed: G =
    46; in_state: 388) fits the card three times an SM at G = 46 (its
    registers allow three, ``__launch_bounds__(256, 3)``; its shared
    memory, a chunk's psi and lambda and the segment's gates, 71,696 B)
    and twice at G = 388 (90,848 B); its cooperative grid is what the card
    holds at once, cut into the slots of the fewest chunk rounds at 20
    qubits with 32 starts (3 of 132 CTAs; 1 of 264); asking for more
    shared memory than a CTA may have leaves none, and the check raises
    (no fallback)."""
    _card()
    lib = fused_adam2d._sweep_library()
    smem = lib.fused_adam_sweep_smem_bytes(g, 20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = fused_adam2d.check_residency(lib, smem)
    assert ctas == per_sm * sms
    assert lib.fused_adam_sweep_slots(20, 32, ctas) == slots
    with pytest.raises(RuntimeError, match="cannot hold one"):
        fused_adam2d.check_residency(lib, 300_000)


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [False, True])
def test_sweep_kernel_w_from_terms_is_the_planes(chain):
    """At 20 qubits, on random Pauli sums (complex groups) and on the open
    Heisenberg chain: the kernel's W of every group it computes equals
    the float32 plane bit for bit, and a launch that computes W from the
    terms gives the bits of one that reads every plane."""
    dev = _card()
    opt = AngleOptimizer(_pauli(20, chain), device=dev)
    wre, wim, flips = opt.w_planes()
    lib = fused_adam2d._sweep_library()
    kre, kim, computed = fused_adam2d.sweep_w_planes(
        lib, flips, wim, opt.w_terms(), 20)
    torch.cuda.synchronize()
    assert bool(computed.any())
    rows = computed.nonzero().flatten().tolist()
    assert torch.equal(kre[rows], wre[rows])
    assert torch.equal(kim[rows], wim[rows])
    args = _inputs2d(dev, 20, n_env=2, chain=chain)
    step = fused_adam2d.fused_adam_step2d
    x0, e0 = step(*args, iters=3, lr=0.1)
    x1, e1 = step(*args, iters=3, lr=0.1, terms=opt.w_terms())
    torch.cuda.synchronize()
    assert torch.equal(x0, x1) and torch.equal(e0, e1)


@pytest.mark.gpu
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("name", ["v1", "v2"])
def test_sixteen_starts_match_plain_version(name, noisy):
    dev = _card()
    step, plain, build = _engine(name)
    args = build(dev, n_env=4, n_starts=16)
    noise = (dict(noise=NOISE, seeds=_seeds(dev, 4, seed=1)) if noisy
             else {})
    ok, strict, _ = _held_to_plain(step, plain, args, **noise)
    assert bool(ok.all()) and strict.float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("n", [4, 5])
def test_v1_below_eight_qubits_matches_plain_version(n, noisy):
    dev = _card()
    args = _inputs(dev, n=n, cap=16)
    noise = (dict(noise=NOISE, seeds=_seeds(dev, 16, seed=n)) if noisy
             else {})
    ok, strict, _ = _held_to_plain(fused_adam.fused_adam_step,
                                   fused_adam.fused_adam_step_reference,
                                   args, **noise)
    assert bool(ok.all()) and strict.float().mean() > 0.5


@pytest.mark.gpu
def test_noise_kernel_trajectories_match_kraus_at_5_qubits():
    """The 5-qubit tape of tests/test_noise_pallas.py:_test_tape at p1 =
    0.15, p2 = 0.25; lr = 0 and an identity map keep x_new = x0, so every
    env's e_new is one trajectory sample of its own Philox stream."""
    from tensorrl_qas_tpu_torch.sim.apply import zero_state
    from tensorrl_qas_tpu_torch.sim.noise import depolarizing_energy_exact

    dev = _card()
    n, n_env, p = 5, 4096, (0.15, 0.25)
    tape = GateTape(n, 4, 4)
    tape.add(GateKind.RY, target=0, angle=0.7)
    tape.add_cx(0, 1)
    tape.add(GateKind.RX, target=2, angle=-1.1)
    tape.add_cx(1, 2)
    pauli = PauliSum.from_strings(
        [s + "I" * (n - len(s)) for s in ("Z", "IZ", "IIZ", "XX", "IYY")],
        [1.0, 0.5, -0.7, 0.9, 1.3], n)
    exact = depolarizing_energy_exact(zero_state(n), *tape.arrays(),
                                      tape.x0(), pauli.to_dense(), *p)
    arrs = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 .repeat(n_env, 1).contiguous() for a in tape.arrays())
    opt = AngleOptimizer(pauli, device=dev)
    psi0 = zero_state(n, torch.complex64, dev)
    x0 = torch.as_tensor(tape.x0(), dtype=torch.float32, device=dev)
    _, e_new = fused_adam.fused_adam_step(
        arrs, arrs, torch.arange(4, dtype=torch.int32, device=dev)
        .repeat(n_env, 1).contiguous(), psi0.real[None].contiguous(),
        psi0.imag[None].contiguous(), *opt.w_planes(),
        x0.repeat(n_env, 1, 1).contiguous(),
        torch.ones(n_env, 1, 4, device=dev), iters=1, lr=0.0, noise=p,
        seeds=_seeds(dev, n_env, seed=9))
    es = e_new.double().cpu().numpy() + opt.offset
    assert es.std() > 0.0
    assert abs(es.mean() - exact) < 5 * es.std() / np.sqrt(n_env) + 1e-3


# -- per-env psi0 and the trainable capacities -------------------------------

def _per_env(args, seed=3):
    """``args`` with one random psi0 row per env, (E, D) planes."""
    n_env, d = args[-1].shape[0], args[3].shape[-1]
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(n_env, d)) + 1j * rng.normal(size=(n_env, d))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    f32 = dict(dtype=torch.float32, device=args[3].device)
    return (*args[:3], torch.as_tensor(psi.real, **f32),
            torch.as_tensor(psi.imag, **f32), *args[5:])


def _psi0_case(case, dev):
    """(wrapper, plain version, shared-psi0 arguments)."""
    if case == "v1":
        return (fused_adam.fused_adam_step,
                fused_adam.fused_adam_step_reference, _inputs(dev))
    n = int(case.split()[1][:-1])
    return (fused_adam2d.fused_adam_step2d,
            fused_adam2d.fused_adam_step2d_reference,
            _inputs2d(dev, n, n_env=4 if n < 14 else 2))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["v1", "v2 12q", "v2 14q", "v2 20q"])
def test_per_env_psi0_kernel_matches_plain_version(case):
    dev = _card()
    step, plain, shared = _psi0_case(case, dev)
    args = _per_env(shared)
    before = step.psi0_launches
    ok, strict, _ = _held_to_plain(step, plain, args)
    assert step.psi0_launches == before + 1
    assert bool(ok.all()) and strict.float().mean() > 0.5
    # the kernel given row 0 for every env (a stride ignored) is flagged
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=plain)
    row0 = (*args[:3], args[3][:1], args[4][:1], *args[5:])
    xw, ew = step(*row0, iters=3, lr=0.1)
    wrong, _, _ = fused_adam.agreement(args, ref, xw, ew, tol=1e-5,
                                       step=plain)
    assert (~wrong[1:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["v1", "v2 12q", "v2 13q", "v2 14q",
                                  "v2 20q"])
def test_per_env_psi0_identical_rows_equal_the_shared_launch(case):
    dev = _card()
    step, _, args = _psi0_case(case, dev)
    n_env = args[-1].shape[0]
    rows = (*args[:3], *(p.expand(n_env, -1).contiguous()
                         for p in args[3:5]), *args[5:])
    before = (step.launches, step.psi0_launches)
    xs, es = step(*args, iters=5, lr=0.1)
    xp, ep = step(*rows, iters=5, lr=0.1)
    assert (step.launches, step.psi0_launches) == (before[0] + 2,
                                                   before[1] + 1)
    assert torch.equal(xp, xs) and torch.equal(ep, es)


def _trainable(dev, config, n_env, noisy=False):
    """Arguments at an in_state config's capacities: every tape opens with
    the embedded warm start (from the env's own reset), then random gates;
    H operands from the env's optimizer."""
    env = CircuitEnv(EnvConfig.from_conf(
        get_config("TensorRL_trainable/", f"{config}.cfg"),
        tn_placement="in_state",
        noise_mode="depolarizing" if noisy else "none", device=dev))
    env.reset()
    g, r = env.tape_capacity, env.rot_capacity
    head, tail = _tapes(dev, env.num_qubits, n_env, 8, g, 0,
                        prefix=env._tape(env.state), rot_cap=r)
    return (g, r), (*head, *env.optimizer.w_planes(), *tail)


@pytest.mark.gpu
@pytest.mark.parametrize("config, caps", [
    ("H2O8q_TNbond2", (172, 151)), ("LIH12q_TNbond2", (244, 211)),
    ("heisenberg_20q_TNbond2", (388, 331))])
def test_kernels_at_trainable_capacities_match_plain_version(config, caps):
    dev = _card()
    got_caps, args = _trainable(dev, config,
                                2 if config.startswith("heisenberg") else 8)
    assert got_caps == caps and args[0][0].shape[1] == caps[0]
    assert args[-1].shape[-1] == caps[1]
    if config.startswith("H2O8q"):
        step, plain = (fused_adam.fused_adam_step,
                       fused_adam.fused_adam_step_reference)
    else:
        step, plain = (fused_adam2d.fused_adam_step2d,
                       fused_adam2d.fused_adam_step2d_reference)
    ok, strict, _ = _held_to_plain(step, plain, args)
    assert bool(ok.all()) and strict.float().mean() > 0.5
    ok, strict, _ = _held_to_plain(step, plain, _per_env(args))
    assert bool(ok.all()) and strict.float().mean() > 0.5


@pytest.mark.gpu
def test_v1_trainable_env_that_parts_in_float32():
    """The draw on which chip_smoke.py's v1 check at the trainable
    capacities left the agreement band at E = 64 after 3 iterations (8q
    H2O in_state, G = 172, R = 151, its ``Case`` at seed 1234): env 50.
    Alone (E = 1) the kernel gives that env's row bit for bit; it agrees
    with the plain version's float32 and float64 runs after 1 and 2
    iterations; after 3 those two runs part by more than 1e-4 Ha, and the
    kernel's e_new lies inside the range that 16 plain float32 runs with
    the H planes rounded otherwise (as ``plain_results`` perturbs them)
    span: float32 rounding decides where the env goes.  The check's four
    perturbed runs did not reach the kernel's e_new (ROADMAP.md, C)."""
    dev = _card()
    import chip_smoke

    v1 = chip_smoke.engines()[0]
    case = chip_smoke.Case(v1, "H2O8q_TNbond2", 64,
                           family=chip_smoke.TRAINABLE)
    assert (case.g, case.r) == (172, 151)
    e, lr = 50, chip_smoke.LR
    xk, ek = v1.step(*case.args, iters=3, lr=lr)
    one = (tuple(a[e:e + 1] for a in case.args[0]),
           tuple(a[e:e + 1] for a in case.args[1]), case.args[2][e:e + 1],
           *case.args[3:-2], case.args[-2][e:e + 1], case.args[-1][e:e + 1])
    x1, e1 = v1.step(*one, iters=3, lr=lr)
    assert torch.equal(x1[0], xk[e]) and torch.equal(e1[0], ek[e])
    for iters in (1, 2):
        k = float(v1.step(*one, iters=iters, lr=lr)[1][0])
        for args in (one, fused_adam._to64(one)):
            assert abs(k - float(v1.plain(*args, iters=iters, lr=lr)[1][0])
                       ) < 1e-5
    p32 = float(v1.plain(*one, iters=3, lr=lr)[1][0])
    p64 = float(v1.plain(*fused_adam._to64(one), iters=3, lr=lr)[1][0])
    assert abs(p32 - p64) > 1e-4
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = []
    for _ in range(16):
        wob = list(one)
        for i in (5, 6):
            u = torch.rand(one[i].shape, generator=gen, dtype=one[i].dtype,
                           device=dev) * 2 - 1
            wob[i] = one[i] * (1 + u * 2.0 ** -23)
        draws.append(float(v1.plain(*wob, iters=3, lr=lr)[1][0]))
    assert min(draws) - 1e-5 <= float(ek[e]) <= max(draws) + 1e-5


@pytest.mark.gpu
def test_noise_kernel_at_trainable_noise_capacity_matches_plain_version():
    dev = _card()
    caps, args = _trainable(dev, "H2O8q_TNbond2_noise", 8, noisy=True)
    assert caps == (172, 151)
    ok, strict, wrong = _held_to_plain(
        fused_adam.fused_adam_step, fused_adam.fused_adam_step_reference,
        args, noise=(0.01, 0.05), seeds=_seeds(dev, 8, seed=2))
    assert bool(ok.all()) and strict.float().mean() > 0.5
    assert (~wrong).any()


# -- the composed engine's tape kernels (B3f / B3b, ops/apply_tape.py) ------

TOL_FWD, TOL_BWD = 1e-5, 1e-4
SU4 = (GateKind.RXX, GateKind.RYY, GateKind.RZZ, GateKind.RX, GateKind.RY,
       GateKind.RZ)


def _tape_case(dev, n, n_env=8, s_n=4, n_gates=30, seed=0):
    """Random tapes over every gate class (su4 rotations, 1-qubit gates, a
    controlled RY, CX, H, Y, padding), random unit psi rows, angles and
    unit-norm cotangents, on ``dev``: (planes, tape, angles, cotangents)."""
    rng = np.random.default_rng(seed)
    pool = (*SU4, GateKind.CX, GateKind.H, GateKind.Y, GateKind.X,
            GateKind.Z)
    if n == 1:                          # one qubit: no pairs
        pool = (*SU4[3:], GateKind.H, GateKind.Y, GateKind.X, GateKind.Z)
    g_cap = n_gates + 2
    arrs = [np.zeros((n_env, g_cap), np.int32) for _ in range(2)]
    arrs += [np.full((n_env, g_cap), -1, np.int32) for _ in range(2)]
    for e in range(n_env):
        r = 0
        for g in range(n_gates):
            k = pool[g % len(pool)] if g < len(pool) else \
                pool[int(rng.integers(len(pool)))]
            t = int(rng.integers(n))
            c = int((t + 1 + rng.integers(n - 1)) % n) if n > 1 else -1
            ctrl = k in (GateKind.CX, *SU4[:3]) or (
                k == GateKind.RY and g % 5 == 0)
            arrs[0][e, g], arrs[1][e, g] = int(k), t
            arrs[2][e, g] = c if ctrl else -1
            if k in SU4:
                arrs[3][e, g] = r
                r += 1
    d = 1 << n
    psi = rng.normal(size=(n_env, s_n, d)) + 1j * rng.normal(
        size=(n_env, s_n, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    lam = rng.normal(size=(2, n_env, s_n, d))
    lam /= np.linalg.norm(lam, axis=(0, 3), keepdims=True)
    f32 = dict(dtype=torch.float32, device=dev)
    return ((torch.as_tensor(psi.real, **f32),
             torch.as_tensor(psi.imag, **f32)),
            tuple(torch.as_tensor(a, device=dev) for a in arrs),
            torch.as_tensor(rng.normal(size=(n_env, s_n, n_gates)), **f32),
            (torch.as_tensor(lam[0], **f32), torch.as_tensor(lam[1], **f32)))


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                               15, 16])
def test_tape_kernels_match_plain_versions(n):
    """B3f and B3b against their plain versions (the register kernels up
    to 9 qubits, the wide kernels' register rows at 10-12 and clusters of
    2-16 CTAs at 13-16); two wrong results must fail the same tolerances:
    RYY's sign flipped, RZZ's gradient dropped."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    planes, tape, angles, cot = _tape_case(dev, n, n_env=8 if n < 12 else 4)
    before = (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches)
    out = at.apply_tape_fwd(*planes, *tape, angles)
    grads = at.apply_tape_bwd(*out, *cot, *tape, angles)
    torch.cuda.synchronize()
    assert (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    out_p = at.apply_tape_fwd_plain(*planes, *tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *tape, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD
    # controls: RYY applied as exp(+i theta/2 YY), RZZ's gradient dropped
    kind, _, _, slot = tape
    ryy = (kind == int(GateKind.RYY)) & (slot >= 0)
    flip = torch.ones_like(angles)
    for e in range(kind.shape[0]):
        flip[e, :, slot[e][ryy[e]].long()] = -1.0
    wrong = at.apply_tape_fwd(*planes, *tape, (angles * flip).contiguous())
    assert _max_err(wrong, out_p) > 100 * TOL_FWD
    rzz = (kind == int(GateKind.RZZ)) & (slot >= 0)
    dang = grads[2].clone()
    for e in range(kind.shape[0]):
        dang[e, :, slot[e][rzz[e]].long()] = 0.0
    assert _max_err((dang,), (grads_p[2],)) > 10 * TOL_BWD


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 8, 9, 10, 12, 14])
def test_register_tape_kernels_variants(n):
    """The register and wide kernels at 1 qubit (no pairs) and beside
    their variants: the adjoint without psi0 cotangents gives the same
    angle gradients; from 10 qubits the schedule kernel's rows equal its
    twin's, and a launch given them equals one that builds its own."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    planes, tape, angles, cot = _tape_case(dev, n, seed=2)
    lib = at._library()
    out = at.run_fwd(lib, *planes, tape, angles)
    grads = at.run_bwd(lib, *out, *cot, tape, angles)
    out_p = at.apply_tape_fwd_plain(*planes, *tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *tape, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD
    lean = at.run_bwd(lib, *out, *cot, tape, angles, psi0_grad=False)
    assert torch.equal(lean[2], grads[2])
    if n >= at.WIDE_MIN_QUBITS:
        r = angles.shape[-1]
        before = at.tape_schedule.launches
        sched = at.tape_schedule(*tape, n, r)
        assert at.tape_schedule.launches == before + 1
        assert np.array_equal(sched.cpu().numpy(),
                              at.tape_schedule_plain(*tape, n, r))
        again = at.run_fwd(lib, *planes, tape, angles, schedule=sched)
        assert all(torch.equal(a, b) for a, b in zip(again, out))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [12, 14])
def test_wide_tape_kernels_on_woven_tapes(n):
    """Tapes woven with error Paulis (``extend_tape_arrays``: X / Y on
    every CX's control, anywhere, and on targets at random) under their
    gates' schedule (weave 3), against the plain versions on the woven
    tapes, where the errors are gates."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays

    dev = _card()
    planes, tape, angles, cot = _tape_case(dev, n, n_env=4, seed=3)
    rng = np.random.default_rng(n)
    kind = tape[0].cpu().numpy()
    is_cx = kind == int(GateKind.CX)
    live = (kind >= int(GateKind.RX)) & (kind <= int(GateKind.CX))
    kt = np.where(live & (rng.random(kind.shape) < 0.5),
                  rng.integers(5, 8, kind.shape), 0)
    kc = np.where(is_cx, rng.integers(5, 7, kind.shape), 0)
    woven = tuple(a.to(torch.int32).contiguous() for a in extend_tape_arrays(
        tape, torch.as_tensor(kt, device=dev),
        torch.as_tensor(kc, device=dev)))
    sched = at.tape_schedule(*tape, n, angles.shape[-1])
    out = at.apply_tape_fwd(*planes, *woven, angles, schedule=sched,
                            weave=3)
    grads = at.apply_tape_bwd(*out, *cot, *woven, angles, schedule=sched,
                              weave=3)
    out_p = at.apply_tape_fwd_plain(*planes, *woven, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *woven, angles)
    assert _max_err(out, out_p) <= TOL_FWD
    assert _max_err(grads, grads_p) <= TOL_BWD
    clean = at.apply_tape_fwd_plain(*planes, *tape, angles)
    assert _max_err(out, clean) > 100 * TOL_FWD      # the errors act


@pytest.mark.gpu
def test_v2_kernels_do_not_spill():
    """ptxas' report of the v2 build: 0 bytes of spills in the register,
    cluster and group kernels."""
    from tensorrl_qas_tpu_torch.ops.build import build

    _card()
    lines = build("fused_adam_v2")["log"].splitlines()
    reports = [(ln, nxt) for ln, nxt in zip(lines, lines[1:])
               if "Function properties for" in ln and "fused_adam_v2_" in ln]
    names = " ".join(ln for ln, _ in reports)
    for kernel in ("reg_kernel", "cluster_kernel", "group_kernel"):
        assert kernel in names, names
    for ln, nxt in reports:
        assert "0 bytes spill stores, 0 bytes spill loads" in nxt, ln


@pytest.mark.gpu
def test_sweep_kernel_does_not_spill():
    """ptxas' report of the sweep kernel's build: 0 bytes of spills, and
    at most 80 registers a thread (three CTAs of 256 threads an SM: 85 a
    thread, allocated 8 at a time)."""
    import re

    from tensorrl_qas_tpu_torch.ops.build import build

    _card()
    lines = build("fused_adam_v2_sweep")["log"].splitlines()
    reports = [(ln, nxt, after) for ln, nxt, after
               in zip(lines, lines[1:], lines[2:])
               if "Function properties for" in ln and "sweep_kernel" in ln]
    assert len(reports) == 1, lines
    assert "0 bytes spill stores, 0 bytes spill loads" in reports[0][1]
    regs = re.search(r"Used (\d+) registers", reports[0][2])
    assert regs and int(regs.group(1)) <= 80, reports[0]


@pytest.mark.gpu
def test_register_tape_kernels_do_not_spill():
    """ptxas' report of the tape kernels' build: 0 bytes of spills in
    every kernel: the register kernels (fwd and bwd at RB = 3 and 4), the
    wide kernels (fwd and bwd, register rows and clusters) and the
    schedule kernel."""
    from tensorrl_qas_tpu_torch.ops.build import build

    _card()
    lines = build("apply_tape")["log"].splitlines()
    reports = [(ln, nxt) for ln, nxt in zip(lines, lines[1:])
               if "Function properties for" in ln and "apply_tape" in ln]
    names = " ".join(ln for ln, _ in reports)
    assert sum("reg_kernel" in ln for ln, _ in reports) == 4, names
    assert sum("wide_kernel" in ln for ln, _ in reports) == 4, names
    assert "schedule_kernel" in names
    for ln, nxt in reports:
        assert "0 bytes spill stores, 0 bytes spill loads" in nxt, ln


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 8, 9, 11, 14, 16])
def test_tape_kernels_are_deterministic(n):
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    planes, tape, angles, cot = _tape_case(dev, n, n_env=4, seed=1)
    runs = []
    for _ in range(2):
        out = at.apply_tape_fwd(*planes, *tape, angles)
        runs.append((*out, *at.apply_tape_bwd(*out, *cot, *tape, angles)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_tape_kernels_refuse_more_than_sixteen_qubits():
    """Past the composed engine's ceiling -- 20 qubits since the sweep
    kernels took 17-20 -- the wrappers raise, naming the sharded path."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    planes, tape, angles, _ = _tape_case(dev, 21, n_env=1, s_n=1,
                                         n_gates=4)
    with pytest.raises(ValueError, match="at most 20.*mesh_shape"):
        at.apply_tape_fwd(*planes, *tape, angles)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17, 20])
@pytest.mark.parametrize("woven", [False, True])
def test_sweep_tape_kernels_match_plain_versions(n, woven):
    """The sweep tape kernels (17-20 qubits, ``csrc/apply_tape_sweep.cu``)
    against their plain versions, plainly and on tapes woven with error
    Paulis under the noiseless tapes' segments (weave 3); every call
    counted as a sweep launch; a repeat bit for bit; the segment kernel's
    rows equal ``sweep_segments``' word for word."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.ops.fused_adam2d import sweep_segments
    from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays

    dev = _card()
    planes, tape, angles, cot = _tape_case(dev, n, n_env=2, s_n=2, seed=n)
    sched = at.tape_schedule(*tape, n, angles.shape[-1])
    twin = [sweep_segments(*(a[e].cpu().numpy() for a in tape[:3]), n)
            for e in range(2)]
    assert sched.cpu().tolist() == twin
    run_tape, kw = tape, dict(schedule=sched)
    if woven:
        kind = tape[0].cpu().numpy()
        rng = np.random.default_rng(n)
        live = (kind >= int(GateKind.RX)) & (kind <= int(GateKind.CX))
        kt = np.where(live & (rng.random(kind.shape) < 0.5),
                      rng.integers(5, 8, kind.shape), 0)
        kc = np.where(kind == int(GateKind.CX),
                      rng.integers(5, 7, kind.shape), 0)
        run_tape = tuple(a.to(torch.int32).contiguous()
                         for a in extend_tape_arrays(
                             tape, torch.as_tensor(kt, device=dev),
                             torch.as_tensor(kc, device=dev)))
        kw["weave"] = 3
    before = (at.apply_tape_fwd.sweep_launches,
              at.apply_tape_bwd.sweep_launches)
    runs = []
    for _ in range(2):
        out = at.apply_tape_fwd(*planes, *run_tape, angles, **kw)
        runs.append((*out, *at.apply_tape_bwd(*out, *cot, *run_tape, angles,
                                              **kw)))
    torch.cuda.synchronize()
    assert (at.apply_tape_fwd.sweep_launches,
            at.apply_tape_bwd.sweep_launches) == (before[0] + 2,
                                                  before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out_p = at.apply_tape_fwd_plain(*planes, *run_tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *run_tape, angles)
    assert _max_err(runs[0][:2], out_p) <= TOL_FWD
    assert _max_err(runs[0][2:], grads_p) <= TOL_BWD


def _sweep_fit_as_designed(dtype, n):
    """The CTAs an SM of the sweep tape kernels at n qubits, forward and
    adjoint, are those their shared memory allows (their registers do not
    hold fewer), and the grid a call takes is that times the SMs."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    lib = at._sweep_library(dtype)
    per_sm = at.check_sweep_fit(lib, n, torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for adjoint, ctas in enumerate(per_sm):
        by_smem = 233472 // (lib.smem_bytes(adjoint, n) + 1024)
        assert ctas == by_smem >= 1, (adjoint, ctas, by_smem)
        assert lib.resident_ctas(adjoint, n) == ctas * sms
    return per_sm


@pytest.mark.gpu
def test_sweep_tape_kernels_do_not_spill():
    """ptxas' report of the sweep tape kernels' build: 0 bytes of spills in
    the forward, adjoint, gradient and segment kernels; three CTAs an SM
    each (the forward with two 32 KB chunk buffers, the adjoint with one
    of psi and mu)."""
    from tensorrl_qas_tpu_torch.ops.build import build

    _card()
    lines = build("apply_tape_sweep")["log"].splitlines()
    reports = [(ln, nxt) for ln, nxt in zip(lines, lines[1:])
               if "Function properties for" in ln
               and "apply_tape_sweep" in ln]
    names = " ".join(ln for ln, _ in reports)
    for kernel in ("fwd_kernel", "bwd_kernel", "bwd_grad_kernel",
                   "schedule_kernel"):
        assert kernel in names, names
    for ln, nxt in reports:
        assert "0 bytes spill stores, 0 bytes spill loads" in nxt, ln
    assert _sweep_fit_as_designed(torch.float32, 20) == (3, 3)


def _composed_args(dev, n_env=16, s_n=4, su4=True, seed=0, n=8):
    """Fused-step arguments at 8-qubit H2O (or 12-qubit LiH) for the
    composed engine: su4 tapes (RXX/RYY/RZZ/RX/RY/RZ) or CNOT-set ones,
    identity angle map."""
    head, tail = _tapes(dev, n, n_env, s_n, 30, seed)
    if su4:
        rng = np.random.default_rng(seed)
        old, new = head[0], head[1]
        live = old[0] != 0
        kinds = torch.as_tensor(rng.choice([int(k) for k in SU4],
                                           size=tuple(old[0].shape)),
                                dtype=torch.int32, device=dev)
        two_q = kinds >= int(GateKind.RXX)
        partner = (old[1] + 1 + torch.as_tensor(
            rng.integers(n - 1, size=tuple(old[0].shape)), device=dev)) % n
        kind = torch.where(live, kinds, 0).int()
        cq = torch.where(live & two_q, partner, -1).int()
        slot = torch.where(live, torch.cumsum(live.int(), 1) - 1, -1).int()
        old = (kind.contiguous(), old[1], cq.contiguous(), slot.contiguous())
        last = ((new[0] != 0).sum(1) - 1).int()
        rows = torch.arange(n_env, device=dev)
        new = tuple(a.clone() for a in old)
        new[0][rows, last] = int(GateKind.RY)
        new[1][rows, last] = old[1][rows, last]
        new[3][rows, last] = last
        n_rots = live.int().sum(1)
        head = (old, new, torch.where(
            torch.arange(30, device=dev)[None] < n_rots[:, None],
            torch.arange(30, device=dev)[None], -1).int().contiguous(),
            *head[3:])
        active = (torch.arange(30, device=dev)[None]
                  < n_rots[:, None]).float()
        x0 = torch.randn(n_env, 30, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
        tail = (make_multistarts(x0 * active, active, s_n, s_n // 4, 0.1,
                                 torch.Generator(device=dev).manual_seed(1)
                                 ).contiguous(),
                active[:, None, :].contiguous())
    pauli = (load_problem("H2O", 8, H2O) if n == 8
             else load_problem("LIH", 12, LIH)).pauli
    return pauli, (*head, *tail)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["su4", "shot", "traj4"])
def test_composed_step_kernels_match_plain_versions(mode):
    """The composed engine through the kernels against itself on the
    plain versions, held by ``agreement`` at 3 iterations under the same
    tagged draws; a 1% Adam rate must fail it."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import composed_step

    dev = _card()
    pauli, args = _composed_args(dev, su4=mode == "su4")
    kw = {"su4": dict(enable_2q=True),
          "shot": dict(noise_mode="shot", n_shots=1024),
          "traj4": dict(noise_mode="depolarizing", n_traj=4)}[mode]
    opt = AngleOptimizer(pauli, device=dev, **kw)
    args = (*args[:5], *opt.h_planes(), *args[5:])
    noise = {} if mode == "su4" else {"seed": 11}
    kernel, plain = composed_step(opt), composed_step(opt, plain=True)
    before = (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches)
    xk, ek = kernel(*args, iters=3, lr=0.1, **noise)
    assert (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches) == (
        before[0] + 5, before[1] + 3)
    ref = fused_adam.plain_results(args, iters=3, lr=0.1, step=plain,
                                   **noise)
    ok, strict, _ = fused_adam.agreement(args, ref, xk, ek, tol=1e-5,
                                         step=plain, iters=3, **noise)
    assert bool(ok.all()) and strict.float().mean() > 0.5
    xw, ew = kernel(*args, iters=3, lr=0.101, **noise)
    wrong, _, _ = fused_adam.agreement(args, ref, xw, ew, tol=1e-5,
                                       step=plain, iters=3, **noise)
    assert not bool(wrong.all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["su4", "traj4"])
def test_composed_step_at_twelve_qubits(mode):
    """The composed engine at 12-qubit LiH (the wide kernels under each
    tape's schedule, built once a step; depolarizing trajectories on woven
    tapes; H psi over the flip groups in one gather) against itself on the
    plain versions by ``agreement`` at 3 iterations; its graph replays the
    eager kernel path bit for bit, each call 5 B3f, 3 B3b and 2 schedule
    launches."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import composed_step

    dev = _card()
    pauli, args = _composed_args(dev, n_env=4, su4=mode == "su4", n=12)
    kw = {"su4": dict(enable_2q=True),
          "traj4": dict(noise_mode="depolarizing", n_traj=4)}[mode]
    opt = AngleOptimizer(pauli, device=dev, **kw)
    fargs = (*args[:5], *opt.w_planes(), *args[5:])
    noise = {} if mode == "su4" else {"seed": 11}
    kernel, plain = composed_step(opt), composed_step(opt, plain=True)
    xk, ek = kernel(*fargs, iters=3, lr=0.1, **noise)
    ref = fused_adam.plain_results(fargs, iters=3, lr=0.1, step=plain,
                                   **noise)
    ok, strict, _ = fused_adam.agreement(fargs, ref, xk, ek, tol=1e-5,
                                         step=plain, iters=3, **noise)
    assert bool(ok.all()) and strict.float().mean() > 0.5
    counters = (at.apply_tape_fwd, at.apply_tape_bwd, at.tape_schedule)
    graph = opt.composed_graph()
    h_apply = opt._h_apply(torch.float32)
    for seed in (11, 12):
        before = [k.launches for k in counters]
        xg, eg = graph(*args, iters=3, lr=0.1, seed=seed)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(counters, before)] == [5, 3,
                                                                      2]
        xe, ee = opt._fused_step_composed(*args[:5], h_apply, *args[5:],
                                          iters=3, lr=0.1, seed=seed)
        assert torch.equal(xg, xe) and torch.equal(ee, eg)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["su4", "shot", "traj4"])
def test_composed_graph_replays_the_eager_kernel_path(mode):
    """The composed step's CUDA graph against the eager kernel path, bit
    for bit, on three batches through one capture (the first the warm-up,
    the second a replay on other tapes, the third a replay on the first
    batch's), each replay adding its 5 / 3 launches to the counters."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    kw = {"su4": dict(enable_2q=True),
          "shot": dict(noise_mode="shot", n_shots=1024),
          "traj4": dict(noise_mode="depolarizing", n_traj=4)}[mode]
    batches = [_composed_args(dev, su4=mode == "su4", seed=s)
               for s in (0, 1)]
    opt = AngleOptimizer(batches[0][0], device=dev, **kw)
    graph = opt.composed_graph()
    h_apply = opt._h_apply(torch.float32)
    for i, (b, seed) in enumerate(((0, 11), (1, 12), (0, 13))):
        args = batches[b][1]
        before = (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches)
        xg, eg = graph(*args, iters=3, lr=0.1, seed=seed)
        torch.cuda.synchronize()
        assert (at.apply_tape_fwd.launches - before[0],
                at.apply_tape_bwd.launches - before[1]) == (5, 3), i
        xe, ee = opt._fused_step_composed(*args[:5], h_apply, *args[5:],
                                          iters=3, lr=0.1, seed=seed)
        assert torch.equal(xg, xe) and torch.equal(eg, ee), i
    assert graph.captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize("config,kernel", [
    ("H2O8q_TNbond2", "fused_adam_step"),
    ("LIH12q_TNbond2", "fused_adam_step2d"),
    ("heisenberg_20q_TNbond2", "fused_adam_step2d")])
def test_sequential_adam_step_launches_the_fused_kernel_once(config, kernel):
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    _card()
    conf = get_config("TensorRL_fixed/", f"{config}.cfg")
    conf["non_local_opt"]["global_iters"] = 5
    env = CircuitEnv(EnvConfig.from_conf(conf, tn_placement="fixed",
                                         device="cuda"))
    env.reset()
    n = env.num_qubits
    counters = (fused_adam.fused_adam_step, fused_adam2d.fused_adam_step2d,
                at.apply_tape_fwd, at.apply_tape_bwd)
    for action in ((n, 0, 2, 2), (n, 0, 1, 1), (0, 1, n, 0)):
        before = [c.launches for c in counters]
        env.step(action)
        torch.cuda.synchronize()
        after = [c.launches - b for c, b in zip(counters, before)]
        assert after == [int(c.__name__ == kernel) for c in counters]
        assert np.isfinite(env.energy)
        assert env.nfev == 5 * env.optimizer.n_starts
    # the kernel at E = 1 against its plain version
    if kernel == "fused_adam_step":
        step, plain = fused_adam.fused_adam_step, \
            fused_adam.fused_adam_step_reference
        args = _inputs(torch.device("cuda"), n_env=1, cap=26)
    else:
        step, plain = fused_adam2d.fused_adam_step2d, \
            fused_adam2d.fused_adam_step2d_reference
        args = _inputs2d(torch.device("cuda"), n, n_env=1,
                         n_starts=env.optimizer.n_starts,
                         cap=env.tape_capacity)
    before = fused_adam2d.fused_adam_step2d.sweep_launches
    ok, _, _ = _held_to_plain(step, plain, args)
    assert bool(ok.all())
    assert fused_adam2d.fused_adam_step2d.sweep_launches == before + (n > 18)


def _noisy_cost_case(config, seed):
    """A noisy COBYLA cost on the card: the env's optimizer
    (depolarizing, method 'cobyla'), its warm-start psi0 and a random
    mid-episode tape at the env's capacity."""
    conf = get_config("TensorRL_fixed/", f"{config}.cfg")
    env = CircuitEnv(EnvConfig.from_conf(
        conf, tn_placement="fixed", noise_mode="depolarizing",
        optim_alg="cobyla", device="cuda"))
    rng = np.random.default_rng(seed)
    n, cap = env.num_qubits, env.tape_capacity
    tape = GateTape(n, cap, cap)
    for _ in range(cap - 1):
        t = int(rng.integers(n))
        if rng.random() < 0.4:
            tape.add(GateKind.CX, t, int((t + 1 + rng.integers(n - 1)) % n))
        else:
            tape.add(GateKind(int(rng.integers(1, 4))), t,
                     angle=float(rng.normal()))
    return env.optimizer, env.psi0, tape


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["H2O8q_TNbond2_noise", "LIH12q_TNbond2"])
def test_noisy_cobyla_cost_matches_eager_on_the_same_draw(config):
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    _card()
    opt, psi0, tape = _noisy_cost_case(config, 5)
    cap = tape.rot_capacity
    energy = opt.kernel_energy_fn(psi0, tape.arrays(), cap)
    kind = torch.as_tensor(tape.kind, dtype=torch.int32,
                           device="cuda").reshape(1, -1)
    x = tape.x0()
    gen = torch.Generator(device="cuda").manual_seed(3)
    before = at.apply_tape_fwd.launches
    draws = [opt._draw_noise(gen, kind, 1, 1) for _ in range(12)]
    for noise in draws:
        assert abs(energy(x, noise)
                   - opt.plain_energy(psi0, tape.arrays(), x, noise)) < 1e-5
    assert at.apply_tape_fwd.launches == before + len(draws)
    # a dropped error Pauli: of the fired errors of the first draws (at
    # least 8), the one whose loss moves the energy most (an error can
    # leave it unchanged)
    drops = []
    for noise in draws:
        if len(drops) >= 8:
            break
        want = opt.plain_energy(psi0, tape.arrays(), x, noise)
        for which, k in enumerate(noise):
            for pos in (k != 0).nonzero().tolist():
                cut = [noise[0].clone(), noise[1].clone()]
                cut[which][tuple(pos)] = 0
                moved = abs(opt.plain_energy(psi0, tape.arrays(), x, cut)
                            - want)
                drops.append((moved, cut, want))
    _, worst, want = max(drops, key=lambda d: d[0])
    assert abs(energy(x, worst) - want) > 1e-5
    # a shifted angle: the last rotation's, by 0.1 rad
    shifted = x.copy()
    shifted[tape.n_rots - 1] += 0.1
    assert abs(energy(shifted, draws[0]) - opt.plain_energy(
        psi0, tape.arrays(), x, draws[0])) > 1e-5


# -- the tensor-network warm start (stage 1 on the card) --------------------

def _h2o_8q_terms():
    import glob
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    path = glob.glob(str(repo / "data/mol_data/H2O_8q_geom_*.npz"))[0]
    raw = np.load(path, allow_pickle=True)
    return ([str(p) for p in raw["paulis"]],
            np.asarray(np.real(raw["weights"]), dtype=np.float64))


@pytest.mark.gpu
def test_warm_start_on_the_card_matches_the_cpu():
    """build_warmstart for 8q H2O (chi 2, 2 layers, maxiter 3000): the fit
    on the card (a CUDA graph an iteration, complex128) gives the CPU's
    e_circuit and overlap to 1e-8 and the same gate counts."""
    from tensorrl_qas_tpu_torch.tn.pipeline import build_warmstart

    _card()
    paulis, weights = _h2o_8q_terms()
    kw = dict(chi=2, n_layers=2, maxiter=3000, seed=0)
    card = build_warmstart(paulis, weights, device="cuda", **kw)
    cpu = build_warmstart(paulis, weights, device="cpu", **kw)
    assert abs(card.e_circuit - cpu.e_circuit) < 1e-8
    assert abs(card.overlap - cpu.overlap) < 1e-8
    assert (card.cnot_count, card.rotation_count) == (cpu.cnot_count,
                                                      cpu.rotation_count)
    assert card.timings["fit_device_ms"] > 0


@pytest.mark.gpu
def test_fit_graph_replays_the_eager_fit():
    """The fit's CUDA graph (one capture, replayed every iteration) and
    the eager loop on the card give the same loss history and unitaries
    to 1e-12 over 200 iterations (8q H2O's DMRG state)."""
    from tensorrl_qas_tpu_torch.tn.circuit_fit import fit_mps_to_circuit
    from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg
    from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis

    _card()
    _, mps = gs_dmrg(mpo_from_paulis(*_h2o_8q_terms()), chi=2, seed=0)
    graph = fit_mps_to_circuit(mps, 2, maxiter=200, device="cuda")
    eager = fit_mps_to_circuit(mps, 2, maxiter=200, device="cuda",
                               graph=False)
    np.testing.assert_allclose(graph[3], eager[3], atol=1e-12, rtol=0)
    assert abs(graph[2] - eager[2]) < 1e-12
    assert torch.allclose(graph[0], eager[0], atol=1e-12, rtol=0)


@pytest.mark.gpu
def test_gs_autodiff_on_the_card_matches_the_cpu():
    """gs_autodiff at 8q (the Heisenberg chain, chi 2, 300 Adam steps):
    the card's energy history equals the CPU's to 1e-8."""
    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        heisenberg_hamiltonian,
    )
    from tensorrl_qas_tpu_torch.tn.autodiff_gs import gs_autodiff
    from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis

    _card()
    mpo = mpo_from_paulis(*heisenberg_hamiltonian(8))
    e_card, _, h_card = gs_autodiff(mpo, chi=2, opt_steps=300, seed=0,
                                    device="cuda")
    e_cpu, _, h_cpu = gs_autodiff(mpo, chi=2, opt_steps=300, seed=0,
                                  device="cpu")
    np.testing.assert_allclose(h_card, h_cpu, atol=1e-8, rtol=0)
    assert abs(e_card - e_cpu) < 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("graph", [True, False])
def test_stage1_on_the_card_is_double_precision(graph):
    """Every tensor that the fit (8q H2O, 20 iterations, with and without
    the CUDA graph) and gs_autodiff (8q, 20 steps) make on the card is
    complex128, float64, an integer or a bool: none is complex64 or
    float32 (the trainer's dtype policy is not stage 1's)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        heisenberg_hamiltonian,
    )
    from tensorrl_qas_tpu_torch.tn.autodiff_gs import gs_autodiff
    from tensorrl_qas_tpu_torch.tn.circuit_fit import fit_mps_to_circuit
    from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg
    from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis

    class Dtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen.update(t.dtype for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor) and t.is_cuda)
            return out

    _card()
    _, mps = gs_dmrg(mpo_from_paulis(*_h2o_8q_terms()), chi=2, seed=0)
    mpo = mpo_from_paulis(*heisenberg_hamiltonian(8))
    with Dtypes() as mode:
        params, _, _, _ = fit_mps_to_circuit(mps, 2, maxiter=20,
                                             device="cuda", graph=graph)
        gs_autodiff(mpo, chi=2, opt_steps=20, seed=0, device="cuda")
    assert params.dtype == torch.complex128
    assert {torch.complex128, torch.float64} <= mode.seen
    assert not mode.seen & {torch.complex64, torch.float32, torch.float16,
                            torch.bfloat16}, mode.seen


# -- complex128 on the card: the double-precision tape kernels
# (csrc/apply_tape_f64.cu) and the composed route every Adam mode takes --

TOL_FWD64, TOL_BWD64 = 1e-12, 1e-10


def _double(case):
    planes, tape, angles, cot = case
    return (tuple(p.double() for p in planes), tape, angles.double(),
            tuple(c.double() for c in cot))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 8, 12, 14, 17])
@pytest.mark.parametrize("woven", [False, True])
def test_double_tape_kernels_match_plain_versions(n, woven):
    """B3f and B3b on float64 planes against their float64 plain versions
    (1e-12 / 1e-10: double roundings; row sums in another order): one
    chunk a row up to 12 qubits, segments above (the segment kernel's rows
    equal ``sweep_segments``' word for word), plainly and on woven tapes;
    every call counted as a double-precision launch; a repeat bit for bit;
    RYY's sign flipped and RZZ's gradient dropped must exceed the
    tolerances."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.ops.fused_adam2d import sweep_segments
    from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays

    dev = _card()
    planes, tape, angles, cot = _double(_tape_case(
        dev, n, n_env=4 if n < 14 else 2, s_n=2, seed=40 + n))
    r = angles.shape[-1]
    sched = at.tape_schedule(*tape, n, r, torch.float64)
    if n <= at._sweep_library(torch.float64).chunk_bits():
        assert sched is None
    else:
        assert sched.cpu().tolist() == [
            sweep_segments(*(a[e].cpu().numpy() for a in tape[:3]), n)
            for e in range(tape[0].shape[0])]
    run_tape, kw = tape, dict(schedule=sched)
    if woven:
        kind = tape[0].cpu().numpy()
        rng = np.random.default_rng(n)
        live = (kind >= int(GateKind.RX)) & (kind <= int(GateKind.CX))
        kt = np.where(live & (rng.random(kind.shape) < 0.5),
                      rng.integers(5, 8, kind.shape), 0)
        kc = np.where(kind == int(GateKind.CX),
                      rng.integers(5, 7, kind.shape), 0)
        run_tape = tuple(a.to(torch.int32).contiguous()
                         for a in extend_tape_arrays(
                             tape, torch.as_tensor(kt, device=dev),
                             torch.as_tensor(kc, device=dev)))
        kw["weave"] = 3
    before = (at.apply_tape_fwd.f64_launches, at.apply_tape_bwd.f64_launches,
              at.apply_tape_fwd.sweep_launches)
    runs = []
    for _ in range(2):
        out = at.apply_tape_fwd(*planes, *run_tape, angles, **kw)
        runs.append((*out, *at.apply_tape_bwd(*out, *cot, *run_tape, angles,
                                              **kw)))
    torch.cuda.synchronize()
    assert (at.apply_tape_fwd.f64_launches, at.apply_tape_bwd.f64_launches,
            at.apply_tape_fwd.sweep_launches) == (before[0] + 2,
                                                  before[1] + 2, before[2])
    assert all(t.dtype == torch.float64 for t in runs[0])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out_p = at.apply_tape_fwd_plain(*planes, *run_tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *run_tape, angles)
    assert _max_err(runs[0][:2], out_p) <= TOL_FWD64
    assert _max_err(runs[0][2:], grads_p) <= TOL_BWD64
    if woven:
        return
    kind, _, _, slot = tape
    ryy = (kind == int(GateKind.RYY)) & (slot >= 0)
    flip = torch.ones_like(angles)
    for e in range(kind.shape[0]):
        flip[e, :, slot[e][ryy[e]].long()] = -1.0
    wrong = at.apply_tape_fwd(*planes, *tape, (angles * flip).contiguous(),
                              schedule=sched)
    assert _max_err(wrong, out_p) > 1e6 * TOL_FWD64
    rzz = (kind == int(GateKind.RZZ)) & (slot >= 0)
    dang = runs[0][4].clone()
    for e in range(kind.shape[0]):
        dang[e, :, slot[e][rzz[e]].long()] = 0.0
    assert _max_err((dang,), (grads_p[2],)) > 1e6 * TOL_BWD64


@pytest.mark.gpu
def test_double_tape_kernels_do_not_spill():
    """ptxas' report of the double-precision tape kernels' build: 0 bytes
    of spills in the whole-row and sweep forward and adjoint, gradient and
    segment kernels; and the CTAs an SM holds at 20 qubits as the runtime
    reports them, two forward (a 64 KB chunk buffer), one adjoint (psi and
    mu), with the whole-row kernels' at 12."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.ops.build import build

    _card()
    lines = build("apply_tape_f64")["log"].splitlines()
    reports = [(ln, nxt) for ln, nxt in zip(lines, lines[1:])
               if "Function properties for" in ln and "apply_tape_f64" in ln]
    names = " ".join(ln for ln, _ in reports)
    for kernel in ("fwd_row_kernel", "bwd_row_kernel", "fwd_kernel",
                   "bwd_kernel", "bwd_grad_kernel", "schedule_kernel"):
        assert kernel in names, names
    for ln, nxt in reports:
        assert "0 bytes spill stores, 0 bytes spill loads" in nxt, ln
    assert _sweep_fit_as_designed(torch.float64, 20) == (2, 1)
    fwd, bwd = at.check_sweep_fit(at._sweep_library(torch.float64), 12,
                                  torch.device("cuda"))
    assert fwd >= 2 and bwd >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["H2O8q_TNbond2", "H2O10q_TNbond2"])
def test_complex128_env_step_matches_the_cpu(config, monkeypatch):
    """A complex128 ``CircuitEnv`` on the card (the composed engine on the
    double-precision kernels, as one CUDA graph) against the same env on
    the CPU (the fused engines' plain versions in float64), with the same
    injected starts: the reset and two steps' energies within 1e-9 Ha."""
    import dataclasses

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim import angle_opt

    _card()
    keep, shift = [1.0, 1.0, 0.0], [0.0, -0.13, 0.0]
    monkeypatch.setattr(
        angle_opt, "make_multistarts",
        lambda x0, active, n_starts, *a, **k: (
            (torch.tensor(keep, dtype=x0.dtype, device=x0.device)[:, None]
             * x0[..., None, :]
             + torch.tensor(shift, dtype=x0.dtype,
                            device=x0.device)[:, None])
            * active[..., None, :]))
    conf = get_config("TensorRL_fixed/", f"{config}.cfg")
    envs = {}
    for dev in ("cpu", "cuda"):
        cfg = EnvConfig.from_conf(conf, tn_placement="fixed",
                                  noise_mode="none", seed=3, device=dev)
        envs[dev] = CircuitEnv(dataclasses.replace(
            cfg, sim_dtype="complex128", global_iters=10, n_starts=3))
    assert envs["cuda"].optimizer._pick_engine() == "composed"
    assert envs["cpu"].optimizer._pick_engine() in ("v1", "v2")
    assert envs["cuda"].psi0.dtype == torch.complex128
    for env in envs.values():
        env.reset()
    assert abs(envs["cuda"].prev_energy - envs["cpu"].prev_energy) < 1e-9
    n = envs["cpu"].num_qubits
    acts = [next(a for a, v in envs["cpu"].action_dict.items()
                 if v[0] == n and v[2] == 5 and v[3] == 3),
            next(a for a, v in envs["cpu"].action_dict.items() if v[0] == 5)]
    before = at.apply_tape_fwd.f64_launches
    for a in acts:
        for env in envs.values():
            env.step(env.action_dict[a])
        assert abs(envs["cuda"].energy - envs["cpu"].energy) < 1e-9
    torch.cuda.synchronize()
    assert at.apply_tape_fwd.f64_launches - before == 2 * (10 + 2)


# -- the tools (tools/polish_champion.py, tools/demo_20q_training.py) and
# the profiling hook (utils/profiling.py) on the card

@pytest.mark.gpu
def test_polish_on_the_card_matches_the_cpu(tmp_path):
    """``polish_champion`` on a hand-written 5q Heisenberg champion with
    one start (the exact start, no random draw), 50 iterations: on the
    card (the composed engine on the double-precision tape kernels, one
    CUDA graph, iters + 2 B3f and iters B3b launches) within 1e-9 Ha of
    ``--device cpu`` (the fused v1 engine's plain version in float64).
    Not at 8q H2O: its Hamiltonian conserves the particle number, so
    every rotation of a champion at angle 0 has an exact zero gradient,
    and rounding picks the sign of each first Adam step (the JAX script
    and the port's host run part by ~1e-7 Ha after 50 iterations
    there)."""
    import json

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.tools import polish_champion

    _card()
    art = tmp_path / "champion.json"
    art.write_text(json.dumps({
        "config": "heisenberg_5q_TNbond2", "polished_err": None,
        "gates": [[2, 0, -1], [4, 1, 0], [3, 1, -1], [1, 2, -1],
                  [4, 3, 2], [2, 4, -1], [2, 3, -1], [3, 0, -1]]}))
    flags = [str(art), "--iters", "50", "--n_starts", "1", "--seeds", "1"]
    before = (at.apply_tape_fwd.f64_launches, at.apply_tape_bwd.f64_launches,
              fused_adam.fused_adam_step.launches)
    card = polish_champion.main(flags)["f64_polished_err"]
    torch.cuda.synchronize()
    after = (at.apply_tape_fwd.f64_launches, at.apply_tape_bwd.f64_launches,
             fused_adam.fused_adam_step.launches)
    host = polish_champion.main([*flags, "--device", "cpu"])[
        "f64_polished_err"]
    assert [a - b for a, b in zip(after, before)] == [52, 50, 0]
    assert abs(card - host) < 1e-9
    assert card > 0.0


@pytest.mark.gpu
def test_demo_without_mesh_launches_the_sweep_kernel_once_a_step(tmp_path):
    """``demo_20q_training --mesh none`` on the card, one episode of two
    env steps (24 layers, the warm start's 22 among them), 3 iterations x
    4 starts: every step one launch of the v2 engine's sweep kernel, no
    other kernel; finite energies above the lower bound."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.tools import demo_20q_training

    _card()
    step = fused_adam2d.fused_adam_step2d
    counters = (fused_adam.fused_adam_step, at.apply_tape_fwd,
                at.apply_tape_bwd)
    before = (step.launches, step.sweep_launches,
              *(c.launches for c in counters))
    record = demo_20q_training.main([
        "--mesh", "none", "--episodes", "1", "--num_layers", "24",
        "--global_iters", "3", "--out", str(tmp_path / "demo.json")])
    torch.cuda.synchronize()
    after = (step.launches, step.sweep_launches,
             *(c.launches for c in counters))
    (ep,) = record["episodes"]
    assert ep["steps"] == 2
    assert [a - b for a, b in zip(after, before)] == [2, 2, 0, 0, 0]
    assert np.isfinite(ep["energies"]).all()
    assert min(ep["energies"]) > record["min_eig_bound"] - 1e-4


@pytest.mark.gpu
def test_device_trace_holds_device_events(tmp_path, monkeypatch):
    """``maybe_device_trace`` with TRLQAS_PROFILE set, around a product
    on the card: the Chrome trace it writes holds device-kernel events."""
    import json

    from tensorrl_qas_tpu_torch.utils.profiling import maybe_device_trace

    _card()
    monkeypatch.setenv("TRLQAS_PROFILE", str(tmp_path))
    with maybe_device_trace() as prof:
        a = torch.randn(256, 256, device="cuda")
        (a @ a).sum().item()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("cat") == "kernel" for ev in events)


def _device_kernels(fn, name):
    """Device kernels whose names contain ``name`` in one call of ``fn``
    (torch.profiler's CPU and CUDA activity, as ``utils/profiling.py``
    traces; read again up to twice where the trace holds no device kernel
    at all, which says nothing of the launches)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.name() for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return sum(name in n for n in names)


def _segment_mix(dev, n, dtype, seed):
    """Two envs of 2 starts at n qubits: env 0's tape on qubits 0..11
    only (one segment), env 1's across all n; in ``dtype``."""
    planes, tape, angles, cot = _tape_case(dev, n, n_env=2, s_n=2,
                                           seed=seed)
    kind, tq, cq, slot = (a.clone() for a in tape)
    tq[0] %= 12
    cq[0] = torch.where(cq[0] >= 0, (tq[0] + 1 + cq[0] % 11) % 12, -1)
    cast = dict(dtype=dtype)
    return (tuple(p.to(**cast) for p in planes), (kind, tq, cq, slot),
            angles.to(**cast), tuple(c.to(**cast) for c in cot))


# -- device kernels a call, counted by the profiler (after the tests that
# trace: a short trace in a process that profiled before held no kernel
# events) --


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [17, 20])
def test_sweep_tape_call_is_one_launch(dtype, n):
    """Above the whole rows a B3f call is one device kernel and a B3b call
    two (the segment pass and the gradient sum), whatever the segments,
    counted by the profiler; on rows of one and of several segments in
    one call, against the plain versions."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    planes, tape, angles, cot = _segment_mix(dev, n, dtype, seed=n)
    sched = at.tape_schedule(*tape, n, angles.shape[-1], dtype)
    segments = sched[:, 0].tolist()
    assert segments[0] == 1 and segments[1] >= 2, segments
    prefix = at.SWEEP_SOURCES[dtype]
    out = at.apply_tape_fwd(*planes, *tape, angles, schedule=sched)
    grads = at.apply_tape_bwd(*out, *cot, *tape, angles, schedule=sched)
    assert _device_kernels(lambda: at.apply_tape_fwd(
        *planes, *tape, angles, schedule=sched), prefix) == 1
    assert _device_kernels(lambda: at.apply_tape_bwd(
        *out, *cot, *tape, angles, schedule=sched), prefix) == 2
    out_p = at.apply_tape_fwd_plain(*planes, *tape, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *tape, angles)
    tol = (TOL_FWD, TOL_BWD) if dtype == torch.float32 else (TOL_FWD64,
                                                             TOL_BWD64)
    assert _max_err(out, out_p) <= tol[0]
    assert _max_err(grads, grads_p) <= tol[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_composed_graph_at_twenty_qubits(dtype):
    """The composed step at 20 qubits (E = 2, S = 1, the open Heisenberg
    chain; float32 through su4, complex128 in every mode) as a CUDA graph
    against the eager kernel path, bit for bit, on two batches through
    one capture; a replay's sweep tape kernels are iters + 2 forward
    kernels and 2 iters adjoint ones (one launch a B3f call, two a
    B3b)."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    dev = _card()
    n, iters = 20, 3
    pauli = _pauli(n, chain=True)
    kw = (dict(enable_2q=True) if dtype == torch.float32
          else dict(dtype=torch.complex128))
    opt = AngleOptimizer(pauli, device=dev, **kw)
    graph = opt.composed_graph()
    h_apply = opt._h_apply(dtype)
    prefix = at.SWEEP_SOURCES[dtype]
    for seed in (0, 1, 0):
        head, tail = _tapes(dev, n, 2, 1, 30, seed)
        args = (*head[:3], *(a.to(dtype) for a in (*head[3:], *tail)))
        xg, eg = graph(*args, iters=iters, lr=0.1)
        torch.cuda.synchronize()
        xe, ee = opt._fused_step_composed(*args[:5], h_apply, *args[5:],
                                          iters=iters, lr=0.1)
        assert torch.equal(xg, xe) and torch.equal(eg, ee), seed
    assert graph.captures == 1
    assert _device_kernels(lambda: graph(*args, iters=iters, lr=0.1),
                           f"{prefix}_fwd") == iters + 2
    assert _device_kernels(lambda: graph(*args, iters=iters, lr=0.1),
                           f"{prefix}_bwd") == 2 * iters
