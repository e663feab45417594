"""Smoke run of the PyTorch port on one CUDA card: both engines of the fused
Adam env step, noiseless, with depolarizing noise and with a psi0 per env,
and the vectorized trainer through each of the six kernel variants, in the
TensorRL-fixed, TensorRL-trainable and StructureRL families.

    python3 chip_smoke.py

Phases, one line each with its seconds:

1. device     -- a CUDA card must be present (no CPU fallback); prints
                 ``nvidia-smi --query-gpu=name,power.limit``.
2. build      -- compiles every kernel with nvcc into build/, one nvcc per
                 source, all started together, and prints ptxas' register /
                 shared-memory / spill lines.
3. kernel v1  -- the dense-H kernel (fused_adam_v1) against its plain
                 PyTorch version at the 8-qubit main path's shapes (E = 128
                 envs, S = 8 starts, G = R = 26, D = 256, the H2O
                 Hamiltonian, tapes drawn from a numpy seed): iters = 3
                 (x_opt, where float32 determines it, and e_new within
                 1e-5) and iters = 100 (e_new within 1e-4 Ha), or, where
                 float32 rounding decides the result, within the plain
                 version's own float32 noise (ops/fused_adam.py:agreement);
                 e_new also against the eager complex128 simulator; two
                 deliberately wrong kernel results must fail the same
                 check; then the kernel's and the plain version's times.
4. trainer v1 -- the CLI's vectorized trainer on configs/TensorRL_fixed/
                 H2O8q_TNbond2.cfg with 128 env replicas for 20 vector
                 steps, results in a temporary directory outside the
                 repository; checks the reference-schema outputs and that
                 every env step went through fused_adam_v1.
5. kernel v2  -- the flip-group kernel (fused_adam_v2) held to the same
                 rule at the 12-qubit LiH shapes (E = 16, S = 8, G = R =
                 116, D = 4096, 84 flip groups), with the same oracle,
                 controls and timing; then a 3-iteration sweep over the
                 rest of the 10-18-qubit band: H2O 10q (E = 64), Heisenberg
                 14q (E = 8, the first size with its state in global
                 memory), 16q (E = 4) and 18q (E = 2).
6. trainer v2 -- the trainer on configs/TensorRL_fixed/LIH12q_TNbond2.cfg
                 with 16 replicas for 80 vector steps (1,280 env steps, so
                 that the replay buffer passes batch 1000 and replay runs);
                 checks the outputs, that the replay ran and that every env
                 step went through fused_adam_v2.
7. kernel v1 5q -- the v1 kernel below 8 qubits (the CLI's default config,
                 heisenberg_5q_TNbond2, E = 64) at 3 iterations, with the
                 controls.
8. kernel v1n -- the noise variant of v1 at the noise config's shapes
                 (H2O8q_TNbond2_noise: E = 128, S = 8, G = R = 46, p1 = 0.01,
                 p2 = 0.05, seeds per env) against its plain version under
                 the same Philox draws, as in 3. at 3 iterations (100 in
                 19.), its e_new against the
                 eager simulator on the tape with the drawn errors woven in;
                 a third control, the noiseless kernel's result, must be
                 flagged in most envs at 3 iterations; then its times and
                 the noiseless kernel's on the same inputs.
9. p = 0      -- the noise variants of both kernels at p1 = p2 = 0 equal the
                 noiseless kernels (1e-6 allowed, bit for bit expected);
                 also reports whether two noiseless launches agree bit
                 for bit (the kernels sum in a fixed order).
10. Kraus    -- 4096 trajectory samples of the v1 noise variant on the
                 5-qubit tape of tests/test_noise_pallas.py at p1 = 0.15,
                 p2 = 0.25 (lr = 0, identity map): the mean of e_new within
                 5 sigma + 1e-3 of the exact density-matrix value; the
                 samples differ; e_new equals the plain version's within
                 1e-5.
11. trainer v1n -- the CLI's trainer on H2O8q_TNbond2_noise (depolarizing
                 noise inferred from the name) with 128 replicas for 20
                 vector steps, every step through the v1 noise variant.
12. kernel v2n -- the v2 noise variant at LiH 12q (E = 16, S = 8, G = R =
                 116) at 3 iterations with the three controls and its
                 times, then at 14q (E = 8, state in the workspace).
13. trainer v2n -- the trainer on LIH12q_TNbond2 with --noise depolarizing,
                 16 replicas, 20 vector steps, every step through the v2
                 noise variant.
14. kernel v1 trainable -- v1 at configs/TensorRL_trainable/H2O8q_TNbond2's
                 capacities (E = 128, G = 172 gates, R = 151 angles; every
                 tape opens with the embedded warm start) at 3 iterations
                 with the controls, and its time (the plain version is
                 timed in 16.).
15. rows v1p  -- v1 launched with (E, D) psi0 planes whose rows all equal
                 the shared plane gives the shared launch bit for bit (100
                 iterations).
16. kernel v1p -- v1 with a random psi0 per env (block-coordinate mode's
                 input) at the same shapes, held to its plain version at 3
                 iterations with three controls (the third: every env given
                 the first env's psi0), and its and the plain version's
                 times.
17. trainers v1 trainable / StructureRL / v1p -- the trainer on the
                 TensorRL_trainable/ and StructureRL/ H2O8q_TNbond2 configs
                 (128 replicas, 20 vector steps), through v1 with shared
                 psi0, then on the trainable config with --block_coord 3,
                 every step through v1 with per-env psi0.
18. kernel v2 trainable, rows v2p, kernel v2p, trainer v2p -- 14.-17. for
                 v2 at TensorRL_trainable/LIH12q_TNbond2 (E = 16, G = 244,
                 R = 211), the trainer with --block_coord 3 and 16
                 replicas for 20 vector steps.
19. the 100-iteration checks of 8. and 12., each when enough of the
                 deadline is left (``LONG_MIN_LEFT_S``).

The line before the last is a JSON object with one entry per kernel
variant (v1, v1 noise, v2, v2 noise, v1 and v2 per-env psi0); the last line
is {"ok": true, "device": {...}}.  Any failure, or passing the deadline,
exits non-zero without that line.

Every kernel check and timing runs at the tape capacities that the
trainer's env gives the config (``CircuitEnv.tape_capacity`` and
``rot_capacity``: num_layers less the warm start's depth, plus one, and
in the in_state families plus the warm start's gates and angles).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, NamedTuple

sys.dont_write_bytecode = True      # write nothing into the checkout

DEADLINE_S = 600
STARTS, ITERS, LR = 8, 100, 0.1
FIXED, TRAINABLE = "TensorRL_fixed/", "TensorRL_trainable/"
STRUCTURE = "StructureRL/"
V1_CONFIG, V1_ENVS, V1_STEPS = "H2O8q_TNbond2", 128, 20
V2_CONFIG, V2_ENVS, V2_STEPS = "LIH12q_TNbond2", 16, 80
V1_SMALL = ("heisenberg_5q_TNbond2", 64)      # v1 below 8 qubits
V1N_CONFIG = "H2O8q_TNbond2_noise"            # noise inferred from the name
V2N_STEPS = 20
V2N_SWEEP = (("heisenberg_14q_TNbond2", 8),)
KRAUS_ENVS, KRAUS_P = 4096, (0.15, 0.25)
# in_state placement: the 8q H2O configs with 128 replicas (v1), the 12q
# LiH config with 16 (v2); block-coordinate trainers with K = 3
T_STEPS, BLOCK_COORD = 20, ("--block_coord", "3")
TOL_P0 = 1e-6            # noise variant at p = 0 vs the noiseless kernel
# the optional 100-iteration checks of the noise variants (run last, in
# this order) run when this much of the deadline is left, about twice
# what they took on the H100: v1n's 67-101 s, v2n's 92 s
LONG_MIN_LEFT_S = {"fused_adam_v1_noise": 200, "fused_adam_v2_noise": 300}
# the rest of the band at 3 iterations: (config, envs)
SWEEP = (("H2O10q_TNbond2", 64), ("heisenberg_14q_TNbond2", 8),
         ("heisenberg_16q_TNbond2", 4), ("heisenberg_18q_TNbond2", 2))
TOL_ITERS3 = 1e-5        # x_opt and e_new after 3 Adam iterations
TOL_ITERS100 = 1e-4      # e_new (Ha) after 100 iterations: f32 summation
#                          order perturbs the Adam trajectories
# Float32 rounding decides some outputs in any float32 implementation, so
# an env whose x_opt or e_new differs may instead lie within the plain
# version's own float32 noise (ops/fused_adam.py:agreement); two
# deliberately wrong kernel results show that the check rejects errors.
TOL_ORACLE = 1e-4        # kernel e_new vs the complex128 eager simulator
FP32_PEAK_FLOPS = 67e12  # H100 SXM, non-tensor-core float32
HBM_BYTES_PER_S = 3.35e12

_phase = ["start"]


def _expire():
    print(f"DEADLINE: {DEADLINE_S} s passed in phase {_phase[0]!r}",
          flush=True)
    os._exit(124)


def phase(name):
    _phase[0] = name
    return time.perf_counter()


def done(label, t0, **info):
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{label}] {time.perf_counter() - t0:.2f} s {extra}".rstrip(),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()
    return out.splitlines()[0]


def draw_batch(rng, n_env, cap, rot_cap, n_qubits, prefix=None):
    """Mid-episode inputs: per env a tape of ``cap`` gates and ``rot_cap``
    angles that opens with the ``prefix`` tape's gates (the embedded warm
    start of in_state placement) and goes on with random CNOTs and
    rotations, the same tape plus one gate, and the angle map."""
    import numpy as np

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape

    head = []
    if prefix is not None:
        head = [(GateKind(int(prefix.kind[g])), int(prefix.tq[g]),
                 int(prefix.cq[g]), float(prefix.angles[prefix.angle_slot[g]])
                 if prefix.angle_slot[g] >= 0 else 0.0)
                for g in range(prefix.n_gates)]
    olds, news, maps, x0s, n_rots = [], [], [], [], []
    for _ in range(n_env):
        gates = []
        for _ in range(int(rng.integers(0, cap - len(head)))):
            if rng.random() < 0.4:
                c = int(rng.integers(n_qubits))
                t = int((c + 1 + rng.integers(n_qubits - 1)) % n_qubits)
                gates.append((GateKind.CX, t, c))
            else:
                gates.append((GateKind(int(rng.integers(1, 4))),
                              int(rng.integers(n_qubits)), -1))
        old = GateTape(n_qubits, cap, rot_cap)
        new = GateTape(n_qubits, cap, rot_cap)
        for gate in head:
            old.add(*gate)
            new.add(*gate)
        for k, t, c in gates:
            ang = float(rng.normal()) if c < 0 else 0.0
            old.add(k, t, c, ang)
            new.add(k, t, c, ang)
        new.add(GateKind(int(rng.integers(1, 4))), int(rng.integers(n_qubits)))
        olds.append(old.arrays())
        news.append(new.arrays())
        mi = [-1] * rot_cap
        for j in range(old.n_rots):
            mi[j] = j
        maps.append(mi)
        x0s.append(old.x0())
        n_rots.append(old.n_rots)

    def stack(tapes):
        return tuple(np.stack([t[k] for t in tapes]) for k in range(4))

    return (stack(olds), stack(news), np.asarray(maps, np.int32),
            np.stack(x0s), np.asarray(n_rots))


class Engine(NamedTuple):
    """One kernel of the fused step: its wrapper (shared by a kernel's
    variants), its variant ("" plain, "noise", or "psi0" for per-env psi0
    planes), its plain version, the H operands it takes from the
    optimizer, the dynamic shared memory one CTA takes at a case's shapes,
    and the rows of H one H psi reads (dense D, or one plane per flip
    group)."""
    name: str
    replaces: str
    source: str
    step: Callable
    variant: str
    plain: Callable
    h_ops: Callable
    smem_bytes: Callable
    h_rows: Callable

    @property
    def noise(self) -> bool:
        return self.variant == "noise"

    def launches(self) -> int:
        """This variant's launches since the wrapper's counts were set to
        0 (a launch that were noisy and per-env would count in both of
        those and make the plain count negative: none is expected)."""
        if self.variant == "noise":
            return self.step.noise_launches
        if self.variant == "psi0":
            return self.step.psi0_launches
        return (self.step.launches - self.step.noise_launches
                - self.step.psi0_launches)


# the TPU kernel each (source, variant) replaces
REPLACES = {
    ("v1", ""): "tensorrl_qas_tpu/ops/pallas_opt.py:54",
    ("v1", "noise"): "tensorrl_qas_tpu/ops/pallas_opt.py:54 (_make_kernel, "
                     "noise=(p1, p2))",
    ("v1", "psi0"): "tensorrl_qas_tpu/ops/pallas_opt.py:54 (_make_kernel; "
                    "per-env psi0, which the JAX package runs on XLA: "
                    "tensorrl_qas_tpu/optim/angle_opt.py:694-699)",
    ("v2", ""): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160",
    ("v2", "noise"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160 "
                     "(_make_kernel, noise=(p1, p2))",
    ("v2", "psi0"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:646 "
                    "(_make_kernel, per_env_psi0=True)",
}


def engines():
    """(v1, v1 noise, v2, v2 noise, v1 per-env psi0, v2 per-env psi0)."""
    from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d

    v1, v2 = fused_adam._library, fused_adam2d._library
    out = {}
    for variant in ("", "noise", "psi0"):
        suffix = f"_{variant}" if variant else ""
        noise = variant == "noise"
        out["v1" + variant] = Engine(
            name="fused_adam_v1" + suffix, replaces=REPLACES["v1", variant],
            source="tensorrl_qas_tpu_torch/csrc/fused_adam_v1.cu",
            step=fused_adam.fused_adam_step, variant=variant,
            plain=fused_adam.fused_adam_step_reference,
            h_ops=lambda opt: opt.h_planes(),
            smem_bytes=lambda case, noise=noise:
                v1().fused_adam_v1_smem_bytes(STARTS, case.g, case.r,
                                              case.n, noise),
            h_rows=lambda case: 1 << case.n)
        out["v2" + variant] = Engine(
            name="fused_adam_v2" + suffix, replaces=REPLACES["v2", variant],
            source="tensorrl_qas_tpu_torch/csrc/fused_adam_v2.cu",
            step=fused_adam2d.fused_adam_step2d, variant=variant,
            plain=fused_adam2d.fused_adam_step2d_reference,
            h_ops=lambda opt: opt.w_planes(),
            smem_bytes=lambda case, noise=noise:
                v2().fused_adam_v2_smem_bytes(case.g, case.r, case.n,
                                              case.args[7].numel(), noise),
            h_rows=lambda case: case.args[7].numel())
    return tuple(out[k] for k in ("v1", "v1noise", "v2", "v2noise",
                                  "v1psi0", "v2psi0"))


class Case:
    """Kernel inputs drawn for one config of a family: E envs of random
    mid-episode tapes at the capacities the trainer's env gives the config
    (G gates, R angles; in the in_state families every tape opens with
    the embedded warm start of the env's reset), numpy seed 1234, a random
    psi0 (one row per env for the per-env psi0 variant), starts from the
    optimizer's start rule; the problem and the H operands from that env's
    optimizer.  For a noise variant, p1 and p2 from that optimizer (the
    config's) and seeds per env from a torch generator (``noise_kw``)."""

    def __init__(self, engine, config, n_env, family=FIXED):
        import numpy as np
        import torch

        from tensorrl_qas_tpu_torch.envs.circuit_env import (
            CircuitEnv,
            EnvConfig,
        )
        from tensorrl_qas_tpu_torch.optim.angle_opt import make_multistarts
        from tensorrl_qas_tpu_torch.train.config import get_config

        dev = torch.device("cuda")
        in_state = family != FIXED
        env = CircuitEnv(EnvConfig.from_conf(
            get_config(family, f"{config}.cfg"),
            tn_placement="in_state" if in_state else "fixed",
            noise_mode="depolarizing" if engine.noise else "none",
            device="cuda"))
        self.n = n = env.num_qubits
        self.g, self.r = g, r = env.tape_capacity, env.rot_capacity
        self.n_env = n_env
        self.prob = env.problem
        self.opt = env.optimizer
        prefix = None
        if in_state:
            env.reset()
            prefix = env._tape(env.state)
        rng = np.random.default_rng(1234)
        self.old, self.new, self.maps, x0, n_rots = draw_batch(
            rng, n_env, g, r, n, prefix)
        rows = n_env if engine.variant == "psi0" else 1
        psi0 = (rng.normal(size=(rows, 1 << n))
                + 1j * rng.normal(size=(rows, 1 << n)))
        self.psi0 = psi0 / np.linalg.norm(psi0, axis=1, keepdims=True)

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)

        f32 = dict(dtype=torch.float32, device=dev)
        active = (torch.arange(r, device=dev)[None, :]
                  < torch.as_tensor(n_rots, device=dev)[:, None]).float()
        gen = torch.Generator(device=dev).manual_seed(7)
        starts = make_multistarts(torch.as_tensor(x0, **f32), active, STARTS,
                                  STARTS // 4, 0.1, gen).contiguous()
        self.args = (tuple(ints(a) for a in self.old),
                     tuple(ints(a) for a in self.new), ints(self.maps),
                     torch.as_tensor(self.psi0.real, **f32),
                     torch.as_tensor(self.psi0.imag, **f32),
                     *engine.h_ops(self.opt), starts,
                     active[:, None, :].contiguous())
        self.noise_kw = {}
        if engine.noise:
            seeds = torch.randint(
                0, 2**31 - 1, (n_env, 2), dtype=torch.int32, device=dev,
                generator=torch.Generator(device=dev).manual_seed(11))
            self.noise_kw = dict(noise=(self.opt.noise_p1,
                                        self.opt.noise_p2), seeds=seeds)

    def controls(self):
        """Deliberately wrong kernel inputs the check must reject: Adam's
        rate off by 1%, and the RY angles' gradients dropped (their
        `active` entries zeroed); for a noise variant also the noiseless
        kernel on the same inputs, for the per-env psi0 variant the first
        env's psi0 shared by all.  A 1% rate still reaches the same optima
        in 100 iterations, so that one is required to fail at 3 iterations
        only; the third control must be flagged in most envs at 3.
        -> (name, args, lr, noise keywords, iterations where it must be
        flagged, least share of envs flagged there)."""
        import numpy as np
        import torch

        from tensorrl_qas_tpu_torch.circuits.tape import GateKind

        ry = np.zeros((self.n_env, self.r), bool)
        for e in range(self.n_env):
            kinds, slots = self.old[0][e], self.old[3][e]
            ry[e, slots[(kinds == GateKind.RY) & (slots >= 0)]] = True
        active = self.args[-1]
        no_ry = (active * torch.as_tensor(~ry, dtype=torch.float32,
                                          device=active.device)[:, None, :]
                 ).contiguous()
        out = [("lr x 1.01", self.args, LR * 1.01, self.noise_kw, (3,), 0.0),
               ("RY gradients dropped", (*self.args[:-1], no_ry), LR,
                self.noise_kw, (3, ITERS), 0.0)]
        if self.noise_kw:
            out.append(("noiseless kernel", self.args, LR, {}, (3,), 0.5))
        if len(self.psi0) > 1:
            row0 = (*self.args[:3], self.args[3][:1], self.args[4][:1],
                    *self.args[5:])
            out.append(("psi0 row 0 for every env", row0, LR, {}, (3,),
                        0.5))
        return out

    def oracle_error(self, x_opt, e_new, envs, iters):
        """Largest |e_new + offset - E| over ``envs``, E from the eager
        complex128 simulator at the remapped x_opt on the new tape (for a
        noise variant with e_new's drawn errors, tag iters + 1, woven into
        the tape)."""
        import numpy as np
        import torch

        from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays
        from tensorrl_qas_tpu_torch.sim.apply import apply_tape
        from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
        from tensorrl_qas_tpu_torch.sim.noise import (
            depolarizing_draw,
            noise_thresholds,
        )

        dev = x_opt.device
        x64 = x_opt.double().cpu().numpy()
        pauli = self.prob.pauli.tensors(dev, torch.complex128)
        new = tuple(torch.as_tensor(a, device=dev) for a in self.new)
        if self.noise_kw:
            new = extend_tape_arrays(new, *depolarizing_draw(
                new[0], self.noise_kw["seeds"], iters + 1,
                noise_thresholds(*self.noise_kw["noise"])))
        err = 0.0
        for e in envs:
            mi = self.maps[e]
            x_new = np.where(mi >= 0, x64[e][np.maximum(mi, 0)], 0.0)
            psi0 = self.psi0[e if len(self.psi0) > 1 else 0]
            psi = apply_tape(torch.as_tensor(psi0, device=dev),
                             *(a[e] for a in new), x_new)
            e_ref = float(pauli_expectation(psi, *pauli))
            err = max(err, abs(e_ref - (float(e_new[e]) + self.opt.offset)))
        return err


def check_kernel(engine, case, label, iters, tol, controls=()):
    """One kernel call held against the plain version's float32 runs
    (``agreement``, under the same noise draws for a noise variant), the
    eager simulator and the controls; raises on any disagreement.  Returns
    the agreement statistics."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    t0 = phase(f"{label} iters={iters}")
    kw = case.noise_kw
    xk, ek = engine.step(*case.args, iters=iters, lr=LR, **kw)
    torch.cuda.synchronize()
    ref = fused_adam.plain_results(case.args, iters=iters, lr=LR,
                                   step=engine.plain, **kw)
    env_ok, _, stats = fused_adam.agreement(
        case.args, ref, xk, ek, tol=tol, check_x=iters == 3,
        step=engine.plain, iters=iters, **kw)
    oracle = case.oracle_error(xk, ek, range(0, case.n_env,
                                             max(1, case.n_env // 8)), iters)
    caught = {}
    for name, c_args, c_lr, c_kw, required, share in controls:
        xc, ec = engine.step(*c_args, iters=iters, lr=c_lr, **c_kw)
        c_ok, _, _ = fused_adam.agreement(case.args, ref, xc, ec, tol=tol,
                                          check_x=iters == 3,
                                          step=engine.plain, iters=iters,
                                          **kw)
        flagged = int((~c_ok).sum())
        caught[name] = f"{flagged}/{case.n_env}"
        if iters in required and (flagged == 0
                                  or flagged <= share * case.n_env):
            raise AssertionError(f"{label}: control {name!r} passed the "
                                 f"check at iters={iters} in "
                                 f"{case.n_env - flagged}/{case.n_env} envs")
    ok = (bool(env_ok.all()) and oracle <= TOL_ORACLE
          and bool(torch.isfinite(ek).all())
          and bool(torch.isfinite(xk).all()))
    info = dict(tol=tol, **stats, oracle_max_abs_err=f"{oracle:.3e}")
    if controls:
        info["controls_envs_flagged"] = caught
    done(f"{label} iters={iters}", t0, **info, ok=ok)
    if not ok:
        raise AssertionError(
            f"{label} disagrees with its plain version at iters={iters}: "
            f"envs failing {(~env_ok).nonzero().flatten().tolist()}, "
            f"oracle {oracle:.3e}")
    return stats


def flop_count(case, h_rows):
    """Floating-point operations one fused step needs on this batch (an
    FMA counts 2), from its tapes gate by gate.  Per amplitude pair a
    rotation takes 12 forward (two complex entries, one of them a real
    cos and the other a real or imaginary sin) and 32 backward (U^H on
    psi, U^T on lambda, 8 for its gradient term); H 8 forward and 16
    backward; CX, X, Y and Z none (a permutation or a sign).  A controlled
    gate touches D/4 pairs, others D/2.  Per evaluation H psi takes 8 per
    entry of the ``h_rows`` x D operand, the Rayleigh quotient 8 per
    amplitude, lambda = 2 conj(H psi) 2; each Adam update about 12 per
    active angle and start.  A noise variant's error Paulis are swaps and
    signs: no flops."""
    import numpy as np

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind

    rot = (GateKind.RX, GateKind.RY, GateKind.RZ)
    dim = 1 << case.n

    def per_pair(kinds, table):
        return sum(np.where(np.isin(kinds, k), v, 0) for k, v in table)

    def gate_flops(tape, table):
        kinds, _, cqs, _ = tape
        pairs = np.where(cqs >= 0, dim // 4, dim // 2)
        return (per_pair(kinds, table) * pairs).sum(axis=1)    # (E,)

    fwd = ((rot, 12), ((GateKind.H,), 8))
    bwd = ((rot, 32), ((GateKind.H,), 16))
    evals = (ITERS + 1) * STARTS          # iterations and the final check
    n_rot = np.isin(case.old[0], rot).sum(axis=1)
    per_env = (evals * gate_flops(case.old, fwd)
               + ITERS * STARTS * gate_flops(case.old, bwd)
               + gate_flops(case.new, fwd)
               + (evals + 1) * (h_rows * dim * 8 + dim * 8)
               + ITERS * STARTS * (dim * 2 + n_rot * 12))
    return float(per_env.sum())


def time_cuda(fn, warmup, reps):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_kernel(engine, case, label, time_plain=True):
    """Kernel ms (median of CUDA events), plain ms (one call, unless
    ``time_plain`` is False), and the bound: the larger of this batch's
    operations at the f32 peak and its bytes (inputs read once, outputs
    written once) at the HBM rate."""
    t0 = phase(f"{label} timing")
    kw = case.noise_kw
    k_ms = time_cuda(lambda: engine.step(*case.args, iters=ITERS, lr=LR,
                                         **kw), warmup=2, reps=10)
    extra = {}
    if kw:      # what the noise costs: the noiseless kernel, same inputs
        extra["noiseless_kernel_same_inputs_ms"] = "{:.4f}".format(time_cuda(
            lambda: engine.step(*case.args, iters=ITERS, lr=LR), warmup=1,
            reps=10))
    p_ms = None
    if time_plain:
        p_ms = time_cuda(lambda: engine.plain(*case.args, iters=ITERS,
                                              lr=LR, **kw), warmup=0, reps=1)
    flops = flop_count(case, engine.h_rows(case))
    seeds = [kw["seeds"]] if kw else []
    tensors = [t for a in (*case.args, *seeds)
               for t in (a if isinstance(a, tuple) else (a,))]
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + case.n_env * (case.r + 1) * 4)
    bound_ms = 1e3 * max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
    bound_by = ("operations" if flops / FP32_PEAK_FLOPS
                >= nbytes / HBM_BYTES_PER_S else "bytes")
    done(f"{label} timing", t0, kernel_ms=f"{k_ms:.4f}",
         plain_ms="not timed" if p_ms is None else f"{p_ms:.4f}",
         bound_ms=f"{bound_ms:.4f}",
         bound_by=bound_by, gflop=f"{flops / 1e9:.3f}",
         dynamic_smem_bytes_per_cta=engine.smem_bytes(case), **extra,
         library_ms="n/a (no single PyTorch call computes this fused step)")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def kernel_phase(engine, config, n_env, label, long_check=True,
                 family=FIXED, time_plain=True):
    """Both iteration counts (the 100-iteration one unless
    ``long_check`` is False) with the controls, then the timing."""
    case = Case(engine, config, n_env, family)
    print(f"[{label}] {family}{config}: E={n_env} G={case.g} R={case.r} "
          f"D={1 << case.n} psi0 rows={len(case.psi0)}", flush=True)
    stats = {}
    for iters, tol in ((3, TOL_ITERS3), (ITERS, TOL_ITERS100)):
        if iters == ITERS and not long_check:
            continue
        stats[iters] = check_kernel(engine, case, label, iters, tol,
                                    case.controls())
    return {"max_abs_err": stats[max(stats)]["e_new_max_abs_err"],
            **time_kernel(engine, case, label, time_plain)}, case


def sweep_phase(engine, sweep=SWEEP):
    for config, n_env in sweep:
        case = Case(engine, config, n_env)
        check_kernel(engine, case, f"sweep {config} E={n_env}", 3,
                     TOL_ITERS3)


def p0_phase(engine, noisy, config, n_env):
    """The noise variant at p1 = p2 = 0 against the noiseless kernel on
    the same inputs, at 100 iterations."""
    import torch

    t0 = phase(f"p=0 {noisy.name}")
    case = Case(engine, config, n_env)
    x0, e0 = engine.step(*case.args, iters=ITERS, lr=LR)
    x1, e1 = engine.step(*case.args, iters=ITERS, lr=LR)
    seeds = torch.zeros((n_env, 2), dtype=torch.int32, device="cuda")
    xp, ep = noisy.step(*case.args, iters=ITERS, lr=LR, noise=(0.0, 0.0),
                        seeds=seeds)
    torch.cuda.synchronize()
    err = max(float((xp - x0).abs().max()), float((ep - e0).abs().max()))
    ok = err <= TOL_P0
    done(f"p=0 {noisy.name}", t0, config=config, n_env=n_env,
         max_abs_diff=f"{err:.3e}",
         bit_for_bit=bool(torch.equal(xp, x0) and torch.equal(ep, e0)),
         noiseless_repeat_bit_for_bit=bool(torch.equal(x1, x0)
                                           and torch.equal(e1, e0)),
         ok=ok)
    if not ok:
        raise AssertionError(f"{noisy.name} at p = 0 differs from the "
                             f"noiseless kernel by {err:.3e}")


def psi0_rows_phase(engine, per_env, case):
    """The per-env psi0 launch with every row equal to the shared plane
    against the shared launch on ``case`` (a shared-psi0 case), at 100
    iterations: the stride only moves a pointer, so bit for bit."""
    import torch

    t0 = phase(f"rows {per_env.name}")
    xs, es = engine.step(*case.args, iters=ITERS, lr=LR)
    rows = (*case.args[:3], *(p.expand(case.n_env, -1).contiguous()
                              for p in case.args[3:5]), *case.args[5:])
    xp, ep = per_env.step(*rows, iters=ITERS, lr=LR)
    torch.cuda.synchronize()
    bit = bool(torch.equal(xp, xs) and torch.equal(ep, es))
    err = max(float((xp - xs).abs().max()), float((ep - es).abs().max()))
    done(f"rows {per_env.name}", t0, G=case.g, R=case.r, n_env=case.n_env,
         max_abs_diff=f"{err:.3e}", bit_for_bit=bit, ok=bit)
    if not bit:
        raise AssertionError(f"{per_env.name} with identical rows differs "
                             "from the shared launch")


def kraus_phase(noisy):
    """Trajectory samples of the v1 noise variant at 5 qubits against the
    exact channel (tests/test_noise_pallas.py's tape and Pauli sum)."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
    from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
    from tensorrl_qas_tpu_torch.sim.apply import zero_state
    from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
    from tensorrl_qas_tpu_torch.sim.noise import depolarizing_energy_exact

    t0 = phase("kraus")
    n, dev = 5, torch.device("cuda")
    tape = GateTape(n, 4, 4)
    tape.add(GateKind.RY, target=0, angle=0.7)
    tape.add_cx(0, 1)
    tape.add(GateKind.RX, target=2, angle=-1.1)
    tape.add_cx(1, 2)
    pauli = PauliSum.from_strings(
        [s + "I" * (n - len(s)) for s in ("Z", "IZ", "IIZ", "XX", "IYY")],
        [1.0, 0.5, -0.7, 0.9, 1.3], n)
    exact = depolarizing_energy_exact(zero_state(n), *tape.arrays(),
                                      tape.x0(), pauli.to_dense(), *KRAUS_P)
    e_n = KRAUS_ENVS
    arrs = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 .repeat(e_n, 1).contiguous() for a in tape.arrays())
    opt = AngleOptimizer(pauli, device=dev)
    psi0 = zero_state(n, torch.complex64, dev)
    x0 = torch.as_tensor(tape.x0(), dtype=torch.float32, device=dev)
    seeds = torch.randint(0, 2**31 - 1, (e_n, 2), dtype=torch.int32,
                          device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              5))
    args = (arrs, arrs, torch.arange(4, dtype=torch.int32, device=dev)
            .repeat(e_n, 1).contiguous(), psi0.real[None].contiguous(),
            psi0.imag[None].contiguous(), *opt.h_planes(),
            x0.repeat(e_n, 1, 1).contiguous(),
            torch.ones(e_n, 1, 4, device=dev))
    kw = dict(iters=1, lr=0.0, noise=KRAUS_P, seeds=seeds)
    _, ek = noisy.step(*args, **kw)
    _, ep = noisy.plain(*args, **kw)
    es = ek.double().cpu().numpy() + opt.offset
    sigma = es.std() / np.sqrt(e_n)
    dev_mean = abs(es.mean() - exact)
    plain_err = float((ek - ep).abs().max())
    ok = dev_mean < 5 * sigma + 1e-3 and es.std() > 0 and plain_err <= 1e-5
    done("kraus", t0, n_qubits=n, samples=e_n, p=KRAUS_P,
         mean=f"{es.mean():.6f}", exact=f"{exact:.6f}",
         sigma_of_mean=f"{sigma:.3e}", abs_dev=f"{dev_mean:.3e}",
         plain_max_abs_err=f"{plain_err:.3e}", ok=ok)
    if not ok:
        raise AssertionError("the v1 noise variant's trajectories miss the "
                             "Kraus channel or its plain version")


def trainer_phase(engine, config, n_env, vector_steps, label, extra=(),
                  expect_replay=True, family=FIXED):
    """The CLI's trainer on ``family``/``config`` for ``vector_steps``
    steps with every kernel's launch count set to 0 just before and read
    just after; every step must have launched ``engine`` once and no other
    kernel."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.train import cli

    variants = engines()
    out = tempfile.mkdtemp(prefix="trlqas_smoke_")
    try:
        t0 = phase(label)
        torch.cuda.reset_peak_memory_stats()
        for e in variants:
            e.step.launches = 0
            e.step.noise_launches = 0
            e.step.psi0_launches = 0
        summary = cli.run([
            "--config", config, "--experiment_name", family,
            "--vector", str(n_env), "--total_steps",
            str(n_env * vector_steps), "--results_path", out + "/",
            *extra])
        launches = {e.name: e.launches() for e in variants}
        run_dir = os.path.join(out, family, config)
        stats = np.load(os.path.join(run_dir, "summary_0.npy"),
                        allow_pickle=True).item()
        with open(os.path.join(run_dir, "events_0.jsonl")) as f:
            events = [json.loads(line) for line in f]
        keys = {"iter", "steps", "episodes", "successes", "best_error",
                "best_step_error", "epsilon", "t"}
        checks = {
            "launches == vector steps": all(
                n == (vector_steps if k == engine.name else 0)
                for k, n in launches.items()),
            "replay ran": summary["replay_steps"] > 0 or not expect_replay,
            "summary schema": set(stats) == {"train", "test"},
            "events": (len(events) == vector_steps
                       and all(keys <= set(ev) for ev in events)
                       and events[-1]["steps"] == n_env * vector_steps),
            "finite energies": bool(np.isfinite(
                [summary["best_step_error"], summary["warm_start_gap"]]
            ).all()),
        }
        done(label, t0, env_steps=summary["steps"],
             env_steps_per_s=f"{summary['steps_per_sec']:.2f}",
             replay_steps=summary["replay_steps"],
             peak_device_GiB=round(torch.cuda.max_memory_allocated() / 2**30,
                                   3),
             best_step_error_Ha=f"{summary['best_step_error']:.6e}",
             warm_start_gap_Ha=f"{summary['warm_start_gap']:.6e}",
             episodes=summary["episodes"], launches=launches,
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{label} checks failed: {checks}")
        return launches[engine.name]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def build_phase(names):
    """One nvcc per kernel source, all started together."""
    t0 = phase("build")
    from tensorrl_qas_tpu_torch.ops.build import build

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(build, names)))
    for name, info in infos.items():
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
    done("build", t0,
         nvcc_s={k: round(v["seconds"], 2) for k, v in infos.items()})


def main() -> int:
    watchdog = threading.Timer(DEADLINE_S, _expire)
    watchdog.daemon = True
    watchdog.start()
    t_start = t0 = phase("device")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", flush=True)
        return 1
    smi = smi_line()
    print(smi, flush=True)
    done("device", t0, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    v1, v1n, v2, v2n, v1p, v2p = engines()
    build_phase(("fused_adam_v1", "fused_adam_v2"))
    results = {}
    results[v1], _ = kernel_phase(v1, V1_CONFIG, V1_ENVS, "kernel v1")
    results[v1]["launches"] = trainer_phase(v1, V1_CONFIG, V1_ENVS,
                                            V1_STEPS, "trainer v1")
    results[v2], _ = kernel_phase(v2, V2_CONFIG, V2_ENVS, "kernel v2")
    sweep_phase(v2)
    results[v2]["launches"] = trainer_phase(v2, V2_CONFIG, V2_ENVS,
                                            V2_STEPS, "trainer v2")
    small = Case(v1, *V1_SMALL)
    check_kernel(v1, small, f"kernel v1 {V1_SMALL[0]} E={V1_SMALL[1]}", 3,
                 TOL_ITERS3, small.controls())

    results[v1n], case_v1n = kernel_phase(v1n, V1N_CONFIG, V1_ENVS,
                                          "kernel v1n", long_check=False)
    p0_phase(v1, v1n, V1N_CONFIG, V1_ENVS)
    p0_phase(v2, v2n, V2_CONFIG, V2_ENVS)
    kraus_phase(v1n)
    results[v1n]["launches"] = trainer_phase(v1n, V1N_CONFIG, V1_ENVS,
                                             V1_STEPS, "trainer v1n")
    results[v2n], case_v2n = kernel_phase(v2n, V2_CONFIG, V2_ENVS,
                                          "kernel v2n", long_check=False)
    sweep_phase(v2n, V2N_SWEEP)
    results[v2n]["launches"] = trainer_phase(
        v2n, V2_CONFIG, V2_ENVS, V2N_STEPS, "trainer v2n",
        extra=("--noise", "depolarizing"), expect_replay=False)

    # in_state placement: the kernels at the trainable capacities (G != R),
    # their per-env psi0 variants, and the trainers of both families
    _, case = kernel_phase(v1, V1_CONFIG, V1_ENVS, "kernel v1 trainable",
                           long_check=False, family=TRAINABLE,
                           time_plain=False)
    psi0_rows_phase(v1, v1p, case)
    results[v1p], _ = kernel_phase(v1p, V1_CONFIG, V1_ENVS, "kernel v1p",
                                   long_check=False, family=TRAINABLE)
    for family, label in ((TRAINABLE, "trainer v1 trainable"),
                          (STRUCTURE, "trainer v1 StructureRL")):
        trainer_phase(v1, V1_CONFIG, V1_ENVS, T_STEPS, label, family=family)
    results[v1p]["launches"] = trainer_phase(
        v1p, V1_CONFIG, V1_ENVS, T_STEPS, "trainer v1p", BLOCK_COORD,
        family=TRAINABLE)
    _, case = kernel_phase(v2, V2_CONFIG, V2_ENVS, "kernel v2 trainable",
                           long_check=False, family=TRAINABLE,
                           time_plain=False)
    psi0_rows_phase(v2, v2p, case)
    results[v2p], _ = kernel_phase(v2p, V2_CONFIG, V2_ENVS, "kernel v2p",
                                   long_check=False, family=TRAINABLE)
    results[v2p]["launches"] = trainer_phase(
        v2p, V2_CONFIG, V2_ENVS, T_STEPS, "trainer v2p", BLOCK_COORD,
        expect_replay=False, family=TRAINABLE)

    for engine, case in ((v1n, case_v1n), (v2n, case_v2n)):
        left = DEADLINE_S - (time.perf_counter() - t_start)
        need = LONG_MIN_LEFT_S[engine.name]
        label = "kernel " + ("v1n" if engine is v1n else "v2n")
        if left >= need:
            stats = check_kernel(engine, case, label, ITERS, TOL_ITERS100,
                                 case.controls())
            results[engine]["max_abs_err"] = stats["e_new_max_abs_err"]
        else:
            print(f"[{label} iters={ITERS}] skipped: {left:.0f} s of the "
                  f"deadline left (< {need})", flush=True)

    kernels = {"kernels": [{
        "name": e.name, "route": "cuda", "source": e.source,
        "replaces": e.replaces, "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
        for e, r in results.items()]}
    done("total", t_start)
    print(f"card: {smi}", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        print(f"FAILED in phase {_phase[0]!r}", flush=True)
        raise
    sys.exit(code)
