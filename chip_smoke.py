"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, one line each with its seconds:

1. device   -- a CUDA card must be present (no CPU fallback); prints
               ``nvidia-smi --query-gpu=name,power.limit``.
2. build    -- compiles every kernel of the main path with nvcc into
               build/ and prints ptxas' register / shared-memory / spill
               lines.
3. kernel   -- the fused Adam kernel against its plain PyTorch version at
               the main path's shapes (E = 128 envs, S = 8 starts, G = R =
               47, D = 256, the 8-qubit H2O Hamiltonian, tapes drawn from
               a numpy seed): iters = 3 (x_opt, where float32 determines
               it, and e_new within 1e-5) and iters = 100 (e_new within
               1e-4 Ha), or, where float32 rounding decides the result,
               within the plain version's own float32 noise
               (ops/fused_adam.py:agreement); e_new also against
               float64 and the eager complex128 simulator; two deliberately
               wrong kernel results must fail the same check; then the
               kernel's and the plain version's times.
4. trainer  -- the CLI's vectorized trainer on configs/TensorRL_fixed/
               H2O8q_TNbond2.cfg with 128 env replicas for 20 vector steps,
               results in a temporary directory outside the repository;
               checks the reference-schema outputs and that every env step
               went through the kernel.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failure, or passing the
deadline, exits non-zero without that line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.dont_write_bytecode = True      # write nothing into the checkout

DEADLINE_S = 600
E_ENVS, STARTS, CAP, N_QUBITS, ITERS = 128, 8, 47, 8, 100
VECTOR_STEPS = 20
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


def draw_batch(rng, n_env, cap, n_qubits):
    """Main-path-shaped inputs: per env a random mid-episode tape of
    CNOTs and rotations, the same tape plus one gate, and the angle map."""
    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape

    olds, news, maps, x0s, n_rots = [], [], [], [], []
    for _ in range(n_env):
        gates = []
        for _ in range(int(rng.integers(0, cap))):
            if rng.random() < 0.4:
                c = int(rng.integers(n_qubits))
                t = int((c + 1 + rng.integers(n_qubits - 1)) % n_qubits)
                gates.append((GateKind.CX, t, c))
            else:
                gates.append((GateKind(int(rng.integers(1, 4))),
                              int(rng.integers(n_qubits)), -1))
        old = GateTape(n_qubits, cap, cap)
        new = GateTape(n_qubits, cap, cap)
        for k, t, c in gates:
            ang = float(rng.normal()) if c < 0 else 0.0
            old.add(k, t, c, ang)
            new.add(k, t, c, ang)
        new.add(GateKind(int(rng.integers(1, 4))), int(rng.integers(n_qubits)))
        olds.append(old.arrays())
        news.append(new.arrays())
        mi = [-1] * cap
        for j in range(old.n_rots):
            mi[j] = j
        maps.append(mi)
        x0s.append(old.x0())
        n_rots.append(old.n_rots)
    import numpy as np

    def stack(tapes):
        return tuple(np.stack([t[k] for t in tapes]) for k in range(4))

    return (stack(olds), stack(news), np.asarray(maps, np.int32),
            np.stack(x0s), np.asarray(n_rots))


def flop_count(old_kind, new_kind, n_starts, dim, iters):
    """Operations of one fused step on this batch: dense H psi (8 flops per
    complex multiply-add), 2x2 gate updates on the gates present (28 flops
    a pair forward, 64 backward with the gradient term), energy sums."""
    g_old = (old_kind != 0).sum(axis=1)
    g_new = (new_kind != 0).sum(axis=1)
    pairs = dim // 2
    evals = (iters + 1) * n_starts
    hpsi = (evals + 1) * dim * dim * 8
    fwd = (evals * g_old + g_new) * pairs * 28
    bwd = iters * n_starts * g_old * pairs * 64
    energy = (evals + 1) * dim * 4
    return float((hpsi + fwd + bwd + energy).sum())


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


def kernel_phase(smoke):
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind
    from tensorrl_qas_tpu_torch.ops import fused_adam
    from tensorrl_qas_tpu_torch.optim.angle_opt import (
        AngleOptimizer,
        make_multistarts,
    )
    from tensorrl_qas_tpu_torch.problems.hamiltonians import load_problem
    from tensorrl_qas_tpu_torch.sim.apply import apply_tape
    from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
    from tensorrl_qas_tpu_torch.train.config import get_config

    dev = torch.device("cuda")
    conf = get_config("TensorRL_fixed/", "H2O8q_TNbond2.cfg")
    prob = load_problem(conf["problem"]["ham_type"], N_QUBITS,
                        conf["problem"]["geometry"],
                        conf["problem"]["mapping"])
    opt = AngleOptimizer(prob.pauli, device=dev)
    hre_t, him_t = opt.h_planes()
    rng = np.random.default_rng(1234)
    old, new, maps, x0, n_rots = draw_batch(rng, E_ENVS, CAP, N_QUBITS)
    psi0 = rng.normal(size=1 << N_QUBITS) + 1j * rng.normal(
        size=1 << N_QUBITS)
    psi0 /= np.linalg.norm(psi0)

    def ints(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    f32 = dict(dtype=torch.float32, device=dev)
    x0_t = torch.as_tensor(x0, **f32)
    active = (torch.arange(CAP, device=dev)[None, :]
              < torch.as_tensor(n_rots, device=dev)[:, None]).float()
    gen = torch.Generator(device=dev).manual_seed(7)
    starts = make_multistarts(x0_t, active, STARTS, STARTS // 4, 0.1,
                              gen).contiguous()
    args = (tuple(ints(a) for a in old), tuple(ints(a) for a in new),
            ints(maps), torch.as_tensor(psi0.real[None], **f32),
            torch.as_tensor(psi0.imag[None], **f32), hre_t, him_t, starts,
            active[:, None, :].contiguous())

    # Deliberately wrong kernel results the check must reject: the kernel
    # with Adam's rate off by 1%, and with the RY angles' gradients
    # dropped (their `active` entries zeroed).  A 1% rate still reaches
    # the same optima in 100 iterations, so that one is required to fail
    # at 3 iterations only.
    ry = np.zeros((E_ENVS, CAP), bool)
    for e in range(E_ENVS):
        slots = old[3][e][(old[0][e] == GateKind.RY) & (old[3][e] >= 0)]
        ry[e, slots] = True
    no_ry = (args[8] * torch.as_tensor(~ry, **f32)[:, None, :]).contiguous()
    controls = (("lr x 1.01", args, 0.101, (3,)),
                ("RY gradients dropped", (*args[:8], no_ry), 0.1, (3, ITERS)))

    results = {}
    for iters, tol in ((3, TOL_ITERS3), (ITERS, TOL_ITERS100)):
        t0 = phase(f"kernel iters={iters}")
        xk, ek = fused_adam.fused_adam_step(*args, iters=iters, lr=0.1)
        torch.cuda.synchronize()
        ref = fused_adam.plain_results(args, iters=iters, lr=0.1)
        env_ok, _, stats = fused_adam.agreement(args, ref, xk, ek, tol=tol,
                                                check_x=iters == 3)
        # e_new through the eager simulator, independent of the plain
        # version's code (complex128, every 16th env; the kernel's
        # energies are of H - offset I)
        xk64 = xk.double().cpu().numpy()
        oracle_err = 0.0
        for e in range(0, E_ENVS, 16):
            x_new = np.where(maps[e] >= 0, xk64[e][np.maximum(maps[e], 0)],
                             0.0)
            psi = apply_tape(torch.as_tensor(psi0, device=dev),
                             *(a[e] for a in new), x_new)
            e_ref = float(pauli_expectation(
                psi, *prob.pauli.tensors(dev, torch.complex128)))
            oracle_err = max(oracle_err,
                             abs(e_ref - (float(ek[e]) + opt.offset)))
        caught = {}
        for name, c_args, c_lr, required in controls:
            xc, ec = fused_adam.fused_adam_step(*c_args, iters=iters, lr=c_lr)
            c_ok, _, _ = fused_adam.agreement(args, ref, xc, ec, tol=tol,
                                              check_x=iters == 3)
            flagged = int((~c_ok).sum())
            caught[name] = f"{flagged}/{E_ENVS}"
            if iters in required and flagged == 0:
                raise AssertionError(f"control {name!r} passed the check "
                                     f"at iters={iters}")
        ok = (bool(env_ok.all()) and oracle_err <= TOL_ORACLE
              and bool(torch.isfinite(ek).all())
              and bool(torch.isfinite(xk).all()))
        done(f"kernel iters={iters}", t0, tol=tol, **stats,
             oracle_max_abs_err=f"{oracle_err:.3e}",
             controls_envs_flagged=caught, ok=ok)
        if not ok:
            raise AssertionError(
                f"kernel disagrees with its plain version at iters={iters}: "
                f"envs failing {(~env_ok).nonzero().flatten().tolist()}, "
                f"oracle {oracle_err:.3e}")
        results[iters] = stats["e_new_max_abs_err"]

    t0 = phase("kernel timing")
    k_ms = time_cuda(lambda: fused_adam.fused_adam_step(
        *args, iters=ITERS, lr=0.1), warmup=3, reps=15)
    p_ms = time_cuda(lambda: fused_adam.fused_adam_step_reference(
        *args, iters=ITERS, lr=0.1), warmup=1, reps=3)
    flops = flop_count(old[0], new[0], STARTS, 1 << N_QUBITS, ITERS)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (*args[0], *args[1], *args[2:])) + E_ENVS * (CAP + 1) * 4
    bound_ms = 1e3 * max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
    bound_by = ("operations" if flops / FP32_PEAK_FLOPS
                >= nbytes / HBM_BYTES_PER_S else "bytes")
    done("kernel timing", t0, kernel_ms=f"{k_ms:.4f}",
         plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
         bound_by=bound_by, gflop=f"{flops / 1e9:.3f}",
         library_ms="n/a (no single PyTorch call computes this fused step)")
    smoke["kernel"] = {"max_abs_err": results[ITERS], "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}


def trainer_phase(smoke):
    import numpy as np

    from tensorrl_qas_tpu_torch.ops import fused_adam
    from tensorrl_qas_tpu_torch.train import cli

    out = tempfile.mkdtemp(prefix="trlqas_smoke_")
    try:
        t0 = phase("trainer")
        fused_adam.fused_adam_step.launches = 0
        summary = cli.run([
            "--config", "H2O8q_TNbond2", "--experiment_name",
            "TensorRL_fixed/", "--vector", str(E_ENVS), "--total_steps",
            str(E_ENVS * VECTOR_STEPS), "--results_path", out + "/"])
        launches = fused_adam.fused_adam_step.launches
        run_dir = os.path.join(out, "TensorRL_fixed", "H2O8q_TNbond2")
        stats = np.load(os.path.join(run_dir, "summary_0.npy"),
                        allow_pickle=True).item()
        with open(os.path.join(run_dir, "events_0.jsonl")) as f:
            events = [json.loads(line) for line in f]
        keys = {"iter", "steps", "episodes", "successes", "best_error",
                "best_step_error", "epsilon", "t"}
        checks = {
            "launches == vector steps": launches == VECTOR_STEPS,
            "summary schema": set(stats) == {"train", "test"},
            "events": (len(events) == VECTOR_STEPS
                       and all(keys <= set(ev) for ev in events)
                       and events[-1]["steps"] == E_ENVS * VECTOR_STEPS),
            "finite energies": bool(np.isfinite(
                [summary["best_step_error"], summary["warm_start_gap"]]
            ).all()),
        }
        done("trainer", t0, env_steps=summary["steps"],
             env_steps_per_s=f"{summary['steps_per_sec']:.2f}",
             best_step_error_Ha=f"{summary['best_step_error']:.6e}",
             warm_start_gap_Ha=f"{summary['warm_start_gap']:.6e}",
             episodes=summary["episodes"], launches=launches,
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"trainer checks failed: {checks}")
        smoke["launches"] = launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main() -> int:
    watchdog = threading.Timer(DEADLINE_S, _expire)
    watchdog.daemon = True
    watchdog.start()
    t0 = phase("device")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", flush=True)
        return 1
    smi = smi_line()
    print(smi, flush=True)
    done("device", t0, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = phase("build")
    from tensorrl_qas_tpu_torch.ops.build import build

    info = build("fused_adam_v1")
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}", flush=True)
    from tensorrl_qas_tpu_torch.ops import fused_adam

    smem = fused_adam._library().fused_adam_v1_smem_bytes(
        STARTS, CAP, CAP, N_QUBITS)
    done("build", t0, nvcc_s=f"{info['seconds']:.2f}", library=info["path"],
         dynamic_smem_bytes_per_cta=smem)

    smoke = {}
    kernel_phase(smoke)
    trainer_phase(smoke)

    k = smoke["kernel"]
    kernels = {"kernels": [{
        "name": "fused_adam_v1", "route": "cuda",
        "source": "tensorrl_qas_tpu_torch/csrc/fused_adam_v1.cu",
        "replaces": "tensorrl_qas_tpu/ops/pallas_opt.py:54",
        "launches": smoke["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}
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
