"""Time the v2 kernel's first design (17-18 qubits) with and without its
unreachable shared-memory state path, on one CUDA card.

``tensorrl_qas_tpu_torch/csrc/fused_adam_v2.cu`` keeps, in
``fused_adam_v2_kernel``, a branch for psi and lambda in shared memory
(``kSmemStateMaxQubits``) that the routing never takes.  This script
builds the source as it is and three variants without that branch, in
parallel with nvcc (``-Xptxas -v``, the flags of ``ops/build.py``) into
``build/variants/``, prints each variant's ptxas line for the first design,
and times each at 17 qubits (open Heisenberg chain, E = 4) and 18 qubits
(``heisenberg_18q_TNbond2``, E = 2 and 8), S = 8, G = R = 46, 100 Adam
iterations, in the order A B C D D C B A (median of 3 launches by CUDA
events each time).  Every variant's results must equal the first's bit
for bit.

Variants: ``as_is`` (the source), ``deleted`` (the branch removed),
``deleted_lb1`` (and ``__launch_bounds__(512, 1)``: no spills),
``deleted_generic`` (the workspace pointer passed through an empty asm,
so that its loads and stores stay generic as with the branch).

    python3 scripts/torch_first_design_variants.py
"""

import ctypes
import pathlib
import subprocess
import sys

sys.dont_write_bytecode = True
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tensorrl_qas_tpu_torch.ops import build, fused_adam2d  # noqa: E402

SOURCE = (build.CSRC / "fused_adam_v2.cu").read_text()
BRANCH = """  float* state = f;
  if (work == nullptr) {                  // dead (kSmemStateMaxQubits)
    f += 4 * D;
  } else {
    state = work + (size_t)row * 4 * D;
  }
"""
GLOBAL_STATE = "  float* state = work + (size_t)row * 4 * D;\n"
GENERIC_STATE = GLOBAL_STATE + """#ifdef __CUDA_ARCH__
  asm("" : "+l"(state));
#endif
"""
BOUNDS = "__global__ void __launch_bounds__(kThreads)\nfused_adam_v2_kernel("
BOUNDS_1 = ("__global__ void __launch_bounds__(kThreads, 1)\n"
            "fused_adam_v2_kernel(")


def without_branch(src: str, state: str) -> str:
    """``src`` with the first design's shared-memory state path removed
    and ``state`` declaring the state pointer."""
    out = src.replace(BRANCH, state)
    for old, new in (
            ("bool state_in_smem(int n) { return n <= kSmemStateMaxQubits; }"
             "\n", ""),
            ("return cluster_size(n) == 0 && !state_in_smem(n);",
             "return cluster_size(n) == 0;"),
            ("const size_t state = state_in_smem(n) ? (size_t)4 << n : 0;",
             "const size_t state = 0;")):
        if old not in out:
            raise SystemExit(f"source changed: {old!r} not found")
        out = out.replace(old, new)
    return out


def variants() -> dict:
    for text in (BRANCH, BOUNDS):
        if text not in SOURCE:
            raise SystemExit(f"source changed: {text!r} not found")
    deleted = without_branch(SOURCE, GLOBAL_STATE)
    return {"as_is": SOURCE, "deleted": deleted,
            "deleted_lb1": deleted.replace(BOUNDS, BOUNDS_1),
            "deleted_generic": without_branch(SOURCE, GENERIC_STATE)}


def build_all(texts: dict) -> dict:
    """Compile every variant at once; print its first-design ptxas line.
    -> {name: library bound like the card's}."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"fused_adam_v2_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"lib_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if ("Function properties" in line
                    and "fused_adam_v2_kernelE" in line):
                print(f"ptxas {name}: {lines[i + 1].strip()} | "
                      f"{lines[i + 2].strip()}", flush=True)
        libs[name] = fused_adam2d.bind(
            ctypes.CDLL(str(out / f"lib_{name}.so")))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    libs = build_all(variants())
    print(cs.smi_line(), flush=True)
    v2 = cs.engines()[2]
    cases = {
        "17q chain E=4": cs.Case(v2, None, 4, caps=(46, 46),
                                 pauli=cs.heisenberg_chain(17)),
        "18q E=2": cs.Case(v2, "heisenberg_18q_TNbond2", 2),
        "18q E=8": cs.Case(v2, "heisenberg_18q_TNbond2", 8)}
    stream = torch.cuda.current_stream().cuda_stream
    times, diffs, first = {}, {}, {}
    for name in [*libs, *reversed(list(libs))]:
        for key, case in cases.items():
            def run(lib=libs[name], case=case):
                return fused_adam2d.run_kernel(
                    lib, *case.args, iters=cs.ITERS, lr=cs.LR, noise=None,
                    seeds=None, stream=stream)[2:]
            x, e = run()
            torch.cuda.synchronize()
            x0, e0 = first.setdefault(key, (x, e))
            diffs.setdefault((name, key), []).append(max(
                float((x - x0).abs().max()), float((e - e0).abs().max())))
            times.setdefault((name, key), []).append(
                cs.time_cuda(run, warmup=0, reps=3))
    for (name, key), ms in times.items():
        print(f"{name:16s} {key:14s} ms "
              + " / ".join(f"{t:.4f}" for t in ms)
              + "  max |diff| from the first run "
              + " / ".join(f"{d:.3e}" for d in diffs[name, key]))
    same = not any(d for ds in diffs.values() for d in ds)
    print(f"all variants bit for bit: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
