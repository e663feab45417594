"""Multi-seed training launcher.

The port's twin of the JAX package's ``scripts/train_multiseed.py``.  The
reference's experimental protocol runs many ``--seed`` jobs by hand
(``README.md:61``); this launcher runs S seeds of the port's CLI
(``tensorrl_qas_tpu_torch.train.cli``) as parallel worker processes, each
an independent training run.  Every flag it does not know passes through
to the CLI, ``--device`` / ``--gpu_id`` / ``--sim_dtype`` included; it
pins no device itself.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.train_multiseed --seeds 0 1 2 3 \\
      --config heisenberg_5q_TNbond2 --experiment_name TensorRL_fixed/ \\
      --episodes 100
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="train_multiseed")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--max_parallel", type=int, default=4)
    args, passthrough = p.parse_known_args(argv)

    repo = pathlib.Path(__file__).resolve().parents[2]
    procs = []
    results = {}
    pending = list(args.seeds)
    while pending or procs:
        while pending and len(procs) < args.max_parallel:
            seed = pending.pop(0)
            cmd = [sys.executable, "-m", "tensorrl_qas_tpu_torch.train.cli",
                   "--seed", str(seed)] + passthrough
            print("launch:", " ".join(cmd), flush=True)
            procs.append((seed, subprocess.Popen(cmd, cwd=repo)))
        seed, proc = procs.pop(0)
        rc = proc.wait()
        results[seed] = rc
        print(f"seed {seed} exited with {rc}", flush=True)
    bad = {s: rc for s, rc in results.items() if rc != 0}
    if bad:
        print("FAILED seeds:", bad)
        return 1
    print("all seeds completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
