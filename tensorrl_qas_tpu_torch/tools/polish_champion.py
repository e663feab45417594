"""Definitive complex128 polish of a structure-search champion circuit.

The port's twin of the JAX package's ``scripts/polish_champion.py``, with
the same positional artifact, flags and output plus ``--device``.
``tools/structure_search.py`` artifacts carry ``best_err`` /
``polished_err`` evaluated at the search's run dtype (complex64 on the
card); this re-optimizes the SAME structure in complex128 with a large
multi-start Adam budget and reports the f64 error -- the number the
published-table comparison wants (the reference evaluates with qulacs
float64, ``VQE_qulacs.py:47-86``).

The circuit is exactly what the RL env plays: the config's TN warm start
as the fixed initial state, then the champion's (kind, target, control)
gate list with all rotation angles re-optimized jointly.  Each seed is one
fused step with the identity map.  One optimizer serves every seed, its
generator re-seeded per seed: on the card the step is the composed engine
on the double-precision tape kernels, captured as a CUDA graph at the
first seed and replayed at the others.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.polish_champion champion.json \
      [--iters 3000] [--n_starts 8] [--seeds 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.circuits.qasm import load_qasm_tape
from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    load_problem,
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.train.config import get_config


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="polish_champion")
    p.add_argument("artifact")
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--n_starts", type=int, default=8)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="where the polish runs (cuda: the card; cpu: the "
                        "host)")
    args = p.parse_args(argv)

    with open(args.artifact) as f:
        art = json.load(f)
    conf = get_config("TensorRL_fixed/", art["config"] + ".cfg")
    n = conf["env"]["num_qubits"]
    tn_bond = conf["env"]["tn_bond"]
    ham = conf["problem"]["ham_type"]
    geometry = conf["problem"].get("geometry", "")
    if not isinstance(geometry, str):
        geometry = str(geometry)
    mapping = conf["problem"].get("mapping", "jordan_wigner")
    prob = load_problem(ham, n, geometry, mapping, keep_dense=False)

    ws = load_qasm_tape(resolve_warmstart_qasm(ham, n, tn_bond, geometry,
                                               mapping))
    dev = as_device(args.device)
    psi0 = apply_tape(zero_state(n, torch.complex128, dev), *ws.arrays(),
                      ws.x0())

    gates = art["gates"]
    tape = GateTape(n, len(gates) + 1, len(gates) + 1)
    for k, t, c in gates:
        if k == 4:
            tape.add(GateKind.CX, target=t, control=c)
        else:
            tape.add(GateKind(int(GateKind.RX) + (k - 1)), t, angle=0.0)
    arrs = tape.arrays()
    x0 = tape.x0().astype(np.float64)
    map_idx = np.arange(len(x0), dtype=np.int32)

    opt = AngleOptimizer(prob.pauli, iters=args.iters,
                         n_starts=args.n_starts, device=dev,
                         dtype=torch.complex128)
    best = np.inf
    for seed in range(args.seeds):
        opt.generator.manual_seed(seed)
        _, e, _ = opt.fused_step(psi0, arrs, x0, tape.n_rots, arrs, map_idx)
        err = e - prob.min_eig
        print(f"seed {seed}: E={e:.12f}  err={err:.6e}", flush=True)
        best = min(best, err)
    out = {"artifact": args.artifact, "config": art["config"],
           "f64_polished_err": float(best), "iters": args.iters,
           "n_starts": args.n_starts, "seeds": args.seeds,
           "search_reported_err": art.get("polished_err")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
