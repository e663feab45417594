"""Deep complex128 re-optimization of a run's best discovered circuits.

The port's twin of the JAX package's ``scripts/polish_best.py``, with the
same flags and JSON rows plus ``--device``.  ``analyze_longrun --f64``
re-*evaluates* the stored angles exactly; this re-*optimizes* them with a
large Adam budget (default 3000 iterations x 8 starts x 3 restarts,
warm-started at the stored optimum plus fresh restarts).  The gap between
the two quantifies how much energy the run-time optimizer budget
(reference-mapped ``global_iters``) left on the table for the *same
discovered structure* -- the reference's equivalent knob is COBYLA
``maxiter`` (``environment_qulacs.py:436-441``).

On the card the optimizer runs in complex128 through the composed engine
on the double-precision tape kernels (one CUDA graph a step shape, replayed
by the later restarts and candidates of the same shape); on the host
through the fused engines' plain versions in float64.  One optimizer
serves every restart, its generator re-seeded per restart.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.polish_best <results_dir> \
      [--seed N] [--iters 3000] [--n_starts 8] [--restarts 3] \
      [--which best] [--topk K] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from tensorrl_qas_tpu_torch import as_device
from tensorrl_qas_tpu_torch.circuits.actions import action_dictionary
from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    load_problem,
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.tools.analyze_longrun import (
    _rot_keys,
    circuit_stats,
)
from tensorrl_qas_tpu_torch.train.config import get_config


def candidates(train: dict, which: str = "best", topk: int = 1) -> list:
    """The ``topk`` lowest-error steps of distinct action prefixes: per
    episode its best step (``which='best'``) or its last step if the
    episode finished (``'best_done'``: last reward >= 5), each with the
    action prefix and the stored pre-action angles (``opt_ang``)."""
    cands = []
    for ep, rec in train.items():
        errs = np.asarray(rec["errors"], dtype=float)
        if errs.size == 0:
            continue
        if which == "best_done":
            rewards = rec.get("reward", [])
            if not (len(rewards) > 0 and rewards[-1] >= 5.0):
                continue
            i = len(errs) - 1
        else:
            i = int(np.argmin(errs))
        cands.append({"error": float(errs[i]), "episode": int(ep),
                      "step": i, "actions": rec["actions"][: i + 1],
                      "angles": (rec.get("opt_ang") or [None])[
                          min(i, len(rec.get("opt_ang", [])) - 1)]})
    cands.sort(key=lambda c: c["error"])
    seen, picked = set(), []
    for c in cands:
        key = tuple(int(a) for a in c["actions"])
        if key in seen:
            continue
        seen.add(key)
        picked.append(c)
        if len(picked) >= topk:
            break
    return picked


def main(argv=None) -> list:
    p = argparse.ArgumentParser(prog="polish_best")
    p.add_argument("results_dir")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--family", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--n_starts", type=int, default=8)
    p.add_argument("--restarts", type=int, default=3)
    p.add_argument("--which", choices=["best", "best_done"], default="best")
    p.add_argument("--topology", default=None)
    p.add_argument("--gate_set", choices=["cnot", "su4"], default=None,
                   help="action basis of the run (default: the config's "
                        "gate_set key, else cnot); required for summaries "
                        "from runs launched with the CLI --gate_set flag")
    p.add_argument("--topk", type=int, default=1,
                   help="polish the K best *distinct-structure* episodes "
                        "(distinct action prefixes), not just the single "
                        "best -- tests whether a run's near-floor circuits "
                        "share one variational attractor")
    p.add_argument("--device", default="cuda",
                   help="where the polish runs (cuda: the card; cpu: the "
                        "host)")
    args = p.parse_args(argv)

    d = pathlib.Path(args.results_dir)
    family = args.family or d.parent.name + "/"
    cfg_name = args.config or d.name + ".cfg"
    conf = get_config(family, cfg_name)
    tn_placement = "fixed" if "fixed" in family.lower() else "in_state"
    zero_params = bool(conf["env"].get("zero_param_init", 0))
    n = conf["env"]["num_qubits"]
    num_layers = conf["env"]["num_layers"]
    topology = (args.topology or conf["env"].get("topology")
                or "all_to_all")
    gate_set = args.gate_set or conf["env"].get("gate_set", "cnot")
    action_dict = action_dictionary(n, topology, gate_set=gate_set)

    def warm_tape():
        return load_circuit_tape(resolve_warmstart_qasm(
            conf["problem"]["ham_type"], n, conf["env"]["tn_bond"],
            conf["problem"].get("geometry"), conf["problem"].get("mapping"),
            gate_set=gate_set, tn_placement=tn_placement))

    tn_tape = None
    if tn_placement == "in_state" and conf["env"].get("tn_init"):
        tn_tape = warm_tape()

    summary = np.load(d / f"summary_{args.seed}.npy",
                      allow_pickle=True).item()["train"]
    picked = candidates(summary, args.which, args.topk)
    if not picked:
        raise SystemExit("no episodes recorded")

    prob = load_problem(conf["problem"]["ham_type"], n,
                        geometry=conf["problem"].get("geometry", ""),
                        mapping=conf["problem"].get("mapping",
                                                    "jordan_wigner"),
                        keep_dense=False)
    dev = as_device(args.device)
    psi0 = zero_state(n, torch.complex128, dev)
    if tn_placement == "fixed" and conf["env"].get("tn_init"):
        # the simulator applies RXX / RYY / RZZ whatever the gate set (the
        # script's enable_2q=(gate_set == 'su4')): a cnot warm start has
        # none
        wtape = warm_tape()
        psi0 = apply_tape(psi0, *wtape.arrays(), wtape.x0())
    opt = AngleOptimizer(prob.pauli, iters=args.iters,
                         n_starts=args.n_starts, device=dev,
                         dtype=torch.complex128,
                         enable_2q=(gate_set == "su4"))
    e_min = float(prob.min_eig)

    rows = []
    for best in picked:
        # rebuild post-action tape + remapped pre-action angles (map_idx
        # semantics, same as analyze_longrun.f64_error)
        stats, state_new = circuit_stats(best["actions"], n, num_layers,
                                         action_dict, tn_tape, zero_params,
                                         gate_set=gate_set,
                                         return_state=True)
        _, state_old = circuit_stats(best["actions"][:-1], n, num_layers,
                                     action_dict, tn_tape, zero_params,
                                     gate_set=gate_set,
                                     return_state=True)
        angles = np.asarray(best["angles"], dtype=np.float64).ravel()
        old_keys = _rot_keys(state_old, n)
        new_keys = _rot_keys(state_new, n)
        ang_of = {k: angles[j] for j, k in enumerate(old_keys)}
        x0 = np.array([ang_of.get(k, 0.0) for k in new_keys] or [0.0],
                      dtype=np.float64)
        cap = state_new.data.shape[0] * n + 8
        tape = state_new.to_tape(cap, max(len(new_keys), 1))
        results = []
        pad = np.zeros(tape.angles.shape[0], dtype=np.float64)
        pad[: len(x0)] = x0
        for s in range(args.restarts):
            opt.generator.manual_seed(s)
            _, e, _ = opt.optimize(psi0, tape.arrays(), pad, tape.n_rots)
            results.append(e - e_min)
        row = {"results_dir": str(d), "which": args.which,
               "episode": best["episode"], "step": best["step"],
               "run_error": best["error"], **stats,
               "polished_f64_error": float(np.min(results)),
               "iters": args.iters, "n_starts": args.n_starts,
               "restarts": args.restarts}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
