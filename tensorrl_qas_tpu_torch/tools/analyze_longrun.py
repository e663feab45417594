"""Extract published-table metrics from a training summary.

The port's twin of the JAX package's ``scripts/analyze_longrun.py``: the
reference's headline table (image/result1.png, BASELINE.md) reports, per
problem x method, the error |E - E_min| and the depth / CNOT / ROT counts
of the discovered circuit.  This reconstructs those from the
``summary_<seed>.npy`` artifact: every episode's action-id sequence is
replayed through the same placement logic as ``CircuitEnv.step_begin``
(moments bookkeeping; TN embedding first for the in-state modes), and the
circuit at the best-error step is measured.  ``--f64`` re-evaluates the
best circuits in complex128 by the port's eager simulator (``f64_error``),
on the card, or on the host with ``--device cpu``.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.analyze_longrun \
      results_longrun/TensorRL_fixed/H2O8q_TNbond2 \
      --seed 1 [--family TensorRL_fixed/ --config H2O8q_TNbond2.cfg] [--f64]
      [--device cpu]
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
from tensorrl_qas_tpu_torch.circuits.tensor_ir import (
    SU4StateTensor,
    StateTensor,
    embed_tape,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    load_problem,
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
from tensorrl_qas_tpu_torch.train.config import get_config


def circuit_stats(action_ids, n, num_layers, action_dict, tn_tape=None,
                  zero_params=False, gate_set="cnot", return_state=False):
    """Replay an episode's action ids into a circuit; return tape stats.

    ``gate_set='su4'`` decodes with the 3n^2-entry su4 dictionary (2q
    actions are RXX/RYY/RZZ placements, ``circuits/actions.py:su4_actions``)
    into an ``SU4StateTensor``; the "cnots" key then counts two-qubit
    rotations (the su4 analog of the published CNOT column).
    ``return_state=True`` additionally returns the replayed state tensor
    (for f64 energy re-evaluation)."""
    su4 = gate_set == "su4"
    state = (SU4StateTensor if su4 else StateTensor)(num_layers, n)
    layer_offset = 0
    if tn_tape is not None:
        layer_offset = embed_tape(state, tn_tape, zero_params=zero_params)
    moments = [0] * n
    for a in action_ids:
        ctrl, offset, rot_qubit, rot_axis = action_dict[int(a)]
        targ = (ctrl + offset) % n
        if ctrl < n:
            gate_layer = max(moments[ctrl], moments[targ])
            if su4:
                state.place_two_rotation(layer_offset + gate_layer,
                                         rot_axis - 1, ctrl, targ, 0.0)
            else:
                state.place_cnot(layer_offset + gate_layer, ctrl, targ)
            m = gate_layer + 1
            moments[ctrl] = m
            moments[targ] = m
        elif rot_qubit < n:
            gate_layer = moments[rot_qubit]
            state.place_rotation(layer_offset + gate_layer, rot_axis - 1,
                                 rot_qubit, 0.0)
            moments[rot_qubit] += 1
    cnots, rots, depth = state.gate_counts()
    stats = {"depth": depth, "cnots": cnots, "rots": rots}
    if return_state:
        return stats, state
    return stats


def _rot_keys(state, n):
    """Rotation identities (layer, row, col) in to_tape slot order.

    ``rot_positions()`` covers both state-tensor classes: the cnot 1q
    axis block and the su4 2q+1q parametric block (tensor_ir.py)."""
    del n  # kept for call-site compatibility; the state knows its layout
    ls, rows, cols = state.rot_positions()
    return list(zip(ls.tolist(), rows.tolist(), cols.tolist()))


def f64_error(actions, angles, conf, tn_placement, num_layers, action_dict,
              tn_tape=None, zero_params=False, device=None):
    """Exact complex128 error of a recorded step at its stored angles.

    Float32 device runs report energies with an O(1e-5)-Ha residual even
    after Rayleigh normalization (state-trajectory rounding); this
    recomputes |E - E_min| from the summary's ``opt_ang`` at full
    precision, by the port's eager simulator in complex128 on ``device``
    (the card by default, as every entry point of the port), which is the apples-to-apples number against the
    reference's float64 qulacs/COBYLA pipeline
    (``environments/VQAs/VQE_qulacs.py:47-86``).

    Step semantics: ``opt_ang[i]`` is the optimum of the PRE-action
    circuit, and ``errors[i]`` is the post-action tape's energy with the
    freshly placed gate at angle 0 -- so the old angles are remapped onto
    the post-action tape by (layer, axis, qubit) identity and the new
    rotation (if any) enters at 0, mirroring the fused step's ``map_idx``
    permutation."""
    n = conf["env"]["num_qubits"]
    prob = load_problem(conf["problem"]["ham_type"], n,
                        geometry=conf["problem"].get("geometry", ""),
                        mapping=conf["problem"].get("mapping",
                                                    "jordan_wigner"),
                        keep_dense=False)
    angles = np.asarray(angles, dtype=np.float64).ravel()
    _, state_new = circuit_stats(actions, n, num_layers, action_dict,
                                 tn_tape, zero_params, return_state=True)
    _, state_old = circuit_stats(actions[:-1], n, num_layers, action_dict,
                                 tn_tape, zero_params, return_state=True)
    old_keys = _rot_keys(state_old, n)
    new_keys = _rot_keys(state_new, n)
    if len(old_keys) != len(angles):
        raise ValueError(f"stored angle vector ({len(angles)}) does not "
                         f"match pre-action rotations ({len(old_keys)})")
    ang_of = {k: angles[j] for j, k in enumerate(old_keys)}
    x = np.array([ang_of.get(k, 0.0) for k in new_keys] or [0.0],
                 dtype=np.float64)
    cap = state_new.data.shape[0] * n + 8
    tape = state_new.to_tape(cap, max(len(new_keys), 1))

    device, cdt = as_device(device), torch.complex128
    psi0 = zero_state(n, cdt, device)
    if tn_placement == "fixed" and conf["env"].get("tn_init"):
        qasm = resolve_warmstart_qasm(
            conf["problem"]["ham_type"], n, conf["env"]["tn_bond"],
            conf["problem"].get("geometry"), conf["problem"].get("mapping"))
        wtape = load_circuit_tape(qasm)
        psi0 = apply_tape(psi0, *wtape.arrays(), wtape.x0())
    psi = apply_tape(psi0, *tape.arrays(), x)
    e = float(pauli_expectation(psi, *prob.pauli.tensors(device, cdt)))
    return e - float(prob.min_eig)


def analyze(summary_path, conf, tn_placement, topology="all_to_all",
            zero_params=False, gate_set=None, f64=False, device=None):
    n = conf["env"]["num_qubits"]
    num_layers = conf["env"]["num_layers"]
    accept_err = conf["env"]["accept_err"]
    if gate_set is None:
        gate_set = conf["env"].get("gate_set", "cnot")
    action_dict = action_dictionary(n, topology, gate_set=gate_set)

    tn_tape = None
    if tn_placement == "in_state" and conf["env"].get("tn_init"):
        # su4 runs embed the su4-basis warm start — one resolution rule
        # shared with CircuitEnv (problems/hamiltonians.py)
        tn_tape = load_circuit_tape(resolve_warmstart_qasm(
            conf["problem"]["ham_type"], n, conf["env"]["tn_bond"],
            conf["problem"].get("geometry"), conf["problem"].get("mapping"),
            gate_set=gate_set, tn_placement=tn_placement))

    summary = np.load(summary_path, allow_pickle=True).item()
    train = summary["train"]

    best = {"error": np.inf}
    best_done = {"error": np.inf}
    n_success = 0
    for ep, rec in train.items():
        errs = np.asarray(rec["errors"], dtype=float)
        if errs.size == 0:
            continue
        rewards = rec.get("reward", [])
        success = len(rewards) > 0 and rewards[-1] >= 5.0
        n_success += int(success)
        i = int(np.argmin(errs))
        if errs[i] < best["error"]:
            best = {"error": float(errs[i]), "episode": int(ep), "step": i,
                    "actions": rec["actions"][: i + 1],
                    "angles": (rec.get("opt_ang") or [None])[
                        min(i, len(rec.get("opt_ang", [])) - 1)]}
        if success and errs[-1] < best_done["error"]:
            best_done = {"error": float(errs[-1]), "episode": int(ep),
                         "step": len(errs) - 1, "actions": rec["actions"],
                         "angles": (rec.get("opt_ang") or [None])[-1]}

    out = {"episodes": len(train), "successes": n_success,
           "accept_err": accept_err}
    for name, rec in (("best", best), ("best_done", best_done)):
        if not np.isfinite(rec["error"]):
            out[name] = None
            continue
        stats, state = circuit_stats(rec["actions"], n, num_layers,
                                     action_dict, tn_tape, zero_params,
                                     gate_set=gate_set, return_state=True)
        row = {"error": rec["error"], "episode": rec["episode"],
               "step": rec["step"], **stats}
        if f64 and rec.get("angles") is not None and gate_set == "cnot":
            row["error_f64"] = f64_error(
                rec["actions"], rec["angles"], conf, tn_placement,
                num_layers, action_dict, tn_tape, zero_params, device=device)
        out[name] = row
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="analyze_longrun")
    p.add_argument("results_dir")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--family", default=None,
                   help="config family dir (default: parent dir name + /)")
    p.add_argument("--config", default=None,
                   help="config file (default: dir name + .cfg)")
    p.add_argument("--f64", action="store_true",
                   help="re-evaluate best circuits at complex128 from the "
                        "stored opt_ang (exact errors vs the f32 device "
                        "numbers; see f64_error)")
    p.add_argument("--device", default="cuda",
                   help="where --f64 simulates (cuda: the card; cpu: the "
                        "host)")
    p.add_argument("--gate_set", choices=["cnot", "su4"], default=None,
                   help="override for summaries from runs launched with "
                        "the CLI --gate_set flag (the config corpus does "
                        "not record it)")
    p.add_argument("--topology",
                   choices=["all_to_all", "hexagon", "hexagon_full"],
                   default=None,
                   help="action-space topology of the run (default: the "
                        "config's topology key, else all_to_all); required "
                        "for summaries from runs launched with the CLI "
                        "--topology override")
    p.add_argument("--trend", action="store_true",
                   help="summarize the learning trend from events_<seed>."
                        "jsonl (rolling per-episode best-error medians vs "
                        "the warm-start gap — the round-5 'is it learning' "
                        "telemetry)")
    args = p.parse_args(argv)

    d = pathlib.Path(args.results_dir)
    family = args.family or d.parent.name + "/"
    cfg_name = args.config or d.name + ".cfg"

    if args.trend:
        ev_path = d / f"events_{args.seed}.jsonl"
        rows = [json.loads(line) for line in open(ev_path)]
        meds = [(r["iter"], r["episodes"], r.get("epsilon"),
                 r["ep_best_med20"]) for r in rows if "ep_best_med20" in r]
        out = {"events": len(rows),
               "final": rows[-1] if rows else None}
        if meds:
            # one sample per 20-episode block (completion order)
            blocks = {}
            for it, ep, eps, m in meds:
                blocks[ep // 20] = (it, ep, eps, m)
            out["ep_best_med20_by_block"] = [
                {"iter": v[0], "episodes": v[1], "epsilon": v[2],
                 "med20": v[3]} for _, v in sorted(blocks.items())]
            first, last = meds[0][3], meds[-1][3]
            out["med20_first"] = first
            out["med20_last"] = last
            out["med20_improvement"] = first - last
        print(json.dumps(out, indent=2))
        return

    conf = get_config(family, cfg_name)
    tn_placement = "fixed" if "fixed" in family.lower() else "in_state"
    zero_params = bool(conf["env"].get("zero_param_init", 0))

    topology = (args.topology or conf["env"].get("topology")
                or "all_to_all")
    out = analyze(d / f"summary_{args.seed}.npy", conf, tn_placement,
                  topology=topology, zero_params=zero_params,
                  gate_set=args.gate_set, f64=args.f64, device=args.device)
    out["family"] = family
    out["config"] = cfg_name
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
