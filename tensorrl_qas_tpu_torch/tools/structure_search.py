"""Direct evolutionary structure search over fixed-mode correction circuits.

The port's twin of the JAX package's ``scripts/structure_search.py``, with
the same flags and JSON output plus ``--device`` and ``--sim_dtype``.  A
diagnostic companion to the RL drivers: the 8q fixed-mode runs plateau at
a bit-identical 1.077e-3 Ha across seeds, thresholds, update ratios and
optimizer budgets (RESULTS.md round 3), while the published row claims
8.9e-4 at depth 6 / 9 CNOT / 15 ROT.  This tool asks directly whether any
circuit of comparable size reaches the published error under the shipped
artifacts (reference warm-start qasm + npz eigvals), independent of the RL
search dynamics.

Method: a population of candidate gate sequences, scored by the same
batched fused optimizer the envs use (``AngleOptimizer.fused_step_batch``:
pop structures x n_starts x global_iters Adam evaluations in one call --
on the card one launch of B1 / B2, or in complex128 the composed engine
on the double-precision tape kernels), evolved by point mutation /
insertion / deletion with elitist selection; numpy drives the population.
A gradient-free architecture search without an agent; the reference has
no counterpart.

Usage:
  python -m tensorrl_qas_tpu_torch.tools.structure_search \
      --config H2O8q_TNbond2 --pop 64 --gens 400 [--device cpu] \
      [--sim_dtype complex128] [--out champion.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from tensorrl_qas_tpu_torch.circuits.actions import action_dictionary
from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
from tensorrl_qas_tpu_torch.envs.illegal import IllegalActionTracker
from tensorrl_qas_tpu_torch.train.config import get_config

RX, RY, RZ, CX = 1, 2, 3, 4     # GateKind values


def random_gate(rng, n):
    if rng.random() < 0.4:
        c = int(rng.integers(n))
        t = int(rng.integers(n - 1))
        t = t + 1 if t >= c else t
        return (CX, t, c)
    q = int(rng.integers(n))
    k = int(rng.integers(3)) + RX
    return (k, q, -1)


def random_struct(rng, n, length):
    return [random_gate(rng, n) for _ in range(int(length))]


def mutate(rng, struct, n, min_len, max_len):
    s = list(struct)
    op = rng.random()
    if op < 0.5 or len(s) <= min_len:          # point replacement
        i = int(rng.integers(len(s)))
        s[i] = random_gate(rng, n)
    elif op < 0.7 and len(s) < max_len:        # insertion
        i = int(rng.integers(len(s) + 1))
        s.insert(i, random_gate(rng, n))
    elif op < 0.85 and len(s) > min_len:       # deletion
        del s[int(rng.integers(len(s)))]
    else:                                      # transposition
        i, j = rng.integers(len(s), size=2)
        s[int(i)], s[int(j)] = s[int(j)], s[int(i)]
    return s


def encode(structs, G, R):
    """Gate lists -> padded (B, G) tape arrays + per-candidate rot counts."""
    B = len(structs)
    kind = np.zeros((B, G), dtype=np.int32)
    tq = np.zeros((B, G), dtype=np.int32)
    cq = np.full((B, G), -1, dtype=np.int32)
    slot = np.full((B, G), -1, dtype=np.int32)
    n_rot = np.zeros(B, dtype=np.int32)
    for b, s in enumerate(structs):
        r = 0
        for g, (k, t, c) in enumerate(s):
            kind[b, g], tq[b, g], cq[b, g] = k, t, c
            if k != CX:
                slot[b, g] = r
                r += 1
        n_rot[b] = r
    return (kind, tq, cq, slot), n_rot


def is_agent_playable(struct, n, adict, inv):
    """True iff the sequence passes the env's illegal-action masking at
    every step (the reference agent masks illegal ids to -inf,
    ``agents/DeepQ.py:87``; an unplayable sequence can never be produced
    by a policy, so mask-aware search keeps champions demonstrable)."""
    tracker = IllegalActionTracker(n, adict)
    cur = [n] * 4
    for (k, t, c) in struct:
        a4 = [c, (t - c) % n, n, 0] if k == CX else [n, 0, t, k]
        ill = tracker.observe(cur)            # iteration-top re-observe
        aid = inv.get(tuple(a4))
        if aid is None or aid in ill:
            return False
        tracker.observe(a4)                   # step_begin observe
        cur = a4
    return True


def stats(struct, n):
    level = np.zeros(n, dtype=np.int64)
    cx = 0
    for k, t, c in struct:
        if k == CX:
            cx += 1
            m = max(level[t], level[c]) + 1
            level[t] = m
            level[c] = m
        else:
            level[t] += 1
    return int(level.max(initial=0)), cx, sum(1 for k, _, _ in struct
                                              if k != CX)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="structure_search")
    p.add_argument("--config", default="H2O8q_TNbond2")
    p.add_argument("--experiment_name", default="TensorRL_fixed/")
    p.add_argument("--pop", type=int, default=64)
    p.add_argument("--gens", type=int, default=400)
    p.add_argument("--min_gates", type=int, default=8)
    p.add_argument("--max_gates", type=int, default=28)
    p.add_argument("--global_iters", type=int, default=100)
    p.add_argument("--n_starts", type=int, default=8)
    p.add_argument("--elite_frac", type=float, default=0.25)
    p.add_argument("--fresh_frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target", type=float, default=8.9e-4)
    p.add_argument("--out", default="")
    p.add_argument("--polish_iters", type=int, default=1000)
    p.add_argument("--stall_restart", type=int, default=150,
                   help="after this many generations without improvement, "
                        "re-seed the population from the champion under "
                        "heavy mutation (escapes collapsed diversity)")
    p.add_argument("--init", default="",
                   help="comma-separated champion JSON files (earlier --out "
                        "artifacts); their gate lists seed the initial "
                        "population (plus mutated copies) so long searches "
                        "can continue across bounded windows")
    p.add_argument("--mask_legal", type=int, default=0,
                   help="restrict the search to sequences playable under "
                        "the env's illegal-action masking (champions can "
                        "then seed --demo RL runs / be produced by a "
                        "policy)")
    p.add_argument("--device", default="cuda",
                   help="where the population is scored (cuda: the card)")
    p.add_argument("--sim_dtype", default="auto",
                   choices=["auto", "complex64", "complex128"],
                   help="statevector precision ('auto': complex64 on the "
                        "card, complex128 on the CPU)")
    args = p.parse_args(argv)

    conf = get_config(args.experiment_name, args.config + ".cfg")
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", seed=args.seed,
                              device=args.device)
    cfg.global_iters = args.global_iters
    cfg.n_starts = args.n_starts
    cfg.sim_dtype = args.sim_dtype
    env = CircuitEnv(cfg)
    n = cfg.num_qubits
    psi0 = env.psi0
    opt = env.optimizer
    e_min = env.min_eig
    G = args.max_gates
    R = args.max_gates
    ident = np.tile(np.arange(R, dtype=np.int32), (args.pop, 1))
    rng = np.random.default_rng(args.seed)

    legal = None
    if args.mask_legal:
        adict = action_dictionary(n, cfg.topology, gate_set=cfg.gate_set)
        inv = {tuple(v): k for k, v in adict.items()}
        legal = lambda s: is_agent_playable(s, n, adict, inv)  # noqa: E731

    def fresh_random():
        for _ in range(200):
            s = random_struct(rng, n, rng.integers(args.min_gates,
                                                   args.max_gates + 1))
            if legal is None or legal(s):
                return s
        raise RuntimeError("could not sample a mask-legal structure")

    pop = [fresh_random() for _ in range(args.pop)]
    n_elite = max(2, int(args.pop * args.elite_frac))
    n_fresh = max(1, int(args.pop * args.fresh_frac))
    if args.init:
        seeds = []
        for path in args.init.split(","):
            spec = json.load(open(path.strip()))
            gates = spec["gates"] if isinstance(spec, dict) else spec
            seeds.append([tuple(g) for g in gates])
        # champions + mutated copies fill the front of the population;
        # fresh randoms keep the tail for diversity
        k = 0
        for s in seeds:
            if len(s) <= args.max_gates and k < args.pop:
                pop[k] = list(s)
                k += 1
        while k < min(args.pop - n_fresh, len(seeds) * 6):
            parent = seeds[k % len(seeds)]
            if len(parent) > args.max_gates:
                break
            for _ in range(50):
                s = mutate(rng, list(parent), n, args.min_gates,
                           args.max_gates)
                if legal is None or legal(s):
                    pop[k] = s
                    break
            else:
                pop[k] = list(parent)
            k += 1
        print(f"population seeded with {len(seeds)} champions "
              f"(+{max(0, k - len(seeds))} mutants)", flush=True)
    best = (np.inf, None)
    t0 = time.time()
    stall = 0

    def mutate_k(parent, k_muts):
        for _ in range(50):
            s = parent
            for _ in range(k_muts):
                s = mutate(rng, s, n, args.min_gates, args.max_gates)
            if legal is None or legal(s):
                return s
        return list(parent)       # parent is legal by induction

    for gen in range(args.gens):
        arrs, n_rot = encode(pop, G, R)
        x0 = np.zeros((args.pop, R), dtype=np.float64)
        _, e_new, _ = opt.fused_step_batch(psi0, arrs, x0, n_rot, arrs,
                                           ident)
        err = np.asarray(e_new) - e_min
        order = np.argsort(err)
        if err[order[0]] < best[0]:
            best = (float(err[order[0]]), list(pop[order[0]]))
            stall = 0
            d, cx, rot = stats(best[1], n)
            print(f"gen {gen}: best err {best[0]:.3e}  "
                  f"depth {d} cx {cx} rot {rot}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
            if args.out:
                # incremental champion write: wall-bounded windows (timeout
                # kills) must not lose the search result
                with open(args.out, "w") as f:
                    json.dump({"config": args.config, "best_err": best[0],
                               "gates": [list(g) for g in best[1]],
                               "gen": gen, "partial": True}, f)
        else:
            stall += 1
        if stall >= args.stall_restart:
            pop = [list(best[1])] + [
                mutate_k(best[1], 3 + int(rng.integers(3)))
                for _ in range(args.pop - 1 - n_fresh)
            ] + [fresh_random() for _ in range(n_fresh)]
            stall = 0
            print(f"gen {gen}: stall restart around champion", flush=True)
            continue
        elites = [pop[i] for i in order[:n_elite]]
        nxt = list(elites)
        while len(nxt) < args.pop - n_fresh:
            parent = elites[int(rng.integers(n_elite))]
            nxt.append(mutate_k(parent, 1 + int(rng.integers(2))))
        while len(nxt) < args.pop:
            nxt.append(fresh_random())
        pop = nxt
        if gen % 25 == 0:
            print(f"gen {gen}: median err {np.median(err):.3e} "
                  f"best-so-far {best[0]:.3e}", flush=True)
        if best[0] <= args.target and gen > 20:
            print("target reached", flush=True)
            break

    # polish the champion at a large budget
    champ = best[1]
    arrs, n_rot = encode([champ] * args.pop, G, R)
    opt.iters = args.polish_iters
    _, e_new, _ = opt.fused_step_batch(
        psi0, arrs, np.zeros((args.pop, R)), n_rot, arrs, ident)
    polished = float(np.min(np.asarray(e_new)) - e_min)
    d, cx, rot = stats(champ, n)
    out = {"config": args.config, "best_err": best[0],
           "polished_err": polished, "depth": d, "cnot": cx, "rot": rot,
           "gates": champ, "gens": gen + 1,
           "wall_s": round(time.time() - t0, 1),
           "target": args.target, "e_min": float(e_min)}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
