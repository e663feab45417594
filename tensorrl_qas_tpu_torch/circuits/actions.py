"""RL action-space enumeration.

An action is a 4-list ``[ctrl, offset, rot_qubit, rot_axis]``:

- CNOT action: ``ctrl < n``, target = ``(ctrl + offset) % n``, rot_qubit = n.
- Rotation action: ``rot_qubit < n``, axis in {1,2,3} = {X,Y,Z}, ctrl = n.

Enumeration order (CNOTs first, then rotations) and the reverted variants
match the reference (``environments/utils/utils.py:39-77``).  The heavy-hex
("hexagon") restricted variants match
``environments/utils/utils_topology_restrict.py:41-125`` including two
reference quirks that we reproduce bug-for-bug for parity:

1. the connectivity filter tests ``(ctrl, targ)`` tuples, and rotation
   actions decode to ``(n, 0)`` which is never an edge, so the restricted
   action space contains CNOTs only;
2. the forward and reverted n=8 edge lists differ (the forward list contains
   both directions of each edge, the reverted list only one).
"""

from itertools import product

_HEX_EDGES_FWD = {
    6: [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5)],
    8: [(0, 1), (1, 0), (0, 2), (2, 0), (0, 3), (3, 0), (3, 4), (4, 3),
        (4, 5), (5, 4), (4, 6), (6, 4), (6, 7), (7, 6)],
    10: [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (4, 6), (6, 7), (7, 8),
         (7, 9)],
}

_HEX_EDGES_REV = {
    6: [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5)],
    8: [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (4, 6), (6, 7)],
    10: [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (4, 6), (6, 7), (7, 8),
         (7, 9)],
}


def all_to_all_actions(n: int) -> dict[int, list[int]]:
    """All-to-all action dictionary: n(n-1) CNOTs then 3n rotations."""
    out = {}
    k = 0
    for c, x in product(range(n), range(1, n)):
        out[k] = [c, x, n, 0]
        k += 1
    for q, axis in product(range(n), range(1, 4)):
        out[k] = [n, 0, q, axis]
        k += 1
    return out


def all_to_all_actions_reverted(n: int) -> dict[int, list[int]]:
    """Same action set enumerated with reversed qubit/offset order."""
    out = {}
    k = 0
    for c, x in product(range(n - 1, -1, -1), range(n - 1, 0, -1)):
        out[k] = [c, x, n, 0]
        k += 1
    for q, axis in product(range(n - 1, -1, -1), range(1, 4)):
        out[k] = [n, 0, q, axis]
        k += 1
    return out


def _hex_filter(full: dict[int, list[int]], n: int, edges) -> dict[int, list[int]]:
    valid = []
    for k in sorted(full.keys()):
        act = full[k]
        ctrl = act[0]
        targ = (act[0] + act[1]) % n
        if (ctrl, targ) in edges:
            valid.append(act)
    # reference reverses the enumeration of surviving actions
    return {len(valid) - 1 - i: a for i, a in enumerate(valid)}


def hexagon_actions(n: int) -> dict[int, list[int]]:
    """Heavy-hex restricted action dictionary (CNOTs on hex edges only)."""
    return _hex_filter(all_to_all_actions(n), n, set(_HEX_EDGES_FWD[n]))


def hexagon_actions_reverted(n: int) -> dict[int, list[int]]:
    return _hex_filter(all_to_all_actions_reverted(n), n, set(_HEX_EDGES_REV[n]))


def hexagon_full_actions(n: int) -> dict[int, list[int]]:
    """Bug-FIXED heavy-hex restricted action space (extension, not parity):
    CNOTs on the hex edges PLUS the 3n single-qubit rotations.

    The reference's restricted filter drops every rotation action
    (``utils_topology_restrict.py`` quirk #1 above), which combined with
    the frozen TN warm start of the ``notin_agent`` envs leaves nothing
    to optimize — the restricted mode can never beat its warm start.
    This variant is what the filter plainly intended: hardware-restricted
    two-qubit connectivity with rotations still available."""
    full = all_to_all_actions(n)
    edges = set(_HEX_EDGES_FWD[n])
    out = {}
    k = 0
    for key in sorted(full.keys()):
        act = full[key]
        if act[0] < n:          # CNOT action: keep hex edges only
            if (act[0], (act[0] + act[1]) % n) in edges:
                out[k] = act
                k += 1
        else:                   # rotation action: keep all
            out[k] = act
            k += 1
    return out


def su4_actions(n: int) -> dict[int, list[int]]:
    """SU(4) gate-set action dictionary (reference's vestigial richer action
    set, ``environments/VQAs/VQE_qulacs_su4.py``): two-qubit Pauli rotations
    RXX/RYY/RZZ on every ordered pair replace CNOTs, plus the 3n single-qubit
    rotations.  A 2q action is ``[ctrl, offset, n, axis]`` with axis 1/2/3 =
    XX/YY/ZZ (target = (ctrl+offset) % n); 1q actions are unchanged.
    3n(n-1) + 3n = 3n^2 actions.
    """
    out = {}
    k = 0
    for c, x, axis in product(range(n), range(1, n), range(1, 4)):
        out[k] = [c, x, n, axis]
        k += 1
    for q, axis in product(range(n), range(1, 4)):
        out[k] = [n, 0, q, axis]
        k += 1
    return out


def action_dictionary(n: int, topology: str = "all_to_all",
                      reverted: bool = False,
                      gate_set: str = "cnot") -> dict[int, list[int]]:
    """Uniform entry point used by envs and agents."""
    if gate_set == "su4":
        if topology != "all_to_all":
            raise ValueError("su4 gate set supports all_to_all topology only")
        return su4_actions(n)
    if gate_set != "cnot":
        raise ValueError(f"unknown gate_set {gate_set!r}")
    if topology == "all_to_all":
        return all_to_all_actions_reverted(n) if reverted else all_to_all_actions(n)
    if topology == "hexagon":
        return hexagon_actions_reverted(n) if reverted else hexagon_actions(n)
    if topology == "hexagon_full":
        # no reverted enumeration: this is an extension with a single
        # canonical order (CNOTs-then-rotations, forward)
        return hexagon_full_actions(n)
    raise ValueError(f"unknown topology {topology!r}")
