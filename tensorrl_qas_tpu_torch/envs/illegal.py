"""Illegal-action masking.

Behavioral re-implementation of the reference's slot-based tracker
(``environments/environment_qulacs.py:466-591``).  The *spec* distilled from
that code: an action becomes illegal right after being played (replaying it
would commute/cancel trivially) and stays illegal until a later action
touches one of its qubits.  The reference realizes this with an n-slot list
manipulated in a single index pass with per-iteration re-insertion, followed
by a pairwise dedup pass and a one-step left-compaction; those passes have
observable edge-case behavior (slot-capacity overflow, duplicate handling),
so we reproduce the same three passes rather than just the clean spec.

Verified by property tests in tests/test_illegal.py.
"""

from __future__ import annotations


def _is_cnot(action, n: int) -> bool:
    return action[0] < n


def _cnot_qubits(action, n: int):
    return action[0], (action[0] + action[1]) % n


class IllegalActionTracker:
    """Tracks currently-illegal actions; decodes them to action ids."""

    def __init__(self, n_qubits: int, action_dict: dict[int, list[int]]):
        self.n = n_qubits
        self.slots: list[list[int]] = [[] for _ in range(n_qubits)]
        # reference decode scans the dict in key order and emits the id for
        # every slot match (``environment_qulacs.py:585-589``)
        self._action_dict = action_dict

    def reset(self) -> None:
        self.slots = [[] for _ in range(self.n)]

    # -- one observation pass ----------------------------------------------

    def observe(self, action) -> list[int]:
        """Process ``action`` (may be the no-op [n,n,n,n]) and return the
        decoded list of illegal action ids."""
        a = list(action)
        n = self.n
        if a[0] < n:  # CNOT phase
            self._pass(a, self._cnot_outcome)
        if a[2] < n:  # rotation phase
            self._pass(a, self._rot_outcome)
        self._dedup()
        self._compact()
        return self.decode()

    def _pass(self, action, outcome_fn) -> None:
        if all(len(s) == 0 for s in self.slots):
            self.slots[0] = action
            return
        for i in range(self.n):
            old = self.slots[i]
            if len(old) == 0:
                continue
            verdict = outcome_fn(action, old)
            if verdict == "collide":
                self.slots[i] = []
                self._append(action)
            elif verdict == "keep":
                self._append(action)
            # "skip": neither clear nor append on this iteration

    def _append(self, action) -> None:
        # the reference only ever inserts at indices 1..n-1
        for i in range(1, self.n):
            if len(self.slots[i]) == 0:
                self.slots[i] = action
                return

    def _cnot_outcome(self, new, old) -> str:
        n = self.n
        c, t = _cnot_qubits(new, n)
        if _is_cnot(old, n) or old[2] == n:
            oc, ot = _cnot_qubits(old, n)
            if c in (oc, ot) or t in (oc, ot):
                return "collide"
            return "keep"
        oq = old[2]
        if c == oq or t == oq:
            return "collide"
        return "keep"

    def _rot_outcome(self, new, old) -> str:
        n = self.n
        q, axis = new[2], new[3]
        if old[0] == n:  # old is a rotation
            if q == old[2] and axis != old[3]:
                return "collide"
            if q != old[2]:
                return "keep"
            return "skip"  # same qubit, same axis: reference appends nothing
        oc, ot = _cnot_qubits(old, n)
        if q == oc or q == ot:
            return "collide"
        return "keep"

    def _dedup(self) -> None:
        for i in range(self.n):
            for j in range(i + 1, self.n):
                if self.slots[i] == self.slots[j]:
                    if j != i + 1:
                        self.slots[i] = []
                    else:
                        self.slots[j] = []
                    break

    def _compact(self) -> None:
        for i in range(self.n - 1):
            if len(self.slots[i]) == 0:
                self.slots[i] = self.slots[i + 1]
                self.slots[i + 1] = []

    def decode(self) -> list[int]:
        ids = []
        for key, act in self._action_dict.items():
            for s in self.slots:
                if s == act:
                    ids.append(key)
        return ids

    # -- checkpointing -------------------------------------------------------

    def state_dict(self):
        return {"slots": [list(s) for s in self.slots]}

    def load_state_dict(self, d):
        self.slots = [list(s) for s in d["slots"]]
