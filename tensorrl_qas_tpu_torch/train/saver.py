"""Per-episode metrics accumulation.

Writes the exact ``summary_<seed>.npy`` schema the reference's analysis
notebooks consume (``TensorRL_fixed_noiseless.py:15-50``): a dict
``{'train': {ep: {...}}, 'test': {...}}`` with per-step lists for loss,
actions, errors, nfev, opt_ang, time, reward, plus per-episode scalars.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

_TRAIN_KEYS = ("loss", "actions", "errors", "errors_noiseless", "nfev",
               "opt_ang", "time", "save_circ", "reward")
_TEST_KEYS = ("actions", "errors", "errors_noiseless", "nfev", "opt_ang",
              "time")


class Saver:
    def __init__(self, results_path: str, experiment_seed: int):
        self.stats = {"train": {}, "test": {}}
        self.seed = experiment_seed
        self.rpath = results_path
        os.makedirs(results_path, exist_ok=True)

    def new_episode(self, mode: str, episode: int) -> None:
        keys = _TRAIN_KEYS if mode == "train" else _TEST_KEYS
        rec = {k: [] for k in keys}
        rec["done_threshold"] = 0
        rec["bond_distance"] = 0
        self.stats[mode][episode] = rec

    def append(self, mode: str, episode: int, **kv) -> None:
        rec = self.stats[mode][episode]
        for k, v in kv.items():
            rec[k].append(v)

    def set(self, mode: str, episode: int, **kv) -> None:
        self.stats[mode][episode].update(kv)

    def validate(self, mode: str, episode: int) -> None:
        rec = self.stats[mode][episode]
        assert len(rec["actions"]) == len(rec["errors"])

    def save(self) -> None:
        np.save(f"{self.rpath}/summary_{self.seed}.npy", self.stats)  # noqa: NPY002

    def save_jsonl_event(self, event: dict) -> None:
        """Structured observability stream alongside the npy blob."""
        event = dict(event)
        event["t"] = time.time()
        with open(f"{self.rpath}/events_{self.seed}.jsonl", "a") as f:
            f.write(json.dumps(event) + "\n")
