"""Typed INI config loading, compatible with the reference .cfg corpus.

The reference parses its INI files with configparser plus hand-maintained
per-key type-coercion lists (``environments/utils/utils.py:6-36``; note
configparser lowercases keys, so ``TN_bond`` in a .cfg surfaces as
``tn_bond``).  We reproduce the same coercion table so every shipped config
family (TensorRL_fixed / TensorRL_trainable / StructureRL) loads with
identical values, and search both our ``configs/`` corpus and a reference
checkout's ``configuration_files/``.
"""

from __future__ import annotations

import configparser
import json
import os
import pathlib

_FLOAT_KEYS = {
    "learning_rate", "dropout", "alpha", "beta", "beta_incr",
    "shift_threshold_ball", "succes_switch", "tolearance_to_thresh",
    "memory_reset_threshold", "fake_min_energy", "_true_en",
}
_STRING_KEYS = {
    "ham_type", "fn_type", "geometry", "method", "agent_type", "agent_class",
    "init_seed", "init_path", "init_thresh", "mapping", "optim_alg",
    "curriculum_type",
}
_LIST_KEYS = {
    "episodes", "neurons", "accept_err", "epsilon_decay", "epsilon_min",
    "final_gamma", "memory_clean", "update_target_net", "epsilon_restart",
    "thresholds", "switch_episodes",
}

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG_SEARCH_PATHS = [
    os.environ.get("TRLQAS_CONFIG_DIR", ""),
    str(_REPO_ROOT / "configs"),
    # a TensorRL-QAS checkout's configuration_files/ can be added explicitly:
    os.environ.get("TRLQAS_REFERENCE_CONFIGS", ""),
]


def _coerce(key: str, val: str):
    if key in _FLOAT_KEYS:
        return float(val)
    if key in _STRING_KEYS:
        return str(val)
    if key in _LIST_KEYS:
        return json.loads(val)
    try:
        return int(val)
    except ValueError:
        return val


def load_config_file(path: str) -> dict:
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_string(f.read())
    out = {}
    for section in cp.sections():
        out[section] = {k: _coerce(k, v) for k, v in cp.items(section)}
    return out


def get_config(experiment_name: str, config_file: str) -> dict:
    """Reference-compatible lookup: ``<base>/<experiment_name><config_file>``
    where experiment_name typically ends in '/' (e.g. 'TensorRL_fixed/')."""
    rel = f"{experiment_name}{config_file}"
    for base in CONFIG_SEARCH_PATHS:
        if not base:
            continue
        cand = os.path.join(base, rel)
        if os.path.exists(cand):
            return load_config_file(cand)
    raise FileNotFoundError(
        f"config {rel!r} not found under any of {CONFIG_SEARCH_PATHS}")
