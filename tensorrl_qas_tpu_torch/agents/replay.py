"""Experience replay buffer.

``DeviceReplay`` keeps the ring on the agent's device as torch tensors:
transitions accumulate in a small host list and are flushed in one
scatter before sampling, and the train step gathers its batch on the
device by index, so the (batch, state) tensors never cross the host
boundary.  n-step reward folding happens at push time
(``agents/DeepQNstep.py:59-99``).  ``PrioritizedReplayMemory`` adds
alpha-prioritized sampling with importance weights on the same ring.
"""

from __future__ import annotations

import json
from collections import deque

import numpy as np
import torch


def rng_state_json(rng: np.random.Generator) -> str:
    """Serialize a numpy Generator's exact bit state (json: the PCG64
    state holds 128-bit ints, which msgpack/npz can't carry natively)."""
    return json.dumps(rng.bit_generator.state)


def restore_rng(rng: np.random.Generator, state_json) -> None:
    rng.bit_generator.state = json.loads(str(state_json))


def _fold_windows_pickle(window, windows) -> np.ndarray:
    """n-step fold windows as a npz-safe uint8 blob.

    The fold window persists ACROSS episodes (reference
    ``DeepQNstep.py:59-99`` never clears it; the early-done cut handles
    episode boundaries), so exact resume must carry the in-flight
    transitions too, not just the ring buffer."""
    import pickle

    blob = pickle.dumps({"window": list(window),
                         "windows": {k: list(v) for k, v in windows.items()}})
    return np.frombuffer(blob, dtype=np.uint8)


def _unfold_windows_pickle(arr, maxlen: int):
    import pickle

    d = pickle.loads(np.asarray(arr, dtype=np.uint8).tobytes())
    window = deque(d["window"], maxlen=maxlen)
    windows = {k: deque(v, maxlen=maxlen) for k, v in d["windows"].items()}
    return window, windows


class DeviceReplay:
    """Uniform replay ring on a torch device, with optional n-step folding.

    Same push / fold / sample semantics as the JAX package's
    ``DeviceReplay`` (index sampling on the host with a numpy Generator,
    so both packages draw the same batch indices from the same seed).
    """

    def __init__(self, capacity: int, state_size: int, seed: int = 0,
                 n_step: int = 0, gamma: float = 1.0, device="cpu"):
        self.capacity = capacity
        self.state_size = state_size
        self.rng = np.random.default_rng(seed)
        self.n_step = n_step
        self.gamma = gamma
        self.device = torch.device(device)
        self.window: deque = deque(maxlen=max(n_step, 1))
        self._windows: dict = {}     # per-env fold windows (see push)
        self._pending: list = []
        self._alloc()

    def _alloc(self):
        c, s, dev = self.capacity, self.state_size, self.device
        self.states = torch.zeros((c, s), dtype=torch.float32, device=dev)
        self.next_states = torch.zeros((c, s), dtype=torch.float32,
                                       device=dev)
        self.actions = torch.zeros(c, dtype=torch.int64, device=dev)
        self.rewards = torch.zeros(c, dtype=torch.float32, device=dev)
        self.dones = torch.zeros(c, dtype=torch.float32, device=dev)
        self.demos = torch.zeros(c, dtype=torch.float32, device=dev)
        self.position = 0
        self.size = 0

    def push(self, state, action, reward, next_state, done,
             env_id=0, is_demo: float = 0.0) -> None:
        """``env_id`` keys the n-step fold window, so transitions of
        different env replicas fold independently; the default (0) is the
        reference's single stream."""
        if self.n_step:
            window = self._window_for(env_id)
            window.append((state, action, reward, next_state, done))
            if len(window) < self.n_step:
                return
            r, ns, dn = self._fold(window)
            s0, a0 = window[0][0], window[0][1]
            self._pending.append((s0, a0, r, ns, dn, is_demo))
        else:
            self._pending.append((state, action, reward, next_state, done,
                                  is_demo))

    def _window_for(self, env_id):
        if env_id == 0:
            return self.window
        w = self._windows.get(env_id)
        if w is None:
            w = self._windows[env_id] = deque(maxlen=max(self.n_step, 1))
        return w

    def _fold(self, window):
        r, next_n, done_n = (window[-1][2], window[-1][3], window[-1][4])
        for _, _, rwd, nxt, dn in reversed(list(window)[:-1]):
            r = self.gamma * r * (1 - dn) + rwd
            if dn:
                next_n, done_n = nxt, dn
        return r, next_n, done_n

    def flush(self) -> None:
        """One scatter uploads all pending transitions."""
        if not self._pending:
            return
        k = len(self._pending)
        dev = self.device
        idx = torch.as_tensor((self.position + np.arange(k)) % self.capacity,
                              device=dev)

        def col(j, dtype):
            return torch.as_tensor(
                np.asarray([p[j] for p in self._pending], dtype=dtype),
                device=dev)

        self.states[idx] = col(0, np.float32)
        self.actions[idx] = col(1, np.int64)
        self.rewards[idx] = col(2, np.float32)
        self.next_states[idx] = col(3, np.float32)
        self.dones[idx] = col(4, np.float32)
        self.demos[idx] = col(5, np.float32)
        self._pending.clear()
        self.position = int((self.position + k) % self.capacity)
        self.size = min(self.size + k, self.capacity)

    def sample_indices(self, batch_size: int):
        """-> (B,) numpy batch indices (uniform)."""
        self.flush()
        return self.rng.choice(self.size, size=batch_size,
                               replace=batch_size > self.size)

    def buffers(self):
        return (self.states, self.actions, self.rewards, self.next_states,
                self.dones, self.demos)

    def __len__(self) -> int:
        return self.size + len(self._pending)

    def clean_memory(self) -> None:
        self._windows = {}
        self._pending.clear()
        self.window = deque(maxlen=max(self.n_step, 1))
        self._alloc()

    # -- checkpointing -------------------------------------------------------

    def state_dict(self):
        self.flush()
        n = self.size
        return {"states": self.states[:n].cpu().numpy(),
                "actions": self.actions[:n].cpu().numpy().astype(np.int32),
                "rewards": self.rewards[:n].cpu().numpy(),
                "next_states": self.next_states[:n].cpu().numpy(),
                "dones": self.dones[:n].cpu().numpy(),
                "demos": self.demos[:n].cpu().numpy(),
                "position": self.position, "size": n,
                "rng_state": rng_state_json(self.rng),
                "fold_windows": _fold_windows_pickle(self.window,
                                                     self._windows)}

    def load_state_dict(self, d):
        n = int(d["size"])
        self.clean_memory()
        dev = self.device
        self.states[:n] = torch.as_tensor(np.asarray(d["states"]), device=dev)
        self.next_states[:n] = torch.as_tensor(np.asarray(d["next_states"]),
                                               device=dev)
        self.actions[:n] = torch.as_tensor(
            np.asarray(d["actions"], dtype=np.int64), device=dev)
        self.rewards[:n] = torch.as_tensor(np.asarray(d["rewards"]),
                                           device=dev)
        self.dones[:n] = torch.as_tensor(np.asarray(d["dones"]), device=dev)
        self.demos[:n] = torch.as_tensor(np.asarray(d["demos"]), device=dev)
        self.position = int(d["position"]) % self.capacity
        self.size = n
        restore_rng(self.rng, d["rng_state"])
        self.window, self._windows = _unfold_windows_pickle(
            d["fold_windows"], max(self.n_step, 1))


class PrioritizedReplayMemory(DeviceReplay):
    """alpha-prioritized sampling with beta-annealed importance weights
    (reference ``agents/DeepQ.py:186-262``; the JAX package's
    ``PrioritizedReplayMemory``, ``agents/replay.py:119-170``) on the
    device ring of ``DeviceReplay``, without n-step folding.  The
    priorities stay on the host (one scalar a slot); a transition enters
    with the largest priority so far (1 in an empty buffer) when it is
    flushed to the ring, and the learner writes |TD error| + epsilon back
    (``update_priorities``)."""

    def __init__(self, capacity: int, state_size: int, seed: int = 0,
                 alpha: float = 0.6, beta_start: float = 0.4,
                 beta_frames: int = 100000, device="cpu"):
        super().__init__(capacity, state_size, seed=seed, device=device)
        self.alpha = alpha
        self.beta_start = beta_start
        self.beta_frames = beta_frames

    def _alloc(self):
        super()._alloc()
        self.priorities = np.zeros(self.capacity, dtype=np.float32)

    def flush(self) -> None:
        k = len(self._pending)
        if k:
            idx = (self.position + np.arange(k)) % self.capacity
            self.priorities[idx] = (self.priorities[: self.size].max()
                                    if self.size else 1.0)
        super().flush()

    def sample_weighted(self, batch_size: int, frame_idx: int = 0):
        """-> (idx (B,), importance weights (B,) float32, at most 1):
        P(i) ~ priority_i^alpha, weights (N P(i))^-beta with beta annealed
        from ``beta_start`` to 1 over ``beta_frames`` replay steps."""
        self.flush()
        probs = self.priorities[: self.size] ** self.alpha
        probs = probs / probs.sum()
        idx = self.rng.choice(self.size, size=batch_size, p=probs)
        beta = min(1.0, self.beta_start
                   + frame_idx * (1.0 - self.beta_start) / self.beta_frames)
        weights = (self.size * probs[idx]) ** (-beta)
        return idx, (weights / weights.max()).astype(np.float32)

    def sample(self, batch_size: int, frame_idx: int = 0):
        """-> (idx, (states, actions, rewards, next_states, dones) on the
        device, weights)."""
        idx, weights = self.sample_weighted(batch_size, frame_idx)
        at = torch.as_tensor(idx, device=self.device)
        batch = tuple(buf[at] for buf in self.buffers()[:5])
        return idx, batch, weights

    def update_priorities(self, idx, td_errors, epsilon: float = 1e-5):
        self.flush()
        self.priorities[idx] = (np.abs(np.asarray(td_errors)).reshape(-1)
                                + epsilon)

    def state_dict(self):
        d = super().state_dict()
        d["priorities"] = self.priorities[: self.size].copy()
        return d

    def load_state_dict(self, d):
        super().load_state_dict(d)
        if "priorities" in d:
            self.priorities[: self.size] = np.asarray(d["priorities"])
        else:                 # a checkpoint of uniform replay: neutral start
            self.priorities[: self.size] = 1.0
