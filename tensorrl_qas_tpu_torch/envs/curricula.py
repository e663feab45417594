"""Success-threshold curricula for the episode ``done`` criterion.

Behavioral re-implementations of the three schedulers in
``environments/utils/curricula.py:2-98``, selected by name from the config
key ``curriculum_type`` (all shipped reference configs use
``VanillaCurriculum`` with a single threshold).  Class names (including the
reference's ``Succes`` spelling) are kept so the .cfg corpus loads
unchanged.
"""

from __future__ import annotations


class VanillaCurriculum:
    """Fixed threshold schedule switched at preset episode counts
    (``curricula.py:80-98``)."""

    def __init__(self, config, target_energy: float):
        self.thresholds = list(config["thresholds"])
        self.switch_episodes = list(config["switch_episodes"])
        self.episodes_completed = 0
        self.min_en = target_energy
        self.current_threshold = float(config["accept_err"])
        self.lowest_energy = self.min_en + self.current_threshold

    def get_current_threshold(self) -> float:
        for i, ep in enumerate(self.switch_episodes):
            if ep > self.episodes_completed:
                return self.thresholds[i]
        # past the last switch point the reference would crash (min() of an
        # empty list); we hold the final threshold instead.
        return self.thresholds[-1]

    def update_threshold(self, energy_done: int = 0) -> None:
        self.episodes_completed += 1

    # -- checkpointing ------------------------------------------------------

    def state_dict(self):
        return {"episodes_completed": self.episodes_completed,
                "lowest_energy": self.lowest_energy,
                "current_threshold": self.current_threshold}

    def load_state_dict(self, d):
        self.episodes_completed = d["episodes_completed"]
        self.lowest_energy = d["lowest_energy"]
        self.current_threshold = d["current_threshold"]


class MovingThreshold:
    """Amortisation-radius shrink on success + periodic greedy shift toward
    the best-seen energy (``curricula.py:2-51``)."""

    def __init__(self, config, target_energy: float):
        self.amortisation = config["shift_threshold_ball"]
        self.greedy_shift_time = config["shift_threshold_time"]
        self.min_en = target_energy
        self.success_thresh = config["success_thresh"]
        self.succ_radius_shift = config["succ_radius_shift"]
        self.succes_switch = config["succes_switch"]
        self.current_threshold = float(config["accept_err"])
        self.lowest_energy = self.min_en + self.current_threshold
        self.success_counter = 0
        self.radius_shift_counter = 0
        self.call_counter = 0

    def get_current_threshold(self) -> float:
        return self.current_threshold

    def update_threshold(self, energy_done: int = 0) -> None:
        if energy_done:
            self._shrink_radius()
        self._greedy_shift()

    def _shrink_radius(self) -> None:
        if not self.success_thresh:
            return
        self.success_counter += 1
        gap = abs(self.min_en - self.lowest_energy)
        if (self.success_counter >= self.success_thresh
                and self.radius_shift_counter < self.succ_radius_shift
                and self.succes_switch > gap):
            self.current_threshold -= self.amortisation / self.succ_radius_shift
            self.success_counter = 0
            self.radius_shift_counter += 1

    def _greedy_shift(self) -> None:
        self.call_counter += 1
        if self.call_counter <= 10 or self.call_counter % self.greedy_shift_time != 0:
            return
        gap = abs(self.min_en - self.lowest_energy)
        if self.amortisation:
            self.current_threshold = gap + self.amortisation
            if self.success_thresh:
                self.radius_shift_counter = 0
                self.success_counter = 0
        else:
            self.current_threshold = gap

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, d):
        self.__dict__.update(d)


class SuccesCountThreshold:
    """Snap threshold to best-seen gap every N successes
    (``curricula.py:53-77``)."""

    def __init__(self, config, target_energy: float):
        self.min_en = target_energy
        self.success_thresh = config["success_thresh"]
        self.current_threshold = float(config["accept_err"])
        self.lowest_energy = self.min_en + self.current_threshold
        self.success_counter = 0

    def get_current_threshold(self) -> float:
        return self.current_threshold

    def update_threshold(self, energy_done: int = 0) -> None:
        if not energy_done or not self.success_thresh:
            return
        self.success_counter += 1
        if self.success_counter >= self.success_thresh:
            self.success_counter = 0
            self.current_threshold = abs(self.min_en - self.lowest_energy)

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, d):
        self.__dict__.update(d)


_REGISTRY = {
    "VanillaCurriculum": VanillaCurriculum,
    "MovingThreshold": MovingThreshold,
    "SuccesCountThreshold": SuccesCountThreshold,
}


def make_curriculum(name: str, config, target_energy: float):
    """Name-based factory (reference: ``curricula.__dict__[...]`` lookup at
    ``environment_qulacs.py:114``)."""
    return _REGISTRY[name](config, target_energy=target_energy)
