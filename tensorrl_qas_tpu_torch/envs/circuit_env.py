"""The RL circuit-construction environment (fixed warm-start placement).

Port of ``tensorrl_qas_tpu/envs/circuit_env.py`` for the TensorRL-fixed
mode: the tensor-network warm-start circuit is compiled once into the
initial statevector (reference ``environment_qulacs_TN_notin_agent.py:158``)
and the agent appends one gate per step, noiselessly or with depolarizing
noise on the agent's gates (the warm start stays noiseless in psi0, as in
the JAX package's fixed mode).  The other modes of the JAX env (in-state
placement, shot noise, su4, sharding, block-coordinate) are not ported
yet and are refused by ``CircuitEnv``.

Step semantics follow the reference, including its ordering
(``environment_qulacs.py:169-267``): the per-step angle optimizer runs on
the circuit *before* the new gate is appended, so a freshly placed
rotation enters this step's energy at angle 0 and is optimized from the
next step on.  The host phase (placement, masks, tapes) and the device
phase (fused optimize + energy) are split so that ``VectorCircuitEnv`` can
batch the device phase of many replicas into one launch.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from tensorrl_qas_tpu_torch import as_device, complex_dtype
from tensorrl_qas_tpu_torch.circuits.actions import action_dictionary
from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
from tensorrl_qas_tpu_torch.circuits.tensor_ir import StateTensor
from tensorrl_qas_tpu_torch.envs.curricula import make_curriculum
from tensorrl_qas_tpu_torch.envs.illegal import IllegalActionTracker
from tensorrl_qas_tpu_torch.optim.angle_opt import (
    AngleOptimizer,
    check_noise,
)
from tensorrl_qas_tpu_torch.problems.hamiltonians import (
    load_problem,
    resolve_warmstart_qasm,
)
from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state


@dataclasses.dataclass
class EnvConfig:
    """Environment configuration (the reference [env]/[problem]/
    [non_local_opt] sections; same fields and defaults as the JAX
    package's ``EnvConfig`` for the modes ported here)."""

    num_qubits: int
    num_layers: int
    ham_type: str
    geometry: str = ""
    mapping: str = "jordan_wigner"
    tn_placement: str = "fixed"
    tn_init: int = 1
    tn_bond: int = 2
    rand_halt: int = 0
    accept_err: float = 1.6e-3
    fn_type: str = "incremental_with_fixed_ends"
    fake_min_energy: float | None = None
    curriculum_type: str = "VanillaCurriculum"
    curriculum_conf: dict = dataclasses.field(default_factory=dict)
    state_with_angles: int = 0
    noise_mode: str = "none"              # 'none' | 'depolarizing' | 'shot'
    noise_values: tuple = ()              # (p1, p2); () = 0.01, 0.05
    n_shots: int = 0
    n_traj: int = 1                       # trajectories per noisy energy
    noise_resample: str = "iter"          # 'iter' | 'step' (AngleOptimizer)
    topology: str = "all_to_all"
    gate_set: str = "cnot"
    optim_method: str | None = "scipy_each_step"
    optim_alg: str = "adam"
    global_iters: int = 100
    n_starts: int = 8
    adam_lr: float = 0.1
    restart_scale: float = 0.1
    device: str = "cuda"
    seed: int = 0

    @classmethod
    def from_conf(cls, conf: dict, tn_placement: str | None = None,
                  noise_mode: str | None = None, seed: int = 0,
                  optim_alg: str | None = None,
                  device: str = "cuda") -> "EnvConfig":
        """Build from a reference-format config dict (see train/config.py)."""
        env = conf["env"]
        prob = conf["problem"]
        agent = conf.get("agent", {})
        nlo = conf.get("non_local_opt", {})
        noise_vals = env.get("noise_values", 0)
        if isinstance(noise_vals, str) and noise_vals != "0":
            vals = tuple(float(x)
                         for x in noise_vals.strip("[]() ").split(","))
        else:
            vals = ()
        if noise_mode is None:
            noise_mode = "depolarizing" if vals else "none"
        alg = optim_alg
        if alg is None:
            # the reference's COBYLA configs map onto multi-start Adam
            ref_alg = str(nlo.get("optim_alg", "adam")).lower()
            alg = "adam" if ref_alg in ("cobyla", "adam") else ref_alg
        return cls(
            num_qubits=env["num_qubits"],
            num_layers=env["num_layers"],
            ham_type=prob["ham_type"],
            geometry=prob.get("geometry", ""),
            mapping=prob.get("mapping", "jordan_wigner"),
            tn_placement=tn_placement or env.get("tn_placement", "fixed"),
            tn_init=int(env.get("tn_init", 1)),
            tn_bond=int(env.get("tn_bond", 0)),
            rand_halt=int(env.get("rand_halt", 0)),
            accept_err=float(env.get("accept_err", 1.6e-3)),
            fn_type=env.get("fn_type", "incremental_with_fixed_ends"),
            fake_min_energy=env.get("fake_min_energy"),
            curriculum_type=env.get("curriculum_type", "VanillaCurriculum"),
            curriculum_conf=dict(env),
            state_with_angles=int(agent.get("angles", 0)),
            noise_mode=noise_mode,
            noise_values=vals,
            n_shots=int(env.get("n_shots", 0)),
            noise_resample=env.get("noise_resample", "iter"),
            topology=env.get("topology", "all_to_all"),
            gate_set=env.get("gate_set", "cnot"),
            optim_method=nlo.get("method", None),
            optim_alg=alg,
            global_iters=int(nlo.get("global_iters", 100)),
            n_starts=int(env.get("n_starts", 8)),
            adam_lr=float(env.get("adam_lr", 0.1)),
            restart_scale=float(env.get("restart_scale", 0.1)),
            device=device,
            seed=seed,
        )


# warm-start statevectors keyed by (qasm path, device): the replicas of a
# VectorCircuitEnv share one warm-start file, compiled once per process
_TN_PSI_CACHE: dict = {}


def _check_supported(cfg: EnvConfig) -> None:
    unsupported = {
        "tn_placement": (cfg.tn_placement, "fixed"),
        "gate_set": (cfg.gate_set, "cnot"),
        "optim_alg": (cfg.optim_alg, "adam"),
    }
    for field, (value, ported) in unsupported.items():
        if value != ported:
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet (only {ported!r})")
    check_noise(cfg.noise_mode, cfg.n_traj)


def make_optimizer(cfg: EnvConfig, pauli, device, seed: int):
    """The env's angle optimizer: Adam settings and noise from ``cfg``;
    p1/p2 are the reference's 0.01 / 0.05 (``VQE_qulacs_noise.py:32,45``)
    unless ``noise_values`` gives two values."""
    p1, p2 = (cfg.noise_values[:2] if len(cfg.noise_values) >= 2
              else (0.01, 0.05))
    return AngleOptimizer(
        pauli, iters=cfg.global_iters, n_starts=cfg.n_starts,
        lr=cfg.adam_lr, restart_scale=cfg.restart_scale, device=device,
        seed=seed, noise_mode=cfg.noise_mode, noise_p1=p1, noise_p2=p2,
        n_shots=cfg.n_shots, n_traj=cfg.n_traj,
        noise_resample=cfg.noise_resample)


class CircuitEnv:
    """Gym-style episodic environment: one gate per step, energy reward."""

    def __init__(self, cfg: EnvConfig,
                 optimizer: AngleOptimizer | None = None):
        _check_supported(cfg)
        self.cfg = cfg
        n = cfg.num_qubits
        self.num_qubits = n
        self.num_layers = cfg.num_layers
        self.device = as_device(cfg.device)
        self.dtype = complex_dtype(self.device)

        # the stored dense matrix (up to 4096^2 complex at 12 qubits) is
        # read by nothing here: the optimizer builds its own H operands
        self.problem = load_problem(cfg.ham_type, n, cfg.geometry,
                                    cfg.mapping, keep_dense=False)
        self.min_eig = (cfg.fake_min_energy if cfg.fake_min_energy is not None
                        else self.problem.min_eig)
        self.max_eig = self.problem.max_eig

        # --- warm-start circuit, compiled once into psi0 -------------------
        self.tn_tape = None
        self.tn_depth = 0
        if cfg.tn_init and cfg.tn_bond:
            qasm_path = resolve_warmstart_qasm(
                cfg.ham_type, n, cfg.tn_bond, cfg.geometry, cfg.mapping,
                gate_set=cfg.gate_set, tn_placement=cfg.tn_placement)
            self.tn_tape = load_circuit_tape(qasm_path)
            self.tn_depth = self.tn_tape.depth()
            memo_key = (str(qasm_path), str(self.device))
            psi = _TN_PSI_CACHE.get(memo_key)
            if psi is None:
                psi = apply_tape(zero_state(n, self.dtype, self.device),
                                 *self.tn_tape.arrays(), self.tn_tape.x0())
                _TN_PSI_CACHE[memo_key] = psi
            self.psi0 = psi
        else:
            self.psi0 = zero_state(n, self.dtype, self.device)
        self.num_layers_termination = cfg.num_layers - self.tn_depth

        # --- action space ---------------------------------------------------
        self.action_dict = action_dictionary(n, cfg.topology,
                                             gate_set=cfg.gate_set)
        if cfg.topology == "all_to_all":
            self.action_size = n * (n + 2)
        else:
            self.action_size = len(action_dictionary(n, cfg.topology,
                                                     reverted=True))
        self.state_size = cfg.num_layers * n * (n + 6)

        # --- tape capacities (static shapes across the whole run) -----------
        max_steps = self.num_layers_termination + 1
        self.tape_capacity = max_steps
        self.rot_capacity = max_steps

        self.optimizer = optimizer or make_optimizer(
            cfg, self.problem.pauli, self.device, cfg.seed)

        self.curriculum_dict = {
            cfg.ham_type: make_curriculum(cfg.curriculum_type,
                                          cfg.curriculum_conf,
                                          target_energy=self.min_eig)
        }
        self.done_threshold = cfg.accept_err
        self.tracker = IllegalActionTracker(n, self.action_dict)
        self._np_rng = np.random.default_rng(cfg.seed)

        # per-step observables read by the driver
        self.energy = 0.0
        self.error = 0.0
        self.error_noiseless = 0.0
        self.prev_energy = None
        self.nfev = 0
        self.opt_ang_save = 0
        self.rwd = 0.0
        self.save_circ = 0
        self.current_number_of_cnots = 0
        self.step_counter = -1
        self.current_bond_distance = 0

    # -- helpers --------------------------------------------------------------

    def _tape(self, state: StateTensor):
        return state.to_tape(self.tape_capacity, self.rot_capacity)

    def _energy_of_state(self, state: StateTensor) -> float:
        tape = self._tape(state)
        return self.optimizer.energy(self.psi0, tape.arrays(), tape.x0())

    def _observation(self, state: StateTensor) -> np.ndarray:
        return state.observation(bool(self.cfg.state_with_angles))

    def _angle_map(self, old_state: StateTensor,
                   new_state: StateTensor) -> np.ndarray:
        """Mapping from old-tape angle slots to new-tape slots (the new
        gate, if a rotation, maps from -1 -> angle 0); fixed length
        ``rot_capacity``."""
        old_pos = {pos: i for i, pos in
                   enumerate(zip(*old_state.rot_positions()))}
        new_pos = list(zip(*new_state.rot_positions()))
        out = np.full(self.rot_capacity, -1, dtype=np.int32)
        for i, pos in enumerate(new_pos):
            out[i] = old_pos.get(pos, -1)
        return out

    # -- API ---------------------------------------------------------------

    def reset(self) -> np.ndarray:
        cfg = self.cfg
        self.state = StateTensor(cfg.num_layers, cfg.num_qubits)
        if cfg.rand_halt:
            # episode lengths matched to the reference's
            # clip(NegBinom(70, 0.573), 25, 70) draw
            # (environment_qulacs.py:330-332)
            self.halting_step = int(np.clip(
                self._np_rng.negative_binomial(70, 0.573), 25, 70))
        self.current_number_of_cnots = 0
        self.current_action = [self.num_qubits] * 4
        self.tracker.reset()
        self.step_counter = -1
        self.moments = [0] * self.num_qubits
        self.current_prob = cfg.ham_type
        self.curriculum = copy.deepcopy(
            self.curriculum_dict[self.current_prob])
        self.done_threshold = copy.deepcopy(
            self.curriculum.get_current_threshold())
        self.prev_energy = self._energy_of_state(self.state)
        return self._observation(self.state)

    def illegal_action_new(self) -> list[int]:
        """Mask query; re-observes ``current_action`` as the reference's
        driver does at the top of each iteration."""
        return self.tracker.observe(self.current_action)

    def step_begin(self, action):
        """Host phase: place the gate and return the device-call payload
        (old/new tape arrays, warm start, number of live angles, remap)."""
        n = self.num_qubits
        old_state = self.state
        next_state = self.state.copy()
        self.step_counter += 1

        ctrl, offset, rot_qubit, rot_axis = action
        targ = (ctrl + offset) % n
        if rot_qubit < n:
            gate_layer = self.moments[rot_qubit]
        elif ctrl < n:
            gate_layer = max(self.moments[ctrl], self.moments[targ])

        if ctrl < n:
            next_state.place_cnot(gate_layer, ctrl, targ)
            m = max(self.moments[ctrl], self.moments[targ]) + 1
            self.moments[ctrl] = m
            self.moments[targ] = m
            self.current_number_of_cnots += 1
        elif rot_qubit < n:
            next_state.place_rotation(gate_layer, rot_axis - 1, rot_qubit, 0.0)
            self.moments[rot_qubit] += 1

        self.current_action = list(action)
        self.tracker.observe(self.current_action)

        old_tape = self._tape(old_state)
        new_tape = self._tape(next_state)
        map_idx = self._angle_map(old_state, next_state)
        self._pending = (old_state, next_state, old_tape)
        return (old_tape.arrays(), old_tape.x0(), old_tape.n_rots,
                new_tape.arrays(), map_idx)

    def step_finish(self, x_opt, energy, nfev, train_flag: bool = True):
        """Apply the device results; compute reward, done and curriculum."""
        old_state, next_state, old_tape = self._pending
        self._pending = None
        opt_angles = np.asarray(x_opt)[: old_tape.n_rots].copy()
        old_state.set_rot_angles(opt_angles)
        next_state.thetas = old_state.thetas
        self.opt_ang_save = opt_angles
        self.state = next_state

        self.energy = energy
        if train_flag and energy < self.curriculum.lowest_energy:
            self.curriculum.lowest_energy = float(energy)
        self.error = float(abs(self.min_eig - energy))
        self.error_noiseless = self.error   # noisy modes report it twice
        rwd = self.reward_fn(energy)
        self.prev_energy = float(energy)
        self.rwd = rwd
        self.nfev = nfev
        self.save_circ = 0

        energy_done = int(self.error < self.done_threshold)
        layers_done = self.step_counter == (self.num_layers_termination - 1)
        done = int(energy_done or layers_done)
        if self.cfg.rand_halt and self.step_counter == self.halting_step:
            done = 1
        if done:
            self.curriculum.update_threshold(energy_done=energy_done)
            self.done_threshold = self.curriculum.get_current_threshold()
            self.curriculum_dict[self.current_prob] = copy.deepcopy(
                self.curriculum)
        return self._observation(self.state), float(rwd), done

    def reward_fn(self, energy: float) -> float:
        """Reference ``incremental_with_fixed_ends``
        (``environment_qulacs.py:447-459``): +5 at success, -5 at max depth,
        else the clipped relative improvement."""
        if self.cfg.fn_type != "incremental_with_fixed_ends":
            raise NotImplementedError(
                f"reward fn_type {self.cfg.fn_type!r} not implemented")
        max_depth = self.step_counter == (self.num_layers_termination - 1)
        if self.error < self.done_threshold:
            return 5.0
        if max_depth:
            return -5.0
        denom = abs(self.prev_energy - self.min_eig)
        if denom == 0.0:
            return 0.0
        return float(np.clip((self.prev_energy - energy) / denom, -1.0, 1.0))

    # -- checkpointing ----------------------------------------------------

    def curriculum_state(self):
        return {k: c.state_dict() for k, c in self.curriculum_dict.items()}

    def load_curriculum_state(self, d):
        for k, s in d.items():
            self.curriculum_dict[k].load_state_dict(s)
