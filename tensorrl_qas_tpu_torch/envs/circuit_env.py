"""The RL circuit-construction environment.

Port of ``tensorrl_qas_tpu/envs/circuit_env.py``, with the per-step angle
optimizer the config names (multi-start Adam, or the reference's COBYLA
with ``optim_alg='cobyla'``), in both warm-start placements:

- ``tn_placement='fixed'`` (TensorRL-fixed): the tensor-network warm-start
  circuit is compiled once into the initial statevector (reference
  ``environment_qulacs_TN_notin_agent.py:158``); with depolarizing noise
  only the agent's gates are noisy, as in the JAX package's fixed mode.
- ``tn_placement='in_state'`` (TensorRL-trainable and StructureRL): the
  warm-start gates are embedded in the leading layers of the RL state
  (``circuits/tensor_ir.py:embed_tape``, reference
  ``environment_qulacs.py:285-328``) and ride every tape from |0...0>, so
  their angles are re-optimized with the agent's; ``zero_param_init``
  (StructureRL) keeps the structure and zeroes the angles.
  ``block_coord_k = K > 1`` re-optimizes the embedded block only on every
  K-th step: on the others its gates are masked to padding and the device
  call starts from the cached prefix state instead (``step_psi0``), which
  hands each replica of a ``VectorCircuitEnv`` its own psi0.

Noise: depolarizing (``noise_mode='depolarizing'``, ``n_traj``
trajectories per energy) and shot noise (``'shot'``, ``n_shots``).  With
``gate_set='su4'`` the agent places RXX/RYY/RZZ rotations instead of
CNOTs (``SU4StateTensor``, reference ``environments/VQAs/
VQE_qulacs_su4.py``); every su4 gate is parametric, and su4 runs
noiseless only, as in the JAX package.  The fixed placement's psi0 is the
su4-basis warm start with its two-qubit rotations applied (the JAX env
drops them there: ROADMAP.md, C).

``sim_dtype`` ('auto' | 'complex64' | 'complex128', the CLI's
``--sim_dtype``) sets the statevector precision of the warm start, the
states and the optimizer, as in the JAX package; 'auto' is complex128 on
the CPU and complex64 on CUDA (``tensorrl_qas_tpu_torch.sim_dtypes``).

``mesh_shape = (n_amp, n_dp)`` runs the per-step optimizer on the sharded
path (``optim/sharded_opt.py``): the statevector split over the amp axis
of a mesh of devices, the starts over dp, past the fused kernels' 20
qubits; ``mesh_devices`` names the mesh's devices (default: the host's
CUDA devices, ``parallel/mesh.py:make_mesh``).  As in the JAX package it
takes noiseless and one-trajectory depolarizing runs, Adam only.

The reference's configs all name COBYLA; ``EnvConfig.from_conf`` maps
them onto multi-start Adam, as the JAX package does, unless the caller
passes ``optim_alg='cobyla'``.  ``CircuitEnv.step`` then runs
``AngleOptimizer.optimize`` (COBYLA on the pre-action tape) and the
post-action energy at the remapped angles; ``VectorCircuitEnv`` takes
Adam only, as in the JAX package.

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

from tensorrl_qas_tpu_torch import as_device, sim_dtypes
from tensorrl_qas_tpu_torch.circuits.actions import action_dictionary
from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
from tensorrl_qas_tpu_torch.circuits.tape import GateKind
from tensorrl_qas_tpu_torch.circuits.tensor_ir import (
    SU4StateTensor,
    StateTensor,
    embed_tape,
)
from tensorrl_qas_tpu_torch.envs.curricula import make_curriculum
from tensorrl_qas_tpu_torch.envs.illegal import IllegalActionTracker
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tensorrl_qas_tpu_torch.optim.sharded_opt import ShardedAngleOptimizer
from tensorrl_qas_tpu_torch.parallel.mesh import make_mesh
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
    tn_placement: str = "fixed"           # 'fixed' | 'in_state'
    tn_init: int = 1
    tn_bond: int = 2
    zero_param_init: int = 0              # StructureRL: embed at angle 0
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
    sim_dtype: str = "auto"      # 'auto' | 'complex64' | 'complex128'
    # block-coordinate trainable mode (in_state only, noiseless): the
    # embedded block's angles are re-optimized on every K-th step only;
    # 0/1 = off (joint optimization every step, the reference's)
    block_coord_k: int = 0
    optim_method: str | None = "scipy_each_step"
    optim_alg: str = "adam"               # 'adam' | 'cobyla' (reference)
    global_iters: int = 100
    n_starts: int = 8
    adam_lr: float = 0.1
    restart_scale: float = 0.1
    device: str = "cuda"
    # multi-device: an (n_amp, n_dp) mesh for the amplitude-sharded path
    # (ShardedAngleOptimizer), and its devices (None: the host's CUDA
    # devices; a list may repeat one, e.g. ("cpu",) * 8)
    mesh_shape: tuple | None = None
    mesh_devices: tuple | None = None
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
            zero_param_init=int(env.get("zero_param_init", 0)),
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
            block_coord_k=int(env.get("block_coord_k", 0)),
            optim_method=nlo.get("method", None),
            optim_alg=alg,
            global_iters=int(nlo.get("global_iters", 100)),
            n_starts=int(env.get("n_starts", 8)),
            adam_lr=float(env.get("adam_lr", 0.1)),
            restart_scale=float(env.get("restart_scale", 0.1)),
            device=device,
            seed=seed,
        )


# warm-start statevectors keyed by (qasm path, device, dtype): the replicas
# of a VectorCircuitEnv share one warm-start file, compiled once per
# process at each precision
_TN_PSI_CACHE: dict = {}


def _check_supported(cfg: EnvConfig) -> None:
    if cfg.tn_placement not in ("fixed", "in_state"):
        raise ValueError(f"tn_placement must be 'fixed' or 'in_state', got "
                         f"{cfg.tn_placement!r}")
    if cfg.gate_set not in ("cnot", "su4"):
        raise ValueError(f"gate_set must be 'cnot' or 'su4', got "
                         f"{cfg.gate_set!r}")
    if cfg.optim_alg not in ("adam", "cobyla"):
        raise ValueError(f"optim_alg must be 'adam' or 'cobyla', got "
                         f"{cfg.optim_alg!r}")
    if cfg.gate_set == "su4" and cfg.noise_mode != "none":
        raise NotImplementedError(
            "su4 gate set is noiseless-only (as in the reference, whose su4 "
            "noise variants were never wired)")
    if cfg.block_coord_k > 1 and cfg.noise_mode != "none":
        raise ValueError(
            "block_coord_k requires noise_mode='none': depolarizing/"
            "shot noise must fire on the embedded prefix gates, which "
            "the frozen-prefix transform masks out")
    if cfg.mesh_shape:
        if cfg.noise_mode not in ("none", "depolarizing"):
            raise NotImplementedError(
                "sharded path supports noise none/depolarizing "
                "(shot noise is single-chip only)")
        if cfg.noise_mode == "depolarizing" and cfg.n_traj != 1:
            raise NotImplementedError(
                "sharded depolarizing runs single-trajectory "
                "(n_traj=1), like the mega-kernel path")
        if cfg.optim_alg != "adam":
            raise ValueError("mesh_shape runs multi-start Adam only "
                             f"(optim_alg='adam'), got {cfg.optim_alg!r}")


def make_optimizer(cfg: EnvConfig, pauli, device, seed: int):
    """The env's angle optimizer: its method (``optim_alg``), Adam settings,
    noise and statevector dtype (``sim_dtype`` on ``device``) from
    ``cfg``; p1/p2 are the reference's 0.01 / 0.05
    (``VQE_qulacs_noise.py:32,45``) unless ``noise_values`` gives two
    values.  With ``mesh_shape`` the sharded optimizer on a mesh of
    ``mesh_devices`` (``sim_dtype`` 'auto': the mesh's lead device's
    default)."""
    p1, p2 = (cfg.noise_values[:2] if len(cfg.noise_values) >= 2
              else (0.01, 0.05))
    if cfg.mesh_shape:
        n_amp, n_dp = cfg.mesh_shape
        mesh = make_mesh(n_amp=n_amp, n_dp=n_dp, devices=cfg.mesh_devices)
        return ShardedAngleOptimizer(
            mesh, pauli.n_qubits, pauli, iters=cfg.global_iters,
            n_starts=cfg.n_starts, lr=cfg.adam_lr,
            restart_scale=cfg.restart_scale, seed=seed,
            noise_mode=cfg.noise_mode, noise_p1=p1, noise_p2=p2,
            noise_resample=cfg.noise_resample,
            enable_2q=cfg.gate_set == "su4",
            dtype=sim_dtypes(cfg.sim_dtype, mesh.lead)[0])
    return AngleOptimizer(
        pauli, iters=cfg.global_iters, n_starts=cfg.n_starts,
        lr=cfg.adam_lr, restart_scale=cfg.restart_scale, device=device,
        seed=seed, noise_mode=cfg.noise_mode, noise_p1=p1, noise_p2=p2,
        n_shots=cfg.n_shots, n_traj=cfg.n_traj,
        noise_resample=cfg.noise_resample, enable_2q=cfg.gate_set == "su4",
        method=cfg.optim_alg, dtype=sim_dtypes(cfg.sim_dtype, device)[0])


def bc_prefix_states(envs) -> None:
    """Cache the frozen-prefix state of every env in ``envs`` (replicas of
    one config) that is on a frozen block-coordinate step without one: the
    embedded block at its current angles applied to |0...0>, by the eager
    simulator on the envs' device, outside any kernel (the JAX package
    computes it outside its kernels too).  One batched pass serves them
    all: the replicas embed the same block, which opens every tape with
    the same gates and angle slots, so only the angles differ.  A joint
    step may move those angles and drops the cache (``step_finish``)."""
    need = [e for e in envs if e._bc_frozen and e._bc_cache is None]
    if not need:
        return
    first = need[0]
    tape = first._tape(first.state)
    kind = tape.kind.copy()
    kind[first._bc_n_gates:] = int(GateKind.NONE)      # the prefix only
    x = np.stack([tape.x0()] + [e._tape(e.state).x0() for e in need[1:]])
    psi0 = zero_state(first.num_qubits, first.dtype, first.device)
    psi = apply_tape(psi0.expand(len(need), -1), kind, tape.tq, tape.cq,
                     tape.angle_slot, x)
    for env, row in zip(need, psi):
        env._bc_cache = row


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
        self.dtype = sim_dtypes(cfg.sim_dtype, self.device)[0]

        # the stored dense matrix (up to 4096^2 complex at 12 qubits) is
        # read by nothing here: the optimizer builds its own H operands
        self.problem = load_problem(cfg.ham_type, n, cfg.geometry,
                                    cfg.mapping, keep_dense=False)
        self.min_eig = (cfg.fake_min_energy if cfg.fake_min_energy is not None
                        else self.problem.min_eig)
        self.max_eig = self.problem.max_eig

        # --- warm-start circuit: compiled once into psi0 (fixed) or embedded
        # in the state at every reset (in_state, psi0 = |0...0>) ----------
        self.tn_tape = None
        self.tn_depth = 0
        self.psi0 = zero_state(n, self.dtype, self.device)
        in_state = cfg.tn_placement == "in_state"
        if cfg.tn_init and cfg.tn_bond:
            qasm_path = resolve_warmstart_qasm(
                cfg.ham_type, n, cfg.tn_bond, cfg.geometry, cfg.mapping,
                gate_set=cfg.gate_set, tn_placement=cfg.tn_placement)
            self.tn_tape = load_circuit_tape(qasm_path)
            self.tn_depth = self.tn_tape.depth()
        if self.tn_tape is not None and not in_state:
            memo_key = (str(qasm_path), str(self.device), self.dtype)
            psi = _TN_PSI_CACHE.get(memo_key)
            if psi is None:
                psi = apply_tape(zero_state(n, self.dtype, self.device),
                                 *self.tn_tape.arrays(), self.tn_tape.x0())
                _TN_PSI_CACHE[memo_key] = psi
            self.psi0 = psi
        self.num_layers_termination = cfg.num_layers - self.tn_depth

        # --- action space ---------------------------------------------------
        self.action_dict = action_dictionary(n, cfg.topology,
                                             gate_set=cfg.gate_set)
        if cfg.gate_set == "su4":
            self.action_size = 3 * n * n
            self.state_size = cfg.num_layers * n * (6 * n + 6)
        elif cfg.topology == "all_to_all":
            self.action_size = n * (n + 2)
            self.state_size = cfg.num_layers * n * (n + 6)
        else:
            self.action_size = len(action_dictionary(n, cfg.topology,
                                                     reverted=True))
            self.state_size = cfg.num_layers * n * (n + 6)

        # --- tape capacities (static shapes across the whole run): in
        # in_state placement the embedded warm start rides every tape; every
        # su4 gate is parametric -------------------------------------------
        max_steps = self.num_layers_termination + 1
        self.tape_capacity = self.rot_capacity = max_steps
        if in_state and self.tn_tape is not None:
            self.tape_capacity += self.tn_tape.n_gates
            self.rot_capacity += self.tn_tape.n_rots
        if cfg.gate_set == "su4":
            self.rot_capacity = self.tape_capacity

        self.optimizer = optimizer or make_optimizer(
            cfg, self.problem.pauli, self.device, cfg.seed)
        # the sharded path's mesh, None on one device
        self.mesh = getattr(self.optimizer, "mesh", None)

        self.curriculum_dict = {
            cfg.ham_type: make_curriculum(cfg.curriculum_type,
                                          cfg.curriculum_conf,
                                          target_energy=self.min_eig)
        }
        self.done_threshold = cfg.accept_err
        self.tracker = IllegalActionTracker(n, self.action_dict)
        self._np_rng = np.random.default_rng(cfg.seed)

        # in_state: layers the embedded block takes; block-coordinate state
        self.layer_offset = 0
        self._bc_frozen = False
        self._bc_n_gates = 0
        self._bc_n_rots = 0
        self._bc_cache = None

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

    # -- block-coordinate trainable mode (EnvConfig.block_coord_k) -----------

    def _bc_active(self) -> bool:
        return (self.cfg.block_coord_k > 1
                and self.cfg.tn_placement == "in_state"
                and self.tn_tape is not None and self.layer_offset > 0)

    def _bc_mask_prefix(self, arrs):
        """The embedded prefix's gates turned into padding (both kernels
        skip ``GateKind.NONE``)."""
        kind, tq, cq, slot = arrs
        kind = np.asarray(kind).copy()
        kind[: self._bc_n_gates] = int(GateKind.NONE)
        return (kind, tq, cq, slot)

    def step_psi0(self):
        """psi0 of THIS step's device call: the warm start (fixed mode,
        joint steps) or the cached frozen-prefix state (frozen
        block-coordinate steps)."""
        if not self._bc_frozen:
            return self.psi0
        if self._bc_cache is None:
            bc_prefix_states([self])
        return self._bc_cache

    # -- helpers --------------------------------------------------------------

    def _tape(self, state: StateTensor):
        return state.to_tape(self.tape_capacity, self.rot_capacity)

    def _energy_of_state(self, state: StateTensor,
                         energies: dict | None = None) -> float:
        """The state's energy; ``energies`` (noiseless only, where the
        energy is a function of psi0, tape and angles) keeps it by those
        inputs for replicas that share an optimizer."""
        tape = self._tape(state)
        arrays, x0 = tape.arrays(), tape.x0()
        if energies is None or self.optimizer.noise_mode != "none":
            return self.optimizer.energy(self.psi0, arrays, x0)
        key = (id(self.optimizer),
               self.psi0.detach().cpu().numpy().tobytes(),
               *(np.ascontiguousarray(a).tobytes() for a in arrays),
               x0.tobytes())
        if key not in energies:
            energies[key] = self.optimizer.energy(self.psi0, arrays, x0)
        return energies[key]

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

    def reset(self, energies: dict | None = None) -> np.ndarray:
        """A new episode; ``energies``: see ``_energy_of_state``."""
        cfg = self.cfg
        state_cls = SU4StateTensor if cfg.gate_set == "su4" else StateTensor
        self.state = state_cls(cfg.num_layers, cfg.num_qubits)
        self.layer_offset = 0
        if self.tn_tape is not None and cfg.tn_placement == "in_state":
            self.layer_offset = embed_tape(
                self.state, self.tn_tape,
                zero_params=bool(cfg.zero_param_init))
        self._bc_frozen = False
        self._bc_cache = None
        if self._bc_active():
            # the fresh state holds exactly the embedded block and to_tape
            # is layer-major, so the block is a strict tape prefix with
            # rotation slots [0, n_rots)
            ptape = self._tape(self.state)
            self._bc_n_gates = ptape.n_gates
            self._bc_n_rots = ptape.n_rots
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
        self.prev_energy = self._energy_of_state(self.state, energies)
        return self._observation(self.state)

    def illegal_action_new(self) -> list[int]:
        """Mask query; re-observes ``current_action`` as the reference's
        driver does at the top of each iteration."""
        return self.tracker.observe(self.current_action)

    def step_begin(self, action):
        """Host phase: place the gate and return the device-call payload
        (old/new tape arrays, warm start, number of live angles, remap); on
        a frozen block-coordinate step the tapes carry the embedded prefix
        as padding and ``step_psi0`` gives the state it leaves."""
        n = self.num_qubits
        off = self.layer_offset
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
            if self.cfg.gate_set == "su4":
                # two-qubit Pauli rotation: rot_axis 1/2/3 = XX/YY/ZZ
                next_state.place_two_rotation(off + gate_layer, rot_axis - 1,
                                              ctrl, targ, 0.0)
            else:
                next_state.place_cnot(off + gate_layer, ctrl, targ)
            m = max(self.moments[ctrl], self.moments[targ]) + 1
            self.moments[ctrl] = m
            self.moments[targ] = m
            self.current_number_of_cnots += 1
        elif rot_qubit < n:
            next_state.place_rotation(off + gate_layer, rot_axis - 1,
                                      rot_qubit, 0.0)
            self.moments[rot_qubit] += 1

        self.current_action = list(action)
        self.tracker.observe(self.current_action)

        old_tape = self._tape(old_state)
        new_tape = self._tape(next_state)
        map_idx = self._angle_map(old_state, next_state)
        self._pending = (old_state, next_state, old_tape)
        old_arrs, new_arrs = old_tape.arrays(), new_tape.arrays()
        self._bc_frozen = (self._bc_active() and self.step_counter
                           % self.cfg.block_coord_k != 0)
        if self._bc_frozen:
            old_arrs = self._bc_mask_prefix(old_arrs)
            new_arrs = self._bc_mask_prefix(new_arrs)
        return (old_arrs, old_tape.x0(), old_tape.n_rots, new_arrs, map_idx)

    def step_finish(self, x_opt, energy, nfev, train_flag: bool = True):
        """Apply the optimizer's results (x_opt None: no per-step
        optimization, the angles stay); compute reward, done and
        curriculum."""
        old_state, next_state, old_tape = self._pending
        self._pending = None
        if x_opt is not None:
            opt_angles = np.asarray(x_opt)[: old_tape.n_rots].copy()
            if self._bc_frozen:
                # the masked prefix's angles saw no gradient, but the start
                # perturbation moved them in the returned vector: keep the
                # embedded block's angles as they were
                opt_angles[: self._bc_n_rots] = \
                    old_tape.x0()[: self._bc_n_rots]
            elif self._bc_active():
                # a joint step moved the prefix angles: drop the cached
                # state
                self._bc_cache = None
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

    def step(self, action, train_flag: bool = True):
        """One step of this env alone (reference ``envs/circuit_env.py:
        636-670``): with Adam the fused step (a batch of one); with COBYLA
        ``optimize`` on the pre-action tape, then the energy of the
        post-action tape at the remapped angles; with no per-step
        optimization configured (``optim_method``), that energy at the
        remapped angles of the state."""
        old_arrs, x0, n_rots, new_arrs, map_idx = self.step_begin(action)
        opt = self.optimizer
        psi0 = self.step_psi0()
        x_opt, nfev = None, 0
        if self.cfg.optim_method == "scipy_each_step":
            if self.cfg.optim_alg == "adam":
                x_opt, energy, nfev = opt.fused_step(psi0, old_arrs, x0,
                                                     n_rots, new_arrs,
                                                     map_idx)
                return self.step_finish(x_opt, energy, nfev, train_flag)
            x_opt, _, nfev = opt.optimize(psi0, old_arrs, x0, n_rots)
        x = x0 if x_opt is None else x_opt
        x_new = np.where(map_idx >= 0, np.asarray(x)[np.maximum(map_idx, 0)],
                         0.0)
        energy = opt.energy(psi0, new_arrs, x_new)
        return self.step_finish(x_opt, energy, nfev, train_flag)

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
