"""Smoke run of the PyTorch port on one CUDA card: both engines of the fused
Adam env step, noiseless, with depolarizing noise and with a psi0 per env,
the composed engine's tape kernels (forward B3f, adjoint B3b), and the
vectorized trainer through each of the six fused-kernel variants, in the
TensorRL-fixed, TensorRL-trainable and StructureRL families, and through
the composed engine with the su4 gate set and with shot noise; the
sequential trainer (the CLI without --vector) with Adam, through both
fused kernels at E = 1, and with COBYLA, on csim and, under noise,
through B3f; the tensor-network warm start (stages 0 and 1, the data tool
with its circuit fit on the card) of the 8q H2O, 12q LiH and 20q
Heisenberg trainers, which then train from it; the multi-device
path (an (amp, dp) mesh of devices, every shard on this one card) at 20q;
and the composed engine at 17-20 qubits (the sweep tape kernels) with
the 20q su4 trainer at full width; and complex128 on the card
(``--sim_dtype complex128``: the composed engine on the double-precision
tape kernels, csrc/apply_tape_f64.cu) with the main path's trainer, and
a generation of the structure search; the tools: the complex128 polish
of a champion and of a trainer's best step, and the 20q demo on one card
and on an (amp, dp) mesh, once under the profiling hook.

    python3 chip_smoke.py
    python3 chip_smoke.py --split     # the split phases alone (3b., 5b.,
                                      # and the tape kernels' by gate
                                      # class), and where v1p / v2p part
                                      # from the plain version at 100
                                      # iterations
    python3 chip_smoke.py --composed  # the composed engine's alone (19.-21.)
    python3 chip_smoke.py --composed-wide  # the composed engine at 17-20
                                      # qubits alone (27.), with the timed
                                      # 100-iteration su4 step at 20q
    python3 chip_smoke.py --h-psi     # the composed su4 step at 12 and
                                      # 16q with each H psi of flip-group
                                      # planes, timed
    python3 chip_smoke.py --parting-env  # the v1 trainable draw whose env
                                      # left the agreement band at E = 64
    python3 chip_smoke.py --tape      # B3f / B3b at 8 and 10-16 qubits
                                      # through the wrappers alone, to
                                      # compare two checkouts
    python3 chip_smoke.py --band      # the 13-18q band's split alone (in
                                      # 5b.), to compare two checkouts
    python3 chip_smoke.py --sweep     # the sweep kernel's phases alone
                                      # (6f.-6h.), and the 20q trainer in
                                      # the in_state families; first the
                                      # kernel timed and split against a
                                      # parent commit's in
                                      # parent_checkout/, in turns
    python3 chip_smoke.py --sweep-time  # the sweep kernel timed at 20q
                                      # E = 8 and E = 1, and the split of
                                      # a launch (copies of its source
                                      # with work taken out)
    python3 chip_smoke.py --plain-modes  # the plain version's time with
                                      # and without autograd's bookkeeping,
                                      # and its peak memory at 20q
    python3 chip_smoke.py --warm-start  # the warm-start phases alone (25.),
                                      # and the 20q fit's ms an iteration
                                      # with its bricks one at a time and
                                      # in runs
    python3 chip_smoke.py --mesh      # the sharded path's phase alone
                                      # (26.), with the sharded step's
                                      # timings at 20q and 22q
    python3 chip_smoke.py --mesh --cards  # the same with the shards on
                                      # the host's cards in turn
    python3 chip_smoke.py --f64       # the complex128 phases alone (28.),
                                      # and the 20q su4 trainer in
                                      # complex128
    python3 chip_smoke.py --sweep-tape  # the sweep tape kernels' float
                                      # (17q, 20q) and double (8-20q)
                                      # instances alone, with their ptxas
                                      # lines
    python3 chip_smoke.py --tools     # the tools' phases alone (29b.),
                                      # then the champion's polish at
                                      # 3000 x 8 x 3 (its graph's capture
                                      # timed) and the 20q demo at its
                                      # defaults on both meshes

The v2 kernel runs a start in one CTA up to 12 qubits, in a thread-block
cluster of 2^(n - 12) CTAs from 13 to 16 (the cluster kernel, 6b.-6c.),
in 2^(n - 12) CTAs in clusters that trade through global memory at 17-18
(the group kernel, 6d.-6e.), and at 19-20, where the card cannot hold a
start, with a start's state swept through L2 by a slot of a cooperative
grid, a start a slot at a time (the sweep kernel, csrc/
fused_adam_v2_sweep.cu, 6f.-6h.).

Phases, one line each with its seconds:

1. device     -- a CUDA card must be present (no CPU fallback); prints
                 ``nvidia-smi --query-gpu=name,power.limit``.
2. build      -- compiles every kernel with nvcc into build/, one nvcc per
                 source, and csim (the COBYLA cost's host engine) with
                 g++, all started together at the outset, and prints
                 ptxas' register / shared-memory / spill lines.  The
                 composed engine's phases (19.-21.) run first: the plain
                 references of 20., and then the plain versions'
                 100-iteration references (timed) of 18., 16., 12. and 8.
                 (``plain_prefetch``, as many as fit), while nvcc builds
                 the tape kernels (~45 s), the rest while the fused
                 kernels compile; the v1 phases then wait only for v1, so
                 the v2 source (the longest build) compiles while they
                 run: 3., 4., 23., 7., 8., v1's p = 0, 10., 11., 14.-17.
                 (v1's parts) and the sweep kernel's 6f.-6h., then the v2
                 phases.
3. kernel v1  -- the v1 kernel (fused_adam_v1) against its plain
                 PyTorch version at the 8-qubit main path's shapes (E = 128
                 envs, S = 8 starts, G = R = 26, D = 256, the H2O
                 Hamiltonian, tapes drawn from a numpy seed): iters = 3
                 (x_opt, where float32 determines it, and e_new within
                 1e-5), or, where float32 rounding decides the result,
                 within the plain version's own float32 noise
                 (ops/fused_adam.py:agreement), and iters = 100 (e_new
                 within 1e-4 Ha of the plain version's float32 run); e_new
                 also against the eager complex128 simulator; two
                 deliberately wrong kernel results must fail the same
                 check; then the kernel's and the plain version's times
                 (the plain version's: its float32 run in the
                 100-iteration check), and its bound with H psi over the
                 flip groups and, as the first v1 kernel counted it, as a
                 dense product.
3b. split v1  -- (``--split`` only) where a v1 launch's time goes: 100
                 iterations at the 8q shapes with every gate kNone (the
                 fixed part), at G = 13 and G = 26 (the cost of a tape
                 slot), at the trainable capacity (G = 172, R = 151) and at
                 5q Heisenberg (E = 64); then the 8q fixed and trainable
                 shapes at 8 and 16 amplitudes a thread (``reg_bits``).
4. trainer v1 -- the CLI's vectorized trainer on configs/TensorRL_fixed/
                 H2O8q_TNbond2.cfg with 128 env replicas for 12 vector
                 steps, results in a temporary directory outside the
                 repository; checks the reference-schema outputs and that
                 every env step went through fused_adam_v1; traced, it
                 prints the kernel's device time per vector step beside
                 the wall time per step (as does the trainable trainer of
                 17.).
5. kernel v2  -- the flip-group kernel (fused_adam_v2) held to the same
                 rule at the 12-qubit LiH shapes (E = 16, S = 8, G = R =
                 116, D = 4096, 84 flip groups), with the same oracle,
                 controls and timing; then a 3-iteration sweep over the
                 rest of the 10-16-qubit band: H2O 10q (E = 64), Heisenberg
                 14q (E = 64, the 14q trainer's shape) and 16q (E = 4) --
                 the cluster kernel, with the controls, every launch
                 through it (17q and 18q: 6d.).
5b. split      -- (``--split`` only) where a v2 launch's time goes: 100
                 iterations at the 12q LiH shapes with every gate kNone
                 (also with 2 of the 16 envs), at half and at the full
                 tape capacity (the cost of a tape slot), and at 10q H2O
                 (E = 64) and 14q Heisenberg (E = 8); the 13-18q band (13q
                 chain E = 8, 14q E = 8 and 64, 16q E = 4 and 16: the
                 cluster kernel; 17q chain and 18q E = 2: the group kernel)
                 with kernel ms, device ms and bounds, and the group kernel
                 there in clusters of 2, 4, 8 and 16 CTAs.  With ``--split``
                 the script runs only 3b. and this phase, a split by gate class
                 (synthetic tapes of one gate class each, at 100 and 0
                 iterations, with the swaps the schedule puts in), v2 at
                 the trainable capacities and v2n timed the same way, and
                 the two traced v1 trainers, and prints no result lines.
6. trainer v2 -- the trainer on configs/TensorRL_fixed/LIH12q_TNbond2.cfg
                 with 16 replicas for 70 vector steps (1,120 env steps, so
                 that the replay buffer passes batch 1000 and replay runs);
                 checks the outputs, that the replay ran and that every env
                 step went through fused_adam_v2.
6b. kernel v2 cluster -- the cluster kernel (fused_adam_v2_cluster) at 14q
                 Heisenberg (E = 8, S = 8, G = R = 46, clusters of 4 CTAs)
                 held to its plain version at 3 and 100 iterations with
                 the two controls, every launch through the cluster
                 kernel, and its times
                 and bound; ``cudaOccupancyMaxActiveClusters`` at C = 2-16;
                 at 13 qubits on an open Heisenberg chain built from its
                 Pauli strings (no config ships for 13q; E = 8, G = R = 46,
                 clusters of 2) with the controls; at 14q two launches bit
                 for bit, the noise variant at p = 0 against the noiseless
                 kernel, identical psi0 rows against the shared plane.
6c. trainer v2 14q -- the trainer on configs/TensorRL_fixed/
                 heisenberg_14q_TNbond2.cfg with 64 replicas for 20 vector
                 steps (n_step 5: 64 x 16 transitions pass batch 1000 and
                 replay runs), traced; every step through the cluster
                 kernel.
6d. kernel v2 group -- the group kernel (fused_adam_v2_group) at 18q
                 Heisenberg (E = 2, S = 8, G = R = 46, 64 CTAs a start in
                 clusters of 2) held to its plain version at 3 and 100
                 iterations with the two controls, every launch through
                 the group kernel, and its
                 times and bound; ``cudaOccupancyMaxActiveClusters`` at
                 17q and 18q for clusters of 2-16; at the 18q trainer's
                 shape (E = 8, S = 4) and on the 17q open chain (E = 2, 32
                 CTAs a start) with the controls; the noise variant at the
                 trainer's shape with the three; at 18q two launches bit
                 for bit, p = 0 against the noiseless kernel, identical
                 psi0 rows against the shared plane.
6e. trainer v2 18q -- the trainer on configs/TensorRL_fixed/
                 heisenberg_18q_TNbond2.cfg with 8 replicas (the config's
                 n_starts = 4) for 4 vector steps, traced; every step
                 through the group kernel; replay does not start (8 x 0
                 transitions < batch 1000).
6f. kernel v2 sweep -- the sweep kernel (fused_adam_v2_sweep) at 20q
                 Heisenberg at the trainer's shape (E = 8, S = 4, G = R =
                 46, D = 2^20) and on the 19q open chain (E = 2, S = 8)
                 held to its plain version at 3 iterations with the two
                 controls; the noise variant (E = 4) with the three, the
                 per-env psi0 variant at 20q (E = 4) with the three; every
                 launch through the sweep kernel; the CTAs the card holds
                 at once (the cooperative grid), an SM and their slots;
                 at the trainer's shape two 100-iteration launches bit
                 for bit, kernel ms (CUDA events), device ms (profiler),
                 bound and the barriers a launch passed; at the
                 sequential trainer's shape (E = 1) held at 100 iterations
                 to the plain version's float32 run with the controls, and
                 timed beside that run.
6g. trainer v2 20q -- the trainer on configs/TensorRL_fixed/
                 heisenberg_20q_TNbond2.cfg with 8 replicas (n_starts 4)
                 for 4 vector steps, traced: every step one sweep kernel
                 launch, env-steps/s, the kernel's device ms a vector step,
                 the card's busy share, peak device memory; replay does
                 not start.
6h. sequential v2 20q -- the CLI without --vector on
                 heisenberg_20q_TNbond2 for 2 Adam steps (one sweep kernel
                 launch at E = 1 each), traced: wall ms a step and the
                 kernel's share.
7. kernel v1 5q -- the v1 kernel below 8 qubits (the CLI's default config,
                 heisenberg_5q_TNbond2, E = 64) at 3 iterations, with the
                 controls.
8. kernel v1n -- the noise variant of v1 at the noise config's shapes
                 (H2O8q_TNbond2_noise: E = 128, S = 8, G = R = 46, p1 = 0.01,
                 p2 = 0.05, seeds per env) against its plain version under
                 the same Philox draws, as in 3., its e_new against the
                 eager simulator on the tape with the drawn errors woven in;
                 a third control, the noiseless kernel's result, must be
                 flagged in most envs at 3 iterations; then its times and
                 the noiseless kernel's on the same inputs.
9. p = 0      -- the noise variants of both kernels at p1 = p2 = 0 equal the
                 noiseless kernels (1e-6 allowed, bit for bit expected);
                 also reports whether two noiseless launches agree bit
                 for bit (the kernels sum in a fixed order).
10. Kraus    -- 4096 trajectory samples of the v1 noise variant on the
                 5-qubit tape of tests/test_noise_pallas.py at p1 = 0.15,
                 p2 = 0.25 (lr = 0, identity map): the mean of e_new within
                 5 sigma + 1e-3 of the exact density-matrix value; the
                 samples differ; e_new equals the plain version's within
                 1e-5.
11. trainer v1n -- the CLI's trainer on H2O8q_TNbond2_noise (depolarizing
                 noise inferred from the name) with 128 replicas for 4
                 vector steps, every step through the v1 noise variant.
12. kernel v2n -- the v2 noise variant at LiH 12q (E = 16, S = 8, G = R =
                 116) at 3 and 100 iterations with the three controls and
                 its
                 times, then at 14q (E = 8, the cluster kernel, with the
                 three controls).
13. trainer v2n -- the trainer on LIH12q_TNbond2 with --noise depolarizing,
                 16 replicas, 10 vector steps, every step through the v2
                 noise variant.
14. kernel v1 trainable -- v1 at configs/TensorRL_trainable/H2O8q_TNbond2's
                 capacities (E = 128, G = 172 gates, R = 151 angles; every
                 tape opens with the embedded warm start) at 3 iterations
                 with the controls, and its time (the plain version is
                 timed in 16.); 3 iterations only.
15. rows v1p  -- v1 launched with (E, D) psi0 planes whose rows all equal
                 the shared plane gives the shared launch bit for bit (100
                 iterations).
16. kernel v1p -- v1 with a random psi0 per env (block-coordinate mode's
                 input) at the same shapes, held to its plain version at 3
                 iterations with three controls (the third: every env
                 given the first env's psi0), and its and the plain
                 version's times (at 100 iterations the trainable tapes'
                 float32 trajectories part: no 100-iteration check).
17. trainers v1 trainable / StructureRL / v1p -- the trainer on the
                 TensorRL_trainable/ and StructureRL/ H2O8q_TNbond2 configs
                 (128 replicas, 4 vector steps, too few for replay),
                 through v1 with shared psi0, then on the trainable config
                 with --block_coord 3 (12 vector steps: replay runs),
                 every step through v1 with per-env psi0.
18. kernel v2 trainable, rows v2p, kernel v2p, trainer v2p -- 14.-17. for
                 v2 at TensorRL_trainable/LIH12q_TNbond2 (E = 16, G = 244,
                 R = 211), the trainer with --block_coord 3 and 16
                 replicas for 6 vector steps.
19. kernel tape -- the composed engine's forward (B3f) and adjoint (B3b)
                 tape kernels against their plain versions at the su4 8-qubit
                 shapes (E = 128, S = 8, G = R = 30, D = 256; random su4
                 tapes plus H, Y and a controlled RY so that every gate
                 class is hit, numpy seed 1234): forward planes within 1e-5,
                 psi0 cotangents and angle gradients within 1e-4; RYY's sign
                 flipped and RZZ's gradient dropped must fail; two launches
                 bit for bit; then both kernels' times (CUDA events over 20
                 launches back to back, and the profiler's device time)
                 beside their bounds and plain versions'; the same at 5
                 and 9 qubits (E = 64) -- the register kernels -- and at
                 10 (E = 64), 12 (E = 16, G = R = 30 and the 12q su4
                 trainer's capacity), 13 (E = 8, clusters of 2), 14 (E =
                 64, clusters of 4) and 16 (E = 4, clusters of 16) -- the
                 wide kernels, which read a schedule (its kernel held to
                 its twin word for word, and timed) --, at 12 and 14 also
                 on tapes woven with error Paulis, X / Y on controls that
                 sit on warp and cluster bits, under the noiseless tapes'
                 schedule.
20. composed su4 / shot / traj4 -- the composed step (AngleOptimizer
                 through the tape kernels against itself on their plain
                 versions, ops/fused_adam.py:agreement, 3 iterations, the
                 controls of 3.): su4 tapes at H2O8q_TNbond2's su4
                 capacities with the eager simulator as oracle; shot noise
                 with 1024 shots at H2O8q_TNbond2_noise_restricted's
                 capacities under the same tagged draws (and at 0 shots bit
                 for bit the noiseless composed step); depolarizing noise
                 over 4 trajectories at H2O8q_TNbond2_noise's; the third
                 control of the noisy ones is a result under other draws.
                 In each setting the step's CUDA graph (ComposedGraph)
                 against the eager kernel path at 3 iterations, bit for bit,
                 on two batches through one capture (then the first batch
                 again), each call's launches counted.  Then one
                 100-iteration su4 step: the graph's first call (warm-up
                 and capture) apart, its replays' ms and the eager path's,
                 the launches a step by the counters and by the profiler in
                 a traced replay, and that replay's device time.
21. trainers su4 / restricted / su4 12q -- the CLI's trainer on
                 H2O8q_TNbond2 --gate_set su4 and on
                 H2O8q_TNbond2_noise_restricted (shot noise and the hexagon
                 topology inferred from the name), 128 replicas, and on
                 LIH12q_TNbond2 --gate_set su4 with 16 replicas (the wide
                 kernels; replay is not reached: 16 x 0 transitions <
                 batch 1000), 12 vector steps of su4 at 8q (replay
                 runs), 4 of the restricted config and 2 at 12q, every
                 step one replay
                 of the composed step's graph (the first its warm-up and
                 capture): every vector step launches B3f iters + 2 times
                 and B3b iters times (at 12q also the schedule kernel
                 twice), and no fused kernel; the 12q trainer traced: wall
                 and device ms a vector step, B3f's, B3b's and the energy's
                 ops by kernel name, the card's busy share.
22. sequential cobyla 8q / cobyla noisy 8q -- (after 21.) the CLI
                 without --vector on H2O8q_TNbond2 with --optim cobyla, an
                 episode of 10 steps: every cost evaluation on csim on the
                 host, no kernel launched; nfev a step, ms a step and
                 csim's us an evaluation; then on H2O8q_TNbond2_noise, an
                 episode of 6 steps: one B3f launch each cost evaluation
                 (launches = nfev > 0), no other kernel; the noisy cost
                 (``kernel_energy_fn``) against the eager complex128
                 simulator on the same 12 woven draws within 1e-5, a
                 dropped error Pauli and a shifted angle exceeding it; its
                 wall and B3f device ms an evaluation beside csim's.
23. sequential v1 -- (after 4.) the CLI without --vector on H2O8q_TNbond2
                 for two episodes with a greedy test after the second
                 (--test_every 1), traced: one v1 launch at E = 1 every
                 env step (train and test), no other kernel; wall ms a
                 step and the kernel's device ms of it.  Then v1 at E = 1
                 against its plain version at 3 iterations with the
                 controls of 3., and its time.
24. kernel v2 E=1 / sequential v2 12q -- (after 6.) v2 at E = 1 (12q LiH)
                 at 3 iterations with the controls, and its time; the CLI
                 without --vector on LIH12q_TNbond2 for 6 Adam steps (one
                 v2 launch each) and 2 COBYLA steps (no kernel); the noisy
                 cost check of 22. at 12q, with csim's ms an evaluation
                 beside B3f's device ms an evaluation on the same tape.
25. warm start -- (after 22., before 3.) tools/generate_data.py
                 in-process with --device cuda (chi 2, 2 brick layers,
                 3000 Stiefel-Adam iterations, seed 0: the tool's
                 defaults) into a temporary data directory, for 8q H2O and
                 12q LiH (from their shipped npz) and 20q Heisenberg
                 (npz and qasm): the pipeline's 1e-6 energy round trip,
                 21 / 33 / 57 CNOTs, e_circuit within 1e-6 Ha of the
                 shipped warm start's energy (the shipped qasm on the
                 eager simulator on the card in complex128), each gap
                 printed, with e_dmrg, the overlap, the gate counts and
                 depth, the fit's wall s and device ms (CUDA events), the
                 stages' wall s and the run's peak device memory; then
                 the 8q fit again with its gradient conjugated (the JAX
                 convention, through an identity autograd Function around
                 the parameters), which must miss the shipped energy by
                 more than 1e-6.  Trainer v1 (4.), trainer v2 (6.) and
                 trainer v2 20q (6g.) then read that directory first
                 (prepended to ``DATA_SEARCH_PATHS`` for the phase, which
                 $TRLQAS_DATA_DIR set now would not reach: the list is
                 read at import), the warm start resolving there.
26. mesh      -- (after 6h.) the sharded path (``parallel/``,
                 ``optim/sharded_opt.py``) with every shard on cuda:0
                 (``mesh_devices``): (a) the 20q Heisenberg warm start's
                 energy through ``ShardedSimulator.expectation`` on (2 amp
                 x 4 dp) against the eager simulator on one device, both
                 complex128, within 1e-10; (b) ``value_and_grad_batched``
                 at 20q on (4 amp x 2 dp), complex128, 2 rows from the
                 warm start's state on a 46-gate tape (CNOTs, rotations,
                 controlled rotations, every fourth target a device bit)
                 at random angles against the
                 single-device adjoint (``sim/adjoint.py``), energy and
                 gradient within 1e-10; an exchange across the wrong
                 device bit and a psum without amp shard 1 must miss it;
                 (c) a sharded fused step (complex64, E = 1, S = 4, a
                 start a dp column, restart_scale 0, 3 iterations) against
                 the sweep kernel at E = 1 on the same starts
                 (``agreement``, the kernel's run as reference, 1e-5);
                 (d) a CircuitEnv and a 2-replica VectorCircuitEnv of the
                 20q config (TensorRL-fixed) on (2, 4) and a CircuitEnv on
                 (1, 1), 2 Adam iterations, driven by the DQN agent (cut to
                 2 x 64 hidden units and 64 replay rows) for 2 steps (1 on
                 (1, 1)): energies finite and within the spectrum, no
                 fused kernel launched; (f) ``parallel/dryrun.py:
                 dryrun_multichip(8, ["cuda:0"] * 8)``; (e) a 22q open
                 Heisenberg chain on (4 amp x 2 dp) from |0>, (b)'s check
                 without the controls, with its peak device memory.  With
                 ``--mesh`` also the sharded path's ms, launches and
                 device ms an Adam iteration (one adjoint sweep) and a
                 3-iteration step (20q on (2, 4), 22q on (4, 2),
                 complex64, 4 starts).  No kernel
                 of this PR: the sharded path is PyTorch operations, the
                 port of the JAX package's XLA code, and the kernels line
                 keeps its entries.

27. composed 20q -- (after 21.) the sweep tape kernels
                 (csrc/apply_tape_sweep.cu, 17-20 qubits) against their
                 plain versions as in 19., on a random 17-qubit batch (E =
                 2, S = 8, G = R = 46) and at the su4 20q config's
                 capacities (E = 8, S = 4, G = R = 46), both also woven,
                 the segment kernel held to ``sweep_segments`` word for
                 word, and their times and bounds; the composed step at
                 20q (E = 2, S = 1) in the three settings of 20. with the
                 controls, each one's CUDA graph against the eager kernel
                 path bit for bit, shot noise at 0 shots against the
                 noiseless step; the trainer
                 on heisenberg_20q_TNbond2 --gate_set su4 with 8 replicas
                 (the config's 4 starts x 100 iterations) for 2 vector
                 steps, traced: every vector
                 step iters + 2 sweep B3f and iters sweep B3b calls and
                 two segment builds, env-steps/s, the busy share, device
                 ms by kernel family, peak device memory; the noisy
                 COBYLA cost of 22. at 20q (csim not timed there).  With
                 ``--composed-wide`` also a 100-iteration su4 step at 20q
                 timed as a graph and eagerly, with its device ms by
                 kernel family, peak memory and the tape kernels' bounds.
28. complex128 -- (after 27.) the double-precision tape kernels
                 (csrc/apply_tape_f64.cu, the double instance of the
                 sweep kernels' body csrc/tape_sweep.cuh) against their float64 plain
                 versions at 8q (E = 128, S = 8, G = R = 30; one chunk a
                 row, one launch a call), 12q (E = 16 at the 12q su4
                 trainer's capacity), 17q (E = 2, S = 8) and 20q (E = 8,
                 S = 4, G = R = 46; segments, held to their twin): planes
                 within 1e-12, cotangents and gradients within 1e-10, the
                 RYY and RZZ controls exceeding them by 1e6, a repeat bit
                 for bit, then their times (CUDA events; profiler device
                 time), plain times, CTAs an SM and byte bounds; the
                 composed step in complex128 at the main path's shapes (8q,
                 E = 128): e_new against its float64 plain run at 3
                 iterations within 1e-10 Ha, and as a CUDA graph against
                 the eager kernel path bit for bit at 100 iterations; the
                 main path's trainer with --sim_dtype complex128 (128
                 replicas, 12 vector steps, the fewest with which replay
                 runs, traced: every vector step
                 iters + 2 double-precision B3f and iters B3b launches, no
                 fused kernel; env-steps/s and peak memory beside 4.'s);
                 the noisy COBYLA cost in complex128 at 8q against the
                 eager complex128 simulator within 1e-12 Ha.  With
                 ``--f64`` also the 20q su4 trainer in complex128 (8
                 replicas, 4 starts, traced, peak memory).
29. structure search -- (after 23.) one generation of
                 tools/structure_search.py on 8q H2O (64 structures, 100
                 iterations x 8 starts) and the champion's polish: two B1
                 launches, no other kernel; its wall s.
29b. tools    -- (after 26.) tools/polish_champion.py on 29.'s champion
                 (complex128, 300 iterations x 8 starts x 1 seed: the
                 composed engine on the double-precision tape kernels,
                 one graph; iters + 2 B3f and iters B3b launches, no
                 fused kernel), its error at most the search's polished
                 error + 1e-9 and above the ground state, and with one
                 start for 50 iterations on the card against --device cpu
                 within 1e-9 Ha; tools/polish_best.py on 23.'s summary (100
                 iterations x 8 x 1, the row's keys the script's, its error
                 at most analyze_longrun.f64_error of the same step +
                 1e-9); tools/demo_20q_training.py at 20q, one episode:
                 --mesh none for 3 env steps (a B2 sweep-kernel launch a
                 step, no other kernel), --mesh 2,4 with all eight shards
                 on this card for 2 (no kernel), their warm-start energies
                 within 1e-5 and above the bound less 1e-4, and the
                 --mesh none run again under TRLQAS_PROFILE
                 (utils/profiling.py: the Chrome trace holds device-kernel
                 events; whether it names the sweep kernel is printed) with
                 its PhaseTimer summary.  With ``--tools`` (alone) also the
                 champion's polish at the scripts' 3000 x 8 x 3, its graph's
                 capture and instantiation s, the first step's host and
                 device memory, the replays' s, seed 0 replayed bit for
                 bit, the graph's device operations, and the demo at its
                 defaults on both meshes (env-steps/s).

The line before the last is a JSON object with one entry per kernel
variant (v1, v1 noise, v2, v2 noise, the v2 cluster, group and sweep
kernels, v1 and v2 per-env psi0, the tape kernels' forward, adjoint and
schedule at 1-9, 10-16 and 17-20 qubits, and their double-precision
forward and adjoint);
the last
line is
{"ok": true, "device":
{...}}.  Any failure, or passing the deadline (``DEADLINE_S``: the
watchdog's message and exit 124; where the watchdog's thread cannot run,
SIGALRM ``HARD_DEADLINE_MARGIN_S`` later), exits non-zero without that
line.

Every kernel check and timing runs at the tape capacities that the
trainer's env gives the config (``CircuitEnv.tape_capacity`` and
``rot_capacity``: num_layers less the warm start's depth, plus one, and
in the in_state families plus the warm start's gates and angles).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, NamedTuple

sys.dont_write_bytecode = True      # write nothing into the checkout

DEADLINE_S = 600
HARD_DEADLINE_MARGIN_S = 30   # SIGALRM ends the process this much later
STARTS, ITERS, LR = 8, 100, 0.1
FIXED, TRAINABLE = "TensorRL_fixed/", "TensorRL_trainable/"
STRUCTURE = "StructureRL/"
# the main path's trainer 12 vector steps and the 12q one 70, the fewest
# with which their replay runs (128 x 8 and 16 x 66 transitions > batch
# 1000), cut from 20 and 80 to pay for the complex128 phases (28.)
V1_CONFIG, V1_ENVS, V1_STEPS = "H2O8q_TNbond2", 128, 12
V2_CONFIG, V2_ENVS, V2_STEPS = "LIH12q_TNbond2", 16, 70
V1_SMALL = ("heisenberg_5q_TNbond2", 64)      # v1 below 8 qubits
V1N_CONFIG = "H2O8q_TNbond2_noise"            # noise inferred from the name
V2N_STEPS = 10
V2N_SWEEP = (("heisenberg_14q_TNbond2", 8),)
KRAUS_ENVS, KRAUS_P = 4096, (0.15, 0.25)
# in_state placement: the 8q H2O configs with 128 replicas (v1), the 12q
# LiH config with 16 (v2); block-coordinate trainers with K = 3; 12 vector
# steps, the fewest with which the 8q trainers' replay runs (20 before the
# composed engine's phases needed the time)
T_STEPS, BLOCK_COORD = 12, ("--block_coord", "3")
# the 12q block-coordinate trainer (replay not reached at 16 replicas) cut
# to pay for the warm-start phases, and the 8q noisy one 12 -> 4 (too few
# for replay, which the fixed 8q trainers run) for the complex128 phases
V2P_STEPS, V1N_STEPS = 6, 4
# the untraced trainable and StructureRL trainers: 4 vector steps, too
# few for replay (the fixed 8q trainers and trainer v1p run it), so that
# the sequential phases fit the deadline
T_FAMILY_STEPS = 4
# the sequential trainer (the CLI without --vector): H2O8q_TNbond2 for two
# episodes with a greedy test after the second, every step the v1 kernel
# at E = 1; one COBYLA episode (csim on the host: no kernel); COBYLA on
# H2O8q_TNbond2_noise for an episode of a few steps, every cost evaluation
# one B3f launch; LiH 12q for a few Adam steps (the v2 kernel at E = 1)
# and two COBYLA steps.  Episodes of k steps: --num_layers = the warm
# start's depth + k
SEQ_ARGS = ("--episodes", "2", "--test_every", "1")
COBYLA_ARGS = ("--optim", "cobyla")
SEQ_COBYLA_STEPS, SEQ_NOISY_STEPS = 10, 6
SEQ_V2_STEPS, SEQ_V2_COBYLA_STEPS = 6, 2
CSIM_EVALS, COST_DRAWS, DROP_CANDIDATES = 200, 12, 8
# the composed engine: tape kernels at the su4 8q shapes (the su4 config's
# capacity G = R = 30, E = 128) and at 5 and 9 qubits (E = 64: groups of
# 4 lanes, a warp at 16 amplitudes a thread) -- the register kernels --,
# at 10 (E = 64), 12 (E = 16; also at the 12q su4 trainer's capacity,
# whose numbers go into the kernels line), 13 (E = 8, clusters of 2), 14
# (E = 64, clusters of 4) and 16 (E = 4, clusters of 16) -- the wide
# kernels --, at 12 and 14 also on woven tapes; its step at 3 iterations in three settings, eagerly and as
# a graph; three trainers: su4 and restricted at 8q with 128 replicas, su4
# at 12q LiH with 16 (root bench.py's ROWS[12])
SU4_ARGS = ("--gate_set", "su4")
TAPE_SHAPES = ((8, 128), (5, 64), (9, 64), (10, 64), (12, 16), (13, 8),
               (14, 64), (16, 4))
TAPE_WOVEN = (12, 14)    # also on tapes woven with error Paulis
TAPE_CAP = 30            # G = R of H2O8q_TNbond2 with the su4 warm start
SU4_12_CONFIG, SU4_12_ENVS, SU4_12_STEPS = "LIH12q_TNbond2", 16, 2
RESTRICTED_CONFIG = "H2O8q_TNbond2_noise_restricted"
NOISY_CONFIG = "H2O8q_TNbond2_noise"
# 12: the fewest vector steps with which the 8q replay runs (20 before the
# v2 register kernel's longer build needed the time), for the su4 trainer;
# the restricted (shot noise) trainer 4, too few for replay (cut for the
# complex128 phases: the su4 trainer runs replay through the same engine)
COMPOSED_STEPS, RESTRICTED_STEPS = 12, 4
N_SHOTS, N_TRAJ, NOISE_SEED = 1024, 4, 11
# the composed engine at 17-20 qubits (the sweep tape kernels,
# csrc/apply_tape_sweep.cu): the tape kernels on a 17-qubit register (no
# config ships for 17q; E = 2, the 13q chain's capacity) and at the su4
# 20q config's capacities (E = 8 replicas, S = 4 starts: G = R = 46), both
# also woven; the composed step at 20q in the three settings, its
# 3-iteration checks against the plain versions at E = WIDE_CHECK_ENVS
# (the plain versions' host time at E = 8 would not fit the deadline); the
# 20q su4 trainer at full width (8 replicas, the config's 4 starts x 100
# iterations) for WIDE_STEPS vector steps, traced (replay is not reached:
# 8 x 0 transitions < batch 1000); the noisy COBYLA cost at 20q
WIDE_CHAIN, WIDE_CHECK_ENVS, WIDE_CHECK_STARTS, WIDE_STEPS = 17, 2, 1, 2
TOL_FWD = 1e-5           # B3f planes vs plain: float32 gate arithmetic
TOL_BWD = 1e-4           # B3b cotangents and angle gradients: float32 row
#                          sums in another order
TOL_P0 = 1e-6            # noise variant at p = 0 vs the noiseless kernel
# the split phase's shapes besides 12q LiH: 10q and 14q (the cluster
# kernel)
SPLIT_SHAPES = (("H2O10q_TNbond2", 64), ("heisenberg_14q_TNbond2", 8))
# the cluster kernel (13-16 qubits, a cluster of 2^(n - 12) CTAs a start):
# checked and timed at 14q Heisenberg with E = 8, and its trainer with 64
# replicas (root bench.py's ROWS[14]) for 20 vector steps: with n_step 5 a
# replica's first transition enters the buffer at its 5th step, so 64 x 16
# > 1000 and replay runs (16 steps would leave 768)
V2C_CONFIG, V2C_ENVS, V2C_TRAINER_ENVS, V2C_STEPS = (
    "heisenberg_14q_TNbond2", 8, 64, 20)
# the rest of the band at 3 iterations: (config, envs); 14q (at the 14q
# trainer's 64 replicas) and 16q run the cluster kernel (held with the
# controls, every launch through it); 17q and 18q at E = 2 are the group
# phase's
V2G_CONFIG = "heisenberg_18q_TNbond2"
SWEEP = (("H2O10q_TNbond2", 64), (V2C_CONFIG, V2C_TRAINER_ENVS),
         ("heisenberg_16q_TNbond2", 4))
# no config ships for 13 or 17 qubits: an open Heisenberg chain from its
# Pauli strings at the 14q config's capacity (clusters of 2 CTAs at 13q)
CHAIN_QUBITS, CHAIN_ENVS, CHAIN_CAP = 13, 8, 46
# --split: the 13-18q band, (config or chain qubits, envs): the cluster
# kernel at 13-16q, the group kernel at 17-18q
BAND_SPLIT = ((CHAIN_QUBITS, 8), ("heisenberg_14q_TNbond2", 8),
              ("heisenberg_14q_TNbond2", 64), ("heisenberg_16q_TNbond2", 4),
              ("heisenberg_16q_TNbond2", 16), (17, 2), (V2G_CONFIG, 2))
# the group kernel (17-18 qubits, a start of 2^(n - 12) CTAs in clusters
# that trade through global memory): checked and timed at 18q Heisenberg
# with E = 2 (S = 8), checked at the 18q trainer's shape (E = 8, the
# config's n_starts = 4) and on the 17q chain (E = 2); its trainer with 8
# replicas (root bench.py's ROWS[18]) for 4 vector steps, too few for
# replay to start (8 x 0 transitions < batch 1000; the 14q trainer runs
# it); --split times its cluster sizes against each other
V2G_ENVS, V2G_TRAINER_ENVS, V2G_STARTS, V2G_STEPS = 2, 8, 4, 4
GROUP_CLUSTERS = (2, 4, 8, 16)
# the sweep kernel (19-20 qubits: every start's psi and lambda in device
# memory, swept by a cooperative grid): checked at 3 iterations at 20q
# Heisenberg at its trainer's shape (V2S_ENVS = 8 replicas, root bench.py
# having no 20q row and the 18q row's 8; S = 4, the config's n_starts) and
# on the 19q open chain (E = 2), with the controls; the noise and per-env
# psi0 variants at E = V2S_VARIANT_ENVS with their three (the psi0
# variant's third, env 0's row for every env, can flag only the others);
# at the trainer's shape two 100-iteration launches bit for bit, and
# timed; at E = 1 (the sequential trainer's launch) checked at 100
# iterations against the plain version's float32 run, whose time is the
# plain time; its trainer for V2S_STEPS vector steps, traced; the
# sequential trainer for SEQ_V2S_STEPS Adam steps
V2S_CONFIG = "heisenberg_20q_TNbond2"
V2S_ENVS, V2S_STARTS, V2S_VARIANT_ENVS, V2S_CHAIN_ENVS = 8, 4, 4, 2
# the 20q trainer cut from 6 vector steps, for the same reason
V2S_STEPS, SEQ_V2S_STEPS = 4, 2
SWEEP_IN_STATE_STEPS = 2      # --sweep: the in_state 20q trainers
# the warm start (stages 0 and 1: tools/generate_data.py, the fit on the
# card in complex128) of the three trainers' configs, with the data tool's
# defaults, into a temporary data directory that trainer v1, trainer v2 and
# trainer v2 20q then read in place of the shipped files: (config, CNOTs
# of the warm start); the molecules' Hamiltonians from their shipped npz
WARM_STARTS = ((V1_CONFIG, 21), (V2_CONFIG, 33), (V2S_CONFIG, 57))
WARM_FLAGS = ("--tn_bond", "2", "--layers", "2", "--maxiter", "3000",
              "--seed", "0")
TOL_WARM = 1e-6          # e_circuit (Ha) vs the shipped warm start's energy
TOL_ITERS3 = 1e-5        # x_opt and e_new after 3 Adam iterations
TOL_ITERS100 = 1e-4      # e_new (Ha) after 100 iterations: f32 summation
#                          order perturbs the Adam trajectories
# Float32 rounding decides some outputs in any float32 implementation, so
# an env whose x_opt or e_new differs may instead lie within the plain
# version's own float32 noise (ops/fused_adam.py:agreement); two
# deliberately wrong kernel results show that the check rejects errors.
TOL_ORACLE = 1e-4        # kernel e_new vs the complex128 eager simulator
# At ITERS iterations the plain version's float32 run alone is the
# reference (plain_reference; at 3 iterations also its float64 run and the
# runs with the H planes rounded differently): x_opt is not compared
# there, and every env's e_new has agreed with that run well inside
# TOL_ITERS100 (at most 1.8e-6) in every logged check, so an env must
# agree strictly (a single run spans no band of float32 noise); the
# complex128 oracle stays.  That run is also the plain version's time.
FP32_PEAK_FLOPS = 67e12  # H100 SXM, non-tensor-core float32
FP64_PEAK_FLOPS = 34e12  # H100 SXM, non-tensor-core float64
HBM_BYTES_PER_S = 3.35e12

_phase = ["start"]
_TEMP_DIRS = []          # removed at exit, whatever the outcome


def _expire():
    # os.write: the main thread may hold sys.stdout's lock
    os.write(1, f"DEADLINE: {DEADLINE_S} s passed in phase "
                f"{_phase[0]!r}\n".encode())
    os._exit(124)


def phase(name):
    _phase[0] = name
    return time.perf_counter()


def done(label, t0, **info):
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{label}] {time.perf_counter() - t0:.2f} s {extra}".rstrip(),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()
    return out.splitlines()[0]


def draw_batch(rng, n_env, cap, rot_cap, n_qubits, prefix=None,
               gate_set="cnot"):
    """Mid-episode inputs: per env a tape of ``cap`` gates and ``rot_cap``
    angles that opens with the ``prefix`` tape's gates (the embedded warm
    start of in_state placement) and goes on with random CNOTs and
    rotations (with ``gate_set='su4'``: RXX / RYY / RZZ and rotations), the
    same tape plus one gate, and the angle map."""
    import numpy as np

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape

    head = []
    if prefix is not None:
        head = [(GateKind(int(prefix.kind[g])), int(prefix.tq[g]),
                 int(prefix.cq[g]), float(prefix.angles[prefix.angle_slot[g]])
                 if prefix.angle_slot[g] >= 0 else 0.0)
                for g in range(prefix.n_gates)]
    olds, news, maps, x0s, n_rots = [], [], [], [], []
    for _ in range(n_env):
        gates = []
        for _ in range(int(rng.integers(0, cap - len(head)))):
            if rng.random() < 0.4:
                c = int(rng.integers(n_qubits))
                t = int((c + 1 + rng.integers(n_qubits - 1)) % n_qubits)
                two_q = (GateKind(int(rng.integers(9, 12)))
                         if gate_set == "su4" else GateKind.CX)
                gates.append((two_q, t, c))
            else:
                gates.append((GateKind(int(rng.integers(1, 4))),
                              int(rng.integers(n_qubits)), -1))
        old = GateTape(n_qubits, cap, rot_cap)
        new = GateTape(n_qubits, cap, rot_cap)
        for gate in head:
            old.add(*gate)
            new.add(*gate)
        for k, t, c in gates:
            ang = float(rng.normal()) if k != GateKind.CX else 0.0
            old.add(k, t, c, ang)
            new.add(k, t, c, ang)
        new.add(GateKind(int(rng.integers(1, 4))), int(rng.integers(n_qubits)))
        olds.append(old.arrays())
        news.append(new.arrays())
        mi = [-1] * rot_cap
        for j in range(old.n_rots):
            mi[j] = j
        maps.append(mi)
        x0s.append(old.x0())
        n_rots.append(old.n_rots)

    def stack(tapes):
        return tuple(np.stack([t[k] for t in tapes]) for k in range(4))

    return (stack(olds), stack(news), np.asarray(maps, np.int32),
            np.stack(x0s), np.asarray(n_rots))


class Engine(NamedTuple):
    """One kernel of the fused step: its wrapper (shared by a kernel's
    variants), its variant ("" plain, "noise", or "psi0" for per-env psi0
    planes), its plain version, the H operands it takes from the
    optimizer, the dynamic shared memory one CTA takes at a case's shapes,
    and the operations one H psi needs at a case's shapes (``h_flops``)."""
    name: str
    replaces: str
    source: str
    step: Callable
    variant: str
    plain: Callable
    h_ops: Callable
    smem_bytes: Callable
    h_flops: Callable

    @property
    def noise(self) -> bool:
        return self.variant == "noise"

    def with_optimizer(self, opt):
        """The composed engine (variant "composed") of ``opt``: its step
        through the tape kernels, and on their plain versions."""
        from tensorrl_qas_tpu_torch.optim.angle_opt import composed_step

        return self._replace(step=composed_step(opt),
                             plain=composed_step(opt, plain=True))

    def launches(self) -> int:
        """This variant's launches since the wrapper's counts were set to
        0 (a launch that were noisy and per-env would count in both of
        those and make the plain count negative: none is expected).  The
        cluster kernel's launches (13-16 qubits), the group kernel's
        (17-18) and the sweep kernel's (19-20) count among v2's too."""
        if self.variant == "noise":
            return self.step.noise_launches
        if self.variant == "psi0":
            return self.step.psi0_launches
        if self.variant in ("cluster", "group", "sweep"):
            # 0 in a checkout from before that kernel (--split's parent)
            return getattr(self.step, f"{self.variant}_launches", 0)
        return (self.step.launches - self.step.noise_launches
                - self.step.psi0_launches)

    def reset(self):
        """Set the wrapper's launch counts to 0."""
        for key in ("launches", "noise_launches", "psi0_launches",
                    "cluster_launches", "group_launches", "sweep_launches"):
            if hasattr(self.step, key):
                setattr(self.step, key, 0)


# the TPU kernel each (source, variant) replaces
REPLACES = {
    ("v1", ""): "tensorrl_qas_tpu/ops/pallas_opt.py:54",
    ("v1", "noise"): "tensorrl_qas_tpu/ops/pallas_opt.py:54 (_make_kernel, "
                     "noise=(p1, p2))",
    ("v1", "psi0"): "tensorrl_qas_tpu/ops/pallas_opt.py:54 (_make_kernel; "
                    "per-env psi0, which the JAX package runs on XLA: "
                    "tensorrl_qas_tpu/optim/angle_opt.py:694-699)",
    ("v2", ""): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160",
    ("v2", "noise"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160 "
                     "(_make_kernel, noise=(p1, p2))",
    ("v2", "psi0"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:646 "
                    "(_make_kernel, per_env_psi0=True)",
    ("v2", "cluster"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160 "
                       "(_make_kernel at 13-16 qubits, call :854)",
    ("v2", "group"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160 "
                     "(_make_kernel at 17-18 qubits, call :854)",
    ("v2", "sweep"): "tensorrl_qas_tpu/ops/pallas_opt2d.py:160 "
                     "(_make_kernel, call :854, at 19-20 qubits, where the "
                     "JAX package runs it through XLA: "
                     "tensorrl_qas_tpu/optim/angle_opt.py:500-560)",
    ("tape", "fwd"): "tensorrl_qas_tpu/ops/pallas_apply.py:473 "
                     "(_fwd_kernel, via _call_fwd :559)",
    ("tape", "bwd"): "tensorrl_qas_tpu/ops/pallas_apply.py:502 "
                     "(_bwd_kernel, via _call_bwd :576, the custom_vjp of "
                     "apply_tape_pallas_ri)",
    ("tape", "schedule"): "tensorrl_qas_tpu/ops/pallas_apply.py:473 and :502 "
                          "(the tape reads of _fwd_kernel and _bwd_kernel, "
                          "as a schedule both kernels of a step read)",
}
TAPE_SOURCE = "tensorrl_qas_tpu_torch/csrc/apply_tape.cu"
SWEEP_TAPE_SOURCE = "tensorrl_qas_tpu_torch/csrc/apply_tape_sweep.cu"
# the composed engine: a step of many tape-kernel launches, held like a
# fused step (its step / plain come from an optimizer, with_optimizer);
# its H psi through the dense planes up to 9 qubits, the flip-group planes
# above
COMPOSED = Engine(
    name="composed", replaces=REPLACES["tape", "fwd"], source=TAPE_SOURCE,
    step=None, variant="composed", plain=None,
    h_ops=lambda opt: (opt.h_planes() if opt.pauli.n_qubits <= 9
                       else opt.w_planes()),
    smem_bytes=lambda case: None,
    h_flops=lambda case: (8 << (2 * case.n) if case.n <= 9
                          else flip_h_flops(case)))


def without_autograd(fn):
    """``fn`` under ``torch.inference_mode``: the fused step's plain
    version takes its gradients by hand (an adjoint sweep), so autograd's
    bookkeeping would only add host time to each of its many small
    operations; the same kernels run in the same order."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        import torch

        with torch.inference_mode():
            return fn(*args, **kwargs)
    return run


def engines():
    """(v1, v1 noise, v2, v2 noise, v1 per-env psi0, v2 per-env psi0, v2
    cluster, v2 group, v2 sweep).  Both kernels take the flip-group
    planes; "v2 cluster", "v2 group" and "v2 sweep" are v2's wrapper
    counted by its cluster kernel's launches (13-16 qubits), its group
    kernel's (17-18) and its sweep kernel's (19-20, a source of its own).
    Their plain versions run ``without_autograd``."""
    from tensorrl_qas_tpu_torch.ops import fused_adam, fused_adam2d

    v2 = fused_adam2d._library
    out = {}
    for variant in ("", "noise", "psi0", "cluster", "group", "sweep"):
        suffix = f"_{variant}" if variant else ""
        noise = variant == "noise"
        if variant == "sweep":
            out["v2sweep"] = Engine(
                name="fused_adam_v2_sweep", replaces=REPLACES["v2", variant],
                source="tensorrl_qas_tpu_torch/csrc/fused_adam_v2_sweep.cu",
                step=fused_adam2d.fused_adam_step2d, variant=variant,
                plain=without_autograd(
                    fused_adam2d.fused_adam_step2d_reference),
                h_ops=lambda opt: opt.w_planes(),
                smem_bytes=lambda case:
                    fused_adam2d._sweep_library().fused_adam_sweep_smem_bytes(
                        case.g, case.args[7].numel()),
                h_flops=flip_h_flops)
            continue
        if variant not in ("cluster", "group"):
            out["v1" + variant] = Engine(
                name="fused_adam_v1" + suffix,
                replaces=REPLACES["v1", variant],
                source="tensorrl_qas_tpu_torch/csrc/fused_adam_v1.cu",
                step=fused_adam.fused_adam_step, variant=variant,
                plain=without_autograd(fused_adam.fused_adam_step_reference),
                h_ops=lambda opt: opt.w_planes(),
                smem_bytes=lambda case, noise=noise: v1_smem_bytes(case,
                                                                   noise),
                h_flops=flip_h_flops)
        out["v2" + variant] = Engine(
            name="fused_adam_v2" + suffix, replaces=REPLACES["v2", variant],
            source="tensorrl_qas_tpu_torch/csrc/fused_adam_v2.cu",
            step=fused_adam2d.fused_adam_step2d, variant=variant,
            plain=without_autograd(fused_adam2d.fused_adam_step2d_reference),
            h_ops=lambda opt: opt.w_planes(),
            smem_bytes=lambda case, noise=noise:
                v2().fused_adam_v2_smem_bytes(case.g, case.r, case.n,
                                              case.args[7].numel(), noise),
            h_flops=flip_h_flops)
    return tuple(out[k] for k in ("v1", "v1noise", "v2", "v2noise",
                                  "v1psi0", "v2psi0", "v2cluster",
                                  "v2group", "v2sweep"))


def flip_h_flops(case):
    """Operations of one H psi over a case's flip groups, H psi[i] =
    sum_f W_f[i] psi[i ^ f]: 8 an amplitude for a group whose imaginary
    plane is not zero (a complex product and sum), 4 for a real one."""
    dim, wim = 1 << case.n, case.args[6]
    n_cplx = int((wim != 0).any(dim=1).sum())
    return dim * (4 * wim.shape[0] + 4 * n_cplx)


def v1_smem_bytes(case, noise):
    """The v1 kernel's dynamic shared memory a CTA at a case's shapes, and
    whether the W planes are in it."""
    from tensorrl_qas_tpu_torch.ops import fused_adam

    wim, flips = case.args[6], case.args[7]
    n_cplx = int((wim != 0).any(dim=1).sum())
    rb = fused_adam.group_layout(case.n, STARTS)[0]
    sizes = [fused_adam._library().fused_adam_v1_smem_bytes(
        STARTS, case.g, case.r, case.n, flips.numel(), n_cplx, noise, rb, w)
        for w in (0, 1)]
    w_smem = sizes[1] <= fused_adam.MAX_SMEM_BYTES
    return {"bytes": sizes[w_smem], "W_in_shared_memory": w_smem}


class Case:
    """Kernel inputs drawn for one config of a family: E envs of random
    mid-episode tapes at the capacities the trainer's env gives the config
    (G gates, R angles; in the in_state families every tape opens with
    the embedded warm start of the env's reset), numpy seed 1234, a random
    psi0 (one row per env for the per-env psi0 variant), starts from the
    optimizer's start rule; the problem and the H operands from that env's
    optimizer.  For a noise variant, p1 and p2 from that optimizer (the
    config's) and seeds per env from a torch generator (``noise_kw``).
    ``gate_set='su4'``: the su4 env's capacities and su4 tapes; the
    composed engine's noisy settings set ``noise_kw`` to their seed and
    ``has_oracle`` to False afterwards.  ``caps=(G, R)`` overrides the
    env's capacities.  ``pauli`` (a PauliSum, with ``caps``) stands in for
    a config: that Hamiltonian on its own, noiseless.  ``n_starts``: the
    starts an env (S)."""

    def __init__(self, engine, config, n_env, family=FIXED,
                 gate_set="cnot", caps=None, pauli=None, seed=1234,
                 n_starts=STARTS):
        import types

        import numpy as np
        import torch

        from tensorrl_qas_tpu_torch.envs.circuit_env import (
            CircuitEnv,
            EnvConfig,
        )
        from tensorrl_qas_tpu_torch.optim.angle_opt import (
            AngleOptimizer,
            make_multistarts,
        )
        from tensorrl_qas_tpu_torch.train.config import get_config

        dev = torch.device("cuda")
        in_state = family != FIXED
        self.n_env, self.s = n_env, n_starts
        prefix = None
        if pauli is not None:
            self.n = n = pauli.n_qubits
            self.g, self.r = g, r = caps
            self.prob = types.SimpleNamespace(pauli=pauli)
            self.opt = AngleOptimizer(pauli, device=dev)
        else:
            conf = get_config(family, f"{config}.cfg")
            conf["env"]["gate_set"] = gate_set
            env = CircuitEnv(EnvConfig.from_conf(
                conf, tn_placement="in_state" if in_state else "fixed",
                noise_mode="depolarizing" if engine.noise else "none",
                device="cuda"))
            self.n = n = env.num_qubits
            self.g, self.r = g, r = caps or (env.tape_capacity,
                                             env.rot_capacity)
            self.prob = env.problem
            self.opt = env.optimizer
            if in_state:
                env.reset()
                prefix = env._tape(env.state)
        rng = np.random.default_rng(seed)
        self.has_oracle = True
        self.old, self.new, self.maps, x0, n_rots = draw_batch(
            rng, n_env, g, r, n, prefix, gate_set)
        rows = n_env if engine.variant == "psi0" else 1
        psi0 = (rng.normal(size=(rows, 1 << n))
                + 1j * rng.normal(size=(rows, 1 << n)))
        self.psi0 = psi0 / np.linalg.norm(psi0, axis=1, keepdims=True)

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)

        f32 = dict(dtype=torch.float32, device=dev)
        active = (torch.arange(r, device=dev)[None, :]
                  < torch.as_tensor(n_rots, device=dev)[:, None]).float()
        gen = torch.Generator(device=dev).manual_seed(7)
        starts = make_multistarts(torch.as_tensor(x0, **f32), active,
                                  n_starts, n_starts // 4, 0.1,
                                  gen).contiguous()
        self.args = (tuple(ints(a) for a in self.old),
                     tuple(ints(a) for a in self.new), ints(self.maps),
                     torch.as_tensor(self.psi0.real, **f32),
                     torch.as_tensor(self.psi0.imag, **f32),
                     *engine.h_ops(self.opt), starts,
                     active[:, None, :].contiguous())
        self.noise_kw = {}
        # the v2 wrapper's flip-group terms: the sweep kernel (19-20
        # qubits) computes W from them where a group has few, as the
        # optimizer passes them; kernel launches only, not the plain
        # version (none in a checkout from before them: --sweep's parent)
        self.kernel_kw = ({"terms": self.opt.w_terms()}
                          if engine.variant != "composed"
                          and "fused_adam_v2" in engine.name
                          and hasattr(self.opt, "w_terms") else {})
        if engine.noise:
            seeds = torch.randint(
                0, 2**31 - 1, (n_env, 2), dtype=torch.int32, device=dev,
                generator=torch.Generator(device=dev).manual_seed(11))
            self.noise_kw = dict(noise=(self.opt.noise_p1,
                                        self.opt.noise_p2), seeds=seeds)

    def controls(self):
        """Deliberately wrong kernel inputs the check must reject: Adam's
        rate off by 1%, and the RY angles' gradients dropped (their
        `active` entries zeroed); for a noise variant also the noiseless
        kernel on the same inputs, for the per-env psi0 variant the first
        env's psi0 shared by all.  A 1% rate still reaches the same optima
        in 100 iterations, so that one is required to fail at 3 iterations
        only; the third control must be flagged in most envs at 3.
        -> (name, args, lr, noise keywords, iterations where it must be
        flagged, least share of envs flagged there)."""
        import numpy as np
        import torch

        from tensorrl_qas_tpu_torch.circuits.tape import GateKind

        ry = np.zeros((self.n_env, self.r), bool)
        for e in range(self.n_env):
            kinds, slots = self.old[0][e], self.old[3][e]
            ry[e, slots[(kinds == GateKind.RY) & (slots >= 0)]] = True
        active = self.args[-1]
        no_ry = (active * torch.as_tensor(~ry, dtype=torch.float32,
                                          device=active.device)[:, None, :]
                 ).contiguous()
        out = [("lr x 1.01", self.args, LR * 1.01, self.noise_kw, (3,), 0.0),
               ("RY gradients dropped", (*self.args[:-1], no_ry), LR,
                self.noise_kw, (3, ITERS), 0.0)]
        if self.noise_kw.get("noise") is not None:
            out.append(("noiseless kernel", self.args, LR, {}, (3,), 0.5))
        if "seed" in self.noise_kw:
            out.append(("other draws", self.args, LR,
                        {"seed": self.noise_kw["seed"] + 1}, (3,), 0.5))
        if len(self.psi0) > 1:
            row0 = (*self.args[:3], self.args[3][:1], self.args[4][:1],
                    *self.args[5:])
            out.append(("psi0 row 0 for every env", row0, LR, {}, (3,),
                        0.5))
        return out

    def oracle_error(self, x_opt, e_new, envs, iters):
        """Largest |e_new + offset - E| over ``envs``, E from the eager
        complex128 simulator at the remapped x_opt on the new tape (for a
        noise variant with e_new's drawn errors, tag iters + 1, woven into
        the tape)."""
        import numpy as np
        import torch

        from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays
        from tensorrl_qas_tpu_torch.sim.apply import apply_tape
        from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation
        from tensorrl_qas_tpu_torch.sim.noise import (
            depolarizing_draw,
            noise_thresholds,
        )

        dev = x_opt.device
        x64 = x_opt.double().cpu().numpy()
        pauli = self.prob.pauli.tensors(dev, torch.complex128)
        new = tuple(torch.as_tensor(a, device=dev) for a in self.new)
        if self.noise_kw:
            new = extend_tape_arrays(new, *depolarizing_draw(
                new[0], self.noise_kw["seeds"], iters + 1,
                noise_thresholds(*self.noise_kw["noise"])))
        err = 0.0
        for e in envs:
            mi = self.maps[e]
            x_new = np.where(mi >= 0, x64[e][np.maximum(mi, 0)], 0.0)
            psi0 = self.psi0[e if len(self.psi0) > 1 else 0]
            psi = apply_tape(torch.as_tensor(psi0, device=dev),
                             *(a[e] for a in new), x_new)
            e_ref = float(pauli_expectation(psi, *pauli))
            err = max(err, abs(e_ref - (float(e_new[e]) + self.opt.offset)))
        return err


def plain_reference(engine, case, iters):
    """The plain version's runs on a case (``plain_results``; at ``ITERS``
    iterations its float32 run alone) and the first run's ms; needs no
    kernel."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    plain_ms = []

    def plain(*args, **kwargs):
        # the first call is the plain float32 run on case.args: timed
        if plain_ms:
            return engine.plain(*args, **kwargs)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = engine.plain(*args, **kwargs)
        b.record()
        b.synchronize()
        plain_ms.append(a.elapsed_time(b))
        return out
    if iters == ITERS:
        ref = [plain(*case.args, iters=iters, lr=LR, **case.noise_kw)]
    else:
        ref = fused_adam.plain_results(case.args, iters=iters, lr=LR,
                                       step=plain, **case.noise_kw)
    return ref, plain_ms[0]


def check_kernel(engine, case, label, iters, tol, controls=(), ref=None):
    """One kernel call held against the plain version's float32 runs
    (``agreement``, under the same noise draws for a noise variant; ``ref``
    from ``plain_reference`` when already run), the eager simulator and
    the controls; raises on any disagreement.  Returns the agreement
    statistics."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    t0 = phase(f"{label} iters={iters}")
    kw = case.noise_kw
    xk, ek = engine.step(*case.args, iters=iters, lr=LR, **kw,
                         **case.kernel_kw)
    torch.cuda.synchronize()
    ref, plain_ms = ref or plain_reference(engine, case, iters)
    cache = {}      # ref's float64 energies, shared with the controls
    env_ok, _, stats = fused_adam.agreement(
        case.args, ref, xk, ek, tol=tol, check_x=iters == 3,
        step=engine.plain, iters=iters, cache=cache, **kw)
    oracle = (case.oracle_error(xk, ek, range(0, case.n_env,
                                              max(1, case.n_env // 8)),
                                iters)
              if case.has_oracle else float("nan"))
    caught = {}
    for name, c_args, c_lr, c_kw, required, share in controls:
        xc, ec = engine.step(*c_args, iters=iters, lr=c_lr, **c_kw,
                             **case.kernel_kw)
        c_ok, _, _ = fused_adam.agreement(case.args, ref, xc, ec, tol=tol,
                                          check_x=iters == 3,
                                          step=engine.plain, iters=iters,
                                          cache=cache, **kw)
        flagged = int((~c_ok).sum())
        caught[name] = f"{flagged}/{case.n_env}"
        if iters in required and (flagged == 0
                                  or flagged <= share * case.n_env):
            raise AssertionError(f"{label}: control {name!r} passed the "
                                 f"check at iters={iters} in "
                                 f"{case.n_env - flagged}/{case.n_env} envs")
    ok = (bool(env_ok.all())
          and (oracle <= TOL_ORACLE or not case.has_oracle)
          and bool(torch.isfinite(ek).all())
          and bool(torch.isfinite(xk).all()))
    info = dict(tol=tol, **stats, oracle_max_abs_err=f"{oracle:.3e}",
                plain_float32_ms=f"{plain_ms:.4f}")
    if controls:
        info["controls_envs_flagged"] = caught
    done(f"{label} iters={iters}", t0, **info, ok=ok)
    if not ok:
        raise AssertionError(
            f"{label} disagrees with its plain version at iters={iters}: "
            f"envs failing {(~env_ok).nonzero().flatten().tolist()}, "
            f"oracle {oracle:.3e}")
    return {**stats, "plain_ms": plain_ms}


def tape_flops(tape, dim, table):
    """(E,) floating-point operations of one pass of each env's tape over
    one state (an FMA counts 2): ``table`` gives the operations per
    amplitude pair by gate kind; a controlled 1-qubit gate touches D/4
    pairs, every other gate D/2 (a two-qubit rotation's cq is its second
    qubit, not a control)."""
    import numpy as np

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind

    kinds, _, cqs, _ = (np.asarray(a) for a in tape)
    controlled = (cqs >= 0) & (kinds < int(GateKind.RXX))
    pairs = np.where(controlled, dim // 4, dim // 2)
    per_pair = sum(np.where(np.isin(kinds, k), v, 0) for k, v in table)
    return (per_pair * pairs).sum(axis=1)


def gate_tables():
    """Operations per amplitude pair, forward and adjoint.  A rotation
    (RX, RY, RZ, and RXX, RYY, RZZ, whose pairs are (i, i ^ 2^t ^ 2^c) or,
    for RZZ, two phases) takes 12 forward (two complex entries, one of
    them a real cos and the other a real or imaginary sin) and 32 in the
    adjoint (U^H on psi, U^T on lambda, 8 for its gradient term); H 8
    forward and 16 adjoint; CX, X, Y and Z none (a permutation or a
    sign)."""
    from tensorrl_qas_tpu_torch.circuits.tape import ROTATION_KINDS, GateKind

    rot = tuple(int(k) for k in ROTATION_KINDS)
    h = (int(GateKind.H),)
    return ((rot, 12), (h, 8)), ((rot, 32), (h, 16))


def flop_count(case, h_flops):
    """Floating-point operations one fused step needs on this batch, from
    its tapes gate by gate (``tape_flops``, ``gate_tables``).  Per
    evaluation H psi takes ``h_flops``, the Rayleigh quotient 8 per
    amplitude, lambda = 2 conj(H psi) 2; each Adam
    update about 12 per active angle and start.  A noise variant's error
    Paulis are swaps and signs: no flops."""
    import numpy as np

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind

    rot = (GateKind.RX, GateKind.RY, GateKind.RZ)
    dim = 1 << case.n
    fwd, bwd = gate_tables()
    evals = (ITERS + 1) * case.s          # iterations and the final check
    n_rot = np.isin(case.old[0], rot).sum(axis=1)
    per_env = (evals * tape_flops(case.old, dim, fwd)
               + ITERS * case.s * tape_flops(case.old, dim, bwd)
               + tape_flops(case.new, dim, fwd)
               + (evals + 1) * (h_flops + dim * 8)
               + ITERS * case.s * (dim * 2 + n_rot * 12))
    return float(per_env.sum())


def time_cuda(fn, warmup, reps):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_back_to_back(fn, launches=20):
    """ms per call of ``fn`` over ``launches`` calls between two CUDA
    events (after 2 warm-up calls), so that a short kernel's launches queue
    up behind each other; the median of 5 such runs."""
    return time_cuda(lambda: [fn() for _ in range(launches)], warmup=2,
                     reps=5) / launches


def device_ms(fn, name, reps=10):
    """Device time per call of the kernels whose names contain ``name``,
    from torch.profiler's CUDA activity over ``reps`` calls (None when the
    trace holds no device time for them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if name in e.key)
    return total / reps / 1e3 if total else None


def device_us_by_name(prof):
    """Device microseconds by kernel name in a finished torch.profiler
    trace, summed from its raw events (``key_averages`` builds a tree of
    every event first, over a minute for a traced trainer)."""
    import torch

    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            out[ev.name()] = out.get(ev.name(), 0.0) + ev.duration_ns() / 1e3
    return out


def bound(engine, case):
    """(operations, bytes, bound ms, bound_by) of one 100-iteration step
    on a case's inputs: the larger of its operations at the f32 peak and
    its bytes (inputs read once, outputs written once) at the HBM rate."""
    kw = case.noise_kw
    flops = flop_count(case, engine.h_flops(case))
    seeds = [kw["seeds"]] if kw else []
    tensors = [t for a in (*case.args, *seeds)
               for t in (a if isinstance(a, tuple) else (a,))]
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + case.n_env * (case.r + 1) * 4)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return (flops, nbytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_kernel(engine, case, label, time_plain=True, plain_ms=None):
    """Kernel ms (median of CUDA events), plain ms (one call, unless
    ``time_plain`` is False; ``plain_ms`` is one already measured on the
    same call), and the bound: the larger of this batch's operations at
    the f32 peak and its bytes (inputs read once, outputs written once)
    at the HBM rate."""
    t0 = phase(f"{label} timing")
    kw = case.noise_kw
    k_ms = time_cuda(lambda: engine.step(*case.args, iters=ITERS, lr=LR,
                                         **kw, **case.kernel_kw),
                     warmup=2, reps=10)
    extra = {}
    if kw:      # what the noise costs: the noiseless kernel, same inputs
        extra["noiseless_kernel_same_inputs_ms"] = "{:.4f}".format(time_cuda(
            lambda: engine.step(*case.args, iters=ITERS, lr=LR,
                                **case.kernel_kw), warmup=1, reps=10))
    p_ms = plain_ms
    if time_plain and p_ms is None:
        p_ms = time_cuda(lambda: engine.plain(*case.args, iters=ITERS,
                                              lr=LR, **kw), warmup=0, reps=1)
    flops, nbytes, bound_ms, bound_by = bound(engine, case)
    # the same bound with H psi counted as a dense complex D x D product,
    # as the first v1 kernel's bounds were
    dense_ms = 1e3 * max(flop_count(case, 8 << (2 * case.n))
                         / FP32_PEAK_FLOPS,
                         nbytes / HBM_BYTES_PER_S)
    done(f"{label} timing", t0, kernel_ms=f"{k_ms:.4f}",
         plain_ms="not timed" if p_ms is None else f"{p_ms:.4f}",
         bound_ms=f"{bound_ms:.4f}", dense_h_bound_ms=f"{dense_ms:.4f}",
         bound_by=bound_by, gflop=f"{flops / 1e9:.3f}",
         dynamic_smem_bytes_per_cta=engine.smem_bytes(case), **extra,
         library_ms="n/a (no single PyTorch call computes this fused step)")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def kernel_phase(engine, config, n_env, label, long_check=True,
                 family=FIXED, time_plain=True, pre=None):
    """Both iteration counts (the 100-iteration one unless
    ``long_check`` is False) with the controls, then the timing (the
    plain version's time that of its 100-iteration float32 run: the
    check's, else ``pre``'s, else one taken there).  ``pre``: (case, its
    100-iteration reference and the reference's ms) from
    ``plain_prefetch``, the same inputs."""
    case, ref = (pre[0], pre[1:]) if pre else (
        Case(engine, config, n_env, family), None)
    print(f"[{label}] {family}{config}: E={n_env} G={case.g} R={case.r} "
          f"D={1 << case.n} psi0 rows={len(case.psi0)}", flush=True)
    stats = {}
    for iters, tol in ((3, TOL_ITERS3), (ITERS, TOL_ITERS100)):
        if iters == ITERS and not long_check:
            continue
        stats[iters] = check_kernel(engine, case, label, iters, tol,
                                    case.controls(),
                                    ref=ref if iters == ITERS else None)
    plain_ms = stats[ITERS]["plain_ms"] if ITERS in stats else (
        ref[1] if ref else None)
    return {"max_abs_err": stats[max(stats)]["e_new_max_abs_err"],
            **time_kernel(engine, case, label, time_plain, plain_ms)}, case


def plain_prefetch(specs, ready):
    """The plain versions' 100-iteration references (their float32 runs,
    timed: ``plain_reference``) of later kernel phases (``specs``:
    (engine, config, envs, family), their ``kernel_phase`` arguments, so
    the same inputs), taken while nvcc builds the tape kernels, one after
    another until ``ready()``: no kernel is needed, and the script would
    wait for the build instead.  -> {engine name: (case, reference,
    ms)}."""
    out = {}
    for engine, config, n_env, family in specs:
        if ready():
            break
        t0 = phase(f"plain prefetch {engine.name}")
        case = Case(engine, config, n_env, family)
        out[engine.name] = (case, *plain_reference(engine, case, ITERS))
        done(f"plain prefetch {engine.name}", t0,
             plain_ms=f"{out[engine.name][2]:.4f}")
    return out


def split_phase(engine, config, n_env, others=(), few=None):
    """Where a launch's time goes (100 iterations, CUDA events): at
    ``config``'s shapes with every gate of both tapes kNone (H psi, Adam
    and the tail; also with ``few`` of the envs when given), at half the
    tape capacity and at the full one (their difference over the slots
    between them: the cost of a tape slot), and at each (config, envs,
    family) of ``others``."""
    import torch

    label = f"split {engine.name}"
    t0 = phase(label)
    full = Case(engine, config, n_env)
    half = Case(engine, config, n_env, caps=(full.g // 2, full.r // 2))

    def no_gates(tape):
        return (torch.zeros_like(tape[0]), *tape[1:])
    empty = (no_gates(full.args[0]), no_gates(full.args[1]), *full.args[2:])
    runs = {"none": empty}
    if few:
        # the gate-free launch with fewer envs: whether H psi's reads of W
        # are bound by each SM's own intake or by what L2 gives all SMs
        old, new, map_idx, *planes, starts, active = empty
        runs[f"none E={few}"] = (
            tuple(t[:few].contiguous() for t in old),
            tuple(t[:few].contiguous() for t in new),
            map_idx[:few].contiguous(), *planes, starts[:few].contiguous(),
            active[:few].contiguous())
    runs[f"G={half.g}"] = half.args
    runs[f"G={full.g}"] = full.args
    for other, envs, family in others:
        case = Case(engine, other, envs, family)
        runs[f"{family}{other} E={envs} G={case.g} R={case.r}"] = case.args
    ms, dev, live = {}, {}, {}
    for key, args in runs.items():
        ms[key] = time_cuda(lambda: engine.step(*args, iters=ITERS, lr=LR),
                            warmup=2, reps=10)
        dev[key] = device_ms(lambda: engine.step(*args, iters=ITERS, lr=LR),
                             engine.name, reps=5)
        live[key] = int((args[0][0] != 0).sum(1).max())
    per_slot = (ms[f"G={full.g}"] - ms[f"G={half.g}"]) / (full.g - half.g)
    done(label, t0, config=config, E=n_env, S=STARTS, iters=ITERS,
         kernel_ms={k: f"{v:.4f}" for k, v in ms.items()},
         device_ms={k: "not measured" if v is None else f"{v:.4f}"
                    for k, v in dev.items()},
         longest_live_tape=live, ms_per_tape_slot=f"{per_slot:.5f}",
         gate_free_share=f"{ms['none'] / ms[f'G={full.g}']:.3f}")
    return ms


def split_v1(v1):
    """The v1 split: 8q H2O (E = 128), its trainable capacity and 5q
    Heisenberg (E = 64); then the 8q shapes at 8 and 16 amplitudes a
    thread (``run_kernel``'s ``reg_bits``)."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    ms = split_phase(v1, V1_CONFIG, V1_ENVS,
                     ((V1_CONFIG, V1_ENVS, TRAINABLE), (*V1_SMALL, FIXED)))
    t0 = phase("split v1 register bits")
    stream = torch.cuda.current_stream().cuda_stream
    by = {}
    for family in (FIXED, TRAINABLE):
        case = Case(v1, V1_CONFIG, V1_ENVS, family)
        for rb in (3, 4):
            by[f"{family}{V1_CONFIG} G={case.g} A={1 << rb}"] = (
                "{:.4f}".format(time_cuda(
                    lambda: fused_adam.run_kernel(
                        fused_adam._library(), *case.args, iters=ITERS,
                        lr=LR, noise=None, seeds=None, stream=stream,
                        reg_bits=rb), warmup=2, reps=10)))
    done("split v1 register bits", t0, kernel_ms=by)
    return ms


def split_v2(v2):
    """The v2 split: 12q LiH (E = 16, also with 2 envs), 10q H2O and 14q
    Heisenberg (``SPLIT_SHAPES``)."""
    return split_phase(v2, V2_CONFIG, V2_ENVS,
                       tuple((c, e, FIXED) for c, e in SPLIT_SHAPES), few=2)


def band(n):
    """(the v2 kernel that runs n qubits -- "cluster" at 13-16, "group" at
    17-18, None below --, CTAs in one of its clusters)."""
    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    lib = fused_adam2d._library()
    if not hasattr(lib, "fused_adam_v2_group_band"):
        # a checkout from before the group kernel (--split's parent)
        size = lib.fused_adam_v2_cluster_size(n)
        return ("cluster" if size else None), size
    size = lib.fused_adam_v2_cluster_size(n, 0)
    if not size:
        return None, 0
    return ("group" if lib.fused_adam_v2_group_band(n) else "cluster"), size


def band_case(engine, config, n_env, **kw):
    """A Case of ``config``, or of the open Heisenberg chain on that many
    qubits (an int) at CHAIN_CAP."""
    if isinstance(config, int):
        return chain_case(engine, n_env, config, **kw)
    return Case(engine, config, n_env, **kw)


def band_label(config):
    return f"{config}q chain" if isinstance(config, int) else config


def split_band(v2):
    """``--split``: v2 across the 13-18q band (``BAND_SPLIT``: the 13q
    chain, 14q at E = 8 and 64, 16q at E = 4 and 16 -- the cluster kernel
    -- and the 17q chain and 18q at E = 2 -- the group kernel) at 100
    iterations, kernel ms (CUDA events), device ms (profiler) and the
    bound, so that a parent checkout compares with this one in the same
    call; then the group kernel at 17q and 18q in clusters of 2, 4, 8 and
    16 CTAs (``run_kernel``'s ``group_cluster``, uncounted), kernel ms and
    how many clusters the card holds."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    t0 = phase("split 13-18q band")
    ms, dev, bounds, cases = {}, {}, {}, {}
    for config, n_env in BAND_SPLIT:
        case = band_case(v2, config, n_env)
        key = f"{band_label(config)} E={n_env} G={case.g}"
        cases[key] = case

        def run():
            return v2.step(*case.args, iters=ITERS, lr=LR)
        ms[key] = f"{time_cuda(run, warmup=1, reps=5):.4f}"
        d = device_ms(run, v2.name, reps=3)
        dev[key] = "not measured" if d is None else f"{d:.4f}"
        _, _, b_ms, b_by = bound(v2, case)
        bounds[key] = f"{b_ms:.4f} ({b_by})"
    done("split 13-18q band", t0, iters=ITERS, S=STARTS, kernel_ms=ms,
         device_ms=dev, bound_ms=bounds)
    lib = fused_adam2d._library()
    if not hasattr(lib, "fused_adam_v2_group_band"):
        print("[split group clusters] skipped: no group kernel in this "
              "checkout", flush=True)
        return
    t0 = phase("split group clusters")
    stream = torch.cuda.current_stream().cuda_stream
    by = {}
    for key, case in cases.items():
        if band(case.n)[0] != "group":
            continue
        smem = lib.fused_adam_v2_smem_bytes(case.g, case.r, case.n,
                                            case.args[7].numel(), 0)
        for size in GROUP_CLUSTERS:
            held = lib.fused_adam_v2_cluster_occupancy(case.n, smem, size)
            k_ms = time_cuda(lambda: fused_adam2d.run_kernel(
                lib, *case.args, iters=ITERS, lr=LR, noise=None, seeds=None,
                stream=stream, group_cluster=size), warmup=1, reps=5)
            by[f"{key} C={size}"] = f"{k_ms:.4f} ms, {held} clusters at once"
    done("split group clusters", t0, iters=ITERS, S=STARTS, kernel_ms=by)


def sweep_phase(engine, sweep=SWEEP):
    """3 iterations over the band; where the cluster or group kernel
    runs, with the controls and its launch count checked."""
    for config, n_env in sweep:
        case = band_case(engine, config, n_env)
        check_band(engine, case, f"sweep {band_label(config)} E={n_env}", 3,
                   TOL_ITERS3,
                   case.controls() if band(case.n)[0] else ())


def check_band(engine, case, label, iters, tol, controls):
    """``check_kernel``, and, where the cluster or group kernel runs
    (``band``), every launch of it (the controls' too) through that
    kernel."""
    kind, size = band(case.n)
    if not kind:
        return check_kernel(engine, case, label, iters, tol, controls)
    step = engine.step
    count = f"{kind}_launches"
    before = (step.launches, getattr(step, count))
    stats = check_kernel(engine, case, f"{label} {kind} C={size}", iters,
                         tol, controls)
    runs = step.launches - before[0]
    if getattr(step, count) - before[1] != runs:
        raise AssertionError(f"{label}: {runs} launches, "
                             f"{getattr(step, count) - before[1]} through "
                             f"the {kind} kernel")
    return stats


def heisenberg_chain(n):
    """The open Heisenberg chain on n qubits from its Pauli strings: XX,
    YY and ZZ on each bond, weight 1."""
    import numpy as np

    from tensorrl_qas_tpu_torch.sim.expectation import PauliSum

    strings = []
    for i in range(n - 1):
        for a in "XYZ":
            word = ["I"] * n
            word[i] = word[i + 1] = a
            strings.append("".join(word))
    return PauliSum.from_strings(strings, np.ones(len(strings)), n)


def chain_case(engine, n_env, n=CHAIN_QUBITS, **kw):
    return Case(engine, None, n_env, caps=(CHAIN_CAP, CHAIN_CAP),
                pauli=heisenberg_chain(n), **kw)


def cluster_phase(v2, v2n, v2p, v2c):
    """The cluster kernel: at 14q Heisenberg (E = 8) held to its plain
    version with the controls, then timed; its occupancy at C = 2-16; at
    13q on the open chain (C = 2) with the controls; at 14q two launches
    bit for bit, p = 0 against the noiseless kernel, identical psi0 rows
    against the shared plane.  -> (kernels-line entry, 14q case)."""
    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    case = Case(v2c, V2C_CONFIG, V2C_ENVS)
    print(f"[kernel v2 cluster] {FIXED}{V2C_CONFIG}: E={V2C_ENVS} G={case.g} "
          f"R={case.r} D={1 << case.n} C={band(case.n)[1]}", flush=True)
    check_band(v2c, case, "kernel v2 cluster", 3, TOL_ITERS3,
               case.controls())
    stats = check_band(v2c, case, "kernel v2 cluster", ITERS, TOL_ITERS100,
                       case.controls())
    entry = {"max_abs_err": stats["e_new_max_abs_err"],
             **time_kernel(v2c, case, "kernel v2 cluster",
                           plain_ms=stats["plain_ms"])}
    t0 = phase("cluster occupancy")
    lib = fused_adam2d._library()
    occ = {}
    for n in (13, 14, 15, 16):
        # Heisenberg's n flip groups (n - 1 bonds and the diagonal)
        smem = lib.fused_adam_v2_smem_bytes(case.g, case.r, n, n, 0)
        occ[f"C={band(n)[1]}"] = {
            "smem_bytes_per_cta": smem,
            "max_active_clusters": lib.fused_adam_v2_cluster_occupancy(
                n, smem, 0)}
    done("cluster occupancy", t0, G=case.g, R=case.r, occupancy=occ)
    chain = chain_case(v2c, CHAIN_ENVS)
    check_band(v2c, chain, f"kernel v2 cluster {CHAIN_QUBITS}q chain "
               f"E={CHAIN_ENVS}", 3, TOL_ITERS3, chain.controls())
    p0_phase(v2, v2n, V2C_CONFIG, V2C_ENVS, repeat_bit_for_bit=True)
    psi0_rows_phase(v2, v2p, case)
    return entry, case


def group_phase(v2, v2n, v2p, v2g):
    """The group kernel (17-18 qubits): at 18q Heisenberg (E = 2, S = 8)
    held to its plain version with the controls, then timed; how many
    clusters of 2-16 CTAs the card holds at 17q and 18q; at the 18q
    trainer's shape (E = 8, S = 4) and on the 17q chain (E = 2) with the
    controls; the noise variant at the trainer's shape with its three;
    at 18q two launches bit for bit, p = 0 against the noiseless kernel,
    identical psi0 rows against the shared plane.  -> (kernels-line
    entry, the E = 2 case)."""
    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    case = Case(v2g, V2G_CONFIG, V2G_ENVS)
    print(f"[kernel v2 group] {FIXED}{V2G_CONFIG}: E={V2G_ENVS} G={case.g} "
          f"R={case.r} D={1 << case.n} CTAs a start="
          f"{1 << (case.n - 12)} C={band(case.n)[1]}", flush=True)
    check_band(v2g, case, "kernel v2 group", 3, TOL_ITERS3,
               case.controls())
    stats = check_band(v2g, case, "kernel v2 group", ITERS, TOL_ITERS100,
                       case.controls())
    entry = {"max_abs_err": stats["e_new_max_abs_err"],
             **time_kernel(v2g, case, "kernel v2 group",
                           plain_ms=stats["plain_ms"])}
    t0 = phase("group occupancy")
    lib = fused_adam2d._library()
    occ = {}
    for n in (17, 18):
        # Heisenberg's n flip groups (n - 1 bonds and the diagonal)
        smem = lib.fused_adam_v2_smem_bytes(case.g, case.r, n, n, 0)
        occ[f"{n}q"] = {"smem_bytes_per_cta": smem, **{
            f"C={c}": lib.fused_adam_v2_cluster_occupancy(n, smem, c)
            for c in GROUP_CLUSTERS}}
    done("group occupancy", t0, G=case.g, R=case.r, clusters_at_once=occ)
    for label, c in (
            (f"kernel v2 group E={V2G_TRAINER_ENVS} S={V2G_STARTS}",
             Case(v2g, V2G_CONFIG, V2G_TRAINER_ENVS, n_starts=V2G_STARTS)),
            (f"kernel v2 group 17q chain E={V2G_ENVS}",
             chain_case(v2g, V2G_ENVS, 17)),
            (f"kernel v2n group E={V2G_TRAINER_ENVS} S={V2G_STARTS}",
             Case(v2n, V2G_CONFIG, V2G_TRAINER_ENVS, n_starts=V2G_STARTS))):
        check_band(v2n if "v2n" in label else v2g, c, label, 3, TOL_ITERS3,
                   c.controls())
    p0_phase(v2, v2n, V2G_CONFIG, V2G_ENVS, repeat_bit_for_bit=True)
    psi0_rows_phase(v2, v2p, case)
    return entry, case


def check_sweep(engine, case, label, iters=3):
    """``check_kernel`` with the controls, every launch (the controls'
    too) through the sweep kernel."""
    step = engine.step
    before = (step.launches, step.sweep_launches)
    stats = check_kernel(engine, case, f"{label} sweep", iters,
                         TOL_ITERS3 if iters == 3 else TOL_ITERS100,
                         case.controls())
    runs = (step.launches - before[0], step.sweep_launches - before[1])
    if runs[0] != runs[1] or not runs[0]:
        raise AssertionError(f"{label}: {runs[0]} launches, {runs[1]} "
                             "through the sweep kernel")
    return stats


def sweep_kernel_phase(v2, v2n, v2p, v2s):
    """The sweep kernel (19-20 qubits): at 20q Heisenberg at the trainer's
    shape (E = 8, S = 4) and on the 19q chain (E = 2) held to its plain
    version at 3 iterations with the two controls, the noise and per-env
    psi0 variants (E = 4) with their three, every launch through the
    sweep kernel; the CTAs the card holds at once; at the trainer's shape
    two 100-iteration launches bit for bit, its time, device time and
    bound; at the sequential trainer's launch (E = 1) held at 100
    iterations to the plain version's float32 run, with the controls, and
    timed beside that run.  -> (kernels-line entry, the E = 8 case)."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    big = Case(v2s, V2S_CONFIG, V2S_ENVS, n_starts=V2S_STARTS)
    lib = fused_adam2d._sweep_library()
    smem = lib.fused_adam_sweep_smem_bytes(big.g, big.args[7].numel())
    ctas = fused_adam2d.check_residency(lib, smem)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = lib.fused_adam_sweep_slots(big.n, V2S_ENVS * V2S_STARTS, ctas)
    print(f"[kernel v2 sweep] {FIXED}{V2S_CONFIG}: G={big.g} R={big.r} "
          f"D={1 << big.n} chunk={1 << lib.fused_adam_sweep_chunk_bits()} "
          f"smem={smem} resident_ctas={ctas} ctas_per_sm={ctas // sms} "
          f"slots={slots}", flush=True)
    check_sweep(v2s, big, f"kernel v2 20q E={V2S_ENVS} S={V2S_STARTS}")
    chain = chain_case(v2s, V2S_CHAIN_ENVS, 19)
    check_sweep(v2s, chain, f"kernel v2 19q chain E={V2S_CHAIN_ENVS}")
    for engine in (v2n, v2p):
        check_sweep(engine, Case(engine, V2S_CONFIG, V2S_VARIANT_ENVS,
                                 n_starts=V2S_STARTS),
                    f"kernel {engine.name} 20q E={V2S_VARIANT_ENVS} "
                    f"S={V2S_STARTS}")
    t0 = phase("sweep repeat")
    x1, e1 = v2s.step(*big.args, iters=ITERS, lr=LR, **big.kernel_kw)
    x2, e2 = v2s.step(*big.args, iters=ITERS, lr=LR, **big.kernel_kw)
    torch.cuda.synchronize()
    bit = bool(torch.equal(x1, x2) and torch.equal(e1, e2))
    done("sweep repeat", t0, E=V2S_ENVS, S=V2S_STARTS, iters=ITERS,
         bit_for_bit=bit, ok=bit)
    if not bit:
        raise AssertionError("two sweep kernel launches differ")
    t0 = phase("kernel v2 sweep timing")
    k_ms = time_cuda(lambda: v2s.step(*big.args, iters=ITERS, lr=LR,
                                      **big.kernel_kw),
                     warmup=0, reps=3)
    dev_ms = device_ms(lambda: v2s.step(*big.args, iters=ITERS, lr=LR,
                                        **big.kernel_kw),
                       "fused_adam_v2_sweep", reps=2)
    flops, nbytes, bound_ms, bound_by = bound(v2s, big)
    # one launch more, uncounted, for its barrier counters
    res = fused_adam2d.run_sweep_kernel(
        lib, *big.args, iters=ITERS, lr=LR, noise=None, seeds=None,
        stream=torch.cuda.current_stream().cuda_stream, **big.kernel_kw)
    done("kernel v2 sweep timing", t0, E=V2S_ENVS, S=V2S_STARTS,
         kernel_ms=f"{k_ms:.4f}", device_ms=_ms_or_not(dev_ms),
         bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
         gflop=f"{flops / 1e9:.3f}", input_MB=f"{nbytes / 1e6:.1f}",
         slots=res[-1]["slots"], barriers=sweep_barriers(res, big),
         plain_ms="not timed (see E=1)")
    one = Case(v2s, V2S_CONFIG, 1, n_starts=V2S_STARTS)
    stats = check_sweep(v2s, one, "kernel v2 20q E=1", iters=ITERS)
    entry = {"max_abs_err": stats["e_new_max_abs_err"],
             **time_kernel(v2s, one, "kernel v2 sweep E=1",
                           plain_ms=stats["plain_ms"])}
    return entry, big


# The split of a sweep-kernel launch (--sweep, --sweep-time): copies of the
# kernel's source with some of its work taken out by text substitutions
# (each must match), built side by side with nvcc and launched on the same
# inputs.  Keyed by a name only that design's source holds; a variant
# lists (text, replacement) pairs, every occurrence replaced.
SWEEP_SPLIT_VARIANTS = {
    # the first design: every start in device memory, all starts
    # through each pass together
    "kHRows": {
        "no gate work": [
            ("for (int j = 0; j < gates; ++j) {",
             "for (int j = 0; j < 0; ++j) {"),
            ("for (int j = sh.misc[0] - 1; j >= 0; --j) {",
             "for (int j = -1; j >= 0; --j) {")],
        "no W reads": [
            ("__ldg(p.wre + (size_t)f * D + at[a])", "0.5f")],
        "barriers alone": [
            ("const int total = rows.count * chunks;",
             "const int total = 0;"),
            ("const int total = groups * chunks;", "const int total = 0;"),
            ("for (int r = blockIdx.x; r < p.E * p.S; r += gridDim.x) {",
             "for (int r = blockIdx.x; r < 0; r += gridDim.x) {")],
    },
    # the second design: starts in slots of the grid, one start of
    # a slot at a time
    "kSlotBytes": {
        "no gate work": [
            ("for (int j = 0; j < gates; ++j) {  // forward gates",
             "for (int j = 0; j < 0; ++j) {"),
            ("for (int j = sh.misc[0] - 1; j >= 0; --j) {  // adjoint gates",
             "for (int j = -1; j >= 0; --j) {")],
        "barriers alone": [
            ("for (int chunk = cb; chunk < chunks; chunk += C) {",
             "for (int chunk = cb; chunk < 0; chunk += C) {"),
            ("for (int chunk = slot.cb(p); chunk < chunks; chunk += C) {",
             "for (int chunk = slot.cb(p); chunk < 0; chunk += C) {"),
            ("if (slot.cb(p) == 0) adam_step(",
             "if (slot.cb(p) < 0) adam_step(")],
        "no H pass": [
            ("for (int chunk = slot.cb(p); chunk < chunks; chunk += C) {",
             "for (int chunk = slot.cb(p); chunk < 0; chunk += C) {")],
        "no Adam step": [
            ("if (slot.cb(p) == 0) adam_step(",
             "if (slot.cb(p) < 0) adam_step(")],
        "two CTAs an SM": [
            ("constexpr int kMinBlocks = 3;",
             "constexpr int kMinBlocks = 2;")],
        "H: W a constant": [
            ("wv = sh.wtab[kWTable * f + (v0 ^ ((kt >> (4 * a)) & 15))];",
             "wv = make_float2(1.f, 0.f);")],
        "H: partners from shared memory": [
            ("q[a] = __ldcg(psi + ((base + l0 + a * kThreads) ^ fl));",
             "q[a] = sh.psi[l0 + a * kThreads];")],
    },
}


# the slots the second design's --sweep-time also times at E = 8
SWEEP_SLOTS = (2, 4, 6)


def build_sweep_variants(source):
    """The split's copies of ``source`` (csrc/fused_adam_v2_sweep.cu of
    some checkout), one nvcc each, all started together -> {variant: the
    library bound by that checkout's ``bind_sweep``}; raises on a
    substitution that matches nothing or a failed build."""
    import ctypes
    import pathlib

    from tensorrl_qas_tpu_torch.ops import build, fused_adam2d

    text = pathlib.Path(source).read_text()
    design = next(k for k in SWEEP_SPLIT_VARIANTS if k in text)
    out_dir = build.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(SWEEP_SPLIT_VARIANTS[design].items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise AssertionError(f"split {name!r}: {old!r} not in "
                                     f"{source}")
            src = src.replace(old, new)
        cu = out_dir / f"sweep_split_{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"libsweep_split_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS,
             f"-I{pathlib.Path(source).parent}", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"split {name!r}: nvcc failed:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  ptxas split {name!r}: {' | '.join(regs[-2:])}", flush=True)
        libs[name] = fused_adam2d.bind_sweep(ctypes.CDLL(str(lib)))
    return libs


def sweep_time_phase(v2s):
    """(``--sweep-time``; ``--sweep`` runs it in a parent checkout and
    here, in turns) the sweep kernel of this checkout at the 20q trainer's
    shape (E = 8, S = 4, 100 iterations) and at E = 1: kernel ms (CUDA
    events, median of 3), device ms (profiler), bound, barriers a launch,
    and the split of a launch at E = 8: the copies of
    ``build_sweep_variants`` (no gate work; no W reads; barriers alone,
    every pass empty), every gate NONE on the same tapes (one empty
    segment a tape), and, where the wrapper takes flip-group terms, W read
    from its planes in place of being computed."""
    import inspect

    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    t0 = phase("sweep time")
    run = fused_adam2d.run_sweep_kernel
    params = inspect.signature(run).parameters
    source = v2s.source
    variants = build_sweep_variants(source)
    lib = fused_adam2d._sweep_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {"design": next(k for k in SWEEP_SPLIT_VARIANTS
                          if k in open(source).read())}
    for label, n_env in (("E=8", V2S_ENVS), ("E=1", 1)):
        case = Case(v2s, V2S_CONFIG, n_env, n_starts=V2S_STARTS)
        kw = {}
        if "terms" in params:
            kw["terms"] = case.opt.w_terms()

        def launch(lib=lib, args=case.args, **more):
            return run(lib, *args, iters=ITERS, lr=LR, noise=None,
                       seeds=None, stream=stream, **{**kw, **more})

        res = launch()
        torch.cuda.synchronize()
        out[f"{label} kernel_ms"] = time_cuda(launch, warmup=1, reps=3)
        dev = device_ms(launch, "fused_adam_v2_sweep", reps=2)
        out[f"{label} device_ms"] = _ms_or_not(dev)
        out[f"{label} bound_ms"] = bound(v2s, case)[2]
        out[f"{label} barriers"] = sweep_barriers(res, case)
        if label != "E=8":
            continue
        for name, vlib in variants.items():
            out[f"split {name} ms"] = time_cuda(
                lambda vlib=vlib: launch(vlib), warmup=1, reps=3)
        none = tuple(tuple(torch.zeros_like(a) if i == 0 else a
                           for i, a in enumerate(tape))
                     for tape in case.args[:2])
        out["split every gate NONE ms"] = time_cuda(
            lambda: launch(args=(*none, *case.args[2:])), warmup=1, reps=3)
        if "terms" in params:
            out["split W from planes ms"] = time_cuda(
                lambda: launch(terms=None), warmup=1, reps=3)
        if "slots" in params:
            for slots in SWEEP_SLOTS:
                out[f"slots {slots} ms"] = time_cuda(
                    lambda: launch(slots=slots), warmup=1, reps=3)
    done("sweep time", t0, **{k.replace(" ", "_"): (f"{v:.4f}"
                                                    if isinstance(v, float)
                                                    else v)
                              for k, v in out.items()})
    return out


def sweep_compare(v2s):
    """(``--sweep``) this checkout's sweep kernel against the parent
    commit's, in turns (parent, this, this, parent), each timed and split
    by ``sweep_time_phase``: the parent's from ``parent_checkout/`` (``git
    archive`` of the parent with this script copied in), in a process of
    its own, when that directory holds this script."""
    import pathlib

    parent = (pathlib.Path(__file__).resolve().parent / "parent_checkout"
              / "chip_smoke.py")

    def run_parent():
        if not parent.exists():
            print("[sweep parent] no parent_checkout/chip_smoke.py: not "
                  "timed", flush=True)
            return
        out = subprocess.run([sys.executable, str(parent), "--sweep-time"],
                             cwd=parent.parent, capture_output=True,
                             text=True, timeout=600, check=False)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("[sweep time]")]
        print("[sweep parent] " + (lines[-1] if lines else
                                   f"failed ({out.returncode}): "
                                   f"{out.stdout[-1500:]}"
                                   f"{out.stderr[-1500:]}"), flush=True)

    run_parent()
    sweep_time_phase(v2s)
    sweep_time_phase(v2s)
    run_parent()


def sweep_barriers(res, case):
    """Barriers a launch of the sweep kernel: its counters' final values
    over the CTAs that wait on each (the second design returns its
    scratch), else the first design's count from its schedule (1 + per
    iteration 2 K + 2, K the most segments of an old tape, + the tail's
    2 + the new tape's K' + 1)."""
    if isinstance(res[-1], dict):
        return res[-1]["barriers"]
    sched = res[-1]
    k_old, k_new = (int(sched[t, :, 0].max()) for t in (0, 1))
    return 1 + ITERS * (2 * k_old + 2) + (k_old + 2) + 2 + k_new + 1


def p0_phase(engine, noisy, config, n_env, repeat_bit_for_bit=False):
    """The noise variant at p1 = p2 = 0 against the noiseless kernel on
    the same inputs, at 100 iterations; with ``repeat_bit_for_bit`` two
    noiseless launches must also agree bit for bit."""
    import torch

    t0 = phase(f"p=0 {noisy.name}")
    case = Case(engine, config, n_env)
    x0, e0 = engine.step(*case.args, iters=ITERS, lr=LR)
    x1, e1 = engine.step(*case.args, iters=ITERS, lr=LR)
    seeds = torch.zeros((n_env, 2), dtype=torch.int32, device="cuda")
    xp, ep = noisy.step(*case.args, iters=ITERS, lr=LR, noise=(0.0, 0.0),
                        seeds=seeds)
    torch.cuda.synchronize()
    err = max(float((xp - x0).abs().max()), float((ep - e0).abs().max()))
    repeat = bool(torch.equal(x1, x0) and torch.equal(e1, e0))
    ok = err <= TOL_P0 and (repeat or not repeat_bit_for_bit)
    done(f"p=0 {noisy.name}", t0, config=config, n_env=n_env,
         max_abs_diff=f"{err:.3e}",
         bit_for_bit=bool(torch.equal(xp, x0) and torch.equal(ep, e0)),
         noiseless_repeat_bit_for_bit=repeat, ok=ok)
    if not ok:
        raise AssertionError(f"{noisy.name} at p = 0 differs from the "
                             f"noiseless kernel by {err:.3e}, or two "
                             f"noiseless launches differ ({repeat=})")


def psi0_rows_phase(engine, per_env, case):
    """The per-env psi0 launch with every row equal to the shared plane
    against the shared launch on ``case`` (a shared-psi0 case), at 100
    iterations: the stride only moves a pointer, so bit for bit."""
    import torch

    t0 = phase(f"rows {per_env.name}")
    xs, es = engine.step(*case.args, iters=ITERS, lr=LR)
    rows = (*case.args[:3], *(p.expand(case.n_env, -1).contiguous()
                              for p in case.args[3:5]), *case.args[5:])
    xp, ep = per_env.step(*rows, iters=ITERS, lr=LR)
    torch.cuda.synchronize()
    bit = bool(torch.equal(xp, xs) and torch.equal(ep, es))
    err = max(float((xp - xs).abs().max()), float((ep - es).abs().max()))
    done(f"rows {per_env.name}", t0, G=case.g, R=case.r, n_env=case.n_env,
         max_abs_diff=f"{err:.3e}", bit_for_bit=bit, ok=bit)
    if not bit:
        raise AssertionError(f"{per_env.name} with identical rows differs "
                             "from the shared launch")


def kraus_phase(noisy):
    """Trajectory samples of the v1 noise variant at 5 qubits against the
    exact channel (tests/test_noise_pallas.py's tape and Pauli sum)."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
    from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
    from tensorrl_qas_tpu_torch.sim.apply import zero_state
    from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
    from tensorrl_qas_tpu_torch.sim.noise import depolarizing_energy_exact

    t0 = phase("kraus")
    n, dev = 5, torch.device("cuda")
    tape = GateTape(n, 4, 4)
    tape.add(GateKind.RY, target=0, angle=0.7)
    tape.add_cx(0, 1)
    tape.add(GateKind.RX, target=2, angle=-1.1)
    tape.add_cx(1, 2)
    pauli = PauliSum.from_strings(
        [s + "I" * (n - len(s)) for s in ("Z", "IZ", "IIZ", "XX", "IYY")],
        [1.0, 0.5, -0.7, 0.9, 1.3], n)
    exact = depolarizing_energy_exact(zero_state(n), *tape.arrays(),
                                      tape.x0(), pauli.to_dense(), *KRAUS_P)
    e_n = KRAUS_ENVS
    arrs = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 .repeat(e_n, 1).contiguous() for a in tape.arrays())
    opt = AngleOptimizer(pauli, device=dev)
    psi0 = zero_state(n, torch.complex64, dev)
    x0 = torch.as_tensor(tape.x0(), dtype=torch.float32, device=dev)
    seeds = torch.randint(0, 2**31 - 1, (e_n, 2), dtype=torch.int32,
                          device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              5))
    args = (arrs, arrs, torch.arange(4, dtype=torch.int32, device=dev)
            .repeat(e_n, 1).contiguous(), psi0.real[None].contiguous(),
            psi0.imag[None].contiguous(), *opt.w_planes(),
            x0.repeat(e_n, 1, 1).contiguous(),
            torch.ones(e_n, 1, 4, device=dev))
    kw = dict(iters=1, lr=0.0, noise=KRAUS_P, seeds=seeds)
    _, ek = noisy.step(*args, **kw)
    _, ep = noisy.plain(*args, **kw)
    es = ek.double().cpu().numpy() + opt.offset
    sigma = es.std() / np.sqrt(e_n)
    dev_mean = abs(es.mean() - exact)
    plain_err = float((ek - ep).abs().max())
    ok = dev_mean < 5 * sigma + 1e-3 and es.std() > 0 and plain_err <= 1e-5
    done("kraus", t0, n_qubits=n, samples=e_n, p=KRAUS_P,
         mean=f"{es.mean():.6f}", exact=f"{exact:.6f}",
         sigma_of_mean=f"{sigma:.3e}", abs_dev=f"{dev_mean:.3e}",
         plain_max_abs_err=f"{plain_err:.3e}", ok=ok)
    if not ok:
        raise AssertionError("the v1 noise variant's trajectories miss the "
                             "Kraus channel or its plain version")


def draw_tape_batch(rng, n_env, s_n, cap, n):
    """Random su4 tapes of ``cap`` gates and angles, each opening with H, Y,
    a controlled RY, RXX, RYY and RZZ (every gate class of the TPU
    kernel's ``_gate_class``) and going on with random RXX / RYY / RZZ and
    RX / RY / RZ; random unit psi rows, angles and unit-norm cotangent rows
    on the card (from 17 qubits drawn there, and cotangent rows of norm
    2^(n/2 - 5)): (planes, tape, angles, cotangents)."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape

    tapes = []
    for _ in range(n_env):
        tape = GateTape(n, cap, cap)
        t = int(rng.integers(n))
        c = int((t + 1 + rng.integers(n - 1)) % n)
        tape.add(GateKind.H, t)
        tape.add(GateKind.Y, c)
        tape.add(GateKind.RY, t, c, float(rng.normal()))
        for k in (GateKind.RXX, GateKind.RYY, GateKind.RZZ):
            tape.add(k, t, c, float(rng.normal()))
        for _ in range(int(rng.integers(0, cap - 6))):
            t = int(rng.integers(n))
            c = int((t + 1 + rng.integers(n - 1)) % n)
            if rng.random() < 0.5:
                tape.add(GateKind(int(rng.integers(9, 12))), t, c,
                         float(rng.normal()))
            else:
                tape.add(GateKind(int(rng.integers(1, 4))), t,
                         angle=float(rng.normal()))
        tapes.append(tape.arrays())
    dev = torch.device("cuda")
    d = 1 << n
    f32 = dict(dtype=torch.float32, device=dev)
    tape = tuple(torch.as_tensor(np.stack([a[k] for a in tapes]),
                                 dtype=torch.int32, device=dev)
                 for k in range(4))
    angles = torch.as_tensor(rng.normal(size=(n_env, s_n, cap)), **f32)
    if n >= 17:
        # 2^17-2^20 amplitudes a row: drawn on the card (seeded from the
        # numpy stream), and the cotangent rows of norm 2^(n/2 - 5), so
        # that the angle gradients are of order 1/32 and not 2^(-n/2)
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.integers(2**31)))
        psi = torch.randn((2, n_env, s_n, d), generator=gen, **f32)
        psi /= psi.norm(dim=(0, 3), keepdim=True)
        lam = torch.randn((2, n_env, s_n, d), generator=gen, **f32)
        lam *= 2.0 ** (n / 2 - 5) / lam.norm(dim=(0, 3), keepdim=True)
        return (psi[0], psi[1]), tape, angles, (lam[0], lam[1])
    psi = (rng.normal(size=(n_env, s_n, d))
           + 1j * rng.normal(size=(n_env, s_n, d)))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    lam = rng.normal(size=(2, n_env, s_n, d))
    lam /= np.linalg.norm(lam, axis=(0, 3), keepdims=True)
    return ((torch.as_tensor(psi.real, **f32),
             torch.as_tensor(psi.imag, **f32)), tape, angles,
            (torch.as_tensor(lam[0], **f32), torch.as_tensor(lam[1], **f32)))


def tape_kernels_label(n):
    """Which tape kernels run n qubits."""
    if n <= 9:
        return "register kernel"
    if n <= 12:
        return f"wide kernel, {1 << (12 - n)} register row(s) a CTA"
    if n <= 16:
        return f"wide kernel, clusters of {1 << (n - 12)} CTAs"
    return "sweep kernels, a launch a segment"


def sweep_twin(tape, n):
    """The sweep tape kernels' schedule of (E, G) tapes by its twin
    (``ops/fused_adam2d.py:sweep_segments``), as an int32 tensor."""
    import torch

    from tensorrl_qas_tpu_torch.ops.fused_adam2d import sweep_segments

    arrs = [a.cpu().numpy() for a in tape[:3]]
    return torch.as_tensor([sweep_segments(*(a[e] for a in arrs), n)
                            for e in range(arrs[0].shape[0])],
                           dtype=torch.int32)


def tape_check(planes, tape, angles, cot, sched):
    """B3f and B3b through their wrappers on one batch (under ``sched``)
    against their plain versions (each run once, timed), with two wrong
    results -- RYY's sign flipped, RZZ's gradient dropped -- and a repeat.
    -> {"out", "grads", "err": (forward, adjoint) largest differences,
    "wrong": the controls' (forward, adjoint), "bit": the repeat's bits
    equal, "plain_ms": {"fwd", "bwd"}}."""
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    kw = dict(schedule=sched)
    out = at.apply_tape_fwd(*planes, *tape, angles, **kw)
    grads = at.apply_tape_bwd(*out, *cot, *tape, angles, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_p = at.apply_tape_fwd_plain(*planes, *tape, angles)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *tape, angles)
    torch.cuda.synchronize()
    plain_ms = {"fwd": 1e3 * (t2 - t1),
                "bwd": 1e3 * (time.perf_counter() - t2)}

    def max_err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))
    kind, _, _, slot = tape
    e_idx = torch.arange(kind.shape[0], device=kind.device)[:, None]
    ryy = torch.where(kind == int(GateKind.RYY), slot, -1)
    flip = torch.ones_like(angles)
    flip[e_idx.expand_as(ryy)[ryy >= 0], :, ryy[ryy >= 0].long()] = -1.0
    wrong_f = max_err(at.apply_tape_fwd(*planes, *tape,
                                        (angles * flip).contiguous(), **kw),
                      out_p)
    rzz = torch.where(kind == int(GateKind.RZZ), slot, -1)
    dang = grads[2].clone()
    dang[e_idx.expand_as(rzz)[rzz >= 0], :, rzz[rzz >= 0].long()] = 0.0
    out2 = at.apply_tape_fwd(*planes, *tape, angles, **kw)
    grads2 = at.apply_tape_bwd(*out2, *cot, *tape, angles, **kw)
    return {"out": out, "grads": grads,
            "err": (max_err(out, out_p), max_err(grads, grads_p)),
            "wrong": (wrong_f, max_err((dang,), (grads_p[2],))),
            "bit": all(torch.equal(a, b) for a, b in zip((*out, *grads),
                                                         (*out2, *grads2))),
            "plain_ms": plain_ms}


def tape_phase(n, n_env, cap, label, woven=False, s_n=STARTS):
    """B3f and B3b against their plain versions on one random batch of E =
    ``n_env`` envs and ``s_n`` starts, the two controls, a repeat bit for
    bit, then their times and bounds; from 10 qubits under a schedule
    built once, as a composed step builds it (the schedule kernel held to
    its twin word for word, and timed; from 17 qubits the sweep kernels'
    segments), and with ``woven`` also on the batch's tapes woven with
    error Paulis (``woven_phase``).  -> {"fwd": entry, "bwd": entry} of
    the kernels line (without launches), and "schedule" from 10 qubits."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    t0 = phase(label)
    sweep = n >= at.SWEEP_MIN_QUBITS
    planes, tape, angles, cot = draw_tape_batch(
        np.random.default_rng(1234), n_env, s_n, cap, n)
    sched = at.tape_schedule(*tape, n, cap)       # None below 10 qubits
    chk = tape_check(planes, tape, angles, cot, sched)
    out, grads, bit = chk["out"], chk["grads"], chk["bit"]
    (err_f, err_b), (wrong_f, wrong_b) = chk["err"], chk["wrong"]
    sched_err = 0.0
    segments = None
    if sched is not None:
        twin = (sweep_twin(tape, n) if sweep else
                torch.as_tensor(at.tape_schedule_plain(*tape, n, cap)))
        sched_err = float((sched.cpu() - twin).abs().max())
        if sweep:
            segments = sched[:, 0].tolist()
    ok = (err_f <= TOL_FWD and err_b <= TOL_BWD
          and wrong_f > 10 * TOL_FWD and wrong_b > 10 * TOL_BWD and bit
          and sched_err == 0.0
          and all(bool(torch.isfinite(t).all()) for t in (*out, *grads)))
    extra = {}
    if sweep:
        extra = dict(segments_per_env=segments, launches_per_call=(
            at._sweep_library().max_segments(cap, n)))
    done(label, t0, E=n_env, S=s_n, G=cap, R=cap, D=1 << n,
         kernels=tape_kernels_label(n),
         fwd_max_abs_err=f"{err_f:.3e}", bwd_max_abs_err=f"{err_b:.3e}",
         tol=(TOL_FWD, TOL_BWD),
         controls={"RYY sign flipped": f"{wrong_f:.3e}",
                   "RZZ gradient dropped": f"{wrong_b:.3e}"},
         repeat_bit_for_bit=bit,
         schedule_vs_twin="n/a" if sched is None else sched_err, **extra,
         ok=ok)
    if not ok:
        raise AssertionError(f"{label}: the tape kernels disagree with "
                             "their plain versions or a control passed")
    if woven:
        woven_phase(n, planes, tape, angles, cot, sched, f"{label} woven")

    t0 = phase(f"{label} timing")
    fwd_flops_t, bwd_flops_t = gate_tables()
    tape_np = tuple(a.cpu().numpy() for a in tape)
    plane_bytes = planes[0].numel() * 4
    tape_bytes = sum(a.numel() * 4 for a in tape)
    in_bytes = tape_bytes + angles.numel() * 4
    stream = at._stream(angles.device)
    # the main path's launches: one schedule a step, read by every launch
    if sweep:
        lib = at._sweep_library()
        run_fwd, run_bwd = at.run_sweep_fwd, at.run_sweep_bwd
        kernel_name = "apply_tape_sweep_{}"

        def run_sched():
            return at.run_sweep_schedule(lib, tape, n, stream=stream)

        def plain_sched():
            return sweep_twin(tape, n)
    else:
        lib = at._library()
        run_fwd, run_bwd = at.run_fwd, at.run_bwd
        kernel_name = "apply_tape_{}"

        def run_sched():
            return at.run_schedule(lib, tape, n, cap, stream=stream)

        def plain_sched():
            return at.tape_schedule_plain(*tape, n, cap)
    # the plain versions' times: their checked runs (the schedule's twin
    # timed here)
    runs = {
        "fwd": (lambda: run_fwd(lib, *planes, tape, angles, schedule=sched,
                                stream=stream),
                chk["plain_ms"]["fwd"],
                s_n * tape_flops(tape_np, 1 << n, fwd_flops_t).sum(),
                4 * plane_bytes + in_bytes, err_f),
        "bwd": (lambda: run_bwd(lib, *out, *cot, tape, angles,
                                schedule=sched, stream=stream),
                chk["plain_ms"]["bwd"],
                s_n * tape_flops(tape_np, 1 << n, bwd_flops_t).sum(),
                6 * plane_bytes + in_bytes + angles.numel() * 4, err_b)}
    if sched is not None:
        # integer work only: bound by its bytes (the tapes in, the rows out)
        runs["schedule"] = (run_sched,
                            time_cuda(plain_sched, warmup=0, reps=1), 0.0,
                            tape_bytes + sched.numel() * 4, sched_err)
    entries, info = {}, {}
    for key, (kernel, p_ms, flops, nbytes, err) in runs.items():
        k_ms = time_back_to_back(kernel, 5 if sweep else 20)
        dev_ms = device_ms(kernel, kernel_name.format(key),
                           reps=3 if sweep else 10)
        t_ops = float(flops) / FP32_PEAK_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        entries[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": 1e3 * max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes", "device_ms": dev_ms}
        info[key] = (f"kernel {k_ms:.4f} ms (back to back; profiler "
                     f"device time {_ms_or_not(dev_ms)}), "
                     f"plain {p_ms:.4f} ms, bound "
                     f"{entries[key]['bound_ms']:.6f} ms "
                     f"({entries[key]['bound_by']}; {flops / 1e6:.3f} "
                     f"MFLOP, {nbytes / 1e6:.3f} MB)")
    if sweep:
        smem = {"dynamic_smem_bytes_per_cta": tuple(
                    lib.smem_bytes(a, n) for a in (0, 1)),
                "ctas_per_sm": at.check_sweep_fit(lib, n, angles.device)}
    else:
        smem = {"dynamic_smem_bytes_per_cta": tuple(
            f(s_n, cap, cap, n, 1)
            for f in (lib.apply_tape_fwd_smem_bytes,
                      lib.apply_tape_bwd_smem_bytes))}
    done(f"{label} timing", t0, kernels=tape_kernels_label(n), **info,
         **smem, library_ms="n/a (no single PyTorch call computes a tape)")
    return entries


def woven_phase(n, planes, tape, angles, cot, sched, label):
    """B3f and B3b on the batch's tapes woven with error Paulis
    (``extend_tape_arrays``: X, Y or Z on a third of the rotations'
    targets, X or Y on every second qubit and control, wherever the
    schedule leaves them) under the noiseless tapes' schedule (weave 3),
    against the plain versions on the woven tapes; the errors must act,
    and some must fall on warp bits (and, in a cluster, on cluster bits)."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind
    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays

    t0 = phase(label)
    rng = np.random.default_rng(4321)
    kind, _, cq, _ = (a.cpu().numpy() for a in tape)
    rot = np.isin(kind, [int(GateKind.RX), int(GateKind.RY),
                         int(GateKind.RZ)])
    kt = np.where(rot & (rng.random(kind.shape) < 1 / 3),
                  rng.integers(int(GateKind.X), int(GateKind.Z) + 1,
                               kind.shape), 0)
    kc = np.where(cq >= 0, rng.integers(int(GateKind.X), int(GateKind.Y)
                                        + 1, kind.shape), 0)
    dev = tape[0].device
    woven = tuple(a.to(torch.int32).contiguous() for a in extend_tape_arrays(
        tape, torch.as_tensor(kt, device=dev),
        torch.as_tensor(kc, device=dev)))
    kw = dict(schedule=sched, weave=3)
    out = at.apply_tape_fwd(*planes, *woven, angles, **kw)
    grads = at.apply_tape_bwd(*out, *cot, *woven, angles, **kw)
    torch.cuda.synchronize()
    out_p = at.apply_tape_fwd_plain(*planes, *woven, angles)
    grads_p = at.apply_tape_bwd_plain(*out_p, *cot, *woven, angles)
    clean = at.apply_tape_fwd_plain(*planes, *tape, angles)

    def max_err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))
    err_f, err_b = max_err(out, out_p), max_err(grads, grads_p)
    acts = max_err(out, clean)
    if n >= at.SWEEP_MIN_QUBITS:
        # every qubit is local in its gate's segment: count the control
        # errors whose qubit lies above the chunk's 12 lowest qubits
        where = {"controls above qubit 11": int(
            ((kc > 0) & (cq > 11)).sum())}
        placed = where["controls above qubit 11"] > 0
    else:
        where = {"register": 0, "lane": 0, "warp": 0, "cluster": 0}
        for e, row in enumerate(sched.cpu().numpy()):
            for k, _, b, g in at.schedule_ops(row)[0]:
                if k != at.SWAP_OP and kc[e, g]:
                    where["register" if b < 4 else "lane" if b < 9
                          else "warp" if b < 12 else "cluster"] += 1
        placed = where["warp"] > 0 and (n <= 12 or where["cluster"] > 0)
    ok = (err_f <= TOL_FWD and err_b <= TOL_BWD and acts > 100 * TOL_FWD
          and placed)
    done(label, t0, errors={"targets": int((kt > 0).sum()),
                            "controls and second qubits by bit": where},
         fwd_max_abs_err=f"{err_f:.3e}", bwd_max_abs_err=f"{err_b:.3e}",
         tol=(TOL_FWD, TOL_BWD), errors_act=f"{acts:.3e}", ok=ok)
    if not ok:
        raise AssertionError(f"{label}: the tape kernels on woven tapes "
                             "disagree with their plain versions")


def _ms_or_not(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def graph_phase(opt, cases, mode):
    """The composed step's CUDA graph (``ComposedGraph``) against the eager
    kernel path (``_fused_step_composed``) at 3 iterations, bit for bit,
    on the cases' batches in turn through one capture (the first call the
    warm-up, the next ones replays, the last on the first batch again),
    under other noise seeds each call; each call's tape-kernel launches
    counted (iters + 2 forward, iters adjoint)."""
    import torch

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import ComposedGraph

    t0 = phase(f"composed {mode} graph")
    graph = ComposedGraph(opt)
    h_apply = opt._h_apply(torch.float32)
    bits, launches = [], []
    for i, case in enumerate((*cases, cases[0])):
        args = (*case.args[:5], *case.args[-2:])
        seed = NOISE_SEED + i
        before = (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches)
        xg, eg = graph(*args, iters=3, lr=LR, seed=seed)
        torch.cuda.synchronize()
        launches.append((at.apply_tape_fwd.launches - before[0],
                         at.apply_tape_bwd.launches - before[1]))
        xe, ee = opt._fused_step_composed(*args[:5], h_apply, *args[5:],
                                          iters=3, lr=LR, seed=seed)
        bits.append(bool(torch.equal(xg, xe) and torch.equal(eg, ee)))
    ok = all(bits) and graph.captures == 1 and all(
        n == (5, 3) for n in launches)
    done(f"composed {mode} graph", t0, batches=len(cases),
         bit_for_bit=bits, captures=graph.captures,
         launches_per_call=launches, ok=ok)
    if not ok:
        raise AssertionError(f"composed {mode}: the graph differs from the "
                             "eager kernel path or miscounts its launches")


def kernel_launches(prof, key):
    """Device kernel events whose names contain ``key`` in a finished
    torch.profiler trace."""
    import torch

    return sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and key in ev.name())


def composed_setup(mode, wide=False, cases=None):
    """One of the three composed settings' inputs, optimizer and engine,
    and its plain versions' 3-iteration reference (``plain_reference``,
    which needs no kernel, so it runs while nvcc builds them); with
    ``wide`` at 20 qubits (the 20q config, E = WIDE_CHECK_ENVS, S =
    WIDE_CHECK_STARTS: the sweep tape kernels), else at 8 (E = V1_ENVS, S
    = 8: the 8q trainers' replicas).  ``cases``: a dict of the inputs
    already drawn, by config and gate set (the two noisy settings share
    theirs, and the step's optimizer the inputs' flip-group planes).
    -> (mode, case, opt, engine, reference)."""
    import copy

    from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer

    name = f"{mode} 20q" if wide else mode
    t0 = phase(f"composed {name} setup")
    config, gate_set, kw = {
        "su4": (V1_CONFIG, "su4", dict(enable_2q=True)),
        "shot": (RESTRICTED_CONFIG, "cnot",
                 dict(noise_mode="shot", n_shots=N_SHOTS)),
        "traj4": (NOISY_CONFIG, "cnot",
                  dict(noise_mode="depolarizing", n_traj=N_TRAJ)),
    }[mode]
    n_env, shape = V1_ENVS, {}
    if wide:
        config, n_env = V2S_CONFIG, WIDE_CHECK_ENVS
        shape = dict(n_starts=WIDE_CHECK_STARTS)
    cases = {} if cases is None else cases
    if (config, gate_set) not in cases:
        drawn = Case(COMPOSED, config, n_env, gate_set=gate_set, **shape)
        drawn.other = Case(COMPOSED, config, n_env, gate_set=gate_set,
                           seed=4321, **shape)
        cases[config, gate_set] = drawn
    case = copy.copy(cases[config, gate_set])
    if (mode == "su4" and not wide
            and (case.g, case.r) != (TAPE_CAP, TAPE_CAP)):
        raise AssertionError(f"su4 capacities {case.g, case.r}, the tape "
                             f"phase assumed {TAPE_CAP}")
    print(f"[composed {name}] {config} {gate_set}: E={n_env} S={case.s} "
          f"G={case.g} R={case.r} D={1 << case.n} {kw}", flush=True)
    opt = AngleOptimizer(case.prob.pauli, device="cuda", **kw)
    if wide:
        opt._w_planes = case.opt.w_planes()      # the same H - offset I
    engine = COMPOSED.with_optimizer(opt)
    if mode != "su4":
        case.noise_kw = {"seed": NOISE_SEED}
        case.has_oracle = False
    ref = plain_reference(engine, case, 3)
    done(f"composed {name} setup", t0)
    return name, case, opt, engine, ref


def composed_phase(mode, case, opt, engine, ref):
    """The composed step through the tape kernels against itself on their
    plain versions (``check_kernel`` at 3 iterations, with controls) in
    one of the three settings, then its CUDA graph against the eager
    kernel path on two batches (``graph_phase``); for shot noise also
    n_shots = 0 against the noiseless composed step, bit for bit; for su4
    at 8q one 100-iteration step timed as a graph and eagerly."""
    import torch

    from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer

    check_kernel(engine, case, f"composed {mode}", 3, TOL_ITERS3,
                 case.controls(), ref=ref)
    graph_phase(opt, (case, case.other), mode)
    pauli = case.prob.pauli
    if mode.startswith("shot"):
        t0 = phase(f"composed {mode} n_shots=0")
        zero = COMPOSED.with_optimizer(AngleOptimizer(
            pauli, device="cuda", noise_mode="shot", n_shots=0))
        clean = COMPOSED.with_optimizer(AngleOptimizer(pauli, device="cuda"))
        xz, ez = zero.step(*case.args, iters=3, lr=LR, seed=NOISE_SEED)
        xc, ec = clean.step(*case.args, iters=3, lr=LR)
        bit = bool(torch.equal(xz, xc) and torch.equal(ez, ec))
        done(f"composed {mode} n_shots=0", t0, bit_for_bit=bit, ok=bit)
        if not bit:
            raise AssertionError("shot mode at n_shots = 0 differs from "
                                 "the noiseless composed step")
    if mode == "su4":
        composed_timing(opt, engine, case)


def composed_timing(opt, engine, case):
    """One 100-iteration su4 step: the graph's first call (warm-up and
    capture) apart, then its replays and the eager kernel path timed, the
    launches a step by the counters and, in a traced replay, by the
    profiler, and the traced replay's device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import ComposedGraph

    t0 = phase("composed su4 timing")
    counters = (at.apply_tape_fwd, at.apply_tape_bwd)
    args = (*case.args[:5], *case.args[-2:])
    graph = ComposedGraph(opt)
    t1 = time.perf_counter()
    graph(*args, iters=ITERS, lr=LR)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t1
    before = [k.launches for k in counters]
    graph_ms = time_cuda(lambda: graph(*args, iters=ITERS, lr=LR),
                         warmup=1, reps=5)
    per = [(k.launches - b) // 6 for k, b in zip(counters, before)]
    eager_ms = time_cuda(lambda: engine.step(*case.args, iters=ITERS,
                                             lr=LR), warmup=1, reps=3)
    # a replay traced: device time by kernel and the launches the
    # profiler sees, against the counters' (the profiler slows the host)
    before = [k.launches for k in counters]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        graph(*args, iters=ITERS, lr=LR)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t1)
    counted = [k.launches - b for k, b in zip(counters, before)]
    seen = [kernel_launches(prof, f"apply_tape_{key}")
            for key in ("fwd", "bwd")]
    dev = device_us_by_name(prof)
    tape_ms = sum(v for k, v in dev.items() if "apply_tape" in k) / 1e3
    ok = (per == counted == seen == [ITERS + 2, ITERS]
          and graph.captures == 1)
    done("composed su4 timing", t0, iters=ITERS,
         graph_step_ms=f"{graph_ms:.4f}", eager_step_ms=f"{eager_ms:.4f}",
         first_call_warmup_and_capture_s=f"{capture_s:.3f}",
         launches_per_step={"counters": per, "traced replay counters":
                            counted, "traced replay profiler": seen},
         profiled_step_wall_ms=f"{wall:.2f}",
         device_ms_tape_kernels=f"{tape_ms:.3f}",
         device_ms_all_kernels=f"{sum(dev.values()) / 1e3:.3f}",
         device_kernels=len(dev), ok=ok)
    if not ok:
        raise AssertionError("composed su4 timing: the launches a step "
                             "disagree between counters and profiler")


def _tape_kernels():
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    return at.apply_tape_fwd, at.apply_tape_bwd, at.tape_schedule


def reset_counts():
    """Every kernel's launch counts to 0 (the fused kernels' wrappers, the
    tape kernels' own, sweep and double-precision counts, the
    schedule's)."""
    for e in engines():
        e.reset()
    for k in _tape_kernels():
        k.launches = 0
    for k in _tape_kernels()[:2]:
        k.sweep_launches = k.f64_launches = 0


def kernel_counts():
    """{kernel name: launches} of every kernel since ``reset_counts``."""
    fwd, bwd, sched = _tape_kernels()
    out = {e.name: e.launches() for e in engines()}
    out.update({k.__name__: k.launches for k in (fwd, bwd, sched)})
    out.update({f"apply_tape_{kind}_{key}": getattr(k, attr)
                for key, k in (("fwd", fwd), ("bwd", bwd))
                for kind, attr in (("sweep", "sweep_launches"),
                                   ("f64", "f64_launches"))})
    return out


def trainer_phase(engine, config, n_env, vector_steps, label, extra=(),
                  expect_replay=True, family=FIXED, expect=None,
                  profile=False):
    """The CLI's trainer on ``family``/``config`` for ``vector_steps``
    steps with every kernel's launch count set to 0 just before and read
    just after; every step must have launched ``engine`` once and no other
    kernel, or the kernels as ``expect`` ({name: launches}, the others 0)
    says.  With ``profile`` the run is traced (torch.profiler, CUDA
    activity) and the kernel's device time per vector step is printed
    beside all kernels' and the wall time per vector step.
    -> {kernel name: launches}."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from tensorrl_qas_tpu_torch.train import cli

    expect = expect or {engine.name: vector_steps}
    out = tempfile.mkdtemp(prefix="trlqas_smoke_")
    try:
        t0 = phase(label)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        tracer = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
                  if profile else contextlib.nullcontext())
        with tracer:
            summary = cli.run([
                "--config", config, "--experiment_name", family,
                "--vector", str(n_env), "--total_steps",
                str(n_env * vector_steps), "--results_path", out + "/",
                *extra])
            torch.cuda.synchronize()
        trace = {}
        if profile:
            dev_us = device_us_by_name(tracer)
            kernel_ms = sum(v for k, v in dev_us.items()
                            if engine.name in k) / 1e3 / vector_steps
            all_ms = sum(dev_us.values()) / 1e3 / vector_steps
            wall_ms = 1e3 * n_env / summary["steps_per_sec"]
            trace = {"profiled_wall_ms_per_vector_step": f"{wall_ms:.3f}",
                     "kernel_device_ms_per_vector_step": f"{kernel_ms:.4f}",
                     "all_device_ms_per_vector_step": f"{all_ms:.4f}",
                     "kernel_share_of_step": f"{kernel_ms / wall_ms:.4f}",
                     "device_busy_share": f"{all_ms / wall_ms:.4f}"}
            if engine is COMPOSED:
                trace = {"profiled_wall_ms_per_vector_step":
                         f"{wall_ms:.3f}",
                         **trainer_split(tracer, vector_steps, wall_ms)}
        launches = kernel_counts()
        run_dir = os.path.join(out, family, config)
        stats = np.load(os.path.join(run_dir, "summary_0.npy"),
                        allow_pickle=True).item()
        with open(os.path.join(run_dir, "events_0.jsonl")) as f:
            events = [json.loads(line) for line in f]
        keys = {"iter", "steps", "episodes", "successes", "best_error",
                "best_step_error", "epsilon", "t"}
        checks = {
            "launches as expected": all(
                n == expect.get(k, 0) for k, n in launches.items()),
            "replay ran": summary["replay_steps"] > 0 or not expect_replay,
            "summary schema": set(stats) == {"train", "test"},
            "events": (len(events) == vector_steps
                       and all(keys <= set(ev) for ev in events)
                       and events[-1]["steps"] == n_env * vector_steps),
            "finite energies": bool(np.isfinite(
                [summary["best_step_error"], summary["warm_start_gap"]]
            ).all()),
        }
        done(label, t0, env_steps=summary["steps"],
             env_steps_per_s=f"{summary['steps_per_sec']:.2f}",
             replay_steps=summary["replay_steps"],
             peak_device_GiB=round(torch.cuda.max_memory_allocated() / 2**30,
                                   3),
             best_step_error_Ha=f"{summary['best_step_error']:.6e}",
             warm_start_gap_Ha=f"{summary['warm_start_gap']:.6e}",
             episodes=summary["episodes"], launches=launches, **trace,
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{label} checks failed: {checks}")
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def episode_layers(config, steps):
    """--num_layers for an episode of ``steps`` env steps on ``config``
    (TensorRL-fixed): the warm start's depth + steps."""
    from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        resolve_warmstart_qasm,
    )
    from tensorrl_qas_tpu_torch.train.config import get_config

    conf = get_config(FIXED, f"{config}.cfg")
    env, prob = conf["env"], conf["problem"]
    qasm = resolve_warmstart_qasm(prob["ham_type"], env["num_qubits"],
                                  env["tn_bond"], prob.get("geometry", ""),
                                  prob.get("mapping", "jordan_wigner"))
    return str(load_circuit_tape(qasm).depth() + steps)


def sequential_phase(config, label, extra=(), expect=None, profile=False,
                     keep=None):
    """The CLI without --vector (the sequential trainer) on
    TensorRL_fixed/``config`` with ``extra`` flags, every kernel's launch
    count set to 0 just before and read just after; ``expect(summary)``
    gives the launches ({kernel name: n}, every other kernel 0).  Checks
    the reference-schema outputs (one record a step, one event an
    episode) and finite errors; prints wall ms a step (train and test
    steps, host clock around the training, which ends in a host read),
    nfev a step, and with ``profile`` (torch.profiler, CUDA activity) the
    device ms a step by kernel.  ``keep``: a directory that receives the
    run's ``summary_0.npy`` as ``<keep>/TensorRL_fixed/<config>/``.  ->
    (summary, launches, per-step records of the train episodes)."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from tensorrl_qas_tpu_torch.train import cli

    out = tempfile.mkdtemp(prefix="trlqas_smoke_")
    try:
        t0 = phase(label)
        reset_counts()
        tracer = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
                  if profile else contextlib.nullcontext())
        with tracer:
            summary = cli.run(["--config", config, "--experiment_name",
                               FIXED, "--results_path", out + "/", *extra])
            torch.cuda.synchronize()
        launches = kernel_counts()
        want = expect(summary)
        run_dir = os.path.join(out, FIXED, config)
        stats = np.load(os.path.join(run_dir, "summary_0.npy"),
                        allow_pickle=True).item()
        with open(os.path.join(run_dir, "events_0.jsonl")) as f:
            events = [json.loads(line) for line in f]
        records = list(stats["train"].values())
        steps = summary["steps"] + summary["test_steps"]
        nfev = [n for rec in records for n in rec["nfev"]]
        errors = [e for mode in ("train", "test")
                  for rec in stats[mode].values() for e in rec["errors"]]
        checks = {
            "launches as expected": all(
                n == want.get(k, 0) for k, n in launches.items()),
            "summary schema": set(stats) == {"train", "test"},
            "a record a step": all(
                len(rec[key]) == len(rec["actions"])
                for rec in records for key in ("errors", "nfev", "opt_ang",
                                               "reward", "time")),
            "an event an episode": (
                [ev["episode"] for ev in events]
                == list(range(summary["episodes"]))),
            "finite errors": bool(np.isfinite(errors).all()),
        }
        trace = {}
        if profile:
            dev_us = device_us_by_name(tracer)
            ms = {name: sum(v for k, v in dev_us.items() if name in k)
                  / 1e3 / steps for name in want if want[name]}
            all_ms = sum(dev_us.values()) / 1e3 / steps
            wall_ms = 1e3 * summary["wall_s"] / steps
            trace = {"profiled_wall_ms_per_step": f"{wall_ms:.3f}",
                     "kernel_device_ms_per_step": {
                         k: f"{v:.4f}" for k, v in ms.items()},
                     "kernel_share_of_step": {
                         k: f"{v / wall_ms:.4f}" for k, v in ms.items()},
                     "all_device_ms_per_step": f"{all_ms:.4f}"}
        done(label, t0, episodes=summary["episodes"],
             test_episodes=summary["test_episodes"],
             env_steps=f"{summary['steps']} train + "
                       f"{summary['test_steps']} test",
             wall_ms_per_step=f"{1e3 * summary['wall_s'] / steps:.3f}",
             nfev_per_step=f"{np.mean(nfev):.2f}",
             nfev_max=max(nfev), steps_with_nfev=int(np.count_nonzero(nfev)),
             best_error_Ha=f"{summary['best_error']:.6e}",
             launches=launches, **trace, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{label} checks failed: {checks}")
        if keep is not None:
            # the summary for tools/polish_best.py, laid out as the CLI
            # lays out its results directory
            os.makedirs(os.path.join(keep, FIXED, config))
            shutil.copy(os.path.join(run_dir, "summary_0.npy"),
                        os.path.join(keep, FIXED, config))
        return summary, launches, records
    finally:
        shutil.rmtree(out, ignore_errors=True)


def seq_case(config, noise_mode="none", seed=1234, sim_dtype="auto"):
    """A sequential env's optimizer (COBYLA, ``noise_mode``, at
    ``sim_dtype``), its warm-start psi0 and a random mid-episode tape at
    its capacity (numpy ``seed``): the inputs of the COBYLA cost timings
    and checks."""
    import dataclasses

    import numpy as np

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape
    from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
    from tensorrl_qas_tpu_torch.train.config import get_config

    conf = get_config(FIXED, f"{config}.cfg")
    env = CircuitEnv(dataclasses.replace(EnvConfig.from_conf(
        conf, tn_placement="fixed", noise_mode=noise_mode,
        optim_alg="cobyla", device="cuda"), sim_dtype=sim_dtype))
    rng = np.random.default_rng(seed)
    n, cap = env.num_qubits, env.tape_capacity
    tape = GateTape(n, cap, env.rot_capacity)
    for _ in range(cap - 1):
        t = int(rng.integers(n))
        if rng.random() < 0.4:
            tape.add(GateKind.CX, t, int((t + 1 + rng.integers(n - 1)) % n))
        else:
            tape.add(GateKind(int(rng.integers(1, 4))), t,
                     angle=float(rng.normal()))
    return env.optimizer, env.psi0, tape


def csim_us(opt, psi0, tape):
    """csim's microseconds per COBYLA cost evaluation (the noiseless cost:
    ``cobyla_cost``'s host energy, psi0 and tape copied once), median of
    5 runs of ``CSIM_EVALS`` evaluations at 8 qubits, 2^(8 - n) times as
    many at n (at least 10)."""
    energy = opt.csim().energy_fn(psi0, *tape.arrays())
    x = tape.x0()
    evals = max(10, CSIM_EVALS >> max(0, opt.pauli.n_qubits - 8))
    runs = []
    for _ in range(5):
        t1 = time.perf_counter()
        for _ in range(evals):
            energy(x)
        runs.append(1e6 * (time.perf_counter() - t1) / evals)
    return sorted(runs)[2]


def noisy_cost_phase(config, label, csim=True, sim_dtype="auto",
                     tol=TOL_FWD):
    """The noisy COBYLA cost on the card (``kernel_energy_fn``: one B3f
    launch an evaluation on the tape woven with that evaluation's draw)
    against the eager complex128 simulator on the same draws
    (``plain_energy``), ``COST_DRAWS`` draws within ``TOL_FWD``; two
    wrong results must exceed it: the fired error Pauli whose loss moves
    the energy most dropped, and the last rotation's angle shifted by 0.1
    rad.  Then per evaluation: wall ms (the host read included), B3f's
    device ms (profiler) and bound, and the eager simulator's ms; with
    ``csim`` also csim's ms on the same tape beside them (not at 20 qubits,
    where its host runs take seconds).  ``sim_dtype`` 'complex128': the
    double-precision B3f, held within ``tol``.  -> {timings}."""
    import torch

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import extend_tape_arrays

    t0 = phase(label)
    opt, psi0, tape = seq_case(config, "depolarizing", sim_dtype=sim_dtype)
    f64 = opt.rdtype == torch.float64
    r = tape.rot_capacity
    energy = opt.kernel_energy_fn(psi0, tape.arrays(), r)
    kind = torch.as_tensor(tape.kind, dtype=torch.int32,
                           device="cuda").reshape(1, -1)
    x = tape.x0()
    gen = torch.Generator(device="cuda").manual_seed(NOISE_SEED)
    draws = [opt._draw_noise(gen, kind, 1, 1) for _ in range(COST_DRAWS)]
    counter = "f64_launches" if f64 else "launches"
    before = getattr(at.apply_tape_fwd, counter)
    got = [energy(x, d) for d in draws]
    launched = getattr(at.apply_tape_fwd, counter) - before
    t1 = time.perf_counter()
    want = [opt.plain_energy(psi0, tape.arrays(), x, d) for d in draws]
    eager_ms = 1e3 * (time.perf_counter() - t1) / len(draws)
    err = max(abs(a - b) for a, b in zip(got, want))
    # of the fired errors of the first draws (at least DROP_CANDIDATES of
    # them), the one whose loss moves the energy most (an error can leave
    # it unchanged)
    drops = []
    for noise, ref in zip(draws, want):
        if len(drops) >= DROP_CANDIDATES:
            break
        for which, k in enumerate(noise):
            for pos in (k != 0).nonzero().tolist():
                cut = [noise[0].clone(), noise[1].clone()]
                cut[which][tuple(pos)] = 0
                moved = abs(opt.plain_energy(psi0, tape.arrays(), x, cut)
                            - ref)
                drops.append((moved, cut, ref))
    if not drops:
        raise AssertionError(f"{label}: no error fired in {COST_DRAWS} "
                             "draws")
    _, worst, ref = max(drops, key=lambda d: d[0])
    shifted = x.copy()
    shifted[tape.n_rots - 1] += 0.1
    controls = {"error Pauli dropped": abs(energy(x, worst) - ref),
                "angle shifted": abs(energy(shifted, draws[0]) - want[0])}
    # per evaluation: wall (a fresh draw, the launch, the host read) and
    # the B3f launch's device time, beside its bound on the first draw's
    # woven row (planes in and out, the woven tape and the angles once;
    # its gates' operations, error Paulis none)
    wall_ms = time_cuda(lambda: energy(x), warmup=2, reps=20)
    b3f_ms = device_ms(lambda: energy(x), "apply_tape_f64_fwd" if f64
                       else "apply_tape_sweep_fwd"
                       if opt.pauli.n_qubits >= at.SWEEP_MIN_QUBITS
                       else "apply_tape_fwd", reps=20)
    host_us = csim_us(opt, psi0, tape) if csim else None
    woven = extend_tape_arrays(
        tuple(torch.as_tensor(a, device="cuda").reshape(1, 1, -1)
              for a in tape.arrays()), *draws[0])
    woven = [a.reshape(1, -1).cpu().numpy() for a in woven]
    dim = 1 << opt.pauli.n_qubits
    flops = float(tape_flops(woven, dim, gate_tables()[0]).sum())
    word = 8 if f64 else 4
    nbytes = word * (4 * dim + r) + 4 * 4 * woven[0].size
    peak = FP64_PEAK_FLOPS if f64 else FP32_PEAK_FLOPS
    b3f_bound = 1e3 * max(flops / peak, nbytes / HBM_BYTES_PER_S)
    ok = (err <= tol and launched == COST_DRAWS
          and all(v > tol for v in controls.values()))
    fired = sum(bool(((kt != 0) | (kc != 0)).any()) for kt, kc in draws)
    done(label, t0, n=opt.pauli.n_qubits, G=tape.capacity, R=r,
         draws=COST_DRAWS, draws_with_errors=fired,
         dtype=str(opt.rdtype), max_abs_err_vs_eager=f"{err:.3e}", tol=tol,
         b3f_launches=launched,
         controls={k: f"{v:.3e}" for k, v in controls.items()},
         eval_wall_ms=f"{wall_ms:.4f}",
         b3f_device_ms_per_eval=_ms_or_not(b3f_ms),
         b3f_bound_ms=f"{b3f_bound:.3e}",
         eager_complex128_ms_per_eval=f"{eager_ms:.3f}",
         csim_us_per_eval_same_tape=("not timed" if host_us is None
                                     else f"{host_us:.1f}"), ok=ok)
    if not ok:
        raise AssertionError(f"{label}: the card's cost disagrees with "
                             f"the eager one ({err:.3e}), or a control "
                             f"passed: {controls}")
    return {"max_abs_err": err, "eval_wall_ms": wall_ms,
            "b3f_device_ms": b3f_ms, "b3f_bound_ms": b3f_bound,
            "csim_us": host_us}


def cobyla_phases():
    """The sequential trainer under COBYLA at 8 qubits (needs csim and the
    tape kernels, no fused kernel): a noiseless episode of
    ``SEQ_COBYLA_STEPS`` steps, whose costs run on the host (csim; no
    kernel launch), and one of ``SEQ_NOISY_STEPS`` steps under
    depolarizing noise, every cost evaluation one B3f launch; then the
    noisy cost against the eager simulator with its controls.  -> B3f's
    launches in the noisy run."""
    summary, _, _ = sequential_phase(
        V1_CONFIG, "sequential cobyla 8q",
        COBYLA_ARGS + ("--episodes", "1", "--num_layers",
                       episode_layers(V1_CONFIG, SEQ_COBYLA_STEPS)),
        expect=lambda s: {})
    opt, psi0, tape = seq_case(V1_CONFIG)
    t0 = phase("csim 8q")
    done("csim 8q", t0, G=tape.capacity,
         csim_us_per_eval=f"{csim_us(opt, psi0, tape):.1f}",
         run_ms_per_eval=f"{1e3 * summary['wall_s'] / summary['nfev']:.3f}"
         if summary["nfev"] else "no evaluation")
    summary, launches, _ = sequential_phase(
        V1N_CONFIG, "cobyla noisy 8q",
        COBYLA_ARGS + ("--episodes", "1", "--num_layers",
                       episode_layers(V1N_CONFIG, SEQ_NOISY_STEPS)),
        expect=lambda s: {"apply_tape_fwd": s["nfev"]})
    if summary["nfev"] == 0:
        raise AssertionError("cobyla noisy 8q: no cost evaluation ran")
    print(f"[cobyla noisy 8q] nfev {summary['nfev']} = B3f launches "
          f"{launches['apply_tape_fwd']}", flush=True)
    noisy_cost_phase(V1N_CONFIG, "cobyla noisy cost 8q")
    return launches["apply_tape_fwd"]


def sequential_v1_phases(v1, keep=None):
    """The sequential trainer with Adam at 8q (every env step, train and
    greedy test, one v1 launch at E = 1, traced; its results copied into
    ``keep``, see ``sequential_phase``), and v1 at E = 1 against its plain
    version at 3 iterations with the controls, and timed (the plain
    version untimed).  -> (v1's launches in the run, its E = 1 timing)."""
    _, launches, _ = sequential_phase(
        V1_CONFIG, "sequential v1", SEQ_ARGS, profile=True,
        expect=lambda s: {v1.name: s["steps"] + s["test_steps"]},
        keep=keep)
    case = Case(v1, V1_CONFIG, 1)
    check_kernel(v1, case, "kernel v1 E=1", 3, TOL_ITERS3, case.controls())
    timing = time_kernel(v1, case, "kernel v1 E=1", time_plain=False)
    return launches[v1.name], timing


def sequential_v2_phases(v2):
    """v2 at E = 1 (12q LiH) against its plain version at 3 iterations with
    the controls, and timed; the sequential trainer on LIH12q_TNbond2 for
    ``SEQ_V2_STEPS`` Adam steps (one v2 launch each) and
    ``SEQ_V2_COBYLA_STEPS`` COBYLA steps (no kernel); csim's ms per
    evaluation at 12q beside B3f's device ms per noisy evaluation on the
    same tape.  -> (v2's launches in the run, its E = 1 timing, the
    12q cost timings)."""
    case = Case(v2, V2_CONFIG, 1)
    check_kernel(v2, case, "kernel v2 E=1", 3, TOL_ITERS3, case.controls())
    timing = time_kernel(v2, case, "kernel v2 E=1", time_plain=False)
    _, launches, _ = sequential_phase(
        V2_CONFIG, "sequential v2 12q",
        ("--episodes", "1", "--num_layers",
         episode_layers(V2_CONFIG, SEQ_V2_STEPS)),
        expect=lambda s: {v2.name: s["steps"]})
    sequential_phase(
        V2_CONFIG, "sequential cobyla 12q",
        COBYLA_ARGS + ("--episodes", "1", "--num_layers",
                       episode_layers(V2_CONFIG, SEQ_V2_COBYLA_STEPS)),
        expect=lambda s: {})
    cost = noisy_cost_phase(V2_CONFIG, "cobyla noisy cost 12q")
    print(f"[cobyla 12q] csim {cost['csim_us'] / 1e3:.3f} ms per "
          "evaluation on the host; B3f "
          f"{_ms_or_not(cost['b3f_device_ms'])} of device time per "
          f"noisy evaluation ({cost['eval_wall_ms']:.4f} ms of wall) on "
          "the same tape", flush=True)
    return launches[v2.name], timing, cost


def sweep_in_state_trainers(v2, v2p, v2s):
    """(``--sweep`` only) the 20q trainer in the in_state families, where
    the warm start rides every tape (G = 388, R = 331): TensorRL-trainable
    and StructureRL through the sweep kernel with a shared psi0, and
    block-coordinate mode (K = 3) through its per-env psi0 variant; 2
    replicas, ``SWEEP_IN_STATE_STEPS`` vector steps each."""
    steps = SWEEP_IN_STATE_STEPS
    for family, extra, engine in ((TRAINABLE, (), v2),
                                  (STRUCTURE, (), v2),
                                  (TRAINABLE, BLOCK_COORD, v2p)):
        trainer_phase(v2s, V2S_CONFIG, 2, steps,
                      f"trainer v2 20q {family}{' '.join(extra)}", extra,
                      expect_replay=False, family=family,
                      expect={engine.name: steps, v2s.name: steps})


def sequential_v2_sweep_phase(v2, v2s):
    """The sequential trainer on heisenberg_20q_TNbond2 for
    ``SEQ_V2S_STEPS`` Adam steps (one sweep kernel launch at E = 1 each),
    traced: wall ms a step and the kernel's share.  -> the sweep kernel's
    launches in the run."""
    _, launches, _ = sequential_phase(
        V2S_CONFIG, "sequential v2 20q",
        ("--episodes", "1", "--num_layers",
         episode_layers(V2S_CONFIG, SEQ_V2S_STEPS)), profile=True,
        expect=lambda s: {v2.name: s["steps"], v2s.name: s["steps"]})
    return launches[v2s.name]


def warm_problem(config):
    """(ham_type, qubits, geometry, mapping) of TensorRL_fixed/``config``."""
    from tensorrl_qas_tpu_torch.train.config import get_config

    conf = get_config(FIXED, f"{config}.cfg")
    prob = conf["problem"]
    return (prob["ham_type"], conf["env"]["num_qubits"],
            prob.get("geometry", ""), prob.get("mapping", "jordan_wigner"))


def warm_start_phase(out_dir):
    """The data tool (``tools/generate_data.py``, in-process, ``--device
    cuda``) for each of WARM_STARTS into ``out_dir``: the pipeline's own
    1e-6 round trip, the CNOT count, and e_circuit within TOL_WARM of the
    shipped warm start's energy (the shipped qasm on the eager simulator
    on the card in complex128); the fit's wall and device time and the
    peak device memory of the run.  -> {config: (result, shipped energy,
    Pauli strings, weights)}."""
    import torch

    from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        resolve_warmstart_qasm,
    )
    from tensorrl_qas_tpu_torch.sim.expectation import PauliSum
    from tensorrl_qas_tpu_torch.tn.pipeline import (
        ROUND_TRIP_TOL,
        tape_energy,
    )
    from tensorrl_qas_tpu_torch.tools import generate_data

    out = {}
    for config, cnots in WARM_STARTS:
        label = f"warm start {config}"
        t0 = phase(label)
        ham, n, geom, mapping = warm_problem(config)
        flags = ["--ham", ham, "--qubits", str(n), "--geometry", geom,
                 "--mapping", mapping, *WARM_FLAGS, "--out", out_dir,
                 "--device", "cuda"]
        if ham != "heisenberg":
            flags += ["--from-npz", resolve_npz(ham, n, geom, mapping)]
        shipped = resolve_warmstart_qasm(ham, n, 2, geom, mapping)
        torch.cuda.reset_peak_memory_stats()
        res = generate_data.run(flags)["result"]
        peak = torch.cuda.max_memory_allocated()
        paulis, weights, _ = generate_data.problem_terms(
            generate_data.build_parser().parse_args(flags))
        ps = PauliSum.from_strings(paulis, weights, n)
        e_shipped = tape_energy(load_circuit_tape(shipped), ps, "cuda")
        gap = abs(res.e_circuit - e_shipped)
        t = res.timings
        checks = {
            "round trip": abs(res.e_circuit - res.e_fit) <= ROUND_TRIP_TOL,
            f"{cnots} CNOTs": res.cnot_count == cnots,
            "shipped energy": gap <= TOL_WARM,
        }
        done(label, t0, qubits=n, e_dmrg=f"{res.e_dmrg:.12f}",
             e_exact=res.e_exact, e_circuit=f"{res.e_circuit:.12f}",
             round_trip_Ha=f"{abs(res.e_circuit - res.e_fit):.3e}",
             e_shipped=f"{e_shipped:.12f}", gap_to_shipped_Ha=f"{gap:.3e}",
             tol=TOL_WARM, overlap=f"{res.overlap:.9f}",
             cnots=res.cnot_count, rotations=res.rotation_count,
             depth=res.depth, fit_wall_s=f"{t['fit_s']:.3f}",
             fit_device_ms=f"{t['fit_device_ms']:.1f}",
             fit_device_ms_per_iteration=(
                 f"{t['fit_device_ms'] / int(WARM_FLAGS[5]):.4f}"),
             stages_s={k: round(v, 3) for k, v in t.items()
                       if k.endswith("_s")},
             peak_device_GiB=round(peak / 2**30, 3), checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{label} checks failed: {checks}")
        out[config] = (res, e_shipped, paulis, weights)
    return out


def warm_start_control(warm):
    """The wrong-result control: the 8q H2O fit once more, the same DMRG
    state, start and settings, with its gradient conjugated (the JAX
    convention, which the port must not follow) by an identity autograd
    Function around the parameters; its fitted circuit's energy must miss
    the shipped warm start's by more than TOL_WARM."""
    import torch

    from tensorrl_qas_tpu_torch.sim.expectation import (
        PauliSum,
        pauli_expectation,
    )
    from tensorrl_qas_tpu_torch.tn import circuit_fit as cf
    from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg
    from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis
    from tensorrl_qas_tpu_torch.tn.stiefel import StiefelAdam

    class ConjugatedGradient(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g.conj()

    t0 = phase("warm start control")
    res, e_shipped, paulis, weights = warm[V1_CONFIG]
    n = len(paulis[0])
    ps = PauliSum.from_strings(paulis, weights, n)
    _, mps = gs_dmrg(mpo_from_paulis(paulis, weights), chi=2, max_sweeps=6,
                     seed=0)
    target = cf.target_state(mps, "cuda")
    pairs = cf.brickwork_pairs(n, 2)
    params0 = torch.as_tensor(cf.initial_params(len(pairs), seed=0),
                              dtype=cf.DTYPE, device="cuda")
    loss = cf.overlap_loss(target, pairs, n)
    opt = StiefelAdam(lr=1e-2, maxiter=int(WARM_FLAGS[5]))
    params = opt.minimize(lambda p: loss(ConjugatedGradient.apply(p)),
                          params0)
    with torch.no_grad():
        e_ctrl = float(pauli_expectation(
            cf.circuit_state(params, pairs, n),
            *ps.tensors("cuda", cf.DTYPE)))
        overlap = 1.0 - float(loss(params))
    gap = abs(e_ctrl - e_shipped)
    done("warm start control", t0, e_fit_conjugated=f"{e_ctrl:.9f}",
         overlap=f"{overlap:.6f}", gap_to_shipped_Ha=f"{gap:.3e}",
         tol=TOL_WARM, fails_the_check=gap > TOL_WARM,
         e_circuit_unconjugated=f"{res.e_circuit:.9f}")
    if not gap > TOL_WARM:
        raise AssertionError("the conjugated-gradient fit passed the "
                             "shipped-energy check")


def warm_start_bricks():
    """(``--warm-start``) the 20q fit's device ms an iteration with its
    bricks applied one at a time and in runs of BRICKS_PER_PRODUCT on
    disjoint pairs (``tn/circuit_fit.py:_chain``): CUDA events around
    fits of 100 and 400 iterations from the same start, their difference
    over 300 (warm-up and capture cancel)."""
    import torch

    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        heisenberg_hamiltonian,
    )
    from tensorrl_qas_tpu_torch.tn import circuit_fit as cf
    from tensorrl_qas_tpu_torch.tn.dmrg import gs_dmrg
    from tensorrl_qas_tpu_torch.tn.mpo import mpo_from_paulis

    t0 = phase("warm start bricks")
    _, mps = gs_dmrg(mpo_from_paulis(*heisenberg_hamiltonian(20)), chi=2,
                     seed=0)
    runs, out = cf.BRICKS_PER_PRODUCT, {}
    try:
        for k in (1, runs):
            cf.BRICKS_PER_PRODUCT = k
            span = {}
            for iters in (100, 400):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                cf.fit_mps_to_circuit(mps, 2, maxiter=iters, device="cuda")
                ev[1].record()
                torch.cuda.synchronize()
                span[iters] = ev[0].elapsed_time(ev[1])
            out[f"{k} a product"] = f"{(span[400] - span[100]) / 300:.4f}"
    finally:
        cf.BRICKS_PER_PRODUCT = runs
    done("warm start bricks", t0, qubits=20,
         fit_device_ms_per_iteration=out)


def resolve_npz(ham, n, geom, mapping):
    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        problem_npz_name,
        resolve_data_file,
    )

    return resolve_data_file(problem_npz_name(ham, n, geom, mapping))


def warm_tempdir():
    """A temporary data directory for the warm starts, outside the
    checkout, removed when the script ends."""
    path = tempfile.mkdtemp(prefix="trlqas_warm_")
    _TEMP_DIRS.append(path)
    return path


@contextlib.contextmanager
def warm_data(out_dir, config):
    """``out_dir`` first on the port's data search path for the block
    (``DATA_SEARCH_PATHS`` is read from $TRLQAS_DATA_DIR at import, so the
    variable set now would not be seen), restored after; the config's
    warm start (and, where the tool wrote one, its npz) must resolve
    there."""
    from tensorrl_qas_tpu_torch.problems import hamiltonians as h

    ham, n, geom, mapping = warm_problem(config)
    h.DATA_SEARCH_PATHS.insert(0, out_dir)
    try:
        qasm = h.resolve_warmstart_qasm(ham, n, 2, geom, mapping)
        npz = resolve_npz(ham, n, geom, mapping)
        if not qasm.startswith(out_dir) or (
                ham == "heisenberg" and not npz.startswith(out_dir)):
            raise AssertionError(f"{config}: the trainer would read "
                                 f"{qasm} and {npz}, not {out_dir}")
        print(f"[{config}] trains from {qasm} and {npz}", flush=True)
        yield
    finally:
        h.DATA_SEARCH_PATHS.pop(0)



class Builds:
    """One nvcc per kernel source (and one g++ per ``host`` source: csim),
    all started together when made;
    ``wait(*names)`` blocks until those sources are built (a failed build
    raises there) and prints their ptxas lines, so that a long build runs
    while the phases that do not need it do."""

    def __init__(self, names, host=()):
        from tensorrl_qas_tpu_torch.ops.build import build, build_host

        self.t0 = time.perf_counter()
        self.pool = concurrent.futures.ThreadPoolExecutor(len(names)
                                                          + len(host))
        self.futures = {name: self.pool.submit(build, name)
                        for name in names}
        self.futures.update({name: self.pool.submit(build_host, name)
                             for name in host})

    def ready(self, name):
        """Whether the build of ``name`` has ended (not yet waited for)."""
        return self.futures[name].done()

    def wait(self, *names):
        t0 = phase("build " + " ".join(names))
        infos = {name: self.futures.pop(name).result() for name in names}
        for name, info in infos.items():
            for ln in info["log"].splitlines():
                if any(k in ln for k in ("registers", "spill", "smem",
                                         "Function properties")):
                    print(f"  ptxas {name}: {ln.strip()}", flush=True)
        if not self.futures:
            self.pool.shutdown()
        done("build " + " ".join(names), t0,
             nvcc_s={k: round(v["seconds"], 2) for k, v in infos.items()},
             since_start_s=round(time.perf_counter() - self.t0, 2))


# synthetic tapes for the split by gate class at 12q (lane bits hold
# qubits 0..4, the registers start with the first four other targets):
# label -> the (kind, target, control) cycle every env's tape repeats
CLASS_PATTERNS = {
    "RY one register qubit": [("RY", 5, -1)],
    "RY registers": [("RY", q, -1) for q in (5, 6, 7, 8)],
    "RZ registers": [("RZ", q, -1) for q in (5, 6, 7, 8)],
    "RX registers": [("RX", q, -1) for q in (5, 6, 7, 8)],
    "CX registers": [("CX", q, 0) for q in (5, 6, 7, 8)],
    "RY lanes": [("RY", q, -1) for q in range(5)],
    "RY warp qubits": [("RY", q, -1) for q in range(5, 12)],
}


def class_split(engine):
    """v2 at the 12q LiH shapes on tapes of G - 3 gates of one class
    (``CLASS_PATTERNS``), every env the same tape, at 100 iterations and
    at 0 (two forward passes and no adjoint): what a gate costs by the bit
    its target sits on and by its form, and how many swaps the schedule
    (``swap_schedule``, the kernel's twin) puts in."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind
    from tensorrl_qas_tpu_torch.ops.fused_adam2d import SWAP, swap_schedule

    t0 = phase("split by gate class")
    full = Case(engine, V2_CONFIG, V2_ENVS)
    live = full.g - 3
    ms, ms0, swaps = {}, {}, {}
    for label, pattern in {"none": [], **CLASS_PATTERNS}.items():
        arrs = np.zeros((4, full.g), np.int32)
        arrs[2:] = -1
        for g in range(live if pattern else 0):
            k, t, c = pattern[g % len(pattern)]
            arrs[:, g] = (int(GateKind[k]), t, c, g if k != "CX" else -1)
        tape = tuple(torch.as_tensor(np.repeat(a[None], V2_ENVS, 0),
                                     device="cuda") for a in arrs)
        args = (tape, tape, *full.args[2:])
        ms[label] = "{:.4f}".format(time_cuda(
            lambda: engine.step(*args, iters=ITERS, lr=LR), warmup=2,
            reps=10))
        # no Adam iteration: the final check and e_new, two forward
        # passes and two H psi
        ms0[label] = "{:.4f}".format(time_cuda(
            lambda: engine.step(*args, iters=0, lr=LR), warmup=2, reps=10))
        swaps[label] = sum(g == SWAP for g, _, _ in
                           swap_schedule(*arrs[:3], full.n)[1])
    done("split by gate class", t0, gates=live, kernel_ms=ms,
         kernel_ms_iters0=ms0, swaps_per_pass=swaps)


# synthetic su4 tapes for the tape kernels' split at 8 qubits (lane bits
# hold qubits 0..4, register bits qubits 5..7): label -> the (kind,
# target, second qubit or control) cycle every env's tape repeats
TAPE_PATTERNS = {
    "none": [],
    "RY registers": [("RY", q, -1) for q in (5, 6, 7)],
    "RY lanes": [("RY", q, -1) for q in range(5)],
    "CX lane control": [("CX", 5 + q % 3, q) for q in range(5)],
    "RXX registers": [("RXX", 5, 6), ("RXX", 6, 7), ("RXX", 5, 7)],
    "RXX lanes": [("RXX", q, (q + 1) % 5) for q in range(5)],
    "RXX lane-register": [("RXX", q, 5 + q % 3) for q in range(5)],
    "RZZ": [("RZZ", q, (q + 3) % 8) for q in range(8)],
}


def split_tape():
    """Where a register tape kernel's launch goes, at the su4 8-qubit
    shapes (E = 128, S = 8, G = R = 30): tapes of one gate class each
    (``TAPE_PATTERNS``; "none": every gate kNone, the fixed part of a
    launch) beside the random su4 tapes of 19., each kernel's
    back-to-back ms and profiler device ms."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.tape import GateKind
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    t0 = phase("split tape")
    n_env = V1_ENVS
    planes, random_tape, angles, cot = draw_tape_batch(
        np.random.default_rng(1234), n_env, STARTS, TAPE_CAP, 8)
    tapes = {"random su4": random_tape}
    for label, pattern in TAPE_PATTERNS.items():
        arrs = np.zeros((4, TAPE_CAP), np.int32)
        arrs[2:] = -1
        for g in range(TAPE_CAP if pattern else 0):
            k, t, c = pattern[g % len(pattern)]
            arrs[:, g] = (int(GateKind[k]), t, c, g if k != "CX" else -1)
        tapes[label] = tuple(torch.as_tensor(np.repeat(a[None], n_env, 0),
                                             device="cuda") for a in arrs)
    lib = at._library()
    stream = at._stream(angles.device)

    def times(tape):
        out = at.run_fwd(lib, *planes, tape, angles, stream=stream)
        runs = {"fwd": lambda: at.run_fwd(lib, *planes, tape, angles,
                                          stream=stream),
                "bwd": lambda: at.run_bwd(lib, *out, *cot, tape, angles,
                                          stream=stream)}
        return {key: f"{time_back_to_back(fn):.4f} / "
                     f"{_ms_or_not(device_ms(fn, f'apply_tape_{key}'))}"
                for key, fn in runs.items()}
    ms = {label: times(tape) for label, tape in tapes.items()}
    done("split tape", t0, gates=TAPE_CAP, E=n_env, S=STARTS,
         back_to_back_ms_and_device_ms=ms)


def parting_phase(v1p, v2p):
    """(``--split`` only) Where the per-env psi0 kernels' 100-iteration
    results part from the plain version's float32 run: v1p at the 8q
    trainable shapes (E = 128, G = 172, R = 151) and v2p at the 12q ones
    (E = 16, G = 244, R = 211), random psi0 rows.  For every env whose
    kernel e_new differs from the float32 run's by more than
    TOL_ITERS100, the three e_new (kernel, plain float32, plain float64)
    and whether the kernel lands above both plain runs; a kernel above in
    most parted envs would be a fault.  -> {engine name: (parted envs,
    envs where the kernel is above both)}."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    out = {}
    for engine, config, n_env in ((v1p, V1_CONFIG, V1_ENVS),
                                  (v2p, V2_CONFIG, V2_ENVS)):
        t0 = phase(f"parting {engine.name}")
        case = Case(engine, config, n_env, TRAINABLE)
        _, ek = engine.step(*case.args, iters=ITERS, lr=LR)
        e32 = engine.plain(*case.args, iters=ITERS, lr=LR)[1]
        e64 = engine.plain(*fused_adam._to64(case.args), iters=ITERS,
                           lr=LR)[1]
        torch.cuda.synchronize()
        ek, e32, e64 = (t.double().cpu() for t in (ek, e32, e64))
        parted = ((ek - e32).abs() > TOL_ITERS100).nonzero().flatten()
        rows = {int(e): {"kernel": f"{float(ek[e]):.7f}",
                         "plain_f32": f"{float(e32[e]):.7f}",
                         "plain_f64": f"{float(e64[e]):.7f}"}
                for e in parted}
        above = int(((ek > e32) & (ek > e64))[parted].sum())
        out[engine.name] = (len(parted), above)
        done(f"parting {engine.name}", t0, G=case.g, R=case.r, n_env=n_env,
             envs_parted=len(parted), kernel_above_both=above,
             f32_vs_f64_max=f"{float((e32 - e64).abs().max()):.3e}",
             kernel_vs_f64_max=f"{float((ek - e64).abs().max()):.3e}",
             parted_e_new_Ha=rows)
    return out


def split_only(v1, v2, v2n):
    """``--split``: the v1 and v2 split phases, the 13-18q band, the
    split by gate class
    (where the checkout's v2 has the register kernel, i.e. a
    ``swap_schedule``), v2 at the trainable capacities and v2n at 12q LiH
    timed the same way, then the 8q fixed and trainable trainers traced
    (the v1 kernel's share of a vector step), so that two checkouts run in
    one call compare on one card."""
    from tensorrl_qas_tpu_torch.ops import fused_adam2d

    split_v1(v1)
    split_v2(v2)
    split_band(v2)
    if hasattr(fused_adam2d, "swap_schedule"):
        class_split(v2)
    else:
        print("[split by gate class] skipped: no register kernel in this "
              "checkout", flush=True)
    t0 = phase("split compare")
    ms = {}
    for label, engine, family in (("v2 trainable", v2, TRAINABLE),
                                  ("v2n", v2n, FIXED)):
        case = Case(engine, V2_CONFIG, V2_ENVS, family)
        ms[f"{label} G={case.g} R={case.r}"] = "{:.4f}".format(time_cuda(
            lambda: engine.step(*case.args, iters=ITERS, lr=LR,
                                **case.noise_kw), warmup=2, reps=10))
    done("split compare", t0, kernel_ms=ms)
    trainer_phase(v1, V1_CONFIG, V1_ENVS, V1_STEPS, "trainer v1",
                  profile=True)
    trainer_phase(v1, V1_CONFIG, V1_ENVS, T_STEPS, "trainer v1 trainable",
                  family=TRAINABLE, profile=True)


def su4_capacity(config):
    """(G, R) the su4 env gives ``config`` (fixed placement)."""
    from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv, EnvConfig
    from tensorrl_qas_tpu_torch.train.config import get_config

    conf = get_config(FIXED, f"{config}.cfg")
    conf["env"]["gate_set"] = "su4"
    env = CircuitEnv(EnvConfig.from_conf(conf, tn_placement="fixed",
                                         noise_mode="none", device="cuda"))
    return env.tape_capacity, env.rot_capacity


def kernel_family(name):
    """A device kernel's name without its template arguments and
    parameters (``void at::native::reduce_kernel<...>(...)`` ->
    ``at::native::reduce_kernel``), so that its instances sum together."""
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    return base.split("<")[0].split("(")[0].strip()


def trainer_split(prof, vector_steps, wall_ms):
    """A traced composed trainer's device time a vector step by kernel:
    B3f, B3b, the schedule, and the rest (the composed step's energy and
    Adam ops, the env's and the agent's) by kernel family, largest
    first."""
    per = {}
    for k, v in device_us_by_name(prof).items():
        key = kernel_family(k)
        per[key] = per.get(key, 0.0) + v / 1e3 / vector_steps
    groups = {key: sum(v for k, v in per.items()
                       if any(f"apply_tape_{band}{key}" in k
                              for band in ("", "sweep_", "f64_")))
              for key in ("fwd", "bwd", "schedule")}
    rest = sorted(((v, k) for k, v in per.items() if "apply_tape" not in k),
                  reverse=True)
    total = sum(per.values())
    return {"device_ms_per_vector_step": {
                "B3f": f"{groups['fwd']:.4f}", "B3b": f"{groups['bwd']:.4f}",
                "schedule": f"{groups['schedule']:.4f}",
                "other kernels": f"{sum(v for v, _ in rest):.4f}",
                "all": f"{total:.4f}"},
            "other kernels by family (ms a vector step, top 10)": {
                k: f"{v:.4f}" for v, k in rest[:10]},
            "other kernel families": len(rest),
            "device_busy_share": f"{total / wall_ms:.4f}"}


def composed_phases(builds, idle=None):
    """The composed engine: its step's inputs and plain references in
    three settings while nvcc builds (``builds``), then its tape kernels,
    its step's checks, and the su4 and shot-noise trainers at 8q and the
    su4 trainer at 12q, each vector step iters + 2 forward and iters
    adjoint launches (at 12q also two schedule launches).  ``idle(ready)``
    runs while the tape
    kernels build (``ready()``: whether they have).  -> the kernels line's
    tape entries: the 8q shapes (register kernels) and the 12q su4
    trainer's (wide kernels)."""
    setups = [composed_setup(mode) for mode in ("su4", "shot", "traj4")]
    g12, r12 = su4_capacity(SU4_12_CONFIG)
    if g12 != r12:
        raise AssertionError(f"12q su4 capacities {g12, r12}: the tape "
                             "phase takes G = R")
    if idle is not None:
        idle(lambda: builds.ready("apply_tape"))
    builds.wait("apply_tape")
    tape = {}
    for n, n_env in TAPE_SHAPES:
        entries = tape_phase(n, n_env, TAPE_CAP, f"kernel tape {n}q",
                             woven=n in TAPE_WOVEN)
        tape.setdefault("reg", entries)
    tape["wide"] = tape_phase(12, SU4_12_ENVS, g12,
                              f"kernel tape 12q G={g12}")
    for setup in setups:
        composed_phase(*setup)
    per_step = {"apply_tape_fwd": COMPOSED_STEPS * (ITERS + 2),
                "apply_tape_bwd": COMPOSED_STEPS * ITERS}
    launches = trainer_phase(COMPOSED, V1_CONFIG, V1_ENVS, COMPOSED_STEPS,
                             "trainer su4", SU4_ARGS, expect=per_step)
    for key in ("fwd", "bwd"):
        tape["reg"][key]["launches"] = launches[f"apply_tape_{key}"]
    trainer_phase(COMPOSED, RESTRICTED_CONFIG, V1_ENVS, RESTRICTED_STEPS,
                  "trainer restricted", expect_replay=False,
                  expect={"apply_tape_fwd": RESTRICTED_STEPS * (ITERS + 2),
                          "apply_tape_bwd": RESTRICTED_STEPS * ITERS})
    print(f"[trainer su4 12q] replay is not reached: {SU4_12_ENVS} replicas "
          f"x {max(0, SU4_12_STEPS - 4)} transitions < batch 1000 (the 8q "
          "trainers run it)", flush=True)
    launches = trainer_phase(
        COMPOSED, SU4_12_CONFIG, SU4_12_ENVS, SU4_12_STEPS,
        "trainer su4 12q", SU4_ARGS, expect_replay=False, profile=True,
        expect={"apply_tape_fwd": SU4_12_STEPS * (ITERS + 2),
                "apply_tape_bwd": SU4_12_STEPS * ITERS,
                "tape_schedule": 2 * SU4_12_STEPS})
    for key in ("fwd", "bwd"):
        tape["wide"][key]["launches"] = launches[f"apply_tape_{key}"]
    tape["wide"]["schedule"]["launches"] = launches["tape_schedule"]
    return tape


def composed_wide_setups():
    """The 20q composed step's inputs, optimizers and plain references in
    the three settings (``composed_setup``; no kernel needed, so they run
    while nvcc builds)."""
    cases = {}
    return [composed_setup(mode, wide=True, cases=cases)
            for mode in ("su4", "shot", "traj4")]


def composed_wide_phases(builds, full=False, setups=None):
    """The composed engine at 17-20 qubits (the sweep tape kernels): its
    20q step's inputs and plain references in the three settings (given,
    ``setups``, or made here), the tape kernels on a 17-qubit register and
    at the su4 20q config's capacities (plainly and woven), the 20q step's
    checks (against the plain versions with controls, the graph against
    the eager path bit for bit, shot noise at 0 shots against the
    noiseless step),
    with ``full`` the timed 100-iteration su4 step, then the 20q su4
    trainer at full width (every vector step iters + 2 sweep forward and
    iters sweep adjoint calls, two segment builds) and the noisy COBYLA
    cost at 20q.  -> the kernels line's sweep entries ("fwd", "bwd",
    "schedule"), launches from the trainer."""
    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    g20, r20 = su4_capacity(V2S_CONFIG)
    if g20 != r20:
        raise AssertionError(f"20q su4 capacities {g20, r20}: the tape "
                             "phase takes G = R")
    setups = setups or composed_wide_setups()
    builds.wait("apply_tape_sweep")
    tape_phase(WIDE_CHAIN, WIDE_CHECK_ENVS, CHAIN_CAP,
               f"kernel tape {WIDE_CHAIN}q", woven=True)
    entries = tape_phase(20, V2S_ENVS, g20, f"kernel tape 20q G={g20}",
                         woven=True, s_n=V2S_STARTS)
    for setup in setups:
        composed_phase(*setup)
    if full:
        composed_wide_timing(setups[0][2])
    print(f"[trainer su4 20q] replay is not reached: {V2S_ENVS} replicas x "
          f"{max(0, WIDE_STEPS - 4)} transitions < batch 1000", flush=True)
    calls = {"fwd": WIDE_STEPS * (ITERS + 2), "bwd": WIDE_STEPS * ITERS}
    launches = trainer_phase(
        COMPOSED, V2S_CONFIG, V2S_ENVS, WIDE_STEPS, "trainer su4 20q",
        SU4_ARGS, expect_replay=False, profile=True,
        expect={**{f"apply_tape_{k}": v for k, v in calls.items()},
                **{f"apply_tape_sweep_{k}": v for k, v in calls.items()},
                "tape_schedule": 2 * WIDE_STEPS})
    for key in ("fwd", "bwd"):
        entries[key]["launches"] = launches[f"apply_tape_sweep_{key}"]
    entries["schedule"]["launches"] = launches["tape_schedule"]
    before = at.apply_tape_fwd.sweep_launches
    noisy_cost_phase(V2S_CONFIG, "cobyla noisy cost 20q", csim=False)
    if at.apply_tape_fwd.sweep_launches - before < COST_DRAWS:
        raise AssertionError("the noisy cost at 20q missed the sweep B3f")
    return entries


def composed_wide_timing(opt):
    """``--composed-wide``: one 100-iteration su4 step at 20q at the
    trainer's shape (E = 8, S = 4; ``opt`` the su4 check's optimizer) as a
    graph -- its first call (warm-up and capture) apart, then replays --,
    eagerly once, the launches a step by the
    counters, a traced replay's device ms by kernel family, its peak
    device memory, and each tape kernel's bound in bytes (the planes in
    and out once, as the B3 rows of PERF.md count them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import ComposedGraph

    mode = "su4 20q"
    t0 = phase(f"composed {mode} timing")
    case = Case(COMPOSED, V2S_CONFIG, V2S_ENVS, gate_set="su4",
                n_starts=V2S_STARTS)
    args = (*case.args[:5], *case.args[-2:])
    graph = ComposedGraph(opt)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    graph(*args, iters=ITERS, lr=LR)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t1
    counters = [(at.apply_tape_fwd, "sweep_launches"),
                (at.apply_tape_bwd, "sweep_launches"),
                (at.tape_schedule, "launches")]
    before = [getattr(*k) for k in counters]
    graph_ms = time_cuda(lambda: graph(*args, iters=ITERS, lr=LR),
                         warmup=0, reps=2)
    per = [(getattr(*k) - b) // 2 for k, b in zip(counters, before)]
    eager_ms = time_cuda(lambda: opt._fused_step_composed(
        *args[:5], opt._h_apply(torch.float32), *args[5:], iters=ITERS,
        lr=LR), warmup=0, reps=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        graph(*args, iters=ITERS, lr=LR)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t1)
    split = trainer_split(prof, 1, wall)
    rows, d = case.n_env * case.s, 1 << case.n
    plane = rows * d * 4
    bounds = {"fwd": 4 * plane, "bwd": 6 * plane}
    ok = per == [ITERS + 2, ITERS, 2] and graph.captures == 1
    done(f"composed {mode} timing", t0, iters=ITERS, E=case.n_env,
         S=case.s, G=case.g, graph_step_ms=f"{graph_ms:.4f}",
         eager_step_ms=f"{eager_ms:.4f}",
         first_call_warmup_and_capture_s=f"{capture_s:.3f}",
         sweep_calls_per_step={"fwd": per[0], "bwd": per[1],
                               "schedule": per[2]},
         segment_launches_per_call=at._sweep_library().max_segments(
             case.g, case.n),
         profiled_step_wall_ms=f"{wall:.2f}", **split,
         peak_device_GiB=round(torch.cuda.max_memory_allocated() / 2**30,
                               3),
         bound_ms_per_call={k: f"{1e3 * v / HBM_BYTES_PER_S:.4f} (bytes)"
                            for k, v in bounds.items()}, ok=ok)
    if not ok:
        raise AssertionError(f"composed {mode} timing: the calls a step "
                             f"{per} or the captures are not as expected")


H_PSI_SHAPES = ((SU4_12_CONFIG, SU4_12_ENVS), ("heisenberg_16q_TNbond2", 4))


def h_psi_compare():
    """``--h-psi``: the composed su4 step (100 iterations, a CUDA graph) at
    the 12q su4 trainer's shape (E = 16, S = 8) and at 16q Heisenberg (E =
    4, S = 8) with each H psi of flip-group planes -- ``flip_h_batched``
    (one gather) and ``flip_h_blocked`` (a group at a time) -- in the order
    batched, blocked, blocked, batched: each step's median ms of 3
    replays and its peak device memory (``optim/angle_opt.py:flip_h_for``
    picks by size), and the largest difference of the two H psi's e_new
    after 3 iterations (float32 sums in another order; tests/
    test_torch_composed_wide.py holds the two to 1e-12 in float64)."""
    import torch

    from tensorrl_qas_tpu_torch.optim import angle_opt

    for config, n_env in H_PSI_SHAPES:
        t0 = phase(f"h psi {config}")
        case = Case(COMPOSED, config, n_env, gate_set="su4")
        opt = angle_opt.AngleOptimizer(case.prob.pauli, device="cuda",
                                       enable_2q=True)
        opt._w_planes = case.opt.w_planes()
        args = (*case.args[:5], *case.args[-2:])
        ms, peak, e_new = {}, {}, {}
        for name in ("batched", "blocked", "blocked", "batched"):
            h = getattr(angle_opt, f"flip_h_{name}")
            wre, wim, flips = opt.w_planes()
            opt._h_apply = (lambda dtype, h=h: h(wre.to(dtype),
                                                 wim.to(dtype), flips))
            e_new[name] = opt._fused_step_composed(
                *args[:5], opt._h_apply(torch.float32), *args[5:], iters=3,
                lr=LR)[1]
            graph = angle_opt.ComposedGraph(opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            graph(*args, iters=ITERS, lr=LR)
            ms.setdefault(name, []).append(time_cuda(
                lambda: graph(*args, iters=ITERS, lr=LR), warmup=0, reps=3))
            peak[name] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
            del graph
        diff = float((e_new["batched"] - e_new["blocked"]).abs().max())
        done(f"h psi {config}", t0, E=n_env, S=case.s, G=case.g,
             D=1 << case.n, flip_groups=opt.w_planes()[2].numel(),
             step_ms={k: [f"{v:.4f}" for v in vs] for k, vs in ms.items()},
             peak_device_GiB=peak, e_new_iters3_max_abs_diff=f"{diff:.3e}")
        del opt._h_apply


PARTING_ENVS, PARTING_DRAWS = 64, 16


def parting_env(v1):
    """``--parting-env``: the draw on which the v1 kernel at the trainable
    capacities (8q H2O, G = 172, R = 151, shared psi0, Case seed 1234)
    left the agreement band at E = 64 after 3 iterations.  For each env
    that fails it: the kernel's e_new alone at E = 1 (bit for bit with its
    row at E = 64 or not), the kernel's and the plain version's float32
    and float64 e_new after 1, 2 and 3 iterations, and after 3 with the H
    planes rounded otherwise (PARTING_DRAWS draws, as ``plain_results``
    perturbs them) through the kernel and the plain float32 version: the
    kernel's e_new lies among the plain version's draws when float32
    rounding decides where the env's trajectory goes."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    t0 = phase("parting env")
    case = Case(v1, V1_CONFIG, PARTING_ENVS, family=TRAINABLE)
    xk, ek = v1.step(*case.args, iters=3, lr=LR)
    ref, _ = plain_reference(v1, case, 3)
    ok, _, stats = fused_adam.agreement(case.args, ref, xk, ek,
                                        tol=TOL_ITERS3, step=v1.plain,
                                        iters=3)
    rows = {}
    for e in (~ok).nonzero().flatten().tolist():
        one = (tuple(a[e:e + 1] for a in case.args[0]),
               tuple(a[e:e + 1] for a in case.args[1]),
               case.args[2][e:e + 1], *case.args[3:-2],
               case.args[-2][e:e + 1], case.args[-1][e:e + 1])
        x1, e1 = v1.step(*one, iters=3, lr=LR)
        row = {"alone_bit_for_bit": bool(torch.equal(x1[0], xk[e])
                                         and torch.equal(e1[0], ek[e]))}
        for it in (1, 2, 3):
            row[f"iters={it}"] = [f"{float(r[1][0]):.8f}" for r in (
                v1.step(*one, iters=it, lr=LR),
                v1.plain(*one, iters=it, lr=LR),
                v1.plain(*fused_adam._to64(one), iters=it, lr=LR))]
        gen = torch.Generator(device="cuda").manual_seed(1)
        kd, pd = [], []
        for _ in range(PARTING_DRAWS):
            wob = list(one)
            for i in (5, 6):
                u = torch.rand(one[i].shape, generator=gen,
                               dtype=one[i].dtype, device="cuda") * 2 - 1
                wob[i] = one[i] * (1 + u * 2.0 ** -23)
            kd.append(float(v1.step(*wob, iters=3, lr=LR)[1][0]))
            pd.append(float(v1.plain(*wob, iters=3, lr=LR)[1][0]))
        near = min(abs(float(ek[e]) - p) for p in pd)
        row.update(kernel_draws=sorted(f"{v:.7f}" for v in kd),
                   plain_draws=sorted(f"{v:.7f}" for v in pd),
                   kernel_to_nearest_plain_draw=f"{near:.3e}",
                   kernel_among_plain_draws=near <= TOL_ITERS3)
        rows[e] = row
    done("parting env", t0, E=PARTING_ENVS, G=case.g, R=case.r, **stats,
         failing=rows)


def tape_compare():
    """``--tape``: B3f and B3b at 8 qubits (E = 128) and 10-16 (the tape
    phases' shapes) through the checkout's own wrappers (from 10 qubits
    under a schedule built once where the checkout has one), so that two
    checkouts compare on one card in one call: CUDA events over 20
    launches back to back and the profiler's device time; the adjoint
    without psi0 cotangents, as the composed step runs it."""
    import numpy as np

    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    t0 = phase("tape compare")
    ms = {}
    for n, n_env in ((8, 128), (10, 64), (12, 16), (13, 8), (14, 64),
                     (16, 4)):
        planes, tape, angles, cot = draw_tape_batch(
            np.random.default_rng(1234), n_env, STARTS, TAPE_CAP, n)
        kw = {}
        if hasattr(at, "tape_schedule"):
            kw["schedule"] = at.tape_schedule(*tape, n, TAPE_CAP)
        out = at.apply_tape_fwd(*planes, *tape, angles, **kw)

        def fwd():
            return at.apply_tape_fwd(*planes, *tape, angles,
                                     tapes_checked=True, **kw)

        def bwd():
            return at.apply_tape_bwd(*out, *cot, *tape, angles,
                                     tapes_checked=True, psi0_grad=False,
                                     **kw)
        ms[f"{n}q E={n_env}"] = {
            key: f"{time_back_to_back(fn):.4f} / "
                 f"{_ms_or_not(device_ms(fn, f'apply_tape_{key}'))}"
            for key, fn in (("fwd", fwd), ("bwd", bwd))}
    done("tape compare", t0, S=STARTS, G=TAPE_CAP, R=TAPE_CAP,
         back_to_back_ms_and_device_ms=ms)


def plain_modes(v1, v2):
    """``--plain-modes``: the plain version's 100-iteration time at v1's
    and v2's main shapes (the timing phases' inputs) with autograd's
    bookkeeping (grad mode, as before ``without_autograd``) and without
    it, in the order grad, inference, inference, grad."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    t0 = phase("plain modes")
    ms = {}
    for engine, config, n_env in ((v1, V1_CONFIG, V1_ENVS),
                                  (v2, V2_CONFIG, V2_ENVS)):
        case = Case(engine, config, n_env)
        for mode in ("grad", "inference", "inference", "grad"):
            ctx = (torch.enable_grad if mode == "grad"
                   else torch.inference_mode)

            def run():
                with ctx():
                    fused_adam.fused_adam_step_reference(
                        *case.args, iters=ITERS, lr=LR)
            ms.setdefault(f"{engine.name} {mode}", []).append(
                f"{time_cuda(run, warmup=0, reps=1):.1f}")
    done("plain modes", t0, plain_ms=ms)


def _host_peak_bytes(fn):
    """The resident set's peak while ``fn()`` runs over the one before it
    (``/proc/self/statm`` read every 5 ms on another thread; torch's CPU
    operations release the GIL)."""
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    base = rss()
    peak = [base]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], rss())
            stop.wait(0.005)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        fn()
    finally:
        stop.set()
        sampler.join()
    return max(peak[0], rss()) - base


def plain_memory(v2s):
    """``--plain-modes``: the plain version's peak memory at 20 qubits over
    what its inputs hold, one Adam iteration, at the fixed family's
    capacities and the in_state families' (the warm start on every tape):
    on the card (``torch.cuda.max_memory_allocated``) at the trainer's
    shape (E = 8, S = 4) in float32 and float64 (the check's two
    dtypes), and on the host at E = 1, S = 2 in float32."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam

    def step(args):
        with torch.inference_mode():
            fused_adam.fused_adam_step_reference(*args, iters=1, lr=LR)

    def on_cpu(a):
        return (tuple(on_cpu(t) for t in a) if isinstance(a, tuple)
                else a.cpu())

    t0 = phase("plain memory")
    gib = {}
    for family in (FIXED, TRAINABLE):
        case = Case(v2s, V2S_CONFIG, V2S_ENVS, family, n_starts=V2S_STARTS)
        shape = f"{family}G={case.g} R={case.r}"
        for dtype in ("float32", "float64"):
            args = (case.args if dtype == "float32"
                    else fused_adam._to64(case.args))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                step(args)
                torch.cuda.synchronize()
                peak = "{:.3f}".format(
                    (torch.cuda.max_memory_allocated() - base) / 2**30)
            except torch.cuda.OutOfMemoryError as exc:
                peak = f"out of memory ({str(exc).splitlines()[0]})"
            del args
            torch.cuda.empty_cache()
            gib[f"card {shape} E={V2S_ENVS} S={V2S_STARTS} {dtype}"] = peak
        host = on_cpu(Case(v2s, V2S_CONFIG, 1, family, n_starts=2).args)
        gib[f"host {shape} E=1 S=2 float32"] = "{:.3f}".format(
            _host_peak_bytes(lambda: step(host)) / 2**30)
        del case, host
    done("plain memory", t0, peak_GiB_over_inputs=gib)


# 26. the sharded path (parallel/, optim/sharded_opt.py) on the card, every
# shard on cuda:0 (a mesh's devices may repeat one): the largest shipped
# config at full width on (2 amp x 4 dp); the adjoint check on (4 amp x 2
# dp), whose two device bits give the wrong-bit control another bit
MESH_CONFIG, MESH_SHAPE, MESH_VAG_SHAPE = V2S_CONFIG, (2, 4), (4, 2)
MESH_ROWS = 2            # (b) / (e): angle vectors, one a dp column
MESH_STARTS = 4          # (c): the 20q config's n_starts, one a dp column
MESH_ITERS = 2           # (d): Adam iterations an env step
MESH_ENV_STEPS = 2       # (d): steps of each env
MESH_BIG = 22            # (e): past the fused kernels' 20 qubits
TOL_MESH = 1e-10         # complex128 sharded vs one device


MESH_CARDS = [1]          # --cards: the host's cards the shards cycle over


def mesh_devices(mesh_shape):
    """The shards' devices: cuda:0 for every shard, or with ``--cards``
    the host's cards in turn (two shards a card on four cards)."""
    return tuple(f"cuda:{i % MESH_CARDS[0]}"
                 for i in range(mesh_shape[0] * mesh_shape[1]))


def mesh_label(mesh_shape):
    where = ("cuda:0" if MESH_CARDS[0] == 1
             else f"{MESH_CARDS[0]} cards in turn")
    return f"{mesh_shape[0]} amp x {mesh_shape[1]} dp on {where}"


def mesh_of(mesh_shape, cls=None):
    from tensorrl_qas_tpu_torch.parallel.mesh import Mesh, make_mesh

    mesh = make_mesh(*mesh_shape, devices=mesh_devices(mesh_shape))
    return mesh if cls is None else cls(mesh.devices)


def faulty_meshes():
    """Meshes whose collectives are wrong on purpose: an exchange across
    another device bit than the gate's, and a psum that leaves out amp
    shard 1.  The check must reject both."""
    import torch

    from tensorrl_qas_tpu_torch.parallel.mesh import Mesh

    class WrongBit(Mesh):
        def ppermute(self, blocks, axis, perm):
            perm = list(perm)
            m = perm[0][0] ^ perm[0][1]
            if axis == "amp" and m and not m & (m - 1):
                other = m << 1 if m << 1 < self.shape["amp"] else m >> 1
                perm = [(r, r ^ other) for r in range(self.shape["amp"])]
            return super().ppermute(blocks, axis, perm)

    class DropShard(Mesh):
        def psum(self, parts, axis):
            if axis == "amp":
                parts = [[torch.zeros_like(p) for p in line] if a == 1
                         else line for a, line in enumerate(parts)]
            return super().psum(parts, axis)

    return {"exchange across the wrong device bit": WrongBit,
            "psum without amp shard 1": DropShard}


def mesh_config():
    """The mesh config's problem, its fixed-placement env settings and
    its warm-start tape."""
    from tensorrl_qas_tpu_torch.circuits.qasm import load_circuit_tape
    from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
    from tensorrl_qas_tpu_torch.problems.hamiltonians import (
        load_problem,
        resolve_warmstart_qasm,
    )
    from tensorrl_qas_tpu_torch.train.config import get_config

    conf = get_config(FIXED, f"{MESH_CONFIG}.cfg")
    cfg = EnvConfig.from_conf(conf, tn_placement="fixed", device="cuda")
    n = cfg.num_qubits
    prob = load_problem(cfg.ham_type, n, cfg.geometry, cfg.mapping,
                        keep_dense=False)
    warm = load_circuit_tape(resolve_warmstart_qasm(
        cfg.ham_type, n, cfg.tn_bond, cfg.geometry, cfg.mapping))
    return conf, cfg, prob, warm


def mesh_tape(rng, n, cap):
    """A tape of ``cap`` gates: CNOTs, rotations and controlled rotations
    over every qubit, every fourth gate's target on one of the two top
    qubits (device bits on 2 and 4 amp shards)."""
    from tensorrl_qas_tpu_torch.circuits.tape import GateKind, GateTape

    tape = GateTape(n, cap, cap)
    for g in range(cap):
        t = int(n - 1 - rng.integers(2)) if g % 4 == 0 else int(
            rng.integers(n))
        c = int((t + 1 + rng.integers(n - 1)) % n)
        u = rng.random()
        if u < 0.35:
            tape.add_cx(c, t)
        else:
            kind = GateKind(int(rng.integers(1, 4)))
            tape.add(kind, t, c if u > 0.85 else -1, float(rng.normal()))
    return tape


def mesh_energy_phase(cfg, prob, warm):
    """(a) The shipped warm start through ShardedSimulator.expectation on
    (2 amp x 4 dp) against the eager simulator on one device, both
    complex128 on the card.  -> the warm-start state (one device)."""
    import torch

    from tensorrl_qas_tpu_torch.parallel.sharded_sim import ShardedSimulator
    from tensorrl_qas_tpu_torch.sim.apply import apply_tape, zero_state
    from tensorrl_qas_tpu_torch.sim.expectation import pauli_expectation

    n = cfg.num_qubits
    t0 = phase("mesh warm start energy")
    sim = ShardedSimulator(mesh_of(MESH_SHAPE), n, prob.pauli,
                           dtype=torch.complex128)
    e_mesh = float(sim.expectation(sim.apply_tape(
        sim.zero_state(), *warm.arrays(), warm.x0())))
    psi = apply_tape(zero_state(n, torch.complex128, "cuda"),
                     *warm.arrays(), warm.x0())
    e_one = float(pauli_expectation(psi, *prob.pauli.tensors(
        "cuda", torch.complex128)))
    err = abs(e_mesh - e_one)
    ok = err <= TOL_MESH
    done("mesh warm start energy", t0, config=MESH_CONFIG,
         mesh=mesh_label(MESH_SHAPE),
         e_mesh_Ha=f"{e_mesh:.12f}", e_one_device_Ha=f"{e_one:.12f}",
         abs_err=f"{err:.3e}", tol=TOL_MESH, ok=ok)
    if not ok:
        raise AssertionError(f"sharded warm-start energy off by {err:.3e}")
    return psi


def mesh_vag_phase(n, pauli, label, psi0, controls=True):
    """(b) / (e) value_and_grad_batched in complex128 on (4 amp x 2 dp)
    from ``psi0`` (a state on the card) at MESH_ROWS angle vectors
    against the single-device adjoint (``sim/adjoint.py``) a row, energy
    and gradient within TOL_MESH; with ``controls`` the faulty meshes
    must miss it.  Prints the peak device memory."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.parallel.sharded_sim import (
        ShardedSimulator,
        shard_state,
    )
    from tensorrl_qas_tpu_torch.sim.adjoint import adjoint_energy

    t0 = phase(label)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(1234)
    tape = mesh_tape(rng, n, 46)
    angles = rng.normal(size=(MESH_ROWS, tape.rot_capacity))
    psi0 = psi0.to(torch.complex128).expand(MESH_ROWS, -1)

    def vag(mesh):
        sim = ShardedSimulator(mesh, n, pauli, dtype=torch.complex128)
        ev, gr = sim.value_and_grad_batched(shard_state(psi0, mesh),
                                            *tape.arrays(), angles)
        return ev.double(), gr.double()

    t1 = time.perf_counter()
    ev, gr = vag(mesh_of(MESH_VAG_SHAPE))
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    sharded_gib = torch.cuda.max_memory_allocated() / 2**30
    pauli_t = pauli.tensors("cuda", torch.complex128)
    e_ref, g_ref = [], []
    for i in range(MESH_ROWS):
        x = torch.as_tensor(angles[i], device="cuda").requires_grad_(True)
        e = adjoint_energy(psi0[i], *tape.arrays(), x, *pauli_t)
        e.backward()
        e_ref.append(e.detach())
        g_ref.append(x.grad)
    e_ref, g_ref = torch.stack(e_ref), torch.stack(g_ref)

    def error(e, g):
        return max(float((e - e_ref).abs().max()),
                   float((g - g_ref).abs().max()))
    err = error(ev, gr)
    caught = {}
    if controls:
        for name, cls in faulty_meshes().items():
            caught[name] = f"{error(*vag(mesh_of(MESH_VAG_SHAPE, cls))):.3e}"
    ok = (err <= TOL_MESH and bool(torch.isfinite(gr).all())
          and all(float(v) > TOL_MESH for v in caught.values()))
    done(label, t0, n=n, mesh=mesh_label(MESH_VAG_SHAPE), rows=MESH_ROWS,
         G=tape.n_gates,
         e_ref_Ha=[f"{float(v):.10f}" for v in e_ref],
         max_abs_err=f"{err:.3e}", tol=TOL_MESH,
         controls_max_abs_err=caught, sharded_vag_s=f"{mesh_s:.2f}",
         sharded_peak_device_GiB=f"{sharded_gib:.3f}",
         peak_device_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         card=smi_line(), ok=ok)
    if not ok:
        raise AssertionError(f"{label}: sharded vag off by {err:.3e}, "
                             f"controls {caught}")


def mesh_sweep_phase(v2s):
    """(c) A sharded fused step (complex64, E = 1, S = 4, a start a dp
    column, restart_scale 0, 3 iterations) on (2 amp x 4 dp) against the
    sweep kernel at E = 1 on the same starts, by ``agreement`` with the
    kernel's result as the reference run."""
    import torch

    from tensorrl_qas_tpu_torch.ops import fused_adam
    from tensorrl_qas_tpu_torch.optim.angle_opt import make_multistarts
    from tensorrl_qas_tpu_torch.optim.sharded_opt import (
        ShardedAngleOptimizer,
    )

    t0 = phase("mesh step vs sweep kernel")
    case = Case(v2s, V2S_CONFIG, 1, n_starts=MESH_STARTS)
    active = case.args[9][:, 0, :]
    x0 = case.args[8][:, 0, :]                  # start 0 is the warm start
    starts = make_multistarts(
        x0, active, MESH_STARTS, MESH_STARTS // 4, 0.0,
        torch.Generator(device=x0.device).manual_seed(7)).contiguous()
    args = (*case.args[:8], starts, case.args[9])
    before = (v2s.step.launches, v2s.step.sweep_launches)
    xk, ek = v2s.step(*args, iters=3, lr=LR, **case.kernel_kw)
    swept = (v2s.step.launches - before[0],
             v2s.step.sweep_launches - before[1])
    opt = ShardedAngleOptimizer(mesh_of(MESH_SHAPE), case.n,
                                case.prob.pauli, iters=3,
                                n_starts=MESH_STARTS, lr=LR,
                                restart_scale=0.0)
    psi0 = torch.as_tensor(case.psi0[0], dtype=torch.complex64,
                           device="cuda")
    old = tuple(a[0] for a in case.old)
    new = tuple(a[0] for a in case.new)
    x_s, e_s, nfev = opt.fused_step(psi0, old, x0[0].cpu().numpy(),
                                    int(active[0].sum()), new,
                                    case.maps[0])
    x_s = torch.as_tensor(x_s, device="cuda")[None]
    e_s = torch.as_tensor([e_s - case.opt.offset], dtype=torch.float32,
                          device="cuda")
    env_ok, strict, stats = fused_adam.agreement(
        args, [(xk, ek)], x_s, e_s, tol=TOL_ITERS3, step=v2s.plain,
        iters=3)
    ok = bool(env_ok.all()) and swept == (1, 1) and nfev == 3 * MESH_STARTS
    done("mesh step vs sweep kernel", t0, config=V2S_CONFIG,
         mesh=mesh_label(MESH_SHAPE),
         G=case.g, R=case.r, S=MESH_STARTS, iters=3,
         e_new_sharded_Ha=f"{float(e_s[0]):.7f}",
         e_new_sweep_kernel_Ha=f"{float(ek[0]):.7f}", tol=TOL_ITERS3,
         strict=bool(strict.all()), **stats, sweep_launches=swept[1], ok=ok)
    if not ok:
        raise AssertionError(f"sharded step disagrees with the sweep "
                             f"kernel: {stats}, launches {swept}")


def mesh_env_phase(conf, cfg, prob):
    """(d) CircuitEnv and a 2-replica VectorCircuitEnv on the mesh config
    (TensorRL-fixed) with mesh_shape (2, 4), a (1, 1) env too, driven by
    the DQN agent at MESH_ITERS Adam iterations: finite energies within
    the config's spectrum, and no fused kernel launched."""
    import dataclasses

    import numpy as np

    from tensorrl_qas_tpu_torch.agents.dqn import make_agent
    from tensorrl_qas_tpu_torch.envs.circuit_env import CircuitEnv
    from tensorrl_qas_tpu_torch.envs.vector_env import VectorCircuitEnv
    from tensorrl_qas_tpu_torch.optim.sharded_opt import (
        ShardedAngleOptimizer,
    )
    from tensorrl_qas_tpu_torch.train.vector_driver import modify_states

    t0 = phase("mesh envs")
    # the agent cut as the dry run cuts it: its 5 x 1000 network on the
    # 34,840-wide 20q state takes ~3.5 s to build on the host (the 20q
    # trainer phases build it), and the replay buffer to 64 rows (the
    # config's takes 5.6 GB)
    conf["agent"]["neurons"] = [64, 64]
    conf["agent"]["memory_size"] = 64
    variants = engines()
    for e in variants:
        e.reset()
    base = dataclasses.replace(cfg, global_iters=MESH_ITERS)
    energies = {}
    agent = None
    for label, shape in ((f"env {MESH_SHAPE}", MESH_SHAPE),
                         ("env (1, 1)", (1, 1))):
        env = CircuitEnv(dataclasses.replace(
            base, mesh_shape=shape, mesh_devices=mesh_devices(shape)))
        if not isinstance(env.optimizer, ShardedAngleOptimizer):
            raise AssertionError(f"{label}: not on the sharded path")
        agent = agent or make_agent(conf, env.action_size, env.state_size,
                                    seed=0, device="cuda")
        state = env.reset()
        es = [env.prev_energy]
        for _ in range(MESH_ENV_STEPS if shape != (1, 1) else 1):
            a, _ = agent.act(state, env.illegal_action_new())
            state, _, _ = env.step(agent.translate[a])
            es.append(env.energy)
        energies[label] = es
    venv = VectorCircuitEnv(dataclasses.replace(
        base, mesh_shape=MESH_SHAPE, mesh_devices=mesh_devices(MESH_SHAPE)),
        n_envs=2)
    states = modify_states(venv.reset_all(), venv, conf)
    es = [[e.prev_energy for e in venv.envs]]
    for _ in range(MESH_ENV_STEPS):
        actions, _ = agent.act_batch(states, venv.illegal_actions())
        nxt, rewards, dones, infos = venv.step_all(
            [agent.translate[int(a)] for a in actions])
        nxt = modify_states(nxt, venv, conf)
        for i in range(venv.n_envs):
            agent.remember(states[i], int(actions[i]), float(rewards[i]),
                           nxt[i], float(dones[i]), env_id=i + 1)
        states = nxt
        es.append([i["energy"] for i in infos])
    energies["vector env 2 replicas"] = es
    flat = np.asarray([v for es in energies.values()
                       for v in np.ravel(es)])
    launches = {e.name: e.launches() for e in variants}
    checks = {"finite": bool(np.isfinite(flat).all()),
              "within the spectrum": bool(
                  (flat >= prob.min_eig - 1e-4).all()
                  and (flat <= prob.max_eig + 1e-4).all()),
              "no fused kernel": not any(launches.values())}
    done("mesh envs", t0, config=f"{FIXED}{MESH_CONFIG}",
         iters=MESH_ITERS, n_starts=venv.optimizer.n_starts,
         energies_Ha={k: np.round(np.asarray(v), 6).tolist()
                      for k, v in energies.items()},
         min_eig=f"{prob.min_eig:.6f}", checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"mesh envs: {checks}")


def mesh_timing(n, pauli, shape, label):
    """The sharded path's time at 4 starts (complex64, a 46-gate tape
    from |0>): an Adam iteration's sweep (``value_and_grad_batched``; the
    median of 5 by CUDA events), its launches and device ms (one traced
    sweep: the busy share is device ms / ms), and a whole 3-iteration
    fused step (the median of 3) with its launches; the peak device
    memory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorrl_qas_tpu_torch.optim.sharded_opt import (
        ShardedAngleOptimizer,
    )

    t0 = phase(label)
    torch.cuda.reset_peak_memory_stats()
    opt = ShardedAngleOptimizer(mesh_of(shape), n, pauli, iters=3,
                                n_starts=MESH_STARTS, lr=LR)
    tape = mesh_tape(np.random.default_rng(7), n, 46)
    ident = np.arange(tape.rot_capacity, dtype=np.int32)
    psi0_b = opt._psi0_batched(None)
    x = torch.as_tensor(np.tile(tape.x0(), (MESH_STARTS, 1)),
                        dtype=opt.rdtype, device="cuda")

    def sweep():
        return opt.sim.value_and_grad_batched(psi0_b, *tape.arrays(), x)

    def step():
        return opt.fused_step(None, tape.arrays(), tape.x0(), tape.n_rots,
                              tape.arrays(), ident)

    def traced(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA]
        return len(evs), sum(ev.duration_ns() for ev in evs) / 1e6

    iter_ms = time_cuda(sweep, warmup=2, reps=5)
    step_ms = time_cuda(step, warmup=1, reps=3)
    launches, dev_ms = traced(sweep)
    step_launches, step_dev_ms = traced(step)
    done(label, t0, n=n, mesh=mesh_label(shape),
         S=MESH_STARTS, G=tape.n_gates, dtype=str(opt.dtype),
         ms_per_iteration=f"{iter_ms:.2f}",
         launches_per_iteration=launches,
         device_ms_per_iteration=f"{dev_ms:.2f}",
         device_busy_share=f"{dev_ms / iter_ms:.3f}",
         step_ms_3_iterations=f"{step_ms:.2f}",
         launches_3_iteration_step=step_launches,
         device_ms_3_iteration_step=f"{step_dev_ms:.2f}",
         peak_device_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         card=smi_line())


def mesh_phase(v2s, full=False):
    """26. The sharded path on the card: (a)-(f), (e) 22 qubits past the
    fused kernels' cap; with ``full`` (``--mesh``) also the sharded
    step's timings at 20q and 22q."""
    import torch

    from tensorrl_qas_tpu_torch.parallel.dryrun import dryrun_multichip

    t_all = phase("mesh")
    conf, cfg, prob, warm = mesh_config()
    psi_warm = mesh_energy_phase(cfg, prob, warm)
    mesh_vag_phase(cfg.num_qubits, prob.pauli,
                   f"mesh vag {cfg.num_qubits}q", psi_warm)
    mesh_sweep_phase(v2s)
    mesh_env_phase(conf, cfg, prob)
    t0 = phase("mesh dryrun")
    out = dryrun_multichip(8, list(mesh_devices(MESH_SHAPE)))
    done("mesh dryrun", t0, mesh=out["mesh"], cards=MESH_CARDS[0])
    big = heisenberg_chain(MESH_BIG)
    zero = torch.zeros(1 << MESH_BIG, dtype=torch.complex128, device="cuda")
    zero[0] = 1.0
    mesh_vag_phase(MESH_BIG, big, f"mesh vag {MESH_BIG}q", zero,
                   controls=False)
    if full:
        mesh_timing(cfg.num_qubits, prob.pauli, MESH_SHAPE,
                    f"mesh step timing {cfg.num_qubits}q")
        mesh_timing(MESH_BIG, big, MESH_VAG_SHAPE,
                    f"mesh step timing {MESH_BIG}q")
    torch.cuda.empty_cache()
    done("mesh", t_all)


# -- complex128 on the card (--sim_dtype complex128) -------------------------

# the double-precision tape kernels (csrc/apply_tape_f64.cu) held to their
# float64 plain versions at (qubits, envs, starts, gates): the main path's
# 8q E = 128 at the su4 8q capacity, one chunk a row; 12q E = 16 at the 12q
# su4 trainer's capacity (0: read from the config), the largest row one
# launch holds; 17q E = 2, S = 8 on the chain's capacity and 20q at the su4
# 20q trainer's shapes (E = 8, S = 4, 0: its capacity), in segments
F64_TAPE_SHAPES = ((8, V1_ENVS, STARTS, TAPE_CAP), (12, 16, STARTS, 0),
                   (WIDE_CHAIN, 2, STARTS, CHAIN_CAP),
                   (20, V2S_ENVS, V2S_STARTS, 0))
TOL_FWD64 = 1e-12        # B3f planes in float64: double gate arithmetic
TOL_BWD64 = 1e-10        # B3b cotangents and gradients: double row sums
TOL_STEP64 = 1e-10       # the composed step's e_new (Ha) vs its plain run
# the 8q complex128 trainer's vector steps: the fewest with which its
# replay runs, as the v1 trainer's (V1_STEPS)
F64_STEPS = 12
F64_ARGS = ("--sim_dtype", "complex128")
F64_SOURCE = "tensorrl_qas_tpu_torch/csrc/apply_tape_f64.cu"
SEARCH_POP = 64          # the structure search's generation on the card
# the tools (29b.): the champion's complex128 polish, its one-start check
# against the host, polish_best on the 8q trainer's summary; the 20q demo
# cut to 3 / 2 env steps (the warm start's 22 layers count against
# --num_layers)
POLISH_ITERS, POLISH_CHECK_ITERS, POLISH_BEST_ITERS = 300, 50, 100
POLISH_FULL = (3000, 8, 3)   # --tools: the scripts' iters, starts, seeds
DEMO_NONE_LAYERS, DEMO_MESH_LAYERS = 25, 24
TOL_POLISH = 1e-9        # complex128 polished errors (Ha)
TOL_DEMO_WARM = 1e-5     # complex64 warm-start energies, mesh against none


def f64_tape_phase(n, n_env, s_n, cap, label):
    """The double-precision B3f and B3b against their float64 plain
    versions on one random batch (``draw_tape_batch`` in float64) within
    1e-12 / 1e-10, RYY's sign flipped and RZZ's gradient dropped exceeding
    them, a repeat bit for bit, above 12 qubits the segment kernel held to
    ``sweep_segments`` word for word; then both kernels' times (CUDA
    events, calls back to back; the profiler's device time), the plain
    versions' (their checked runs), the CTAs an SM holds and the bounds
    (the planes in and out once: twice the float kernels' bytes).  ->
    {"fwd": entry, "bwd": entry} of the kernels line (without
    launches)."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.ops import apply_tape as at

    t0 = phase(label)
    lib = at._sweep_library(torch.float64)
    planes, tape, angles, cot = draw_tape_batch(
        np.random.default_rng(1234), n_env, s_n, cap, n)
    planes, cot = (tuple(t.double() for t in p) for p in (planes, cot))
    angles = angles.double()
    sched = at.tape_schedule(*tape, n, cap, torch.float64)
    counters = (at.apply_tape_fwd, at.apply_tape_bwd)
    before = [k.f64_launches for k in counters]
    chk = tape_check(planes, tape, angles, cot, sched)
    # a check, a control and a repeat forward, a check and a repeat adjoint
    counted = tuple(k.f64_launches - b for k, b in zip(counters, before))
    out, grads, bit = chk["out"], chk["grads"], chk["bit"]
    err = dict(zip(("fwd", "bwd"), chk["err"]))
    wrong_f, wrong_b = chk["wrong"]
    plain_ms = chk["plain_ms"]
    sched_err = ("n/a (one chunk a row)" if sched is None
                 else float((sched.cpu() - sweep_twin(tape, n)).abs().max()))
    ok = (err["fwd"] <= TOL_FWD64 and err["bwd"] <= TOL_BWD64
          and wrong_f > 1e6 * TOL_FWD64 and wrong_b > 1e6 * TOL_BWD64
          and bit and sched_err in (0.0, "n/a (one chunk a row)")
          and counted == (3, 2)
          and all(t.dtype == torch.float64 for t in (*out, *grads)))
    segments = None if sched is None else sched[:, 0].tolist()
    done(label, t0, E=n_env, S=s_n, G=cap, R=cap, D=1 << n,
         fwd_max_abs_err=f"{err['fwd']:.3e}",
         bwd_max_abs_err=f"{err['bwd']:.3e}", tol=(TOL_FWD64, TOL_BWD64),
         controls={"RYY sign flipped": f"{wrong_f:.3e}",
                   "RZZ gradient dropped": f"{wrong_b:.3e}"},
         repeat_bit_for_bit=bit, f64_launches=counted,
         segments_per_env=segments, schedule_vs_twin=sched_err,
         launches_per_call=lib.max_segments(cap, n), ok=ok)
    if not ok:
        raise AssertionError(f"{label}: the double-precision tape kernels "
                             "disagree with their plain versions, a "
                             "control passed or a launch went uncounted")
    t0 = phase(f"{label} timing")
    fwd_t, bwd_t = gate_tables()
    tape_np = tuple(a.cpu().numpy() for a in tape)
    plane_bytes = planes[0].numel() * 8
    in_bytes = sum(a.numel() * 4 for a in tape) + angles.numel() * 8
    stream = at._stream(angles.device)
    runs = {"fwd": (lambda: at.run_sweep_fwd(lib, *planes, tape, angles,
                                             schedule=sched, stream=stream),
                    s_n * tape_flops(tape_np, 1 << n, fwd_t).sum(),
                    4 * plane_bytes + in_bytes),
            "bwd": (lambda: at.run_sweep_bwd(lib, *out, *cot, tape, angles,
                                             schedule=sched, stream=stream),
                    s_n * tape_flops(tape_np, 1 << n, bwd_t).sum(),
                    6 * plane_bytes + in_bytes + angles.numel() * 8)}
    entries, info = {}, {}
    reps = 5 if n > lib.chunk_bits() else 20
    for key, (kernel, flops, nbytes) in runs.items():
        k_ms = time_back_to_back(kernel, reps)
        dev_ms = device_ms(kernel, f"apply_tape_f64_{key}", reps=3)
        t_ops = float(flops) / FP64_PEAK_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        entries[key] = {"max_abs_err": err[key], "ms": k_ms,
                        "plain_ms": plain_ms[key],
                        "bound_ms": 1e3 * max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes", "device_ms": dev_ms}
        info[key] = (f"kernel {k_ms:.4f} ms (back to back; profiler "
                     f"device time {_ms_or_not(dev_ms)}), plain "
                     f"{plain_ms[key]:.4f} ms, bound "
                     f"{entries[key]['bound_ms']:.6f} ms "
                     f"({entries[key]['bound_by']}; {flops / 1e6:.3f} "
                     f"MFLOP, {nbytes / 1e6:.3f} MB)")
    done(f"{label} timing", t0, **info,
         dynamic_smem_bytes_per_cta=tuple(
             lib.smem_bytes(a, n) for a in (0, 1)),
         threads_per_cta=lib.threads(n),
         ctas_per_sm=at.check_sweep_fit(lib, n, angles.device),
         library_ms="n/a (no single PyTorch call computes a tape)")
    return entries


def f64_composed_phase():
    """The composed step in complex128 at the main path's shapes (8q H2O,
    E = 128, S = 8, CNOT tapes at the fixed config's capacities, the
    double-precision tape kernels): at 3 iterations against its plain run
    in float64, e_new within 1e-10 Ha (x_opt's largest difference shown:
    an angle on a flat direction moves by ~lr x 1e-16 / eps an iteration
    between summation orders); at 100 iterations as a CUDA graph (its
    first call the warm-up and capture, then replays on other starts and
    on the first again) against the eager kernel path bit for bit, every
    call 102 B3f and 100 B3b double-precision launches; the graph's and
    the eager step's ms."""
    import torch

    from tensorrl_qas_tpu_torch.ops import apply_tape as at
    from tensorrl_qas_tpu_torch.optim.angle_opt import (
        AngleOptimizer,
        ComposedGraph,
    )

    label = "composed complex128 8q"
    t0 = phase(label)
    case = Case(COMPOSED, V1_CONFIG, V1_ENVS)
    opt = AngleOptimizer(case.prob.pauli, device="cuda",
                         dtype=torch.complex128)
    args = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in (*case.args[:5], *case.args[-2:]))
    h_apply = opt._h_apply(torch.float64)

    def step(a, iters, plain=False):
        return opt._fused_step_composed(*a[:5], h_apply, *a[5:],
                                        iters=iters, lr=LR, plain=plain)
    xk, ek = step(args, 3)
    xp, ep = step(args, 3, plain=True)
    e_err = float((ek - ep).abs().max())
    x_diff = float((xk - xp).abs().max())
    graph = ComposedGraph(opt)
    counters = (at.apply_tape_fwd, at.apply_tape_bwd)
    other = (*args[:5], (args[5] + 0.05 * args[6]).contiguous(), args[6])
    bits, launches = [], []
    t1 = time.perf_counter()
    for a in (args, other, args):
        before = [k.f64_launches for k in counters]
        xg, eg = graph(*a, iters=ITERS, lr=LR)
        torch.cuda.synchronize()
        launches.append(tuple(k.f64_launches - b
                              for k, b in zip(counters, before)))
        xe, ee = step(a, ITERS)
        bits.append(bool(torch.equal(xg, xe) and torch.equal(eg, ee)))
    first_calls_s = time.perf_counter() - t1
    graph_ms = time_cuda(lambda: graph(*args, iters=ITERS, lr=LR), warmup=1,
                         reps=5)
    eager_ms = time_cuda(lambda: step(args, ITERS), warmup=0, reps=1)
    ok = (e_err <= TOL_STEP64 and all(bits) and graph.captures == 1
          and all(n == (ITERS + 2, ITERS) for n in launches)
          and ek.dtype == torch.float64)
    done(label, t0, E=case.n_env, S=case.s, G=case.g, R=case.r,
         e_new_max_abs_err_vs_plain_3_iters=f"{e_err:.3e}", tol=TOL_STEP64,
         x_opt_max_abs_diff_3_iters=f"{x_diff:.3e}",
         graph_bit_for_bit_100_iters=bits, captures=graph.captures,
         f64_launches_per_call=launches,
         graph_step_ms=f"{graph_ms:.4f}", eager_step_ms=f"{eager_ms:.4f}",
         checked_calls_s=f"{first_calls_s:.2f}", ok=ok)
    if not ok:
        raise AssertionError(f"{label}: the step disagrees with its plain "
                             "run or the graph with the eager kernel path")


def f64_phases(builds):
    """complex128 on the card: the double-precision tape kernels at
    ``F64_TAPE_SHAPES``, the 8q composed step (``f64_composed_phase``),
    the main path's trainer with ``--sim_dtype complex128`` (128
    replicas, every vector step iters + 2 double-precision B3f and iters
    B3b launches through the composed step's graph, no fused kernel;
    traced), and the noisy COBYLA cost in complex128 at 8q (one
    double-precision B3f launch an evaluation) against the eager complex128
    simulator within 1e-12 Ha.  -> the kernels line's entries (numbers at
    8q, launches from the trainer)."""
    builds.wait("apply_tape_f64")
    entries = f64_tape_phases()
    f64_composed_phase()
    calls = {"fwd": F64_STEPS * (ITERS + 2), "bwd": F64_STEPS * ITERS}
    launches = trainer_phase(
        COMPOSED, V1_CONFIG, V1_ENVS, F64_STEPS, "trainer v1 complex128",
        F64_ARGS, profile=True,
        expect={**{f"apply_tape_{k}": v for k, v in calls.items()},
                **{f"apply_tape_f64_{k}": v for k, v in calls.items()}})
    for key in ("fwd", "bwd"):
        entries[key]["launches"] = launches[f"apply_tape_f64_{key}"]
    noisy_cost_phase(NOISY_CONFIG, "cobyla noisy cost complex128 8q",
                     csim=False, sim_dtype="complex128", tol=1e-12)
    return entries


def f64_tape_phases():
    """The double-precision tape kernels at ``F64_TAPE_SHAPES``
    (``f64_tape_phase``) -> the entries of the first (8q)."""
    g12, _ = su4_capacity(SU4_12_CONFIG)
    g20, _ = su4_capacity(V2S_CONFIG)
    entries = None
    for n, n_env, s_n, cap in F64_TAPE_SHAPES:
        cap = cap or (g12 if n == 12 else g20)
        got = f64_tape_phase(n, n_env, s_n, cap,
                             f"kernel tape f64 {n}q E={n_env}")
        entries = entries or got
    return entries


def sweep_tape_phases(builds):
    """``--sweep-tape``: the two instances of the sweep tape kernels' body
    (``csrc/tape_sweep.cuh``) alone, each build's ptxas lines printed: the
    float kernels at 17 qubits and at the 20q su4 trainer's shapes (E = 8,
    S = 4, G = R = 46), then the double ones at ``F64_TAPE_SHAPES``, each
    checked against its plain versions and timed as in the default
    run."""
    g20, _ = su4_capacity(V2S_CONFIG)
    builds.wait("apply_tape_sweep")
    tape_phase(WIDE_CHAIN, WIDE_CHECK_ENVS, CHAIN_CAP,
               f"kernel tape {WIDE_CHAIN}q", woven=True)
    tape_phase(20, V2S_ENVS, g20, f"kernel tape 20q G={g20}", woven=True,
               s_n=V2S_STARTS)
    builds.wait("apply_tape_f64")
    f64_tape_phases()


def f64_wide_trainer():
    """``--f64``: the 20q Heisenberg su4 trainer in complex128 (8
    replicas, the config's 4 starts x 100 iterations, G = R = 46) for
    ``WIDE_STEPS`` vector steps, traced: every vector step iters + 2
    double-precision B3f and iters B3b calls (3 segment launches each)
    and two segment builds; env-steps/s, device ms by kernel family, the
    busy share and peak device memory."""
    calls = {"fwd": WIDE_STEPS * (ITERS + 2), "bwd": WIDE_STEPS * ITERS}
    print(f"[trainer su4 20q complex128] replay is not reached: {V2S_ENVS} "
          f"replicas x {max(0, WIDE_STEPS - 4)} transitions < batch 1000",
          flush=True)
    trainer_phase(
        COMPOSED, V2S_CONFIG, V2S_ENVS, WIDE_STEPS,
        "trainer su4 20q complex128", SU4_ARGS + F64_ARGS,
        expect_replay=False, profile=True,
        expect={**{f"apply_tape_{k}": v for k, v in calls.items()},
                **{f"apply_tape_f64_{k}": v for k, v in calls.items()},
                "tape_schedule": 2 * WIDE_STEPS})


def structure_search_phase(v1):
    """One generation of the structure search on the card
    (``tools/structure_search.py``: 8q H2O, a population of
    ``SEARCH_POP`` structures of up to 28 gates, 100 Adam iterations x 8
    starts, then the champion's polish): the generation and the polish one
    B1 launch each, no other kernel; the result within the output's rules;
    the wall s.  -> the path of the champion's artifact (``--out``)."""
    import torch

    from tensorrl_qas_tpu_torch.tools import structure_search

    t0 = phase("structure search 8q")
    champion = os.path.join(tools_tempdir(), "champion.json")
    reset_counts()
    t1 = time.perf_counter()
    res = structure_search.main(["--config", V1_CONFIG, "--pop",
                                 str(SEARCH_POP), "--gens", "1",
                                 "--polish_iters", str(ITERS), "--out",
                                 champion])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernel_counts()
    ok = (all(n == (2 if k == v1.name else 0) for k, n in launches.items())
          and res["gens"] == 1 and len(res["gates"]) <= 28
          and res["polished_err"] <= res["best_err"] + 1e-6
          and res["best_err"] > -1e-5)
    done("structure search 8q", t0, pop=SEARCH_POP, wall_s=f"{wall:.3f}",
         best_err_Ha=f"{res['best_err']:.6e}",
         polished_err_Ha=f"{res['polished_err']:.6e}",
         depth=res["depth"], cnot=res["cnot"], rot=res["rot"],
         launches=launches, ok=ok)
    if not ok:
        raise AssertionError("structure search: launches or result not as "
                             f"expected: {launches}, {res}")
    return champion


def tools_tempdir():
    """A temporary directory for the tools' inputs and outputs, outside
    the checkout, removed when the script ends."""
    path = tempfile.mkdtemp(prefix="trlqas_tools_")
    _TEMP_DIRS.append(path)
    return path


def polish_expect(iters, calls=1):
    """The launches of ``calls`` complex128 polish steps of ``iters``
    iterations at 8q: iters + 2 double-precision B3f and iters B3b calls
    a step (a row is one chunk: no schedule), no other kernel."""
    fwd, bwd = calls * (iters + 2), calls * iters
    return {"apply_tape_fwd": fwd, "apply_tape_bwd": bwd,
            "apply_tape_f64_fwd": fwd, "apply_tape_f64_bwd": bwd}


def counts_as(got, expect):
    """Whether ``got`` (``kernel_counts``) is ``expect``, the others 0."""
    return all(n == expect.get(k, 0) for k, n in got.items())


def polish_champion_phase(champion):
    """``tools/polish_champion.py`` on the structure search's champion
    (29.) on the card: complex128, ``POLISH_ITERS`` x 8 starts x 1 seed
    (the composed engine on the double-precision tape kernels, one CUDA
    graph), its error at most the search's own ``polished_err`` + 1e-9
    and above the ground state; then with one start (no random draw) for
    ``POLISH_CHECK_ITERS`` iterations on the card and on the host
    (``--device cpu``: the fused v1 engine's plain version in float64)
    within 1e-9 Ha.  -> the wall s of the first run."""
    import torch

    from tensorrl_qas_tpu_torch.tools import polish_champion

    t0 = phase("polish champion 8q")
    with open(champion) as f:
        search = json.load(f)
    reset_counts()
    t1 = time.perf_counter()
    res = polish_champion.main([champion, "--iters", str(POLISH_ITERS),
                                "--seeds", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernel_counts()
    one = ["--iters", str(POLISH_CHECK_ITERS), "--n_starts", "1",
           "--seeds", "1"]
    card = polish_champion.main([champion, *one])["f64_polished_err"]
    host = polish_champion.main([champion, *one, "--device", "cpu"])[
        "f64_polished_err"]
    err = res["f64_polished_err"]
    checks = {
        "launches as expected": counts_as(launches,
                                          polish_expect(POLISH_ITERS)),
        "not above the search's polish":
            err <= search["polished_err"] + TOL_POLISH,
        "above the ground state": err >= -TOL_POLISH,
        "card as host, one start": abs(card - host) < TOL_POLISH,
    }
    done("polish champion 8q", t0, iters=POLISH_ITERS, wall_s=f"{wall:.3f}",
         f64_polished_err_Ha=f"{err:.9e}",
         search_polished_err_Ha=f"{search['polished_err']:.9e}",
         one_start_card_Ha=f"{card:.12e}", one_start_host_Ha=f"{host:.12e}",
         one_start_diff_Ha=f"{abs(card - host):.3e}", launches=launches,
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"polish champion: checks failed: {checks}")
    return wall


def polish_best_phase(kept):
    """``tools/polish_best.py`` on the summary of the sequential 8q trainer
    (23.: two episodes), which ``kept`` holds, on the card: complex128,
    ``POLISH_BEST_ITERS`` x 8 starts x 1 restart; the row has the script's
    keys, and its error is at most ``analyze_longrun.f64_error`` of the
    same step + 1e-9 (start 0 is that step's remapped angles, and the step
    keeps its best iterate) and above the ground state.  -> the wall s."""
    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.circuits.actions import action_dictionary
    from tensorrl_qas_tpu_torch.tools import analyze_longrun, polish_best
    from tensorrl_qas_tpu_torch.train.config import get_config

    t0 = phase("polish best 8q")
    run_dir = os.path.join(kept, FIXED, V1_CONFIG)
    reset_counts()
    t1 = time.perf_counter()
    (row,) = polish_best.main([run_dir, "--seed", "0", "--iters",
                               str(POLISH_BEST_ITERS), "--restarts", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernel_counts()
    train = np.load(os.path.join(run_dir, "summary_0.npy"),
                    allow_pickle=True).item()["train"]
    (cand,) = polish_best.candidates(train)
    conf = get_config(FIXED, f"{V1_CONFIG}.cfg")
    n = conf["env"]["num_qubits"]
    exact = analyze_longrun.f64_error(
        cand["actions"], cand["angles"], conf, "fixed",
        conf["env"]["num_layers"], action_dictionary(n, "all_to_all"))
    err = row["polished_f64_error"]
    keys = {"results_dir", "which", "episode", "step", "run_error",
            "depth", "cnots", "rots", "polished_f64_error", "iters",
            "n_starts", "restarts"}
    checks = {
        "launches as expected": counts_as(
            launches, polish_expect(POLISH_BEST_ITERS)),
        "the script's keys": set(row) == keys,
        "the best step": (row["episode"], row["step"]) == (
            cand["episode"], cand["step"]),
        "not above its stored angles": err <= exact + TOL_POLISH,
        "above the ground state": err >= -TOL_POLISH,
    }
    done("polish best 8q", t0, iters=POLISH_BEST_ITERS,
         wall_s=f"{wall:.3f}", episode=row["episode"], step=row["step"],
         run_error_Ha=f"{row['run_error']:.6e}",
         stored_angles_f64_error_Ha=f"{exact:.9e}",
         polished_f64_error_Ha=f"{err:.9e}", launches=launches,
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"polish best: checks failed: {checks}")
    return wall


def demo_run(mesh, args=(), trace=False):
    """``tools/demo_20q_training.py --mesh <mesh>`` on the card with
    ``args``, every kernel's count set to 0 just before; with ``trace``
    under ``TRLQAS_PROFILE`` (a temporary directory) inside
    ``utils/profiling.maybe_device_trace``, its phases in a
    ``PhaseTimer``.  -> (record, launches, wall s, the trace's path and
    the timer's summary, or None)."""
    import torch

    from tensorrl_qas_tpu_torch.tools import demo_20q_training
    from tensorrl_qas_tpu_torch.utils import profiling

    out = os.path.join(tools_tempdir(), "demo20q.json")
    argv = ["--mesh", mesh, *args, "--out", out]
    timer = profiling.PhaseTimer()
    reset_counts()
    t1 = time.perf_counter()
    if trace:
        os.environ["TRLQAS_PROFILE"] = tools_tempdir()
    try:
        with profiling.maybe_device_trace() as prof:
            with timer.phase("demo_20q_training"):
                record = demo_20q_training.main(argv)
            with timer.phase("synchronize"):
                torch.cuda.synchronize()
    finally:
        os.environ.pop("TRLQAS_PROFILE", None)
    wall = time.perf_counter() - t1
    traced = (prof.trace_path, timer.summary()) if trace else None
    return record, kernel_counts(), wall, traced


def demo_line(record):
    """The per-episode numbers of a demo record for a phase's line."""
    eps = record["episodes"]
    steps = sum(e["steps"] for e in eps)
    wall = sum(e["wall_s"] for e in eps)
    return {"episodes": len(eps), "env_steps": steps,
            "wall_s_per_step": f"{wall / steps:.4f}",
            "env_steps_per_s": f"{steps / wall:.4f}",
            "warmstart_Ha": f"{eps[0]['warmstart']:.7f}",
            "best_energy_Ha": f"{record['best_energy']:.7f}",
            "min_eig_bound_Ha": f"{record['min_eig_bound']:.7f}"}


def demo_phases(v2, v2s):
    """The 20q demo (``tools/demo_20q_training.py``) on the card, one
    episode a run: ``--mesh none`` for ``DEMO_NONE_LAYERS`` layers (3 env
    steps, each one launch of the v2 engine's sweep kernel, no other
    kernel), ``--mesh 2,4`` (the sharded optimizer, all eight shards on
    this card) for ``DEMO_MESH_LAYERS`` (2 steps, no kernel), their
    warm-start energies within 1e-5 of each other and above the lower
    bound less 1e-4; then the ``--mesh none`` run again under
    ``TRLQAS_PROFILE``: the trace file holds device-kernel events (whether
    it names the sweep kernel is printed, not required: the profiler has
    missed kernels before), and the PhaseTimer's summary."""
    import torch

    t0 = phase("demo 20q none")
    none, counts, wall, _ = demo_run("none", ("--episodes", "1",
                                              "--num_layers",
                                              str(DEMO_NONE_LAYERS)))
    steps = none["episodes"][0]["steps"]
    warm = none["episodes"][0]["warmstart"]
    checks = {"3 env steps": steps == 3,
              "a sweep launch a step": counts_as(
                  counts, {v2.name: steps, v2s.name: steps}),
              "above the bound": warm >= none["min_eig_bound"] - 1e-4}
    done("demo 20q none", t0, wall_s=f"{wall:.3f}", **demo_line(none),
         launches=counts, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"demo 20q none: checks failed: {checks}")

    t0 = phase("demo 20q mesh 2,4")
    mesh, counts, wall, _ = demo_run("2,4", ("--episodes", "1",
                                             "--num_layers",
                                             str(DEMO_MESH_LAYERS)))
    warm_mesh = mesh["episodes"][0]["warmstart"]
    checks = {"2 env steps": mesh["episodes"][0]["steps"] == 2,
              "no kernel": counts_as(counts, {}),
              "warm start as --mesh none":
                  abs(warm_mesh - warm) < TOL_DEMO_WARM}
    done("demo 20q mesh 2,4", t0, wall_s=f"{wall:.3f}", **demo_line(mesh),
         warm_diff_Ha=f"{abs(warm_mesh - warm):.3e}", launches=counts,
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"demo 20q mesh: checks failed: {checks}")

    t0 = phase("demo 20q traced")
    _, counts, wall, (path, timer) = demo_run(
        "none", ("--episodes", "1", "--num_layers", str(DEMO_NONE_LAYERS)),
        trace=True)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [ev.get("name", "") for ev in events
               if ev.get("cat") == "kernel"]
    names_sweep = any("fused_adam_v2_sweep_kernel" in k for k in kernels)
    checks = {"trace file": os.path.getsize(path) > 0,
              "device-kernel events": len(kernels) > 0,
              "a sweep launch a step": counts_as(
                  counts, {v2.name: steps, v2s.name: steps})}
    done("demo 20q traced", t0, wall_s=f"{wall:.3f}",
         trace_MB=f"{os.path.getsize(path) / 2**20:.2f}",
         kernel_events=len(kernels), names_sweep_kernel=names_sweep,
         phase_timer=json.dumps(timer), checks=checks)
    torch.cuda.synchronize()
    if not all(checks.values()):
        raise AssertionError(f"demo 20q traced: checks failed: {checks}")


def host_rss_bytes():
    """This process's resident set (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def polish_champion_full(champion):
    """``--tools``: the champion's polish at the script's size
    (``POLISH_FULL``: 3000 iterations x 8 starts x 3 seeds) through the
    tool's main, its CUDA graph's capture and instantiation timed (a
    ``torch.cuda.CUDAGraph`` that times ``capture_begin`` to
    ``capture_end`` and ``capture_end``, which instantiates) and the
    first step's host and device memory; each seed's wall s (the first:
    the eager warm-up, the capture and the instantiation; the others a
    replay); seed 0 again, a replay, bit for bit the first (eager) run;
    the graph's device operations estimated from traced steps of 10 and
    20 iterations (every iteration the same kernels)."""
    import gc

    import numpy as np
    import torch

    from tensorrl_qas_tpu_torch.optim import angle_opt
    from tensorrl_qas_tpu_torch.tools import polish_champion

    iters, starts, seeds = POLISH_FULL
    t0 = phase("polish champion 8q full")
    made, steps, graphs = [], [], []

    class TimedGraph(torch.cuda.CUDAGraph):
        def capture_begin(self, *args, **kwargs):
            self.times = [time.perf_counter()]
            return super().capture_begin(*args, **kwargs)

        def capture_end(self):
            self.times.append(time.perf_counter())
            super().capture_end()
            self.times.append(time.perf_counter())
            graphs.append(self.times)

    class Recorded(angle_opt.AngleOptimizer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def fused_step(self, *args):
            rss, reserved = host_rss_bytes(), torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            allocated = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            out = super().fused_step(*args)
            torch.cuda.synchronize()
            steps.append({
                "s": time.perf_counter() - t1, "out": out, "args": args,
                "host_MB": (host_rss_bytes() - rss) / 2**20,
                "reserved_MB": (torch.cuda.memory_reserved() - reserved)
                / 2**20,
                "peak_MB": (torch.cuda.max_memory_allocated() - allocated)
                / 2**20})
            return out

    # the earlier phases' graphs and cached blocks freed first, so that
    # the first step's memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    graph_cls, opt_cls = torch.cuda.CUDAGraph, polish_champion.AngleOptimizer
    torch.cuda.CUDAGraph, polish_champion.AngleOptimizer = (TimedGraph,
                                                            Recorded)
    try:
        t1 = time.perf_counter()
        res = polish_champion.main([champion, "--iters", str(iters),
                                    "--n_starts", str(starts), "--seeds",
                                    str(seeds)])
        wall = time.perf_counter() - t1
        (opt,) = made
        opt.generator.manual_seed(0)
        opt.fused_step(*steps[0]["args"])
    finally:
        torch.cuda.CUDAGraph, polish_champion.AngleOptimizer = (graph_cls,
                                                                opt_cls)
    (times,) = graphs
    capture_s, instantiate_s = times[1] - times[0], times[2] - times[1]
    first, again = steps[0], steps[-1]
    same = (np.array_equal(first["out"][0], again["out"][0])
            and first["out"][1] == again["out"][1])
    # device operations of one step: traced steps of 10 and 20 iterations
    # (the warm-up before each capture), the difference a 10-iteration one
    psi0, arrs, x0, n_rots, _, map_idx = steps[0]["args"]
    ops = {}
    for k in (10, 20):
        small = angle_opt.AngleOptimizer(opt.pauli, iters=k, n_starts=starts,
                                          device=opt.device,
                                          dtype=torch.complex128)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            small.fused_step(psi0, arrs, x0, n_rots, arrs, map_idx)
            torch.cuda.synchronize()
        ops[k] = kernel_launches(prof, "")
    per_iter = (ops[20] - ops[10]) / 10
    nodes = ops[10] + per_iter * (iters - 10)
    eager_s = first["s"] - capture_s - instantiate_s
    replays = [st["s"] for st in steps[1:seeds]]
    checks = {"seed 0 replayed bit for bit as its eager run": same,
              "above the ground state":
                  res["f64_polished_err"] >= -TOL_POLISH}
    done("polish champion 8q full", t0, iters=iters, n_starts=starts,
         seeds=seeds, wall_s=f"{wall:.3f}",
         f64_polished_err_Ha=f"{res['f64_polished_err']:.9e}",
         search_polished_err_Ha=res["search_reported_err"],
         first_step_s=f"{first['s']:.3f}", eager_warmup_s=f"{eager_s:.3f}",
         capture_s=f"{capture_s:.3f}",
         capture_end_instantiate_s=f"{instantiate_s:.3f}",
         replay_s=[f"{r:.4f}" for r in replays],
         first_step_host_rss_MB=f"{first['host_MB']:.1f}",
         first_step_device_reserved_MB=f"{first['reserved_MB']:.1f}",
         first_step_device_peak_MB=f"{first['peak_MB']:.1f}",
         device_ops_10_20_iters=[ops[10], ops[20]],
         device_ops_per_iteration=per_iter,
         graph_device_ops_estimate=int(nodes), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"polish champion full: checks failed: "
                             f"{checks}")


def demo_full(v2, v2s):
    """``--tools``: the 20q demo at its defaults (2 episodes, 30 layers: up
    to 9 env steps an episode, 20 iterations x 4 starts) on one card
    (``--mesh none``, a sweep launch a step) and on the (2, 4) mesh (no
    kernel): env-steps/s and wall s a step of each."""
    for mesh in ("none", "2,4"):
        label = f"demo 20q {mesh} defaults"
        t0 = phase(label)
        record, counts, wall, _ = demo_run(mesh)
        steps = sum(e["steps"] for e in record["episodes"])
        expect = ({v2.name: steps, v2s.name: steps} if mesh == "none"
                  else {})
        checks = {"launches as expected": counts_as(counts, expect)}
        done(label, t0, wall_s=f"{wall:.3f}", **demo_line(record),
             launches=counts, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{label}: checks failed: {checks}")


def main(argv=()) -> int:
    watchdog = threading.Timer(DEADLINE_S, _expire)
    watchdog.daemon = True
    watchdog.start()
    # and, should the watchdog's thread never run (a call that holds the
    # GIL, a write that blocks), the kernel ends the process: SIGALRM's
    # default action
    signal.signal(signal.SIGALRM, signal.SIG_DFL)
    signal.alarm(DEADLINE_S + HARD_DEADLINE_MARGIN_S)
    t_start = t0 = phase("device")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", flush=True)
        return 1
    smi = smi_line()
    print(smi, flush=True)
    done("device", t0, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    v1, v1n, v2, v2n, v1p, v2p, v2c, v2g, v2s = engines()
    if "--composed" in argv:
        composed_phases(Builds(("apply_tape",)))
        watchdog.cancel()
        return 0
    if "--h-psi" in argv:
        Builds(("apply_tape",)).wait("apply_tape")
        h_psi_compare()
        watchdog.cancel()
        return 0
    if "--parting-env" in argv:
        Builds(("fused_adam_v1",)).wait("fused_adam_v1")
        parting_env(v1)
        watchdog.cancel()
        return 0
    if "--f64" in argv:
        builds = Builds(("apply_tape_f64",))
        f64_phases(builds)
        f64_wide_trainer()
        watchdog.cancel()
        return 0
    if "--sweep-tape" in argv:
        sweep_tape_phases(Builds(("apply_tape_sweep", "apply_tape_f64")))
        watchdog.cancel()
        return 0
    if "--composed-wide" in argv:
        composed_wide_phases(Builds(("apply_tape_sweep",)), full=True)
        watchdog.cancel()
        return 0
    if "--tape" in argv:
        Builds(("apply_tape",)).wait("apply_tape")
        tape_compare()
        watchdog.cancel()
        return 0
    if "--plain-modes" in argv:
        plain_modes(v1, v2)
        plain_memory(v2s)
        watchdog.cancel()
        return 0
    if "--band" in argv:
        Builds(("fused_adam_v2",)).wait("fused_adam_v2")
        split_band(v2)
        watchdog.cancel()
        return 0
    if "--sweep-time" in argv:
        Builds(("fused_adam_v2_sweep",)).wait("fused_adam_v2_sweep")
        sweep_time_phase(v2s)
        watchdog.cancel()
        return 0
    if "--sweep" in argv:
        Builds(("fused_adam_v2_sweep",)).wait("fused_adam_v2_sweep")
        sweep_compare(v2s)
        sweep_kernel_phase(v2, v2n, v2p, v2s)
        trainer_phase(v2s, V2S_CONFIG, V2S_ENVS, V2S_STEPS, "trainer v2 20q",
                      expect={v2.name: V2S_STEPS, v2s.name: V2S_STEPS},
                      expect_replay=False, profile=True)
        sequential_v2_sweep_phase(v2, v2s)
        sweep_in_state_trainers(v2, v2p, v2s)
        watchdog.cancel()
        return 0
    if "--mesh" in argv:
        if "--cards" in argv:
            MESH_CARDS[0] = torch.cuda.device_count()
        Builds(("fused_adam_v2_sweep",)).wait("fused_adam_v2_sweep")
        mesh_phase(v2s, full=True)
        watchdog.cancel()
        return 0
    if "--warm-start" in argv:
        warm_start_control(warm_start_phase(warm_tempdir()))
        warm_start_bricks()
        watchdog.cancel()
        return 0
    if "--tools" in argv:
        builds = Builds(("fused_adam_v1", "apply_tape_f64",
                         "fused_adam_v2_sweep"))
        builds.wait("fused_adam_v1")
        kept = tools_tempdir()
        sequential_phase(
            V1_CONFIG, "sequential v1", SEQ_ARGS, keep=kept,
            expect=lambda s: {v1.name: s["steps"] + s["test_steps"]})
        champion = structure_search_phase(v1)
        builds.wait("apply_tape_f64", "fused_adam_v2_sweep")
        polish_champion_phase(champion)
        polish_best_phase(kept)
        demo_phases(v2, v2s)
        polish_champion_full(champion)
        demo_full(v2, v2s)
        watchdog.cancel()
        return 0
    if "--split" in argv:
        builds = Builds(("fused_adam_v1", "fused_adam_v2", "apply_tape"))
        builds.wait("apply_tape")
        split_tape()
        builds.wait("fused_adam_v1", "fused_adam_v2")
        split_only(v1, v2, v2n)
        parting_phase(v1p, v2p)
        watchdog.cancel()
        return 0
    builds = Builds(("fused_adam_v1", "fused_adam_v2", "apply_tape",
                     "apply_tape_sweep", "fused_adam_v2_sweep",
                     "apply_tape_f64"), host=("csim",))
    # the composed engine's phases go first: their plain references, and
    # then the plain times of later timing phases, while nvcc builds the
    # tape kernels (~45 s), the rest while it builds the fused kernels
    prefetch = ((v2p, V2_CONFIG, V2_ENVS, TRAINABLE),
                (v1p, V1_CONFIG, V1_ENVS, TRAINABLE),
                (v2n, V2_CONFIG, V2_ENVS, FIXED),
                (v1n, V1N_CONFIG, V1_ENVS, FIXED))
    pre, wide = {}, []

    def idle(ready):
        # the composed engine's 20q references first, then the prefetch
        wide.extend(composed_wide_setups())
        pre.update(plain_prefetch(prefetch, ready))
    tape = composed_phases(builds, idle=idle)
    # the composed engine at 17-20 qubits: the sweep tape kernels
    tape["sweep"] = composed_wide_phases(builds, setups=wide)
    # complex128 on the card: the double-precision tape kernels, the
    # composed step and the main path's trainer in float64
    tape["f64"] = f64_phases(builds)
    # the sequential trainer under COBYLA: csim, and B3f under noise
    builds.wait("csim")
    seq = {"apply_tape_fwd (cobyla noisy 8q)": cobyla_phases()}
    # the warm starts of the three trainers below (stages 0 and 1 on the
    # card), which then train from them
    warm_dir = warm_tempdir()
    warm_start_control(warm_start_phase(warm_dir))
    builds.wait("fused_adam_v1")
    results = {}
    results[v1], _ = kernel_phase(v1, V1_CONFIG, V1_ENVS, "kernel v1")
    with warm_data(warm_dir, V1_CONFIG):
        results[v1]["launches"] = trainer_phase(v1, V1_CONFIG, V1_ENVS,
                                                V1_STEPS, "trainer v1",
                                                profile=True)[v1.name]
    kept = tools_tempdir()
    seq[f"{v1.name} (sequential v1)"], _ = sequential_v1_phases(v1, kept)
    champion = structure_search_phase(v1)
    # what needs no fused_adam_v2 library goes first, while nvcc may still
    # build that source (the longest build): v1 below 8 qubits, with noise
    # and at the trainable capacities, and the sweep kernel
    small = Case(v1, *V1_SMALL)
    check_kernel(v1, small, f"kernel v1 {V1_SMALL[0]} E={V1_SMALL[1]}", 3,
                 TOL_ITERS3, small.controls())
    results[v1n], _ = kernel_phase(v1n, V1N_CONFIG, V1_ENVS, "kernel v1n",
                                   pre=pre.get(v1n.name))
    p0_phase(v1, v1n, V1N_CONFIG, V1_ENVS)
    kraus_phase(v1n)
    results[v1n]["launches"] = trainer_phase(
        v1n, V1N_CONFIG, V1_ENVS, V1N_STEPS, "trainer v1n",
        expect_replay=False)[v1n.name]
    # in_state placement: the kernels at the trainable capacities (G != R),
    # their per-env psi0 variants, and the trainers of both families
    _, case = kernel_phase(v1, V1_CONFIG, V1_ENVS, "kernel v1 trainable",
                           long_check=False, family=TRAINABLE,
                           time_plain=False)
    psi0_rows_phase(v1, v1p, case)
    # the trainable families at 3 iterations only: their 100-iteration
    # trajectories part in float32 in any implementation (ROADMAP.md, C:
    # the plain version's float32 and float64 runs part by up to 9.8e-3
    # Ha at 8q), and the band of runs that would show it costs ~6 plain
    # runs
    results[v1p], _ = kernel_phase(v1p, V1_CONFIG, V1_ENVS, "kernel v1p",
                                   long_check=False, family=TRAINABLE,
                                   pre=pre.get(v1p.name))
    # untraced (--split traces the trainable trainer): tracing it here took
    # more of the deadline than its training; T_FAMILY_STEPS, too few for
    # replay (trainer v1p runs it in the trainable family)
    for family, label in ((TRAINABLE, "trainer v1 trainable"),
                          (STRUCTURE, "trainer v1 StructureRL")):
        trainer_phase(v1, V1_CONFIG, V1_ENVS, T_FAMILY_STEPS, label,
                      family=family, expect_replay=False)
    results[v1p]["launches"] = trainer_phase(
        v1p, V1_CONFIG, V1_ENVS, T_STEPS, "trainer v1p", BLOCK_COORD,
        family=TRAINABLE)[v1p.name]
    # the sweep kernel (19-20 qubits), the 20q trainer and the sequential
    # trainer at 20q through it
    builds.wait("fused_adam_v2_sweep")
    results[v2s], _ = sweep_kernel_phase(v2, v2n, v2p, v2s)
    print(f"[trainer v2 20q] replay is not reached: {V2S_ENVS} replicas x "
          f"{max(0, V2S_STEPS - 4)} transitions < batch 1000", flush=True)
    with warm_data(warm_dir, V2S_CONFIG):
        results[v2s]["launches"] = trainer_phase(
            v2s, V2S_CONFIG, V2S_ENVS, V2S_STEPS, "trainer v2 20q",
            expect={v2.name: V2S_STEPS, v2s.name: V2S_STEPS},
            expect_replay=False, profile=True)[v2s.name]
    seq[f"{v2s.name} (sequential v2 20q)"] = sequential_v2_sweep_phase(
        v2, v2s)
    # 26. the sharded path (parallel/) on the card, beside the sweep
    # kernel it is held to
    mesh_phase(v2s)
    # 29b. the tools: the complex128 polish of the search's champion and of
    # the sequential 8q trainer's best step, the 20q demo on one card, on
    # the mesh, and traced
    polish_champion_phase(champion)
    polish_best_phase(kept)
    demo_phases(v2, v2s)

    builds.wait("fused_adam_v2")
    results[v2], _ = kernel_phase(v2, V2_CONFIG, V2_ENVS, "kernel v2")
    sweep_phase(v2)
    with warm_data(warm_dir, V2_CONFIG):
        results[v2]["launches"] = trainer_phase(
            v2, V2_CONFIG, V2_ENVS, V2_STEPS, "trainer v2")[v2.name]
    shutil.rmtree(warm_dir)
    seq[f"{v2.name} (sequential v2 12q)"], _, _ = sequential_v2_phases(v2)
    print(f"[sequential] launches on the sequential paths: {seq}",
          flush=True)
    # the cluster kernel (13-16 qubits) and the 14q trainer through it
    results[v2c], _ = cluster_phase(v2, v2n, v2p, v2c)
    results[v2c]["launches"] = trainer_phase(
        v2c, V2C_CONFIG, V2C_TRAINER_ENVS, V2C_STEPS, "trainer v2 14q",
        expect={v2.name: V2C_STEPS, v2c.name: V2C_STEPS},
        profile=True)[v2c.name]
    # the group kernel (17-18 qubits) and the 18q trainer through it
    results[v2g], _ = group_phase(v2, v2n, v2p, v2g)
    print(f"[trainer v2 18q] replay is not reached: {V2G_TRAINER_ENVS} "
          f"replicas x {V2G_STEPS - 4} transitions < batch 1000 (the 14q "
          "trainer runs it)", flush=True)
    results[v2g]["launches"] = trainer_phase(
        v2g, V2G_CONFIG, V2G_TRAINER_ENVS, V2G_STEPS, "trainer v2 18q",
        expect={v2.name: V2G_STEPS, v2g.name: V2G_STEPS},
        expect_replay=False, profile=True)[v2g.name]
    p0_phase(v2, v2n, V2_CONFIG, V2_ENVS)
    results[v2n], _ = kernel_phase(v2n, V2_CONFIG, V2_ENVS, "kernel v2n",
                                   pre=pre.get(v2n.name))
    sweep_phase(v2n, V2N_SWEEP)
    results[v2n]["launches"] = trainer_phase(
        v2n, V2_CONFIG, V2_ENVS, V2N_STEPS, "trainer v2n",
        extra=("--noise", "depolarizing"), expect_replay=False)[v2n.name]
    _, case = kernel_phase(v2, V2_CONFIG, V2_ENVS, "kernel v2 trainable",
                           long_check=False, family=TRAINABLE,
                           time_plain=False)
    psi0_rows_phase(v2, v2p, case)
    results[v2p], _ = kernel_phase(v2p, V2_CONFIG, V2_ENVS, "kernel v2p",
                                   long_check=False, family=TRAINABLE,
                                   pre=pre.get(v2p.name))
    results[v2p]["launches"] = trainer_phase(
        v2p, V2_CONFIG, V2_ENVS, V2P_STEPS, "trainer v2p", BLOCK_COORD,
        expect_replay=False, family=TRAINABLE)[v2p.name]
    results = {e: results[e] for e in (v1, v2, v2c, v2g, v2s, v1n, v2n, v1p,
                                       v2p)}

    kernels = {"kernels": [{
        "name": e.name, "route": "cuda", "source": e.source,
        "replaces": e.replaces, "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
        for e, r in results.items()] + [{
        "name": f"{prefix}{key} ({label})",
        "route": "cuda", "source": source,
        "replaces": REPLACES["tape", key], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
        for band, prefix, source, label in (
            ("reg", "apply_tape_", TAPE_SOURCE,
             "register kernel at 1-9 qubits; numbers at 8, launches from "
             "the 8q su4 trainer"),
            ("wide", "apply_tape_", TAPE_SOURCE,
             "wide kernels at 10-16 qubits; numbers at 12, the 12q su4 "
             "trainer's shapes and launches"),
            ("sweep", "apply_tape_sweep_", SWEEP_TAPE_SOURCE,
             "sweep kernels at 17-20 qubits, a launch a segment; numbers at "
             "20, the 20q su4 trainer's shapes and calls"),
            ("f64", "apply_tape_f64_", F64_SOURCE,
             "double-precision kernels at 1-20 qubits (complex128), one "
             "chunk a row up to 12; numbers at 8, launches from the 8q "
             "complex128 trainer"))
        for key, r in tape[band].items()]}
    done("total", t_start)
    print(f"card: {smi}", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except BaseException:
        print(f"FAILED in phase {_phase[0]!r}", flush=True)
        traceback.print_exc()
        code = 1
    for path in _TEMP_DIRS:
        shutil.rmtree(path, ignore_errors=True)
    # leave without the interpreter's teardown (joining threads, releasing
    # the CUDA context, graphs and profiler state), whose hang would keep
    # the process past its deadline after its result is out
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
