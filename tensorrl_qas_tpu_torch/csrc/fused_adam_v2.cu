// Fused multi-start Adam env step with a flip-grouped Pauli H, one launch
// per env step (CUDA, sm_90a), for 7 <= n <= 18 qubits.
//
// Replaces the TPU kernel tensorrl_qas_tpu/ops/pallas_opt2d.py:_make_kernel
// (launched by fused_adam_step_pallas2d / _fused_adam_step_call2d), its
// noise variant (the same kernel launched with a non-null `seeds`;
// pallas_opt2d.py:draw_noise / apply_noise) and its per-env psi0 variant
// (per_env_psi0=True, pallas_opt2d.py:646-650, launched here with
// psi0_stride = D; see "Per-env psi0" below).  The gate device functions are
// gates.cuh, and the register kernel's gate bodies regs.cuh, both shared
// with fused_adam_v1.cu.  The plain PyTorch version of the same function is
// tensorrl_qas_tpu_torch/ops/fused_adam2d.py:fused_adam_step2d_reference.
//
// What one CTA computes, for its (env e, start s) (grid = E x S):
//   for it in 0..iters-1:                       (Adam over the OLD tape)
//     psi   = tape(x) psi0                       D amplitudes
//     Hpsi  = sum_f W_f * psi[i ^ f]             flip-group planes from L2
//     E     = Re<psi|H psi> / <psi|psi>          best-iterate tracking
//     dx    = adjoint sweep, lambda = 2 conj(H psi), masked by `active`
//     x     = Adam(x, dx)                        bias-corrected
//   final re-check of x; the start's best (x, E) goes to global memory.
// The last CTA of each env to finish (a per-env arrival counter) then picks
// the first start of least energy as x_opt, remaps it onto the new tape
// (x_new[j] = x_opt[map[j]], map -1 -> 0) and computes e_new = E(new tape,
// x_new), so an env step is one launch.  Adam's starts are independent
// until the argmin, so each start gets a CTA of its own up to 12 qubits:
// 128 CTAs on 132 SMs at 12 qubits, E = 16, S = 8; 2^(n - 12) CTAs above.
//
// Register kernel (7 <= n <= 12, fused_adam_v2_reg_kernel).  Every thread
// holds 16 amplitudes of psi, and of lambda in the adjoint, in registers:
// 2^(n - 4) threads (8 at 7 qubits, 256 at 12).  Amplitude p of the
// physical order lives in thread p >> 4, register p & 15, so the n
// physical bits fall into 4 register bits, up to 5 lane bits and the warp
// bits above them (3 at 12 qubits); a schedule maps logical qubits onto
// physical bits:
//   - a gate whose target sits on a register bit has both ends of each
//     pair in the thread: no communication;
//   - on a lane bit the partner comes by __shfl_xor_sync: warp-synchronous,
//     no CTA barrier;
//   - a target on a warp bit is first swapped with a register bit through
//     shared memory (each thread trades the half of its amplitudes whose
//     register bit differs from its own warp bit with the partner thread:
//     one write, one barrier, one read, double-buffered, 128-bit accesses),
//     and the new map is kept.  A control on any bit is a predicate on the
//     thread's own index.
// Lane bits hold logical qubits 0..4 for good, so H psi reads W coalesced.
// The schedule (register bit to evict: the one whose qubit is next a
// target furthest ahead, Belady) is computed once per launch and tape by
// one thread; the forward sweeps run it, the adjoint runs it backwards (a
// swap is its own inverse) and ends on the map the forward began with.
// Its plain twin is ops/fused_adam2d.py:swap_schedule.  Each op carries
// its gate's case (form, control, register bit or lane), so a gate
// dispatches on one switch to a body whose register indices are constants;
// the form (diagonal, real, or real diagonal with imaginary off-diagonal:
// every kind taken here) leaves 8 FMAs a pair forward, not 16.  Each
// gate's 2x2 entries are computed once per Adam iteration into shared
// memory.  Gradient rows: each gate's contribution is summed in
// registers, over the warp by shuffles, and lane 0 writes a per-warp
// partial indexed by gate; after the sweep one barrier and a fixed-order
// sum over warps and over the gates of each angle (descending gate order)
// give dx, so the kernel is deterministic.  H psi: psi goes to shared
// memory at logical indices (one barrier) and each thread computes lambda
// = 2 conj(H psi) for exactly the logical indices it holds, so lambda
// lands in its registers; the imaginary plane of a group is read only
// where it is not zero (the wrapper's wim_any: never for a real H).  At
// 13 qubits an adjoint gate needs more than the 128 registers a thread of
// 512 may have (ptxas spilled, as it did with 256 threads of 32
// amplitudes), so from 13 qubits a start takes more than one CTA.
//
// Cluster kernel (13 <= n <= 16, fused_adam_v2_cluster_kernel).  A start
// is one thread-block cluster of C = 2^(n - 12) CTAs, each the register
// kernel's 256 threads x 16 amplitudes of psi and lambda in registers: the
// physical bits are 4 register, 5 lane and 3 warp bits, and above them
// n - 12 cluster bits, the CTA's rank in its cluster.  The same schedule
// (build_schedule) runs over the cluster bits as over warp bits: a gate
// target on a cluster bit is first swapped with a register bit through
// distributed shared memory -- each thread writes the half of its
// amplitudes whose register bit differs from its rank bit into the
// partner CTA's buffer (map_shared_rank), one cluster barrier, and reads
// its own buffer (double-buffered, apart from the warp swaps' buffers).  A
// control on a cluster bit is CTA-uniform: the CTA whose rank bit is clear
// skips the gate, the other runs it uncontrolled.  An error Pauli on a
// cluster bit is a sign (Z) or an exchange of the whole slice with the
// partner CTA (X, Y).  H psi: each CTA puts its slice of psi in its own
// shared memory (at register * 256 + thread, conflict-free), one cluster
// barrier, and each thread sums W_f[i] psi[i ^ f] over its amplitudes,
// reading psi[i ^ f] at the physical flip of f (a per-group xor, pflip)
// from its own CTA or, where f flips a cluster bit, from the owning CTA's
// shared memory.  Energy partials and the angle gradients are summed in
// each CTA in the register kernel's fixed order, then over the ranks in
// rank order: every CTA pushes its partials into every CTA's shared
// memory, one cluster barrier, and every CTA sums the same numbers in the
// same order, so all of them take the same Adam step and the launch stays
// deterministic.  Rank 0 writes the start's best and bumps the env's
// arrival counter; the flag goes to the cluster's CTAs over distributed
// shared memory, and the last cluster of the env does the tail with all of
// its CTAs.
//
// Group kernel (17 <= n <= 18, fused_adam_v2_group_kernel).  A start would
// need 32 or 64 CTAs, more than a cluster holds (16), and no cluster holds
// an 18-qubit start's psi and lambda (4 MB) on chip.  So a start is 2^(n -
// 12) of the same register CTAs in clusters of kGroupCluster (2; the
// launch may ask for up to 16): the rank's low bits are cluster bits, as
// in the cluster kernel, the bits above them group bits, whose exchanges
// go through the start slot's area in global memory (L2-resident: 6 MB a
// start at 18 qubits) behind a start-wide barrier, an arrive counter with
// release / acquire ordering that only grows (group_sync).  A swap through
// a group bit writes the CTA's half into the partner's inbox (double-
// buffered apart from the warp and cluster swaps), one barrier, and reads
// its own inbox; an X or Y error on a group bit trades whole slices the
// same way; a control on one is CTA-uniform, as on a cluster bit.  The
// schedule (build_schedule with `top`, the first group bit) starts the
// group bits with the qubits targeted last and, at a swap through one,
// sends out the qubit below them used furthest ahead, taking a warp or
// cluster swap first where that qubit is not in a register; the op marks
// the swap (kGroupSwap).  H psi: where a flip reaches a group bit
// (kFarFlip), every CTA also writes its slice to global memory, one
// barrier, and such a group reads the partner's slice there.  Energy
// partials and angle gradients go to global memory, one barrier, and every
// CTA sums all the start's ranks in rank order, so launches repeat bit for
// bit.  A barrier over CTAs that are not all resident would hang, so the
// launch puts on the card only as many starts as it holds whole
// (`slots`, from cudaOccupancyMaxActiveClusters: 66 clusters of 2 on the
// H100, two 18-qubit starts or four 17-qubit ones), slot w walks starts
// w, w + slots, ... in order, and a barrier that waits implausibly long
// traps.  The argmin, the remap and e_new are the cluster kernel's, done
// by the slot whose start of the env arrives last.
//
// All three kernels: the W planes (read-only, shared by every CTA: 2.75 MB at
// 12-qubit LiH, 37.7 MB at 18-qubit Heisenberg) are read through __ldg from
// L2; energy sums are block reductions in double; all amplitude arithmetic
// is f32 FMA: no tensor-core TF32 or bf16, whose rounding exceeds the
// 1.6e-3 Ha acceptance threshold over a 40-gate tape.
//
// Bound.  Per start and Adam iteration: H psi is G_f D complex
// multiply-adds (8 flops each), forward and adjoint are 2x2 updates over
// D/2 pairs per gate.  At 12-qubit LiH (84 flip groups, ~60-gate
// mid-episode tapes) that is ~14 MFLOP per start per iteration, ~180 GFLOP
// per launch for E = 16, S = 8, 100 iterations: about 2.7 ms at the card's
// 67 TFLOP/s f32 rate; the inputs are a few MB, so operations bound it.
// One CTA per start is one SM per start (2^(n - 12) SMs from 13 qubits):
// the register kernel's gate chain
// is bound by that SM's instruction issue (a gate's FMAs, and the register
// moves that merging its switch cases takes), H psi by the SM's
// shared-memory and L1 traffic (psi's partners and W, 48 KB a group at 12
// qubits), not by L2; the split phase of chip_smoke.py measures both.

// Noise.  With seeds every CTA of env e computes the env's depolarizing
// realization itself (philox.cuh: key = seeds[e], counter = (gate, tag)),
// once per tag -- Adam iteration `it`, `iters` for the final re-check,
// `iters + 1` for e_new -- into per-gate error kinds in shared memory.  The
// same (key, counter) gives every start the same draws, so one realization
// is shared by an env's starts without any communication.  A fired error is
// a Pauli after the gate: on the target (a register or lane bit then) it is
// a local swap / sign or a shuffle; on the control Z is a sign on any bit,
// X or Y on a warp bit goes through shared memory (three barriers; errors
// fire on a few percent of gates).  The adjoint sweep undoes it on psi and
// transposes it onto lambda before the gate's own adjoint step.  As in
// fused_adam_v1.cu the variant is a block-uniform runtime flag, so that at
// p = 0 it is the noiseless kernel bit for bit (two template instances
// were not).
//
// Per-env psi0.  psi0_stride is the distance in floats between two envs'
// psi0 rows: 0 for one plane shared by the batch, D for (E, D) planes
// (block-coordinate trainable mode, where a frozen env starts from its
// cached prefix state).  Every CTA of env e reads row e; the stride is a
// runtime argument, so with identical rows the per-env launch is the
// shared launch bit for bit.  G (tape) and R (angles) are independent
// capacities: 244 gates and 211 angles for 12-qubit LiH in trainable
// mode, where the tapes embed the warm-start circuit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "philox.cuh"
#include "regs.cuh"

// The register kernel's launch and the dynamic shared memory go through
// these two macros, so that tests/cuda_emu/cuda_runtime.h, which defines
// both (and emulates the cluster launch), can run this source on the host.
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
#define DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
// the start of the dynamic shared memory, from any device function
extern __shared__ __align__(16) unsigned char fused_adam_v2_smem[];
#define SHARED_BASE() fused_adam_v2_smem
#endif

// The largest cluster a start may take (16 on the H100, where more than 8
// is a non-portable size).  The host tests compile the source with 2, so
// that the group kernel runs from 14 qubits with 1 group bit.
#ifndef FUSED_ADAM_V2_MAX_CLUSTER
#define FUSED_ADAM_V2_MAX_CLUSTER 16
#endif

namespace {

using namespace gates;
using namespace regs;

constexpr int kMaxQubits = 18;
// Largest qubit count of the register kernel (at 13 qubits its adjoint
// needs more than the 128 registers a thread of 512 may have, and 256
// threads of 32 amplitudes spill too: from 13 qubits a start is a cluster).
constexpr int kRegMaxQubits = 12;
constexpr int kMaxCluster = FUSED_ADAM_V2_MAX_CLUSTER;
__host__ __device__ constexpr int log2_of(int c) {
  return c > 1 ? 1 + log2_of(c / 2) : 0;
}
// The cluster kernel's band: 2^(n - 12) CTAs a start, one cluster; the
// group kernel's above it: 2^(n - 12) CTAs a start in clusters of
// kGroupCluster (or the launch's group_cluster).
constexpr int kClusterMinQubits = 13;
constexpr int kClusterMaxQubits = 12 + log2_of(kMaxCluster);
constexpr int kGroupCluster = 2 < kMaxCluster ? 2 : kMaxCluster;

// -- register kernel (7 <= n <= 12) ------------------------------------------

// Register bits of a thread: 16 amplitudes, 2^(n - 4) threads (8 at 7
// qubits, 256 at 12).
constexpr int kRegBits = 4;
constexpr int kRegThreads = 256;
// The first cluster bit: 4 register, 5 lane and 3 warp bits below it.
constexpr int kClusterBit = 12;
constexpr int kRegWarps = kRegThreads / 32;

namespace cg = cooperative_groups;

// One op of a schedule, (x, y) = (bits, gate): bits 0-3 the gate kind or
// kSwapOp, 4-8 the target's physical bit (a swap: its register bit), 9-13
// the control's physical bit + 1 (0: none; a swap: its warp, cluster or
// group bit + 1), bit 14 set when the gate has an angle gradient (a swap:
// when it goes through a group bit), 15-19 the gate's case (its
// form, whether it has a control, and its target's register bit or 4 for a
// lane bit: gate_case); y the gate's tape index (0 for a swap).
constexpr int kSwapOp = 15;
constexpr int kGradBit = 1 << 14;
constexpr int kGroupSwap = 1 << 14;     // a swap through a group bit
constexpr int kFarFlip = 1 << 30;       // pflip: a flip reaching a group bit

__device__ __forceinline__ int op_kind(int x) { return x & 15; }
__device__ __forceinline__ int op_p(int x) { return (x >> 4) & 31; }
__device__ __forceinline__ int op_q(int x) { return ((x >> 9) & 31) - 1; }
__device__ __forceinline__ int op_case(int x) { return (x >> 15) & 31; }

struct RegShared {
  double* red;     // 2 * kRegWarps energy partials
  float4* coef;    // 2 G: each gate's 2x2 entries at the current angles
  int2* ops;       // ops_capacity(G): the schedule of the current tape
  float* region;   // 4 D: two swap buffers; psi at logical indices for
                   // H psi; a Pauli's exchange on a warp bit
  float* x;        // R: iterate
  float* m;
  float* v;
  float* bx;       // best iterate
  float* scal;     // [0] current energy, [1] best energy
  float* gpart;    // G x warps gradient partials (schedule scratch first)
  Tape old_tape;
  Tape new_tape;
  int* map;        // R
  int* flips;      // G_f
  int* wim_any;    // G_f: 1 where the group's imaginary plane is not zero
  int* flag;       // [0] last CTA of its env, [1] best start
  int* err_t;      // G error kinds on the target (noise variant)
  int* err_c;      // G error kinds on the control
  int* err_ops;    // 2 G + 1: the ops with an error, ascending, then -1
  int* slot_first; // R: last gate whose gradient feeds each angle
  int* gate_next;  // G: the previous such gate of the same angle, or -1
  int* map0;       // kMaxQubits: logical qubit at each physical bit, start
  int* map1;       //   ... and end of the schedule
  int* sched;      // 4 kMaxQubits: build_schedule's scratch
  int* nops;       // 1: ops in the schedule
  // cluster kernel only (null / unused in the register kernel):
  double* cred;    // 2 kMaxCluster: every rank's energy partials
  float* cbuf;     // 4 D: two buffers the partner CTA writes a swap into
  float* cdx;      // C x R: every rank's angle-gradient partials
  int* pflip;      // G_f: each group's flip in the storage of H psi
};

// Where a CTA sits in its start: its rank among the start's CTAs (the
// physical bits from 12 up; 0 in the register kernel).  Its rank in its
// cluster (crank) and its first thread's index among the start's threads
// (gt0) follow from it and the hardware's indices, and are not kept.
struct Cl {
  int rank;
};

__device__ __forceinline__ int gt0(const Cl& cl) {
  return cl.rank * (int)blockDim.x;
}

__device__ __forceinline__ int crank() {
  return (int)cg::this_cluster().block_rank();
}

// The group kernel's start of `ctas` CTAs spans clusters: the rank's low
// `cbits` bits are the cluster rank (cluster bits), the bits above them
// the group bits; `xg` is the start slot's exchange area in global memory
// (group_area_floats), `bar` its barrier counter, and thread 0 counts the
// barriers it passed.  At the start of the dynamic shared memory, ahead of
// the body's, so that it takes no registers through the gate chain.
struct GroupSh {
  float* xg;
  unsigned int* bar;
  unsigned int passed;
  int cbits;
  int ctas;
};
constexpr int kGroupShBytes = 32;

__device__ __forceinline__ GroupSh& group_sh() {
  return *reinterpret_cast<GroupSh*>(SHARED_BASE());
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// The same shared-memory object in the CTA of rank r of this cluster.
template <class T>
__device__ __forceinline__ T* at_rank(T* p, int r) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)r);
}

// Logical index of register j of thread tid under `map` (physical bit ->
// logical qubit).
template <int RB>
__device__ __forceinline__ int thread_base(const int* map, int n, int tid) {
  int base = 0;
  for (int b = 0; b < n - RB; ++b) base |= ((tid >> b) & 1) << map[RB + b];
  return base;
}

template <int RB>
__device__ __forceinline__ void logical_indices(const int* map, int n,
                                                int tid, int (&idx)[1 << RB]) {
  const int base = thread_base<RB>(map, n, tid);
  int bit[RB];
#pragma unroll
  for (int a = 0; a < RB; ++a) bit[a] = 1 << map[a];
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    int i = base;
#pragma unroll
    for (int a = 0; a < RB; ++a)
      if ((j >> a) & 1) i |= bit[a];
    idx[j] = i;
  }
}

// The schedule of `tape` (see the header; twin: ops/fused_adam2d.py:
// swap_schedule), by one thread.  Physical bits from `top` up are group
// bits (n: none), whose swaps go through global memory: they start with
// the qubits whose first target comes last, and a swap through one sends
// out the qubit below them that is next a target furthest ahead, taking a
// warp or cluster swap into the evicted register first where that qubit
// is not in a register.  `after` is G ints of scratch, `work` 4
// kMaxQubits; ops holds up to 3 G.
__device__ void build_schedule(const Tape& tape, int G, int n, int RB,
                               int top, int* after, int* work, int2* ops,
                               int* map0, int* map1, int* nops) {
  const int lanes = n - RB < 5 ? n - RB : 5;
  int* first = work;
  int* occ = work + kMaxQubits;
  int* pos = work + 2 * kMaxQubits;
  int* nu = work + 3 * kMaxQubits;
  for (int q = 0; q < n; ++q) first[q] = G;
  for (int g = G - 1; g >= 0; --g) {
    if (tape.kind[g] == kNone) continue;
    const int t = tape.tq[g];
    after[g] = first[t];
    first[t] = g;
  }
  unsigned placed = 0;
  for (int a = 0; a < RB; ++a) {            // the first RB targets
    int best = -1;
    for (int q = lanes; q < n; ++q)
      if (!((placed >> q) & 1) && (best < 0 || first[q] < first[best]))
        best = q;
    occ[a] = best;
    placed |= 1u << best;
  }
  for (int l = 0; l < lanes; ++l) occ[RB + l] = l;
  unsigned late = 0;                        // the group bits' qubits
  for (int k = top; k < n; ++k) {
    int best = -1;
    for (int q = lanes; q < n; ++q)
      if (!(((placed | late) >> q) & 1) &&
          (best < 0 || first[q] >= first[best]))
        best = q;
    late |= 1u << best;
  }
  int w = RB + lanes;
  for (int q = lanes; q < n; ++q)
    if (!(((placed | late) >> q) & 1)) occ[w++] = q;
  for (int q = lanes; q < n; ++q)
    if ((late >> q) & 1) occ[w++] = q;
  for (int p = 0; p < n; ++p) {
    pos[occ[p]] = p;
    map0[p] = occ[p];
  }
  for (int q = 0; q < n; ++q) nu[q] = first[q];
  int c = 0;
  for (int g = 0; g < G; ++g) {
    const int k = tape.kind[g];
    if (k == kNone) continue;
    const int t = tape.tq[g], cq = tape.cq[g];
    if (pos[t] >= RB + lanes) {             // a warp bit: swap it in
      int a = 0;
      for (int b = 1; b < RB; ++b)
        if (nu[occ[b]] > nu[occ[a]]) a = b;
      const int b = pos[t];
      if (b >= top) {                       // a group bit: the coldest out
        int v = -1;
        for (int p = RB + lanes; p < top; ++p)
          if (v < 0 || nu[occ[p]] > nu[occ[v]]) v = p;
        if (v >= 0 && nu[occ[v]] > nu[occ[a]]) {
          const int qa = occ[a], qv = occ[v];
          ops[c++] = make_int2(kSwapOp | (a << 4) | ((v + 1) << 9), 0);
          occ[a] = qv;
          occ[v] = qa;
          pos[qv] = a;
          pos[qa] = v;
        }
      }
      const int qa = occ[a];
      ops[c++] = make_int2(kSwapOp | (a << 4) | ((b + 1) << 9) |
                               (b >= top ? kGroupSwap : 0),
                           0);
      occ[a] = t;
      occ[b] = qa;
      pos[t] = a;
      pos[qa] = b;
    }
    const bool grad =
        tape.slot[g] >= 0 && (k == kRX || k == kRY || k == kRZ);
    ops[c++] = make_int2(k | (pos[t] << 4) |
                             ((cq >= 0 ? pos[cq] + 1 : 0) << 9) |
                             (grad ? kGradBit : 0) |
                             (gate_case(k, cq >= 0, pos[t], RB) << 15),
                         g);
    nu[t] = after[g];
  }
  for (int p = 0; p < n; ++p) map1[p] = occ[p];
  *nops = c;
}

// Each group's flip as the xor it makes in the cluster kernel's storage of
// psi for H psi (amplitude j of thread t of a CTA at j * 256 + t) under
// the schedule's end map, the xor of the rank above bit 16, and bit 30 set
// where it reaches a group bit (from `top` up); by the thread that built
// the schedule.
__device__ void physical_flips(const RegShared& sh, int n_groups, int n,
                               int top) {
  constexpr int kLocal = (1 << kClusterBit) - 1;
  constexpr int kRegs = (1 << kRegBits) - 1;
  for (int f = 0; f < n_groups; ++f) {
    const int fl = sh.flips[f];
    int pf = 0;
    for (int b = 0; b < n; ++b)
      if ((fl >> sh.map1[b]) & 1) pf |= 1 << b;
    const int loc = pf & kLocal;
    sh.pflip[f] = ((loc & kRegs) << (kClusterBit - kRegBits)) |
                  (loc >> kRegBits) | ((pf >> kClusterBit) << 16) |
                  ((pf >> top) != 0 ? kFarFlip : 0);
  }
}

// Each gate's 2x2 entries at the iterate x into coef (the caller's next
// barrier publishes them).
__device__ __forceinline__ void gate_coefs(const RegShared& sh,
                                           const Tape& tape, const float* x,
                                           int G) {
#pragma unroll 1
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int k = tape.kind[g], sl = tape.slot[g];
    float s = 0.f, c = 1.f;
    if (sl >= 0) sincosf(0.5f * x[sl], &s, &c);
    const Coef u = gate_coef(k, c, s);
    sh.coef[2 * g] = make_float4(u.u00r, u.u00i, u.u01r, u.u01i);
    sh.coef[2 * g + 1] = make_float4(u.u10r, u.u10i, u.u11r, u.u11i);
  }
}

__device__ __forceinline__ Coef load_coef(const RegShared& sh, int g) {
  const float4 a = sh.coef[2 * g], b = sh.coef[2 * g + 1];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// Error kinds of every gate of `tape` at `tag` into err_t / err_c; the
// caller's next barrier publishes them.
__device__ __forceinline__ void draw_errors_reg(
    const RegShared& sh, const Tape& tape, int G,
    const int* __restrict__ seeds, int e, int tag, unsigned thr1,
    unsigned thr2) {
  const unsigned k0 = (unsigned)seeds[2 * e], k1 = (unsigned)seeds[2 * e + 1];
#pragma unroll 1
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    philox::error_kinds(tape.kind[g], g, tag, k0, k1, thr1, thr2,
                        sh.err_t[g], sh.err_c[g]);
}

// The ops of the schedule whose gate drew an error at this tag, ascending,
// then -1, into err_ops (warp 0, by ballots over 32 ops at a time; after
// the barrier that publishes err_t / err_c and the schedule, before the
// next one).  A sweep then compares each op with the next listed one
// instead of reading the error kinds of every gate.
__device__ __forceinline__ void list_errors(const RegShared& sh) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, nops = *sh.nops;
  int count = 0;
  for (int base = 0; base < nops; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < nops) {
      const int2 op = sh.ops[i];
      hit = op_kind(op.x) != kSwapOp &&
            (sh.err_t[op.y] != 0 || sh.err_c[op.y] != 0);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) sh.err_ops[count + __popc(ballot & ((1u << lane) - 1u))] = i;
    count += __popc(ballot);
  }
  if (lane == 0) sh.err_ops[count] = -1;
}

template <int RB>
__device__ __forceinline__ void load_psi0(Amps<RB>& s, const RegShared& sh,
                                          const float* __restrict__ p0re,
                                          const float* __restrict__ p0im,
                                          int n, const Cl& cl) {
  int idx[1 << RB];
  logical_indices<RB>(sh.map0, n, gt0(cl) + threadIdx.x, idx);
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    s.pr[j] = __ldg(p0re + idx[j]);
    s.pi[j] = __ldg(p0im + idx[j]);
  }
}

// One plane of a swap, out (trade) and in (take): the values v[k] this
// thread sends (those of pair k whose register bit A differs from its
// bit beta), as float4s: chunk c of plane q of thread t at float4
// (q * C + c) * T + t (conflict-free).
template <int P>
__device__ __forceinline__ void trade(const float (&v)[P], float4* b4,
                                      int q) {
  constexpr int C = P / 4;
  const int tid = threadIdx.x, T = blockDim.x;
#pragma unroll
  for (int c = 0; c < C; ++c)
    b4[(q * C + c) * T + tid] =
        make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

template <int P>
__device__ __forceinline__ void take(float (&v)[P], const float4* b4, int q,
                                     int partner) {
  constexpr int C = P / 4;
  const int T = blockDim.x;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 r = b4[(q * C + c) * T + partner];
    v[4 * c] = r.x;
    v[4 * c + 1] = r.y;
    v[4 * c + 2] = r.z;
    v[4 * c + 3] = r.w;
  }
}

// The sent half of one plane of register bit A, and its return.
template <int RB, int A>
__device__ __forceinline__ void sent_half(const float (&x)[1 << RB], int beta,
                                          float (&v)[1 << (RB - 1)]) {
#pragma unroll
  for (int k = 0; k < (1 << (RB - 1)); ++k) {
    const int j0 = pair_j0<A>(k), j1 = j0 | (1 << A);
    v[k] = beta ? x[j0] : x[j1];
  }
}

template <int RB, int A>
__device__ __forceinline__ void put_half(float (&x)[1 << RB], int beta,
                                         const float (&v)[1 << (RB - 1)]) {
#pragma unroll
  for (int k = 0; k < (1 << (RB - 1)); ++k) {
    const int j0 = pair_j0<A>(k), j1 = j0 | (1 << A);
    x[j0] = beta ? v[k] : x[j0];
    x[j1] = beta ? x[j1] : v[k];
  }
}

// The trade of register bit A with the thread bit tb (see swap_bits).
template <int RB, int A, bool kLambda>
__device__ __forceinline__ void reg_swap(Amps<RB>& s, int tb, float* buf) {
  constexpr int P = 1 << (RB - 1);
  const int tid = threadIdx.x;
  const int beta = (tid >> tb) & 1, partner = tid ^ (1 << tb);
  float4* b4 = reinterpret_cast<float4*>(buf);
  float v[P];
  sent_half<RB, A>(s.pr, beta, v);
  trade<P>(v, b4, 0);
  sent_half<RB, A>(s.pi, beta, v);
  trade<P>(v, b4, 1);
  if (kLambda) {
    sent_half<RB, A>(s.lr, beta, v);
    trade<P>(v, b4, 2);
    sent_half<RB, A>(s.li, beta, v);
    trade<P>(v, b4, 3);
  }
  __syncthreads();
  take<P>(v, b4, 0, partner);
  put_half<RB, A>(s.pr, beta, v);
  take<P>(v, b4, 1, partner);
  put_half<RB, A>(s.pi, beta, v);
  if (kLambda) {
    take<P>(v, b4, 2, partner);
    put_half<RB, A>(s.lr, beta, v);
    take<P>(v, b4, 3, partner);
    put_half<RB, A>(s.li, beta, v);
  }
}

// Swap register bit a with warp bit b through `buf` (2 D floats): each
// thread trades its amplitudes whose bit a differs from its own bit b with
// the partner thread across bit b (psi, and lambda with kLambda), staged
// by the pair's rank k.
template <int RB, bool kLambda>
__device__ __forceinline__ void swap_bits(Amps<RB>& s, int a, int b,
                                          float* buf) {
  WITH_REG_BIT(a, (reg_swap<RB, A, kLambda>(s, b - RB, buf)));
}

// The trade of register bit A with cluster bit cb: as reg_swap, with the
// partner the same thread of the CTA across bit cb, which takes the sent
// half into its own `buf` (2 D floats) through distributed shared memory.
template <int RB, int A, bool kLambda>
__device__ __forceinline__ void cluster_reg_swap(Amps<RB>& s, int cb,
                                                 const Cl& cl, float* buf) {
  constexpr int P = 1 << (RB - 1);
  const int beta = (cl.rank >> cb) & 1;
  float4* out = reinterpret_cast<float4*>(at_rank(buf, crank() ^ (1 << cb)));
  const float4* in = reinterpret_cast<const float4*>(buf);
  float v[P];
  sent_half<RB, A>(s.pr, beta, v);
  trade<P>(v, out, 0);
  sent_half<RB, A>(s.pi, beta, v);
  trade<P>(v, out, 1);
  if (kLambda) {
    sent_half<RB, A>(s.lr, beta, v);
    trade<P>(v, out, 2);
    sent_half<RB, A>(s.li, beta, v);
    trade<P>(v, out, 3);
  }
  cluster_sync();
  const int tid = threadIdx.x;
  take<P>(v, in, 0, tid);
  put_half<RB, A>(s.pr, beta, v);
  take<P>(v, in, 1, tid);
  put_half<RB, A>(s.pi, beta, v);
  if (kLambda) {
    take<P>(v, in, 2, tid);
    put_half<RB, A>(s.lr, beta, v);
    take<P>(v, in, 3, tid);
    put_half<RB, A>(s.li, beta, v);
  }
}

// -- the group kernel's exchange through global memory ----------------------

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
#if defined(__CUDA_ARCH__)
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return *static_cast<const volatile unsigned int*>(p);
#endif
}

// Spins a barrier waits at most (x 64 ns and more) before it traps: the
// launch puts on the card only as many starts as it can hold whole, so a
// wait this long is a residency fault, which fails the launch.
constexpr unsigned int kSpinLimit = 1u << 26;

// The start-wide barrier of the group kernel: every CTA of the start
// arrives on the slot's counter (release) and waits until all have
// (acquire), the pattern of a cooperative grid barrier, after which the
// CTA's loads see what the others stored before arriving; the counter
// only grows (generation g ends at g x C), so it is never reset within a
// launch.
__device__ __forceinline__ void group_sync(const Cl& cl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    GroupSh& g = group_sh();
    const unsigned int target = ++g.passed * (unsigned int)g.ctas;
    __threadfence();
    atomicAdd(g.bar, 1u);
    unsigned int spins = 0;
    while (ld_acquire(g.bar) < target) {
      if (++spins == kSpinLimit) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The areas of a start slot's exchange (floats, for C CTAs of D
// amplitudes): C inboxes of 4 D (a swap's two buffers of 2 D, or the 4 D
// of a Pauli's whole-slice exchange), C slices of psi for H psi (2 D,
// float2), C energy partials (2 doubles), C x R gradient partials, a flag.
__host__ __device__ __forceinline__ size_t group_area_floats(int C, int D,
                                                             int R) {
  return ((size_t)C * (6 * (size_t)D + 4 + R) + 4 + 3) & ~(size_t)3;
}
// (offsets in 32 bits: under 2^22 floats at 18 qubits)
__device__ __forceinline__ float* inbox(int r, int D) {
  return group_sh().xg + r * 4 * D;
}
__device__ __forceinline__ float2* group_psi(int C, int D) {
  return reinterpret_cast<float2*>(group_sh().xg + C * 4 * D);
}
__device__ __forceinline__ double* group_red(int C, int D) {
  return reinterpret_cast<double*>(group_sh().xg + C * 6 * D);
}
__device__ __forceinline__ float* group_dx(int C, int D) {
  return group_sh().xg + C * (6 * D + 4);
}
__device__ __forceinline__ int* group_flag(int C, int D, int R) {
  return reinterpret_cast<int*>(group_dx(C, D) + C * R);
}

// The trade of register bit A with group bit gb (a bit of the rank above
// the cluster bits): as cluster_reg_swap, through the partner CTA's inbox
// in global memory (buffer `parity`) and one start-wide barrier.
template <int RB, int A, bool kLambda>
__device__ __forceinline__ void group_reg_swap(Amps<RB>& s, int gb,
                                               const Cl& cl, int D,
                                               int parity) {
  constexpr int P = 1 << (RB - 1);
  const int beta = (cl.rank >> gb) & 1;
  float4* out = reinterpret_cast<float4*>(
      inbox(cl.rank ^ (1 << gb), D) + parity * 2 * D);
  const float4* in =
      reinterpret_cast<const float4*>(inbox(cl.rank, D) + parity * 2 * D);
  float v[P];
  sent_half<RB, A>(s.pr, beta, v);
  trade<P>(v, out, 0);
  sent_half<RB, A>(s.pi, beta, v);
  trade<P>(v, out, 1);
  if (kLambda) {
    sent_half<RB, A>(s.lr, beta, v);
    trade<P>(v, out, 2);
    sent_half<RB, A>(s.li, beta, v);
    trade<P>(v, out, 3);
  }
  group_sync(cl);
  const int tid = threadIdx.x;
  take<P>(v, in, 0, tid);
  put_half<RB, A>(s.pr, beta, v);
  take<P>(v, in, 1, tid);
  put_half<RB, A>(s.pi, beta, v);
  if (kLambda) {
    take<P>(v, in, 2, tid);
    put_half<RB, A>(s.lr, beta, v);
    take<P>(v, in, 3, tid);
    put_half<RB, A>(s.li, beta, v);
  }
}

// Pauli k on group bit gb: as cluster_pauli, the X or Y exchange through
// the partner's inbox (4 D floats) and start-wide barriers.
template <int RB, bool kAdjoint>
__device__ __forceinline__ void group_pauli(Amps<RB>& s, int k, int gb,
                                            const Cl& cl, int D) {
  constexpr int J = 1 << RB;
  const int beta = (cl.rank >> gb) & 1;
  if (k == kZ) {
    if (beta) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s.pr[j] = -s.pr[j];
        s.pi[j] = -s.pi[j];
        if (kAdjoint) {
          s.lr[j] = -s.lr[j];
          s.li[j] = -s.li[j];
        }
      }
    }
    return;
  }
  float4* out = reinterpret_cast<float4*>(inbox(cl.rank ^ (1 << gb), D));
  const float4* in = reinterpret_cast<const float4*>(inbox(cl.rank, D));
  group_sync(cl);                      // the last exchange's reads are done
  trade<J>(s.pr, out, 0);
  trade<J>(s.pi, out, 1);
  if (kAdjoint) {
    trade<J>(s.lr, out, 2);
    trade<J>(s.li, out, 3);
  }
  group_sync(cl);
  const int tid = threadIdx.x;
  float qr[J], qi[J];
  take<J>(qr, in, 0, tid);
  take<J>(qi, in, 1, tid);
#pragma unroll
  for (int j = 0; j < J; ++j) pauli_one<false>(k, beta, s.pr[j], s.pi[j],
                                               qr[j], qi[j]);
  if (kAdjoint) {
    take<J>(qr, in, 2, tid);
    take<J>(qi, in, 3, tid);
#pragma unroll
    for (int j = 0; j < J; ++j) pauli_one<true>(k, beta, s.lr[j], s.li[j],
                                                qr[j], qi[j]);
  }
  group_sync(cl);                      // ... and this one's
}

// A swap op of the schedule: register bit a with the warp bit b through
// the CTA's `region` (buffer `parity`), or, in the cluster kernel, with
// the cluster bit b through the partner's `cbuf` (buffer `cparity`), or,
// in the group kernel, with the group bit b through the partner's inbox
// in global memory (buffer `gparity`).  The kinds keep their own double
// buffers: a CTA may run on to its next warp swap while its partner still
// reads the last cluster swap, and to its next cluster swap while a CTA
// of another cluster still reads the last group swap.
template <int RB, bool kCl, bool kGrp, bool kLambda>
__device__ __forceinline__ void swap_op(Amps<RB>& s, const RegShared& sh,
                                        int x, int D, const Cl& cl,
                                        int& parity, int& cparity,
                                        int& gparity) {
  const int a = op_p(x), b = op_q(x);
  if (kGrp && (x & kGroupSwap)) {
    WITH_REG_BIT(a, (group_reg_swap<RB, A, kLambda>(
                        s, b - kClusterBit, cl, D, gparity)));
    gparity ^= 1;
    return;
  }
  if (kCl && b >= kClusterBit) {
    float* buf = sh.cbuf + cparity * 2 * D;
    WITH_REG_BIT(a, (cluster_reg_swap<RB, A, kLambda>(
                        s, b - kClusterBit, cl, buf)));
    cparity ^= 1;
    return;
  }
  swap_bits<RB, kLambda>(s, a, b, sh.region + parity * 2 * D);
  parity ^= 1;
}

// Pauli k on cluster bit cb: Z a sign on the CTA whose rank bit is set; X
// and Y the whole slice (psi, and lambda with kAdjoint) exchanged with the
// partner CTA through its `cbuf` (4 D floats, both swap buffers: cluster
// barriers before and after, as pauli's around a warp bit's exchange).
template <int RB, bool kAdjoint>
__device__ __forceinline__ void cluster_pauli(Amps<RB>& s, int k, int cb,
                                              const RegShared& sh,
                                              const Cl& cl) {
  constexpr int J = 1 << RB;
  const int beta = (cl.rank >> cb) & 1;
  if (k == kZ) {
    if (beta) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s.pr[j] = -s.pr[j];
        s.pi[j] = -s.pi[j];
        if (kAdjoint) {
          s.lr[j] = -s.lr[j];
          s.li[j] = -s.li[j];
        }
      }
    }
    return;
  }
  float4* out = reinterpret_cast<float4*>(at_rank(sh.cbuf,
                                                  crank() ^ (1 << cb)));
  const float4* in = reinterpret_cast<const float4*>(sh.cbuf);
  cluster_sync();                         // the last exchange's reads are done
  trade<J>(s.pr, out, 0);
  trade<J>(s.pi, out, 1);
  if (kAdjoint) {
    trade<J>(s.lr, out, 2);
    trade<J>(s.li, out, 3);
  }
  cluster_sync();
  const int tid = threadIdx.x;
  float qr[J], qi[J];
  take<J>(qr, in, 0, tid);
  take<J>(qi, in, 1, tid);
#pragma unroll
  for (int j = 0; j < J; ++j) pauli_one<false>(k, beta, s.pr[j], s.pi[j],
                                               qr[j], qi[j]);
  if (kAdjoint) {
    take<J>(qr, in, 2, tid);
    take<J>(qi, in, 3, tid);
#pragma unroll
    for (int j = 0; j < J; ++j) pauli_one<true>(k, beta, s.lr[j], s.li[j],
                                                qr[j], qi[j]);
  }
  cluster_sync();                         // ... and this one's
}

// Pauli k on physical bit `pos` of any kernel (see pauli).
template <int RB, bool kCl, bool kGrp, bool kAdjoint>
__device__ __forceinline__ void any_pauli(Amps<RB>& s, int k, int pos,
                                          const RegShared& sh, int D,
                                          unsigned mask, const Cl& cl) {
  if (kGrp && pos >= kClusterBit + group_sh().cbits) {
    group_pauli<RB, kAdjoint>(s, k, pos - kClusterBit, cl, D);
    return;
  }
  if (kCl && pos >= kClusterBit) {
    cluster_pauli<RB, kAdjoint>(s, k, pos - kClusterBit, sh, cl);
    return;
  }
  pauli<RB, kAdjoint>(s, k, pos, sh.region, D, mask);
}

// Whether this CTA runs a gate whose control sits on physical bit q, and
// the case it runs: a control on a cluster bit is CTA-uniform, so the CTA
// whose rank bit is set runs the gate uncontrolled and the other skips it.
template <bool kCl>
__device__ __forceinline__ bool gate_runs(int& c, int q, const Cl& cl) {
  if (!kCl || q < kClusterBit) return true;
  c -= 5;                                 // gate_case without the control
  return (cl.rank >> (q - kClusterBit)) & 1;
}

// psi <- tape(x) psi along the schedule, each gate followed by its drawn
// errors in the noise variant.  The next op and its entries are read
// before the current one runs.
template <int RB, bool kCl, bool kGrp>
__device__ __forceinline__ void forward_reg(Amps<RB>& s, const RegShared& sh,
                                            int D, bool noise, unsigned mask,
                                            const Cl& cl) {
  const int nops = *sh.nops;
  int parity = 0, cparity = 0, gparity = 0;
  int2 next = nops > 0 ? sh.ops[0] : make_int2(kSwapOp, 0);
  Coef next_u = load_coef(sh, next.y);
  int e_at = 0;                           // the next listed error op
  int e_op = noise ? sh.err_ops[0] : -1;
  for (int i = 0; i < nops; ++i) {
    const int2 op = next;
    const Coef u = next_u;
    if (i + 1 < nops) {
      next = sh.ops[i + 1];
      next_u = load_coef(sh, next.y);
    }
    const int k = op_kind(op.x), p = op_p(op.x), q = op_q(op.x);
    if (k == kSwapOp) {
      swap_op<RB, kCl, kGrp, false>(s, sh, op.x, D, cl, parity, cparity,
                                    gparity);
      continue;
    }
    int c = op_case(op.x);
    if (gate_runs<kCl>(c, q, cl)) gate_fwd<RB>(s, u, c, p, q, mask);
    if (i == e_op) {                      // block-uniform
      const int et = sh.err_t[op.y], ec = sh.err_c[op.y];
      // no control: the error falls on qubit 0, a lane bit for good
      if (et) pauli<RB, false>(s, et, p, sh.region, D, mask);
      if (ec)
        any_pauli<RB, kCl, kGrp, false>(s, ec, q >= 0 ? q : RB, sh, D, mask,
                                        cl);
      e_op = sh.err_ops[++e_at];
    }
  }
}

// lambda <- 2 conj(H psi) for this thread's amplitudes; scal[0] <-
// Re<psi|H psi> / <psi|psi>.  psi goes to `region` at logical indices
// under map1 (the map the schedule ends on), re and im side by side (one
// 64-bit load a partner).  The W planes are read from L2; a group whose
// imaginary plane is zero (wim_any[f] == 0: every group of a real
// Hamiltonian) reads only its real plane.
template <int RB>
__device__ __forceinline__ void h_energy_reg(Amps<RB>& s, const RegShared& sh,
                                             const float* __restrict__ wre,
                                             const float* __restrict__ wim,
                                             int n_groups, int n,
                                             unsigned mask) {
  constexpr int J = 1 << RB;
  const int tid = threadIdx.x, T = blockDim.x, D = T << RB;
  int idx[J];
  logical_indices<RB>(sh.map1, n, tid, idx);
  float2* x2 = reinterpret_cast<float2*>(sh.region);
  __syncthreads();                        // the last swap's reads are done
#pragma unroll
  for (int j = 0; j < J; ++j) {
    x2[idx[j]] = make_float2(s.pr[j], s.pi[j]);
    s.lr[j] = 0.f;
    s.li[j] = 0.f;
  }
  __syncthreads();
  for (int f = 0; f < n_groups; ++f) {
    const int fl = sh.flips[f];
    const float* wr = wre + (size_t)f * D;
    if (sh.wim_any[f]) {
      const float* wi = wim + (size_t)f * D;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float a = __ldg(wr + idx[j]), b = __ldg(wi + idx[j]);
        const float2 p = x2[idx[j] ^ fl];
        s.lr[j] = fmaf(a, p.x, s.lr[j]);
        s.lr[j] = fmaf(-b, p.y, s.lr[j]);
        s.li[j] = fmaf(a, p.y, s.li[j]);
        s.li[j] = fmaf(b, p.x, s.li[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float a = __ldg(wr + idx[j]);
        const float2 p = x2[idx[j] ^ fl];
        s.lr[j] = fmaf(a, p.x, s.lr[j]);
        s.li[j] = fmaf(a, p.y, s.li[j]);
      }
    }
  }
  double raw = 0.0, nn = 0.0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float pr = s.pr[j], pi = s.pi[j];
    raw += (double)pr * s.lr[j] + (double)pi * s.li[j];
    nn += (double)pr * pr + (double)pi * pi;
    s.lr[j] = 2.f * s.lr[j];
    s.li[j] = -2.f * s.li[j];
  }
  const int width = T < 32 ? T : 32, warps = (T + 31) >> 5;
  raw = warp_sum(raw, mask, width);
  nn = warp_sum(nn, mask, width);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    sh.red[2 * warp] = raw;
    sh.red[2 * warp + 1] = nn;
  }
  __syncthreads();
  if (tid == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < warps; ++w) {
      a += sh.red[2 * w];
      b += sh.red[2 * w + 1];
    }
    sh.scal[0] = (float)(a / b);
  }
  __syncthreads();
}

// W_f psi[i ^ f] added into lambda for group f, psi read from `src` at
// the storage xor fx (this CTA's or another's slice, in shared or global
// memory).
template <int RB>
__device__ __forceinline__ void h_group(Amps<RB>& s, const float2* src,
                                        int fx, const float* wr,
                                        const float* wi,
                                        const int (&idx)[1 << RB]) {
  constexpr int J = 1 << RB;
  const int tid = threadIdx.x, T = blockDim.x;
  if (wi != nullptr) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float a = __ldg(wr + idx[j]), b = __ldg(wi + idx[j]);
      const float2 p = src[(j * T + tid) ^ fx];
      s.lr[j] = fmaf(a, p.x, s.lr[j]);
      s.lr[j] = fmaf(-b, p.y, s.lr[j]);
      s.li[j] = fmaf(a, p.y, s.li[j]);
      s.li[j] = fmaf(b, p.x, s.li[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float a = __ldg(wr + idx[j]);
      const float2 p = src[(j * T + tid) ^ fx];
      s.lr[j] = fmaf(a, p.x, s.lr[j]);
      s.li[j] = fmaf(a, p.y, s.li[j]);
    }
  }
}

// The cluster and group kernels' H psi: lambda <- 2 conj(H psi) for this
// thread's amplitudes, scal[0] <- Re<psi|H psi> / <psi|psi>, in every CTA
// of the start.  Each CTA puts its slice of psi in `region` (amplitude j
// of thread t at j * T + t: a warp's lanes on consecutive float2s), one
// cluster barrier publishes the slices, and psi[i ^ f] is read at the
// group's storage xor (pflip) in this CTA or, where f flips a cluster bit,
// in the CTA of rank `rank ^ (pflip >> 16)`.  In the group kernel, where a
// flip reaches a group bit, the slices also go to global memory (one
// start-wide barrier) and such a group reads the partner's there, from
// L2.  W is read from L2 at the logical indices (stride 2^n).  The CTA's
// energy partials (the register kernel's fixed order) go to every CTA's
// `cred` (the group kernel: to global memory, one start-wide barrier);
// each CTA sums them in rank order.
template <int RB, bool kGrp>
__device__ __forceinline__ void h_energy_cl(Amps<RB>& s, const RegShared& sh,
                                            const float* __restrict__ wre,
                                            const float* __restrict__ wim,
                                            int n_groups, int n, int C,
                                            unsigned mask, const Cl& cl) {
  constexpr int J = 1 << RB;
  const int tid = threadIdx.x, T = blockDim.x, D = T << RB;
  const size_t dim = (size_t)1 << n;
  int idx[J];
  logical_indices<RB>(sh.map1, n, gt0(cl) + tid, idx);
  float2* x2 = reinterpret_cast<float2*>(sh.region);
  // the group kernel: whether a flip reaches a group bit
  bool remote = false;
  if (kGrp)
    for (int f = 0; f < n_groups; ++f)
      remote |= (sh.pflip[f] & kFarFlip) != 0;
  float2* gx = kGrp ? group_psi(C, D) : nullptr;
  __syncthreads();                        // the last warp swap's reads are done
#pragma unroll
  for (int j = 0; j < J; ++j) {
    x2[j * T + tid] = make_float2(s.pr[j], s.pi[j]);
    if (kGrp && remote)
      gx[cl.rank * D + j * T + tid] = make_float2(s.pr[j], s.pi[j]);
    s.lr[j] = 0.f;
    s.li[j] = 0.f;
  }
  cluster_sync();                         // every CTA's slice is in place
  if (kGrp && remote) group_sync(cl);
  for (int f = 0; f < n_groups; ++f) {
    const int pf = sh.pflip[f];
    const int fx = pf & 0xffff, fr = (pf & ~kFarFlip) >> 16;
    const float* wr = wre + (size_t)f * dim;
    const float* wi = sh.wim_any[f] ? wim + (size_t)f * dim : nullptr;
    const float2* src = kGrp && (pf & kFarFlip) ? gx + (cl.rank ^ fr) * D
                        : fr ? at_rank(x2, crank() ^ fr) : x2;
    h_group<RB>(s, src, fx, wr, wi, idx);
  }
  double raw = 0.0, nn = 0.0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float pr = s.pr[j], pi = s.pi[j];
    raw += (double)pr * s.lr[j] + (double)pi * s.li[j];
    nn += (double)pr * pr + (double)pi * pi;
    s.lr[j] = 2.f * s.lr[j];
    s.li[j] = -2.f * s.li[j];
  }
  const int warps = T >> 5;
  raw = warp_sum(raw, mask, 32);
  nn = warp_sum(nn, mask, 32);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    sh.red[2 * warp] = raw;
    sh.red[2 * warp + 1] = nn;
  }
  __syncthreads();
  double* gred = kGrp ? group_red(C, D) : nullptr;
  if (tid == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < warps; ++w) {
      a += sh.red[2 * w];
      b += sh.red[2 * w + 1];
    }
    if (kGrp) {
      gred[2 * cl.rank] = a;
      gred[2 * cl.rank + 1] = b;
    } else {
      for (int c = 0; c < C; ++c) {
        double* to = at_rank(sh.cred, c);
        to[2 * cl.rank] = a;
        to[2 * cl.rank + 1] = b;
      }
    }
  }
  // every rank's partials are in (and, the group kernel, every CTA's
  // reads of the others' slices done)
  if (kGrp) group_sync(cl); else cluster_sync();
  if (tid == 0) {
    double a = 0.0, b = 0.0;
    for (int c = 0; c < C; ++c) {
      a += kGrp ? gred[2 * c] : sh.cred[2 * c];
      b += kGrp ? gred[2 * c + 1] : sh.cred[2 * c + 1];
    }
    sh.scal[0] = (float)(a / b);
  }
  __syncthreads();
}

// Adjoint sweep: the schedule backwards; each gate's drawn errors are
// undone first in the noise variant; lane 0 of each warp writes the warp's
// part of gate g's gradient row to gpart[g * warps + warp].  The next op
// and its entries are read before the current one runs.
template <int RB, bool kCl, bool kGrp>
__device__ __forceinline__ void backward_reg(Amps<RB>& s, const RegShared& sh,
                                             int D, bool noise, unsigned mask,
                                             const Cl& cl) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int width = T < 32 ? T : 32, warps = (T + 31) >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int nops = *sh.nops;
  int parity = 0, cparity = 0, gparity = 0;
  int2 next = nops > 0 ? sh.ops[nops - 1] : make_int2(kSwapOp, 0);
  Coef next_u = load_coef(sh, next.y);
  int e_at = 0;                           // the last listed error op
  if (noise)
    while (sh.err_ops[e_at] >= 0) ++e_at;
  int e_op = e_at > 0 ? sh.err_ops[--e_at] : -1;
  for (int i = nops - 1; i >= 0; --i) {
    const int2 op = next;
    const Coef u = next_u;
    if (i > 0) {
      next = sh.ops[i - 1];
      next_u = load_coef(sh, next.y);
    }
    const int k = op_kind(op.x), p = op_p(op.x), q = op_q(op.x);
    if (k == kSwapOp) {
      swap_op<RB, kCl, kGrp, true>(s, sh, op.x, D, cl, parity, cparity,
                                   gparity);
      continue;
    }
    if (i == e_op) {                      // block-uniform
      const int et = sh.err_t[op.y], ec = sh.err_c[op.y];
      if (et) pauli<RB, true>(s, et, p, sh.region, D, mask);
      if (ec)
        any_pauli<RB, kCl, kGrp, true>(s, ec, q >= 0 ? q : RB, sh, D, mask,
                                       cl);
      e_op = e_at > 0 ? sh.err_ops[--e_at] : -1;
    }
    int c = op_case(op.x);
    float gp = 0.f;
    if (gate_runs<kCl>(c, q, cl)) gp = gate_adj<RB>(s, u, c, p, q, mask);
    if (op.x & kGradBit) {                // block-uniform branch
      if (width == 32) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          gp += __shfl_xor_sync(0xffffffffu, gp, off);
      } else {
        gp = warp_sum(gp, mask, width);
      }
      if (lane == 0) sh.gpart[op.y * warps + warp] = gp;
    }
  }
}

// Keep the better of (x, E) and (bx, best E).
__device__ __forceinline__ void track_best_reg(const RegShared& sh, int R) {
  const bool better = sh.scal[0] < sh.scal[1];
  if (better)
#pragma unroll 1
    for (int r = threadIdx.x; r < R; r += blockDim.x) sh.bx[r] = sh.x[r];
  __syncthreads();
  if (threadIdx.x == 0 && better) sh.scal[1] = sh.scal[0];
  __syncthreads();
}

// Ops a schedule may hold (up to 3 a gate: a warp or cluster swap, a group
// swap and the gate), even, so that what follows stays 16-byte aligned.
__host__ __device__ __forceinline__ int ops_capacity(int G) {
  return (3 * G + 1) & ~1;
}

// CTAs of one start: 1 in the register kernel, 2^(n - 12) in the cluster
// and group kernels.
int start_ctas(int n) {
  return n <= kRegMaxQubits ? 1 : 1 << (n - kClusterBit);
}

// Whether the group kernel runs n qubits.
bool in_group_band(int n) { return n > kClusterMaxQubits; }

// CTAs of one cluster: 1 in the register kernel, a start in the cluster
// kernel, `group_cluster` (kGroupCluster when 0) in the group kernel.
int cluster_size(int n, int group_cluster) {
  if (!in_group_band(n)) return start_ctas(n);
  return group_cluster > 0 ? group_cluster : kGroupCluster;
}

size_t reg_smem_bytes(int G, int R, int n, int n_groups, bool noise) {
  const int C = start_ctas(n);
  const size_t D = ((size_t)1 << n) / C;  // amplitudes a CTA holds
  const size_t warps = ((D >> kRegBits) + 31) / 32;
  // the group kernel sums over the start in global memory
  const size_t sums = in_group_band(n) ? 0 : (size_t)C * R;
  const size_t cl = C > 1 ? sizeof(double) * 2 * kMaxCluster +
                                sizeof(float) * (4 * D + sums) +
                                sizeof(int) * n_groups
                          : 0;
  const size_t group = in_group_band(n) ? kGroupShBytes : 0;
  return sizeof(double) * 2 * kRegWarps + sizeof(float4) * 2 * G +
         sizeof(int2) * ops_capacity(G) + sizeof(float) * 4 * D +
         sizeof(float) * (4 * (size_t)R + 2 + G * warps) +
         sizeof(int) * ((size_t)(noise ? 13 : 9) * G + (noise ? 1 : 0) +
                        2 * R + 2 * n_groups + 2 +
                        6 * kMaxQubits + 1) +
         cl + group;
}

// The register kernel (kCl false: one CTA a start), the cluster kernel
// (kCl true: a start is the cluster of C CTAs this CTA belongs to) and the
// group kernel (kGrp true as well: a start of C CTAs in clusters of
// 2^cbits), for start `row` = e * S + s; see the header.  In the
// cluster and group kernels every CTA keeps its own copy of the iterate,
// Adam's moments and the best iterate, and takes the same steps.
// The first group bit: n (none) outside the group kernel.
template <bool kGrp>
__device__ __forceinline__ int first_group_bit(int n) {
  return kGrp ? kClusterBit + group_sh().cbits : n;
}

template <int RB, bool kCl, bool kGrp>
__device__ __forceinline__ void fused_adam_v2_body(
    unsigned char* smem_reg, int row0, int step, int rows, const Cl& cl,
    Tape old_g, Tape new_g,
    const int* __restrict__ map_idx, const float* __restrict__ p0re,
    const float* __restrict__ p0im, const float* __restrict__ wre,
    const float* __restrict__ wim, const int* __restrict__ flips,
    const int* __restrict__ wim_any, const float* __restrict__ starts,
    const float* __restrict__ active, const int* __restrict__ seeds,
    float* __restrict__ x_opt, float* __restrict__ e_new, float* best_x,
    float* best_e, unsigned int* arrived, int S, int G, int R, int n,
    int n_groups, int psi0_stride, int iters, float lr, double b1, double b2,
    float omb1, float omb2, float eps, unsigned thr1, unsigned thr2) {
  const bool noise = seeds != nullptr;
  const int tid = threadIdx.x, T = blockDim.x;
  const int D = T << RB;                  // amplitudes a CTA holds
  const int warps = (T + 31) >> 5;
  const unsigned mask = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
  const int C = kCl ? 1 << (n - kClusterBit) : 1;   // CTAs a start
  const bool lead = cl.rank == 0;         // writes the start's results
  RegShared sh;
  unsigned char* b = smem_reg;
  sh.red = reinterpret_cast<double*>(b);
  b += sizeof(double) * 2 * kRegWarps;
  sh.cred = reinterpret_cast<double*>(b);
  b += kCl ? sizeof(double) * 2 * kMaxCluster : 0;
  sh.coef = reinterpret_cast<float4*>(b);
  b += sizeof(float4) * 2 * G;
  sh.ops = reinterpret_cast<int2*>(b);
  b += sizeof(int2) * ops_capacity(G);
  float* f = reinterpret_cast<float*>(b);
  sh.region = f; f += 4 * D;
  sh.cbuf = f; f += kCl ? 4 * D : 0;
  sh.x = f; f += R;
  sh.m = f; f += R;
  sh.v = f; f += R;
  sh.bx = f; f += R;
  sh.scal = f; f += 2;
  sh.gpart = f; f += G * warps;
  sh.cdx = f; f += kCl && !kGrp ? C * R : 0;
  int* ip = reinterpret_cast<int*>(f);
  int* tapes[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) { tapes[a] = ip; ip += G; }
  sh.old_tape = {tapes[0], tapes[1], tapes[2], tapes[3]};
  sh.new_tape = {tapes[4], tapes[5], tapes[6], tapes[7]};
  sh.map = ip; ip += R;
  sh.flips = ip; ip += n_groups;
  sh.wim_any = ip; ip += n_groups;
  sh.flag = ip; ip += 2;
  sh.err_t = ip; ip += noise ? G : 0;
  sh.err_c = ip; ip += noise ? G : 0;
  sh.err_ops = ip; ip += noise ? 2 * G + 1 : 0;
  sh.slot_first = ip; ip += R;
  sh.gate_next = ip; ip += G;
  sh.map0 = ip; ip += kMaxQubits;
  sh.map1 = ip; ip += kMaxQubits;
  sh.sched = ip; ip += 4 * kMaxQubits;
  sh.nops = ip; ip += 1;
  sh.pflip = ip;

  // one start after another: slot w of the group kernel runs starts w,
  // w + step, ... below rows; the other kernels run start row0 alone
  int row = row0;
  do {
    const int e = row / S;
    const float* p0r = p0re + (size_t)e * psi0_stride;   // this env's psi0
    const float* p0i = p0im + (size_t)e * psi0_stride;
    const int* src[8] = {old_g.kind, old_g.tq, old_g.cq, old_g.slot,
                         new_g.kind, new_g.tq, new_g.cq, new_g.slot};
#pragma unroll
    for (int a = 0; a < 8; ++a)           // constant indices: no stack
      for (int g = tid; g < G; g += T)
        tapes[a][g] = src[a][(size_t)e * G + g];
    // the other loops over a CTA's threads stay rolled (one pass or two
    // at the shapes here): unrolled, their trip counts were kept in
    // registers across the group kernel's starts, and spilled
#pragma unroll 1
    for (int r = tid; r < R; r += T) {
      sh.map[r] = map_idx[(size_t)e * R + r];
      const float x0 = starts[(size_t)row * R + r];
      sh.x[r] = x0;
      sh.bx[r] = x0;
      sh.m[r] = 0.f;
      sh.v[r] = 0.f;
    }
#pragma unroll 1
    for (int q = tid; q < n_groups; q += T) {
      sh.flips[q] = flips[q];
      sh.wim_any[q] = wim_any[q];
    }
    if (tid == 0) sh.scal[1] = INFINITY;
    __syncthreads();
    // the gates whose gradient feeds each angle, last gate first
#pragma unroll 1
    for (int r = tid; r < R; r += T) {
      int head = -1;
      for (int g = 0; g < G; ++g) {
        const int k = sh.old_tape.kind[g];
        if (sh.old_tape.slot[g] == r && (k == kRX || k == kRY || k == kRZ)) {
          sh.gate_next[g] = head;
          head = g;
        }
      }
      sh.slot_first[r] = head;
    }
    if (tid == 0) {
      build_schedule(sh.old_tape, G, n, RB, first_group_bit<kGrp>(n),
                     reinterpret_cast<int*>(sh.gpart), sh.sched, sh.ops,
                     sh.map0, sh.map1, sh.nops);
      if (kCl) physical_flips(sh, n_groups, n, first_group_bit<kGrp>(n));
    }
    // in the cluster kernel also: every CTA of the cluster runs before any
    // reaches into another's shared memory
    if constexpr (kCl) cluster_sync(); else __syncthreads();

    Amps<RB> s;
    // b^t as a running product in double from the exact rates: the bias
    // corrections are then the plain version's 1 - b^t rounded once to
    // float (1.f - powf(0.999f, t) is off by 1.3e-5 relative at t = 1,
    // since 0.999f = 0.99900001)
    double b1t = 1.0, b2t = 1.0;
    const float b1f = (float)b1, b2f = (float)b2;
    for (int it = 0; it < iters; ++it) {
      if (noise) draw_errors_reg(sh, sh.old_tape, G, seeds, e, it, thr1, thr2);
      gate_coefs(sh, sh.old_tape, sh.x, G);
      __syncthreads();
      if (noise) {
        list_errors(sh);
        __syncthreads();
      }
      load_psi0<RB>(s, sh, p0r, p0i, n, cl);
      forward_reg<RB, kCl, kGrp>(s, sh, D, noise, mask, cl);
      if constexpr (kCl)
        h_energy_cl<RB, kGrp>(s, sh, wre, wim, n_groups, n, C, mask, cl);
      else
        h_energy_reg<RB>(s, sh, wre, wim, n_groups, n, mask);
      track_best_reg(sh, R);
      backward_reg<RB, kCl, kGrp>(s, sh, D, noise, mask, cl);
      __syncthreads();
      if constexpr (kCl) {
        // this CTA's gradient rows (the register kernel's order), to every
        // CTA of the cluster (the group kernel: to global memory)
        float* gdx = kGrp ? group_dx(C, D) : nullptr;
#pragma unroll 1
        for (int r = tid; r < R; r += T) {
          float dx = 0.f;
          for (int g = sh.slot_first[r]; g >= 0; g = sh.gate_next[g]) {
            float acc = 0.f;
            for (int w = 0; w < warps; ++w) acc += sh.gpart[g * warps + w];
            dx += acc;
          }
          if (kGrp)
            gdx[cl.rank * R + r] = dx;
          else
            for (int c = 0; c < C; ++c)
              at_rank(sh.cdx, c)[cl.rank * R + r] = dx;
        }
        if (kGrp) group_sync(cl); else cluster_sync();
      }
      b1t *= b1;
      b2t *= b2;
      const float bc1 = (float)(1.0 - b1t);
      const float bc2 = (float)(1.0 - b2t);
#pragma unroll 1
      for (int r = tid; r < R; r += T) {
        float dx = 0.f;
        if constexpr (kGrp) {
          const float* gdx = group_dx(C, D);
          for (int c = 0; c < C; ++c) dx += gdx[c * R + r];
        } else if constexpr (kCl) {
          for (int c = 0; c < C; ++c) dx += sh.cdx[c * R + r];
        } else {
          for (int g = sh.slot_first[r]; g >= 0; g = sh.gate_next[g]) {
            float acc = 0.f;
            for (int w = 0; w < warps; ++w) acc += sh.gpart[g * warps + w];
            dx += acc;
          }
        }
        const float gr = dx * active[(size_t)e * R + r];
        const float mm = b1f * sh.m[r] + omb1 * gr;
        const float vv = b2f * sh.v[r] + omb2 * gr * gr;
        const float mhat = mm / bc1;
        const float vhat = vv / bc2;
        sh.x[r] = sh.x[r] - lr * mhat / (sqrtf(vhat) + eps);
        sh.m[r] = mm;
        sh.v[r] = vv;
      }
      __syncthreads();
    }

    // the final iterate may beat the tracked best
    if (noise) draw_errors_reg(sh, sh.old_tape, G, seeds, e, iters, thr1, thr2);
    gate_coefs(sh, sh.old_tape, sh.x, G);
    __syncthreads();
    if (noise) {
      list_errors(sh);
      __syncthreads();
    }
    load_psi0<RB>(s, sh, p0r, p0i, n, cl);
    forward_reg<RB, kCl, kGrp>(s, sh, D, noise, mask, cl);
    if constexpr (kCl)
      h_energy_cl<RB, kGrp>(s, sh, wre, wim, n_groups, n, C, mask, cl);
    else
      h_energy_reg<RB>(s, sh, wre, wim, n_groups, n, mask);
    track_best_reg(sh, R);

    if (lead) {
#pragma unroll 1
      for (int r = tid; r < R; r += T) best_x[(size_t)row * R + r] = sh.bx[r];
      if (tid == 0) best_e[row] = sh.scal[1];
    }
    __threadfence();                        // publish before arriving
    __syncthreads();
    int* gflag = kGrp ? group_flag(C, D, R) : nullptr;
    if (tid == 0 && lead) {
      const int last = atomicAdd(&arrived[e], 1u) == (unsigned int)(S - 1);
      if constexpr (kGrp) {                 // the flag to every CTA
        *gflag = last;
      } else if constexpr (kCl) {
        for (int c = 0; c < C; ++c) at_rank(sh.flag, c)[0] = last;
      } else {
        sh.flag[0] = last;
      }
    }
    if constexpr (kGrp) {
      group_sync(cl);
      if (tid == 0) sh.flag[0] = *gflag;
      __syncthreads();
    } else if constexpr (kCl) {
      cluster_sync();
    } else {
      __syncthreads();
    }
    if (!sh.flag[0]) continue;

    // last start of env e: the other starts' results are visible (L1
    // bypassed)
    __threadfence();
    if (tid == 0) {                         // first minimum, as argmin
      int bs = 0;
      float be = __ldcg(best_e + (size_t)e * S);
      for (int s2 = 1; s2 < S; ++s2) {
        const float v = __ldcg(best_e + (size_t)e * S + s2);
        if (v < be) {
          be = v;
          bs = s2;
        }
      }
      sh.flag[1] = bs;
    }
    __syncthreads();
    const size_t best_row = (size_t)e * S + sh.flag[1];
#pragma unroll 1
    for (int r = tid; r < R; r += T) {
      const float xo = __ldcg(best_x + best_row * R + r);
      if (lead) x_opt[(size_t)e * R + r] = xo;
      sh.bx[r] = xo;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = tid; r < R; r += T) {
      const int mj = sh.map[r];
      sh.x[r] = mj >= 0 ? sh.bx[mj] : 0.f;  // x_new
    }
    __syncthreads();

    if (tid == 0) {
      build_schedule(sh.new_tape, G, n, RB, first_group_bit<kGrp>(n),
                     reinterpret_cast<int*>(sh.gpart), sh.sched, sh.ops,
                     sh.map0, sh.map1, sh.nops);
      if (kCl) physical_flips(sh, n_groups, n, first_group_bit<kGrp>(n));
    }
    if (noise)                              // a fresh realization for e_new
      draw_errors_reg(sh, sh.new_tape, G, seeds, e, iters + 1, thr1, thr2);
    gate_coefs(sh, sh.new_tape, sh.x, G);
    __syncthreads();
    if (noise) {
      list_errors(sh);
      __syncthreads();
    }
    load_psi0<RB>(s, sh, p0r, p0i, n, cl);
    forward_reg<RB, kCl, kGrp>(s, sh, D, noise, mask, cl);
    if constexpr (kCl)
      h_energy_cl<RB, kGrp>(s, sh, wre, wim, n_groups, n, C, mask, cl);
    else
      h_energy_reg<RB>(s, sh, wre, wim, n_groups, n, mask);
    if (tid == 0 && lead) e_new[e] = sh.scal[0];
  } while (kGrp && (row += step) < rows);
}

#define FUSED_ADAM_V2_PARAMS                                                 \
  Tape old_g, Tape new_g, const int* __restrict__ map_idx,                 \
      const float* __restrict__ p0re, const float* __restrict__ p0im,      \
      const float* __restrict__ wre, const float* __restrict__ wim,        \
      const int* __restrict__ flips, const int* __restrict__ wim_any,      \
      const float* __restrict__ starts, const float* __restrict__ active,  \
      const int* __restrict__ seeds, float* __restrict__ x_opt,            \
      float* __restrict__ e_new, float *best_x, float *best_e,             \
      unsigned int *arrived, int S, int G, int R, int n, int n_groups,     \
      int psi0_stride, int iters, float lr, double b1, double b2,          \
      float omb1, float omb2, float eps, unsigned thr1, unsigned thr2
#define FUSED_ADAM_V2_ARGS                                                   \
  old_g, new_g, map_idx, p0re, p0im, wre, wim, flips, wim_any, starts,     \
      active, seeds, x_opt, e_new, best_x, best_e, arrived, S, G, R, n,    \
      n_groups, psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1, thr2

// 7 <= n <= 12: one CTA of 2^(n - 4) threads a start, grid E x S.
template <int RB>
__global__ void __launch_bounds__(kRegThreads)
fused_adam_v2_reg_kernel(FUSED_ADAM_V2_PARAMS) {
  DYNAMIC_SHARED(smem_reg);
  const Cl cl = {0};
  fused_adam_v2_body<RB, false, false>(smem_reg, blockIdx.x, 1, 0, cl,
                                       FUSED_ADAM_V2_ARGS);
}

// 13 <= n <= 16: a cluster of 2^(n - 12) CTAs of 256 threads a start,
// grid E x S x 2^(n - 12), launched with the cluster dimension.
template <int RB>
__global__ void __launch_bounds__(kRegThreads, 1)
fused_adam_v2_cluster_kernel(FUSED_ADAM_V2_PARAMS) {
  DYNAMIC_SHARED(smem_cl);
  const int C = 1 << (n - kClusterBit);
  const int rank = (int)cg::this_cluster().block_rank();
  const Cl cl = {rank};
  fused_adam_v2_body<RB, true, false>(smem_cl, blockIdx.x / C, 1, 0, cl,
                                      FUSED_ADAM_V2_ARGS);
}

// 17 <= n <= 18: a start of 2^(n - 12) CTAs of 256 threads in clusters of
// the launch's cluster dimension; the grid holds `slots` starts (no more
// than the card holds at once, whole), and slot w runs starts w, w +
// slots, ... of the `rows` = E x S in order.  `xchg` holds each slot's
// exchange area, `arrived` the E env counters and then each slot's
// barrier counter.
template <int RB>
__global__ void __launch_bounds__(kRegThreads, 1)
fused_adam_v2_group_kernel(FUSED_ADAM_V2_PARAMS, float* xchg, int slots,
                           int rows) {
  DYNAMIC_SHARED(smem_grp);
  const int C = 1 << (n - kClusterBit);
  const int slot = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  GroupSh* gs = &group_sh();
  if (threadIdx.x == 0) {
    const int D = blockDim.x << RB;
    gs->xg = xchg + slot * group_area_floats(C, D, R);
    gs->bar = arrived + rows / S + slot;
    gs->passed = 0;
    gs->cbits = log2_of((int)cg::this_cluster().num_blocks());
    gs->ctas = C;
  }
  __syncthreads();
  const Cl cl = {rank};
  fused_adam_v2_body<RB, true, true>(smem_grp + kGroupShBytes, slot, slots,
                                     rows, cl, FUSED_ADAM_V2_ARGS);
}

size_t smem_bytes(int G, int R, int n, int n_groups, bool noise) {
  return reg_smem_bytes(G, R, n, n_groups, noise);
}

// The launch configuration of `clusters` clusters of C CTAs.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void cluster_config(ClusterLaunch& l, int clusters, int C, size_t bytes,
                    cudaStream_t stream) {
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(clusters * C, 1, 1);
  l.cfg.blockDim = dim3(kRegThreads, 1, 1);
  l.cfg.dynamicSmemBytes = bytes;
  l.cfg.stream = stream;
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = C;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 1;
}

// A cluster or group kernel's attributes for `bytes` of dynamic shared
// memory a CTA and clusters of C CTAs (more than 8 is a non-portable
// size).
template <class K>
cudaError_t cluster_attributes(K kernel, int C, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess || C <= 8) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <class K>
int occupancy(K kernel, int C, size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the attribute at the card's limit, so that the query, not the
  // attribute, judges `bytes`
  if (err == cudaSuccess) err = cluster_attributes(kernel, C, (size_t)optin);
  int clusters = 0;
  if (err == cudaSuccess) {
    ClusterLaunch l;
    cluster_config(l, 1, C, bytes, nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();                   // not sticky for the next launch
    return -(int)err;
  }
  return clusters;
}

bool valid_group_cluster(int n, int c) {
  return c == 0 || (c >= 2 && c <= kMaxCluster && (c & (c - 1)) == 0 &&
                    c <= start_ctas(n));
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks it against the
// card's per-block limit before launching); noise: the noise variant.
size_t fused_adam_v2_smem_bytes(int G, int R, int n, int n_groups,
                                int noise) {
  return smem_bytes(G, R, n, n_groups, noise != 0);
}

// CTAs a start takes at n qubits: 1 up to 12 (the register kernel),
// 2^(n - 12) above (the cluster kernel up to 16, the group kernel at 17
// and 18).
int fused_adam_v2_start_ctas(int n) { return start_ctas(n); }

// CTAs of one cluster of the kernel that runs n qubits, 0 for the register
// kernel; `group_cluster` (0: the default, kGroupCluster) sets it for the
// group kernel.
int fused_adam_v2_cluster_size(int n, int group_cluster) {
  return n > kRegMaxQubits ? cluster_size(n, group_cluster) : 0;
}

// 1 where the group kernel runs n qubits.
int fused_adam_v2_group_band(int n) { return in_group_band(n) ? 1 : 0; }

// How many clusters of the kernel that runs n qubits (clusters of
// fused_adam_v2_cluster_size(n, group_cluster) CTAs), each CTA with
// `bytes` of dynamic shared memory, the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 when none fits, or minus a CUDA
// error code.
int fused_adam_v2_cluster_occupancy(int n, size_t bytes, int group_cluster) {
  if (n <= kRegMaxQubits || n > kMaxQubits ||
      !valid_group_cluster(n, group_cluster))
    return -(int)cudaErrorInvalidValue;
  const int C = cluster_size(n, group_cluster);
  if (in_group_band(n))
    return occupancy(fused_adam_v2_group_kernel<kRegBits>, C, bytes);
  return occupancy(fused_adam_v2_cluster_kernel<kRegBits>, C, bytes);
}

// Floats of global exchange the group kernel takes for `slots` starts at
// once with R angles at n qubits, 0 for the other kernels.
size_t fused_adam_v2_exchange_floats(int n, int R, int slots) {
  if (!in_group_band(n)) return 0;
  const int C = start_ctas(n);
  return (size_t)slots * group_area_floats(C, (1 << n) / C, R);
}

const char* fused_adam_v2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs asynchronously on `stream`.  best_x (E, S, R) and best_e (E, S) are
// scratch; arrived (E,) must be zero, (E + slots,) in the group kernel
// (each slot's barrier counter after the env counters).  A non-null
// `seeds` (E x 2 int32) launches the noise variant with fire thresholds
// thr1 (after rotations) and thr2 (after CX) out of 2^24.  psi0_stride is
// 0 for (1, D) psi0 planes shared by the envs, D for (E, D) planes.  b1
// and b2 are Adam's exact rates.  wim_any (G_f int32): 1 where a group's
// imaginary plane has a non-zero entry (the kernels skip the others).
// The kernel by n: the register kernel up to 12 qubits, the cluster
// kernel from 13 to 16, the group kernel at 17-18 (the caller checks
// fused_adam_v2_cluster_occupancy first for both); the group kernel takes
// `xchg` (fused_adam_v2_exchange_floats(n, R, slots) floats), `slots`
// (how many starts the card holds at once, by that occupancy) and
// `group_cluster` (0: kGroupCluster), which the other kernels leave null
// and 0.
int fused_adam_v2_launch(const int* okind, const int* otq, const int* ocq,
                         const int* oslot, const int* nkind, const int* ntq,
                         const int* ncq, const int* nslot, const int* map_idx,
                         const float* p0re, const float* p0im,
                         const float* wre, const float* wim, const int* flips,
                         const int* wim_any, const float* starts,
                         const float* active, const int* seeds, float* x_opt,
                         float* e_new,
                         float* best_x, float* best_e, unsigned int* arrived,
                         float* xchg, int slots, int group_cluster, int E,
                         int S, int G, int R, int n, int n_groups,
                         int psi0_stride, int iters, float lr, double b1,
                         double b2, float omb1, float omb2, float eps,
                         unsigned thr1, unsigned thr2, void* stream) {
  const bool group = in_group_band(n);
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < 7 || n > kMaxQubits ||
      n_groups < 1 || iters < 0 || (xchg != nullptr) != group ||
      (group ? slots < 1 : slots != 0) ||
      !valid_group_cluster(n, group ? group_cluster : 0) ||
      (psi0_stride != 0 && psi0_stride != 1 << n))
    return (int)cudaErrorInvalidValue;
  const Tape old_g = {okind, otq, ocq, oslot};
  const Tape new_g = {nkind, ntq, ncq, nslot};
  const size_t bytes = smem_bytes(G, R, n, n_groups, seeds != nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= kRegMaxQubits) {               // the register kernel
    err = cudaFuncSetAttribute(fused_adam_v2_reg_kernel<kRegBits>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    KERNEL_LAUNCH(fused_adam_v2_reg_kernel<kRegBits>, E * S,
                  1 << (n - kRegBits), bytes, st, old_g, new_g, map_idx,
                  p0re, p0im, wre, wim, flips, wim_any, starts, active, seeds,
                  x_opt, e_new, best_x, best_e, arrived, S, G, R, n, n_groups,
                  psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1,
                  thr2);
    return (int)cudaGetLastError();
  }
  const int C = start_ctas(n), size = cluster_size(n, group_cluster);
  ClusterLaunch l;
  if (!group) {                           // the cluster kernel
    err = cluster_attributes(fused_adam_v2_cluster_kernel<kRegBits>, C,
                             bytes);
    if (err != cudaSuccess) return (int)err;
    cluster_config(l, E * S, C, bytes, st);
    err = cudaLaunchKernelEx(&l.cfg, fused_adam_v2_cluster_kernel<kRegBits>,
                             old_g, new_g, map_idx, p0re, p0im, wre, wim,
                             flips, wim_any, starts, active, seeds, x_opt,
                             e_new, best_x, best_e, arrived, S, G, R, n,
                             n_groups, psi0_stride, iters, lr, b1, b2, omb1,
                             omb2, eps, thr1, thr2);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  // the group kernel: no more starts at once than there are
  const int held = slots < E * S ? slots : E * S;
  err = cluster_attributes(fused_adam_v2_group_kernel<kRegBits>, size,
                           bytes);
  if (err != cudaSuccess) return (int)err;
  cluster_config(l, held * (C / size), size, bytes, st);
  err = cudaLaunchKernelEx(&l.cfg, fused_adam_v2_group_kernel<kRegBits>,
                           old_g, new_g, map_idx, p0re, p0im, wre, wim, flips,
                           wim_any, starts, active, seeds, x_opt, e_new,
                           best_x, best_e, arrived, S, G, R, n, n_groups,
                           psi0_stride, iters, lr, b1, b2, omb1, omb2, eps,
                           thr1, thr2, xchg, held, E * S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
