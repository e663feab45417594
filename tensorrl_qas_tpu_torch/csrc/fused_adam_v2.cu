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
// until the argmin, so each start gets a CTA of its own: 128 CTAs on 132
// SMs at 12 qubits, E = 16, S = 8.
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
// amplitudes), so 13 qubits keeps the first design below.
//
// First design (fused_adam_v2_kernel, 13 <= n <= 18): psi and lambda (16
// D bytes) live in shared memory at 13 qubits and in the CTA's slice of a
// global workspace above (256 KB to 4 MB a start), reached through L2.  A
// gate pairs amplitude i0 (target bit 0) with i1 = i0 | 2^t; each of 512
// threads owns whole pairs, so a gate updates in place and ends with a
// barrier; H psi is one pass in which thread i sums W_f[i] psi[i ^ f];
// gradient rows are warp shuffles plus a fixed-order sum by thread 0.
//
// Both kernels: the W planes (read-only, shared by every CTA: 2.75 MB at
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
// One CTA per start is one SM per start: the register kernel's gate chain
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

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "philox.cuh"
#include "regs.cuh"

namespace {

using namespace gates;
using namespace regs;

constexpr int kThreads = 512;             // threads of a first-design CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQubits = 18;
// Largest qubit count whose psi and lambda (16 D bytes) the first design
// keeps in shared memory; above it they live in the global workspace.
constexpr int kSmemStateMaxQubits = 13;
// Largest qubit count of the register kernel (at 13 qubits its adjoint
// needs more than the 128 registers a thread of 512 may have, and 256
// threads of 32 amplitudes spill too: 13 qubits keeps the first design).
constexpr int kRegMaxQubits = 12;

// -- register kernel (7 <= n <= 12) ------------------------------------------

// Register bits of a thread: 16 amplitudes, 2^(n - 4) threads (8 at 7
// qubits, 256 at 12).
constexpr int kRegBits = 4;
constexpr int kRegThreads = 256;

// One op of a schedule, (x, y) = (bits, gate): bits 0-3 the gate kind or
// kSwapOp, 4-8 the target's physical bit (a swap: its register bit), 9-13
// the control's physical bit + 1 (0: none; a swap: its warp bit + 1), bit
// 14 set when the gate has an angle gradient, 15-19 the gate's case (its
// form, whether it has a control, and its target's register bit or 4 for a
// lane bit: gate_case); y the gate's tape index (0 for a swap).
constexpr int kSwapOp = 15;
constexpr int kGradBit = 1 << 14;

__device__ __forceinline__ int op_kind(int x) { return x & 15; }
__device__ __forceinline__ int op_p(int x) { return (x >> 4) & 31; }
__device__ __forceinline__ int op_q(int x) { return ((x >> 9) & 31) - 1; }
__device__ __forceinline__ int op_case(int x) { return (x >> 15) & 31; }

struct RegShared {
  double* red;     // 2 * kWarps energy partials
  float4* coef;    // 2 G: each gate's 2x2 entries at the current angles
  int2* ops;       // 2 G: the schedule of the current tape
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
};

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
// swap_schedule), by one thread.  `after` is G ints of scratch, `work`
// 4 kMaxQubits.
__device__ void build_schedule(const Tape& tape, int G, int n, int RB,
                               int* after, int* work, int2* ops, int* map0,
                               int* map1, int* nops) {
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
  int w = RB + lanes;
  for (int q = lanes; q < n; ++q)
    if (!((placed >> q) & 1)) occ[w++] = q;
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
      const int b = pos[t], qa = occ[a];
      ops[c++] = make_int2(kSwapOp | (a << 4) | ((b + 1) << 9), 0);
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

// Each gate's 2x2 entries at the iterate x into coef (the caller's next
// barrier publishes them).
__device__ __forceinline__ void gate_coefs(const RegShared& sh,
                                           const Tape& tape, const float* x,
                                           int G) {
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
                                          int n) {
  int idx[1 << RB];
  logical_indices<RB>(sh.map0, n, threadIdx.x, idx);
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

// psi <- tape(x) psi along the schedule, each gate followed by its drawn
// errors in the noise variant.  The next op and its entries are read
// before the current one runs.
template <int RB>
__device__ __forceinline__ void forward_reg(Amps<RB>& s, const RegShared& sh,
                                            int D, bool noise,
                                            unsigned mask) {
  const int nops = *sh.nops;
  int parity = 0;
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
      swap_bits<RB, false>(s, p, q, sh.region + parity * 2 * D);
      parity ^= 1;
      continue;
    }
    gate_fwd<RB>(s, u, op_case(op.x), p, q, mask);
    if (i == e_op) {                      // block-uniform
      const int et = sh.err_t[op.y], ec = sh.err_c[op.y];
      // no control: the error falls on qubit 0, a lane bit for good
      if (et) pauli<RB, false>(s, et, p, sh.region, D, mask);
      if (ec) pauli<RB, false>(s, ec, q >= 0 ? q : RB, sh.region, D, mask);
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

// Adjoint sweep: the schedule backwards; each gate's drawn errors are
// undone first in the noise variant; lane 0 of each warp writes the warp's
// part of gate g's gradient row to gpart[g * warps + warp].  The next op
// and its entries are read before the current one runs.
template <int RB>
__device__ __forceinline__ void backward_reg(Amps<RB>& s, const RegShared& sh,
                                             int D, bool noise,
                                             unsigned mask) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int width = T < 32 ? T : 32, warps = (T + 31) >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int nops = *sh.nops;
  int parity = 0;
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
      swap_bits<RB, true>(s, p, q, sh.region + parity * 2 * D);
      parity ^= 1;
      continue;
    }
    if (i == e_op) {                      // block-uniform
      const int et = sh.err_t[op.y], ec = sh.err_c[op.y];
      if (et) pauli<RB, true>(s, et, p, sh.region, D, mask);
      if (ec) pauli<RB, true>(s, ec, q >= 0 ? q : RB, sh.region, D, mask);
      e_op = e_at > 0 ? sh.err_ops[--e_at] : -1;
    }
    float gp = gate_adj<RB>(s, u, op_case(op.x), p, q, mask);
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
    for (int r = threadIdx.x; r < R; r += blockDim.x) sh.bx[r] = sh.x[r];
  __syncthreads();
  if (threadIdx.x == 0 && better) sh.scal[1] = sh.scal[0];
  __syncthreads();
}

size_t reg_smem_bytes(int G, int R, int n, int n_groups, bool noise) {
  const size_t D = (size_t)1 << n;
  const size_t warps = ((D >> kRegBits) + 31) / 32;
  return sizeof(double) * 2 * kWarps + sizeof(float4) * 2 * G +
         sizeof(int2) * 2 * G + sizeof(float) * 4 * D +
         sizeof(float) * (4 * (size_t)R + 2 + G * warps) +
         sizeof(int) * ((size_t)(noise ? 13 : 9) * G + (noise ? 1 : 0) +
                        2 * R + 2 * n_groups + 2 +
                        6 * kMaxQubits + 1);
}

template <int RB>
__global__ void __launch_bounds__(kRegThreads)
fused_adam_v2_reg_kernel(Tape old_g, Tape new_g,
                         const int* __restrict__ map_idx,
                         const float* __restrict__ p0re,
                         const float* __restrict__ p0im,
                         const float* __restrict__ wre,
                         const float* __restrict__ wim,
                         const int* __restrict__ flips,
                         const int* __restrict__ wim_any,
                         const float* __restrict__ starts,
                         const float* __restrict__ active,
                         const int* __restrict__ seeds,
                         float* __restrict__ x_opt, float* __restrict__ e_new,
                         float* best_x, float* best_e, unsigned int* arrived,
                         int S, int G, int R, int n, int n_groups,
                         int psi0_stride, int iters, float lr, double b1,
                         double b2, float omb1, float omb2, float eps,
                         unsigned thr1, unsigned thr2) {
  extern __shared__ __align__(16) unsigned char smem_reg[];
  const bool noise = seeds != nullptr;
  const int tid = threadIdx.x, T = blockDim.x;
  const int D = T << RB;
  const int warps = (T + 31) >> 5;
  const unsigned mask = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
  const int e = blockIdx.x / S;
  const int row = blockIdx.x;             // e * S + s
  const float* p0r = p0re + (size_t)e * psi0_stride;   // this env's psi0
  const float* p0i = p0im + (size_t)e * psi0_stride;
  RegShared sh;
  unsigned char* b = smem_reg;
  sh.red = reinterpret_cast<double*>(b);
  b += sizeof(double) * 2 * kWarps;
  sh.coef = reinterpret_cast<float4*>(b);
  b += sizeof(float4) * 2 * G;
  sh.ops = reinterpret_cast<int2*>(b);
  b += sizeof(int2) * 2 * G;
  float* f = reinterpret_cast<float*>(b);
  sh.region = f; f += 4 * D;
  sh.x = f; f += R;
  sh.m = f; f += R;
  sh.v = f; f += R;
  sh.bx = f; f += R;
  sh.scal = f; f += 2;
  sh.gpart = f; f += G * warps;
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
  sh.nops = ip;

  const int* src[8] = {old_g.kind, old_g.tq, old_g.cq, old_g.slot,
                       new_g.kind, new_g.tq, new_g.cq, new_g.slot};
#pragma unroll
  for (int a = 0; a < 8; ++a)             // constant indices: no stack
    for (int g = tid; g < G; g += T) tapes[a][g] = src[a][(size_t)e * G + g];
  for (int r = tid; r < R; r += T) {
    sh.map[r] = map_idx[(size_t)e * R + r];
    const float x0 = starts[(size_t)row * R + r];
    sh.x[r] = x0;
    sh.bx[r] = x0;
    sh.m[r] = 0.f;
    sh.v[r] = 0.f;
  }
  for (int q = tid; q < n_groups; q += T) {
    sh.flips[q] = flips[q];
    sh.wim_any[q] = wim_any[q];
  }
  if (tid == 0) sh.scal[1] = INFINITY;
  __syncthreads();
  // the gates whose gradient feeds each angle, last gate first
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
  if (tid == 0)
    build_schedule(sh.old_tape, G, n, RB, reinterpret_cast<int*>(sh.gpart),
                   sh.sched, sh.ops, sh.map0, sh.map1, sh.nops);
  __syncthreads();

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
    load_psi0<RB>(s, sh, p0r, p0i, n);
    forward_reg<RB>(s, sh, D, noise, mask);
    h_energy_reg<RB>(s, sh, wre, wim, n_groups, n, mask);
    track_best_reg(sh, R);
    backward_reg<RB>(s, sh, D, noise, mask);
    __syncthreads();
    b1t *= b1;
    b2t *= b2;
    const float bc1 = (float)(1.0 - b1t);
    const float bc2 = (float)(1.0 - b2t);
    for (int r = tid; r < R; r += T) {
      float dx = 0.f;
      for (int g = sh.slot_first[r]; g >= 0; g = sh.gate_next[g]) {
        float acc = 0.f;
        for (int w = 0; w < warps; ++w) acc += sh.gpart[g * warps + w];
        dx += acc;
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
  load_psi0<RB>(s, sh, p0r, p0i, n);
  forward_reg<RB>(s, sh, D, noise, mask);
  h_energy_reg<RB>(s, sh, wre, wim, n_groups, n, mask);
  track_best_reg(sh, R);

  for (int r = tid; r < R; r += T) best_x[(size_t)row * R + r] = sh.bx[r];
  if (tid == 0) best_e[row] = sh.scal[1];
  __threadfence();                        // publish before arriving
  __syncthreads();
  if (tid == 0) sh.flag[0] =
      atomicAdd(&arrived[e], 1u) == (unsigned int)(S - 1);
  __syncthreads();
  if (!sh.flag[0]) return;

  // last CTA of env e: the other starts' results are visible (L1 bypassed)
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
  for (int r = tid; r < R; r += T) {
    const float xo = __ldcg(best_x + best_row * R + r);
    x_opt[(size_t)e * R + r] = xo;
    sh.bx[r] = xo;
  }
  __syncthreads();
  for (int r = tid; r < R; r += T) {
    const int mj = sh.map[r];
    sh.x[r] = mj >= 0 ? sh.bx[mj] : 0.f;  // x_new
  }
  __syncthreads();

  if (tid == 0)
    build_schedule(sh.new_tape, G, n, RB, reinterpret_cast<int*>(sh.gpart),
                   sh.sched, sh.ops, sh.map0, sh.map1, sh.nops);
  if (noise)                              // a fresh realization for e_new
    draw_errors_reg(sh, sh.new_tape, G, seeds, e, iters + 1, thr1, thr2);
  gate_coefs(sh, sh.new_tape, sh.x, G);
  __syncthreads();
  if (noise) {
    list_errors(sh);
    __syncthreads();
  }
  load_psi0<RB>(s, sh, p0r, p0i, n);
  forward_reg<RB>(s, sh, D, noise, mask);
  h_energy_reg<RB>(s, sh, wre, wim, n_groups, n, mask);
  if (tid == 0) e_new[e] = sh.scal[0];
}

// -- first design (13 <= n <= 18) --------------------------------------------

struct Shared {
  double* red;   // 2 * kWarps energy partials
  float* pre;    // D: psi (shared memory or global workspace)
  float* pim;
  float* lre;    // D: lambda
  float* lim;
  float* x;      // R: iterate
  float* m;
  float* v;
  float* bx;     // best iterate
  float* dx;     // gradient
  float* ct;     // cos(x / 2)
  float* st;     // sin(x / 2)
  float* scal;   // [0] current energy, [1] best energy
  float* gpart;  // 2 x kWarps gradient partials (double-buffered)
  Tape old_tape;
  Tape new_tape;
  int* map;      // R
  int* flips;    // G_f
  int* flag;     // [0] last CTA of its env, [1] best start
  int* err_t;    // G error kinds on the target (noise variant)
  int* err_c;    // G error kinds on the control
};

// Error kinds of every gate of `tape` at `tag` into err_t / err_c; the
// caller's next barrier publishes them.
__device__ void draw_errors(const Shared& sh, const Tape& tape, int G,
                            const int* __restrict__ seeds, int e, int tag,
                            unsigned thr1, unsigned thr2) {
  const unsigned k0 = (unsigned)seeds[2 * e], k1 = (unsigned)seeds[2 * e + 1];
  for (int g = threadIdx.x; g < G; g += kThreads)
    philox::error_kinds(tape.kind[g], g, tag, k0, k1, thr1, thr2,
                        sh.err_t[g], sh.err_c[g]);
}

// Pauli k on qubit q: on psi (forward), or, with kAdjoint, undone on psi
// and transposed onto lambda.
template <bool kAdjoint>
__device__ void error_pass(const Shared& sh, int k, int q, int n) {
  const int half = 1 << (n - 1);
  for (int p = threadIdx.x; p < half; p += kThreads) {
    const int i0 = pair_low(p, q);
    const int i1 = i0 | (1 << q);
    philox::pauli_pair<false>(k, sh.pre[i0], sh.pim[i0], sh.pre[i1],
                              sh.pim[i1]);
    if (kAdjoint)
      philox::pauli_pair<true>(k, sh.lre[i0], sh.lim[i0], sh.lre[i1],
                               sh.lim[i1]);
  }
  __syncthreads();
}

// Both error Paulis of gate g (block-uniform: they live in shared memory).
template <bool kAdjoint>
__device__ void gate_errors(const Shared& sh, int g, int t, int c, int n) {
  if (sh.err_t[g]) error_pass<kAdjoint>(sh, sh.err_t[g], t, n);
  if (sh.err_c[g]) error_pass<kAdjoint>(sh, sh.err_c[g], c < 0 ? 0 : c, n);
}

// psi <- psi0, trig table of x, dx <- 0.
__device__ void begin_pass(const Shared& sh, const float* __restrict__ p0re,
                           const float* __restrict__ p0im, int D, int R) {
  for (int i = threadIdx.x; i < D; i += kThreads) {
    sh.pre[i] = __ldg(p0re + i);
    sh.pim[i] = __ldg(p0im + i);
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float s, c;
    sincosf(0.5f * sh.x[r], &s, &c);
    sh.st[r] = s;
    sh.ct[r] = c;
    sh.dx[r] = 0.f;
  }
  __syncthreads();
}

// psi <- tape(x) psi, each gate followed by its drawn errors in the noise
// variant.
__device__ void forward(const Shared& sh, const Tape& tape, int G, int n,
                        bool noise) {
  const int half = 1 << (n - 1);
  for (int g = 0; g < G; ++g) {
    const int k = tape.kind[g];
    if (k == kNone) continue;
    const int t = tape.tq[g], c = tape.cq[g], sl = tape.slot[g];
    const Coef u = sl >= 0 ? gate_coef(k, sh.ct[sl], sh.st[sl])
                           : gate_coef(k, 1.f, 0.f);
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int i0 = pair_low(p, t);
      if (c >= 0 && !((i0 >> c) & 1)) continue;
      const int i1 = i0 | (1 << t);
      const float a0r = sh.pre[i0], a0i = sh.pim[i0];
      const float a1r = sh.pre[i1], a1i = sh.pim[i1];
      float b0r, b0i, b1r, b1i;
      cmul2(u.u00r, u.u00i, a0r, a0i, u.u01r, u.u01i, a1r, a1i, b0r, b0i);
      cmul2(u.u10r, u.u10i, a0r, a0i, u.u11r, u.u11i, a1r, a1i, b1r, b1i);
      sh.pre[i0] = b0r;
      sh.pim[i0] = b0i;
      sh.pre[i1] = b1r;
      sh.pim[i1] = b1i;
    }
    __syncthreads();
    if (noise) gate_errors<false>(sh, g, t, c, n);
  }
}

// lambda <- 2 conj(H psi); scal[0] <- Re<psi|H psi> / <psi|psi>.
__device__ void h_energy(const Shared& sh, const float* __restrict__ wre,
                         const float* __restrict__ wim, int n_groups, int D) {
  double raw = 0.0, nn = 0.0;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float hr = 0.f, hi = 0.f;
    for (int f = 0; f < n_groups; ++f) {
      const int j = i ^ sh.flips[f];
      const float wr = __ldg(wre + (size_t)f * D + i);
      const float wi = __ldg(wim + (size_t)f * D + i);
      const float pr = sh.pre[j], pi = sh.pim[j];
      hr = fmaf(wr, pr, hr);
      hr = fmaf(-wi, pi, hr);
      hi = fmaf(wr, pi, hi);
      hi = fmaf(wi, pr, hi);
    }
    const float pr = sh.pre[i], pi = sh.pim[i];
    sh.lre[i] = 2.f * hr;
    sh.lim[i] = -2.f * hi;
    raw += (double)pr * hr + (double)pi * hi;
    nn += (double)pr * pr + (double)pi * pi;
  }
  for (int off = 16; off > 0; off >>= 1) {
    raw += __shfl_xor_sync(0xffffffffu, raw, off);
    nn += __shfl_xor_sync(0xffffffffu, nn, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh.red[2 * warp] = raw;
    sh.red[2 * warp + 1] = nn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a += sh.red[2 * w];
      b += sh.red[2 * w + 1];
    }
    sh.scal[0] = (float)(a / b);
  }
  __syncthreads();
}

// Keep the better of (x, E) and (bx, best E).
__device__ void track_best(const Shared& sh, int R) {
  const bool better = sh.scal[0] < sh.scal[1];
  if (better)
    for (int r = threadIdx.x; r < R; r += kThreads) sh.bx[r] = sh.x[r];
  __syncthreads();
  if (threadIdx.x == 0 && better) sh.scal[1] = sh.scal[0];
  __syncthreads();
}

// Adjoint sweep over the tape: undo each gate on psi (U^H), carry lambda
// back (U^T), and add 1/2 Im[(P psi)^T lambda] into dx[slot]; in the noise
// variant each gate's drawn errors are undone first.  A gradient row is
// summed in a fixed order (warp shuffles, then thread 0 over the warps),
// so the kernel is deterministic; the warp partials alternate between two
// buffers, which lets thread 0 sum gate g's while the others start on the
// next gate.
__device__ void backward(const Shared& sh, const Tape& tape, int G, int n,
                         bool noise) {
  const int half = 1 << (n - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int parity = 0;
  for (int g = G - 1; g >= 0; --g) {
    const int k = tape.kind[g];
    if (k == kNone) continue;
    const int t = tape.tq[g], c = tape.cq[g], sl = tape.slot[g];
    if (noise) gate_errors<true>(sh, g, t, c, n);
    float* gbuf = sh.gpart + parity * kWarps;
    parity ^= 1;
    const bool has_grad = sl >= 0 && (k == kRX || k == kRY || k == kRZ);
    const Coef u = sl >= 0 ? gate_coef(k, sh.ct[sl], sh.st[sl])
                           : gate_coef(k, 1.f, 0.f);
    float gp = 0.f;
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int i0 = pair_low(p, t);
      if (c >= 0 && !((i0 >> c) & 1)) continue;
      const int i1 = i0 | (1 << t);
      const float a0r = sh.pre[i0], a0i = sh.pim[i0];
      const float a1r = sh.pre[i1], a1i = sh.pim[i1];
      const float l0r = sh.lre[i0], l0i = sh.lim[i0];
      const float l1r = sh.lre[i1], l1i = sh.lim[i1];
      if (has_grad) {
        float q0r, q0i, q1r, q1i;
        generator(k, a0r, a0i, a1r, a1i, q0r, q0i, q1r, q1i);
        gp += 0.5f * (q0r * l0i + q0i * l0r + q1r * l1i + q1i * l1r);
      }
      float b0r, b0i, b1r, b1i;           // U^H (a0, a1)
      cmul2(u.u00r, -u.u00i, a0r, a0i, u.u10r, -u.u10i, a1r, a1i, b0r, b0i);
      cmul2(u.u01r, -u.u01i, a0r, a0i, u.u11r, -u.u11i, a1r, a1i, b1r, b1i);
      float m0r, m0i, m1r, m1i;           // U^T (l0, l1)
      cmul2(u.u00r, u.u00i, l0r, l0i, u.u10r, u.u10i, l1r, l1i, m0r, m0i);
      cmul2(u.u01r, u.u01i, l0r, l0i, u.u11r, u.u11i, l1r, l1i, m1r, m1i);
      sh.pre[i0] = b0r;
      sh.pim[i0] = b0i;
      sh.pre[i1] = b1r;
      sh.pim[i1] = b1i;
      sh.lre[i0] = m0r;
      sh.lim[i0] = m0i;
      sh.lre[i1] = m1r;
      sh.lim[i1] = m1i;
    }
    if (has_grad) {                       // block-uniform branch
      for (int off = 16; off > 0; off >>= 1)
        gp += __shfl_xor_sync(0xffffffffu, gp, off);
      if (lane == 0) gbuf[warp] = gp;
    }
    __syncthreads();
    if (has_grad && threadIdx.x == 0) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += gbuf[w];
      sh.dx[sl] += acc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_adam_v2_kernel(Tape old_g, Tape new_g, const int* __restrict__ map_idx,
                     const float* __restrict__ p0re,
                     const float* __restrict__ p0im,
                     const float* __restrict__ wre,
                     const float* __restrict__ wim,
                     const int* __restrict__ flips,
                     const float* __restrict__ starts,
                     const float* __restrict__ active,
                     const int* __restrict__ seeds,
                     float* __restrict__ x_opt, float* __restrict__ e_new,
                     float* best_x, float* best_e, unsigned int* arrived,
                     float* work, int S, int G, int R, int n, int n_groups,
                     int psi0_stride, int iters, float lr, double b1,
                     double b2, float omb1, float omb2, float eps,
                     unsigned thr1, unsigned thr2) {
  extern __shared__ double smem[];
  const bool noise = seeds != nullptr;
  const int D = 1 << n;
  const int e = blockIdx.x / S;
  const int row = blockIdx.x;             // e * S + s
  const float* p0r = p0re + (size_t)e * psi0_stride;   // this env's psi0
  const float* p0i = p0im + (size_t)e * psi0_stride;
  Shared sh;
  sh.red = smem;
  float* f = reinterpret_cast<float*>(smem + 2 * kWarps);
  float* state = f;
  if (work == nullptr) {
    f += 4 * D;
  } else {
    state = work + (size_t)row * 4 * D;
  }
  sh.pre = state;
  sh.pim = state + D;
  sh.lre = state + 2 * D;
  sh.lim = state + 3 * D;
  sh.x = f; f += R;
  sh.m = f; f += R;
  sh.v = f; f += R;
  sh.bx = f; f += R;
  sh.dx = f; f += R;
  sh.ct = f; f += R;
  sh.st = f; f += R;
  sh.scal = f; f += 2;
  sh.gpart = f; f += 2 * kWarps;
  int* ip = reinterpret_cast<int*>(f);
  int* tapes[8];
  for (int a = 0; a < 8; ++a) { tapes[a] = ip; ip += G; }
  sh.old_tape = {tapes[0], tapes[1], tapes[2], tapes[3]};
  sh.new_tape = {tapes[4], tapes[5], tapes[6], tapes[7]};
  sh.map = ip; ip += R;
  sh.flips = ip; ip += n_groups;
  sh.flag = ip; ip += 2;
  sh.err_t = ip; ip += noise ? G : 0;
  sh.err_c = ip;

  const int* src[8] = {old_g.kind, old_g.tq, old_g.cq, old_g.slot,
                       new_g.kind, new_g.tq, new_g.cq, new_g.slot};
  for (int idx = threadIdx.x; idx < 8 * G; idx += kThreads)
    tapes[idx / G][idx % G] = src[idx / G][(size_t)e * G + idx % G];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sh.map[r] = map_idx[(size_t)e * R + r];
    const float x0 = starts[(size_t)row * R + r];
    sh.x[r] = x0;
    sh.bx[r] = x0;
    sh.m[r] = 0.f;
    sh.v[r] = 0.f;
  }
  for (int q = threadIdx.x; q < n_groups; q += kThreads)
    sh.flips[q] = flips[q];
  if (threadIdx.x == 0) sh.scal[1] = INFINITY;
  __syncthreads();

  // b^t as a running product in double from the exact rates: the bias
  // corrections are then the plain version's 1 - b^t rounded once to
  // float (1.f - powf(0.999f, t) is off by 1.3e-5 relative at t = 1,
  // since 0.999f = 0.99900001)
  double b1t = 1.0, b2t = 1.0;
  const float b1f = (float)b1, b2f = (float)b2;
  for (int it = 0; it < iters; ++it) {
    if (noise) draw_errors(sh, sh.old_tape, G, seeds, e, it, thr1, thr2);
    begin_pass(sh, p0r, p0i, D, R);
    forward(sh, sh.old_tape, G, n, noise);
    h_energy(sh, wre, wim, n_groups, D);
    track_best(sh, R);
    backward(sh, sh.old_tape, G, n, noise);
    b1t *= b1;
    b2t *= b2;
    const float bc1 = (float)(1.0 - b1t);
    const float bc2 = (float)(1.0 - b2t);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const float gr = sh.dx[r] * active[(size_t)e * R + r];
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
  if (noise) draw_errors(sh, sh.old_tape, G, seeds, e, iters, thr1, thr2);
  begin_pass(sh, p0r, p0i, D, R);
  forward(sh, sh.old_tape, G, n, noise);
  h_energy(sh, wre, wim, n_groups, D);
  track_best(sh, R);

  for (int r = threadIdx.x; r < R; r += kThreads)
    best_x[(size_t)row * R + r] = sh.bx[r];
  if (threadIdx.x == 0) best_e[row] = sh.scal[1];
  __threadfence();                        // publish before arriving
  __syncthreads();
  if (threadIdx.x == 0) sh.flag[0] =
      atomicAdd(&arrived[e], 1u) == (unsigned int)(S - 1);
  __syncthreads();
  if (!sh.flag[0]) return;

  // last CTA of env e: the other starts' results are visible (L1 bypassed)
  __threadfence();
  if (threadIdx.x == 0) {                 // first minimum, as argmin
    int b = 0;
    float be = __ldcg(best_e + (size_t)e * S);
    for (int s = 1; s < S; ++s) {
      const float v = __ldcg(best_e + (size_t)e * S + s);
      if (v < be) {
        be = v;
        b = s;
      }
    }
    sh.flag[1] = b;
  }
  __syncthreads();
  const size_t best_row = (size_t)e * S + sh.flag[1];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float xo = __ldcg(best_x + best_row * R + r);
    x_opt[(size_t)e * R + r] = xo;
    sh.bx[r] = xo;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int mj = sh.map[r];
    sh.x[r] = mj >= 0 ? sh.bx[mj] : 0.f;  // x_new
  }
  __syncthreads();

  if (noise)                              // a fresh realization for e_new
    draw_errors(sh, sh.new_tape, G, seeds, e, iters + 1, thr1, thr2);
  begin_pass(sh, p0r, p0i, D, R);
  forward(sh, sh.new_tape, G, n, noise);
  h_energy(sh, wre, wim, n_groups, D);
  if (threadIdx.x == 0) e_new[e] = sh.scal[0];
}

bool state_in_smem(int n) { return n <= kSmemStateMaxQubits; }

size_t smem_bytes(int G, int R, int n, int n_groups, bool noise) {
  if (n <= kRegMaxQubits) return reg_smem_bytes(G, R, n, n_groups, noise);
  const size_t state = state_in_smem(n) ? (size_t)4 << n : 0;
  return sizeof(double) * 2 * kWarps +
         sizeof(float) * (state + (size_t)7 * R + 2 + 2 * kWarps) +
         sizeof(int) * ((size_t)(noise ? 10 : 8) * G + R + n_groups + 2);
}

// Launch the register kernel.
cudaError_t launch_reg(const Tape& old_g, const Tape& new_g,
                       const int* map_idx, const float* p0re,
                       const float* p0im, const float* wre, const float* wim,
                       const int* flips, const int* wim_any,
                       const float* starts, const float* active,
                       const int* seeds, float* x_opt,
                       float* e_new, float* best_x, float* best_e,
                       unsigned int* arrived, int E, int S, int G, int R,
                       int n, int n_groups, int psi0_stride, int iters,
                       float lr, double b1, double b2, float omb1, float omb2,
                       float eps, unsigned thr1, unsigned thr2, size_t bytes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_adam_v2_reg_kernel<kRegBits>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  fused_adam_v2_reg_kernel<kRegBits>
      <<<E * S, 1 << (n - kRegBits), bytes, stream>>>(
      old_g, new_g, map_idx, p0re, p0im, wre, wim, flips, wim_any, starts,
      active, seeds, x_opt, e_new, best_x, best_e, arrived, S, G, R, n,
      n_groups, psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1, thr2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks it against the
// card's per-block limit before launching); noise: the noise variant.
size_t fused_adam_v2_smem_bytes(int G, int R, int n, int n_groups,
                                int noise) {
  return smem_bytes(G, R, n, n_groups, noise != 0);
}

// Floats of global workspace for psi and lambda of E x S starts: 0 up to
// 13 qubits (registers, or shared memory at 13).
size_t fused_adam_v2_workspace_floats(int E, int S, int n) {
  return state_in_smem(n) ? 0 : (size_t)E * S * 4 << n;
}

const char* fused_adam_v2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs asynchronously on `stream`.  best_x (E, S, R) and best_e (E, S) are
// scratch; arrived (E,) must be zero; work is null or holds
// fused_adam_v2_workspace_floats(E, S, n) floats.  A non-null `seeds`
// (E x 2 int32) launches the noise variant with fire thresholds thr1
// (after rotations) and thr2 (after CX) out of 2^24.  psi0_stride is 0
// for (1, D) psi0 planes shared by the envs, D for (E, D) planes.  b1 and
// b2 are Adam's exact rates.  wim_any (G_f int32): 1 where a group's
// imaginary plane has a non-zero entry (the register kernel skips the
// others; the first design reads every plane).
int fused_adam_v2_launch(const int* okind, const int* otq, const int* ocq,
                         const int* oslot, const int* nkind, const int* ntq,
                         const int* ncq, const int* nslot, const int* map_idx,
                         const float* p0re, const float* p0im,
                         const float* wre, const float* wim, const int* flips,
                         const int* wim_any, const float* starts,
                         const float* active, const int* seeds, float* x_opt,
                         float* e_new,
                         float* best_x, float* best_e, unsigned int* arrived,
                         float* work, int E, int S, int G, int R, int n,
                         int n_groups, int psi0_stride, int iters, float lr,
                         double b1, double b2, float omb1, float omb2,
                         float eps, unsigned thr1, unsigned thr2,
                         void* stream) {
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < 7 || n > kMaxQubits ||
      n_groups < 1 || iters < 0 || (work == nullptr) != state_in_smem(n) ||
      (psi0_stride != 0 && psi0_stride != 1 << n))
    return (int)cudaErrorInvalidValue;
  const Tape old_g = {okind, otq, ocq, oslot};
  const Tape new_g = {nkind, ntq, ncq, nslot};
  const size_t bytes = smem_bytes(G, R, n, n_groups, seeds != nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kRegMaxQubits)
    return (int)launch_reg(
        old_g, new_g, map_idx, p0re, p0im, wre, wim, flips, wim_any, starts,
        active, seeds, x_opt, e_new, best_x, best_e, arrived, E, S, G, R, n,
        n_groups, psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1,
        thr2, bytes, st);
  cudaError_t err = cudaFuncSetAttribute(
      fused_adam_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_adam_v2_kernel<<<E * S, kThreads, bytes, st>>>(
      old_g, new_g, map_idx, p0re, p0im, wre, wim, flips, starts, active,
      seeds, x_opt, e_new, best_x, best_e, arrived, work, S, G, R, n,
      n_groups, psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1, thr2);
  return (int)cudaGetLastError();
}

}  // extern "C"
