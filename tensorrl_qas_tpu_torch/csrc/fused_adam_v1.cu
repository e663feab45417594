// Fused multi-start Adam env step, one launch per env step (CUDA, sm_90a),
// for 1 <= n <= 9 qubits.
//
// Replaces the TPU kernel tensorrl_qas_tpu/ops/pallas_opt.py:_make_kernel
// (launched by fused_adam_step_pallas / _fused_adam_step_call), together
// with the gate device functions it takes from ops/pallas_apply.py
// (_gate_class, _apply_gate_fast, _bwd_gate_fast, _gate_coeffs, _xor_lane),
// which live in gates.cuh and regs.cuh.  The plain PyTorch version of the
// same function is
// tensorrl_qas_tpu_torch/ops/fused_adam.py:fused_adam_step_reference.
// The noise variant (the same kernel launched with a non-null `seeds`)
// replaces the TPU kernel compiled with noise=(p1, p2)
// (pallas_opt.py:draw_noise / noise_kinds / apply_noise): see "Noise" below.
// Launched with psi0_stride = D, each env starts from its own psi0 row
// (block-coordinate trainable mode); the JAX package has no such v1
// variant and runs that case on XLA (optim/angle_opt.py:694-699).
//
// What one CTA computes, for its env e (grid = E envs):
//   for each start s, in its own thread group:
//     for it in 0..iters-1:                     (Adam over the OLD tape)
//       psi   = tape(x) psi0                     D amplitudes in registers
//       Hpsi  = sum_f W_f * psi[i ^ f]           flip-group planes
//       E     = Re<psi|H psi> / <psi|psi>        best-iterate tracking
//       dx    = adjoint sweep, lambda = 2 conj(H psi), masked by `active`
//       x     = Adam(x, dx)                      bias-corrected
//     final re-check of x
//   argmin over starts (first minimum) -> x_opt,
//   x_new[j] = x_opt[map[j]] (map -1 -> 0), e_new = E(new tape, x_new).
//
// Layout.  A start's 2^n amplitudes of psi, and of lambda in the adjoint,
// live in the registers of a group of T = 2^(n - RB) threads, 2^RB
// amplitudes each (regs.cuh): physical index (t << RB) | j for register j
// of the group's thread t.  The low L = n - RB logical qubits sit on the
// lane bits and the others on the register bits, so qubit q < L is
// physical bit RB + q and qubit q >= L physical bit q - L, and the logical
// index of register j of thread t is t | (j << L): a group's reads of a W
// row are consecutive.  RB is 3 (8 amplitudes a thread) or 4 (16, which
// 9 qubits need: a group never spans two warps, so no qubit sits on a warp
// bit and nothing moves through shared memory in the gate chain).  Below
// RB qubits a group is one thread whose upper registers hold zeros.  A
// gate on a register bit needs no communication, one on a lane bit a
// __shfl_xor_sync inside the group, a control is a predicate on the
// thread's own index; each gate dispatches on one switch (the gate case
// its op word carries) to a body with constant register indices.  Groups
// smaller than a warp share it: the tape is the env's, so every group of
// a CTA runs the same gate sequence, and the shuffles of a warp stay
// convergent.  An env's S starts share one CTA, S groups (or S / rounds
// groups taking the starts in rounds, when S groups would pass 256
// threads: at 512 the 128 registers a thread may have spilled at RB = 3).
//
// Inside an Adam iteration there is no CTA barrier: a group's gate
// entries at its angles (and error kinds) live in its own slice of shared
// memory, its start's x, m, v and best iterate in that start's rows,
// ordered by __syncwarp on the group's lanes.  H psi: the group writes
// psi to its own slice at logical indices (re and im side by side, one
// 64-bit load a partner), then each thread computes lambda = 2 conj(sum_f
// W_f[i] psi[i ^ f]) for exactly the indices it holds, in group order, so
// lambda lands in its registers.
// The W planes (G_f x D floats, and the imaginary plane only of the groups
// whose plane is not zero: none for a real H) are read into shared memory
// once per launch; a Pauli sum whose planes do not fit (up to D complex
// groups, 512 KB at 8 qubits) reads them from global memory through L2.
// Energies are summed in double over the group by a shuffle butterfly,
// which leaves every thread the same sum.  A gate's gradient row is not
// reduced where the gate runs (a shuffle butterfly a gate was latency that
// a few warps an SM do not hide): each thread writes its part to a ring of
// T rows in the group's slice, and every T rows each thread sums one row
// over the group's lanes; Adam then sums each angle's rows in descending
// gate order.  Every sum has a fixed order, so the kernel is
// deterministic.  The first CTA barrier after the
// set-up comes after every start's final re-check: the argmin, then e_new
// on the new tape by group 0.  All amplitude arithmetic is f32 FMA: no
// tensor-core TF32 or bf16, whose rounding exceeds the 1.6e-3 Ha acceptance
// threshold over a 40-gate tape.
//
// Noise.  With seeds each group draws its env's depolarizing realization
// itself (philox.cuh: key = seeds[e], counter = (gate, tag)) once per tag --
// Adam iteration `it`, `iters` for the final re-check, `iters + 1` for
// e_new -- into per-op error kinds in its slice of shared memory: the same
// (key, counter) gives every start the same draws without a barrier.  A
// fired error is a Pauli after the gate: on a register bit a local swap or
// sign, on a lane bit a shuffle.  The adjoint sweep undoes it on psi and
// transposes it onto lambda before the gate's own adjoint step.  The
// variant is a block-uniform runtime flag, not a second compiled kernel:
// two template instances contracted the shared arithmetic into FMAs
// differently (x_opt apart by 2.3e-6 at p = 0 on the card), while one code
// path makes the variant at p = 0 the noiseless kernel bit for bit.
//
// Per-env psi0.  psi0_stride is the distance in floats between two envs'
// psi0 rows: 0 for one plane shared by the batch, D for (E, D) planes.
// It only moves the pointer psi0 is read from, so it is a runtime argument
// of the one kernel: with identical rows the per-env launch is the shared
// launch bit for bit.  The tapes are G gates and the angle rows R entries
// apart; the two capacities differ when the tapes embed a warm-start
// circuit (172 gates, 151 angles for 8-qubit H2O in trainable mode).

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "philox.cuh"
#include "regs.cuh"

// The launch and the dynamic shared memory go through these two macros, so
// that tests/cuda_emu/cuda_runtime.h, which defines both, can run this
// source on the host.
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
#define DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

using namespace gates;
using namespace regs;

constexpr int kMaxQubits = 9;

constexpr int kMaxThreads = 256;

// One op of a tape, (x, y, z) = (bits, gate, slot): bits 0-3 the gate
// kind, 4-8 the target's physical bit, 9-13 the control's physical bit + 1
// (0: none), bit 14 set when the gate has an angle gradient, 15-19 the
// gate's case (regs.cuh:gate_case); y the gate's tape index, z its angle
// slot (-1: none).  The kNone gates are left out.
constexpr int kGradBit = 1 << 14;

__device__ __forceinline__ int op_kind(int x) { return x & 15; }
__device__ __forceinline__ int op_p(int x) { return (x >> 4) & 31; }
__device__ __forceinline__ int op_q(int x) { return ((x >> 9) & 31) - 1; }
__device__ __forceinline__ int op_case(int x) { return (x >> 15) & 31; }

// How a CTA holds its env's starts (twin: ops/fused_adam.py:group_layout).
struct Dims {
  int D;       // 2^n
  int rb;      // register bits of a thread
  int L;       // lane bits of a group
  int T;       // threads of a group (one start)
  int Dp;      // amplitudes a group holds, T << rb (>= D)
  int groups;  // groups of the CTA
  int rounds;  // rounds over the starts
};

__host__ __device__ inline Dims make_dims(int n, int S, int rb) {
  Dims d;
  d.D = 1 << n;
  d.rb = rb;
  d.L = n > rb ? n - rb : 0;
  d.T = 1 << d.L;
  d.Dp = d.T << rb;
  const int cap = kMaxThreads / d.T;
  d.rounds = (S + cap - 1) / cap;
  d.groups = (S + d.rounds - 1) / d.rounds;
  return d;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Byte offsets of the shared-memory regions of a CTA.
struct Layout {
  size_t coef;    // groups x 2G float4: the gate entries at the angles
  size_t region;  // groups x Dp float2: psi at logical indices for H psi
  size_t ops;     // 2 x G int4: the ops of the old and the new tape
  size_t x;       // S x R floats each: iterate, Adam moments, best
  size_t m;       //   iterate and gradient of every start
  size_t v;
  size_t bx;
  size_t be;      // S floats: best energy of every start
  size_t ring;    // groups x T (T + 1) floats: gradient parts, by lane
  size_t rowsum;  // groups x G floats: each op's gradient row
  size_t rowop;   // groups x T ints: the op of each ring row
  size_t first;   // R ints: the last op whose gradient feeds each angle
  size_t next;    // G ints: the op before it feeding the same angle, or -1
  size_t wre;     // G_f x Dp floats (when W is in shared memory)
  size_t wim;     // n_cplx x Dp floats: the non-zero imaginary planes
  size_t flips;   // G_f ints
  size_t wat;     // G_f ints: a group's imaginary plane, or -1
  size_t map;     // R ints
  size_t err;     // groups x G ints: error kinds per op (noise variant)
  size_t misc;    // 4 ints: op counts of both tapes, best start
  size_t total;
};

__host__ __device__ inline Layout make_layout(const Dims& d, int S, int G,
                                              int R, int n_groups, int n_cplx,
                                              bool noise, bool w_smem) {
  Layout l;
  size_t o = 0;
  const size_t sr = align16(sizeof(float) * (size_t)S * R);
  l.coef = o; o += align16(sizeof(float4) * 2 * (size_t)d.groups * G);
  l.region = o; o += align16(sizeof(float2) * (size_t)d.groups * d.Dp);
  l.ops = o; o += align16(sizeof(int4) * 2 * (size_t)G);
  l.x = o; o += sr;
  l.m = o; o += sr;
  l.v = o; o += sr;
  l.bx = o; o += sr;
  l.be = o; o += align16(sizeof(float) * (size_t)S);
  l.ring = o; o += align16(sizeof(float) * (size_t)d.groups * d.T *
                           (d.T + 1));
  l.rowsum = o; o += align16(sizeof(float) * (size_t)d.groups * G);
  l.rowop = o; o += align16(sizeof(int) * (size_t)d.groups * d.T);
  l.first = o; o += align16(sizeof(int) * (size_t)R);
  l.next = o; o += align16(sizeof(int) * (size_t)G);
  const size_t plane = w_smem ? sizeof(float) * d.Dp : 0;
  l.wre = o; o += align16(plane * n_groups);
  l.wim = o; o += align16(plane * n_cplx);
  l.flips = o; o += align16(sizeof(int) * (size_t)n_groups);
  l.wat = o; o += align16(sizeof(int) * (size_t)n_groups);
  l.map = o; o += align16(sizeof(int) * (size_t)R);
  l.err = o; o += align16(sizeof(int) * (noise ? (size_t)d.groups * G : 0));
  l.misc = o; o += align16(sizeof(int) * 4);
  l.total = o;
  return l;
}

// Physical bit of logical qubit q (lanes hold the low qubits).
__device__ __forceinline__ int phys(int q, int L, int rb) {
  return q < L ? rb + q : q - L;
}

// The live gates of `tape` (env e) as ops, in tape order, by warp 0 (32
// gates at a time, compacted by ballot); count into *nops.
__device__ __forceinline__ void build_ops(const Tape& tape, int e, int G,
                                          int L, int rb, int4* ops,
                                          int* nops) {
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const unsigned wmask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int lane = threadIdx.x;
  int count = 0;
  for (int base = 0; base < G; base += lanes) {
    const int g = base + lane;
    const size_t at = (size_t)e * G + g;
    const int k = g < G ? tape.kind[at] : kNone;
    const bool hit = k != kNone;
    const unsigned ballot = __ballot_sync(wmask, hit);
    if (hit) {
      const int t = phys(tape.tq[at], L, rb);
      const int cq = tape.cq[at], sl = tape.slot[at];
      const int cp = cq >= 0 ? phys(cq, L, rb) : -1;
      const bool grad = sl >= 0 && (k == kRX || k == kRY || k == kRZ);
      ops[count + __popc(ballot & ((1u << lane) - 1u))] = make_int4(
          k | (t << 4) | ((cp + 1) << 9) | (grad ? kGradBit : 0) |
              (gate_case(k, cq >= 0, t, rb) << 15),
          g, sl, 0);
    }
    count += __popc(ballot);
  }
  if (lane == 0) *nops = count;
}

// What one group works with: its start's rows and its own scratch.
struct Group {
  int t;             // thread index in the group
  int T, L, D, Dp;
  unsigned mask;     // the lanes of this warp's working groups
  bool noise;        // the noise variant (block-uniform)
  float4* coef;      // 2G: gate entries of the current tape at x
  float2* region;    // Dp
  int* err;          // G error kinds per op (noise variant)
  float* x;          // R
  float* m;
  float* v;
  float* bx;
  float* ring;       // T x (T + 1): row k's part of lane c at c (T + 1) + k
  float* rowsum;     // G: gradient row of each op of the old tape
  int* rowop;        // T: the op of each ring row
};

// Gate entries of every op at the iterate x (the caller's __syncwarp
// publishes them).
__device__ __forceinline__ void gate_coefs(const Group& gr, const int4* ops,
                                           int nops, const float* x) {
  for (int i = gr.t; i < nops; i += gr.T) {
    const int4 op = ops[i];
    float s = 0.f, c = 1.f;
    if (op.z >= 0) sincosf(0.5f * x[op.z], &s, &c);
    const Coef u = gate_coef(op_kind(op.x), c, s);
    gr.coef[2 * i] = make_float4(u.u00r, u.u00i, u.u01r, u.u01i);
    gr.coef[2 * i + 1] = make_float4(u.u10r, u.u10i, u.u11r, u.u11i);
  }
}

__device__ __forceinline__ Coef load_coef(const float4* coef, int i) {
  const float4 a = coef[2 * i], b = coef[2 * i + 1];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// Error kinds of every op at `tag` into the group's err (kt | kc << 8).
__device__ __forceinline__ void draw_errors(const Group& gr, const int4* ops,
                                            int nops,
                                            const int* __restrict__ seeds,
                                            int e, int tag, unsigned thr1,
                                            unsigned thr2) {
  const unsigned k0 = (unsigned)seeds[2 * e], k1 = (unsigned)seeds[2 * e + 1];
  for (int i = gr.t; i < nops; i += gr.T) {
    const int4 op = ops[i];
    int kt, kc;
    philox::error_kinds(op_kind(op.x), op.y, tag, k0, k1, thr1, thr2, kt,
                        kc);
    gr.err[i] = kt | (kc << 8);
  }
}

template <int RB>
__device__ __forceinline__ void load_psi0(Amps<RB>& s, const Group& gr,
                                          const float* __restrict__ p0re,
                                          const float* __restrict__ p0im) {
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    const int i = gr.t | (j << gr.L);
    const bool in = i < gr.D;             // false only below RB qubits
    s.pr[j] = in ? __ldg(p0re + i) : 0.f;
    s.pi[j] = in ? __ldg(p0im + i) : 0.f;
  }
}

// psi <- tape(x) psi, each gate followed by its drawn errors in the noise
// variant (an error on the control of a gate without one falls on qubit
// 0, physical bit q0).  The next op, its entries and its error kinds are
// read before the current one runs.
template <int RB>
__device__ __forceinline__ void forward(Amps<RB>& s, const Group& gr,
                                        const int4* ops, int nops, int q0) {
  int4 next = nops > 0 ? ops[0] : make_int4(0, 0, -1, 0);
  Coef next_u = load_coef(gr.coef, 0);
  int next_e = gr.noise && nops > 0 ? gr.err[0] : 0;
  for (int i = 0; i < nops; ++i) {
    const int4 op = next;
    const Coef u = next_u;
    const int ek = next_e;
    if (i + 1 < nops) {
      next = ops[i + 1];
      next_u = load_coef(gr.coef, i + 1);
      if (gr.noise) next_e = gr.err[i + 1];
    }
    const int p = op_p(op.x), q = op_q(op.x);
    gate_fwd<RB>(s, u, op_case(op.x), p, q, gr.mask);
    if (gr.noise) {                       // block-uniform
      if (ek & 255)
        pauli<RB, false, false>(s, ek & 255, p, nullptr, 0, gr.mask);
      if (ek >> 8)
        pauli<RB, false, false>(s, ek >> 8, q >= 0 ? q : q0, nullptr, 0,
                                gr.mask);
    }
  }
}

// lambda <- 2 conj(H psi) for this thread's amplitudes; returns Re<psi|H
// psi> / <psi|psi> (every thread of the group the same).  kSmemW: the W
// planes are in shared memory (row stride Dp, imaginary planes compact),
// else in global memory (row stride D, read through L2, every group's
// imaginary plane at its own row); wat[f] is the compact row of group f's
// imaginary plane, or -1 where it is zero.
template <int RB, bool kSmemW>
__device__ __forceinline__ float h_energy(Amps<RB>& s, const Group& gr,
                                          const float* wre, const float* wim,
                                          const int* flips, const int* wat,
                                          int n_groups) {
  constexpr int J = 1 << RB;
  const int stride = kSmemW ? gr.Dp : gr.D;
  __syncwarp(gr.mask);                    // the last reads of region done
#pragma unroll
  for (int j = 0; j < J; ++j) {
    gr.region[gr.t | (j << gr.L)] = make_float2(s.pr[j], s.pi[j]);
    s.lr[j] = 0.f;
    s.li[j] = 0.f;
  }
  __syncwarp(gr.mask);
  for (int f = 0; f < n_groups; ++f) {
    const int fl = flips[f], at = wat[f];
    const float* wr = wre + (size_t)f * stride;
    if (at >= 0) {
      const float* wi = wim + (size_t)(kSmemW ? at : f) * stride;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = gr.t | (j << gr.L);
        const float a = kSmemW ? wr[i] : __ldg(wr + i);
        const float b = kSmemW ? wi[i] : __ldg(wi + i);
        const float2 p = gr.region[i ^ fl];
        s.lr[j] = fmaf(a, p.x, s.lr[j]);
        s.lr[j] = fmaf(-b, p.y, s.lr[j]);
        s.li[j] = fmaf(a, p.y, s.li[j]);
        s.li[j] = fmaf(b, p.x, s.li[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = gr.t | (j << gr.L);
        const float a = kSmemW ? wr[i] : __ldg(wr + i);
        const float2 p = gr.region[i ^ fl];
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
  raw = warp_sum(raw, gr.mask, gr.T);
  nn = warp_sum(nn, gr.mask, gr.T);
  return (float)(raw / nn);
}

// The first `rows` rows of the ring summed over the group's lanes into
// rowsum at their ops: lane t sums row t in place by halves (lane c with
// lane c + T/2, then c + T/4, ...), the pairing of a shuffle butterfly,
// whose rounding it keeps.
__device__ __forceinline__ void flush_rows(const Group& gr, int rows) {
  __syncwarp(gr.mask);
  if (gr.t < rows) {
    float* row = gr.ring + gr.t;          // lane c's part at c (T + 1)
    for (int half = gr.T >> 1; half > 0; half >>= 1)
      for (int c = 0; c < half; ++c)
        row[c * (gr.T + 1)] += row[(c + half) * (gr.T + 1)];
    gr.rowsum[gr.rowop[gr.t]] = row[0];
  }
  __syncwarp(gr.mask);
}

// Adjoint sweep: the ops backwards, each gate's drawn errors undone first
// in the noise variant; each thread's part of a gate's gradient row goes
// to the ring (padded rows: conflict-free writes and reads), and every T
// rows, then at the end, the ring is summed into rowsum.
template <int RB>
__device__ __forceinline__ void backward(Amps<RB>& s, const Group& gr,
                                         const int4* ops, int nops, int q0) {
  int4 next = nops > 0 ? ops[nops - 1] : make_int4(0, 0, -1, 0);
  Coef next_u = load_coef(gr.coef, nops > 0 ? nops - 1 : 0);
  int next_e = gr.noise && nops > 0 ? gr.err[nops - 1] : 0;
  int rows = 0;                           // gradient rows written
  for (int i = nops - 1; i >= 0; --i) {
    const int4 op = next;
    const Coef u = next_u;
    const int ek = next_e;
    if (i > 0) {
      next = ops[i - 1];
      next_u = load_coef(gr.coef, i - 1);
      if (gr.noise) next_e = gr.err[i - 1];
    }
    const int p = op_p(op.x), q = op_q(op.x);
    if (gr.noise) {                       // block-uniform
      if (ek & 255)
        pauli<RB, true, false>(s, ek & 255, p, nullptr, 0, gr.mask);
      if (ek >> 8)
        pauli<RB, true, false>(s, ek >> 8, q >= 0 ? q : q0, nullptr, 0,
                               gr.mask);
    }
    const float gp = gate_adj<RB>(s, u, op_case(op.x), p, q, gr.mask);
    if (op.x & kGradBit) {                // block-uniform branch
      const int row = rows & (gr.T - 1);
      gr.ring[gr.t * (gr.T + 1) + row] = gp;
      if (gr.t == 0) gr.rowop[row] = i;
      if (row == gr.T - 1) flush_rows(gr, gr.T);
      ++rows;
    }
  }
  if (rows & (gr.T - 1)) flush_rows(gr, rows & (gr.T - 1));
}

// Everything the kernel's phases share.
struct Env {
  const int4* ops[2];       // old, new
  const int* nops;          // [0] old, [1] new
  // the W planes in shared memory and in global memory (two fields, not
  // one pointer chosen at run time, so that the shared-memory reads
  // compile to shared-memory loads)
  const float* swre;
  const float* swim;
  const float* wre;
  const float* wim;
  const int* flips;
  const int* wat;
  int n_groups;
  bool w_smem;
  int q0;                   // physical bit of qubit 0
  const float* p0re;
  const float* p0im;
  const int* seeds;
  int e;
  unsigned thr1, thr2;
};

// One evaluation at the group's current angles x of tape `which` (0 old,
// 1 new) under the errors drawn at `tag`: psi forward and H psi; returns
// the energy, lambda is left in the registers.
template <int RB>
__device__ __forceinline__ float evaluate(Amps<RB>& s, const Group& gr,
                                          const Env& env, int which,
                                          const float* x, int tag) {
  const int4* ops = env.ops[which];
  const int nops = env.nops[which];
  if (gr.noise)
    draw_errors(gr, ops, nops, env.seeds, env.e, tag, env.thr1, env.thr2);
  gate_coefs(gr, ops, nops, x);
  __syncwarp(gr.mask);
  load_psi0<RB>(s, gr, env.p0re, env.p0im);
  forward<RB>(s, gr, ops, nops, env.q0);
  return env.w_smem
             ? h_energy<RB, true>(s, gr, env.swre, env.swim, env.flips,
                                  env.wat, env.n_groups)
             : h_energy<RB, false>(s, gr, env.wre, env.wim, env.flips,
                                   env.wat, env.n_groups);
}

template <int RB>
__global__ void __launch_bounds__(kMaxThreads)
fused_adam_v1_kernel(Tape old_g, Tape new_g, const int* __restrict__ map_idx,
                     const float* __restrict__ p0re,
                     const float* __restrict__ p0im,
                     const float* __restrict__ wre,
                     const float* __restrict__ wim,
                     const int* __restrict__ flips,
                     const int* __restrict__ wim_at,
                     const float* __restrict__ starts,
                     const float* __restrict__ active,
                     const int* __restrict__ seeds,
                     float* __restrict__ x_opt, float* __restrict__ e_new,
                     int S, int G, int R, int n, int n_groups, int n_cplx,
                     int w_smem, int psi0_stride, int iters, float lr,
                     double b1, double b2, float omb1, float omb2, float eps,
                     unsigned thr1, unsigned thr2) {
  DYNAMIC_SHARED(smem_v1);
  const bool noise = seeds != nullptr;
  const Dims d = make_dims(n, S, RB);
  const Layout l = make_layout(d, S, G, R, n_groups, n_cplx, noise,
                               w_smem != 0);
  unsigned char* b = smem_v1;
  float* xs = reinterpret_cast<float*>(b + l.x);
  float* ms = reinterpret_cast<float*>(b + l.m);
  float* vs = reinterpret_cast<float*>(b + l.v);
  float* bxs = reinterpret_cast<float*>(b + l.bx);
  int* first = reinterpret_cast<int*>(b + l.first);
  int* next = reinterpret_cast<int*>(b + l.next);
  float* bes = reinterpret_cast<float*>(b + l.be);
  int* map = reinterpret_cast<int*>(b + l.map);
  int* misc = reinterpret_cast<int*>(b + l.misc);
  int4* ops = reinterpret_cast<int4*>(b + l.ops);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int e = blockIdx.x;

  Env env;
  env.ops[0] = ops;
  env.ops[1] = ops + G;
  env.nops = misc;
  env.n_groups = n_groups;
  env.w_smem = w_smem != 0;
  env.q0 = phys(0, d.L, RB);
  env.p0re = p0re + (size_t)e * psi0_stride;   // this env's psi0
  env.p0im = p0im + (size_t)e * psi0_stride;
  env.seeds = seeds;
  env.e = e;
  env.thr1 = thr1;
  env.thr2 = thr2;
  int* sflips = reinterpret_cast<int*>(b + l.flips);
  int* swat = reinterpret_cast<int*>(b + l.wat);
  env.flips = sflips;
  env.wat = swat;
  float* swre = reinterpret_cast<float*>(b + l.wre);
  float* swim = reinterpret_cast<float*>(b + l.wim);
  env.swre = swre;
  env.swim = swim;
  env.wre = wre;
  env.wim = wim;
  if (w_smem) {
    for (int idx = tid; idx < n_groups * d.Dp; idx += nthreads) {
      const int f = idx / d.Dp, i = idx - f * d.Dp;
      const bool in = i < d.D;
      swre[idx] = in ? wre[(size_t)f * d.D + i] : 0.f;
      const int at = wim_at[f];
      if (at >= 0) swim[(size_t)at * d.Dp + i] = in ? wim[(size_t)f * d.D + i]
                                                    : 0.f;
    }
  }
  for (int f = tid; f < n_groups; f += nthreads) {
    sflips[f] = flips[f];
    swat[f] = wim_at[f];
  }
  for (int r = tid; r < R; r += nthreads) map[r] = map_idx[(size_t)e * R + r];
  for (int idx = tid; idx < S * R; idx += nthreads) {
    const float x0 = starts[(size_t)e * S * R + idx];
    xs[idx] = x0;
    bxs[idx] = x0;
    ms[idx] = 0.f;
    vs[idx] = 0.f;
  }
  if (tid < 32) {
    build_ops(old_g, e, G, d.L, RB, ops, misc);
    build_ops(new_g, e, G, d.L, RB, ops + G, misc + 1);
    __syncwarp(blockDim.x < 32 ? (1u << blockDim.x) - 1u : 0xffffffffu);
    if (tid == 0) {                       // the ops feeding each angle
      for (int r = 0; r < R; ++r) first[r] = -1;
      for (int i = 0; i < misc[0]; ++i) {
        const int4 op = ops[i];
        if (op.x & kGradBit) {
          next[i] = first[op.z];
          first[op.z] = i;
        }
      }
    }
  }
  __syncthreads();

  const int grp = tid / d.T;
  Group gr;
  gr.t = tid - grp * d.T;
  gr.T = d.T;
  gr.L = d.L;
  gr.D = d.D;
  gr.Dp = d.Dp;
  gr.coef = reinterpret_cast<float4*>(b + l.coef) + (size_t)grp * 2 * G;
  gr.region = reinterpret_cast<float2*>(b + l.region) + (size_t)grp * d.Dp;
  gr.noise = noise;
  gr.err = reinterpret_cast<int*>(b + l.err) + (size_t)grp * G;
  gr.ring = reinterpret_cast<float*>(b + l.ring) +
            (size_t)grp * d.T * (d.T + 1);
  gr.rowsum = reinterpret_cast<float*>(b + l.rowsum) + (size_t)grp * G;
  gr.rowop = reinterpret_cast<int*>(b + l.rowop) + (size_t)grp * d.T;
  const float b1f = (float)b1, b2f = (float)b2;
  const float* act = active + (size_t)e * R;
  Amps<RB> s;
  for (int round = 0; round < d.rounds; ++round) {
    const int working = min(d.groups, S - round * d.groups);
    if (grp >= working) break;
    const int st = round * d.groups + grp;          // this group's start
    // the lanes of this warp whose groups work this round (a prefix)
    const int in_warp = min(32, working * d.T - (tid & ~31));
    gr.mask = in_warp >= 32 ? 0xffffffffu : (1u << in_warp) - 1u;
    gr.x = xs + (size_t)st * R;
    gr.m = ms + (size_t)st * R;
    gr.v = vs + (size_t)st * R;
    gr.bx = bxs + (size_t)st * R;
    float be = INFINITY;
    // b^t as a running product in double from the exact rates: the bias
    // corrections are then the plain version's 1 - b^t rounded once to
    // float (1.f - powf(0.999f, t) is off by 1.3e-5 relative at t = 1,
    // since 0.999f = 0.99900001)
    double b1t = 1.0, b2t = 1.0;
    for (int it = 0; it < iters; ++it) {
      const float ev = evaluate<RB>(s, gr, env, 0, gr.x, it);
      if (ev < be) {                      // each thread its own slots
        for (int r = gr.t; r < R; r += gr.T) gr.bx[r] = gr.x[r];
        be = ev;
      }
      backward<RB>(s, gr, env.ops[0], env.nops[0], env.q0);
      b1t *= b1;
      b2t *= b2;
      const float bc1 = (float)(1.0 - b1t);
      const float bc2 = (float)(1.0 - b2t);
      for (int r = gr.t; r < R; r += gr.T) {
        float dx = 0.f;                   // descending gate order
        for (int i = first[r]; i >= 0; i = next[i]) dx += gr.rowsum[i];
        const float g = dx * act[r];
        const float mm = b1f * gr.m[r] + omb1 * g;
        const float vv = b2f * gr.v[r] + omb2 * g * g;
        const float mhat = mm / bc1;
        const float vhat = vv / bc2;
        gr.x[r] = gr.x[r] - lr * mhat / (sqrtf(vhat) + eps);
        gr.m[r] = mm;
        gr.v[r] = vv;
      }
      __syncwarp(gr.mask);                // x complete
    }
    // the final iterate may beat the tracked best
    const float ev = evaluate<RB>(s, gr, env, 0, gr.x, iters);
    if (ev < be) {
      for (int r = gr.t; r < R; r += gr.T) gr.bx[r] = gr.x[r];
      be = ev;
    }
    if (gr.t == 0) bes[st] = be;
  }
  __syncthreads();

  if (tid == 0) {                         // first minimum, as argmin
    int bs = 0;
    for (int s2 = 1; s2 < S; ++s2)
      if (bes[s2] < bes[bs]) bs = s2;
    misc[2] = bs;
  }
  __syncthreads();
  const float* best = bxs + (size_t)misc[2] * R;
  for (int r = tid; r < R; r += nthreads) {
    x_opt[(size_t)e * R + r] = best[r];
    const int mj = map[r];
    xs[r] = mj >= 0 ? best[mj] : 0.f;   // row 0 <- x_new
  }
  __syncthreads();

  if (grp == 0) {                         // e_new on the new tape, group 0
    gr.mask = d.T >= 32 ? 0xffffffffu : (1u << d.T) - 1u;
    const float ev = evaluate<RB>(s, gr, env, 1, xs, iters + 1);
    if (gr.t == 0) e_new[e] = ev;
  }
}

// Whether rb register bits a thread can hold n qubits: 3 or 4, and a
// group within one warp.
bool valid_rb(int n, int rb) { return (rb == 3 || rb == 4) && n - rb <= 5; }

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks it against the
// card's per-block limit before launching, and first asks with w_smem = 1
// whether the W planes fit); 0 where rb cannot hold n qubits.  noise: the
// noise variant; n_cplx: the groups whose imaginary plane is not zero.
size_t fused_adam_v1_smem_bytes(int S, int G, int R, int n, int n_groups,
                                int n_cplx, int noise, int rb, int w_smem) {
  if (!valid_rb(n, rb)) return 0;
  return make_layout(make_dims(n, S, rb), S, G, R, n_groups, n_cplx,
                     noise != 0, w_smem != 0).total;
}

const char* fused_adam_v1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs asynchronously on `stream`.  wre / wim (G_f, D) flip-group planes,
// flips (G_f,), wim_at (G_f,): the rank of a group among those whose
// imaginary plane is not zero, or -1 (n_cplx of them); w_smem: W is read
// into shared memory (else it is read from global memory; only from
// rb qubits up).  A non-null `seeds` (E x 2 int32) launches the
// noise variant with fire thresholds thr1 (after rotations) and thr2
// (after CX) out of 2^24.  psi0_stride is 0 for (1, D) psi0 planes shared
// by the envs, D for (E, D) planes.  rb: 3 or 4 register bits a thread
// (2^rb amplitudes).  b1 and b2 are Adam's exact rates.
int fused_adam_v1_launch(const int* okind, const int* otq, const int* ocq,
                         const int* oslot, const int* nkind, const int* ntq,
                         const int* ncq, const int* nslot, const int* map_idx,
                         const float* p0re, const float* p0im,
                         const float* wre, const float* wim, const int* flips,
                         const int* wim_at, const float* starts,
                         const float* active, const int* seeds, float* x_opt,
                         float* e_new, int E, int S, int G, int R, int n,
                         int n_groups, int n_cplx, int rb, int w_smem,
                         int psi0_stride, int iters, float lr, double b1,
                         double b2, float omb1, float omb2, float eps,
                         unsigned thr1, unsigned thr2, void* stream) {
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < 1 || n > kMaxQubits ||
      !valid_rb(n, rb) || n_groups < 1 || n_cplx < 0 || n_cplx > n_groups ||
      iters < 0 || (!w_smem && n < rb) ||
      (psi0_stride != 0 && psi0_stride != 1 << n))
    return (int)cudaErrorInvalidValue;
  const Tape old_g = {okind, otq, ocq, oslot};
  const Tape new_g = {nkind, ntq, ncq, nslot};
  const Dims d = make_dims(n, S, rb);
  const size_t bytes = make_layout(d, S, G, R, n_groups, n_cplx,
                                   seeds != nullptr, w_smem != 0).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = rb == 3 ? fused_adam_v1_kernel<3> : fused_adam_v1_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  KERNEL_LAUNCH(
      kernel, E, d.groups * d.T, bytes, st, old_g, new_g, map_idx, p0re,
      p0im, wre, wim, flips, wim_at, starts, active, seeds, x_opt, e_new, S, G, R, n, n_groups, n_cplx, w_smem,
      psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1, thr2);
  return (int)cudaGetLastError();
}

}  // extern "C"
