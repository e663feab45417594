// Each env's own gate tape on its block of states, forward (B3f) and
// adjoint (B3b): the two kernels of the composed engine (CUDA, sm_90a), for
// 1 <= n <= 16 qubits.
//
// Replaces the TPU kernels tensorrl_qas_tpu/ops/pallas_apply.py:_fwd_kernel
// (launched by _call_fwd) and _bwd_kernel (launched by _call_bwd, the
// custom_vjp backward of apply_tape_pallas_ri).  The plain PyTorch versions
// of the same functions are tensorrl_qas_tpu_torch/ops/apply_tape.py:
// apply_tape_fwd_plain and apply_tape_bwd_plain.
//
// What is computed, for each (env e, start s) row:
//   forward:  psi = tape_e(angles[e, s]) psi0[e, s]
//   adjoint:  from the output psi and the cotangent lambda = gre - i gim,
//             for each gate g, last first:
//               dang[e, s, slot_g] += 1/2 Im[(P_g psi)^T lambda]
//               psi <- U_g^H psi,  lambda <- U_g^T lambda
//             then (dre, dim) = (Re lambda, -Im lambda).
// Gate kinds: the 1-qubit gates (gates.cuh; controlled when cq >= 0), CX,
// and the su4 set's RXX / RYY / RZZ = exp(-i theta/2 P_t P_c), whose cq is
// the second qubit.  The error Paulis that noise weaves into a tape (kinds
// X / Y / Z, slot -1) are plain 1-qubit gates to the register kernels;
// the wide kernels read a woven tape under its gates' schedule (below).
//
// Bound.  The planes are read and written once per launch: at the su4
// 8-qubit shapes (E = 128, S = 8, G = R = 30, D = 256) about 4.4 MB and 25
// MFLOP forward, 6.6 MB and 66 MFLOP adjoint, 1.3 and 2.0 us at the card's
// memory rate: a launch is bound by the latency of its gate chain (30
// dependent gates) and by its launch.  At the 12-qubit su4 trainer's
// shapes (E = 16, S = 8, G = R = 116, D = 4096) 8.5 MB and 160 MFLOP
// forward, 12.7 MB and 425 MFLOP adjoint: 2.5 and 6.3 us.
//
// The register kernels (1 <= n <= 9; apply_tape_*_reg_kernel).  Layout of
// fused_adam_v1.cu (twin: ops/fused_adam.py:group_layout): a row is a group
// of T = 2^(n - RB) threads of one warp, 2^RB amplitudes each in registers
// (regs.cuh:Amps), RB = 3 up to 8 qubits and 4 at 9; the low L = n - RB
// logical qubits sit on the lane bits, the others on the register bits, so
// register j of group thread t holds logical amplitude t | (j << L).  One
// CTA per env holds its S rows as S groups (in rounds past 256 threads);
// the env's tape is read into shared memory once, as ops (kNone left out),
// and each group computes its own gate entries at its row's angles.  The
// gate chain has no CTA barrier, only __syncwarp on the group's lanes: a
// gate on a register bit is local, one on a lane bit takes its partner by
// __shfl_xor_sync, a control is a predicate on the thread's own index
// (regs.cuh).  RXX / RYY pair amplitude i with i ^ 2^p ^ 2^q; that mask is
// a register part and a lane part, so a two-qubit rotation takes one
// shuffle of each value at most (none for RZZ, which is diagonal), whether
// its qubits sit on register bits, lane bits or one of each.  Every gate
// dispatches on one switch over the case its op carries, to a body with
// constant register indices.  The adjoint keeps psi and lambda in
// registers; each thread writes its part of a gradient gate's row to a
// ring of T padded rows in the group's shared memory, and every T rows
// (and at the end) lane t sums row t over the group in a shuffle
// butterfly's pairing, then lane 0 adds the sums to their dang slots in
// descending gate order: a fixed order, no atomics.  (A butterfly of
// shuffles at every gradient gate gave the same sums bit for bit but took
// 0.0278 ms of device time against the ring's 0.0218 at the su4 8-qubit
// shapes on the H100; PERF.md.)  dre / dim are skipped when the caller
// passes null pointers (nobody reads them).  All amplitude arithmetic is
// f32 FMA: no TF32.
//
// The wide kernels (10 <= n <= 16; apply_tape_*_wide_kernel).  B2's
// register layout (fused_adam_v2.cu): a thread holds 16 amplitudes of psi
// (and of lambda in the adjoint) in registers, amplitude p of a row's
// physical order in thread p >> 4, register p & 15; the physical bits are 4
// register bits, 5 lane bits -- logical qubits 0..4 for good, so that a
// warp reads and writes its 32 amplitudes of a register coalesced -- and
// above them the thread's warp bits, and from 13 qubits the cluster bits
// (the CTA's rank).  Up to 12 qubits a row is 2^(n - 4) threads of one CTA
// of 256, which holds 2^(12 - n) rows of one env (register rows); from 13
// a row is a thread-block cluster of 2^(n - 12) such CTAs (16 at 16 qubits,
// a non-portable size).  A schedule maps logical qubits onto physical bits:
//   - a 1-qubit gate (and CX) needs its target, RXX / RYY both of their
//     qubits, on register or lane bits: a register bit is local, a lane
//     bit takes its partner by __shfl_xor_sync, and a two-qubit rotation
//     takes one shuffle of each value at most (the register kernels'
//     bodies, above);
//   - a needed qubit on a warp bit is first swapped with a register bit
//     through shared memory (one CTA barrier; double-buffered), on a
//     cluster bit through the partner CTA's shared memory (distributed
//     shared memory, one cluster barrier; its own double buffer), and the
//     new map is kept;
//   - RZZ is diagonal and never swaps: its ZZ eigenvalue is a predicate on
//     the physical index, wherever its qubits sit;
//   - a control is a predicate on the thread's own index, and on a cluster
//     bit CTA-uniform (the CTA whose rank bit is clear skips the gate);
//   - an error Pauli of a woven tape (extend_tape_arrays: gate g at 3 g,
//     its errors at 3 g + 1 and 3 g + 2) falls where its qubit sits: Z a
//     sign on any bit, X / Y local, a shuffle, an exchange through shared
//     memory (warp bit) or of the whole slice with the partner CTA
//     (cluster bit).
// The schedule (Belady: the register evicted is the one whose qubit is
// needed furthest ahead) depends only on the noiseless tape, so one serves
// every noise realization: apply_tape_schedule_kernel builds it, one warp
// an env, into a buffer that every launch of a composed step reads (the
// step makes iters + 2 forward and iters adjoint launches on the same two
// tapes); twin: ops/apply_tape.py:tape_schedule_plain.  The forward runs
// it forwards from map0 and the adjoint backwards (a swap is its own
// inverse) from map1, ending on map0.  Gradient rows: a shuffle butterfly
// over each warp, lane 0 writes the warp's part by gate; after the sweep
// each angle sums its gates (last first, each over the row's warps in
// order), and in a cluster rank 0 adds every CTA's sums in rank order:
// no atomics, so two launches agree bit for bit.  The launch functions
// route by n.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "regs.cuh"

// The launches and the dynamic shared memory go through these two macros,
// so that tests/cuda_emu/cuda_runtime.h, which defines both (and emulates
// the cluster launch), can run this source on the host.
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
#define DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

using namespace gates;

enum : int { kRXX = 9, kRYY = 10, kRZZ = 11 };

// ---- the register kernels (1 <= n <= 9) ------------------------------------

constexpr int kRegMaxQubits = 9;
constexpr int kRegMaxThreads = 256;

// One op, (x, y, z) = (bits, case, slot): bits 0-3 the gate kind, 4-8 the
// target's physical bit, 9-13 the control's (or the second qubit's)
// physical bit + 1 (0: none), bit 14 set when the gate has an angle
// gradient; y the gate's case (op_case), z its angle slot (-1: none).
constexpr int kGradBit = 1 << 14;
// Cases past regs.cuh:gate_case's 0..29: RZZ, and RXX / RYY as kCaseRot2 +
// M + 16 * lane, M the register part of the pair mask, lane set when it
// has a lane part.
constexpr int kCaseRZZ = 30;
constexpr int kCaseRot2 = 32;

__device__ __forceinline__ int op_kind(int x) { return x & 15; }
__device__ __forceinline__ int op_p(int x) { return (x >> 4) & 31; }
__device__ __forceinline__ int op_q(int x) { return ((x >> 9) & 31) - 1; }

// X(M, LANE) for every pair mask a two-qubit rotation can have at RB <= 4:
// both qubits on register bits, one on each, both on lane bits.
#define FOR_ROT2_CASES(X)                                            \
  X(3, 0) X(5, 0) X(6, 0) X(9, 0) X(10, 0) X(12, 0)                  \
  X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(0, 1)

// How a CTA holds its env's rows (twin: ops/fused_adam.py:group_layout).
struct Dims {
  int D;       // 2^n
  int rb;      // register bits of a thread
  int L;       // lane bits of a group
  int T;       // threads of a group (one row)
  int groups;  // groups of the CTA
  int rounds;  // rounds over the starts
};

__host__ __device__ inline Dims make_dims(int n, int S) {
  Dims d;
  d.D = 1 << n;
  d.rb = n > 8 ? 4 : 3;
  d.L = n > d.rb ? n - d.rb : 0;
  d.T = 1 << d.L;
  const int cap = kRegMaxThreads / d.T;
  d.rounds = (S + cap - 1) / cap;
  d.groups = (S + d.rounds - 1) / d.rounds;
  return d;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Byte offsets of the shared-memory regions of a CTA.
struct Layout {
  size_t ops;    // G int4: the env's live gates
  size_t coef;   // groups x 2G float4: each op's entries at the row's angles
  size_t grad;   // groups x R floats: the row's angle gradients (adjoint)
  size_t ring;   // groups x T (T + 1) floats: gradient parts, by lane
  size_t rowslot;  // groups x T ints: the slot of each ring row
  size_t misc;   // 1 int: the op count
  size_t total;
};

__host__ __device__ inline Layout make_layout(const Dims& d, int G, int R,
                                              bool adjoint) {
  Layout l;
  size_t o = 0;
  l.ops = o; o += align16(sizeof(int4) * (size_t)G);
  l.coef = o; o += align16(sizeof(float4) * 2 * (size_t)d.groups * G);
  const size_t a = adjoint ? 1 : 0;
  l.grad = o; o += align16(a * sizeof(float) * d.groups * R);
  l.ring = o; o += align16(a * sizeof(float) * d.groups * d.T * (d.T + 1));
  l.rowslot = o; o += align16(a * sizeof(int) * d.groups * d.T);
  l.misc = o; o += align16(sizeof(int));
  l.total = o;
  return l;
}

// Physical bit of logical qubit q (lanes hold the low qubits).
__device__ __forceinline__ int phys(int q, int L, int rb) {
  return q < L ? rb + q : q - L;
}

// The case an op dispatches on (see kCaseRot2).
__device__ __forceinline__ int op_case(int k, int p, int q, int rb) {
  if (k == kRZZ) return kCaseRZZ;
  if (k >= kRXX) {
    const int m = (1 << p) | (1 << q);
    return kCaseRot2 + (m & ((1 << rb) - 1)) + ((m >> rb) ? 16 : 0);
  }
  return regs::gate_case(k, q >= 0, p, rb);
}

// The live gates of env e's tape as ops, in tape order, by warp 0 (32
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
      const int p = phys(tape.tq[at], L, rb);
      const int cq = tape.cq[at], sl = tape.slot[at];
      const int q = cq >= 0 ? phys(cq, L, rb) : -1;
      const bool grad = sl >= 0 && (k == kRX || k == kRY || k == kRZ ||
                                    k >= kRXX);
      ops[count + __popc(ballot & ((1u << lane) - 1u))] = make_int4(
          k | (p << 4) | ((q + 1) << 9) | (grad ? kGradBit : 0),
          op_case(k, p, q, rb), sl, 0);
    }
    count += __popc(ballot);
  }
  if (lane == 0) *nops = count;
}

// Each op's entries at the row's angles x into the group's coef: the 2x2
// unitary of a 1-qubit gate, (cos, sin) of a two-qubit rotation (the
// caller's __syncwarp publishes them).
__device__ __forceinline__ void row_coefs(float4* coef, const int4* ops,
                                          int nops, const float* x, int t,
                                          int T) {
  for (int i = t; i < nops; i += T) {
    const int4 op = ops[i];
    const int k = op_kind(op.x);
    float s = 0.f, c = 1.f;
    if (op.z >= 0) sincosf(0.5f * x[op.z], &s, &c);
    if (k >= kRXX) {
      coef[2 * i] = make_float4(c, s, 0.f, 0.f);
      coef[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const Coef u = gate_coef(k, c, s);
      coef[2 * i] = make_float4(u.u00r, u.u00i, u.u01r, u.u01i);
      coef[2 * i + 1] = make_float4(u.u10r, u.u10i, u.u11r, u.u11i);
    }
  }
}

__device__ __forceinline__ Coef load_coef(const float4* coef, int i) {
  const float4 a = coef[2 * i], b = coef[2 * i + 1];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// The ZZ eigenvalue of physical index i on bits p and q.
__device__ __forceinline__ float zz(int i, int p, int q) {
  return (((i >> p) ^ (i >> q)) & 1) ? -1.f : 1.f;
}

// (P psi)_i / psi_partner of XX (1) and YY (-z_i).
__device__ __forceinline__ float rot2_gf(bool yy, int i, int p, int q) {
  return yy ? -zz(i, p, q) : 1.f;
}

// One amplitude a of a two-qubit rotation exp(-i theta/2 P), (P psi)_i = q:
// forward a <- cos a - i sin q.
__device__ __forceinline__ void amp_fwd(float cs, float sn, float qr,
                                        float qi, float& ar, float& ai) {
  const float r = fmaf(sn, qi, cs * ar);
  ai = fmaf(-sn, qr, cs * ai);
  ar = r;
}

// The adjoint of one amplitude, its generator values q = (P psi)_i and
// h = (P lambda)_i: the gradient part 1/2 Im[q lambda_i], then psi <- (cos
// + i sin P) psi, lambda <- (cos - i sin P) lambda.
__device__ __forceinline__ void amp_adj(float cs, float sn, float qr,
                                        float qi, float hr, float hi,
                                        float& ar, float& ai, float& lr,
                                        float& li, float& gp) {
  gp = fmaf(0.5f, fmaf(qr, li, qi * lr), gp);
  const float a = fmaf(-sn, qi, cs * ar);
  ai = fmaf(sn, qr, cs * ai);
  ar = a;
  const float l = fmaf(sn, hi, cs * lr);
  li = fmaf(-sn, hr, cs * li);
  lr = l;
}

// RZZ: diagonal, (P psi)_i = z_i psi_i; returns the gradient part.
template <int RB, bool kAdj>
__device__ __forceinline__ float zz_gate(regs::Amps<RB>& s, float cs,
                                         float sn, int p, int q, int pbase) {
  float gps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    const float z = zz(pbase | j, p, q);
    const float qr = z * s.pr[j], qi = z * s.pi[j];
    if (kAdj)
      amp_adj(cs, sn, qr, qi, z * s.lr[j], z * s.li[j], s.pr[j], s.pi[j],
              s.lr[j], s.li[j], gps[j & 1]);
    else
      amp_fwd(cs, sn, qr, qi, s.pr[j], s.pi[j]);
  }
  return gps[0] + gps[1];
}

// RXX / RYY on the pair mask whose register part is M and whose lane part
// is lm (kLane: lm != 0): register j of this thread pairs with register
// j ^ M of lane ^ lm.  Each pair (j, j ^ M) is taken once, both partners'
// values read (or shuffled) before either is written.  Returns the
// gradient part (adjoint).
template <int RB, int M, bool kLane, bool kAdj>
__device__ __forceinline__ float rot2_gate(regs::Amps<RB>& s, float cs,
                                           float sn, bool yy, int p, int q,
                                           int lm, int pbase,
                                           unsigned mask) {
  float gps[2] = {0.f, 0.f};
  if constexpr (M < (1 << RB)) {
#pragma unroll
    for (int j = 0; j < (1 << RB); ++j) {
      const int jp = j ^ M;
      if (jp < j) continue;
      // the partner values of j (from jp) and of jp (from j)
      float br, bi, cr, ci, mr = 0.f, mi = 0.f, nr = 0.f, ni = 0.f;
      if (kLane) {
        br = __shfl_xor_sync(mask, s.pr[jp], lm);
        bi = __shfl_xor_sync(mask, s.pi[jp], lm);
        if (kAdj) {
          mr = __shfl_xor_sync(mask, s.lr[jp], lm);
          mi = __shfl_xor_sync(mask, s.li[jp], lm);
        }
        cr = br, ci = bi, nr = mr, ni = mi;
        if (jp != j) {
          cr = __shfl_xor_sync(mask, s.pr[j], lm);
          ci = __shfl_xor_sync(mask, s.pi[j], lm);
          if (kAdj) {
            nr = __shfl_xor_sync(mask, s.lr[j], lm);
            ni = __shfl_xor_sync(mask, s.li[j], lm);
          }
        }
      } else {
        br = s.pr[jp];
        bi = s.pi[jp];
        cr = s.pr[j];
        ci = s.pi[j];
        if (kAdj) {
          mr = s.lr[jp];
          mi = s.li[jp];
          nr = s.lr[j];
          ni = s.li[j];
        }
      }
      const float g0 = rot2_gf(yy, pbase | j, p, q);
      if (kAdj)
        amp_adj(cs, sn, g0 * br, g0 * bi, g0 * mr, g0 * mi, s.pr[j], s.pi[j],
                s.lr[j], s.li[j], gps[j & 1]);
      else
        amp_fwd(cs, sn, g0 * br, g0 * bi, s.pr[j], s.pi[j]);
      if (jp != j) {
        const float g1 = rot2_gf(yy, pbase | jp, p, q);
        if (kAdj)
          amp_adj(cs, sn, g1 * cr, g1 * ci, g1 * nr, g1 * ni, s.pr[jp],
                  s.pi[jp], s.lr[jp], s.li[jp], gps[jp & 1]);
        else
          amp_fwd(cs, sn, g1 * cr, g1 * ci, s.pr[jp], s.pi[jp]);
      }
    }
  }
  return gps[0] + gps[1];
}

// One op on the thread's registers: forward psi <- U psi, or (kAdj) the
// adjoint step, whose gradient part it returns (meaningful for ops with
// the gradient bit).  `prank`: the physical index bits above the CTA's
// (a cluster CTA's rank bits), which RZZ's eigenvalue may read.
template <int RB, bool kAdj>
__device__ __forceinline__ float apply_op(regs::Amps<RB>& s, const Coef& u,
                                          int4 op, unsigned mask,
                                          int prank = 0) {
  const int c = op.y, p = op_p(op.x), q = op_q(op.x);
  if (c < kCaseRZZ) {
    if (kAdj) return regs::gate_adj<RB>(s, u, c, p, q, mask);
    regs::gate_fwd<RB>(s, u, c, p, q, mask);
    return 0.f;
  }
  const int pbase = (threadIdx.x << RB) | prank;
  const float cs = u.u00r, sn = u.u00i;
  if (c == kCaseRZZ) return zz_gate<RB, kAdj>(s, cs, sn, p, q, pbase);
  const bool yy = op_kind(op.x) == kRYY;
  const int lm = ((1 << p) | (1 << q)) >> RB;
  float gp = 0.f;
  switch (c) {
#define ROT2_CASE(M, LANE)                                                 \
  case kCaseRot2 + (M) + 16 * (LANE):                                      \
    gp = rot2_gate<RB, M, (LANE) != 0, kAdj>(s, cs, sn, yy, p, q, lm,      \
                                             pbase, mask);                 \
    break;
    FOR_ROT2_CASES(ROT2_CASE)
#undef ROT2_CASE
  }
  return gp;
}

// A group's row: where it is, which lanes work, its slices of shared
// memory.
struct Row {
  size_t row;       // e * S + s
  int t, T, L, D;
  unsigned mask;    // the lanes of this warp's working groups
  float4* coef;
  float* grad;
  float* ring;      // T x (T + 1): row k's part of lane c at c (T + 1) + k
  int* rowslot;     // T: the slot of each ring row
};

// The group's row plane into registers (register j of thread t: logical
// amplitude t | (j << L); zeros past D, below RB qubits); with kNeg the
// negated plane (lambda's imaginary part from gim).
template <int RB, bool kNeg>
__device__ __forceinline__ void load_plane(float (&a)[1 << RB],
                                           const Row& rw,
                                           const float* __restrict__ src) {
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    const int i = rw.t | (j << rw.L);
    const float v = i < rw.D ? __ldg(src + rw.row * rw.D + i) : 0.f;
    a[j] = kNeg ? -v : v;
  }
}

template <int RB, bool kNeg>
__device__ __forceinline__ void store_plane(const float (&a)[1 << RB],
                                            const Row& rw, float* dst) {
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    const int i = rw.t | (j << rw.L);
    if (i < rw.D) dst[rw.row * rw.D + i] = kNeg ? -a[j] : a[j];
  }
}

// The first `rows` rows of the ring summed over the group's lanes: lane
// t sums row t in place by halves (lane c with lane c + T/2, then c + T/4,
// ...), the pairing of a shuffle butterfly; lane 0 then adds the sums to
// their slots in row order.
__device__ __forceinline__ void flush_rows(const Row& rw, int rows) {
  __syncwarp(rw.mask);
  if (rw.t < rows) {
    float* row = rw.ring + rw.t;          // lane c's part at c (T + 1)
    for (int half = rw.T >> 1; half > 0; half >>= 1)
      for (int c = 0; c < half; ++c)
        row[c * (rw.T + 1)] += row[(c + half) * (rw.T + 1)];
  }
  __syncwarp(rw.mask);
  if (rw.t == 0)
    for (int r = 0; r < rows; ++r) rw.grad[rw.rowslot[r]] += rw.ring[r];
}

// The ops in tape order (kAdj false) or backwards with each gradient
// gate's row summed over the group into grad in descending gate order,
// through the ring every T rows and at the end (kAdj).  The next op and
// its entries are read before the current one runs.
template <int RB, bool kAdj>
__device__ __forceinline__ void run_ops(regs::Amps<RB>& s, const Row& rw,
                                        const int4* ops, int nops) {
  if (nops == 0) return;
  const int first = kAdj ? nops - 1 : 0, step = kAdj ? -1 : 1;
  int4 next = ops[first];
  Coef next_u = load_coef(rw.coef, first);
  int rows = 0;                           // ring rows written
  for (int n = 0, i = first; n < nops; ++n, i += step) {
    const int4 op = next;
    const Coef u = next_u;
    if (n + 1 < nops) {
      next = ops[i + step];
      next_u = load_coef(rw.coef, i + step);
    }
    const float gp = apply_op<RB, kAdj>(s, u, op, rw.mask);
    if (!kAdj || !(op.x & kGradBit)) continue;   // block-uniform branch
    const int r = rows & (rw.T - 1);
    rw.ring[rw.t * (rw.T + 1) + r] = gp;
    if (rw.t == 0) rw.rowslot[r] = op.z;
    if (r == rw.T - 1) flush_rows(rw, rw.T);
    ++rows;
  }
  if (kAdj && (rows & (rw.T - 1))) flush_rows(rw, rows & (rw.T - 1));
}

// The group's row of round `round`; false when the group has none.
__device__ __forceinline__ bool group_row(Row& rw, const Dims& d, int S,
                                          int round) {
  const int tid = threadIdx.x, grp = tid / d.T;
  const int working = min(d.groups, S - round * d.groups);
  if (grp >= working) return false;
  // the lanes of this warp whose groups work this round (a prefix)
  const int in_warp = min(32, working * d.T - (tid & ~31));
  rw.mask = in_warp >= 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  rw.row = (size_t)blockIdx.x * S + round * d.groups + grp;
  return true;
}

// Set-up shared by both register kernels: the env's ops (one CTA
// barrier), then the group's fixed fields.  -> the op count.
template <bool kAdj>
__device__ __forceinline__ int setup(Row& rw, int4*& ops, const Tape& tape,
                                     const Dims& d, int G, int R,
                                     unsigned char* b) {
  const Layout l = make_layout(d, G, R, kAdj);
  ops = reinterpret_cast<int4*>(b + l.ops);
  int* misc = reinterpret_cast<int*>(b + l.misc);
  if (threadIdx.x < 32)
    build_ops(tape, blockIdx.x, G, d.L, d.rb, ops, misc);
  __syncthreads();
  const int grp = threadIdx.x / d.T;
  rw.t = threadIdx.x - grp * d.T;
  rw.T = d.T;
  rw.L = d.L;
  rw.D = d.D;
  rw.coef = reinterpret_cast<float4*>(b + l.coef) + (size_t)grp * 2 * G;
  rw.grad = reinterpret_cast<float*>(b + l.grad) + (size_t)grp * R;
  rw.ring = reinterpret_cast<float*>(b + l.ring) +
            (size_t)grp * d.T * (d.T + 1);
  rw.rowslot = reinterpret_cast<int*>(b + l.rowslot) + (size_t)grp * d.T;
  return misc[0];
}

// Both register kernels ask for one CTA an SM (an env's CTA), so that
// ptxas may take up to 255 registers a thread: with the thread count
// alone it held the 16-amplitude forward to 128 and spilled.
template <int RB>
__global__ void __launch_bounds__(kRegMaxThreads, 1)
apply_tape_fwd_reg_kernel(Tape tape, const float* __restrict__ angles,
                          const float* __restrict__ re,
                          const float* __restrict__ im,
                          float* __restrict__ ore, float* __restrict__ oim,
                          int S, int G, int R, int n) {
  DYNAMIC_SHARED(smem_fwd_reg);
  const Dims d = make_dims(n, S);
  Row rw;
  int4* ops;
  const int nops = setup<false>(rw, ops, tape, d, G, R, smem_fwd_reg);
  regs::Amps<RB> s;
  for (int round = 0; round < d.rounds; ++round) {
    if (!group_row(rw, d, S, round)) break;
    __syncwarp(rw.mask);                  // the last round's reads done
    row_coefs(rw.coef, ops, nops, angles + rw.row * R, rw.t, rw.T);
    __syncwarp(rw.mask);
    load_plane<RB, false>(s.pr, rw, re);
    load_plane<RB, false>(s.pi, rw, im);
    run_ops<RB, false>(s, rw, ops, nops);
    store_plane<RB, false>(s.pr, rw, ore);
    store_plane<RB, false>(s.pi, rw, oim);
  }
}

template <int RB>
__global__ void __launch_bounds__(kRegMaxThreads, 1)
apply_tape_bwd_reg_kernel(Tape tape, const float* __restrict__ angles,
                          const float* __restrict__ ore,
                          const float* __restrict__ oim,
                          const float* __restrict__ gre,
                          const float* __restrict__ gim,
                          float* __restrict__ dre, float* __restrict__ dim,
                          float* __restrict__ dang, int S, int G, int R,
                          int n) {
  DYNAMIC_SHARED(smem_bwd_reg);
  const Dims d = make_dims(n, S);
  Row rw;
  int4* ops;
  const int nops = setup<true>(rw, ops, tape, d, G, R, smem_bwd_reg);
  regs::Amps<RB> s;
  for (int round = 0; round < d.rounds; ++round) {
    if (!group_row(rw, d, S, round)) break;
    __syncwarp(rw.mask);                  // the last round's reads done
    row_coefs(rw.coef, ops, nops, angles + rw.row * R, rw.t, rw.T);
    for (int r = rw.t; r < R; r += rw.T) rw.grad[r] = 0.f;
    __syncwarp(rw.mask);
    load_plane<RB, false>(s.pr, rw, ore);
    load_plane<RB, false>(s.pi, rw, oim);
    load_plane<RB, false>(s.lr, rw, gre);
    load_plane<RB, true>(s.li, rw, gim);
    run_ops<RB, true>(s, rw, ops, nops);
    if (dre != nullptr) {
      store_plane<RB, false>(s.lr, rw, dre);
      store_plane<RB, true>(s.li, rw, dim);
    }
    __syncwarp(rw.mask);                  // lane 0's gradient sums
    for (int r = rw.t; r < R; r += rw.T) dang[rw.row * R + r] = rw.grad[r];
  }
}

// ---- the wide kernels (10 <= n <= 16) -------------------------------------

constexpr int kWideMinQubits = 10;
constexpr int kWideMaxQubits = 16;
constexpr int kWideThreads = 256;         // a CTA: 16 amplitudes a thread
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideRB = 4;
constexpr int kLaneBits = 5;              // logical qubits 0..4, for good
constexpr int kFirstWarpBit = kWideRB + kLaneBits;
constexpr int kClusterBit = 12;           // a CTA's rank bits from here
constexpr int kCtaAmps = kWideThreads << kWideRB;
constexpr unsigned kFull = 0xffffffffu;
// A swap op: bits 0-3 kSwapOp, 4-8 the register bit, 9-13 the warp or
// cluster bit + 1; w its gate (whose entries the loop reads ahead).
constexpr int kSwapOp = 15;
// A schedule row (int32 words): [0] the op count, [1, 17) map0 (the
// logical qubit at each physical bit where the forward pass begins), [17,
// 33) map1 (where it ends), [33] n; from kHeader 3 G ops of 4 words (x, y,
// z, w) = (bits, case, slot, gate), then R words sfirst (each angle's last
// gradient gate, -1: none) and G words gnext (the gradient gate before it
// of the same angle, -1: none); padded to 4 words.
constexpr int kHeader = 36;
constexpr int kMaxMap = 16;

namespace cg = cooperative_groups;

__host__ __device__ inline int sched_words(int G, int R) {
  return (kHeader + 12 * G + R + G + 3) & ~3;
}

// Rows of a register-row CTA (2^(12 - n) rows of 2^(n - 4) threads below
// 12 qubits) and CTAs of a row (a cluster of 2^(n - 12) above).
__host__ __device__ inline int wide_rows(int n) {
  return n < kClusterBit ? 1 << (kClusterBit - n) : 1;
}
__host__ __device__ inline int wide_ctas(int n) {
  return n > kClusterBit ? 1 << (n - kClusterBit) : 1;
}

// The qubits gate (k, t, c) needs on a register or lane bit: a 1-qubit
// gate's (and CX's) target, both qubits of RXX / RYY; none for RZZ, which
// is diagonal.  -> their count.
__host__ __device__ inline int local_needs(int k, int t, int c,
                                           int (&q)[2]) {
  if (k == kNone || k == kRZZ) return 0;
  q[0] = t;
  q[1] = c;
  return k == kRXX || k == kRYY ? 2 : 1;
}

__device__ __forceinline__ bool has_grad(int k, int sl) {
  return k != kNone && sl >= 0 &&
         (k == kRX || k == kRY || k == kRZ || k >= kRXX);
}

// The schedule of one tape (kind / tq / cq / slot: G gates) into `row`
// (sched_words(G, R) words, zeroed), by one thread; twin: ops/
// apply_tape.py:tape_schedule_plain.  Lane bits hold qubits 0..4 for good;
// the register bits start with the four other qubits needed first and the
// warp / cluster bits with the rest in ascending order.  Before each gate
// every qubit it needs (local_needs) that sits above the lane bits is
// swapped into the register bit whose qubit is needed furthest ahead
// (Belady; ties: the lowest register bit), never one that gate needs.
// `after` (2 G ints) and `work` (4 kMaxMap ints) are scratch.
__device__ void build_wide_schedule(const int* kind, const int* tq,
                                    const int* cq, const int* slot, int G,
                                    int R, int n, int* after, int* work,
                                    int* row) {
  int* first = work;                      // next need of each qubit
  int* occ = work + kMaxMap;              // physical bit -> qubit
  int* pos = work + 2 * kMaxMap;          // qubit -> physical bit
  int* nu = work + 3 * kMaxMap;           // next need, as the pass goes
  for (int q = 0; q < n; ++q) first[q] = G;
  for (int g = G - 1; g >= 0; --g) {
    int need[2];
    const int m = local_needs(kind[g], tq[g], cq[g], need);
    for (int j = 0; j < m; ++j) {
      after[2 * g + j] = first[need[j]];
      first[need[j]] = g;
    }
  }
  unsigned placed = 0;
  for (int a = 0; a < kWideRB; ++a) {
    int best = -1;
    for (int q = kLaneBits; q < n; ++q)
      if (!((placed >> q) & 1) && (best < 0 || first[q] < first[best]))
        best = q;
    occ[a] = best;
    placed |= 1u << best;
  }
  for (int l = 0; l < kLaneBits; ++l) occ[kWideRB + l] = l;
  int w = kFirstWarpBit;
  for (int q = kLaneBits; q < n; ++q)
    if (!((placed >> q) & 1)) occ[w++] = q;
  for (int p = 0; p < n; ++p) {
    pos[occ[p]] = p;
    row[1 + p] = occ[p];
  }
  for (int q = 0; q < n; ++q) nu[q] = first[q];
  int4* ops = reinterpret_cast<int4*>(row + kHeader);
  int c = 0;
  for (int g = 0; g < G; ++g) {
    const int k = kind[g];
    if (k == kNone) continue;
    int need[2];
    const int m = local_needs(k, tq[g], cq[g], need);
    for (int j = 0; j < m; ++j) {
      const int q = need[j], b = pos[q];
      if (b < kFirstWarpBit) continue;
      int a = -1;
      for (int r = 0; r < kWideRB; ++r) {
        const int o = occ[r];
        if (o == need[0] || (m > 1 && o == need[1])) continue;
        if (a < 0 || nu[o] > nu[occ[a]]) a = r;
      }
      const int qa = occ[a];
      ops[c++] = make_int4(kSwapOp | (a << 4) | ((b + 1) << 9), 0, -1, g);
      occ[a] = q;
      occ[b] = qa;
      pos[q] = a;
      pos[qa] = b;
    }
    const int t = tq[g], cc = cq[g], sl = slot[g];
    const int p = pos[t], qq = cc >= 0 ? pos[cc] : -1;
    ops[c++] = make_int4(k | (p << 4) | ((qq + 1) << 9) |
                             (has_grad(k, sl) ? kGradBit : 0),
                         op_case(k, p, qq, kWideRB), sl, g);
    for (int j = 0; j < m; ++j) nu[need[j]] = after[2 * g + j];
  }
  row[0] = c;
  for (int p = 0; p < n; ++p) row[1 + kMaxMap + p] = occ[p];
  row[1 + 2 * kMaxMap] = n;
  int* sfirst = row + kHeader + 12 * G;
  int* gnext = sfirst + R;
  for (int r = 0; r < R; ++r) sfirst[r] = -1;
  for (int g = 0; g < G; ++g) {
    const bool grad = has_grad(kind[g], slot[g]);
    gnext[g] = grad ? sfirst[slot[g]] : -1;
    if (grad) sfirst[slot[g]] = g;
  }
}

size_t sched_smem_bytes(int G, int R) {
  return sizeof(int) * ((size_t)sched_words(G, R) + 6 * (size_t)G +
                        4 * kMaxMap);
}

// One warp an env: the tape into shared memory, the schedule by lane 0,
// the row out (every word, so unused ops are zero).
__global__ void __launch_bounds__(32)
apply_tape_schedule_kernel(Tape tape, int G, int R, int n,
                           int* __restrict__ out) {
  DYNAMIC_SHARED(smem_sched);
  const int W = sched_words(G, R);
  int* row = reinterpret_cast<int*>(smem_sched);
  int* kind = row + W;
  int* tq = kind + G;
  int* cq = tq + G;
  int* slot = cq + G;
  int* after = slot + G;
  int* work = after + 2 * G;
  const int lane = threadIdx.x;
  const size_t e = blockIdx.x;
  for (int i = lane; i < W; i += 32) row[i] = 0;
  for (int g = lane; g < G; g += 32) {
    kind[g] = tape.kind[e * G + g];
    tq[g] = tape.tq[e * G + g];
    cq[g] = tape.cq[e * G + g];
    slot[g] = tape.slot[e * G + g];
  }
  __syncwarp();
  if (lane == 0)
    build_wide_schedule(kind, tq, cq, slot, G, R, n, after, work, row);
  __syncwarp();
  for (int i = lane; i < W; i += 32) out[e * W + i] = row[i];
}

// Byte offsets of a wide CTA's shared memory.
struct WideLayout {
  size_t ops;      // 3 G int4: the env's schedule
  size_t coef;     // rows x 2 G float4: each gate's entries at a row's angles
  size_t region;   // 4 kCtaAmps floats: the warp swaps' two buffers, or a
                   // Pauli's exchange on a warp bit
  size_t cbuf;     // 4 kCtaAmps floats (clusters): what partners write in
  size_t gpart;    // G x warps floats (adjoint): a gate's row, by warp
  size_t cdx;      // C x R floats (adjoint, clusters): every rank's sums
  size_t errk;     // 2 G ints (woven tapes): each gate's error kinds
  size_t chain;    // R + G ints (adjoint): sfirst, gnext
  size_t map;      // 2 kMaxMap + 1 ints: map0, map1, the op count
  size_t total;
};

__host__ __device__ inline WideLayout wide_layout(int n, int G, int R,
                                                  bool adjoint, bool woven) {
  WideLayout l;
  size_t o = 0;
  const size_t a = adjoint ? 1 : 0, c = n > kClusterBit ? 1 : 0;
  l.ops = o; o += align16(sizeof(int4) * 3 * (size_t)G);
  l.coef = o; o += align16(sizeof(float4) * 2 * (size_t)G * wide_rows(n));
  l.region = o; o += align16(sizeof(float) * 4 * (size_t)kCtaAmps);
  l.cbuf = o; o += align16(c * sizeof(float) * 4 * kCtaAmps);
  l.gpart = o; o += align16(a * sizeof(float) * (size_t)G * kWideWarps);
  l.cdx = o; o += align16(a * c * sizeof(float) * wide_ctas(n) * R);
  l.errk = o; o += align16((woven ? 1 : 0) * sizeof(int) * 2 * (size_t)G);
  l.chain = o; o += align16(a * sizeof(int) * ((size_t)R + G));
  l.map = o; o += align16(sizeof(int) * (2 * kMaxMap + 1));
  l.total = o;
  return l;
}

// A thread's row and the CTA's shared memory.
struct WideRow {
  int4* ops;
  float4* coef;    // this row's slice
  float* region;
  float* cbuf;
  float* gpart;
  float* cdx;
  int* errk;
  int* sfirst;
  int* gnext;
  int* map0;
  int* map1;
  int nops;
  int rank;        // the CTA's rank in its row's cluster (0: a CTA a row)
  int t;           // the thread's index among its row's threads
  int rs;          // the row's slot in the CTA
  int T;           // threads of the row in this CTA
  size_t row;      // e * S + s (an idle slot: its CTA's last row)
  int e;           // the env (tape row)
  bool live;       // the slot holds a row
};

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

template <class P>
__device__ __forceinline__ P* at_rank(P* p, int r) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)r);
}

// Set-up: the row, the env's schedule, its woven error kinds and the
// row's gate entries into shared memory; a CTA (cluster) barrier.  A row
// with a woven tape (weave 3: extend_tape_arrays' order) reads gate g at
// tape position 3 g and its errors at 3 g + 1 (target) and 3 g + 2
// (control); the schedule row is e % es.
template <bool kCl, bool kAdj>
__device__ __forceinline__ void wide_setup(
    WideRow& w, unsigned char* b, const Tape& tape,
    const int* __restrict__ sched, int es, int weave,
    const float* __restrict__ angles, int S, int G, int R, int n) {
  const bool woven = weave == 3;
  const WideLayout l = wide_layout(n, G, R, kAdj, woven);
  const int tid = threadIdx.x;
  w.ops = reinterpret_cast<int4*>(b + l.ops);
  w.region = reinterpret_cast<float*>(b + l.region);
  w.cbuf = reinterpret_cast<float*>(b + l.cbuf);
  w.gpart = reinterpret_cast<float*>(b + l.gpart);
  w.cdx = reinterpret_cast<float*>(b + l.cdx);
  w.errk = reinterpret_cast<int*>(b + l.errk);
  w.sfirst = reinterpret_cast<int*>(b + l.chain);
  w.gnext = w.sfirst + R;
  w.map0 = reinterpret_cast<int*>(b + l.map);
  w.map1 = w.map0 + kMaxMap;
  if (kCl) {
    w.rank = (int)cg::this_cluster().block_rank();
    w.T = kWideThreads;
    w.rs = 0;
    w.t = w.rank * kWideThreads + tid;
    w.row = blockIdx.x >> (n - kClusterBit);
    w.live = true;
  } else {
    const int T = 1 << (n - kWideRB), rows = kWideThreads / T;
    const int nb = (S + rows - 1) / rows;
    const int blk = blockIdx.x % nb;
    w.rank = 0;
    w.T = T;
    w.rs = tid / T;
    w.t = tid - w.rs * T;
    const int s = blk * rows + w.rs;
    w.live = s < S;
    w.row = (size_t)(blockIdx.x / nb) * S + (s < S ? s : S - 1);
  }
  w.e = (int)(w.row / S);
  const int* src = sched + (size_t)(w.e % es) * sched_words(G, R);
  const int nops = src[0];
  int* ow = reinterpret_cast<int*>(w.ops);
#pragma unroll 1
  for (int i = tid; i < 4 * nops; i += kWideThreads)
    ow[i] = src[kHeader + i];
  if (tid < 2 * kMaxMap) w.map0[tid] = src[1 + tid];
  if (kAdj)
#pragma unroll 1
    for (int i = tid; i < R + G; i += kWideThreads)
      w.sfirst[i] = src[kHeader + 12 * G + i];
  const size_t base = (size_t)w.e * weave * G;
  if (woven)
#pragma unroll 1
    for (int g = tid; g < G; g += kWideThreads) {
      w.errk[2 * g] = tape.kind[base + 3 * g + 1];
      w.errk[2 * g + 1] = tape.kind[base + 3 * g + 2];
    }
  w.coef = reinterpret_cast<float4*>(b + l.coef) + (size_t)w.rs * 2 * G;
  const float* x = angles + w.row * R;
  const int t0 = kCl ? tid : w.t, step = kCl ? kWideThreads : w.T;
#pragma unroll 1
  for (int g = t0; g < G; g += step) {
    const size_t at = base + (size_t)g * weave;
    const int k = tape.kind[at], sl = tape.slot[at];
    float sn = 0.f, cs = 1.f;
    if (sl >= 0) sincosf(0.5f * x[sl], &sn, &cs);
    if (k >= kRXX) {
      w.coef[2 * g] = make_float4(cs, sn, 0.f, 0.f);
      w.coef[2 * g + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const Coef u = gate_coef(k, cs, sn);
      w.coef[2 * g] = make_float4(u.u00r, u.u00i, u.u01r, u.u01i);
      w.coef[2 * g + 1] = make_float4(u.u10r, u.u10i, u.u11r, u.u11i);
    }
  }
  w.nops = nops;
  // in a cluster also: every CTA runs before any reaches into another's
  // shared memory
  if constexpr (kCl) cluster_sync(); else __syncthreads();
}

// Logical index of register j of the row's thread t under `map` (physical
// bit -> logical qubit).
__device__ __forceinline__ void wide_indices(const int* map, int n, int t,
                                             int (&idx)[1 << kWideRB]) {
  int base = 0;
#pragma unroll 1
  for (int b = 0; b < n - kWideRB; ++b)
    base |= ((t >> b) & 1) << map[kWideRB + b];
  int bit[kWideRB];
#pragma unroll
  for (int a = 0; a < kWideRB; ++a) bit[a] = 1 << map[a];
#pragma unroll
  for (int j = 0; j < (1 << kWideRB); ++j) {
    int i = base;
#pragma unroll
    for (int a = 0; a < kWideRB; ++a)
      if ((j >> a) & 1) i |= bit[a];
    idx[j] = i;
  }
}

template <bool kNeg>
__device__ __forceinline__ void wide_load(float (&a)[1 << kWideRB],
                                          const float* __restrict__ src,
                                          const int (&idx)[1 << kWideRB],
                                          bool live) {
#pragma unroll
  for (int j = 0; j < (1 << kWideRB); ++j) {
    const float v = live ? __ldg(src + idx[j]) : 0.f;
    a[j] = kNeg ? -v : v;
  }
}

template <bool kNeg>
__device__ __forceinline__ void wide_store(const float (&a)[1 << kWideRB],
                                           float* dst,
                                           const int (&idx)[1 << kWideRB],
                                           bool live) {
  if (!live) return;
#pragma unroll
  for (int j = 0; j < (1 << kWideRB); ++j) dst[idx[j]] = kNeg ? -a[j] : a[j];
}

// -- swaps (the schedule of fused_adam_v2.cu's register and cluster
// kernels, copied: B2's source stays as it is) ------------------------------

// One plane of a swap, out (trade) and in (take): chunk c of plane q of
// thread t at float4 (q * C + c) * T + t (conflict-free).
template <int P>
__device__ __forceinline__ void trade(const float (&v)[P], float4* b4,
                                      int q) {
  constexpr int C = P / 4;
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < C; ++c)
    b4[(q * C + c) * kWideThreads + tid] =
        make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

template <int P>
__device__ __forceinline__ void take(float (&v)[P], const float4* b4, int q,
                                     int partner) {
  constexpr int C = P / 4;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 r = b4[(q * C + c) * kWideThreads + partner];
    v[4 * c] = r.x;
    v[4 * c + 1] = r.y;
    v[4 * c + 2] = r.z;
    v[4 * c + 3] = r.w;
  }
}

// The half of one plane that register bit A sends across a bit whose
// value here is beta (pair k's end where A differs from beta), and its
// return.
template <int A>
__device__ __forceinline__ void sent_half(const float (&x)[1 << kWideRB],
                                          int beta,
                                          float (&v)[1 << (kWideRB - 1)]) {
#pragma unroll
  for (int k = 0; k < (1 << (kWideRB - 1)); ++k) {
    const int j0 = regs::pair_j0<A>(k), j1 = j0 | (1 << A);
    v[k] = beta ? x[j0] : x[j1];
  }
}

template <int A>
__device__ __forceinline__ void put_half(
    float (&x)[1 << kWideRB], int beta, const float (&v)[1 << (kWideRB - 1)]) {
#pragma unroll
  for (int k = 0; k < (1 << (kWideRB - 1)); ++k) {
    const int j0 = regs::pair_j0<A>(k), j1 = j0 | (1 << A);
    x[j0] = beta ? v[k] : x[j0];
    x[j1] = beta ? x[j1] : v[k];
  }
}

// Register bit A with a bit whose value here is beta: the sent halves of
// psi (and lambda) into `out`, a barrier (of the cluster with kCluster, of
// the CTA without), this thread's returns from `in` at `from`.
template <int A, bool kLambda, bool kCluster>
__device__ __forceinline__ void exchange(regs::Amps<kWideRB>& s, int beta,
                                         float4* out, const float4* in,
                                         int from) {
  constexpr int P = 1 << (kWideRB - 1);
  float v[P];
  sent_half<A>(s.pr, beta, v);
  trade<P>(v, out, 0);
  sent_half<A>(s.pi, beta, v);
  trade<P>(v, out, 1);
  if (kLambda) {
    sent_half<A>(s.lr, beta, v);
    trade<P>(v, out, 2);
    sent_half<A>(s.li, beta, v);
    trade<P>(v, out, 3);
  }
  if (kCluster) cluster_sync(); else __syncthreads();
  take<P>(v, in, 0, from);
  put_half<A>(s.pr, beta, v);
  take<P>(v, in, 1, from);
  put_half<A>(s.pi, beta, v);
  if (kLambda) {
    take<P>(v, in, 2, from);
    put_half<A>(s.lr, beta, v);
    take<P>(v, in, 3, from);
    put_half<A>(s.li, beta, v);
  }
}

// Swap op x: register bit a with warp bit b through `region` (buffer
// `parity`: the partner thread across b reads what this one wrote), or,
// in a cluster, with cluster bit b through the partner CTA's `cbuf`
// (buffer `cparity`, its own double buffer: a CTA may run on to its next
// warp swap while the partner still reads the last cluster swap).
template <bool kCl, bool kLambda>
__device__ __forceinline__ void wide_swap(regs::Amps<kWideRB>& s, int x,
                                          const WideRow& w, int& parity,
                                          int& cparity) {
  constexpr int RB = kWideRB;
  const int a = op_p(x), b = op_q(x), tid = threadIdx.x;
  if (kCl && b >= kClusterBit) {
    const int cb = b - kClusterBit;
    float* buf = w.cbuf + cparity * 2 * kCtaAmps;
    float4* out = reinterpret_cast<float4*>(
        at_rank(buf, (int)cg::this_cluster().block_rank() ^ (1 << cb)));
    const float4* in = reinterpret_cast<const float4*>(buf);
    const int beta = (w.rank >> cb) & 1;
    WITH_REG_BIT(a, (exchange<A, kLambda, true>(s, beta, out, in, tid)));
    cparity ^= 1;
    return;
  }
  const int tb = b - RB;
  float4* b4 = reinterpret_cast<float4*>(w.region + parity * 2 * kCtaAmps);
  WITH_REG_BIT(a, (exchange<A, kLambda, false>(s, (tid >> tb) & 1, b4, b4,
                                               tid ^ (1 << tb))));
  parity ^= 1;
}

// Pauli k on cluster bit cb: Z a sign on the CTA whose rank bit is set; X
// and Y the whole slice (psi, and lambda with kAdj) exchanged with the
// partner CTA through its `cbuf` (both buffers; cluster barriers before
// and after), applied four amplitudes at a time.
template <bool kAdj>
__device__ __forceinline__ void cluster_pauli(regs::Amps<kWideRB>& s, int k,
                                              int cb, const WideRow& w) {
  constexpr int J = 1 << kWideRB, C = J / 4;
  const int beta = (w.rank >> cb) & 1, tid = threadIdx.x;
  if (k == kZ) {
    if (beta) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s.pr[j] = -s.pr[j];
        s.pi[j] = -s.pi[j];
        if (kAdj) {
          s.lr[j] = -s.lr[j];
          s.li[j] = -s.li[j];
        }
      }
    }
    return;
  }
  float4* out = reinterpret_cast<float4*>(
      at_rank(w.cbuf, (int)cg::this_cluster().block_rank() ^ (1 << cb)));
  const float4* in = reinterpret_cast<const float4*>(w.cbuf);
  cluster_sync();                         // the last exchange's reads are done
  trade<J>(s.pr, out, 0);
  trade<J>(s.pi, out, 1);
  if (kAdj) {
    trade<J>(s.lr, out, 2);
    trade<J>(s.li, out, 3);
  }
  cluster_sync();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 r = in[(0 * C + c) * kWideThreads + tid];
    const float4 i = in[(1 * C + c) * kWideThreads + tid];
    regs::pauli_one<false>(k, beta, s.pr[4 * c], s.pi[4 * c], r.x, i.x);
    regs::pauli_one<false>(k, beta, s.pr[4 * c + 1], s.pi[4 * c + 1], r.y,
                           i.y);
    regs::pauli_one<false>(k, beta, s.pr[4 * c + 2], s.pi[4 * c + 2], r.z,
                           i.z);
    regs::pauli_one<false>(k, beta, s.pr[4 * c + 3], s.pi[4 * c + 3], r.w,
                           i.w);
    if (kAdj) {
      const float4 lr = in[(2 * C + c) * kWideThreads + tid];
      const float4 li = in[(3 * C + c) * kWideThreads + tid];
      regs::pauli_one<true>(k, beta, s.lr[4 * c], s.li[4 * c], lr.x, li.x);
      regs::pauli_one<true>(k, beta, s.lr[4 * c + 1], s.li[4 * c + 1], lr.y,
                            li.y);
      regs::pauli_one<true>(k, beta, s.lr[4 * c + 2], s.li[4 * c + 2], lr.z,
                            li.z);
      regs::pauli_one<true>(k, beta, s.lr[4 * c + 3], s.li[4 * c + 3], lr.w,
                            li.w);
    }
  }
  cluster_sync();                         // ... and this one's
}

// Pauli k on physical bit pos: a register, lane or warp bit (regs::pauli:
// through `region` on a warp bit), or a cluster bit.
template <bool kCl, bool kAdj>
__device__ __forceinline__ void wide_pauli(regs::Amps<kWideRB>& s, int k,
                                           int pos, const WideRow& w) {
  if (kCl && pos >= kClusterBit) {
    cluster_pauli<kAdj>(s, k, pos - kClusterBit, w);
    return;
  }
  regs::pauli<kWideRB, kAdj>(s, k, pos, w.region, kCtaAmps, kFull);
}

// A woven gate's errors: forward, on the target then the control (a gate
// without one: qubit 0, lane bit 0); the adjoint undoes them in reverse.
template <bool kCl, bool kAdj>
__device__ __forceinline__ void wide_errors(regs::Amps<kWideRB>& s,
                                            const int4& op,
                                            const WideRow& w) {
  const int et = w.errk[2 * op.w], ec = w.errk[2 * op.w + 1];
  const int p = op_p(op.x), q = op_q(op.x), pc = q >= 0 ? q : kWideRB;
  if (!kAdj && et) wide_pauli<kCl, false>(s, et, p, w);
  if (ec) wide_pauli<kCl, kAdj>(s, ec, pc, w);
  if (kAdj && et) wide_pauli<kCl, true>(s, et, p, w);
}

// Whether this CTA runs gate op o: a 1-qubit gate's control on a cluster
// bit is CTA-uniform, so the CTA whose rank bit is set runs it
// uncontrolled (its case less 5) and the other skips it.
template <bool kCl>
__device__ __forceinline__ bool wide_gate_runs(int4& o, int rank) {
  if (!kCl) return true;
  const int q = op_q(o.x);
  if (q < kClusterBit || op_kind(o.x) >= kRXX) return true;
  o.y -= 5;
  return (rank >> (q - kClusterBit)) & 1;
}

// psi <- tape psi along the schedule (kAdj false), or the adjoint sweep
// backwards (kAdj), where lane 0 of each warp writes the warp's part of a
// gradient gate g's row to gpart[g * warps + warp].  The next op and its
// entries are read before the current one runs.
template <bool kCl, bool kAdj>
__device__ __forceinline__ void wide_sweep(regs::Amps<kWideRB>& s,
                                           const WideRow& w, bool woven) {
  constexpr int RB = kWideRB;
  const int nops = w.nops;
  if (nops == 0) return;
  const int prank = w.rank << kClusterBit;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int parity = 0, cparity = 0;
  const int first = kAdj ? nops - 1 : 0, step = kAdj ? -1 : 1;
  int4 next = w.ops[first];
  Coef next_u = load_coef(w.coef, next.w);
  for (int n = 0, i = first; n < nops; ++n, i += step) {
    const int4 op = next;
    const Coef u = next_u;
    if (n + 1 < nops) {
      next = w.ops[i + step];
      next_u = load_coef(w.coef, next.w);
    }
    if (op_kind(op.x) == kSwapOp) {
      wide_swap<kCl, kAdj>(s, op.x, w, parity, cparity);
      continue;
    }
    if (kAdj && woven) wide_errors<kCl, true>(s, op, w);
    int4 o = op;
    float gp = 0.f;
    if (wide_gate_runs<kCl>(o, w.rank))
      gp = apply_op<RB, kAdj>(s, u, o, kFull, prank);
    if (!kAdj && woven) wide_errors<kCl, false>(s, op, w);
    if (kAdj && (op.x & kGradBit)) {      // block-uniform branch
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gp += __shfl_xor_sync(kFull, gp, off);
      if (lane == 0) w.gpart[op.w * kWideWarps + warp] = gp;
    }
  }
}

// The row's angle gradients into dang: each angle's gates, last first,
// each summed over the row's warps in order; in a cluster every CTA's
// sums go to rank 0's cdx and rank 0 adds them in rank order.
template <bool kCl>
__device__ __forceinline__ void wide_grad_sums(const WideRow& w, float* dang,
                                               int R, int n) {
  const int wpr = w.T >> 5, w0 = w.rs * wpr;
  const int t0 = kCl ? (int)threadIdx.x : w.t;
  const int step = kCl ? kWideThreads : w.T;
#pragma unroll 1
  for (int r = t0; r < R; r += step) {
    float dx = 0.f;
    for (int g = w.sfirst[r]; g >= 0; g = w.gnext[g]) {
      float acc = 0.f;
      for (int k = 0; k < wpr; ++k) acc += w.gpart[g * kWideWarps + w0 + k];
      dx += acc;
    }
    if (kCl)
      at_rank(w.cdx, 0)[w.rank * R + r] = dx;
    else if (w.live)
      dang[w.row * R + r] = dx;
  }
  if constexpr (kCl) {
    cluster_sync();
    if (w.rank == 0) {
      const int C = wide_ctas(n);
#pragma unroll 1
      for (int r = threadIdx.x; r < R; r += kWideThreads) {
        float dx = 0.f;
        for (int c = 0; c < C; ++c) dx += w.cdx[c * R + r];
        dang[w.row * R + r] = dx;
      }
    }
  }
}

// 10 <= n <= 16: register rows (kCl false: 2^(12 - n) rows a CTA up to 12
// qubits) or a cluster of 2^(n - 12) CTAs a row (kCl).  Both ask for one
// CTA an SM, so that ptxas may take up to 255 registers a thread.
template <bool kCl>
__global__ void __launch_bounds__(kWideThreads, 1)
apply_tape_fwd_wide_kernel(Tape tape, const int* __restrict__ sched, int es,
                           int weave, const float* __restrict__ angles,
                           const float* __restrict__ re,
                           const float* __restrict__ im,
                           float* __restrict__ ore, float* __restrict__ oim,
                           int S, int G, int R, int n) {
  DYNAMIC_SHARED(smem_fwd_wide);
  WideRow w;
  wide_setup<kCl, false>(w, smem_fwd_wide, tape, sched, es, weave, angles,
                         S, G, R, n);
  const size_t off = w.row << n;
  regs::Amps<kWideRB> s;
  {
    int idx[1 << kWideRB];
    wide_indices(w.map0, n, w.t, idx);
    wide_load<false>(s.pr, re + off, idx, w.live);
    wide_load<false>(s.pi, im + off, idx, w.live);
  }
  wide_sweep<kCl, false>(s, w, weave == 3);
  int idx[1 << kWideRB];
  wide_indices(w.map1, n, w.t, idx);
  wide_store<false>(s.pr, ore + off, idx, w.live);
  wide_store<false>(s.pi, oim + off, idx, w.live);
}

template <bool kCl>
__global__ void __launch_bounds__(kWideThreads, 1)
apply_tape_bwd_wide_kernel(Tape tape, const int* __restrict__ sched, int es,
                           int weave, const float* __restrict__ angles,
                           const float* __restrict__ ore,
                           const float* __restrict__ oim,
                           const float* __restrict__ gre,
                           const float* __restrict__ gim,
                           float* __restrict__ dre, float* __restrict__ dim,
                           float* __restrict__ dang, int S, int G, int R,
                           int n) {
  DYNAMIC_SHARED(smem_bwd_wide);
  WideRow w;
  wide_setup<kCl, true>(w, smem_bwd_wide, tape, sched, es, weave, angles, S,
                        G, R, n);
  const size_t off = w.row << n;
  regs::Amps<kWideRB> s;
  {
    int idx[1 << kWideRB];
    wide_indices(w.map1, n, w.t, idx);
    wide_load<false>(s.pr, ore + off, idx, w.live);
    wide_load<false>(s.pi, oim + off, idx, w.live);
    wide_load<false>(s.lr, gre + off, idx, w.live);
    wide_load<true>(s.li, gim + off, idx, w.live);
  }
  wide_sweep<kCl, true>(s, w, weave == 3);
  if (dre != nullptr) {
    int idx[1 << kWideRB];
    wide_indices(w.map0, n, w.t, idx);
    wide_store<false>(s.lr, dre + off, idx, w.live);
    wide_store<true>(s.li, dim + off, idx, w.live);
  }
  __syncthreads();                        // every warp's gradient parts
  wide_grad_sums<kCl>(w, dang, R, n);
}

// ---- launch ---------------------------------------------------------------

bool wide_kernel(int n) { return n >= kWideMinQubits; }

// n <= 9: a tape as given (errors as gates), no schedule; n >= 10: a
// schedule of es rows (E a multiple) and weave 1 or 3.
bool bad_shape(int E, int S, int G, int R, int n, const int* sched, int es,
               int weave) {
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < 1 || n > kWideMaxQubits)
    return true;
  if (!wide_kernel(n)) return sched != nullptr || weave != 1;
  return sched == nullptr || es < 1 || E % es != 0 ||
         (weave != 1 && weave != 3);
}

size_t smem_bytes(int S, int G, int R, int n, int weave, bool adjoint) {
  if (!wide_kernel(n))
    return make_layout(make_dims(n, S), G, R, adjoint).total;
  return wide_layout(n, G, R, adjoint, weave == 3).total;
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The launch configuration of `clusters` clusters of C CTAs (as
// fused_adam_v2.cu's).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void cluster_config(ClusterLaunch& l, int clusters, int C, size_t bytes,
                    cudaStream_t stream) {
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(clusters * C, 1, 1);
  l.cfg.blockDim = dim3(kWideThreads, 1, 1);
  l.cfg.dynamicSmemBytes = bytes;
  l.cfg.stream = stream;
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = C;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 1;
}

// `bytes` of dynamic shared memory a CTA, clusters of C CTAs (more than 8
// is a non-portable size).
template <class K>
cudaError_t cluster_attributes(K kernel, int C, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess || C <= 8) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A wide kernel's launch: register rows in CTAs of kWideThreads up to 12
// qubits (E x ceil(S / rows) CTAs), a cluster a row above.
template <class K, class... A>
int launch_wide(K row_kernel, K cluster_kernel, int E, int S, int n,
                size_t bytes, cudaStream_t st, A... args) {
  if (n <= kClusterBit) {
    const int err = set_smem((const void*)row_kernel, bytes);
    if (err != 0) return err;
    const int rows = wide_rows(n), blocks = (S + rows - 1) / rows;
    KERNEL_LAUNCH(row_kernel, E * blocks, kWideThreads, bytes, st, args...);
    return (int)cudaGetLastError();
  }
  const int C = wide_ctas(n);
  cudaError_t err = cluster_attributes(cluster_kernel, C, bytes);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l;
  cluster_config(l, E * S, C, bytes, st);
  err = cudaLaunchKernelEx(&l.cfg, cluster_kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs at these shapes (G: the tape's gates,
// woven or not below 10 qubits; the schedule's from 10, with `weave` 1 or
// 3); the wrapper checks them against the card's per-block limit.
size_t apply_tape_fwd_smem_bytes(int S, int G, int R, int n, int weave) {
  return smem_bytes(S, G, R, n, weave, false);
}

size_t apply_tape_bwd_smem_bytes(int S, int G, int R, int n, int weave) {
  return smem_bytes(S, G, R, n, weave, true);
}

// Words of one env's schedule row for G gates and R angles.
int apply_tape_schedule_words(int G, int R) { return sched_words(G, R); }

const char* apply_tape_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The wide kernels' schedule of (E, G) tapes with R angles at 10 <= n <=
// 16 qubits into out (E x apply_tape_schedule_words(G, R) int32).
int apply_tape_schedule_launch(const int* kind, const int* tq, const int* cq,
                               const int* slot, int* out, int E, int G, int R,
                               int n, void* stream) {
  if (E < 1 || G < 1 || R < 1 || n < kWideMinQubits || n > kWideMaxQubits ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sched_smem_bytes(G, R);
  const int err = set_smem((const void*)apply_tape_schedule_kernel, bytes);
  if (err != 0) return err;
  const Tape tape = {kind, tq, cq, slot};
  KERNEL_LAUNCH(apply_tape_schedule_kernel, E, 32, bytes,
                static_cast<cudaStream_t>(stream), tape, G, R, n, out);
  return (int)cudaGetLastError();
}

// Forward: re / im / ore / oim (E, S, D) f32, tapes (E, weave x G) int32,
// angles (E, S, R) f32; from 10 qubits `sched` (es rows of the schedule of
// the tapes' gates, apply_tape_schedule_launch; env e reads row e % es)
// and `weave` (3: every gate followed by its error Paulis, as
// extend_tape_arrays weaves them), else null and 1.  Returns
// cudaGetLastError() after the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int apply_tape_fwd_launch(const int* kind, const int* tq, const int* cq,
                          const int* slot, const float* angles,
                          const float* re, const float* im, float* ore,
                          float* oim, const int* sched, int es, int weave,
                          int E, int S, int G, int R, int n, void* stream) {
  if (bad_shape(E, S, G, R, n, sched, es, weave))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(S, G, R, n, weave, false);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tape tape = {kind, tq, cq, slot};
  if (wide_kernel(n))
    return launch_wide(apply_tape_fwd_wide_kernel<false>,
                       apply_tape_fwd_wide_kernel<true>, E, S, n, bytes, st,
                       tape, sched, es, weave, angles, re, im, ore, oim, S, G,
                       R, n);
  const Dims d = make_dims(n, S);
  auto kernel = d.rb == 3 ? apply_tape_fwd_reg_kernel<3>
                          : apply_tape_fwd_reg_kernel<4>;
  const int err = set_smem((const void*)kernel, bytes);
  if (err != 0) return err;
  KERNEL_LAUNCH(kernel, E, d.groups * d.T, bytes, st, tape, angles, re, im,
                ore, oim, S, G, R, n);
  return (int)cudaGetLastError();
}

// Adjoint: from the forward output (ore, oim) and the cotangents (gre,
// gim), all (E, S, D) f32, into dre / dim (E, S, D) and dang (E, S, R);
// the tapes, sched, es and weave as the forward's.  dre and dim may both be
// null (the psi0 cotangents are then not written).
int apply_tape_bwd_launch(const int* kind, const int* tq, const int* cq,
                          const int* slot, const float* angles,
                          const float* ore, const float* oim,
                          const float* gre, const float* gim, float* dre,
                          float* dim, float* dang, const int* sched, int es,
                          int weave, int E, int S, int G, int R, int n,
                          void* stream) {
  if (bad_shape(E, S, G, R, n, sched, es, weave) ||
      (dre == nullptr) != (dim == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(S, G, R, n, weave, true);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tape tape = {kind, tq, cq, slot};
  if (wide_kernel(n))
    return launch_wide(apply_tape_bwd_wide_kernel<false>,
                       apply_tape_bwd_wide_kernel<true>, E, S, n, bytes, st,
                       tape, sched, es, weave, angles, ore, oim, gre, gim,
                       dre, dim, dang, S, G, R, n);
  const Dims d = make_dims(n, S);
  auto kernel = d.rb == 3 ? apply_tape_bwd_reg_kernel<3>
                          : apply_tape_bwd_reg_kernel<4>;
  const int err = set_smem((const void*)kernel, bytes);
  if (err != 0) return err;
  KERNEL_LAUNCH(kernel, E, d.groups * d.T, bytes, st, tape, angles, ore, oim,
                gre, gim, dre, dim, dang, S, G, R, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
