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
// X / Y / Z, slot -1) are plain 1-qubit gates here.
//
// Bound.  The planes are read and written once per launch: at the su4
// 8-qubit shapes (E = 128, S = 8, G = R = 30, D = 256) about 4.4 MB and 25
// MFLOP forward, 6.6 MB and 66 MFLOP adjoint, 1.3 and 2.0 us at the card's
// memory rate: a launch is bound by the latency of its gate chain (30
// dependent gates) and by its launch.
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
// The first design (10 <= n <= 16; apply_tape_*_kernel), kept as it was
// first written.  Each row gets a CTA.  Its state lives in shared memory up
// to 13 qubits (psi: 8 D bytes forward; psi and lambda: 16 D bytes, 128 KB
// at 13 qubits, adjoint); above that psi and lambda live in global memory
// (the output planes and a workspace the wrapper allocates), reached
// through L2, one code path over a pointer.  The tape rows and the row's
// cos / sin table are read into shared memory once.  A 1-qubit gate pairs
// amplitude i0 (target bit 0) with i1 = i0 | 2^t; a two-qubit rotation
// pairs i0 with i0 ^ 2^t ^ 2^c (the matching XX and YY exchange; RZZ is
// diagonal and takes the same pairs), where both carry the same ZZ
// eigenvalue z.  Each thread owns whole pairs, so a gate updates in place
// and needs one CTA barrier.  A gradient row is summed in a fixed order
// (warp shuffles, then thread 0 over the warps).  The launch functions
// route by n; `design` = 1 forces the first design at any n (for timing).

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "regs.cuh"

// The launches and the dynamic shared memory go through these two macros,
// so that tests/cuda_emu/cuda_runtime.h, which defines both, can run this
// source on the host.
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
// the gradient bit).
template <int RB, bool kAdj>
__device__ __forceinline__ float apply_op(regs::Amps<RB>& s, const Coef& u,
                                          int4 op, unsigned mask) {
  const int c = op.y, p = op_p(op.x), q = op_q(op.x);
  if (c < kCaseRZZ) {
    if (kAdj) return regs::gate_adj<RB>(s, u, c, p, q, mask);
    regs::gate_fwd<RB>(s, u, c, p, q, mask);
    return 0.f;
  }
  const int pbase = threadIdx.x << RB;
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

// ---- the first design (10 <= n <= 16, or `design` = 1) ---------------------

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// Largest qubit count whose state stays in shared memory.
constexpr int kSmemStateMaxQubits = 13;

// Threads of a CTA: one per amplitude pair, within [32, kMaxThreads].
int threads_for(int n) {
  const int half = 1 << (n - 1);
  return half < 32 ? 32 : (half > kMaxThreads ? kMaxThreads : half);
}

// The generator of a two-qubit rotation on the pair (i0, i1 = partner):
// (P psi)[i] = gd psi[i] + gf psi[partner(i)], the same (gd, gf) at both
// ends of the pair (they share the ZZ eigenvalue z).
__device__ __forceinline__ void rot2q_generator(int k, int i0, int t, int c,
                                                float& gd, float& gf) {
  const float z = (((i0 >> t) ^ (i0 >> c)) & 1) ? -1.f : 1.f;
  gd = k == kRZZ ? z : 0.f;
  gf = k == kRXX ? 1.f : (k == kRYY ? -z : 0.f);
}

// Partner of pair member i0 under gate (k, t, c).
__device__ __forceinline__ int partner(int k, int i0, int t, int c) {
  return k >= kRXX ? i0 ^ (1 << t) ^ (1 << c) : i0 | (1 << t);
}

// Shared-memory carve-up common to both kernels: tape rows (4 G ints), the
// cos / sin tables (R floats each), then the kernel's own arrays.
struct Rows {
  int* kind;
  int* tq;
  int* cq;
  int* slot;
  float* ct;
  float* st;
};

__device__ float* load_rows(Rows& rw, float* f, const int* __restrict__ kind,
                            const int* __restrict__ tq,
                            const int* __restrict__ cq,
                            const int* __restrict__ slot,
                            const float* __restrict__ angles, int e,
                            size_t row, int G, int R) {
  rw.ct = f; f += R;
  rw.st = f; f += R;
  int* ip = reinterpret_cast<int*>(f);
  rw.kind = ip; ip += G;
  rw.tq = ip; ip += G;
  rw.cq = ip; ip += G;
  rw.slot = ip; ip += G;
  const int* src[4] = {kind, tq, cq, slot};
  int* dst[4] = {rw.kind, rw.tq, rw.cq, rw.slot};
  for (int idx = threadIdx.x; idx < 4 * G; idx += blockDim.x)
    dst[idx / G][idx % G] = src[idx / G][(size_t)e * G + idx % G];
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float s, c;
    sincosf(0.5f * angles[row * R + r], &s, &c);
    rw.st[r] = s;
    rw.ct[r] = c;
  }
  return reinterpret_cast<float*>(ip);
}

__global__ void __launch_bounds__(kMaxThreads)
apply_tape_fwd_kernel(const int* __restrict__ kind, const int* __restrict__ tq,
                      const int* __restrict__ cq, const int* __restrict__ slot,
                      const float* __restrict__ angles,
                      const float* __restrict__ re,
                      const float* __restrict__ im, float* ore, float* oim,
                      int S, int G, int R, int n) {
  DYNAMIC_SHARED(smem_fwd);
  float* smem = reinterpret_cast<float*>(smem_fwd);
  const int D = 1 << n, half = D >> 1;
  const size_t row = blockIdx.x;          // e * S + s
  const int e = blockIdx.x / S;
  Rows rw;
  float* f = load_rows(rw, smem, kind, tq, cq, slot, angles, e, row, G, R);
  const bool in_smem = n <= kSmemStateMaxQubits;
  float* pr = in_smem ? f : ore + row * D;
  float* pi = in_smem ? f + D : oim + row * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    pr[i] = re[row * D + i];
    pi[i] = im[row * D + i];
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const int k = rw.kind[g];
    if (k == kNone) continue;             // block-uniform
    const int t = rw.tq[g], c = rw.cq[g], sl = rw.slot[g];
    const float cs = sl >= 0 ? rw.ct[sl] : 1.f;
    const float sn = sl >= 0 ? rw.st[sl] : 0.f;
    if (k >= kRXX) {                      // exp(-i theta/2 P), P = XX/YY/ZZ
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i0 = pair_low(p, t);
        const int i1 = partner(k, i0, t, c);
        float gd, gf;
        rot2q_generator(k, i0, t, c, gd, gf);
        const float a0r = pr[i0], a0i = pi[i0];
        const float a1r = pr[i1], a1i = pi[i1];
        const float q0r = gd * a0r + gf * a1r, q0i = gd * a0i + gf * a1i;
        const float q1r = gd * a1r + gf * a0r, q1i = gd * a1i + gf * a0i;
        pr[i0] = cs * a0r + sn * q0i;
        pi[i0] = cs * a0i - sn * q0r;
        pr[i1] = cs * a1r + sn * q1i;
        pi[i1] = cs * a1i - sn * q1r;
      }
    } else {
      const Coef u = gate_coef(k, cs, sn);
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i0 = pair_low(p, t);
        if (c >= 0 && !((i0 >> c) & 1)) continue;
        const int i1 = i0 | (1 << t);
        const float a0r = pr[i0], a0i = pi[i0];
        const float a1r = pr[i1], a1i = pi[i1];
        float b0r, b0i, b1r, b1i;
        cmul2(u.u00r, u.u00i, a0r, a0i, u.u01r, u.u01i, a1r, a1i, b0r, b0i);
        cmul2(u.u10r, u.u10i, a0r, a0i, u.u11r, u.u11i, a1r, a1i, b1r, b1i);
        pr[i0] = b0r;
        pi[i0] = b0i;
        pr[i1] = b1r;
        pi[i1] = b1i;
      }
    }
    __syncthreads();
  }

  if (in_smem)
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      ore[row * D + i] = pr[i];
      oim[row * D + i] = pi[i];
    }
}

__global__ void __launch_bounds__(kMaxThreads)
apply_tape_bwd_kernel(const int* __restrict__ kind, const int* __restrict__ tq,
                      const int* __restrict__ cq, const int* __restrict__ slot,
                      const float* __restrict__ angles,
                      const float* __restrict__ ore,
                      const float* __restrict__ oim,
                      const float* __restrict__ gre,
                      const float* __restrict__ gim, float* dre, float* dim,
                      float* __restrict__ dang, float* work, int S, int G,
                      int R, int n) {
  DYNAMIC_SHARED(smem_bwd);
  float* smem = reinterpret_cast<float*>(smem_bwd);
  const int D = 1 << n, half = D >> 1;
  const size_t row = blockIdx.x;          // e * S + s
  const int e = blockIdx.x / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  Rows rw;
  float* f = load_rows(rw, smem, kind, tq, cq, slot, angles, e, row, G, R);
  float* grad = f; f += R;                // dang row
  float* gpart = f; f += 2 * kMaxWarps;   // warp partials, double-buffered
  const bool in_smem = n <= kSmemStateMaxQubits;
  // psi in shared memory or the workspace, lambda in shared memory or in
  // the output planes
  float* pr = in_smem ? f : work + row * 2 * D;
  float* pi = pr + D;
  float* lr = in_smem ? f + 2 * D : dre + row * D;
  float* li = in_smem ? f + 3 * D : dim + row * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    pr[i] = ore[row * D + i];
    pi[i] = oim[row * D + i];
    lr[i] = gre[row * D + i];
    li[i] = -gim[row * D + i];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) grad[r] = 0.f;
  __syncthreads();

  int parity = 0;
  for (int g = G - 1; g >= 0; --g) {
    const int k = rw.kind[g];
    if (k == kNone) continue;             // block-uniform
    const int t = rw.tq[g], c = rw.cq[g], sl = rw.slot[g];
    const float cs = sl >= 0 ? rw.ct[sl] : 1.f;
    const float sn = sl >= 0 ? rw.st[sl] : 0.f;
    const bool two_q = k >= kRXX;
    const bool has_grad = sl >= 0 && (two_q || k == kRX || k == kRY ||
                                      k == kRZ);
    float* gbuf = gpart + parity * kMaxWarps;
    parity ^= 1;
    float gp = 0.f;
    if (two_q) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i0 = pair_low(p, t);
        const int i1 = partner(k, i0, t, c);
        float gd, gf;
        rot2q_generator(k, i0, t, c, gd, gf);
        const float a0r = pr[i0], a0i = pi[i0];
        const float a1r = pr[i1], a1i = pi[i1];
        const float l0r = lr[i0], l0i = li[i0];
        const float l1r = lr[i1], l1i = li[i1];
        // P psi, P lambda (P real symmetric: U^T = U, U^H = U(-theta))
        const float q0r = gd * a0r + gf * a1r, q0i = gd * a0i + gf * a1i;
        const float q1r = gd * a1r + gf * a0r, q1i = gd * a1i + gf * a0i;
        const float h0r = gd * l0r + gf * l1r, h0i = gd * l0i + gf * l1i;
        const float h1r = gd * l1r + gf * l0r, h1i = gd * l1i + gf * l0i;
        if (has_grad)
          gp += 0.5f * (q0r * l0i + q0i * l0r + q1r * l1i + q1i * l1r);
        pr[i0] = cs * a0r - sn * q0i;     // (cos + i sin P) psi
        pi[i0] = cs * a0i + sn * q0r;
        pr[i1] = cs * a1r - sn * q1i;
        pi[i1] = cs * a1i + sn * q1r;
        lr[i0] = cs * l0r + sn * h0i;     // (cos - i sin P) lambda
        li[i0] = cs * l0i - sn * h0r;
        lr[i1] = cs * l1r + sn * h1i;
        li[i1] = cs * l1i - sn * h1r;
      }
    } else {
      const Coef u = gate_coef(k, cs, sn);
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i0 = pair_low(p, t);
        if (c >= 0 && !((i0 >> c) & 1)) continue;
        const int i1 = i0 | (1 << t);
        const float a0r = pr[i0], a0i = pi[i0];
        const float a1r = pr[i1], a1i = pi[i1];
        const float l0r = lr[i0], l0i = li[i0];
        const float l1r = lr[i1], l1i = li[i1];
        if (has_grad) {
          float q0r, q0i, q1r, q1i;
          generator(k, a0r, a0i, a1r, a1i, q0r, q0i, q1r, q1i);
          gp += 0.5f * (q0r * l0i + q0i * l0r + q1r * l1i + q1i * l1r);
        }
        float b0r, b0i, b1r, b1i;         // U^H (a0, a1)
        cmul2(u.u00r, -u.u00i, a0r, a0i, u.u10r, -u.u10i, a1r, a1i, b0r,
              b0i);
        cmul2(u.u01r, -u.u01i, a0r, a0i, u.u11r, -u.u11i, a1r, a1i, b1r,
              b1i);
        float m0r, m0i, m1r, m1i;         // U^T (l0, l1)
        cmul2(u.u00r, u.u00i, l0r, l0i, u.u10r, u.u10i, l1r, l1i, m0r, m0i);
        cmul2(u.u01r, u.u01i, l0r, l0i, u.u11r, u.u11i, l1r, l1i, m1r, m1i);
        pr[i0] = b0r;
        pi[i0] = b0i;
        pr[i1] = b1r;
        pi[i1] = b1i;
        lr[i0] = m0r;
        li[i0] = m0i;
        lr[i1] = m1r;
        li[i1] = m1i;
      }
    }
    if (has_grad) {                       // block-uniform branch
      for (int off = 16; off > 0; off >>= 1)
        gp += __shfl_xor_sync(0xffffffffu, gp, off);
      if (lane == 0) gbuf[warp] = gp;
    }
    __syncthreads();
    if (has_grad && threadIdx.x == 0) {
      float acc = 0.f;
      for (int w = 0; w < n_warps; ++w) acc += gbuf[w];
      grad[sl] += acc;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    if (in_smem) dre[row * D + i] = lr[i];
    dim[row * D + i] = -li[i];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    dang[row * R + r] = grad[r];
}

bool state_in_smem(int n) { return n <= kSmemStateMaxQubits; }

size_t fwd_smem_bytes(int G, int R, int n) {
  const size_t state = state_in_smem(n) ? (size_t)2 << n : 0;
  return sizeof(float) * (state + 2 * (size_t)R) + sizeof(int) * 4 * (size_t)G;
}

size_t bwd_smem_bytes(int G, int R, int n) {
  const size_t state = state_in_smem(n) ? (size_t)4 << n : 0;
  return sizeof(float) * (state + 3 * (size_t)R + 2 * kMaxWarps) +
         sizeof(int) * 4 * (size_t)G;
}

// ---- launch ---------------------------------------------------------------

// `design`: 0 the register kernels up to 9 qubits and the first design
// above, 1 the first design at any qubit count.
bool register_kernel(int n, int design) {
  return design == 0 && n <= kRegMaxQubits;
}

bool bad_shape(int E, int S, int G, int R, int n, int design) {
  return E < 1 || S < 1 || G < 1 || R < 1 || n < 1 || n > 16 ||
         design < 0 || design > 1;
}

size_t smem_bytes(int S, int G, int R, int n, int design, bool adjoint) {
  if (register_kernel(n, design))
    return make_layout(make_dims(n, S), G, R, adjoint).total;
  return adjoint ? bwd_smem_bytes(G, R, n) : fwd_smem_bytes(G, R, n);
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs at these shapes and `design` (the
// wrapper checks them against the card's per-block limit before launching).
size_t apply_tape_fwd_smem_bytes(int S, int G, int R, int n, int design) {
  return smem_bytes(S, G, R, n, design, false);
}

size_t apply_tape_bwd_smem_bytes(int S, int G, int R, int n, int design) {
  return smem_bytes(S, G, R, n, design, true);
}

// Above this qubit count the first design's adjoint needs a workspace of
// E x S x 2 x D floats for psi.
int apply_tape_smem_state_max_qubits() { return kSmemStateMaxQubits; }

// The register kernels' largest qubit count.
int apply_tape_reg_max_qubits() { return kRegMaxQubits; }

const char* apply_tape_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Forward: re / im / ore / oim (E, S, D) f32, tapes (E, G) int32, angles
// (E, S, R) f32.  Returns cudaGetLastError() after the launch (0 on
// success); the kernel runs asynchronously on `stream`.
int apply_tape_fwd_launch(const int* kind, const int* tq, const int* cq,
                          const int* slot, const float* angles,
                          const float* re, const float* im, float* ore,
                          float* oim, int E, int S, int G, int R, int n,
                          int design, void* stream) {
  if (bad_shape(E, S, G, R, n, design)) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(S, G, R, n, design, false);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (register_kernel(n, design)) {
    const Dims d = make_dims(n, S);
    const Tape tape = {kind, tq, cq, slot};
    auto kernel = d.rb == 3 ? apply_tape_fwd_reg_kernel<3>
                            : apply_tape_fwd_reg_kernel<4>;
    const int err = set_smem((const void*)kernel, bytes);
    if (err != 0) return err;
    KERNEL_LAUNCH(kernel, E, d.groups * d.T, bytes, st, tape, angles, re,
                  im, ore, oim, S, G, R, n);
    return (int)cudaGetLastError();
  }
  const int err = set_smem((const void*)apply_tape_fwd_kernel, bytes);
  if (err != 0) return err;
  KERNEL_LAUNCH(apply_tape_fwd_kernel, E * S, threads_for(n), bytes, st,
                kind, tq, cq, slot, angles, re, im, ore, oim, S, G, R, n);
  return (int)cudaGetLastError();
}

// Adjoint: from the forward output (ore, oim) and the cotangents (gre,
// gim), all (E, S, D) f32, into dre / dim (E, S, D) and dang (E, S, R).
// dre and dim may both be null with the register kernels (the psi0
// cotangents are then not written).  The first design's work is null up
// to apply_tape_smem_state_max_qubits() qubits, else E x S x 2 x D floats.
int apply_tape_bwd_launch(const int* kind, const int* tq, const int* cq,
                          const int* slot, const float* angles,
                          const float* ore, const float* oim,
                          const float* gre, const float* gim, float* dre,
                          float* dim, float* dang, float* work, int E, int S,
                          int G, int R, int n, int design, void* stream) {
  if (bad_shape(E, S, G, R, n, design) || (dre == nullptr) != (dim == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(S, G, R, n, design, true);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (register_kernel(n, design)) {
    if (work != nullptr) return (int)cudaErrorInvalidValue;
    const Dims d = make_dims(n, S);
    const Tape tape = {kind, tq, cq, slot};
    auto kernel = d.rb == 3 ? apply_tape_bwd_reg_kernel<3>
                            : apply_tape_bwd_reg_kernel<4>;
    const int err = set_smem((const void*)kernel, bytes);
    if (err != 0) return err;
    KERNEL_LAUNCH(kernel, E, d.groups * d.T, bytes, st, tape, angles, ore,
                  oim, gre, gim, dre, dim, dang, S, G, R, n);
    return (int)cudaGetLastError();
  }
  if (dre == nullptr || (work == nullptr) != state_in_smem(n))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem((const void*)apply_tape_bwd_kernel, bytes);
  if (err != 0) return err;
  KERNEL_LAUNCH(apply_tape_bwd_kernel, E * S, threads_for(n), bytes, st,
                kind, tq, cq, slot, angles, ore, oim, gre, gim, dre, dim,
                dang, work, S, G, R, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
