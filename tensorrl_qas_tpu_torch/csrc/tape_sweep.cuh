// The body of the composed engine's sweep tape kernels, forward (B3f) and
// adjoint (B3b), templated on the real type of the planes: apply_tape_
// sweep.cu instantiates it in float for 17-20 qubits, apply_tape_f64.cu in
// double for 1-20 (Cfg below).  What the kernels compute is in those
// sources' headers; this is how.
//
// Every row stays in device memory as re / im planes and the card sweeps
// it segment by segment:
//   - A CTA takes one chunk of 2^cb amplitudes of one row, cb =
//     chunk_bits(n) (kChunkBits, or n where the instance takes whole rows
//     of at most kChunkBits qubits), into shared memory, applies a
//     segment's gates there (and their woven errors), one CTA barrier a
//     gate, and writes the chunk back.
//   - Above kChunkBits qubits the tape is cut into segments (segments.cuh,
//     the rule fused_adam_v2_sweep.cu follows too; its twin ops/
//     fused_adam2d.py:sweep_segments, word for word): runs of consecutive
//     live gates whose qubits above qubit 4, a control or a two-qubit
//     rotation's second qubit included, number at most kChunkBits - 5.  A
//     segment's local qubits are qubits 0..4, its gates' and the lowest
//     others up to kChunkBits; the chunk's index gives the others.  A
//     woven error Pauli sits on its gate's own target or control, so it is
//     local in its gate's segment (asserted: a trap otherwise).  Qubits
//     0..4 are local in every segment, so a warp reads 32 consecutive
//     values of a plane.  At most kChunkBits qubits the row is one chunk,
//     the tape one segment of all its gates, and no schedule is read.
//   - One launch per segment.  The launch boundary is the barrier between
//     segments, so no CTA waits on another and the grid (rows x chunks
//     CTAs) needs no residency; the host cannot know a tape's segment
//     count without reading the card, so a call makes max_segments(G, n)
//     launches, the most any tape of G gates can need, and a CTA whose row
//     has fewer returns at once.  A CUDA graph captures the launches as
//     they are.
//   - The forward runs the segments in order (the first reads psi0, the
//     others the output planes, in place).  The adjoint runs them in
//     reverse on psi (scratch planes; the first reads the forward's
//     output) and lambda (scratch; the first reads the cotangents); each
//     angle gate's row is summed over its chunk's pairs (a fixed-order
//     block reduction) into a per-chunk partial, and one last launch, a
//     CTA a row, sums each gate's partials over the chunks in order and
//     each angle's gates last first.  No atomics: a repeated call gives
//     the same bits.
//   - The schedule (3 G + 2 words an env) depends only on the noiseless
//     tape: the schedule kernel builds it, one thread an env, once per
//     composed step and tape; a woven tape's rows read the noiseless
//     tape's row e % es.
// A gate is one pair update: the pair (l0, l1 = l0 | 2^t, and for RXX /
// RYY also ^ 2^c) of every l0 whose target bit is 0, with a 2x2 matrix
// chosen by l0's bit c (a control: the identity, skipped, at 0; RYY and
// RZZ: the ZZ eigenvalue's sign; else the same matrix), the adjoint with
// its conjugate transpose on psi and its transpose on lambda.  All
// amplitude arithmetic is FMA in the instance's real type: no TF32.
//
// Each instance keeps the code it had as a source of its own: the float
// kernels' SASS is the same instruction for instruction (48 registers,
// 42,208 / 74,976 B of shared memory), the double ones' registers too
// (64 / 70): the whole-row branches fold away in float, the coefficients
// keep their float4 rows, and an entry keeps each type's field order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "segments.cuh"

// The launches and the dynamic shared memory go through these two macros,
// so that tests/cuda_emu/cuda_runtime.h, which defines both, can run the
// sources on the host.
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
#define DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

namespace tape_sweep {

using gates::cmul2;
using gates::gate_coef;
using gates::pair_low;
using gates::kNone;
using gates::kRX;
using gates::kRY;
using gates::kRZ;

enum : int { kRXX = 9, kRYY = 10, kRZZ = 11 };

constexpr int kLaneQubits = segments::kLaneQubits;
constexpr int kMaxQubits = 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Live gates whose entries sit in shared memory at once (a segment with
// more takes them in batches), each with up to 3 woven entries.
constexpr int kBatch = 32;
constexpr int kMaxWeave = 3;

// An entry's flags: a control (pairs whose control bit is 0 are skipped),
// RXX / RYY (the pair also flips the second qubit), and the generator's
// form for the gradient (X-like, Y-like, Z-like on the pair).
enum : int { kCtrl = 1, kFlip2 = 2, kGenShift = 2 };
enum : int { kGenNone = 0, kGenX = 1, kGenY = 2, kGenZ = 3 };

// -- the real type ----------------------------------------------------------

struct __align__(16) Double2 {
  double x, y;
};
struct __align__(16) Double4 {
  double x, y, z, w;
};
struct DCoef {
  double u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i;
};

// An amplitude (c2), a coefficient row (c4: two amplitudes) and a 2x2
// unitary (coef) in the real type.
template <class T>
struct Real;
template <>
struct Real<float> {
  using c2 = float2;
  using c4 = float4;
  using coef = gates::Coef;
};
template <>
struct Real<double> {
  using c2 = Double2;
  using c4 = Double4;
  using coef = DCoef;
};

// gates.cuh's gate table and product, in double.
__device__ __forceinline__ DCoef gate_coef(int k, double c, double s) {
  switch (k) {
    case gates::kRX: return {c, 0., 0., -s, 0., -s, c, 0.};
    case gates::kRY: return {c, 0., -s, 0., s, 0., c, 0.};
    case gates::kRZ: return {c, -s, 0., 0., 0., 0., c, s};
    case gates::kCX:
    case gates::kX: return {0., 0., 1., 0., 1., 0., 0., 0.};
    case gates::kY: return {0., 0., 0., -1., 0., 1., 0., 0.};
    case gates::kZ: return {1., 0., 0., 0., 0., 0., -1., 0.};
    case gates::kH: {
      const double r = 0.70710678118654752440;
      return {r, 0., r, 0., r, 0., -r, 0.};
    }
    default: return {1., 0., 0., 0., 0., 0., 1., 0.};
  }
}

__device__ __forceinline__ void cmul2(double ar, double ai, double br,
                                      double bi, double cr, double ci,
                                      double dr, double di, double& outr,
                                      double& outi) {
  outr = ar * br - ai * bi + cr * dr - ci * di;
  outi = ar * bi + ai * br + cr * di + ci * dr;
}

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// An instance: the real type, the chunk's qubits (the host tests compile
// the sources with smaller chunks, so that small states cross many
// segments) and the fewest qubits it takes.  Where that is at most the
// chunk's, rows of up to kChunkBits qubits are one chunk each.
template <class T_, int kChunkBits_, int kMinQubits_>
struct Cfg {
  using T = T_;
  static constexpr int kChunkBits = kChunkBits_;
  static constexpr int kMinQubits = kMinQubits_;
  static constexpr bool kWholeRows = kMinQubits_ <= kChunkBits_;
  static_assert(kChunkBits >= kLaneQubits + 2 && kChunkBits <= kMaxQubits,
                "a chunk holds qubits 0..4 and a gate's two qubits");

  // Whether a row of n qubits is one chunk, one segment, no schedule.
  __host__ __device__ static bool whole(int n) {
    return kWholeRows && n <= kChunkBits;
  }
  // The chunk's qubits at n.
  __host__ __device__ static int chunk_bits(int n) {
    return whole(n) ? n : kChunkBits;
  }
  // Threads of a CTA at n qubits: a thread a pair, from one warp to 256.
  __host__ __device__ static int threads(int n) {
    if (!whole(n)) return kThreads;
    const int pairs = 1 << (n - 1);
    return pairs < 32 ? 32 : pairs > kThreads ? kThreads : pairs;
  }
};

// One woven tape position of a segment as a pass applies it: kind (kNone:
// skipped), target and second / control qubit as local bits (-1: none),
// flags, the noiseless gate's index + 1 when it has an angle gradient (else
// 0), and the generator's sign for a pair whose l0 has bit c at 0 / 1 (32
// B in float, 40 in double).
template <class T>
struct Entry;
template <>
struct Entry<float> {
  int kind, tl, cl, flags, grad;
  float sg0, sg1;
  int pad;
};
template <>
struct Entry<double> {
  int kind, tl, cl, flags, grad, pad;
  double sg0, sg1;
};

// An entry of kind `kind` with no qubits, flags or gradient yet.
__device__ __forceinline__ Entry<float> blank_entry(int kind, float) {
  return {kind, 0, -1, 0, 0, 1.f, 1.f, 0};
}
__device__ __forceinline__ Entry<double> blank_entry(int kind, double) {
  return {kind, 0, -1, 0, 0, 0, 1., 1.};
}

template <class T>
struct Args {
  const int* kind;        // (E, weave G) woven tape, or (E, G)
  const int* tq;
  const int* cq;
  const int* slot;
  const T* angles;        // (E S, R)
  const T* in_re;         // forward: psi0; adjoint: the forward's output
  const T* in_im;
  T* out_re;              // forward: the output; adjoint: psi scratch
  T* out_im;
  const T* g_re;          // adjoint: the cotangents
  const T* g_im;
  T* l_re;                // adjoint: lambda scratch
  T* l_im;
  T* d_re;                // adjoint: the psi0 cotangents (or null)
  T* d_im;
  T* gpart;               // adjoint: (E S, G, chunks) gradient partials
  const int* sched;       // (es, 3 G + 2) segments; null for whole rows
  int es, weave, E, S, G, R, n;
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

template <class T>
struct Sh {
  typename Real<T>::c2* psi;  // 2^cb: the chunk of psi ...
  typename Real<T>::c2* lam;  // ... and of lambda (adjoint)
  Entry<T>* ent;              // kBatch kMaxWeave
  typename Real<T>::c4* coef; // 4 kBatch kMaxWeave: M0 rows 0, 1; M1 rows
  T* red;                     // 2 kWarps: gradient partials, double-buffered
  int* lq;                    // kMaxQubits: the qubit of each local bit
  int* nq;                    // kMaxQubits: the qubit of each chunk-index bit
};

template <class T>
__host__ __device__ __forceinline__ size_t smem_layout(bool adjoint, int cb,
                                                       size_t* off) {
  const size_t n_ent = (size_t)kBatch * kMaxWeave;
  const size_t chunk = sizeof(typename Real<T>::c2) << cb;
  const size_t sizes[7] = {
      chunk, adjoint ? chunk : 0, sizeof(Entry<T>) * n_ent,
      sizeof(typename Real<T>::c4) * 4 * n_ent, sizeof(T) * 2 * kWarps,
      sizeof(int) * kMaxQubits, sizeof(int) * kMaxQubits};
  size_t b = 0;
  for (int k = 0; k < 7; ++k) {
    if (off) off[k] = b;
    b += align16(sizes[k]);
  }
  return b;
}

template <class T>
__device__ __forceinline__ Sh<T> carve(unsigned char* base, bool adjoint,
                                       int cb) {
  using c2 = typename Real<T>::c2;
  size_t off[7];
  smem_layout<T>(adjoint, cb, off);
  Sh<T> sh;
  sh.psi = reinterpret_cast<c2*>(base + off[0]);
  sh.lam = reinterpret_cast<c2*>(base + off[1]);
  sh.ent = reinterpret_cast<Entry<T>*>(base + off[2]);
  sh.coef = reinterpret_cast<typename Real<T>::c4*>(base + off[3]);
  sh.red = reinterpret_cast<T*>(base + off[4]);
  sh.lq = reinterpret_cast<int*>(base + off[5]);
  sh.nq = reinterpret_cast<int*>(base + off[6]);
  return sh;
}

// The most segments a tape of G gates can have at n qubits: a segment
// closes only when its qubits above qubit 4 and the next gate's would
// exceed room = kChunkBits - 5, so it holds at least room - 1 of them, and
// a gate brings at most 2: every segment but the last has at least
// ceil((room - 1) / 2) live gates.  At most kChunkBits qubits never close
// one.
template <class C>
__host__ __device__ __forceinline__ int max_segments(int G, int n) {
  const int room = C::kChunkBits - kLaneQubits;
  if (n <= C::kChunkBits || G < 1) return 1;
  return (G - 1) / (room / 2) + 1;         // room / 2 = ceil((room - 1) / 2)
}

// -- the device bodies ------------------------------------------------------

// The segments of env e's (E, G) noiseless tape into out (segments::build),
// one thread an env.
template <class C>
__device__ __forceinline__ void schedule(const int* kind, const int* tq,
                                         const int* cq, int E, int G, int n,
                                         int* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < E)
    segments::build<C::kChunkBits>(kind, tq, cq, e, G, n,
                                   out + (size_t)e * segments::words(G));
}

// The local and chunk-index qubits of a segment's mask, by thread 0.
template <class T>
__device__ __forceinline__ void split_mask(const Sh<T>& sh, unsigned mask,
                                           int n) {
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int q = 0; q < n; ++q) {
      if ((mask >> q) & 1)
        sh.lq[a++] = q;
      else
        sh.nq[b++] = q;
    }
  }
}

// The entries of live gates live[lo .. lo + nb) (for a whole row, live is
// null and the gates are the tape's positions lo ..) of row `row` (env e)
// of a segment with local-qubit mask `mask`: thread j < nb writes the
// weave entries of live gate lo + j at j weave + v.  Ends on a CTA
// barrier.
template <class C>
__device__ void load_entries(const Sh<typename C::T>& sh,
                             const Args<typename C::T>& a, const int* live,
                             int lo, int nb, int row, int e, unsigned mask) {
  using T = typename C::T;
  using Coef = typename Real<T>::coef;
  using c4 = typename Real<T>::c4;
  const int tid = threadIdx.x, GW = a.weave * a.G;
  if (tid < nb) {
    const int g = C::kWholeRows && live == nullptr ? lo + tid
                                                   : __ldg(live + lo + tid);
    for (int v = 0; v < a.weave; ++v) {
      const int idx = tid * a.weave + v;
      const size_t at = (size_t)e * GW + (size_t)a.weave * g + v;
      const int kind = __ldg(a.kind + at);
      Entry<T> en = blank_entry(kind, T());
      if (kind != kNone) {
        const int t = __ldg(a.tq + at), c = __ldg(a.cq + at);
        const int sl = __ldg(a.slot + at);
        // every qubit of a segment's gate, its woven errors' included, is
        // local by the segment rule
        if (!((mask >> t) & 1) || (c >= 0 && !((mask >> c) & 1))) __trap();
        T s = T(0), co = T(1);
        if (sl >= 0)
          sin_cos(T(0.5) * __ldg(a.angles + (size_t)row * a.R + sl), &s, &co);
        en.tl = segments::local_bit(mask, t);
        en.cl = c >= 0 ? segments::local_bit(mask, c) : -1;
        Coef m0, m1;
        int gen = kGenNone;
        if (kind >= kRXX) {
          // exp(-i theta/2 P): RXX [[c, -is], [-is, c]] on (l0, l0 ^ t ^ c);
          // RYY [[c, is z], [is z, c]], z = (-1)^(bit c of l0); RZZ diag(c -
          // is z, c + is z) on (l0, l0 | t)
          if (kind == kRXX) {
            m0 = m1 = {co, T(0), T(0), -s, T(0), -s, co, T(0)};
            gen = kGenX;
          } else if (kind == kRYY) {
            m0 = {co, T(0), T(0), s, T(0), s, co, T(0)};
            m1 = {co, T(0), T(0), -s, T(0), -s, co, T(0)};
            gen = kGenX;
            en.sg0 = T(-1);
          } else {
            m0 = {co, -s, T(0), T(0), T(0), T(0), co, s};
            m1 = {co, s, T(0), T(0), T(0), T(0), co, -s};
            gen = kGenZ;
            en.sg1 = T(-1);
          }
          en.flags = kind == kRZZ ? 0 : kFlip2;
        } else {
          m0 = m1 = gate_coef(kind, co, s);
          if (c >= 0) en.flags = kCtrl;
          gen = kind == kRX ? kGenX : kind == kRY ? kGenY
                                    : kind == kRZ ? kGenZ : kGenNone;
        }
        en.flags |= gen << kGenShift;
        if (v == 0 && sl >= 0 && gen != kGenNone) en.grad = g + 1;
        c4* cf = sh.coef + 4 * idx;
        cf[0] = c4{m0.u00r, m0.u00i, m0.u01r, m0.u01i};
        cf[1] = c4{m0.u10r, m0.u10i, m0.u11r, m0.u11i};
        cf[2] = c4{m1.u00r, m1.u00i, m1.u01r, m1.u01i};
        cf[3] = c4{m1.u10r, m1.u10i, m1.u11r, m1.u11i};
      }
      sh.ent[idx] = en;
    }
  }
  __syncthreads();
}

// Pair q of an entry: (l0, l1) and the bit c of l0 (0 without one);
// false where a control skips the pair.
template <class T>
__device__ __forceinline__ bool entry_pair(const Entry<T>& en, int q,
                                           int& l0, int& l1, int& b) {
  l0 = pair_low(q, en.tl);
  b = en.cl >= 0 ? (l0 >> en.cl) & 1 : 0;
  if ((en.flags & kCtrl) && !b) return false;
  l1 = l0 | (1 << en.tl);
  if (en.flags & kFlip2) l1 ^= 1 << en.cl;
  return true;
}

template <class T>
__device__ __forceinline__ typename Real<T>::coef entry_coef(
    const Sh<T>& sh, int idx, int b) {
  const typename Real<T>::c4 r0 = sh.coef[4 * idx + 2 * b];
  const typename Real<T>::c4 r1 = sh.coef[4 * idx + 2 * b + 1];
  return {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
}

// psi <- U psi for entry idx over the chunk's `pairs`.  Ends on a barrier.
template <class T>
__device__ __forceinline__ void chunk_gate(const Sh<T>& sh, int idx,
                                           int pairs) {
  using c2 = typename Real<T>::c2;
  const Entry<T> en = sh.ent[idx];
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    int l0, l1, b;
    if (!entry_pair(en, q, l0, l1, b)) continue;
    const typename Real<T>::coef u = entry_coef(sh, idx, b);
    const c2 a0 = sh.psi[l0], a1 = sh.psi[l1];
    T r, i;
    cmul2(u.u00r, u.u00i, a0.x, a0.y, u.u01r, u.u01i, a1.x, a1.y, r, i);
    sh.psi[l0] = c2{r, i};
    cmul2(u.u10r, u.u10i, a0.x, a0.y, u.u11r, u.u11i, a1.x, a1.y, r, i);
    sh.psi[l1] = c2{r, i};
  }
  __syncthreads();
}

// The adjoint step of entry idx over the chunk's `pairs`: psi <- U^H psi,
// lambda <- U^T lambda, and, for an angle gate, the chunk's part of its
// gradient row, 1/2 Im[(P psi)^T lambda] over its pairs with the
// post-gate psi, summed in a fixed order into gpart_row[g * chunks +
// chunk].  Ends on a barrier; `parity` alternates the partials' buffer.
template <class C, class T>
__device__ __forceinline__ void chunk_gate_adj(const Sh<T>& sh, int idx,
                                               int pairs, T* gpart_row,
                                               int chunks, int chunk,
                                               int& parity) {
  using c2 = typename Real<T>::c2;
  const Entry<T> en = sh.ent[idx];
  const int gen = en.flags >> kGenShift;
  T gp = T(0);
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    int l0, l1, b;
    if (!entry_pair(en, q, l0, l1, b)) continue;
    const typename Real<T>::coef u = entry_coef(sh, idx, b);
    const c2 a0 = sh.psi[l0], a1 = sh.psi[l1];
    const c2 m0 = sh.lam[l0], m1 = sh.lam[l1];
    if (en.grad) {
      // P on the pair: X (a1, a0), Y (-i a1, i a0), Z (a0, -a1), times the
      // sign of RYY's / RZZ's ZZ eigenvalue
      T q0r, q0i, q1r, q1i;
      if (gen == kGenX) {
        q0r = a1.x; q0i = a1.y; q1r = a0.x; q1i = a0.y;
      } else if (gen == kGenY) {
        q0r = a1.y; q0i = -a1.x; q1r = -a0.y; q1i = a0.x;
      } else {
        q0r = a0.x; q0i = a0.y; q1r = -a1.x; q1i = -a1.y;
      }
      const T sg = b ? en.sg1 : en.sg0;
      gp += T(0.5) * sg * (q0r * m0.y + q0i * m0.x + q1r * m1.y + q1i * m1.x);
    }
    T r, i;
    cmul2(u.u00r, -u.u00i, a0.x, a0.y, u.u10r, -u.u10i, a1.x, a1.y, r, i);
    sh.psi[l0] = c2{r, i};
    cmul2(u.u01r, -u.u01i, a0.x, a0.y, u.u11r, -u.u11i, a1.x, a1.y, r, i);
    sh.psi[l1] = c2{r, i};
    cmul2(u.u00r, u.u00i, m0.x, m0.y, u.u10r, u.u10i, m1.x, m1.y, r, i);
    sh.lam[l0] = c2{r, i};
    cmul2(u.u01r, u.u01i, m0.x, m0.y, u.u11r, u.u11i, m1.x, m1.y, r, i);
    sh.lam[l1] = c2{r, i};
  }
  T* red = sh.red + parity * kWarps;
  if (en.grad) {                          // block-uniform
    for (int off = 16; off > 0; off >>= 1)
      gp += __shfl_xor_sync(0xffffffffu, gp, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = gp;
  }
  __syncthreads();
  if (en.grad) {
    if (threadIdx.x == 0) {
      const int warps = C::kWholeRows ? (int)(blockDim.x >> 5) : kWarps;
      T s = T(0);
      for (int w = 0; w < warps; ++w) s += red[w];
      gpart_row[(size_t)(en.grad - 1) * chunks + chunk] = s;
    }
    parity ^= 1;
  }
}

// The CTA's segment: its row, chunk, env, the segment's gate range [b0, b1)
// (into the live-gate list, or the tape itself for a whole row), its
// local-qubit mask and the live-gate list (null for a whole row); false
// (for the whole CTA) when the row's tape has no segment `seg`.
struct Where {
  int row, chunk, e, b0, b1;
  unsigned mask;
  const int* live;
};

template <class C>
__device__ __forceinline__ bool where_is(const Args<typename C::T>& a,
                                         int seg, Where& at, int& nseg) {
  const int chunks = 1 << (a.n - C::chunk_bits(a.n));
  at.row = blockIdx.x / chunks;
  at.chunk = blockIdx.x % chunks;
  at.e = at.row / a.S;
  if (C::whole(a.n)) {
    nseg = 1;
    at.b0 = 0;
    at.b1 = a.G;
    at.mask = (1u << a.n) - 1u;
    at.live = nullptr;
    return seg == 0;
  }
  const int* w = a.sched + (size_t)(at.e % a.es) * segments::words(a.G);
  nseg = __ldg(w);
  if (seg >= nseg) return false;
  at.b0 = __ldg(w + 1 + seg);
  at.b1 = __ldg(w + 2 + seg);
  at.mask = (unsigned)__ldg(w + a.G + 2 + seg);
  at.live = w + 2 * a.G + 2;
  return true;
}

// Global index in its row of the chunk's local amplitude l.
template <class C>
__device__ __forceinline__ size_t amp_index(const int* lq, int n, int base,
                                            int l) {
  if (C::whole(n)) return (size_t)l;
  return (size_t)(base | segments::local_index<C::kChunkBits>(lq, l));
}

// Forward over segment `seg`: one chunk of one row a CTA, from psi0 (the
// first segment) or the output planes, through the segment's gates, back
// to the output planes.
template <class C>
__device__ __forceinline__ void fwd(const Args<typename C::T>& a, int seg,
                                    unsigned char* smem) {
  using T = typename C::T;
  using c2 = typename Real<T>::c2;
  const int cb = C::chunk_bits(a.n);
  const Sh<T> sh = carve<T>(smem, false, cb);
  Where at;
  int nseg;
  if (!where_is<C>(a, seg, at, nseg)) return;  // block-uniform
  split_mask(sh, at.mask, a.n);
  __syncthreads();
  const size_t D = (size_t)1 << a.n;
  const size_t rb = (size_t)at.row * D;
  const int base =
      C::whole(a.n) ? 0
                    : segments::chunk_base<C::kChunkBits>(sh.nq, at.chunk,
                                                          a.n);
  const T* src_re = seg == 0 ? a.in_re : a.out_re;
  const T* src_im = seg == 0 ? a.in_im : a.out_im;
  for (int l = threadIdx.x; l < (1 << cb); l += blockDim.x) {
    const size_t i = rb + amp_index<C>(sh.lq, a.n, base, l);
    sh.psi[l] = c2{src_re[i], src_im[i]};
  }
  for (int lo = at.b0; lo < at.b1; lo += kBatch) {
    const int nb = min(kBatch, at.b1 - lo);
    __syncthreads();                      // the last batch's entries read
    load_entries<C>(sh, a, at.live, lo, nb, at.row, at.e, at.mask);
    for (int idx = 0; idx < nb * a.weave; ++idx)
      if (sh.ent[idx].kind != kNone) chunk_gate(sh, idx, 1 << (cb - 1));
  }
  __syncthreads();
  for (int l = threadIdx.x; l < (1 << cb); l += blockDim.x) {
    const size_t i = rb + amp_index<C>(sh.lq, a.n, base, l);
    const c2 v = sh.psi[l];
    a.out_re[i] = v.x;
    a.out_im[i] = v.y;
  }
}

// Adjoint over segment `seg` (the launches run the segments last first):
// psi from the forward's output (the row's last segment) or the scratch
// planes, lambda from the cotangents (gre, -gim) or its scratch planes,
// through the segment's entries in reverse; then back to the scratch
// planes, or, after the first segment, lambda into the psi0 cotangents
// (Re lambda, -Im lambda) where the caller asked for them.
template <class C>
__device__ __forceinline__ void bwd(const Args<typename C::T>& a, int seg,
                                    unsigned char* smem) {
  using T = typename C::T;
  using c2 = typename Real<T>::c2;
  const int cb = C::chunk_bits(a.n);
  const Sh<T> sh = carve<T>(smem, true, cb);
  Where at;
  int nseg;
  if (!where_is<C>(a, seg, at, nseg)) return;  // block-uniform
  split_mask(sh, at.mask, a.n);
  __syncthreads();
  const int chunks = 1 << (a.n - cb);
  const size_t D = (size_t)1 << a.n;
  const size_t rb = (size_t)at.row * D;
  const int base =
      C::whole(a.n) ? 0
                    : segments::chunk_base<C::kChunkBits>(sh.nq, at.chunk,
                                                          a.n);
  const bool first = seg == nseg - 1;
  for (int l = threadIdx.x; l < (1 << cb); l += blockDim.x) {
    const size_t i = rb + amp_index<C>(sh.lq, a.n, base, l);
    if (first) {
      sh.psi[l] = c2{a.in_re[i], a.in_im[i]};
      sh.lam[l] = c2{a.g_re[i], -a.g_im[i]};
    } else {
      sh.psi[l] = c2{a.out_re[i], a.out_im[i]};
      sh.lam[l] = c2{a.l_re[i], a.l_im[i]};
    }
  }
  T* gpart_row = a.gpart + (size_t)at.row * a.G * chunks;
  int parity = 0;
  for (int hi = at.b1; hi > at.b0; hi -= kBatch) {
    const int lo = max(at.b0, hi - kBatch), nb = hi - lo;
    __syncthreads();                      // the last batch's entries read
    load_entries<C>(sh, a, at.live, lo, nb, at.row, at.e, at.mask);
    for (int idx = nb * a.weave - 1; idx >= 0; --idx)
      if (sh.ent[idx].kind != kNone)
        chunk_gate_adj<C>(sh, idx, 1 << (cb - 1), gpart_row, chunks,
                          at.chunk, parity);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < (1 << cb); l += blockDim.x) {
    const size_t i = rb + amp_index<C>(sh.lq, a.n, base, l);
    const c2 p = sh.psi[l], m = sh.lam[l];
    if (seg > 0) {
      a.out_re[i] = p.x;
      a.out_im[i] = p.y;
      a.l_re[i] = m.x;
      a.l_im[i] = m.y;
    } else if (a.d_re != nullptr) {
      a.d_re[i] = m.x;
      a.d_im[i] = -m.y;
    }
  }
}

// Each row's angle gradients, a CTA of kThreads a row: every gradient
// gate's partials summed over the chunks in order (a warp a gate: lane l
// takes chunks l, l + 32, ..., then a fixed butterfly), then each angle's
// gates summed last first, as the plain version's scatter adds them.
template <class C>
__device__ __forceinline__ void bwd_grad(const Args<typename C::T>& a,
                                         typename C::T* dang,
                                         unsigned char* smem) {
  using T = typename C::T;
  T* gsum = reinterpret_cast<T*>(smem);
  int* gslot = reinterpret_cast<int*>(smem + align16(sizeof(T) * a.G));
  const int row = blockIdx.x, e = row / a.S;
  const int chunks = 1 << (a.n - C::chunk_bits(a.n));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t GW = (size_t)a.weave * a.G;
  for (int g = tid; g < a.G; g += blockDim.x) {
    const size_t at = (size_t)e * GW + (size_t)a.weave * g;
    const int k = __ldg(a.kind + at), sl = __ldg(a.slot + at);
    const bool grad = sl >= 0 && ((k >= kRX && k <= kRZ) || k >= kRXX);
    gslot[g] = grad ? sl : -1;
  }
  __syncthreads();
  const T* gp = a.gpart + (size_t)row * a.G * chunks;
  for (int g = warp; g < a.G; g += kWarps) {
    if (gslot[g] < 0) continue;           // warp-uniform
    T s = T(0);
    for (int c = lane; c < chunks; c += 32) s += gp[(size_t)g * chunks + c];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) gsum[g] = s;
  }
  __syncthreads();
  for (int r = tid; r < a.R; r += blockDim.x) {
    T dx = T(0);
    for (int g = a.G - 1; g >= 0; --g)
      if (gslot[g] == r) dx += gsum[g];
    dang[(size_t)row * a.R + r] = dx;
  }
}

// -- the host side ----------------------------------------------------------

// An instance's four kernels.
template <class C>
struct Kernels {
  void (*fwd)(Args<typename C::T>, int);
  void (*bwd)(Args<typename C::T>, int);
  void (*bwd_grad)(Args<typename C::T>, typename C::T*);
  void (*schedule)(const int*, const int*, const int*, int, int, int, int*);
};

template <class C>
size_t smem_bytes(bool adjoint, int n) {
  return smem_layout<typename C::T>(adjoint, C::chunk_bits(n), nullptr);
}

template <class C>
size_t grad_smem_bytes(int G) {
  return align16(sizeof(typename C::T) * G) + align16(sizeof(int) * G);
}

inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class C>
bool bad_shape(int E, int S, int G, int R, int n, const int* sched, int es,
               int weave) {
  return E < 1 || S < 1 || G < 1 || R < 1 || n < C::kMinQubits ||
         n > kMaxQubits ||
         (!C::whole(n) && (sched == nullptr || es < 1 || E % es != 0)) ||
         (weave != 1 && weave != kMaxWeave);
}

// How many CTAs of the forward (adjoint 0) or adjoint (1) segment kernel an
// SM holds at once at n qubits (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its threads and shared memory); 0 when none fits, or minus a CUDA
// error code.
template <class C>
int ctas_per_sm(const Kernels<C>& k, int adjoint, int n) {
  const size_t bytes = smem_bytes<C>(adjoint != 0, n);
  int per_sm = 0;
  cudaError_t err = (cudaError_t)set_smem(
      (const void*)(adjoint ? k.bwd : k.fwd), bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adjoint ? k.bwd : k.fwd, C::threads(n), bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();                   // not sticky for the next launch
    return -(int)err;
  }
  return per_sm;
}

template <class C>
int schedule_launch(const Kernels<C>& k, const int* kind, const int* tq,
                    const int* cq, int* out, int E, int G, int n,
                    void* stream) {
  if (E < 1 || G < 1 || n < C::kMinQubits || C::whole(n) ||
      n > kMaxQubits || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto kernel = k.schedule;
  KERNEL_LAUNCH(kernel, (E + 31) / 32, 32, 0,
                static_cast<cudaStream_t>(stream), kind, tq, cq, E, G, n,
                out);
  return (int)cudaGetLastError();
}

template <class C>
int fwd_launch(const Kernels<C>& k, const Args<typename C::T>& a,
               void* stream) {
  if (bad_shape<C>(a.E, a.S, a.G, a.R, a.n, a.sched, a.es, a.weave))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<C>(false, a.n);
  int err = set_smem((const void*)k.fwd, bytes);
  if (err != 0) return err;
  const int grid = a.E * a.S * (1 << (a.n - C::chunk_bits(a.n)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = k.fwd;
  for (int seg = 0; seg < max_segments<C>(a.G, a.n); ++seg) {
    KERNEL_LAUNCH(kernel, grid, C::threads(a.n), bytes, st, a, seg);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

template <class C>
int bwd_launch(const Kernels<C>& k, const Args<typename C::T>& a,
               typename C::T* dang, void* stream) {
  if (bad_shape<C>(a.E, a.S, a.G, a.R, a.n, a.sched, a.es, a.weave) ||
      (a.d_re == nullptr) != (a.d_im == nullptr) || a.gpart == nullptr ||
      (!C::whole(a.n) && (a.out_re == nullptr || a.out_im == nullptr ||
                          a.l_re == nullptr || a.l_im == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<C>(true, a.n);
  int err = set_smem((const void*)k.bwd, bytes);
  if (err != 0) return err;
  const size_t gbytes = grad_smem_bytes<C>(a.G);
  err = set_smem((const void*)k.bwd_grad, gbytes);
  if (err != 0) return err;
  const int grid = a.E * a.S * (1 << (a.n - C::chunk_bits(a.n)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = k.bwd;
  for (int seg = max_segments<C>(a.G, a.n) - 1; seg >= 0; --seg) {
    KERNEL_LAUNCH(kernel, grid, C::threads(a.n), bytes, st, a, seg);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const auto grad = k.bwd_grad;
  KERNEL_LAUNCH(grad, a.E * a.S, kThreads, gbytes, st, a, dang);
  return (int)cudaGetLastError();
}

}  // namespace tape_sweep
