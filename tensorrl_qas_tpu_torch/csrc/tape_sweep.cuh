// The body of the composed engine's sweep tape kernels, forward (B3f) and
// adjoint (B3b), templated on the real type of the planes: apply_tape_
// sweep.cu instantiates it in float for 17-20 qubits, apply_tape_f64.cu in
// double for 1-20 (Cfg below).  What the kernels compute is in those
// sources' headers; this is how.
//
// Every row stays in device memory as re / im planes and the card sweeps
// it segment by segment:
//   - A CTA takes one chunk of 2^cb amplitudes of one row into shared
//     memory as re / im planes (the adjoint also mu = conj(lambda), so
//     that lambda's update is psi's, U^H, and every copy is a plain one),
//     applies a segment's gates there (and their woven errors), one CTA
//     barrier a gate, and writes the chunk back.
//   - Rows of at most kChunkBits qubits (the double instance's) are one
//     chunk each: a CTA a row, one launch, the tape one segment of all its
//     gates, no schedule.
//   - Above, the tape is cut into segments (segments.cuh, the rule
//     fused_adam_v2_sweep.cu follows too; its twin ops/fused_adam2d.py:
//     sweep_segments, word for word): runs of consecutive live gates whose
//     qubits above qubit 4, a control or a two-qubit rotation's second
//     qubit included, number at most kChunkBits - 5.  A segment's local
//     qubits are qubits 0..4, its gates' and the lowest others up to
//     kChunkBits; the chunk's index gives the others.  A woven error Pauli
//     sits on its gate's own target or control, so it is local in its
//     gate's segment (asserted: a trap otherwise).  Qubits 0..4 are local
//     in every segment, so 32 consecutive values of a plane are a 16-B
//     aligned run in device memory and in the chunk.
//   - One launch a call (the adjoint one more, the gradient sum).  A
//     persistent grid of the CTAs the card holds at once (a cooperative
//     launch) takes work items from a ticket counter: (pass k, row,
//     chunk), pass k a row's segment k (the adjoint's segment nseg - 1 -
//     k).  A row with fewer segments has no item in the later passes: it
//     costs a word read, not a launch.  Tickets follow an order in which
//     every item an item waits on has a smaller ticket: pass by pass, row
//     by row, chunk by chunk (row-major: groups of rows whose state L2
//     holds, so that a row's next pass came sooner, were no faster).
//     Pass k of a row waits only on the row's counter of
//     finished chunks (released after their write-back, acquired before
//     the load; a spin with __nanosleep), never on a grid barrier.  A CTA
//     takes a ticket only while it runs and releases what it finished
//     before it spins, so the least unfinished ticket can always go on:
//     no deadlock, whatever the grid.
//   - A chunk comes in by cp.async, 16 B a copy, the whole chunk in flight
//     at once; with two or three CTAs an SM one CTA's copies run under
//     another's gates.  Where a second chunk buffer still leaves two CTAs
//     an SM (Cfg::stages), the next item's chunk loads while the current
//     item's gates run, if its wait is already over.  The write-back is
//     16-B stores, released after the next item's gates, or before any
//     spin.
//   - The forward's first pass reads psi0, the others the output planes,
//     in place.  The adjoint's passes run on psi (scratch planes; the first
//     reads the forward's output) and mu (scratch; the first reads the
//     cotangents, mu = gre + i gim); the last writes mu as the psi0
//     cotangents (Re lambda, -Im lambda).  Each angle gate's row is summed
//     over its chunk's pairs (a fixed-order block reduction) into a
//     per-chunk partial, and one last launch, a CTA a row, sums each
//     gate's partials over the chunks in order and each angle's gates last
//     first.  No atomics in any sum: a repeated call gives the same bits.
//   - The schedule (3 G + 2 words an env) depends only on the noiseless
//     tape: the schedule kernel builds it, one thread an env, once per
//     composed step and tape; a woven tape's rows read the noiseless
//     tape's row e % es.
// A gate is one pair update: the pair (l0, l1 = l0 | 2^t, and for RXX /
// RYY also ^ 2^c) of every l0 whose target bit is 0, with a 2x2 matrix
// chosen by l0's bit c (a control: the identity, skipped, at 0; RYY and
// RZZ: the ZZ eigenvalue's sign; else the same matrix), the adjoint with
// its conjugate transpose on psi and on mu.  All amplitude arithmetic is
// FMA in the instance's real type: no TF32.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "segments.cuh"

// The launches and the dynamic shared memory go through these macros, so
// that tests/cuda_emu/cuda_runtime.h, which defines them, can run the
// sources on the host.
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
#define DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif
#ifndef COOPERATIVE_LAUNCH
#define COOPERATIVE_LAUNCH(kernel, grid, block, bytes, stream, param)      \
  cudaLaunchCooperativeKernel((const void*)(kernel), dim3(grid),           \
                              dim3(block), (void**)(param), (bytes),       \
                              (stream))
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
// Threads of a sweep CTA alone on its SM (more warps to hide its shared
// memory's latency in the gates); others take kThreads.
constexpr int kLoneThreads = 512;
constexpr int kMaxWarps = (kLoneThreads > kThreads ? kLoneThreads
                                                   : kThreads) / 32;
// Live gates whose entries sit in shared memory at once (a segment with
// more takes them in batches), each with up to 3 woven entries.
constexpr int kBatch = 32;
constexpr int kMaxWeave = 3;
// An SM's shared memory (the H100's).
constexpr size_t kSmSmem = 233472;
// Chunk buffers a sweep CTA keeps where two still leave an SM two CTAs or
// more: the next item's chunk then loads while the current item's gates
// run (where two would leave one CTA an SM, one buffer and more CTAs
// overlap better: the gates want the warps).
constexpr int kMaxStages = 2;
// Spins (x 64 ns and more) a wait takes at most before it traps: a wait
// this long is a fault, which fails the launch rather than hang the card.
constexpr unsigned kSpinLimit = 1u << 24;
// The sync words of a call: the ticket counter alone on a 128-B line,
// then a counter of finished chunks a row.
constexpr int kLine = 32;

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

// A coefficient row (c4: two amplitudes), a 2x2 unitary (coef) and 16
// bytes of a plane (v16: a copy's unit) in the real type.
template <class T>
struct Real;
template <>
struct Real<float> {
  using c4 = float4;
  using coef = gates::Coef;
  using v16 = float4;
};
template <>
struct Real<double> {
  using c4 = Double4;
  using coef = DCoef;
  using v16 = Double2;
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

// A work item of a call, as thread 0 hands it to its CTA: its ticket (-1:
// the call's items are all taken), row, chunk, pass (k: the row's k-th
// pass in this call), segment, the row's segments, the segment's gate
// range [b0, b1) (into the live-gate list, or the tape itself for a whole
// row) and local-qubit mask, and the global index of the chunk's first
// amplitude.
struct Item {
  int ticket, row, chunk, step, seg, nseg, b0, b1, base;
  unsigned mask;
};

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Bytes of a chunk's planes (re, im; the adjoint also mu's) at cb bits.
template <class T>
__host__ __device__ constexpr size_t buffer_bytes(bool adjoint, int cb) {
  return (size_t)(adjoint ? 4 : 2) * (sizeof(T) << cb);
}

// The shared memory besides the chunk buffers: the entries (kBatch
// kMaxWeave), their coefficient rows (4 each: M0 rows 0, 1; M1 rows 0, 1),
// the gradient partials (2 kMaxWarps, double-buffered), each item slot's
// local qubits (2 kMaxQubits), the two item slots and a flag.
template <class T>
__host__ __device__ constexpr size_t fixed_bytes(int part) {
  return part == 0 ? sizeof(Entry<T>) * kBatch * kMaxWeave
       : part == 1 ? sizeof(typename Real<T>::c4) * 4 * kBatch * kMaxWeave
       : part == 2 ? sizeof(T) * 2 * kMaxWarps
       : part == 3 ? sizeof(int) * 2 * kMaxQubits
                   : sizeof(Item) * 2 + sizeof(int);
}

template <class T>
__host__ __device__ constexpr size_t smem_total(bool adjoint, int cb,
                                                int stages) {
  return align16(buffer_bytes<T>(adjoint, cb) * stages) +
         align16(fixed_bytes<T>(0)) + align16(fixed_bytes<T>(1)) +
         align16(fixed_bytes<T>(2)) + align16(fixed_bytes<T>(3)) +
         align16(fixed_bytes<T>(4));
}

// An instance: the real type, the chunk's qubits and the fewest qubits it
// takes.  Where that is at most the chunk's, rows of up to kChunkBits
// qubits are one chunk each.  The host tests compile the sources with
// smaller chunks, so that small states cross many segments.
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
  // CTAs an SM holds by their shared memory, `stages` chunk buffers each.
  __host__ __device__ static constexpr int per_sm(bool adjoint, int stages) {
    return (int)(kSmSmem / (smem_total<T>(adjoint, kChunkBits, stages) +
                            1024));
  }
  // Chunk buffers of a sweep CTA: two where that leaves two CTAs an SM.
  __host__ __device__ static constexpr int stages(bool adjoint) {
    return per_sm(adjoint, kMaxStages) >= 2 ? kMaxStages : 1;
  }
  // A sweep CTA's shared memory, and the CTAs an SM holds by it (its
  // __launch_bounds__, so that registers do not hold fewer).
  __host__ __device__ static constexpr size_t sweep_smem(bool adjoint) {
    return smem_total<T>(adjoint, kChunkBits, stages(adjoint));
  }
  __host__ __device__ static constexpr int min_blocks(bool adjoint) {
    return per_sm(adjoint, stages(adjoint)) > 1
               ? per_sm(adjoint, stages(adjoint)) : 1;
  }
  // Threads of a sweep CTA: kLoneThreads where it is alone on its SM.
  __host__ __device__ static constexpr int sweep_threads(bool adjoint) {
    return min_blocks(adjoint) == 1 ? kLoneThreads : kThreads;
  }
  // Threads of a CTA of the forward (adjoint 0) or adjoint (1) at n
  // qubits: a thread a pair of a whole row, from one warp to kThreads.
  __host__ __device__ static int threads(int n, bool adjoint) {
    if (!whole(n)) return sweep_threads(adjoint);
    const int pairs = 1 << (n - 1);
    return pairs < 32 ? 32 : pairs > kThreads ? kThreads : pairs;
  }
};

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
  T* l_re;                // adjoint: mu scratch
  T* l_im;
  T* d_re;                // adjoint: the psi0 cotangents (or null)
  T* d_im;
  T* gpart;               // adjoint: (E S, G, chunks) gradient partials
  const int* sched;       // (es, 3 G + 2) segments; null for whole rows
  int es, weave, E, S, G, R, n;
  unsigned* sync;         // cut rows: kLine + E S words, zeroed a call
};

// A chunk's planes in shared memory: psi's re / im, and mu's (adjoint).
template <class T>
struct Buf {
  T *re, *im, *mre, *mim;
};

template <class T>
struct Sh {
  unsigned char* bufs;        // the chunk buffers
  Entry<T>* ent;              // kBatch kMaxWeave
  typename Real<T>::c4* coef; // 4 kBatch kMaxWeave
  T* red;                     // 2 kMaxWarps
  int* lq;                    // 2 x kMaxQubits: an item slot's local qubits
  Item* item;                 // 2: the current and the next item
  int* flag;                  // the next item's chunk is on its way
};

template <class T>
__device__ __forceinline__ Sh<T> carve(unsigned char* base, bool adjoint,
                                       int cb, int stages) {
  Sh<T> sh;
  size_t b = 0;
  sh.bufs = base;
  b += align16(buffer_bytes<T>(adjoint, cb) * stages);
  sh.ent = reinterpret_cast<Entry<T>*>(base + b);
  b += align16(fixed_bytes<T>(0));
  sh.coef = reinterpret_cast<typename Real<T>::c4*>(base + b);
  b += align16(fixed_bytes<T>(1));
  sh.red = reinterpret_cast<T*>(base + b);
  b += align16(fixed_bytes<T>(2));
  sh.lq = reinterpret_cast<int*>(base + b);
  b += align16(fixed_bytes<T>(3));
  sh.item = reinterpret_cast<Item*>(base + b);
  sh.flag = reinterpret_cast<int*>(sh.item + 2);
  return sh;
}

// Buffer `stage` of a CTA's chunk buffers at cb bits.
template <class T>
__device__ __forceinline__ Buf<T> buffer(const Sh<T>& sh, int stage,
                                         bool adjoint, int cb) {
  T* p = reinterpret_cast<T*>(sh.bufs + buffer_bytes<T>(adjoint, cb) * stage);
  const int d = 1 << cb;
  return {p, p + d, adjoint ? p + 2 * d : nullptr,
          adjoint ? p + 3 * d : nullptr};
}

// The most segments a tape of G gates can have at n qubits: a segment
// closes only when its qubits above qubit 4 and the next gate's would
// exceed room = kChunkBits - 5, so it holds at least room - 1 of them, and
// a gate brings at most 2: every segment but the last has at least
// ceil((room - 1) / 2) live gates.  At most kChunkBits qubits never close
// one.  It bounds a call's items.
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

// One pair's update: (a0, a1) <- U (a0, a1) at l0, l1.  U by value: a
// reference to one of two matrices puts both in local memory.
template <class T>
__device__ __forceinline__ void pair_fwd(const Buf<T>& p, int l0, int l1,
                                         const typename Real<T>::coef u) {
  const T a0r = p.re[l0], a0i = p.im[l0], a1r = p.re[l1], a1i = p.im[l1];
  T r, i;
  cmul2(u.u00r, u.u00i, a0r, a0i, u.u01r, u.u01i, a1r, a1i, r, i);
  p.re[l0] = r;
  p.im[l0] = i;
  cmul2(u.u10r, u.u10i, a0r, a0i, u.u11r, u.u11i, a1r, a1i, r, i);
  p.re[l1] = r;
  p.im[l1] = i;
}

// psi <- U psi for entry idx over the chunk's `pairs`.  kHoist (a sweep
// CTA, eight pairs a thread and more): its two matrices in registers for
// the whole pass, and a gate with no second qubit takes the first with no
// test a pair; else (a whole row: a pair a thread, where registers bound
// the CTAs an SM) a pair's matrix from shared memory.  Ends on a barrier.
template <bool kHoist, class T>
__device__ __forceinline__ void chunk_gate(const Sh<T>& sh, const Buf<T>& p,
                                           int idx, int pairs) {
  const Entry<T> en = sh.ent[idx];
  if (!kHoist) {
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      int l0, l1, b;
      if (entry_pair(en, q, l0, l1, b))
        pair_fwd(p, l0, l1, entry_coef(sh, idx, b));
    }
    __syncthreads();
    return;
  }
  const typename Real<T>::coef u0 = entry_coef(sh, idx, 0);
  if (en.cl < 0) {
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int l0 = pair_low(q, en.tl);
      pair_fwd(p, l0, l0 | (1 << en.tl), u0);
    }
  } else {
    const typename Real<T>::coef u1 = entry_coef(sh, idx, 1);
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      int l0, l1, b;
      if (entry_pair(en, q, l0, l1, b)) pair_fwd(p, l0, l1, b ? u1 : u0);
    }
  }
  __syncthreads();
}

// One pair's adjoint step: its part of the gradient row (an angle gate,
// sign sg) into gp, then psi <- U^H psi and mu <- U^H mu at l0, l1.
template <class T>
__device__ __forceinline__ void pair_adj(const Buf<T>& p, int l0, int l1,
                                         const typename Real<T>::coef u,
                                         const Entry<T>& en, T sg, T& gp) {
  const T a0r = p.re[l0], a0i = p.im[l0], a1r = p.re[l1], a1i = p.im[l1];
  const T m0r = p.mre[l0], m0i = p.mim[l0], m1r = p.mre[l1],
          m1i = p.mim[l1];
  if (en.grad) {
    // P on the pair: X (a1, a0), Y (-i a1, i a0), Z (a0, -a1), times the
    // sign of RYY's / RZZ's ZZ eigenvalue; Im(x lambda) with lambda =
    // conj(mu) is xi mr - xr mi
    const int gen = en.flags >> kGenShift;
    T q0r, q0i, q1r, q1i;
    if (gen == kGenX) {
      q0r = a1r; q0i = a1i; q1r = a0r; q1i = a0i;
    } else if (gen == kGenY) {
      q0r = a1i; q0i = -a1r; q1r = -a0i; q1i = a0r;
    } else {
      q0r = a0r; q0i = a0i; q1r = -a1r; q1i = -a1i;
    }
    gp += T(0.5) * sg * (q0i * m0r - q0r * m0i + q1i * m1r - q1r * m1i);
  }
  T r, i;
  cmul2(u.u00r, -u.u00i, a0r, a0i, u.u10r, -u.u10i, a1r, a1i, r, i);
  p.re[l0] = r;
  p.im[l0] = i;
  cmul2(u.u01r, -u.u01i, a0r, a0i, u.u11r, -u.u11i, a1r, a1i, r, i);
  p.re[l1] = r;
  p.im[l1] = i;
  cmul2(u.u00r, -u.u00i, m0r, m0i, u.u10r, -u.u10i, m1r, m1i, r, i);
  p.mre[l0] = r;
  p.mim[l0] = i;
  cmul2(u.u01r, -u.u01i, m0r, m0i, u.u11r, -u.u11i, m1r, m1i, r, i);
  p.mre[l1] = r;
  p.mim[l1] = i;
}

// The adjoint step of entry idx over the chunk's `pairs` (pair_adj, its
// matrices as chunk_gate's), and, for an angle gate, the chunk's part of
// its gradient row, 1/2 Im[(P psi)^T lambda] over its pairs with the
// post-gate psi, summed in a fixed order into gpart_row[g * chunks +
// chunk].  Ends on a barrier; `parity` alternates the partials' buffer.
template <bool kHoist, class T>
__device__ __forceinline__ void chunk_gate_adj(const Sh<T>& sh,
                                               const Buf<T>& p, int idx,
                                               int pairs, T* gpart_row,
                                               int chunks, int chunk,
                                               int& parity) {
  const Entry<T> en = sh.ent[idx];
  T gp = T(0);
  if (!kHoist) {
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      int l0, l1, b;
      if (entry_pair(en, q, l0, l1, b))
        pair_adj(p, l0, l1, entry_coef(sh, idx, b), en,
                 b ? en.sg1 : en.sg0, gp);
    }
  } else if (en.cl < 0) {
    const typename Real<T>::coef u0 = entry_coef(sh, idx, 0);
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int l0 = pair_low(q, en.tl);
      pair_adj(p, l0, l0 | (1 << en.tl), u0, en, en.sg0, gp);
    }
  } else {
    const typename Real<T>::coef u0 = entry_coef(sh, idx, 0);
    const typename Real<T>::coef u1 = entry_coef(sh, idx, 1);
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      int l0, l1, b;
      if (entry_pair(en, q, l0, l1, b))
        pair_adj(p, l0, l1, b ? u1 : u0, en, b ? en.sg1 : en.sg0, gp);
    }
  }
  T* red = sh.red + parity * kMaxWarps;
  if (en.grad) {                          // block-uniform
    for (int off = 16; off > 0; off >>= 1)
      gp += __shfl_xor_sync(0xffffffffu, gp, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = gp;
  }
  __syncthreads();
  if (en.grad) {
    if (threadIdx.x == 0) {
      const int warps = (int)(blockDim.x >> 5);
      T s = T(0);
      for (int w = 0; w < warps; ++w) s += red[w];
      gpart_row[(size_t)(en.grad - 1) * chunks + chunk] = s;
    }
    parity ^= 1;
  }
}

// -- copies and waits -------------------------------------------------------

// 16 bytes from device memory into shared memory, asynchronously (L2
// only: other CTAs of the launch wrote them); cp_async_wait_all waits for
// the thread's copies.  The host emulation defers each copy to the wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
#elif defined(CUDA_EMU)
  emu::cp_async(dst, src, 16);
#else
  *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#elif defined(CUDA_EMU)
  emu::cp_async_wait();
#endif
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
#if defined(__CUDA_ARCH__)
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return *static_cast<const volatile unsigned*>(p);
#endif
}

// A finished chunk of row `row`: its write-back, by every thread of the
// CTA before a barrier, is seen by whoever acquires the counter after.
__device__ __forceinline__ void release_chunk(unsigned* done, int row) {
  __threadfence();
  atomicAdd(done + row, 1u);
}

// Global index in its row of the chunk's local amplitude l.
template <class C>
__device__ __forceinline__ int amp_index(const int* lq, int n, int base,
                                         int l) {
  if (C::whole(n)) return l;
  return base | segments::local_index<C::kChunkBits>(lq, l);
}

// The same of a multiple l of `step` (a power of two at least 32): its
// bits from log2(step) up.  A thread's copies take local amplitudes l0 +
// j step, l0 < step, whose index is amp_index(l0) | step_index(j step).
template <class C>
__device__ __forceinline__ int step_index(const int* lq, int n, int step,
                                          int l) {
  if (C::whole(n)) return l;
  int i = 0;
  for (int b = __ffs(step) - 1; b < C::kChunkBits; ++b)
    i |= ((l >> b) & 1) << lq[b];
  return i;
}

// An item's chunk into `p`, asynchronously (cp_async_wait_all, then a
// barrier, before it is read): the forward's psi from psi0 on the row's
// first pass, else from the output planes; the adjoint's psi and mu from
// the forward's output and the cotangents on the first pass, else from
// the scratch planes.
template <class C, bool kAdj>
__device__ __forceinline__ void load_chunk(const Args<typename C::T>& a,
                                           const Item& it, const int* lq,
                                           const Buf<typename C::T>& p) {
  using T = typename C::T;
  constexpr int kPer = 16 / sizeof(T);
  const int cb = C::chunk_bits(a.n);
  const size_t rb = (size_t)it.row << a.n;
  const bool first = it.step == 0;
  const T* pr = first ? a.in_re : a.out_re;
  const T* pi = first ? a.in_im : a.out_im;
  const T* mr = first ? a.g_re : a.l_re;
  const T* mi = first ? a.g_im : a.l_im;
  const int step = blockDim.x * kPer, l0 = threadIdx.x * kPer;
  const int i0 = amp_index<C>(lq, a.n, it.base, l0);
  for (int hi = 0; hi + l0 < (1 << cb); hi += step) {
    const int l = hi + l0;
    const size_t i = rb + (i0 | step_index<C>(lq, a.n, step, hi));
    cp_async16(p.re + l, pr + i);
    cp_async16(p.im + l, pi + i);
    if (kAdj) {
      cp_async16(p.mre + l, mr + i);
      cp_async16(p.mim + l, mi + i);
    }
  }
}

// An item's chunk from `p` back to device memory: the forward's to the
// output planes; the adjoint's psi and mu to the scratch planes, or, after
// the row's segment 0, mu to the psi0 cotangents where the caller asked
// for them.
template <class C, bool kAdj>
__device__ __forceinline__ void store_chunk(const Args<typename C::T>& a,
                                            const Item& it, const int* lq,
                                            const Buf<typename C::T>& p) {
  using T = typename C::T;
  using V = typename Real<T>::v16;
  constexpr int kPer = 16 / sizeof(T);
  const int cb = C::chunk_bits(a.n);
  const size_t rb = (size_t)it.row << a.n;
  T* dr = kAdj && it.seg == 0 ? nullptr : a.out_re;
  T* di = kAdj && it.seg == 0 ? nullptr : a.out_im;
  T* er = it.seg == 0 ? a.d_re : a.l_re;
  T* ei = it.seg == 0 ? a.d_im : a.l_im;
  const int step = blockDim.x * kPer, l0 = threadIdx.x * kPer;
  const int i0 = amp_index<C>(lq, a.n, it.base, l0);
  for (int hi = 0; hi + l0 < (1 << cb); hi += step) {
    const int l = hi + l0;
    const size_t i = rb + (i0 | step_index<C>(lq, a.n, step, hi));
    if (dr != nullptr) {
      *reinterpret_cast<V*>(dr + i) = *reinterpret_cast<const V*>(p.re + l);
      *reinterpret_cast<V*>(di + i) = *reinterpret_cast<const V*>(p.im + l);
    }
    if (kAdj && er != nullptr) {
      *reinterpret_cast<V*>(er + i) = *reinterpret_cast<const V*>(p.mre + l);
      *reinterpret_cast<V*>(ei + i) = *reinterpret_cast<const V*>(p.mim + l);
    }
  }
}

// An item's gates on its chunk `p`: the forward's segment in order, the
// adjoint's in reverse (with the gradient partials); kHoist as
// chunk_gate's.
template <class C, bool kAdj, bool kHoist>
__device__ __forceinline__ void item_gates(const Args<typename C::T>& a,
                                           const Sh<typename C::T>& sh,
                                           const Buf<typename C::T>& p,
                                           const Item& it, int chunks) {
  using T = typename C::T;
  const int e = it.row / a.S;
  const int* live = C::whole(a.n) ? nullptr
                  : a.sched + (size_t)(e % a.es) * segments::words(a.G) +
                        2 * a.G + 2;
  const int pairs = 1 << (C::chunk_bits(a.n) - 1);
  if (!kAdj) {
    for (int lo = it.b0; lo < it.b1; lo += kBatch) {
      const int nb = min(kBatch, it.b1 - lo);
      __syncthreads();                    // the last batch's entries read
      load_entries<C>(sh, a, live, lo, nb, it.row, e, it.mask);
      for (int idx = 0; idx < nb * a.weave; ++idx)
        if (sh.ent[idx].kind != kNone)
          chunk_gate<kHoist>(sh, p, idx, pairs);
    }
    return;
  }
  T* gpart_row = a.gpart + (size_t)it.row * a.G * chunks;
  int parity = 0;
  for (int hi = it.b1; hi > it.b0; hi -= kBatch) {
    const int lo = max(it.b0, hi - kBatch), nb = hi - lo;
    __syncthreads();                      // the last batch's entries read
    load_entries<C>(sh, a, live, lo, nb, it.row, e, it.mask);
    for (int idx = nb * a.weave - 1; idx >= 0; --idx)
      if (sh.ent[idx].kind != kNone)
        chunk_gate_adj<kHoist>(sh, p, idx, pairs, gpart_row, chunks,
                               it.chunk, parity);
  }
}

// A whole row a CTA (C::whole(n)): its chunk, all its gates, back.
template <class C, bool kAdj>
__device__ __forceinline__ void whole_row(const Args<typename C::T>& a,
                                          unsigned char* smem) {
  using T = typename C::T;
  const Sh<T> sh = carve<T>(smem, kAdj, a.n, 1);
  // every field but the row a constant, folded where used
  const Item it = {(int)blockIdx.x, (int)blockIdx.x, 0, 0, 0, 1, 0, a.G, 0,
                   (1u << a.n) - 1u};
  const Buf<T> p = buffer(sh, 0, kAdj, a.n);
  load_chunk<C, kAdj>(a, it, sh.lq, p);
  cp_async_wait_all();
  __syncthreads();
  item_gates<C, kAdj, false>(a, sh, p, it, 1);
  store_chunk<C, kAdj>(a, it, sh.lq, p);
}

// Thread 0's walk over a call's tickets, in their order: pass k, row r
// (skipping rows with at most k segments), chunk; base the first ticket
// of (pass k, row r).
struct Cursor {
  int k, r, base;
};

// Segments of row `row`'s tape.
template <class C>
__device__ __forceinline__ int row_segments(const Args<typename C::T>& a,
                                            int row) {
  return __ldg(a.sched + (size_t)((row / a.S) % a.es) * segments::words(a.G));
}

// The next (pass, row) in ticket order that has an item.
template <class C>
__device__ __forceinline__ void next_row(const Args<typename C::T>& a,
                                         Cursor& c) {
  do {
    if (++c.r == a.E * a.S) {
      c.r = 0;
      ++c.k;
    }
  } while (row_segments<C>(a, c.r) <= c.k);
}

// Thread 0: the next ticket into item slot `it` (its local qubits into
// lq): -1 past the call's `total` items.
template <class C, bool kAdj>
__device__ __forceinline__ void take(const Args<typename C::T>& a,
                                     Cursor& c, int total, int chunks,
                                     Item& it, int* lq) {
  const int t = (int)atomicAdd(a.sync, 1u);
  it.ticket = -1;
  if (t >= total) return;
  while (t >= c.base + chunks) {
    c.base += chunks;
    next_row<C>(a, c);
  }
  const int* w = a.sched + (size_t)((c.r / a.S) % a.es) * segments::words(a.G);
  const int nseg = __ldg(w), seg = kAdj ? nseg - 1 - c.k : c.k;
  const unsigned mask = (unsigned)__ldg(w + a.G + 2 + seg);
  const int chunk = t - c.base;
  int nl = 0, nb = 0, base = 0;
  for (int q = 0; q < a.n; ++q) {
    if ((mask >> q) & 1) {
      lq[nl++] = q;
    } else {
      base |= ((chunk >> nb) & 1) << q;
      ++nb;
    }
  }
  it = {t, c.r, chunk, c.k, seg, nseg, __ldg(w + 1 + seg), __ldg(w + 2 + seg),
        base, mask};
}

// Whether an item's pass may start: the row's chunks of every earlier pass
// are finished (its first pass waits on nothing).
__device__ __forceinline__ bool ready(const unsigned* done, const Item& it,
                                      int chunks) {
  return it.step == 0 || ld_acquire(done + it.row) >=
                             (unsigned)it.step * (unsigned)chunks;
}

__device__ __forceinline__ void wait_ready(const unsigned* done,
                                           const Item& it, int chunks) {
  unsigned spins = 0;
  while (!ready(done, it, chunks)) {
    if (++spins == kSpinLimit) __trap();
    __nanosleep(64);
  }
}

// The persistent CTA of a cut row's call (the grid takes every item of
// the call from the ticket counter; see the header).
template <class C, bool kAdj>
__device__ __forceinline__ void sweep(const Args<typename C::T>& a,
                                      unsigned char* smem) {
  using T = typename C::T;
  constexpr int kStages = C::stages(kAdj);
  const int cb = C::kChunkBits;
  const Sh<T> sh = carve<T>(smem, kAdj, cb, kStages);
  const int tid = threadIdx.x;
  const int chunks = 1 << (a.n - cb);
  unsigned* const done = a.sync + kLine;
  Cursor cur;
  int total = 0, pend = -1;               // thread 0's
  if (tid == 0) {
    cur = {0, 0, 0};
    for (int r = 0; r < a.E * a.S; ++r) total += row_segments<C>(a, r);
    total *= chunks;
    take<C, kAdj>(a, cur, total, chunks, sh.item[0], sh.lq);
    if (sh.item[0].ticket >= 0) wait_ready(done, sh.item[0], chunks);
  }
  __syncthreads();
  if (sh.item[0].ticket < 0) return;
  load_chunk<C, kAdj>(a, sh.item[0], sh.lq, buffer(sh, 0, kAdj, cb));
  cp_async_wait_all();
  __syncthreads();
  for (int is = 0;; is ^= 1) {
    const int nx = is ^ 1;
    const Buf<T> p = buffer(sh, is % kStages, kAdj, cb);
    const Buf<T> pn = buffer(sh, nx % kStages, kAdj, cb);
    int* const lq = sh.lq + is * kMaxQubits;
    int* const lqn = sh.lq + nx * kMaxQubits;
    if (tid == 0) {
      take<C, kAdj>(a, cur, total, chunks, sh.item[nx], lqn);
      *sh.flag = sh.item[nx].ticket >= 0 && ready(done, sh.item[nx], chunks);
    }
    __syncthreads();
    const Item it = sh.item[is], nt = sh.item[nx];
    const bool now = *sh.flag, ahead = kStages > 1 && now;
    if (ahead) load_chunk<C, kAdj>(a, nt, lqn, pn);
    item_gates<C, kAdj, true>(a, sh, p, it, chunks);
    if (tid == 0 && pend >= 0) {          // its stores are long out
      release_chunk(done, pend);
      pend = -1;
    }
    store_chunk<C, kAdj>(a, it, lq, p);
    if (tid == 0) pend = it.row;
    if (nt.ticket < 0) break;
    if (!ahead) {
      __syncthreads();                    // the stores issued (and, one
      if (!now) {                         // buffer, its reads done)
        if (tid == 0) {
          release_chunk(done, pend);
          pend = -1;
          wait_ready(done, nt, chunks);
        }
        __syncthreads();
      }
      load_chunk<C, kAdj>(a, nt, lqn, pn);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  __syncthreads();
  if (tid == 0) release_chunk(done, pend);
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
  for (int g = warp; g < a.G; g += kThreads / 32) {
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

// An instance's kernels: the whole-row forward and adjoint (null where the
// instance takes no whole rows), the sweep forward and adjoint, the
// gradient sum and the schedule.
template <class C>
struct Kernels {
  void (*whole_fwd)(Args<typename C::T>);
  void (*whole_bwd)(Args<typename C::T>);
  void (*fwd)(Args<typename C::T>);
  void (*bwd)(Args<typename C::T>);
  void (*bwd_grad)(Args<typename C::T>, typename C::T*);
  void (*schedule)(const int*, const int*, const int*, int, int, int, int*);
};

template <class C>
size_t smem_bytes(bool adjoint, int n) {
  return C::whole(n) ? smem_total<typename C::T>(adjoint, n, 1)
                     : C::sweep_smem(adjoint);
}

template <class C>
size_t grad_smem_bytes(int G) {
  return align16(sizeof(typename C::T) * G) + align16(sizeof(int) * G);
}

// The sync words of a call on `rows` rows.
inline int sync_words(int rows) { return kLine + rows; }

inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class C>
const void* kernel_of(const Kernels<C>& k, int adjoint, int n) {
  if (C::whole(n))
    return (const void*)(adjoint ? k.whole_bwd : k.whole_fwd);
  return (const void*)(adjoint ? k.bwd : k.fwd);
}

template <class C>
bool bad_shape(int E, int S, int G, int R, int n, const int* sched, int es,
               int weave) {
  return E < 1 || S < 1 || G < 1 || R < 1 || n < C::kMinQubits ||
         n > kMaxQubits ||
         (!C::whole(n) && (sched == nullptr || es < 1 || E % es != 0)) ||
         (weave != 1 && weave != kMaxWeave);
}

// How many CTAs of the forward (adjoint 0) or adjoint (1) kernel at n
// qubits an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its threads and shared memory); 0 when none fits, or minus a CUDA
// error code.
template <class C>
int ctas_per_sm(const Kernels<C>& k, int adjoint, int n) {
  const size_t bytes = smem_bytes<C>(adjoint != 0, n);
  const void* kernel = kernel_of(k, adjoint, n);
  int per_sm = 0;
  cudaError_t err = (cudaError_t)set_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adjoint ? (C::whole(n) ? k.whole_bwd : k.bwd)
                         : (C::whole(n) ? k.whole_fwd : k.fwd),
        C::threads(n, adjoint != 0), bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();                   // not sticky for the next launch
    return -(int)err;
  }
  return per_sm;
}

// The CTAs of the forward (adjoint 0) or adjoint (1) sweep kernel the card
// holds at once at n qubits (ctas_per_sm times the SMs): a call's grid at
// most; 0 when none fits, or minus a CUDA error code.
template <class C>
int resident_ctas(const Kernels<C>& k, int adjoint, int n) {
  const int per_sm = ctas_per_sm(k, adjoint, n);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return per_sm < 0 ? per_sm : per_sm * sms;
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

// One call's forward (adjoint 0) or adjoint (1) segment work: a launch of
// a CTA a row for whole rows; else the call's sync words zeroed and one
// cooperative launch of at most the resident CTAs.
template <class C>
int pass_launch(const Kernels<C>& k, Args<typename C::T> a, int adjoint,
                cudaStream_t st) {
  const size_t bytes = smem_bytes<C>(adjoint != 0, a.n);
  int err = set_smem(kernel_of(k, adjoint, a.n), bytes);
  if (err != 0) return err;
  if (C::whole(a.n)) {
    const auto kernel = adjoint ? k.whole_bwd : k.whole_fwd;
    KERNEL_LAUNCH(kernel, a.E * a.S, C::threads(a.n, adjoint != 0), bytes,
                  st, a);
    return (int)cudaGetLastError();
  }
  const int resident = resident_ctas(k, adjoint, a.n);
  if (resident < 1) return resident < 0 ? -resident : cudaErrorInvalidValue;
  const long long items = (long long)a.E * a.S *
                          (1 << (a.n - C::kChunkBits)) *
                          max_segments<C>(a.G, a.n);
  const int grid = (int)(items < resident ? items : resident);
  err = (int)cudaMemsetAsync(a.sync, 0,
                             sizeof(unsigned) * sync_words(a.E * a.S), st);
  if (err != 0) return err;
  const auto kernel = adjoint ? k.bwd : k.fwd;
  void* args[] = {&a};
  err = (int)COOPERATIVE_LAUNCH(kernel, grid, C::sweep_threads(adjoint != 0),
                               bytes, st, args);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <class C>
int fwd_launch(const Kernels<C>& k, const Args<typename C::T>& a,
               void* stream) {
  if (bad_shape<C>(a.E, a.S, a.G, a.R, a.n, a.sched, a.es, a.weave) ||
      (!C::whole(a.n) && a.sync == nullptr))
    return (int)cudaErrorInvalidValue;
  return pass_launch(k, a, 0, static_cast<cudaStream_t>(stream));
}

template <class C>
int bwd_launch(const Kernels<C>& k, const Args<typename C::T>& a,
               typename C::T* dang, void* stream) {
  if (bad_shape<C>(a.E, a.S, a.G, a.R, a.n, a.sched, a.es, a.weave) ||
      (a.d_re == nullptr) != (a.d_im == nullptr) || a.gpart == nullptr ||
      (!C::whole(a.n) && (a.out_re == nullptr || a.out_im == nullptr ||
                          a.l_re == nullptr || a.l_im == nullptr ||
                          a.sync == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t gbytes = grad_smem_bytes<C>(a.G);
  int err = set_smem((const void*)k.bwd_grad, gbytes);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = pass_launch(k, a, 1, st);
  if (err != 0) return err;
  const auto grad = k.bwd_grad;
  KERNEL_LAUNCH(grad, a.E * a.S, kThreads, gbytes, st, a, dang);
  return (int)cudaGetLastError();
}

}  // namespace tape_sweep
