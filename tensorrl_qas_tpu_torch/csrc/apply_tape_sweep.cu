// Each env's own gate tape on its block of states, forward (B3f) and
// adjoint (B3b), for 17 <= n <= 20 qubits (CUDA, sm_90a): the sweep tape
// kernels of the composed engine.
//
// Replaces the TPU kernels tensorrl_qas_tpu/ops/pallas_apply.py:_fwd_kernel
// (launched by _call_fwd) and _bwd_kernel (launched by _call_bwd, the
// custom_vjp backward of apply_tape_pallas_ri) at the sizes where the JAX
// package runs the composed engine through XLA (tensorrl_qas_tpu/optim/
// angle_opt.py:808-845: every composed configuration above D = 65536).
// The plain PyTorch versions of the same functions are
// tensorrl_qas_tpu_torch/ops/apply_tape.py:apply_tape_fwd_plain and
// apply_tape_bwd_plain; apply_tape.cu computes the same below 17 qubits.
// What is computed, for each (env e, start s) row, as there:
//   forward:  psi = tape_e(angles[e, s]) psi0[e, s]
//   adjoint:  from the output psi and lambda = gre - i gim, each gate g,
//             last first: dang[e, s, slot_g] += 1/2 Im[(P_g psi)^T lambda],
//             psi <- U_g^H psi, lambda <- U_g^T lambda; then
//             (dre, dim) = (Re lambda, -Im lambda).
// Gate kinds: the 1-qubit gates (gates.cuh; controlled when cq >= 0), CX,
// RXX / RYY / RZZ = exp(-i theta/2 P_t P_c) (cq the second qubit), and the
// error Paulis of a woven tape (optim/angle_opt.py:extend_tape_arrays,
// weave 3: gate g at 3 g, its errors on its target and control at 3 g + 1
// and 3 g + 2).
//
// Why another design.  apply_tape.cu's wide kernels hold a row in the
// registers of a cluster of 2^(n - 12) CTAs; at 17 qubits that is 32 CTAs,
// more than a cluster may have, and at 20 qubits an (E S) batch of rows is
// 256 MB, which no chip-resident design holds.  Here, as in
// fused_adam_v2_sweep.cu, every row stays in device memory as float re /
// im planes and the card sweeps it segment by segment:
//
//   - The tape is cut into segments (segments.cuh, the rule
//     fused_adam_v2_sweep.cu follows too; its twin ops/fused_adam2d.py:
//     sweep_segments, word for word): runs of consecutive live gates whose
//     qubits above qubit 4, a control or a two-qubit rotation's second
//     qubit included, number at most kChunkBits - 5.  A segment's local
//     qubits are qubits
//     0..4, its gates' and the lowest others up to kChunkBits.  A woven
//     error Pauli sits on its gate's own target or control, so it is local
//     in its gate's segment (asserted: a trap otherwise).
//   - One launch per segment: a CTA takes one chunk of 2^kChunkBits
//     amplitudes of one row, the amplitudes that differ only in the
//     segment's local qubits (the chunk's index gives the others), into
//     shared memory, applies every gate of the segment there (and its
//     errors), one CTA barrier a gate, and writes the chunk back.  Qubits
//     0..4 are local in every segment, so a warp reads 32 consecutive
//     floats of a plane.  The launch boundary is the barrier between
//     segments, so no CTA waits on another and the grid (rows x chunks
//     CTAs) needs no residency; the host cannot know a tape's segment
//     count without reading the card, so a call makes max_segments(G, n)
//     launches, the most any tape of G gates can need, and a CTA whose
//     row has fewer returns at once.  A CUDA graph captures the launches
//     as they are.
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
//     tape: apply_tape_sweep_schedule_kernel builds it, one thread an env,
//     once per composed step and tape; a woven tape's rows read the
//     noiseless tape's row e % es.
// A gate is one pair update: the pair (l0, l1 = l0 | 2^t, and for RXX /
// RYY also ^ 2^c) of every l0 whose target bit is 0, with a 2x2 matrix
// chosen by l0's bit c (a control: the identity, skipped, at 0; RYY and
// RZZ: the ZZ eigenvalue's sign; else the same matrix), the adjoint with
// its conjugate transpose on psi and its transpose on lambda.  All
// amplitude arithmetic is f32 FMA: no TF32.
//
// Bound.  Bytes the function must move: the planes in and out once
// (forward 4, adjoint 6 planes of E S D floats, the adjoint's psi0
// cotangents included); at 20 qubits, E = 8, S = 4 that is 537 MB
// forward, 0.16 ms at the card's 3.35 TB/s, and 805 MB adjoint, 0.24 ms.
// What the design moves: each segment reads and writes every row once
// (the adjoint psi and lambda), so about `segments` times that; the
// shared-memory passes (a barrier a gate) and the segments' count bound
// it, not operations (an RX is 6 flops an amplitude).  chip_smoke.py
// prints the bound at the main path's shapes.

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "segments.cuh"

// The launches and the dynamic shared memory go through these two macros,
// so that tests/cuda_emu/cuda_runtime.h, which defines both, can run this
// source on the host.
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
#define DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

// The chunk: 2^kChunkBits amplitudes a CTA takes at once.  The host tests
// compile the source with smaller chunks and a lower qubit band, so that
// small states cross many segments.
#ifndef APPLY_TAPE_SWEEP_CHUNK_BITS
#define APPLY_TAPE_SWEEP_CHUNK_BITS 12
#endif
#ifndef APPLY_TAPE_SWEEP_MIN_QUBITS
#define APPLY_TAPE_SWEEP_MIN_QUBITS 17
#endif

namespace {

using namespace gates;

enum : int { kRXX = 9, kRYY = 10, kRZZ = 11 };

constexpr int kChunkBits = APPLY_TAPE_SWEEP_CHUNK_BITS;
constexpr int kChunk = 1 << kChunkBits;
constexpr int kLaneQubits = segments::kLaneQubits;
constexpr int kMinQubits = APPLY_TAPE_SWEEP_MIN_QUBITS;
constexpr int kMaxQubits = 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Live gates whose entries sit in shared memory at once (a segment with
// more takes them in batches), each with up to 3 woven entries.
constexpr int kBatch = 32;
constexpr int kMaxWeave = 3;
static_assert(kChunkBits >= kLaneQubits + 2 && kMinQubits >= kChunkBits,
              "a chunk holds qubits 0..4 and a gate's two qubits");

// An entry's flags: a control (pairs whose control bit is 0 are skipped),
// RXX / RYY (the pair also flips the second qubit), and the generator's
// form for the gradient (X-like, Y-like, Z-like on the pair).
enum : int { kCtrl = 1, kFlip2 = 2, kGenShift = 2 };
enum : int { kGenNone = 0, kGenX = 1, kGenY = 2, kGenZ = 3 };

// One woven tape position of a segment as a pass applies it: kind (kNone:
// skipped), target and second / control qubit as local bits (-1: none),
// flags, the noiseless gate's index + 1 when it has an angle gradient (else
// 0), and the generator's sign for a pair whose l0 has bit c at 0 / 1.
struct Entry {
  int kind, tl, cl, flags, grad;
  float sg0, sg1;
  int pad;
};

struct Args {
  const int* kind;        // (E, weave G) woven tape, or (E, G)
  const int* tq;
  const int* cq;
  const int* slot;
  const float* angles;    // (E S, R)
  const float* in_re;     // forward: psi0; adjoint: the forward's output
  const float* in_im;
  float* out_re;          // forward: the output; adjoint: psi scratch
  float* out_im;
  const float* g_re;      // adjoint: the cotangents
  const float* g_im;
  float* l_re;            // adjoint: lambda scratch
  float* l_im;
  float* d_re;            // adjoint: the psi0 cotangents (or null)
  float* d_im;
  float* gpart;           // adjoint: (E S, G, chunks) gradient partials
  const int* sched;       // (es, 3 G + 2) segments of the noiseless tape
  int es, weave, E, S, G, R, n;
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

struct Sh {
  float2* psi;     // kChunk: the chunk of psi ...
  float2* lam;     // ... and of lambda (adjoint)
  Entry* ent;      // kBatch kMaxWeave
  float4* coef;    // 4 kBatch kMaxWeave: M0 rows 0, 1; M1 rows 0, 1
  float* red;      // 2 kWarps: gradient partials, double-buffered
  int* lq;         // kMaxQubits: the qubit of each local bit
  int* nq;         // kMaxQubits: the qubit of each chunk-index bit
};

__host__ __device__ __forceinline__ size_t smem_layout(bool adjoint,
                                                       size_t* off) {
  const size_t n_ent = (size_t)kBatch * kMaxWeave;
  const size_t sizes[7] = {
      sizeof(float2) * kChunk, adjoint ? sizeof(float2) * kChunk : 0,
      sizeof(Entry) * n_ent,   sizeof(float4) * 4 * n_ent,
      sizeof(float) * 2 * kWarps, sizeof(int) * kMaxQubits,
      sizeof(int) * kMaxQubits};
  size_t b = 0;
  for (int k = 0; k < 7; ++k) {
    if (off) off[k] = b;
    b += align16(sizes[k]);
  }
  return b;
}

__device__ __forceinline__ Sh carve(unsigned char* base, bool adjoint) {
  size_t off[7];
  smem_layout(adjoint, off);
  Sh sh;
  sh.psi = reinterpret_cast<float2*>(base + off[0]);
  sh.lam = reinterpret_cast<float2*>(base + off[1]);
  sh.ent = reinterpret_cast<Entry*>(base + off[2]);
  sh.coef = reinterpret_cast<float4*>(base + off[3]);
  sh.red = reinterpret_cast<float*>(base + off[4]);
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
__host__ __device__ __forceinline__ int max_segments(int G, int n) {
  const int room = kChunkBits - kLaneQubits;
  if (n <= kChunkBits || G < 1) return 1;
  return (G - 1) / (room / 2) + 1;         // room / 2 = ceil((room - 1) / 2)
}

// -- the segments ------------------------------------------------------------

// The segments of env e's (E, G) noiseless tape into out (segments::
// build, the rule of fused_adam_v2_sweep.cu; twin: ops/fused_adam2d.py:
// sweep_segments), one thread an env.
__global__ void apply_tape_sweep_schedule_kernel(const int* kind,
                                                 const int* tq, const int* cq,
                                                 int E, int G, int n,
                                                 int* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < E)
    segments::build<kChunkBits>(kind, tq, cq, e, G, n,
                                out + (size_t)e * segments::words(G));
}

// The local and chunk-index qubits of a segment's mask, by thread 0.
__device__ __forceinline__ void split_mask(const Sh& sh, unsigned mask,
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

// The entries of live gates live[lo .. lo + nb) of row `row` (env e) of a
// segment with local-qubit mask `mask`: thread j < nb writes the weave
// entries of live gate lo + j at j weave + v.  Ends on a CTA barrier.
__device__ void load_entries(const Sh& sh, const Args& a, const int* live,
                             int lo, int nb, int row, int e, unsigned mask) {
  const int tid = threadIdx.x, GW = a.weave * a.G;
  if (tid < nb) {
    const int g = __ldg(live + lo + tid);
    for (int v = 0; v < a.weave; ++v) {
      const int idx = tid * a.weave + v;
      const size_t at = (size_t)e * GW + (size_t)a.weave * g + v;
      const int kind = __ldg(a.kind + at);
      Entry en = {kind, 0, -1, 0, 0, 1.f, 1.f, 0};
      if (kind != kNone) {
        const int t = __ldg(a.tq + at), c = __ldg(a.cq + at);
        const int sl = __ldg(a.slot + at);
        // every qubit of a segment's gate, its woven errors' included, is
        // local by the segment rule
        if (!((mask >> t) & 1) || (c >= 0 && !((mask >> c) & 1))) __trap();
        float s = 0.f, co = 1.f;
        if (sl >= 0) sincosf(0.5f * __ldg(a.angles + (size_t)row * a.R + sl),
                             &s, &co);
        en.tl = segments::local_bit(mask, t);
        en.cl = c >= 0 ? segments::local_bit(mask, c) : -1;
        Coef m0, m1;
        int gen = kGenNone;
        if (kind >= kRXX) {
          // exp(-i theta/2 P): RXX [[c, -is], [-is, c]] on (l0, l0 ^ t ^ c);
          // RYY [[c, is z], [is z, c]], z = (-1)^(bit c of l0); RZZ diag(c -
          // is z, c + is z) on (l0, l0 | t)
          if (kind == kRXX) {
            m0 = m1 = {co, 0.f, 0.f, -s, 0.f, -s, co, 0.f};
            gen = kGenX;
          } else if (kind == kRYY) {
            m0 = {co, 0.f, 0.f, s, 0.f, s, co, 0.f};
            m1 = {co, 0.f, 0.f, -s, 0.f, -s, co, 0.f};
            gen = kGenX;
            en.sg0 = -1.f;
          } else {
            m0 = {co, -s, 0.f, 0.f, 0.f, 0.f, co, s};
            m1 = {co, s, 0.f, 0.f, 0.f, 0.f, co, -s};
            gen = kGenZ;
            en.sg1 = -1.f;
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
        float4* cf = sh.coef + 4 * idx;
        cf[0] = make_float4(m0.u00r, m0.u00i, m0.u01r, m0.u01i);
        cf[1] = make_float4(m0.u10r, m0.u10i, m0.u11r, m0.u11i);
        cf[2] = make_float4(m1.u00r, m1.u00i, m1.u01r, m1.u01i);
        cf[3] = make_float4(m1.u10r, m1.u10i, m1.u11r, m1.u11i);
      }
      sh.ent[idx] = en;
    }
  }
  __syncthreads();
}

// Pair q of an entry: (l0, l1) and the bit c of l0 (0 without one);
// false where a control skips the pair.
__device__ __forceinline__ bool entry_pair(const Entry& en, int q, int& l0,
                                           int& l1, int& b) {
  l0 = pair_low(q, en.tl);
  b = en.cl >= 0 ? (l0 >> en.cl) & 1 : 0;
  if ((en.flags & kCtrl) && !b) return false;
  l1 = l0 | (1 << en.tl);
  if (en.flags & kFlip2) l1 ^= 1 << en.cl;
  return true;
}

__device__ __forceinline__ Coef entry_coef(const Sh& sh, int idx, int b) {
  const float4 r0 = sh.coef[4 * idx + 2 * b];
  const float4 r1 = sh.coef[4 * idx + 2 * b + 1];
  return {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
}

// psi <- U psi for entry idx.  Ends on a barrier.
__device__ __forceinline__ void chunk_gate(const Sh& sh, int idx) {
  const Entry en = sh.ent[idx];
  for (int q = threadIdx.x; q < kChunk / 2; q += blockDim.x) {
    int l0, l1, b;
    if (!entry_pair(en, q, l0, l1, b)) continue;
    const Coef u = entry_coef(sh, idx, b);
    const float2 a0 = sh.psi[l0], a1 = sh.psi[l1];
    float r, i;
    cmul2(u.u00r, u.u00i, a0.x, a0.y, u.u01r, u.u01i, a1.x, a1.y, r, i);
    sh.psi[l0] = make_float2(r, i);
    cmul2(u.u10r, u.u10i, a0.x, a0.y, u.u11r, u.u11i, a1.x, a1.y, r, i);
    sh.psi[l1] = make_float2(r, i);
  }
  __syncthreads();
}

// The adjoint step of entry idx: psi <- U^H psi, lambda <- U^T lambda, and,
// for an angle gate, the chunk's part of its gradient row, 1/2 Im[(P
// psi)^T lambda] over its pairs with the post-gate psi, summed in a fixed
// order into gpart_row[g * chunks + chunk].  Ends on a barrier; `parity`
// alternates the partials' buffer.
__device__ __forceinline__ void chunk_gate_adj(const Sh& sh, int idx,
                                               float* gpart_row, int chunks,
                                               int chunk, int& parity) {
  const Entry en = sh.ent[idx];
  const int gen = en.flags >> kGenShift;
  float gp = 0.f;
  for (int q = threadIdx.x; q < kChunk / 2; q += blockDim.x) {
    int l0, l1, b;
    if (!entry_pair(en, q, l0, l1, b)) continue;
    const Coef u = entry_coef(sh, idx, b);
    const float2 a0 = sh.psi[l0], a1 = sh.psi[l1];
    const float2 m0 = sh.lam[l0], m1 = sh.lam[l1];
    if (en.grad) {
      // P on the pair: X (a1, a0), Y (-i a1, i a0), Z (a0, -a1), times the
      // sign of RYY's / RZZ's ZZ eigenvalue
      float q0r, q0i, q1r, q1i;
      if (gen == kGenX) {
        q0r = a1.x; q0i = a1.y; q1r = a0.x; q1i = a0.y;
      } else if (gen == kGenY) {
        q0r = a1.y; q0i = -a1.x; q1r = -a0.y; q1i = a0.x;
      } else {
        q0r = a0.x; q0i = a0.y; q1r = -a1.x; q1i = -a1.y;
      }
      const float sg = b ? en.sg1 : en.sg0;
      gp += 0.5f * sg * (q0r * m0.y + q0i * m0.x + q1r * m1.y + q1i * m1.x);
    }
    float r, i;
    cmul2(u.u00r, -u.u00i, a0.x, a0.y, u.u10r, -u.u10i, a1.x, a1.y, r, i);
    sh.psi[l0] = make_float2(r, i);
    cmul2(u.u01r, -u.u01i, a0.x, a0.y, u.u11r, -u.u11i, a1.x, a1.y, r, i);
    sh.psi[l1] = make_float2(r, i);
    cmul2(u.u00r, u.u00i, m0.x, m0.y, u.u10r, u.u10i, m1.x, m1.y, r, i);
    sh.lam[l0] = make_float2(r, i);
    cmul2(u.u01r, u.u01i, m0.x, m0.y, u.u11r, u.u11i, m1.x, m1.y, r, i);
    sh.lam[l1] = make_float2(r, i);
  }
  float* red = sh.red + parity * kWarps;
  if (en.grad) {                          // block-uniform
    for (int off = 16; off > 0; off >>= 1)
      gp += __shfl_xor_sync(0xffffffffu, gp, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = gp;
  }
  __syncthreads();
  if (en.grad) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      gpart_row[(size_t)(en.grad - 1) * chunks + chunk] = s;
    }
    parity ^= 1;
  }
}

// The CTA's segment: its row, chunk, env and schedule words; false (for
// the whole CTA) when the row's tape has no segment `seg`.
struct Where {
  int row, chunk, e, b0, b1;
  unsigned mask;
  const int* live;
};

__device__ __forceinline__ bool where_is(const Args& a, int seg, Where& at,
                                         int& nseg) {
  const int chunks = 1 << (a.n - kChunkBits);
  at.row = blockIdx.x / chunks;
  at.chunk = blockIdx.x % chunks;
  at.e = at.row / a.S;
  const int* w = a.sched + (size_t)(at.e % a.es) * segments::words(a.G);
  nseg = __ldg(w);
  if (seg >= nseg) return false;
  at.b0 = __ldg(w + 1 + seg);
  at.b1 = __ldg(w + 2 + seg);
  at.mask = (unsigned)__ldg(w + a.G + 2 + seg);
  at.live = w + 2 * a.G + 2;
  return true;
}

// Forward over segment `seg`: one chunk of one row a CTA, from psi0 (the
// first segment) or the output planes, through the segment's gates, back
// to the output planes.
__global__ void __launch_bounds__(kThreads)
apply_tape_sweep_fwd_kernel(Args a, int seg) {
  DYNAMIC_SHARED(apply_tape_sweep_smem);
  const Sh sh = carve(apply_tape_sweep_smem, false);
  Where at;
  int nseg;
  if (!where_is(a, seg, at, nseg)) return;  // block-uniform
  split_mask(sh, at.mask, a.n);
  __syncthreads();
  const size_t D = (size_t)1 << a.n;
  const size_t rb = (size_t)at.row * D;
  const int base = segments::chunk_base<kChunkBits>(sh.nq, at.chunk, a.n);
  const float* src_re = seg == 0 ? a.in_re : a.out_re;
  const float* src_im = seg == 0 ? a.in_im : a.out_im;
  for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
    const size_t i =
        rb + (base | segments::local_index<kChunkBits>(sh.lq, l));
    sh.psi[l] = make_float2(src_re[i], src_im[i]);
  }
  for (int lo = at.b0; lo < at.b1; lo += kBatch) {
    const int nb = min(kBatch, at.b1 - lo);
    __syncthreads();                      // the last batch's entries read
    load_entries(sh, a, at.live, lo, nb, at.row, at.e, at.mask);
    for (int idx = 0; idx < nb * a.weave; ++idx)
      if (sh.ent[idx].kind != kNone) chunk_gate(sh, idx);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
    const size_t i =
        rb + (base | segments::local_index<kChunkBits>(sh.lq, l));
    const float2 v = sh.psi[l];
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
__global__ void __launch_bounds__(kThreads)
apply_tape_sweep_bwd_kernel(Args a, int seg) {
  DYNAMIC_SHARED(apply_tape_sweep_smem);
  const Sh sh = carve(apply_tape_sweep_smem, true);
  Where at;
  int nseg;
  if (!where_is(a, seg, at, nseg)) return;  // block-uniform
  split_mask(sh, at.mask, a.n);
  __syncthreads();
  const int chunks = 1 << (a.n - kChunkBits);
  const size_t D = (size_t)1 << a.n;
  const size_t rb = (size_t)at.row * D;
  const int base = segments::chunk_base<kChunkBits>(sh.nq, at.chunk, a.n);
  const bool first = seg == nseg - 1;
  for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
    const size_t i =
        rb + (base | segments::local_index<kChunkBits>(sh.lq, l));
    if (first) {
      sh.psi[l] = make_float2(a.in_re[i], a.in_im[i]);
      sh.lam[l] = make_float2(a.g_re[i], -a.g_im[i]);
    } else {
      sh.psi[l] = make_float2(a.out_re[i], a.out_im[i]);
      sh.lam[l] = make_float2(a.l_re[i], a.l_im[i]);
    }
  }
  float* gpart_row = a.gpart + (size_t)at.row * a.G * chunks;
  int parity = 0;
  for (int hi = at.b1; hi > at.b0; hi -= kBatch) {
    const int lo = max(at.b0, hi - kBatch), nb = hi - lo;
    __syncthreads();                      // the last batch's entries read
    load_entries(sh, a, at.live, lo, nb, at.row, at.e, at.mask);
    for (int idx = nb * a.weave - 1; idx >= 0; --idx)
      if (sh.ent[idx].kind != kNone)
        chunk_gate_adj(sh, idx, gpart_row, chunks, at.chunk, parity);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
    const size_t i =
        rb + (base | segments::local_index<kChunkBits>(sh.lq, l));
    const float2 p = sh.psi[l], m = sh.lam[l];
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

// Each row's angle gradients, a CTA a row: every gradient gate's partials
// summed over the chunks in order (a warp a gate: lane l takes chunks l, l
// + 32, ..., then a fixed butterfly), then each angle's gates summed last
// first, as the plain version's scatter adds them.
__global__ void __launch_bounds__(kThreads)
apply_tape_sweep_bwd_grad_kernel(Args a, float* dang) {
  DYNAMIC_SHARED(apply_tape_sweep_smem);
  float* gsum = reinterpret_cast<float*>(apply_tape_sweep_smem);
  int* gslot = reinterpret_cast<int*>(apply_tape_sweep_smem +
                                      align16(sizeof(float) * a.G));
  const int row = blockIdx.x, e = row / a.S;
  const int chunks = 1 << (a.n - kChunkBits);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t GW = (size_t)a.weave * a.G;
  for (int g = tid; g < a.G; g += blockDim.x) {
    const size_t at = (size_t)e * GW + (size_t)a.weave * g;
    const int k = __ldg(a.kind + at), sl = __ldg(a.slot + at);
    const bool grad = sl >= 0 && ((k >= kRX && k <= kRZ) || k >= kRXX);
    gslot[g] = grad ? sl : -1;
  }
  __syncthreads();
  const float* gp = a.gpart + (size_t)row * a.G * chunks;
  for (int g = warp; g < a.G; g += kWarps) {
    if (gslot[g] < 0) continue;           // warp-uniform
    float s = 0.f;
    for (int c = lane; c < chunks; c += 32) s += gp[(size_t)g * chunks + c];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) gsum[g] = s;
  }
  __syncthreads();
  for (int r = tid; r < a.R; r += blockDim.x) {
    float dx = 0.f;
    for (int g = a.G - 1; g >= 0; --g)
      if (gslot[g] == r) dx += gsum[g];
    dang[(size_t)row * a.R + r] = dx;
  }
}

size_t smem_bytes(bool adjoint) { return smem_layout(adjoint, nullptr); }

size_t grad_smem_bytes(int G) {
  return align16(sizeof(float) * G) + align16(sizeof(int) * G);
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int E, int S, int G, int R, int n, const int* sched, int es,
               int weave) {
  return E < 1 || S < 1 || G < 1 || R < 1 || n < kMinQubits ||
         n > kMaxQubits || sched == nullptr || es < 1 || E % es != 0 ||
         (weave != 1 && weave != kMaxWeave);
}

}  // namespace

extern "C" {

// The qubit counts these kernels take, and their chunk's qubits.
int apply_tape_sweep_min_qubits() { return kMinQubits; }
int apply_tape_sweep_max_qubits() { return kMaxQubits; }
int apply_tape_sweep_chunk_bits() { return kChunkBits; }

// Launches of one forward (or one adjoint, before its gradient launch) on
// tapes of G gates at n qubits.
int apply_tape_sweep_max_segments(int G, int n) {
  return max_segments(G, n);
}

// Shared-memory bytes of one CTA of the forward (adjoint 0) or adjoint
// (1) segment kernel; of the gradient kernel at G gates.
size_t apply_tape_sweep_smem_bytes(int adjoint) {
  return smem_bytes(adjoint != 0);
}

size_t apply_tape_sweep_grad_smem_bytes(int G) { return grad_smem_bytes(G); }

// How many CTAs of the forward (adjoint 0) or adjoint (1) segment kernel an
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its
// shared memory); 0 when none fits, or minus a CUDA error code.
int apply_tape_sweep_ctas_per_sm(int adjoint) {
  const void* kernel =
      adjoint ? (const void*)apply_tape_sweep_bwd_kernel
              : (const void*)apply_tape_sweep_fwd_kernel;
  const size_t bytes = smem_bytes(adjoint != 0);
  int per_sm = 0;
  cudaError_t err = (cudaError_t)set_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = adjoint ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, apply_tape_sweep_bwd_kernel, kThreads, bytes)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, apply_tape_sweep_fwd_kernel, kThreads, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();                   // not sticky for the next launch
    return -(int)err;
  }
  return per_sm;
}

const char* apply_tape_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The segments of (E, G) noiseless tapes at n qubits into out (E x (3 G +
// 2) int32), one thread an env.
int apply_tape_sweep_schedule_launch(const int* kind, const int* tq,
                                     const int* cq, int* out, int E, int G,
                                     int n, void* stream) {
  if (E < 1 || G < 1 || n < kMinQubits || n > kMaxQubits || out == nullptr)
    return (int)cudaErrorInvalidValue;
  KERNEL_LAUNCH(apply_tape_sweep_schedule_kernel, (E + 31) / 32, 32, 0,
                static_cast<cudaStream_t>(stream), kind, tq, cq, E, G, n,
                out);
  return (int)cudaGetLastError();
}

// Forward: re / im / ore / oim (E, S, D) f32, tapes (E, weave x G) int32
// (weave 3: every gate followed by its error Paulis), angles (E, S, R)
// f32, sched (es rows of the noiseless tapes' segments; env e reads row e
// % es).  max_segments(G, n) launches on `stream`; returns the first
// launch's error (cudaGetLastError), 0 on success.
int apply_tape_sweep_fwd_launch(const int* kind, const int* tq, const int* cq,
                                const int* slot, const float* angles,
                                const float* re, const float* im, float* ore,
                                float* oim, const int* sched, int es,
                                int weave, int E, int S, int G, int R, int n,
                                void* stream) {
  if (bad_shape(E, S, G, R, n, sched, es, weave))
    return (int)cudaErrorInvalidValue;
  const Args a = {kind, tq, cq, slot, angles, re, im, ore, oim, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  sched, es, weave, E, S, G, R, n};
  const size_t bytes = smem_bytes(false);
  int err = set_smem((const void*)apply_tape_sweep_fwd_kernel, bytes);
  if (err != 0) return err;
  const int grid = E * S * (1 << (n - kChunkBits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int seg = 0; seg < max_segments(G, n); ++seg) {
    KERNEL_LAUNCH(apply_tape_sweep_fwd_kernel, grid, kThreads, bytes, st, a,
                  seg);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// Adjoint: from the forward output (ore, oim) and the cotangents (gre,
// gim), all (E, S, D) f32, into dre / dim (E, S, D; both may be null: the
// psi0 cotangents are then not written) and dang (E, S, R); the tapes,
// sched, es and weave as the forward's.  Scratch from the caller: pre /
// pim / lre / lim (E, S, D) f32 each, gpart (E S x G x 2^(n - chunk bits))
// f32.  max_segments(G, n) segment launches, last segment first, then the
// gradient launch.
int apply_tape_sweep_bwd_launch(
    const int* kind, const int* tq, const int* cq, const int* slot,
    const float* angles, const float* ore, const float* oim, const float* gre,
    const float* gim, float* dre, float* dim, float* dang, const int* sched,
    int es, int weave, float* pre, float* pim, float* lre, float* lim,
    float* gpart, int E, int S, int G, int R, int n, void* stream) {
  if (bad_shape(E, S, G, R, n, sched, es, weave) ||
      (dre == nullptr) != (dim == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = {kind, tq, cq, slot, angles, ore, oim, pre, pim, gre, gim,
                  lre, lim, dre, dim, gpart, sched, es, weave, E, S, G, R,
                  n};
  const size_t bytes = smem_bytes(true);
  int err = set_smem((const void*)apply_tape_sweep_bwd_kernel, bytes);
  if (err != 0) return err;
  const size_t gbytes = grad_smem_bytes(G);
  err = set_smem((const void*)apply_tape_sweep_bwd_grad_kernel, gbytes);
  if (err != 0) return err;
  const int grid = E * S * (1 << (n - kChunkBits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int seg = max_segments(G, n) - 1; seg >= 0; --seg) {
    KERNEL_LAUNCH(apply_tape_sweep_bwd_kernel, grid, kThreads, bytes, st, a,
                  seg);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  KERNEL_LAUNCH(apply_tape_sweep_bwd_grad_kernel, E * S, kThreads, gbytes,
                st, a, dang);
  return (int)cudaGetLastError();
}

}  // extern "C"
