// Fused multi-start Adam env step with a flip-grouped Pauli H for 19-20
// qubits (CUDA, sm_90a): the sweep kernel, one cooperative launch per env
// step.
//
// Replaces the TPU kernel tensorrl_qas_tpu/ops/pallas_opt2d.py:_make_kernel
// (call :854) at the sizes where the JAX package runs the same function
// through XLA with a host-stepped Adam (tensorrl_qas_tpu/optim/
// angle_opt.py:500-560, _host_stepped / _fused_step_hostloop), with its
// noise variant (a non-null `seeds`) and its per-env psi0 variant
// (psi0_stride = D).  It computes what fused_adam_v2.cu computes below 19
// qubits: per start, Adam over the old tape for `iters` iterations, the
// best iterate, the re-check, the argmin over starts, the remap onto the
// new tape and e_new.  The plain PyTorch version of the same function is
// tensorrl_qas_tpu_torch/ops/fused_adam2d.py:fused_adam_step2d_reference.
//
// Why another design.  fused_adam_v2.cu holds a start on chip: psi and
// lambda in the registers of 2^(n - 12) CTAs that wait on each other.  An
// SM holds one such CTA (255 registers x 256 threads), so at 20 qubits a
// start (256 CTAs) cannot be resident on the H100's 132 SMs, and a barrier
// over it would wait on CTAs that never run.  Here every start's psi and
// lambda live in device memory (8 MB each at 20 qubits), and the card
// sweeps them pass by pass:
//
//   - A persistent grid of as many CTAs as the card holds at once,
//     launched with cudaLaunchCooperativeKernel, which refuses a grid that
//     cannot be co-resident: a grid barrier (grid_sync) waits only on CTAs
//     that run.  The passes are separated by grid barriers, and every CTA
//     runs the same sequence of passes.
//   - The tape is cut into segments (build_segments; twin: ops/
//     fused_adam2d.py:sweep_segments): runs of consecutive gates whose
//     qubits, with qubits 0..4, number at most kChunkBits.  A segment's
//     local qubits are those and the lowest others up to kChunkBits; a
//     pass over a segment takes the state in chunks of 2^kChunkBits
//     amplitudes that differ only in the local qubits (the chunk's index
//     gives the others), each chunk into a CTA's shared memory, where
//     every gate of the segment, and its drawn errors, is applied with one
//     CTA barrier a gate; then the chunk goes back.  Qubits 0..4 are local
//     in every segment, so a warp's 32 lanes read 32 consecutive
//     amplitudes.
//   - Forward passes run the segments in order (the first reads psi0),
//     backward passes in reverse on psi and lambda, with each angle
//     gate's gradient row summed in the chunk (a fixed-order block
//     reduction) into a per-chunk partial in device memory.
//   - H psi: one pass over contiguous chunks, lambda = 2 conj(H psi) for
//     each amplitude from the W planes (read coalesced, once for every 2
//     starts: at 20 qubits W is 84 MB, more than L2 holds) and psi[i ^ f]
//     of those starts (from L2: the pass walks 2 starts' 16 MB at a
//     time), and each chunk's energy partials in double.
//   - An Adam pass, one CTA a start: the energy and each angle's gradient
//     summed over the chunks in order, best-iterate tracking, the Adam
//     update; then the next iteration's first forward pass.
//   - The tail: per env the first start of least energy, x_opt, the remap
//     onto the new tape, a forward pass of the new tape and an energy.
// All starts of the launch go through the passes together (each pass
// walks start by start, chunk by chunk, every other pass backwards so
// that it starts on what the last one wrote last).  A launch holds every
// start's psi and lambda in scratch: 512 MB at 20 qubits, E = 8, S = 4.
// Every sum is taken in a fixed order, so a repeated launch gives the same
// bits.  All amplitude arithmetic is f32 FMA: no TF32 or bf16, whose
// rounding exceeds the 1.6e-3 Ha acceptance threshold.
//
// Bound.  Operations: per start and Adam iteration H psi is G_f D complex
// multiply-adds (4 flops for a real group) and each gate a 2x2 update over
// D/2 pairs forward and backward; at 20 qubits, E = 8, S = 4, 100
// iterations on mid-episode tapes of the 20q config (G = 46) 1.3 TFLOP,
// 20 ms at the card's 67 TFLOP/s f32 rate.  Bytes the function must move:
// its inputs once, 176 MB (mostly the W planes).  What the design moves:
// per start and iteration each forward segment reads and writes psi (16
// MB), each backward segment psi and lambda (32 MB), H psi reads psi, its
// partners and W and writes lambda -- hundreds of MB, so device memory
// and L2 traffic, and the shared-memory passes over each chunk a gate,
// bound this kernel, not operations; chip_smoke.py prints the bound.
//
// Noise.  With seeds every chunk draws its segment's errors itself
// (philox.cuh: key = seeds[e], counter = (gate, tag)), tag `it` for Adam
// iteration it, `iters` for the re-check, `iters + 1` for e_new: the draw
// of fused_adam_v2.cu and of the plain version, shared by an env's starts.
// A fired error is a Pauli after its gate on the gate's target (and, after
// CX, its control), both local in the gate's segment; the backward pass
// undoes it on psi and applies its transpose to lambda before the gate's
// own adjoint step.  A runtime flag, so that at p = 0 the launch is the
// noiseless one bit for bit.
//
// Per-env psi0.  psi0_stride is 0 for one psi0 plane shared by the envs
// and D for (E, D) planes; the first forward pass of env e reads row e.

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "philox.cuh"

// The launch and the dynamic shared memory go through these macros, so
// that tests/cuda_emu/cuda_runtime.h, which defines them, can run this
// source on the host.  Each pass carves its pointers into the dynamic
// shared memory itself (``sweep_shared``): kept in registers across the
// whole kernel, they took more than a third of what three CTAs an SM
// allow.
#ifndef SHARED_BASE
extern __shared__ __align__(16) unsigned char fused_adam_sweep_smem[];
#define SHARED_BASE() fused_adam_sweep_smem
#endif
#ifndef COOPERATIVE_LAUNCH
#define COOPERATIVE_LAUNCH(kernel, grid, block, bytes, stream, param)      \
  cudaLaunchCooperativeKernel((const void*)(kernel), dim3(grid),           \
                              dim3(block), (void**)(param), (bytes),       \
                              (stream))
#endif

// The chunk: 2^kChunkBits amplitudes a CTA takes at once (psi and lambda:
// 64 KB of shared memory at 12).  The host tests compile the source with
// smaller chunks and a lower qubit band, so that small states cross many
// segments.
#ifndef FUSED_ADAM_SWEEP_CHUNK_BITS
#define FUSED_ADAM_SWEEP_CHUNK_BITS 12
#endif
#ifndef FUSED_ADAM_SWEEP_MIN_QUBITS
#define FUSED_ADAM_SWEEP_MIN_QUBITS 19
#endif

namespace {

using namespace gates;

constexpr int kChunkBits = FUSED_ADAM_SWEEP_CHUNK_BITS;
constexpr int kChunk = 1 << kChunkBits;
constexpr int kLaneQubits = 5;          // local in every segment
constexpr int kMinQubits = FUSED_ADAM_SWEEP_MIN_QUBITS;
constexpr int kMaxQubits = 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHRows = 2;               // rows an item of the H psi pass
constexpr int kHAmps = 2;               // amplitudes a thread takes at once
// Three CTAs an SM (the shared memory allows three at the 20q configs'
// tapes): at most 85 registers a thread, 79 with no spills; on an H100
// 23% faster at 20 qubits, E = 8, S = 4 than two an SM at 128 registers,
// where the H psi pass held 4 rows x 4 amplitudes of accumulators
// (chip_smoke.py --sweep-shapes times these shapes in turns).
constexpr int kMinBlocks = 3;
static_assert(kChunkBits >= kLaneQubits + 2 && kMinQubits >= kChunkBits,
              "a chunk holds qubits 0..4 and a gate's two qubits");

// Spins a grid barrier waits at most (x 64 ns and more) before it traps:
// the cooperative launch puts every CTA on the card at once, so a wait
// this long is a fault, which fails the launch.
constexpr unsigned int kSpinLimit = 1u << 26;

// Schedule words of one tape of one env (build_segments): [0] the
// segments, [1 .. G + 1] each segment's first index into the live-gate
// list and the end, [G + 2 .. 2 G + 1] each segment's local-qubit mask,
// [2 G + 2 .. 3 G + 1] the live gates in tape order; -1 where unused.
__host__ __device__ __forceinline__ int schedule_words(int G) {
  return 3 * G + 2;
}

struct SweepParams {
  Tape old_g, new_g;
  const int* map_idx;
  const float* p0re;
  const float* p0im;
  const float* wre;
  const float* wim;
  const int* flips;
  const int* wim_any;
  const float* starts;
  const float* active;
  const int* seeds;
  float* x_opt;
  float* e_new;
  // scratch (the wrapper allocates it; no input is written)
  float2* psi;            // E S x D: each start's psi ...
  float2* lam;            // ... and lambda
  float* adam;            // E S x 4 R: iterate, m, v, best iterate
  float* best_e;          // E S
  float* gpart;           // E S x G x chunks: gradient-row partials
  double* epart;          // E S x chunks x 2: energy partials
  int* sched;             // 2 x E x schedule_words(G): old, new tape
  float* xnew;            // E x R: x_opt remapped onto the new tape
  unsigned int* bar;      // the grid barrier's counter (zero)
  int E, S, G, R, n, n_groups, psi0_stride, iters;
  float lr;
  double b1, b2;
  float omb1, omb2, eps;
  unsigned thr1, thr2;
};

// A segment's gate as one pass applies it: kind, target and control as
// local bits (-1: none), whether it has an angle gradient (its tape index
// + 1, else 0).
struct SegGate {
  int kind, tl, cl, grad;
};

struct Sh {
  float2* psi;     // kChunk: the chunk of psi ...
  float2* lam;     // ... and of lambda
  float4* coef;    // 2 G: each segment gate's 2x2 entries
  SegGate* gate;   // G
  int2* err;       // G: error kinds on the target and the control
  float* gsum;     // G: the Adam pass's gradient rows
  float* redf;     // 2 kWarps: gradient-row partials, double-buffered
  double* redd;    // 2 kWarps kHRows: energy partials
  int* flips;      // n_groups
  int* wim_any;    // n_groups
  int* lq;         // kMaxQubits: the local qubit of each local bit
  int* nq;         // kMaxQubits: the qubit of each chunk-index bit
  int* misc;       // 8: [0] gates in the segment, [1] flag, [2] best start,
                   //    [3] max old segments, [4] max new segments
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t smem_layout(int G, int n_groups,
                                                       size_t* off) {
  size_t b = 0;
  const size_t sizes[13] = {
      sizeof(float2) * kChunk, sizeof(float2) * kChunk,
      sizeof(float4) * 2 * (size_t)G, sizeof(SegGate) * (size_t)G,
      sizeof(int2) * (size_t)G, sizeof(float) * (size_t)G,
      sizeof(float) * 2 * kWarps, sizeof(double) * 2 * kWarps * kHRows,
      sizeof(int) * (size_t)n_groups, sizeof(int) * (size_t)n_groups,
      sizeof(int) * kMaxQubits, sizeof(int) * kMaxQubits, sizeof(int) * 8};
  for (int k = 0; k < 13; ++k) {
    if (off) off[k] = b;
    b += align16(sizes[k]);
  }
  return b;
}

__device__ __forceinline__ Sh carve(unsigned char* base, int G,
                                    int n_groups) {
  size_t off[13];
  smem_layout(G, n_groups, off);
  Sh sh;
  sh.psi = reinterpret_cast<float2*>(base + off[0]);
  sh.lam = reinterpret_cast<float2*>(base + off[1]);
  sh.coef = reinterpret_cast<float4*>(base + off[2]);
  sh.gate = reinterpret_cast<SegGate*>(base + off[3]);
  sh.err = reinterpret_cast<int2*>(base + off[4]);
  sh.gsum = reinterpret_cast<float*>(base + off[5]);
  sh.redf = reinterpret_cast<float*>(base + off[6]);
  sh.redd = reinterpret_cast<double*>(base + off[7]);
  sh.flips = reinterpret_cast<int*>(base + off[8]);
  sh.wim_any = reinterpret_cast<int*>(base + off[9]);
  sh.lq = reinterpret_cast<int*>(base + off[10]);
  sh.nq = reinterpret_cast<int*>(base + off[11]);
  sh.misc = reinterpret_cast<int*>(base + off[12]);
  return sh;
}

// The dynamic shared memory's layout, for a pass to take at its start.
__device__ __forceinline__ Sh sweep_shared(const SweepParams& p) {
  return carve(SHARED_BASE(), p.G, p.n_groups);
}

// -- the grid barrier --------------------------------------------------------

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

// Every CTA arrives on the counter (release) and waits until all have
// (acquire), after which its loads see what the others stored before
// arriving; the counter only grows (barrier k ends at k x gridDim.x).
// Data written inside the launch is read with __ldcg (L2), never __ldg.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int& passed) {
  __syncthreads();
  ++passed;
  if (threadIdx.x == 0) {
    const unsigned int target = passed * gridDim.x;
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned int spins = 0;
    while (ld_acquire(bar) < target) {
      if (++spins == kSpinLimit) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// -- the segments ------------------------------------------------------------

// The lowest qubits not in `m` added until it holds kChunkBits.
__host__ __device__ __forceinline__ unsigned fill_local(unsigned m, int n) {
  int count = 0;
  for (int q = 0; q < n; ++q) count += (m >> q) & 1;
  for (int q = kLaneQubits; q < n && count < kChunkBits; ++q)
    if (!((m >> q) & 1)) {
      m |= 1u << q;
      ++count;
    }
  return m;
}

// Env e's segments of `tape` into `w` (schedule_words(G) ints), by one
// thread: each live gate joins the current segment unless its qubits above
// qubit 4 would make the segment's more than kChunkBits - 5; then a new
// segment starts.  A tape with no live gate has one empty segment (its
// pass copies psi0).  Twin: ops/fused_adam2d.py:sweep_segments.
__device__ void build_segments(const Tape& tape, int e, int G, int n,
                               int* w) {
  for (int k = 0; k < schedule_words(G); ++k) w[k] = -1;
  int* begin = w + 1;
  int* mask = w + G + 2;
  int* live = w + 2 * G + 2;
  const unsigned low = (1u << kLaneQubits) - 1u;
  const int room = kChunkBits - kLaneQubits;
  int nl = 0, nseg = 0;
  unsigned cur = 0;
  begin[0] = 0;
  for (int g = 0; g < G; ++g) {
    const size_t at = (size_t)e * G + g;
    if (__ldg(tape.kind + at) == kNone) continue;
    const int t = __ldg(tape.tq + at), c = __ldg(tape.cq + at);
    unsigned q = 1u << t;
    if (c >= 0) q |= 1u << c;
    q &= ~low;
    if (nl > begin[nseg] && __popc(cur | q) > room) {
      mask[nseg] = (int)fill_local(low | cur, n);
      begin[++nseg] = nl;
      cur = 0;
    }
    cur |= q;
    live[nl++] = g;
  }
  mask[nseg] = (int)fill_local(low | cur, n);
  begin[++nseg] = nl;
  w[0] = nseg;
}

// Local bit of qubit q in a segment's mask.
__device__ __forceinline__ int local_bit(unsigned mask, int q) {
  return __popc(mask & ((1u << q) - 1u));
}

// Segment k of `w` set up for a pass over env e's chunks at the iterate x
// (R floats, written inside the launch): each gate's local bits, 2x2
// entries and, with noise, its error kinds at `tag`; the local and chunk
// qubits.  Ends on a CTA barrier.
__device__ void load_segment(const Sh& sh, const SweepParams& p,
                             const Tape& tape, const int* w, int k, int e,
                             const float* x, int tag, bool noise) {
  const int G = p.G, tid = threadIdx.x;
  const int b0 = __ldcg(w + 1 + k), b1 = __ldcg(w + 2 + k);
  const unsigned mask = (unsigned)__ldcg(w + G + 2 + k);
  const int* live = w + 2 * G + 2;
  if (tid == 0) {
    int a = 0, b = 0;
    for (int q = 0; q < p.n; ++q) {
      if ((mask >> q) & 1)
        sh.lq[a++] = q;
      else
        sh.nq[b++] = q;
    }
    sh.misc[0] = b1 - b0;
  }
  const unsigned k0 = noise ? (unsigned)__ldg(p.seeds + 2 * e) : 0u;
  const unsigned k1 = noise ? (unsigned)__ldg(p.seeds + 2 * e + 1) : 0u;
#pragma unroll 1
  for (int j = tid; j < b1 - b0; j += blockDim.x) {
    const int g = __ldcg(live + b0 + j);
    const size_t at = (size_t)e * G + g;
    const int kind = __ldg(tape.kind + at), t = __ldg(tape.tq + at);
    const int c = __ldg(tape.cq + at), sl = __ldg(tape.slot + at);
    float s = 0.f, co = 1.f;
    if (sl >= 0) sincosf(0.5f * __ldcg(x + sl), &s, &co);
    const Coef u = gate_coef(kind, co, s);
    sh.coef[2 * j] = make_float4(u.u00r, u.u00i, u.u01r, u.u01i);
    sh.coef[2 * j + 1] = make_float4(u.u10r, u.u10i, u.u11r, u.u11i);
    const bool grad = sl >= 0 && (kind == kRX || kind == kRY || kind == kRZ);
    sh.gate[j] = {kind, local_bit(mask, t), c >= 0 ? local_bit(mask, c) : -1,
                  grad ? g + 1 : 0};
    int et = 0, ec = 0;
    if (noise)
      philox::error_kinds(kind, g, tag, k0, k1, p.thr1, p.thr2, et, ec);
    sh.err[j] = make_int2(et, ec);
  }
  __syncthreads();
}

// The global index of local amplitude l of chunk `chunk` in the current
// segment (local bit b -> qubit lq[b], chunk bit b -> qubit nq[b]).
__device__ __forceinline__ int chunk_base(const Sh& sh, int chunk, int n) {
  int i = 0;
  for (int b = 0; b < n - kChunkBits; ++b) i |= ((chunk >> b) & 1) << sh.nq[b];
  return i;
}

__device__ __forceinline__ int local_index(const Sh& sh, int l) {
  int i = l & ((1 << kLaneQubits) - 1);
#pragma unroll
  for (int b = kLaneQubits; b < kChunkBits; ++b)
    i |= ((l >> b) & 1) << sh.lq[b];
  return i;
}

__device__ __forceinline__ Coef seg_coef(const Sh& sh, int j) {
  const float4 a = sh.coef[2 * j], b = sh.coef[2 * j + 1];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// Pauli k on local bit b of the chunk: on psi, and with kAdjoint its
// transpose on lambda too (philox.cuh:pauli_pair).  Ends on a barrier.
template <bool kAdjoint>
__device__ __forceinline__ void chunk_pauli(const Sh& sh, int k, int b) {
  for (int q = threadIdx.x; q < kChunk / 2; q += blockDim.x) {
    const int l0 = pair_low(q, b), l1 = l0 | (1 << b);
    philox::pauli_pair<false>(k, sh.psi[l0].x, sh.psi[l0].y, sh.psi[l1].x,
                              sh.psi[l1].y);
    if (kAdjoint)
      philox::pauli_pair<true>(k, sh.lam[l0].x, sh.lam[l0].y, sh.lam[l1].x,
                               sh.lam[l1].y);
  }
  __syncthreads();
}

// psi <- U psi for gate j of the segment.  Ends on a barrier.
__device__ __forceinline__ void chunk_gate(const Sh& sh, int j) {
  const SegGate gt = sh.gate[j];
  const Coef u = seg_coef(sh, j);
  for (int q = threadIdx.x; q < kChunk / 2; q += blockDim.x) {
    const int l0 = pair_low(q, gt.tl), l1 = l0 | (1 << gt.tl);
    if (gt.cl >= 0 && !((l0 >> gt.cl) & 1)) continue;
    const float2 a0 = sh.psi[l0], a1 = sh.psi[l1];
    float r, i;
    cmul2(u.u00r, u.u00i, a0.x, a0.y, u.u01r, u.u01i, a1.x, a1.y, r, i);
    sh.psi[l0] = make_float2(r, i);
    cmul2(u.u10r, u.u10i, a0.x, a0.y, u.u11r, u.u11i, a1.x, a1.y, r, i);
    sh.psi[l1] = make_float2(r, i);
  }
  __syncthreads();
}

// The adjoint step of gate j: psi <- U^H psi, lambda <- U^T lambda, and,
// for an angle gate, the chunk's part of its gradient row, 1/2 Im[(P
// psi)^T lambda] over the pairs with the post-gate psi (P the rotation's
// generator), summed in a fixed order into gpart[row][g][chunk].  Ends on
// a barrier; `parity` alternates the partials' buffer.
__device__ __forceinline__ void chunk_gate_adj(const Sh& sh, int j,
                                               float* gpart_row, int chunks,
                                               int chunk, int& parity) {
  const SegGate gt = sh.gate[j];
  const Coef u = seg_coef(sh, j);
  float gp = 0.f;
  for (int q = threadIdx.x; q < kChunk / 2; q += blockDim.x) {
    const int l0 = pair_low(q, gt.tl), l1 = l0 | (1 << gt.tl);
    if (gt.cl >= 0 && !((l0 >> gt.cl) & 1)) continue;
    const float2 a0 = sh.psi[l0], a1 = sh.psi[l1];
    const float2 m0 = sh.lam[l0], m1 = sh.lam[l1];
    if (gt.grad) {
      float q0r, q0i, q1r, q1i;
      generator(gt.kind, a0.x, a0.y, a1.x, a1.y, q0r, q0i, q1r, q1i);
      gp += 0.5f * (q0r * m0.y + q0i * m0.x + q1r * m1.y + q1i * m1.x);
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
  float* red = sh.redf + parity * kWarps;
  if (gt.grad) {                          // block-uniform
    for (int off = 16; off > 0; off >>= 1)
      gp += __shfl_xor_sync(0xffffffffu, gp, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = gp;
  }
  __syncthreads();
  if (gt.grad) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      gpart_row[(size_t)(gt.grad - 1) * chunks + chunk] = s;
    }
    parity ^= 1;
  }
}

// -- the passes --------------------------------------------------------------

// The rows of a pass: `rows` starts (the new-tape passes: one a env, the
// buffers of the env's first start); row r's env and buffer index.
struct Rows {
  int count, S;
  bool per_env;
  __device__ int env(int r) const { return per_env ? r : r / S; }
  __device__ int buf(int r) const { return per_env ? r * S : r; }
};

// The item order of pass `pass`: every other pass backwards.
__device__ __forceinline__ int item_at(int k, int total, unsigned pass) {
  return (pass & 1) ? total - 1 - k : k;
}

// Forward pass over segment `seg` of `tape` (schedule `sched`, env words
// apart) for every row whose env has that segment: chunks from psi0 (the
// first segment) or psi, through the segment's gates, back to psi.
__device__ void forward_pass(const SweepParams& p,
                             const Tape& tape, const int* sched,
                             const Rows& rows, const float* xbase,
                             int xstride, int seg, int tag, bool noise,
                             unsigned pass) {
  const Sh sh = sweep_shared(p);
  const int chunks = 1 << (p.n - kChunkBits), D = 1 << p.n;
  const int words = schedule_words(p.G);
  const int total = rows.count * chunks;
  for (int k = blockIdx.x; k < total; k += gridDim.x) {
    const int item = item_at(k, total, pass);
    const int r = item / chunks, chunk = item % chunks;
    const int e = rows.env(r), buf = rows.buf(r);
    const int* w = sched + (size_t)e * words;
    if (seg >= __ldcg(w)) continue;       // block-uniform
    load_segment(sh, p, tape, w, seg, e, xbase + (size_t)r * xstride, tag,
                 noise);
    const int base = chunk_base(sh, chunk, p.n);
    float2* psi = p.psi + (size_t)buf * D;
    const float* p0r = p.p0re + (size_t)e * p.psi0_stride;
    const float* p0i = p.p0im + (size_t)e * p.psi0_stride;
    for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
      const int i = base | local_index(sh, l);
      sh.psi[l] = seg == 0 ? make_float2(__ldg(p0r + i), __ldg(p0i + i))
                           : __ldcg(psi + i);
    }
    __syncthreads();
    const int gates = sh.misc[0];
    for (int j = 0; j < gates; ++j) {
      chunk_gate(sh, j);
      const int2 er = sh.err[j];
      if (er.x) chunk_pauli<false>(sh, er.x, sh.gate[j].tl);
      if (er.y) chunk_pauli<false>(sh, er.y, sh.gate[j].cl);
    }
    for (int l = threadIdx.x; l < kChunk; l += blockDim.x)
      psi[base | local_index(sh, l)] = sh.psi[l];
    __syncthreads();
  }
}

// Backward pass over segment `seg` of the old tape: psi and lambda through
// the segment's gates in reverse (errors undone first), the gradient rows'
// chunk partials; the state goes back unless this is the first segment.
__device__ void backward_pass(const SweepParams& p,
                              const Rows& rows, int seg, int tag, bool noise,
                              unsigned pass) {
  const Sh sh = sweep_shared(p);
  const int chunks = 1 << (p.n - kChunkBits), D = 1 << p.n;
  const int words = schedule_words(p.G);
  const int total = rows.count * chunks;
  int parity = 0;
  for (int k = blockIdx.x; k < total; k += gridDim.x) {
    const int item = item_at(k, total, pass);
    const int r = item / chunks, chunk = item % chunks;
    const int e = rows.env(r);
    const int* w = p.sched + (size_t)e * words;
    if (seg >= __ldcg(w)) continue;       // block-uniform
    load_segment(sh, p, p.old_g, w, seg, e, p.adam + (size_t)r * 4 * p.R,
                 tag, noise);
    const int base = chunk_base(sh, chunk, p.n);
    float2* psi = p.psi + (size_t)r * D;
    float2* lam = p.lam + (size_t)r * D;
    for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
      const int i = base | local_index(sh, l);
      sh.psi[l] = __ldcg(psi + i);
      sh.lam[l] = __ldcg(lam + i);
    }
    __syncthreads();
    float* gpart_row = p.gpart + (size_t)r * p.G * chunks;
    for (int j = sh.misc[0] - 1; j >= 0; --j) {
      const int2 er = sh.err[j];
      if (er.x) chunk_pauli<true>(sh, er.x, sh.gate[j].tl);
      if (er.y) chunk_pauli<true>(sh, er.y, sh.gate[j].cl);
      chunk_gate_adj(sh, j, gpart_row, chunks, chunk, parity);
    }
    if (seg > 0)
      for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
        const int i = base | local_index(sh, l);
        psi[i] = sh.psi[l];
        lam[i] = sh.lam[l];
      }
    __syncthreads();
  }
}

// H psi over contiguous chunks, kHRows rows at a time: each amplitude's
// W_f[i] is read once for the rows of the item (W, 84 MB at 20 qubits,
// does not fit L2, and a pass over the rows one by one would read it for
// each), psi[i ^ f] of each row from L2 (the item order walks the rows'
// chunks group by group: 2 rows' psi, 16 MB at 20 qubits, in flight).  Per
// row the chunk's energy partials (Re<psi|H psi>, <psi|psi> in double, a
// fixed order that does not depend on the grouping) into epart and, with
// `lambda`, lambda = 2 conj(H psi).  A group whose imaginary plane is zero
// reads only its real one.
__device__ void h_pass(const SweepParams& p, const Rows& rows,
                       bool lambda, unsigned pass) {
  const Sh sh = sweep_shared(p);
  const int chunks = 1 << (p.n - kChunkBits), D = 1 << p.n;
  const int groups = (rows.count + kHRows - 1) / kHRows;
  const int total = groups * chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = blockIdx.x; k < total; k += gridDim.x) {
    const int item = item_at(k, total, pass);
    const int r0 = item / chunks * kHRows, chunk = item % chunks;
    const int nb = min(kHRows, rows.count - r0);
    const float2* psi[kHRows];
    float2* lam[kHRows];
    double raw[kHRows], nn[kHRows];
#pragma unroll
    for (int s = 0; s < kHRows; ++s) {
      const size_t buf = rows.buf(r0 + (s < nb ? s : 0));
      psi[s] = p.psi + buf * D;
      lam[s] = p.lam + buf * D;
      raw[s] = 0.0;
      nn[s] = 0.0;
    }
    // kHAmps amplitudes of a thread at once (l, l + T, ...): their loads
    // of a group are issued together
    for (int l0 = tid; l0 < kChunk; l0 += kHAmps * blockDim.x) {
      int at[kHAmps];
      float hr[kHRows][kHAmps], hi[kHRows][kHAmps];
#pragma unroll
      for (int a = 0; a < kHAmps; ++a) {
        const int l = l0 + a * (int)blockDim.x;
        at[a] = l < kChunk ? chunk * kChunk + l : -1;
#pragma unroll
        for (int s = 0; s < kHRows; ++s) hr[s][a] = hi[s][a] = 0.f;
      }
      for (int f = 0; f < p.n_groups; ++f) {
        const int fl = sh.flips[f];
        const bool cplx = sh.wim_any[f] != 0;
        float wr[kHAmps], wi[kHAmps];
#pragma unroll
        for (int a = 0; a < kHAmps; ++a) {
          wr[a] = at[a] >= 0 ? __ldg(p.wre + (size_t)f * D + at[a]) : 0.f;
          wi[a] = cplx && at[a] >= 0 ? __ldg(p.wim + (size_t)f * D + at[a])
                                     : 0.f;
        }
#pragma unroll
        for (int s = 0; s < kHRows; ++s) {
          if (s >= nb) break;
#pragma unroll
          for (int a = 0; a < kHAmps; ++a) {
            if (at[a] < 0) continue;
            const float2 q = __ldcg(psi[s] + (at[a] ^ fl));
            hr[s][a] = fmaf(wr[a], q.x, hr[s][a]);
            if (cplx) hr[s][a] = fmaf(-wi[a], q.y, hr[s][a]);
            hi[s][a] = fmaf(wr[a], q.y, hi[s][a]);
            if (cplx) hi[s][a] = fmaf(wi[a], q.x, hi[s][a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kHAmps; ++a) {
        if (at[a] < 0) continue;
#pragma unroll
        for (int s = 0; s < kHRows; ++s) {
          if (s >= nb) break;
          const float2 v = __ldcg(psi[s] + at[a]);
          raw[s] += (double)v.x * hr[s][a] + (double)v.y * hi[s][a];
          nn[s] += (double)v.x * v.x + (double)v.y * v.y;
          if (lambda)
            lam[s][at[a]] = make_float2(2.f * hr[s][a], -2.f * hi[s][a]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kHRows; ++s) {
      if (s >= nb) break;                 // block-uniform
      for (int off = 16; off > 0; off >>= 1) {
        raw[s] += __shfl_xor_sync(0xffffffffu, raw[s], off);
        nn[s] += __shfl_xor_sync(0xffffffffu, nn[s], off);
      }
      if (lane == 0) {
        sh.redd[(s * kWarps + warp) * 2] = raw[s];
        sh.redd[(s * kWarps + warp) * 2 + 1] = nn[s];
      }
    }
    __syncthreads();
    if (tid < nb) {                       // thread s: row r0 + s
      double a = 0.0, b = 0.0;
      for (int w = 0; w < kWarps; ++w) {
        a += sh.redd[(tid * kWarps + w) * 2];
        b += sh.redd[(tid * kWarps + w) * 2 + 1];
      }
      double* out =
          p.epart + ((size_t)rows.buf(r0 + tid) * chunks + chunk) * 2;
      out[0] = a;
      out[1] = b;
    }
    __syncthreads();
  }
}

// A row's energy: its chunks' partials summed in order by warp 0 (lane l
// takes chunks l, l + 32, ..., then a fixed butterfly); -> thread 0.
__device__ __forceinline__ float row_energy(const SweepParams& p, int buf) {
  const int chunks = 1 << (p.n - kChunkBits);
  double raw = 0.0, nn = 0.0;
  if (threadIdx.x < 32) {
    const double* ep = p.epart + (size_t)buf * chunks * 2;
    for (int c = threadIdx.x; c < chunks; c += 32) {
      raw += __ldcg(ep + 2 * c);
      nn += __ldcg(ep + 2 * c + 1);
    }
    for (int off = 16; off > 0; off >>= 1) {
      raw += __shfl_xor_sync(0xffffffffu, raw, off);
      nn += __shfl_xor_sync(0xffffffffu, nn, off);
    }
  }
  return (float)(raw / nn);
}

// The Adam pass, one CTA a start: its energy, best-iterate tracking and,
// with `update`, each angle's gradient (the gates of the angle from the
// last back, each gate's row summed over the chunks in order) and the
// Adam step with bias corrections bc1, bc2.
__device__ void adam_pass(const SweepParams& p, bool update,
                          float bc1, float bc2) {
  const Sh sh = sweep_shared(p);
  const int chunks = 1 << (p.n - kChunkBits), R = p.R, G = p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float b1f = (float)p.b1, b2f = (float)p.b2;
  for (int r = blockIdx.x; r < p.E * p.S; r += gridDim.x) {
    const int e = r / p.S;
    float* x = p.adam + (size_t)r * 4 * R;
    float* m = x + R;
    float* v = x + 2 * R;
    float* bx = x + 3 * R;
    const float en = row_energy(p, r);
    if (tid == 0) {
      const bool better = en < __ldcg(p.best_e + r);
      if (better) p.best_e[r] = en;
      sh.misc[1] = better;
    }
    __syncthreads();
    if (sh.misc[1])
      for (int a = tid; a < R; a += blockDim.x) bx[a] = __ldcg(x + a);
    if (update) {
      const float* gp = p.gpart + (size_t)r * G * chunks;
      for (int g = warp; g < G; g += kWarps) {
        const size_t at = (size_t)e * G + g;
        const int kind = __ldg(p.old_g.kind + at);
        if (__ldg(p.old_g.slot + at) < 0 ||
            !(kind == kRX || kind == kRY || kind == kRZ))
          continue;                         // warp-uniform
        float s = 0.f;
        for (int c = lane; c < chunks; c += 32)
          s += __ldcg(gp + (size_t)g * chunks + c);
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) sh.gsum[g] = s;
      }
      __syncthreads();
      for (int a = tid; a < R; a += blockDim.x) {
        float dx = 0.f;
        for (int g = G - 1; g >= 0; --g) {
          const size_t at = (size_t)e * G + g;
          const int kind = __ldg(p.old_g.kind + at);
          if (__ldg(p.old_g.slot + at) == a &&
              (kind == kRX || kind == kRY || kind == kRZ))
            dx += sh.gsum[g];
        }
        const float gr = dx * __ldg(p.active + (size_t)e * R + a);
        const float mm = b1f * __ldcg(m + a) + p.omb1 * gr;
        const float vv = b2f * __ldcg(v + a) + p.omb2 * gr * gr;
        const float mhat = mm / bc1;
        const float vhat = vv / bc2;
        x[a] = __ldcg(x + a) - p.lr * mhat / (sqrtf(vhat) + p.eps);
        m[a] = mm;
        v[a] = vv;
      }
    }
    __syncthreads();
  }
}

// Every start's state at its start, and both tapes' schedules, one
// thread a tape; the flips into shared memory.
__device__ void init_pass(const SweepParams& p) {
  const Sh sh = sweep_shared(p);
  const int tid = threadIdx.x, R = p.R, words = schedule_words(p.G);
  for (int f = tid; f < p.n_groups; f += blockDim.x) {
    sh.flips[f] = __ldg(p.flips + f);
    sh.wim_any[f] = __ldg(p.wim_any + f);
  }
  for (int k = blockIdx.x; k < 2 * p.E + p.E * p.S; k += gridDim.x) {
    if (k < 2 * p.E) {
      if (tid == 0)
        build_segments(k < p.E ? p.old_g : p.new_g, k % p.E, p.G, p.n,
                       p.sched + (size_t)k * words);
      continue;
    }
    const int r = k - 2 * p.E;
    float* x = p.adam + (size_t)r * 4 * R;
    for (int a = tid; a < R; a += blockDim.x) {
      const float x0 = __ldg(p.starts + (size_t)r * R + a);
      x[a] = x0;
      x[R + a] = 0.f;
      x[2 * R + a] = 0.f;
      x[3 * R + a] = x0;
    }
    if (tid == 0) p.best_e[r] = INFINITY;
  }
}

// The most segments an env's tape has: old (tape 0) or new (1).
__device__ int max_segments(const SweepParams& p, int tape) {
  const int words = schedule_words(p.G);
  int m = 0;
  for (int e = 0; e < p.E; ++e)
    m = max(m, __ldcg(p.sched + ((size_t)tape * p.E + e) * words));
  return m;
}

// Per env: the first start of least energy, x_opt, and x_new.
__device__ void tail_pass(const SweepParams& p) {
  const Sh sh = sweep_shared(p);
  const int tid = threadIdx.x, R = p.R;
  for (int e = blockIdx.x; e < p.E; e += gridDim.x) {
    if (tid == 0) {
      int bs = 0;
      float be = __ldcg(p.best_e + (size_t)e * p.S);
      for (int s = 1; s < p.S; ++s) {
        const float v = __ldcg(p.best_e + (size_t)e * p.S + s);
        if (v < be) {
          be = v;
          bs = s;
        }
      }
      sh.misc[2] = bs;
    }
    __syncthreads();
    const float* bx = p.adam + ((size_t)e * p.S + sh.misc[2]) * 4 * R + 3 * R;
    for (int a = tid; a < R; a += blockDim.x) {
      p.x_opt[(size_t)e * R + a] = __ldcg(bx + a);
      const int mj = __ldg(p.map_idx + (size_t)e * R + a);
      p.xnew[(size_t)e * R + a] = mj >= 0 ? __ldcg(bx + mj) : 0.f;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_adam_v2_sweep_kernel(SweepParams p) {
  const bool noise = p.seeds != nullptr;
  unsigned int passed = 0, pass = 0;
  init_pass(p);
  grid_sync(p.bar, passed);
  const int max_old = max_segments(p, 0), max_new = max_segments(p, 1);
  const Rows starts = {p.E * p.S, p.S, false};
  double b1t = 1.0, b2t = 1.0;
  // Adam iterations, then (it == iters) the re-check of the final iterate
  for (int it = 0; it <= p.iters; ++it) {
    const bool update = it < p.iters;
    for (int s = 0; s < max_old; ++s) {
      forward_pass(p, p.old_g, p.sched, starts, p.adam, 4 * p.R, s, it,
                   noise, pass++);
      grid_sync(p.bar, passed);
    }
    h_pass(p, starts, update, pass++);
    grid_sync(p.bar, passed);
    if (update)
      for (int s = max_old - 1; s >= 0; --s) {
        backward_pass(p, starts, s, it, noise, pass++);
        grid_sync(p.bar, passed);
      }
    // b^t as a running product in double from the exact rates: the bias
    // corrections are the plain version's 1 - b^t rounded once to float
    b1t *= p.b1;
    b2t *= p.b2;
    adam_pass(p, update, (float)(1.0 - b1t), (float)(1.0 - b2t));
    grid_sync(p.bar, passed);
  }
  tail_pass(p);
  grid_sync(p.bar, passed);
  // e_new: the new tape at x_new from psi0, in the env's first start's
  // buffers, under a fresh draw (tag iters + 1)
  const Rows envs = {p.E, p.S, true};
  const int* sched_new = p.sched + (size_t)p.E * schedule_words(p.G);
  for (int s = 0; s < max_new; ++s) {
    forward_pass(p, p.new_g, sched_new, envs, p.xnew, p.R, s, p.iters + 1,
                 noise, pass++);
    grid_sync(p.bar, passed);
  }
  h_pass(p, envs, false, pass++);
  grid_sync(p.bar, passed);
  for (int e = blockIdx.x; e < p.E; e += gridDim.x) {
    const float en = row_energy(p, e * p.S);
    if (threadIdx.x == 0) p.e_new[e] = en;
  }
}

size_t smem_bytes(int G, int n_groups) {
  return smem_layout(G, n_groups, nullptr);
}

}  // namespace

extern "C" {

// The qubit counts this kernel takes, and its chunk's qubits.
int fused_adam_sweep_min_qubits() { return kMinQubits; }
int fused_adam_sweep_max_qubits() { return kMaxQubits; }
int fused_adam_sweep_chunk_bits() { return kChunkBits; }

// Shared-memory bytes one CTA needs for tapes of G gates and n_groups flip
// groups.
size_t fused_adam_sweep_smem_bytes(int G, int n_groups) {
  return smem_bytes(G, n_groups);
}

// How many CTAs of `bytes` dynamic shared memory the card holds at once
// (blocks an SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor, times
// the SMs): the cooperative launch's grid; 0 when none fits, or minus a
// CUDA error code.
int fused_adam_sweep_resident_ctas(size_t bytes) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the attribute at the card's limit, so that the query, not the
  // attribute, judges `bytes`
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_adam_v2_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_adam_v2_sweep_kernel, kThreads, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();                   // not sticky for the next launch
    return -(int)err;
  }
  return per_sm * sms;
}

const char* fused_adam_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs asynchronously on `stream` with `ctas` CTAs, no more than
// fused_adam_sweep_resident_ctas gives (the cooperative launch refuses a
// grid the card cannot hold at once).  Scratch, allocated by the caller:
// psi and lam (E S x D float2 each), adam (E S x 4 R), best_e (E S), gpart
// (E S x G x 2^(n - chunk bits)), epart (E S x 2^(n - chunk bits) x 2
// doubles), sched (2 E x (3 G + 2) ints), xnew (E x R), bar (one zero
// unsigned int).  The other arguments are fused_adam_v2_launch's: a
// non-null `seeds` (E x 2 int32) launches the noise variant with fire
// thresholds thr1 and thr2 out of 2^24; psi0_stride 0 or D; wim_any (G_f
// int32) 1 where a group's imaginary plane is not zero.
int fused_adam_sweep_launch(
    const int* okind, const int* otq, const int* ocq, const int* oslot,
    const int* nkind, const int* ntq, const int* ncq, const int* nslot,
    const int* map_idx, const float* p0re, const float* p0im,
    const float* wre, const float* wim, const int* flips, const int* wim_any,
    const float* starts, const float* active, const int* seeds,
    float* x_opt, float* e_new, float2* psi, float2* lam, float* adam,
    float* best_e, float* gpart, double* epart, int* sched, float* xnew,
    unsigned int* bar, int ctas, int E, int S, int G, int R, int n,
    int n_groups, int psi0_stride, int iters, float lr, double b1,
    double b2, float omb1, float omb2, float eps, unsigned thr1,
    unsigned thr2, void* stream) {
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < kMinQubits || n > kMaxQubits ||
      n_groups < 1 || iters < 0 || ctas < 1 ||
      (psi0_stride != 0 && psi0_stride != 1 << n))
    return (int)cudaErrorInvalidValue;
  SweepParams p = {{okind, otq, ocq, oslot}, {nkind, ntq, ncq, nslot},
                   map_idx, p0re, p0im, wre, wim, flips, wim_any, starts,
                   active, seeds, x_opt, e_new, psi, lam, adam, best_e,
                   gpart, epart, sched, xnew, bar, E, S, G, R, n, n_groups,
                   psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1,
                   thr2};
  const size_t bytes = smem_bytes(G, n_groups);
  cudaError_t err = cudaFuncSetAttribute(
      fused_adam_v2_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = COOPERATIVE_LAUNCH(fused_adam_v2_sweep_kernel, ctas, kThreads, bytes,
                           static_cast<cudaStream_t>(stream), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
