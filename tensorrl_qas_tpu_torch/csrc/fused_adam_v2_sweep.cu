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
// Why a sweep.  fused_adam_v2.cu holds a start in the registers of 2^(n -
// 12) CTAs that wait on each other; an SM holds one such CTA, so at 20
// qubits a start (256 CTAs) cannot be resident on the H100's 132 SMs.
// Here a start's psi and lambda (8 MB each at 20 qubits) live in device
// memory between passes, and the card sweeps them pass by pass.
//
// The design (the second; the first walked every start of the launch
// through each pass together, 512 MB of state at 20 qubits, E = 8, S = 4,
// so that each pass was a round trip to HBM):
//
//   - Slots.  A persistent grid of as many CTAs as the card holds at once,
//     launched with cudaLaunchCooperativeKernel (which refuses a grid that
//     cannot be co-resident), is cut into `slots` interleaved sets of CTAs.
//     A slot runs its starts one at a time, each through its whole Adam
//     run, with a barrier of the slot's own CTAs between passes
//     (Slot::sync), so that the state in flight is slots x 16 MB at 20
//     qubits and a pass's round trip of it is mostly L2 traffic;
//     fused_adam_sweep_slots picks as many slots as kSlotBytes holds.  E =
//     1 (4 starts, 64 MB) runs its starts in the slots in turn.  A start's
//     buffers are its slot's: scratch is slots x D, not E S x D.
//   - The tape is cut into segments (segments.cuh; twin: ops/
//     fused_adam2d.py:sweep_segments): runs of consecutive gates whose
//     qubits, with qubits 0..4, number at most kChunkBits.  A pass over a
//     segment takes the state in chunks of 2^kChunkBits amplitudes that
//     differ only in the segment's local qubits (the chunk's index gives
//     the others), a chunk to a CTA's shared memory, where every gate of
//     the segment, and its drawn errors, is applied with one CTA barrier a
//     gate; then the chunk goes back.  Qubits 0..4 are local in every
//     segment, so a warp's 32 lanes read 32 consecutive amplitudes.
//   - H psi: one pass over contiguous chunks, staged in shared memory;
//     lambda = 2 conj(H psi) from each group's W_f(i) and psi[i ^ f] --
//     from shared memory where f flips only chunk bits, from L2 otherwise
//     -- and the chunk's energy partials in double.  W_f(i) = sum_k w_k
//     iphase_k (-1)^popc(i & sign_k) comes from a table of the group's
//     values at each parity vector of its terms where it has at most
//     kComputeTerms of them (every bond group of a Heisenberg chain),
//     made in double in the order and rounding of pauli_flip_groups, so
//     that it equals the group's float32 plane bit for bit; other groups
//     read their planes (one 4 MB plane at the 20q chain).
//   - Backward passes run the segments in reverse on psi and lambda, with
//     each angle gate's gradient row summed in the chunk (a fixed-order
//     block reduction) into a per-chunk partial.
//   - The Adam step of a start, by its slot's first CTA: the energy and
//     each angle's gradient summed over the chunks in order, best-iterate
//     tracking, the Adam update.
//   - The tail (after a barrier of the whole grid): per env the first
//     start of least energy, x_opt, the remap onto the new tape; then each
//     env's new tape forward from psi0 and its energy, in the slots.
// Every sum is taken in a fixed order that does not depend on the grid or
// the slots, so a repeated launch gives the same bits.  All amplitude
// arithmetic is f32 FMA: no TF32 or bf16, whose rounding exceeds the
// 1.6e-3 Ha acceptance threshold.
//
// Bound.  Operations: per start and Adam iteration H psi is G_f D complex
// multiply-adds (4 flops for a real group) and each gate a 2x2 update over
// D/2 pairs forward and backward; at 20 qubits, E = 8, S = 4, 100
// iterations on mid-episode tapes of the 20q config (G = 46) 1.3 TFLOP,
// 20 ms at the card's 67 TFLOP/s f32 rate; chip_smoke.py prints it.
//
// Noise.  With seeds every pass draws its segment's errors itself
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
#include "segments.cuh"

// The launches and the dynamic shared memory go through these macros, so
// that tests/cuda_emu/cuda_runtime.h, which defines them, can run this
// source on the host.
#ifndef SHARED_BASE
extern __shared__ __align__(16) unsigned char fused_adam_sweep_smem[];
#define SHARED_BASE() fused_adam_sweep_smem
#endif
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, bytes, stream, ...) \
  kernel<<<grid, block, bytes, stream>>>(__VA_ARGS__)
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
constexpr int kLaneQubits = segments::kLaneQubits;
constexpr int kMinQubits = FUSED_ADAM_SWEEP_MIN_QUBITS;
constexpr int kMaxQubits = 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHAmps = 4;               // H psi: amplitudes a thread at once
// A group's W is computed from its terms up to this many, else read.
constexpr int kComputeTerms = 4;
// The most state a launch keeps in flight, psi and lambda of a start a
// slot: 64 MB, about the H100's L2 (50 MB).
constexpr double kSlotBytes = 64.0 * (1 << 20);
// Three CTAs an SM (the shared memory allows three at the 20q configs'
// fixed capacity, G = 46): 80 registers a thread as ptxas allocates them.
// The passes make their pointers where they use them, so that none spills
// (a pointer kept across the run, or an Adam rate kept as a running
// product, spilled; two CTAs an SM at 128 registers are slower).
constexpr int kMinBlocks = 3;
static_assert(kHAmps * kComputeTerms <= 16, "ktab: a nibble an offset");
static_assert(kChunkBits >= kLaneQubits + 2 && kMinQubits >= kChunkBits,
              "a chunk holds qubits 0..4 and a gate's two qubits");

// Spins a barrier waits at most (x 64 ns and more) before it traps: the
// cooperative launch puts every CTA on the card at once, so a wait this
// long is a fault, which fails the launch.  The grid's barrier after the
// starts waits on the slot with the most work left.
constexpr unsigned int kSpinLimit = 1u << 28;
constexpr int kBarStride = 32;          // a barrier counter a 128-B line

struct SweepParams {
  Tape old_g, new_g;
  const int* map_idx;
  const float* p0re;
  const float* p0im;
  const float* wre;
  const float* wim;
  const int* flips;
  const int* wim_any;
  const int* gterm;       // G_f + 1: group f's terms [gterm[f], gterm[f+1])
  const int* tsign;       // terms' sign masks
  const double* tcoef;    // terms' w_k iphase_k: (re, im)
  const float* starts;
  const float* active;
  const int* seeds;
  float* x_opt;
  float* e_new;
  // scratch (the wrapper allocates it; no input is written)
  float2* psi;            // slots x D: each slot's psi ...
  float2* lam;            // ... and lambda
  float* adam;            // E S x 4 R: iterate, m, v, best iterate
  float* best_e;          // E S
  float* gpart;           // slots x G x chunks: gradient-row partials
  double* epart;          // slots x chunks x 2: energy partials
  int* sched;             // 2 x E x segments::words(G): old, new tape
  float* xnew;            // E x R: x_opt remapped onto the new tape
  unsigned int* bar;      // (slots + 1) x kBarStride counters (zero)
  double offset;          // taken off the f = 0 group's W
  int E, S, G, R, n, n_groups, psi0_stride, iters, slots;
  float lr;
  double b1, b2;
  float omb1, omb2, eps;
  unsigned thr1, thr2;
};

// A segment's gate as one pass applies it: kind, target and control as
// local bits (-1: none), whether it has an angle gradient (its tape index
// + 1, else 0), the error kinds drawn on the target and the control.
struct SegGate {
  int kind, tl, cl, grad, et, ec;
};

// A flip group as H psi reads it: its flip, whether its imaginary plane is
// not zero, its computed terms (-1: W read from the plane), and their
// parity vectors at amplitudes a kThreads (a < kHAmps, a nibble each).
struct Group {
  int flip, cplx, terms, ktab;
};

// The dynamic shared memory of a CTA.  The Adam step takes the chunk's
// psi and lambda as its gradient rows (G <= 4 kChunk floats).
struct Sh {
  float2* psi;     // kChunk: the chunk of psi ...
  float2* lam;     // ... and of lambda
  float4* coef;    // 2 G: each segment gate's 2x2 entries
  SegGate* gate;   // G
  float* redf;     // 2 kWarps: gradient-row partials, double-buffered
  double* redd;    // 2 kWarps: energy partials
  Group* grp;      // n_groups
  int* tsign;      // kComputeTerms n_groups: the terms' sign masks
  float2* wtab;    // kWTable n_groups: W at each parity vector
  int* lq;         // kMaxQubits: the local qubit of each local bit
  int* nq;         // kMaxQubits: the qubit of each chunk-index bit
  int* misc;       // 8: [0] gates in the segment, [1] flag, [2] best start
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

constexpr int kShParts = 12;
constexpr int kWTable = 1 << kComputeTerms;

__host__ __device__ __forceinline__ size_t smem_layout(int G, int n_groups,
                                                       size_t* off) {
  size_t b = 0;
  const size_t t = (size_t)kComputeTerms * n_groups;
  const size_t sizes[kShParts] = {
      sizeof(float2) * kChunk, sizeof(float2) * kChunk,
      sizeof(float4) * 2 * (size_t)G, sizeof(SegGate) * (size_t)G,
      sizeof(float) * 2 * kWarps, sizeof(double) * 2 * kWarps,
      sizeof(Group) * (size_t)n_groups, sizeof(int) * t,
      sizeof(float2) * kWTable * (size_t)n_groups,
      sizeof(int) * kMaxQubits, sizeof(int) * kMaxQubits, sizeof(int) * 8};
  for (int k = 0; k < kShParts; ++k) {
    if (off) off[k] = b;
    b += align16(sizes[k]);
  }
  return b;
}

// The dynamic shared memory's layout, for a pass to take at its start
// (kept in registers across the whole kernel, the pointers took more than
// a third of what three CTAs an SM allow).
__device__ __forceinline__ Sh sweep_shared(const SweepParams& p) {
  unsigned char* base = SHARED_BASE();
  size_t off[kShParts];
  smem_layout(p.G, p.n_groups, off);
  Sh sh;
  sh.psi = reinterpret_cast<float2*>(base + off[0]);
  sh.lam = reinterpret_cast<float2*>(base + off[1]);
  sh.coef = reinterpret_cast<float4*>(base + off[2]);
  sh.gate = reinterpret_cast<SegGate*>(base + off[3]);
  sh.redf = reinterpret_cast<float*>(base + off[4]);
  sh.redd = reinterpret_cast<double*>(base + off[5]);
  sh.grp = reinterpret_cast<Group*>(base + off[6]);
  sh.tsign = reinterpret_cast<int*>(base + off[7]);
  sh.wtab = reinterpret_cast<float2*>(base + off[8]);
  sh.lq = reinterpret_cast<int*>(base + off[9]);
  sh.nq = reinterpret_cast<int*>(base + off[10]);
  sh.misc = reinterpret_cast<int*>(base + off[11]);
  return sh;
}

// -- barriers ----------------------------------------------------------------

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

// The `ctas` CTAs that count on `bar` arrive (release) and wait until all
// have (acquire), after which their loads see what the others stored
// before arriving; the counter only grows (barrier k ends at k x ctas).
// Data written inside the launch is read with __ldcg (L2), never __ldg.
__device__ __forceinline__ void bar_sync(unsigned int* bar, int ctas,
                                         unsigned int& passed) {
  __syncthreads();
  ++passed;
  if (threadIdx.x == 0) {
    const unsigned int target = passed * (unsigned)ctas;
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

// A CTA's slot (interleaved: CTA b is in slot b % slots) and the slot
// barriers it passed; its index among the slot's CTAs (cb) and their
// number (C) are made where used, not kept in registers.
struct Slot {
  int id;
  unsigned int passed;
  __device__ int cb(const SweepParams& p) const {
    return (int)blockIdx.x / p.slots;
  }
  __device__ int C(const SweepParams& p) const {
    return ((int)gridDim.x - id + p.slots - 1) / p.slots;
  }
  __device__ void sync(const SweepParams& p) {
    bar_sync(p.bar + (size_t)id * kBarStride, C(p), passed);
  }
};

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
    int et = 0, ec = 0;
    if (noise)
      philox::error_kinds(kind, g, tag, k0, k1, p.thr1, p.thr2, et, ec);
    sh.gate[j] = {kind, segments::local_bit(mask, t),
                  c >= 0 ? segments::local_bit(mask, c) : -1,
                  grad ? g + 1 : 0, et, ec};
  }
  __syncthreads();
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

// Forward pass over segment k of env e's old tape at start row r's
// iterate, or (`fresh`) of its new tape at x_new, in the slot's psi (from
// psi0 for the first segment): each of the slot's chunks into shared
// memory, through the segment's gates (and drawn errors), back.  Its
// pointers are made here, not kept across passes: three CTAs an SM leave
// 80 registers a thread.
__device__ void forward_pass(const SweepParams& p, const Slot& slot,
                             bool fresh, int k, int e, int r, int tag,
                             bool noise) {
  const Sh sh = sweep_shared(p);
  const int* w = p.sched + ((size_t)(fresh ? p.E : 0) + e) *
                               segments::words(p.G);
  const float* x = fresh ? p.xnew + (size_t)e * p.R
                         : p.adam + (size_t)r * 4 * p.R;
  float2* psi = p.psi + ((size_t)slot.id << p.n);
  load_segment(sh, p, fresh ? p.new_g : p.old_g, w, k, e, x, tag, noise);
  const int chunks = 1 << (p.n - kChunkBits), C = slot.C(p), cb = slot.cb(p);
  const float* p0r = p.p0re + (size_t)e * p.psi0_stride;
  const float* p0i = p.p0im + (size_t)e * p.psi0_stride;
  const int gates = sh.misc[0];
  for (int chunk = cb; chunk < chunks; chunk += C) {
    const int base = segments::chunk_base<kChunkBits>(sh.nq, chunk, p.n);
    for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
      const int i = base | segments::local_index<kChunkBits>(sh.lq, l);
      sh.psi[l] = k == 0 ? make_float2(__ldg(p0r + i), __ldg(p0i + i))
                         : __ldcg(psi + i);
    }
    __syncthreads();
    for (int j = 0; j < gates; ++j) {  // forward gates
      chunk_gate(sh, j);
      const SegGate gt = sh.gate[j];
      if (gt.et) chunk_pauli<false>(sh, gt.et, gt.tl);
      if (gt.ec) chunk_pauli<false>(sh, gt.ec, gt.cl);
    }
    for (int l = threadIdx.x; l < kChunk; l += blockDim.x)
      psi[base | segments::local_index<kChunkBits>(sh.lq, l)] = sh.psi[l];
    __syncthreads();
  }
}

// Backward pass over segment k of the old tape for start row r (env e) in
// the slot's buffers: psi and lambda through the segment's gates in
// reverse (errors undone first), each angle gate's gradient partial of
// every chunk into the slot's gpart; the state goes back unless this is
// the first segment.
__device__ void backward_pass(const SweepParams& p, const Slot& slot,
                              int k, int r, int e, int tag, bool noise) {
  const Sh sh = sweep_shared(p);
  const int* w = p.sched + (size_t)e * segments::words(p.G);
  load_segment(sh, p, p.old_g, w, k, e, p.adam + (size_t)r * 4 * p.R, tag,
               noise);
  const int chunks = 1 << (p.n - kChunkBits), C = slot.C(p), cb = slot.cb(p);
  const int D = 1 << p.n;
  float2* psi = p.psi + (size_t)slot.id * D;
  float2* lam = p.lam + (size_t)slot.id * D;
  float* gpart = p.gpart + (size_t)slot.id * p.G * chunks;
  int parity = 0;
  for (int chunk = cb; chunk < chunks; chunk += C) {
    const int base = segments::chunk_base<kChunkBits>(sh.nq, chunk, p.n);
    for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
      const int i = base | segments::local_index<kChunkBits>(sh.lq, l);
      sh.psi[l] = __ldcg(psi + i);
      sh.lam[l] = __ldcg(lam + i);
    }
    __syncthreads();
    for (int j = sh.misc[0] - 1; j >= 0; --j) {  // adjoint gates
      const SegGate gt = sh.gate[j];
      if (gt.et) chunk_pauli<true>(sh, gt.et, gt.tl);
      if (gt.ec) chunk_pauli<true>(sh, gt.ec, gt.cl);
      chunk_gate_adj(sh, j, gpart, chunks, chunk, parity);
    }
    if (k > 0)
      for (int l = threadIdx.x; l < kChunk; l += blockDim.x) {
        const int i = base | segments::local_index<kChunkBits>(sh.lq, l);
        psi[i] = sh.psi[l];
        lam[i] = sh.lam[l];
      }
    __syncthreads();
  }
}

// W_f(i) of a computed group f: its table's entry at the parity vector
// of i's terms, bit k = popc(i & sign_k) mod 2 (stage_groups).  The W
// test kernel reads it so; h_pass reaches the same entries through the
// nibble table.
__device__ __forceinline__ float2 group_w(const Sh& sh, int f, int i) {
  int v = 0;
  for (int t = 0; t < sh.grp[f].terms; ++t)
    v |= (__popc((unsigned)i & (unsigned)sh.tsign[kComputeTerms * f + t])
          & 1) << t;
  return sh.wtab[kWTable * f + v];
}

// H psi over contiguous chunks of the slot's psi: each chunk's
// energy partials (Re<psi|H psi>, <psi|psi> in double, a fixed order) into
// the slot's epart and, with `lambda`, lambda = 2 conj(H psi).  A group
// whose imaginary plane is zero reads or adds no imaginary part.
__device__ void h_pass(const SweepParams& p, const Slot& slot,
                       bool lambda) {
  const Sh sh = sweep_shared(p);
  const int chunks = 1 << (p.n - kChunkBits), D = 1 << p.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float2* psi = p.psi + (size_t)slot.id * D;
  const int C = slot.C(p);
  for (int chunk = slot.cb(p); chunk < chunks; chunk += C) {
    const int base = chunk << kChunkBits;
    for (int l = tid; l < kChunk; l += blockDim.x)
      sh.psi[l] = __ldcg(psi + base + l);
    __syncthreads();
    double raw = 0.0, nn = 0.0;
    // kHAmps amplitudes of a thread at once (l, l + T, ...): a group's
    // partners are loaded together before they are used (a chunk smaller
    // than kHAmps T, in the host tests, leaves some out)
    constexpr bool kPartial = kChunk < kHAmps * kThreads;
    for (int l0 = tid; l0 < kChunk; l0 += kHAmps * kThreads) {
      float hr[kHAmps], hi[kHAmps];
#pragma unroll
      for (int a = 0; a < kHAmps; ++a) hr[a] = hi[a] = 0.f;
      for (int f = 0; f < p.n_groups; ++f) {
        const Group gr = sh.grp[f];
        const int fl = gr.flip;
        const bool cplx = gr.cplx != 0, computed = gr.terms >= 0;
        // W's parity vector at amplitude base + l0 + a T is v0 ^ the a-th
        // nibble of ktab (l0 and a T share no bit)
        int v0 = 0, kt = 0;
        if (computed) {
          for (int t = 0; t < gr.terms; ++t)
            v0 |= (__popc((unsigned)(base + l0) &
                          (unsigned)sh.tsign[kComputeTerms * f + t]) & 1)
                  << t;
          kt = gr.ktab;
        }
        float2 q[kHAmps];
        if (fl < kChunk) {                // block-uniform
#pragma unroll
          for (int a = 0; a < kHAmps; ++a)
            if (!kPartial || l0 + a * kThreads < kChunk)
              q[a] = sh.psi[(l0 + a * kThreads) ^ fl];
        } else {
#pragma unroll
          for (int a = 0; a < kHAmps; ++a)
            if (!kPartial || l0 + a * kThreads < kChunk)
              q[a] = __ldcg(psi + ((base + l0 + a * kThreads) ^ fl));
        }
#pragma unroll
        for (int a = 0; a < kHAmps; ++a) {
          if (kPartial && l0 + a * kThreads >= kChunk) continue;
          const int i = base + l0 + a * kThreads;
          float2 wv;
          if (computed) {
            wv = sh.wtab[kWTable * f + (v0 ^ ((kt >> (4 * a)) & 15))];
          } else {
            wv.x = __ldg(p.wre + (size_t)f * D + i);
            wv.y = cplx ? __ldg(p.wim + (size_t)f * D + i) : 0.f;
          }
          hr[a] = fmaf(wv.x, q[a].x, hr[a]);
          if (cplx) hr[a] = fmaf(-wv.y, q[a].y, hr[a]);
          hi[a] = fmaf(wv.x, q[a].y, hi[a]);
          if (cplx) hi[a] = fmaf(wv.y, q[a].x, hi[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < kHAmps; ++a) {
        const int l = l0 + a * kThreads;
        if (kPartial && l >= kChunk) continue;
        const float2 v = sh.psi[l];
        raw += (double)v.x * hr[a] + (double)v.y * hi[a];
        nn += (double)v.x * v.x + (double)v.y * v.y;
        if (lambda)
          p.lam[((size_t)slot.id << p.n) + base + l] =
              make_float2(2.f * hr[a], -2.f * hi[a]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      raw += __shfl_xor_sync(0xffffffffu, raw, off);
      nn += __shfl_xor_sync(0xffffffffu, nn, off);
    }
    if (lane == 0) {
      sh.redd[2 * warp] = raw;
      sh.redd[2 * warp + 1] = nn;
    }
    __syncthreads();
    if (tid == 0) {
      double a = 0.0, b = 0.0;
      for (int v = 0; v < kWarps; ++v) {
        a += sh.redd[2 * v];
        b += sh.redd[2 * v + 1];
      }
      double* epart = p.epart + ((size_t)slot.id * chunks + chunk) * 2;
      epart[0] = a;
      epart[1] = b;
    }
    __syncthreads();
  }
}

// The energy of the slot's last H pass: its chunks' partials summed in
// order by warp 0 (lane l takes chunks l, l + 32, ..., then a fixed
// butterfly); -> thread 0.
__device__ __forceinline__ float slot_energy(const SweepParams& p,
                                             int slot) {
  const int chunks = 1 << (p.n - kChunkBits);
  double raw = 0.0, nn = 0.0;
  if (threadIdx.x < 32) {
    const double* ep = p.epart + (size_t)slot * chunks * 2;
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

// Start row r's (env e) Adam step after iteration `it`, by one CTA: its
// energy, best-iterate tracking and, for it < iters, each angle's gradient
// (the gates of the angle from the last back, each gate's row summed over
// the chunks in order) and the Adam step.
__device__ void adam_step(const SweepParams& p, int slot, int r, int e,
                          int it) {
  const bool update = it < p.iters;
  // b^(it + 1) as a running product in double from the exact rates: the
  // bias corrections are the plain version's 1 - b^t rounded once to float
  double b1t = 1.0, b2t = 1.0;
  for (int k = 0; k <= it; ++k) {
    b1t *= p.b1;
    b2t *= p.b2;
  }
  const float bc1 = (float)(1.0 - b1t), bc2 = (float)(1.0 - b2t);
  const Sh sh = sweep_shared(p);
  const int chunks = 1 << (p.n - kChunkBits), R = p.R, G = p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float b1f = (float)p.b1, b2f = (float)p.b2;
  float* x = p.adam + (size_t)r * 4 * R;
  float* m = x + R;
  float* v = x + 2 * R;
  float* bx = x + 3 * R;
  const float en = slot_energy(p, slot);
  if (tid == 0) {
    const bool better = en < __ldcg(p.best_e + r);
    if (better) p.best_e[r] = en;
    sh.misc[1] = better;
  }
  __syncthreads();
  if (sh.misc[1])
    for (int a = tid; a < R; a += blockDim.x) bx[a] = __ldcg(x + a);
  if (update) {
    const float* gp = p.gpart + (size_t)slot * G * chunks;
    float* gsum = reinterpret_cast<float*>(sh.psi);
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
      if (lane == 0) gsum[g] = s;
    }
    __syncthreads();
    for (int a = tid; a < R; a += blockDim.x) {
      float dx = 0.f;
      for (int g = G - 1; g >= 0; --g) {
        const size_t at = (size_t)e * G + g;
        const int kind = __ldg(p.old_g.kind + at);
        if (__ldg(p.old_g.slot + at) == a &&
            (kind == kRX || kind == kRY || kind == kRZ))
          dx += gsum[g];
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

// The flip groups into shared memory, and for each group of at most
// kComputeTerms terms (gterm given) its sign masks, the parity vectors of
// amplitudes a kThreads (a < kHAmps: h_pass's offsets), and its W at every
// parity vector v of the terms (bit k: the sign of term k is -1) as
// pauli_flip_groups makes its planes: the terms' w_k iphase_k in order,
// each added with its sign in double where not zero, the offset off the f
// = 0 group, then rounded once to float -- so W from the table is the
// float32 plane bit for bit.  Ends on a CTA barrier.
__device__ void stage_groups(const SweepParams& p) {
  const Sh sh = sweep_shared(p);
  for (int f = threadIdx.x; f < p.n_groups; f += blockDim.x) {
    const int fl = __ldg(p.flips + f);
    const int t0 = p.gterm ? __ldg(p.gterm + f) : 0;
    const int nt = p.gterm ? __ldg(p.gterm + f + 1) - t0 : -1;
    const bool computed = nt >= 0 && nt <= kComputeTerms;
    sh.grp[f] = {fl, __ldg(p.wim_any + f), computed ? nt : -1, 0};
    if (!computed) continue;
    int kt = 0;
    for (int t = 0; t < nt; ++t) {
      const unsigned sign = (unsigned)__ldg(p.tsign + t0 + t);
      sh.tsign[kComputeTerms * f + t] = (int)sign;
      for (int a = 0; a < kHAmps; ++a)
        kt |= (__popc((unsigned)(a * kThreads) & sign) & 1) << (4 * a + t);
    }
    sh.grp[f].ktab = kt;
    for (int v = 0; v < (1 << nt); ++v) {
      double wr = 0.0, wi = 0.0;
      for (int t = 0; t < nt; ++t) {
        const bool neg = (v >> t) & 1;
        const double cr = __ldg(p.tcoef + 2 * (t0 + t));
        const double ci = __ldg(p.tcoef + 2 * (t0 + t) + 1);
        if (cr != 0.0) wr += neg ? -cr : cr;
        if (ci != 0.0) wi += neg ? -ci : ci;
      }
      if (fl == 0) wr -= p.offset;
      sh.wtab[kWTable * f + v] = make_float2((float)wr, (float)wi);
    }
  }
  __syncthreads();
}

// Every start's state at its start, and both tapes' schedules, one thread
// a tape.
__device__ void init_pass(const SweepParams& p) {
  const int tid = threadIdx.x, R = p.R, words = segments::words(p.G);
  for (int k = blockIdx.x; k < 2 * p.E + p.E * p.S; k += gridDim.x) {
    if (k < 2 * p.E) {
      const Tape& t = k < p.E ? p.old_g : p.new_g;
      if (tid == 0)
        segments::build<kChunkBits>(t.kind, t.tq, t.cq, k % p.E, p.G, p.n,
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

// Start row r's whole Adam run in its slot: per iteration the forward
// segments, H psi, the backward segments and the Adam step, then (it ==
// iters) the re-check of the final iterate.
__device__ void run_start(const SweepParams& p, Slot& slot, int r,
                          bool noise) {
  const int e = r / p.S;
  const int nseg = __ldcg(p.sched + (size_t)e * segments::words(p.G));
  for (int it = 0; it <= p.iters; ++it) {
    const bool update = it < p.iters;
    for (int k = 0; k < nseg; ++k) {
      forward_pass(p, slot, false, k, e, r, it, noise);
      slot.sync(p);
    }
    h_pass(p, slot, update);
    slot.sync(p);
    if (update)
      for (int k = nseg - 1; k >= 0; --k) {
        backward_pass(p, slot, k, r, e, it, noise);
        slot.sync(p);
      }
    if (slot.cb(p) == 0) adam_step(p, slot.id, r, e, it);
    slot.sync(p);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_adam_v2_sweep_kernel(SweepParams p) {
  const bool noise = p.seeds != nullptr;
  unsigned int grid_passed = 0;
  stage_groups(p);
  init_pass(p);
  bar_sync(p.bar + (size_t)p.slots * kBarStride, gridDim.x, grid_passed);
  const int id = blockIdx.x % p.slots;
  Slot slot = {id, 0u};
  for (int r = id; r < p.E * p.S; r += p.slots) run_start(p, slot, r, noise);
  bar_sync(p.bar + (size_t)p.slots * kBarStride, gridDim.x, grid_passed);
  tail_pass(p);
  bar_sync(p.bar + (size_t)p.slots * kBarStride, gridDim.x, grid_passed);
  // e_new: each env's new tape at x_new from psi0 in its slot's buffers,
  // under a fresh draw (tag iters + 1)
  for (int e = id; e < p.E; e += p.slots) {
    const int nseg =
        __ldcg(p.sched + ((size_t)p.E + e) * segments::words(p.G));
    for (int k = 0; k < nseg; ++k) {
      forward_pass(p, slot, true, k, e, 0, p.iters + 1, noise);
      slot.sync(p);
    }
    h_pass(p, slot, false);
    slot.sync(p);
    if (slot.cb(p) == 0) {
      const float en = slot_energy(p, id);
      if (threadIdx.x == 0) p.e_new[e] = en;
    }
  }
}

size_t smem_bytes(int G, int n_groups) {
  return smem_layout(G, n_groups, nullptr);
}

// W of every flip group at every amplitude by group_w (a test of the
// in-kernel planes against pauli_flip_groups'): one CTA a group.
__global__ void __launch_bounds__(kThreads)
fused_adam_sweep_w_kernel(SweepParams p, float* wre, float* wim) {
  const Sh sh = sweep_shared(p);
  stage_groups(p);
  const int f = blockIdx.x, D = 1 << p.n;
  if (sh.grp[f].terms < 0) return;        // block-uniform
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float2 w = group_w(sh, f, i);
    wre[(size_t)f * D + i] = w.x;
    wim[(size_t)f * D + i] = w.y;
  }
}

}  // namespace

extern "C" {

// The qubit counts this kernel takes, its chunk's qubits, and the most
// terms of a group whose W it computes.
int fused_adam_sweep_min_qubits() { return kMinQubits; }
int fused_adam_sweep_max_qubits() { return kMaxQubits; }
int fused_adam_sweep_chunk_bits() { return kChunkBits; }
int fused_adam_sweep_compute_terms() { return kComputeTerms; }

// Shared-memory bytes one CTA needs for tapes of G gates and n_groups flip
// groups.
size_t fused_adam_sweep_smem_bytes(int G, int n_groups) {
  return smem_bytes(G, n_groups);
}

// The slots of a launch at n qubits with `rows` starts on `ctas` CTAs: of
// the counts whose starts' psi and lambda (16 B an amplitude) kSlotBytes
// holds, at most one a start and one a CTA, the one with the fewest chunk
// rounds a launch -- a slot's starts one after another times a pass's
// rounds, ceil(chunks / (ctas / slots)) -- and of those the fewest.
int fused_adam_sweep_slots(int n, int rows, int ctas) {
  const long long chunks = 1ll << (n - kChunkBits);
  int most = (int)(kSlotBytes / (16.0 * (double)(1ll << n)));
  if (most > rows) most = rows;
  if (most > ctas) most = ctas;
  int best = 1;
  long long best_rounds = -1;
  for (int s = 1; s <= most; ++s) {
    const long long rounds =
        (long long)((rows + s - 1) / s) * ((chunks * s + ctas - 1) / ctas);
    if (best_rounds < 0 || rounds < best_rounds) {
      best = s;
      best_rounds = rounds;
    }
  }
  return best;
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
// grid the card cannot hold at once), in `slots` slots (1 <= slots <=
// min(ctas, E S)).  Scratch, allocated by the caller: psi and lam (slots
// x D float2 each), adam (E S x 4 R), best_e (E S), gpart (slots x G x
// 2^(n - chunk bits)), epart (slots x 2^(n - chunk bits) x 2 doubles),
// sched (2 E x (3 G + 2) ints), xnew (E x R), bar ((slots + 1) x 32 zero
// unsigned ints).  The other arguments are
// fused_adam_v2_launch's: a non-null `seeds` (E x 2 int32) launches the
// noise variant with fire thresholds thr1 and thr2 out of 2^24;
// psi0_stride 0 or D; wim_any (G_f int32) 1 where a group's imaginary
// plane is not zero; gterm (G_f + 1 int32), tsign (int32) and tcoef (2
// doubles a term) the groups' terms in pauli_flip_groups' order, or
// gterm null to read every group's planes; `offset` the identity weight
// taken off the f = 0 group.
int fused_adam_sweep_launch(
    const int* okind, const int* otq, const int* ocq, const int* oslot,
    const int* nkind, const int* ntq, const int* ncq, const int* nslot,
    const int* map_idx, const float* p0re, const float* p0im,
    const float* wre, const float* wim, const int* flips, const int* wim_any,
    const int* gterm, const int* tsign, const double* tcoef,
    const float* starts, const float* active, const int* seeds,
    float* x_opt, float* e_new, float2* psi, float2* lam, float* adam,
    float* best_e, float* gpart, double* epart, int* sched, float* xnew,
    unsigned int* bar, int ctas, int slots, int E, int S, int G,
    int R, int n, int n_groups, int psi0_stride, int iters, double offset,
    float lr, double b1, double b2, float omb1, float omb2, float eps,
    unsigned thr1, unsigned thr2, void* stream) {
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < kMinQubits || n > kMaxQubits ||
      G > 4 * kChunk || n_groups < 1 || iters < 0 || ctas < 1 ||
      slots < 1 || slots > ctas ||
      slots > E * S || (psi0_stride != 0 && psi0_stride != 1 << n))
    return (int)cudaErrorInvalidValue;
  SweepParams p = {{okind, otq, ocq, oslot}, {nkind, ntq, ncq, nslot},
                   map_idx, p0re, p0im, wre, wim, flips, wim_any, gterm,
                   tsign, tcoef, starts, active, seeds, x_opt, e_new, psi,
                   lam, adam, best_e, gpart, epart, sched, xnew, bar,
                   offset, E, S, G, R, n, n_groups, psi0_stride, iters,
                   slots, lr, b1, b2, omb1, omb2, eps, thr1, thr2};
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

// The in-kernel W of every flip group of n qubits whose terms it computes
// (at most kComputeTerms: group_w) into (n_groups, 2^n) planes wre / wim;
// the other groups' rows are not written.  One CTA a group, on `stream`.
int fused_adam_sweep_w_planes(const int* flips, const int* wim_any,
                              const int* gterm, const int* tsign,
                              const double* tcoef, double offset, int n,
                              int n_groups, float* wre, float* wim,
                              void* stream) {
  if (n < 1 || n > kMaxQubits || n_groups < 1 || !gterm)
    return (int)cudaErrorInvalidValue;
  SweepParams p = {};
  p.flips = flips;
  p.wim_any = wim_any;
  p.gterm = gterm;
  p.tsign = tsign;
  p.tcoef = tcoef;
  p.offset = offset;
  p.G = 1;
  p.n = n;
  p.n_groups = n_groups;
  const size_t bytes = smem_bytes(1, n_groups);
  cudaError_t err = cudaFuncSetAttribute(
      fused_adam_sweep_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  KERNEL_LAUNCH(fused_adam_sweep_w_kernel, n_groups, kThreads, bytes,
                static_cast<cudaStream_t>(stream), p, wre, wim);
  return (int)cudaGetLastError();
}

}  // extern "C"
