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
//
// Why another design.  apply_tape.cu's wide kernels hold a row in the
// registers of a cluster of 2^(n - 12) CTAs; at 17 qubits that is 32 CTAs,
// more than a cluster may have, and at 20 qubits an (E S) batch of rows is
// 256 MB, which no chip-resident design holds.  Here, as in
// fused_adam_v2_sweep.cu, every row stays in device memory as float re /
// im planes and the card sweeps it segment by segment, a chunk of 2^12
// amplitudes at a time in shared memory: tape_sweep.cuh, the body this
// source shares with the double-precision instance (apply_tape_f64.cu),
// has the design (the second: a persistent grid, one launch a call, the
// next chunk loading while the gates run).  This is its float instance,
// for 17-20 qubits, where every row is cut into chunks and read under a
// schedule of segments; the forward's two 32 KB chunk buffers leave room
// for three CTAs an SM, the adjoint's (psi and mu) one.
//
// Bound.  Bytes the function must move: the planes in and out once
// (forward 4, adjoint 6 planes of E S D floats, the adjoint's psi0
// cotangents included); at 20 qubits, E = 8, S = 4 that is 537 MB
// forward, 0.16 ms at the card's 3.35 TB/s, and 805 MB adjoint, 0.24 ms.
// What the design moves: each segment reads and writes its row once (the
// adjoint psi and mu), so about `segments` times that; the shared-memory
// passes (a barrier a gate) and the segments' count bound it, not
// operations (an RX is 6 flops an amplitude).  chip_smoke.py prints the
// bound at the main path's shapes.

#include "tape_sweep.cuh"

// The chunk's qubits and the fewest qubits taken.  The host tests compile
// the source with smaller chunks and a lower qubit band, so that small
// states cross many segments.
#ifndef APPLY_TAPE_SWEEP_CHUNK_BITS
#define APPLY_TAPE_SWEEP_CHUNK_BITS 12
#endif
#ifndef APPLY_TAPE_SWEEP_MIN_QUBITS
#define APPLY_TAPE_SWEEP_MIN_QUBITS 17
#endif

namespace {

using C = tape_sweep::Cfg<float, APPLY_TAPE_SWEEP_CHUNK_BITS,
                          APPLY_TAPE_SWEEP_MIN_QUBITS>;
using Args = tape_sweep::Args<float>;
static_assert(!C::kWholeRows, "the float instance cuts every row");

__global__ void apply_tape_sweep_schedule_kernel(const int* kind,
                                                 const int* tq, const int* cq,
                                                 int E, int G, int n,
                                                 int* out) {
  tape_sweep::schedule<C>(kind, tq, cq, E, G, n, out);
}

__global__ void __launch_bounds__(C::sweep_threads(false),
                                    C::min_blocks(false))
apply_tape_sweep_fwd_kernel(Args a) {
  DYNAMIC_SHARED(apply_tape_sweep_smem);
  tape_sweep::sweep<C, false>(a, apply_tape_sweep_smem);
}

__global__ void __launch_bounds__(C::sweep_threads(true),
                                    C::min_blocks(true))
apply_tape_sweep_bwd_kernel(Args a) {
  DYNAMIC_SHARED(apply_tape_sweep_smem);
  tape_sweep::sweep<C, true>(a, apply_tape_sweep_smem);
}

__global__ void __launch_bounds__(tape_sweep::kThreads)
apply_tape_sweep_bwd_grad_kernel(Args a, float* dang) {
  DYNAMIC_SHARED(apply_tape_sweep_smem);
  tape_sweep::bwd_grad<C>(a, dang, apply_tape_sweep_smem);
}

const tape_sweep::Kernels<C> kKernels = {
    nullptr, nullptr, apply_tape_sweep_fwd_kernel,
    apply_tape_sweep_bwd_kernel, apply_tape_sweep_bwd_grad_kernel,
    apply_tape_sweep_schedule_kernel};

}  // namespace

extern "C" {

// The qubit counts these kernels take, and their chunk's qubits.
int apply_tape_sweep_min_qubits() { return C::kMinQubits; }
int apply_tape_sweep_max_qubits() { return tape_sweep::kMaxQubits; }
int apply_tape_sweep_chunk_bits() { return C::kChunkBits; }

// The most segments a tape of G gates can have at n qubits (a call's
// items are at most E S chunks x that).
int apply_tape_sweep_max_segments(int G, int n) {
  return tape_sweep::max_segments<C>(G, n);
}

// Threads of a CTA, and chunk buffers of a sweep CTA, of the forward
// (adjoint 0) or adjoint (1) kernel at n qubits.
int apply_tape_sweep_threads(int adjoint, int n) {
  return C::threads(n, adjoint != 0);
}
int apply_tape_sweep_stages(int adjoint) {
  return C::stages(adjoint != 0);
}

// Shared-memory bytes of one CTA of the forward (adjoint 0) or adjoint (1)
// kernel at n qubits; of the gradient kernel at G gates.
size_t apply_tape_sweep_smem_bytes(int adjoint, int n) {
  return tape_sweep::smem_bytes<C>(adjoint != 0, n);
}

size_t apply_tape_sweep_grad_smem_bytes(int G) {
  return tape_sweep::grad_smem_bytes<C>(G);
}

// The int32 sync words (zeroed by each call) a sweep call on `rows` rows
// takes from the caller.
int apply_tape_sweep_sync_words(int rows) { return tape_sweep::sync_words(rows); }

// How many CTAs of the forward (adjoint 0) or adjoint (1) kernel an SM
// holds at once at n qubits, and the card (a sweep call's grid at most);
// 0 when none fits, or minus a CUDA error code.
int apply_tape_sweep_ctas_per_sm(int adjoint, int n) {
  return tape_sweep::ctas_per_sm<C>(kKernels, adjoint, n);
}

int apply_tape_sweep_resident_ctas(int adjoint, int n) {
  return tape_sweep::resident_ctas<C>(kKernels, adjoint, n);
}

const char* apply_tape_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The segments of (E, G) noiseless tapes at n qubits (above the chunk's)
// into out (E x (3 G + 2) int32), one thread an env.
int apply_tape_sweep_schedule_launch(const int* kind, const int* tq,
    const int* cq, int* out, int E, int G, int n, void* stream) {
  return tape_sweep::schedule_launch<C>(kKernels, kind, tq, cq, out, E, G,
                                        n, stream);
}

// Forward: re / im / ore / oim (E, S, D) float, tapes (E, weave x G) int32
// (weave 3: every gate followed by its error Paulis), angles (E, S, R)
// float, sched (es rows of the noiseless tapes' segments; env e reads row
// e % es; null where a row is whole), sync (apply_tape_sweep_sync_words(E S)
// int32 of scratch; null where a row is whole).  One launch on `stream`;
// returns the first error (cudaGetLastError), 0 on success.
int apply_tape_sweep_fwd_launch(const int* kind, const int* tq, const int* cq,
    const int* slot, const float* angles, const float* re, const float* im,
    float* ore, float* oim, const int* sched, int es, int weave, int E, int S,
    int G, int R, int n, unsigned* sync, void* stream) {
  const Args a = {kind,    tq,      cq,      slot,    angles, re,
                  im,      ore,     oim,     nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, sched,  es,
                  weave,   E,       S,       G,       R,      n,
                  sync};
  return tape_sweep::fwd_launch<C>(kKernels, a, stream);
}

// Adjoint: from the forward output (ore, oim) and the cotangents (gre,
// gim), all (E, S, D) float, into dre / dim (E, S, D; both may be null: the
// psi0 cotangents are then not written) and dang (E, S, R); the tapes,
// sched, es, weave and sync as the forward's.  Scratch from the caller:
// pre / pim / lre / lim (E, S, D) float each (null where a row is whole),
// gpart (E S x G x chunks a row) float.  The segment launch, then the
// gradient launch.
int apply_tape_sweep_bwd_launch(const int* kind, const int* tq, const int* cq,
    const int* slot, const float* angles, const float* ore, const float* oim,
    const float* gre, const float* gim, float* dre, float* dim, float* dang,
    const int* sched, int es, int weave, float* pre, float* pim, float* lre,
    float* lim, float* gpart, int E, int S, int G, int R, int n, unsigned* sync,
    void* stream) {
  const Args a = {kind, tq, cq, slot, angles, ore, oim, pre,
                  pim, gre, gim, lre, lim, dre, dim, gpart,
                  sched, es, weave, E, S, G, R, n, sync};
  return tape_sweep::bwd_launch<C>(kKernels, a, dang, stream);
}

}  // extern "C"
