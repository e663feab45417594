// Each env's own gate tape on its block of states, forward (B3f) and
// adjoint (B3b), in double precision, for 1 <= n <= 20 qubits (CUDA,
// sm_90a): the tape kernels of the composed engine under complex128
// (EnvConfig.sim_dtype = 'complex128', the CLI's --sim_dtype).
//
// Replaces the TPU kernels tensorrl_qas_tpu/ops/pallas_apply.py:_fwd_kernel
// (launched by _call_fwd) and _bwd_kernel (launched by _call_bwd, the
// custom_vjp backward of apply_tape_pallas_ri), which the JAX package runs
// at the dtype of its planes.  The plain PyTorch versions of the same
// functions are tensorrl_qas_tpu_torch/ops/apply_tape.py:
// apply_tape_fwd_plain and apply_tape_bwd_plain (any float dtype);
// apply_tape.cu and apply_tape_sweep.cu compute the same on float planes.
// What is computed, for each (env e, start s) row:
//   forward:  psi = tape_e(angles[e, s]) psi0[e, s]
//   adjoint:  from the output psi and lambda = gre - i gim, each gate g,
//             last first: dang[e, s, slot_g] += 1/2 Im[(P_g psi)^T lambda],
//             psi <- U_g^H psi, lambda <- U_g^T lambda; then
//             (dre, dim) = (Re lambda, -Im lambda).
// Gate kinds: the 1-qubit gates (RX, RY, RZ, X, Y, Z, H; controlled when
// cq >= 0), CX, RXX / RYY / RZZ = exp(-i theta/2 P_t P_c) (cq the second
// qubit), and the error Paulis of a woven tape (optim/angle_opt.py:
// extend_tape_arrays, weave 3: gate g at 3 g, its errors on its target and
// control at 3 g + 1 and 3 g + 2).
//
// Design: apply_tape_sweep.cu's, in double: tape_sweep.cuh, the body the
// two sources share, instantiated here for double planes and angles.  The
// float kernels below 17 qubits hold a row in registers (202-255 a thread
// already in float); doubled state would spill, so this instance keeps
// every row in device memory and takes chunks of it into shared memory:
//   - At n <= kWholeBits (12) a chunk is the whole row: the tape is one
//     segment of all its gates, a CTA takes one row (a thread a pair, from
//     one warp to 256), and a call is one launch (the adjoint one more,
//     the fixed-order gradient sum).  No schedule.
//   - Above, chunks of 2^kChunkBits amplitudes and the tape cut into
//     segments by segments.cuh's rule, which the schedule kernel writes
//     once per tape; a call is one cooperative launch of a persistent grid
//     that walks every (pass, row, chunk) item (the adjoint one more
//     launch, the gradient sum).
//   - kChunkBits = 12: a segment holds 7 qubits above qubit 4, so a
//     20-qubit tape needs fewer segments -- each a pass over its row in
//     device memory -- than at 11 (22 env-segments against ~27 on the
//     checks' 20q tapes).  The forward's two 64 KB chunk buffers (psi)
//     take ~145 KB of shared memory, one CTA an SM, so the next chunk
//     loads while the gates run; the adjoint's psi and mu take 128 KB a
//     chunk, one buffer.  The wrappers ask the runtime for the CTAs the
//     card holds (apply_tape_f64_resident_ctas).
// All amplitude arithmetic is double FMA.
//
// Bound.  Bytes the function must move: the planes in and out once
// (forward 4, adjoint 6 planes of E S D doubles, the adjoint's psi0
// cotangents included), twice the float kernels' bytes; at 20 qubits, E =
// 8, S = 4 that is 1074 MB forward, 0.32 ms at the card's 3.35 TB/s, and
// 1611 MB adjoint, 0.48 ms.  Operations (an RX is 6 flops an amplitude) at
// the card's ~34 TFLOP/s of FP64 stay below that.  What the design moves:
// each segment reads and writes its row once (the adjoint psi and mu),
// with a CTA barrier a gate.  chip_smoke.py prints the bound at its
// shapes.

#include "tape_sweep.cuh"

// The chunk's most qubits.  The host tests compile the source with smaller
// chunks, so that small states cross many segments.
#ifndef APPLY_TAPE_F64_CHUNK_BITS
#define APPLY_TAPE_F64_CHUNK_BITS 12
#endif

namespace {

using C = tape_sweep::Cfg<double, APPLY_TAPE_F64_CHUNK_BITS, 1>;
using Args = tape_sweep::Args<double>;

__global__ void apply_tape_f64_schedule_kernel(const int* kind, const int* tq,
                                               const int* cq, int E, int G,
                                               int n, int* out) {
  tape_sweep::schedule<C>(kind, tq, cq, E, G, n, out);
}

__global__ void __launch_bounds__(tape_sweep::kThreads)
apply_tape_f64_fwd_row_kernel(Args a) {
  DYNAMIC_SHARED(apply_tape_f64_smem);
  tape_sweep::whole_row<C, false>(a, apply_tape_f64_smem);
}

__global__ void __launch_bounds__(tape_sweep::kThreads)
apply_tape_f64_bwd_row_kernel(Args a) {
  DYNAMIC_SHARED(apply_tape_f64_smem);
  tape_sweep::whole_row<C, true>(a, apply_tape_f64_smem);
}

__global__ void __launch_bounds__(C::sweep_threads(false),
                                    C::min_blocks(false))
apply_tape_f64_fwd_kernel(Args a) {
  DYNAMIC_SHARED(apply_tape_f64_smem);
  tape_sweep::sweep<C, false>(a, apply_tape_f64_smem);
}

__global__ void __launch_bounds__(C::sweep_threads(true),
                                    C::min_blocks(true))
apply_tape_f64_bwd_kernel(Args a) {
  DYNAMIC_SHARED(apply_tape_f64_smem);
  tape_sweep::sweep<C, true>(a, apply_tape_f64_smem);
}

__global__ void __launch_bounds__(tape_sweep::kThreads)
apply_tape_f64_bwd_grad_kernel(Args a, double* dang) {
  DYNAMIC_SHARED(apply_tape_f64_smem);
  tape_sweep::bwd_grad<C>(a, dang, apply_tape_f64_smem);
}

const tape_sweep::Kernels<C> kKernels = {
    apply_tape_f64_fwd_row_kernel, apply_tape_f64_bwd_row_kernel,
    apply_tape_f64_fwd_kernel,     apply_tape_f64_bwd_kernel,
    apply_tape_f64_bwd_grad_kernel, apply_tape_f64_schedule_kernel};

}  // namespace

extern "C" {

// The qubit counts these kernels take, and their chunk's qubits.
int apply_tape_f64_min_qubits() { return C::kMinQubits; }
int apply_tape_f64_max_qubits() { return tape_sweep::kMaxQubits; }
int apply_tape_f64_chunk_bits() { return C::kChunkBits; }

// The most segments a tape of G gates can have at n qubits (a call's
// items are at most E S chunks x that).
int apply_tape_f64_max_segments(int G, int n) {
  return tape_sweep::max_segments<C>(G, n);
}

// Threads of a CTA, and chunk buffers of a sweep CTA, of the forward
// (adjoint 0) or adjoint (1) kernel at n qubits.
int apply_tape_f64_threads(int adjoint, int n) {
  return C::threads(n, adjoint != 0);
}
int apply_tape_f64_stages(int adjoint) {
  return C::stages(adjoint != 0);
}

// Shared-memory bytes of one CTA of the forward (adjoint 0) or adjoint (1)
// kernel at n qubits; of the gradient kernel at G gates.
size_t apply_tape_f64_smem_bytes(int adjoint, int n) {
  return tape_sweep::smem_bytes<C>(adjoint != 0, n);
}

size_t apply_tape_f64_grad_smem_bytes(int G) {
  return tape_sweep::grad_smem_bytes<C>(G);
}

// The int32 sync words (zeroed by each call) a sweep call on `rows` rows
// takes from the caller.
int apply_tape_f64_sync_words(int rows) { return tape_sweep::sync_words(rows); }

// How many CTAs of the forward (adjoint 0) or adjoint (1) kernel an SM
// holds at once at n qubits, and the card (a sweep call's grid at most);
// 0 when none fits, or minus a CUDA error code.
int apply_tape_f64_ctas_per_sm(int adjoint, int n) {
  return tape_sweep::ctas_per_sm<C>(kKernels, adjoint, n);
}

int apply_tape_f64_resident_ctas(int adjoint, int n) {
  return tape_sweep::resident_ctas<C>(kKernels, adjoint, n);
}

const char* apply_tape_f64_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The segments of (E, G) noiseless tapes at n qubits (above the chunk's)
// into out (E x (3 G + 2) int32), one thread an env.
int apply_tape_f64_schedule_launch(const int* kind, const int* tq,
    const int* cq, int* out, int E, int G, int n, void* stream) {
  return tape_sweep::schedule_launch<C>(kKernels, kind, tq, cq, out, E, G,
                                        n, stream);
}

// Forward: re / im / ore / oim (E, S, D) double, tapes (E, weave x G) int32
// (weave 3: every gate followed by its error Paulis), angles (E, S, R)
// double, sched (es rows of the noiseless tapes' segments; env e reads row
// e % es; null where a row is whole), sync (apply_tape_f64_sync_words(E S)
// int32 of scratch; null where a row is whole).  One launch on `stream`;
// returns the first error (cudaGetLastError), 0 on success.
int apply_tape_f64_fwd_launch(const int* kind, const int* tq, const int* cq,
    const int* slot, const double* angles, const double* re, const double* im,
    double* ore, double* oim, const int* sched, int es, int weave, int E, int S,
    int G, int R, int n, unsigned* sync, void* stream) {
  const Args a = {kind,    tq,      cq,      slot,    angles, re,
                  im,      ore,     oim,     nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, sched,  es,
                  weave,   E,       S,       G,       R,      n,
                  sync};
  return tape_sweep::fwd_launch<C>(kKernels, a, stream);
}

// Adjoint: from the forward output (ore, oim) and the cotangents (gre,
// gim), all (E, S, D) double, into dre / dim (E, S, D; both may be null: the
// psi0 cotangents are then not written) and dang (E, S, R); the tapes,
// sched, es, weave and sync as the forward's.  Scratch from the caller:
// pre / pim / lre / lim (E, S, D) double each (null where a row is whole),
// gpart (E S x G x chunks a row) double.  The segment launch, then the
// gradient launch.
int apply_tape_f64_bwd_launch(const int* kind, const int* tq, const int* cq,
    const int* slot, const double* angles, const double* ore, const double* oim,
    const double* gre, const double* gim, double* dre, double* dim, double* dang,
    const int* sched, int es, int weave, double* pre, double* pim, double* lre,
    double* lim, double* gpart, int E, int S, int G, int R, int n, unsigned* sync,
    void* stream) {
  const Args a = {kind, tq, cq, slot, angles, ore, oim, pre,
                  pim, gre, gim, lre, lim, dre, dim, gpart,
                  sched, es, weave, E, S, G, R, n, sync};
  return tape_sweep::bwd_launch<C>(kKernels, a, dang, stream);
}

}  // extern "C"
