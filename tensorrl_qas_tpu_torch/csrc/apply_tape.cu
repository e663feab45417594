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
// What one CTA computes, for its (env e, start s) row (grid = E x S):
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
// Layout.  The rows are independent and share only their env's tape, so
// each row gets a CTA.  Its state lives in shared memory up to 13 qubits
// (psi: 8 D bytes forward; psi and lambda: 16 D bytes, 128 KB at 13
// qubits, adjoint); above that psi and lambda live in global memory (the
// output planes and a workspace the wrapper allocates), reached through
// L2, one code path over a pointer.  The tape rows and the row's cos / sin
// table (one sincosf per angle) are read into shared memory once.  A
// 1-qubit gate pairs amplitude i0 (target bit 0) with i1 = i0 | 2^t; a
// two-qubit rotation pairs i0 with i0 ^ 2^t ^ 2^c (the matching XX and YY
// exchange; RZZ is diagonal and takes the same pairs), where both carry
// the same ZZ eigenvalue z.  Each thread owns whole pairs, so a gate
// updates in place and needs one barrier.  The TPU kernel's lane rolls
// (_xor_lane), its permutation matmul (_xor2_pair) and its one-hot angle
// select (_theta_sel) become an index XOR and x[slot]; its lax.switch over
// gate classes becomes a branch on the kind.  A gradient row is summed in a
// fixed order (warp shuffles, then thread 0 over the warps, no atomics), so
// the kernels are deterministic.  All amplitude arithmetic is f32 FMA.
//
// Bound.  Per row and gate the forward reads and writes D amplitudes (12
// flops a pair for a rotation, a swap for CX / X), the adjoint twice that
// plus the gradient row; the planes are read and written once per launch.
// At the su4 8-qubit shapes (E = 128, S = 8, G = 30, D = 256) that is ~2
// MB of planes and ~30 MFLOP per launch: a few microseconds at the card's
// rates either way, so a launch is bound by its latency (one barrier per
// gate) and its launch overhead.  This first version is simple, not fast.

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"

namespace {

using namespace gates;

enum : int { kRXX = 9, kRYY = 10, kRZZ = 11 };

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
  extern __shared__ float smem[];
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
  extern __shared__ float smem[];
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

bool bad_shape(int E, int S, int G, int R, int n) {
  return E < 1 || S < 1 || G < 1 || R < 1 || n < 1 || n > 16;
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks them against the
// card's per-block limit before launching).
size_t apply_tape_fwd_smem_bytes(int G, int R, int n) {
  return fwd_smem_bytes(G, R, n);
}

size_t apply_tape_bwd_smem_bytes(int G, int R, int n) {
  return bwd_smem_bytes(G, R, n);
}

// Above this qubit count the adjoint needs a workspace of E x S x 2 x D
// floats for psi.
int apply_tape_smem_state_max_qubits() { return kSmemStateMaxQubits; }

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
                          void* stream) {
  if (bad_shape(E, S, G, R, n)) return (int)cudaErrorInvalidValue;
  const size_t bytes = fwd_smem_bytes(G, R, n);
  const int err = set_smem((const void*)apply_tape_fwd_kernel, bytes);
  if (err != 0) return err;
  apply_tape_fwd_kernel<<<E * S, threads_for(n), bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      kind, tq, cq, slot, angles, re, im, ore, oim, S, G, R, n);
  return (int)cudaGetLastError();
}

// Adjoint: from the forward output (ore, oim) and the cotangents (gre,
// gim), all (E, S, D) f32, into dre / dim (E, S, D) and dang (E, S, R).
// work is null up to apply_tape_smem_state_max_qubits() qubits, else
// E x S x 2 x D floats.
int apply_tape_bwd_launch(const int* kind, const int* tq, const int* cq,
                          const int* slot, const float* angles,
                          const float* ore, const float* oim,
                          const float* gre, const float* gim, float* dre,
                          float* dim, float* dang, float* work, int E, int S,
                          int G, int R, int n, void* stream) {
  if (bad_shape(E, S, G, R, n) || (work == nullptr) != state_in_smem(n))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = bwd_smem_bytes(G, R, n);
  const int err = set_smem((const void*)apply_tape_bwd_kernel, bytes);
  if (err != 0) return err;
  apply_tape_bwd_kernel<<<E * S, threads_for(n), bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      kind, tq, cq, slot, angles, ore, oim, gre, gim, dre, dim, dang, work,
      S, G, R, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
