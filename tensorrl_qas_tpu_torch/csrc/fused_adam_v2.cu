// Fused multi-start Adam env step with a flip-grouped Pauli H, one launch
// per env step (CUDA, sm_90a), for 7 <= n <= 18 qubits.
//
// Replaces the TPU kernel tensorrl_qas_tpu/ops/pallas_opt2d.py:_make_kernel
// (launched by fused_adam_step_pallas2d / _fused_adam_step_call2d), its
// noise variant (the same kernel launched with a non-null `seeds`;
// pallas_opt2d.py:draw_noise / apply_noise) and its per-env psi0 variant
// (per_env_psi0=True, pallas_opt2d.py:646-650, launched here with
// psi0_stride = D; see "Per-env psi0" below).  The gate device functions are
// gates.cuh, shared with fused_adam_v1.cu.  The plain PyTorch version of
// the same function is
// tensorrl_qas_tpu_torch/ops/fused_adam2d.py:fused_adam_step2d_reference.
//
// What one CTA computes, for its (env e, start s) (grid = E x S):
//   for it in 0..iters-1:                       (Adam over the OLD tape)
//     psi   = tape(x) psi0                       D amplitudes
//     Hpsi  = sum_f W_f * psi[i ^ f]             flip-group planes from L2
//     E     = Re<psi|H psi> / <psi|psi>          best-iterate tracking
//     dx    = adjoint sweep, lambda = 2 conj(H psi), masked by `active`
//     x     = Adam(x, dx)                        bias-corrected
//   final re-check of x; the start's best (x, E) goes to global memory.
// The last CTA of each env to finish (a per-env arrival counter) then picks
// the first start of least energy as x_opt, remaps it onto the new tape
// (x_new[j] = x_opt[map[j]], map -1 -> 0) and computes e_new = E(new tape,
// x_new), so an env step is one launch.
//
// Layout.  Adam's starts are independent until the argmin, so each start
// gets a CTA of its own: 128 CTAs on 132 SMs at 12 qubits, E = 16, S = 8.
// The CTA's psi and lambda (re and im planes, 16 D bytes) live in shared
// memory up to 13 qubits (64 KB at 12, 128 KB at 13) and, above that, in
// the CTA's slice of a global workspace that the wrapper allocates (256 KB
// to 4 MB a start), reached through L2; one code path over a pointer
// serves both.  The tapes, the angle map and the flip masks are read into
// shared memory once.  A gate pairs amplitude i0 (target bit 0) with
// i1 = i0 | 2^t; each thread owns whole pairs, so a gate updates in place
// and needs one barrier.  H psi is one pass: thread i sums
// W_f[i] psi[i ^ f] over the flip groups f, with the W planes (read-only,
// shared by every CTA: 2.75 MB at 12-qubit LiH, 37.7 MB at 18-qubit
// Heisenberg) read through __ldg from L2, and writes lambda[i].  Energy
// sums are block reductions in double; gradient rows are warp shuffles
// plus one shared-memory atomic per warp.  All amplitude arithmetic is f32
// FMA: no tensor-core TF32 or bf16, whose rounding exceeds the 1.6e-3 Ha
// acceptance threshold over a 40-gate tape.
//
// Bound.  Per start and Adam iteration: H psi is G_f D complex
// multiply-adds (8 flops each), forward and adjoint are 2x2 updates over
// D/2 pairs per gate (28 and 64 flops a pair).  At 12-qubit LiH (84 flip
// groups, ~60-gate mid-episode tapes) that is ~14 MFLOP per start per
// iteration, ~180 GFLOP per launch for E = 16, S = 8, 100 iterations:
// about 2.7 ms at the card's 67 TFLOP/s f32 rate; the inputs are a few MB,
// so operations bound it.  This first version is simple, not fast: one
// CTA per start, one barrier per gate, W from L2 on every H psi.  Staging
// W in shared memory, several CTAs per start (a cluster sharing psi) and
// fewer barriers are work for a later change.
//
// Noise.  With seeds every CTA of env e computes the env's depolarizing
// realization itself (philox.cuh: key = seeds[e], counter = (gate, tag)),
// once per tag -- Adam iteration `it`, `iters` for the final re-check,
// `iters + 1` for e_new -- into per-gate error kinds in shared memory.  The
// same (key, counter) gives every start the same draws, so one realization
// is shared by an env's starts without any communication, whether psi
// lives in shared memory or in the workspace.  A fired error is one more
// pass over the pairs of its qubit (a swap or a sign, one barrier) after
// the gate; the adjoint sweep undoes it on psi and transposes it onto
// lambda before the gate's own adjoint step.  As in fused_adam_v1.cu the
// variant is a block-uniform runtime flag, so that at p = 0 it is the
// noiseless kernel bit for bit (two template instances were not).
//
// Per-env psi0.  psi0_stride is the distance in floats between two envs'
// psi0 rows: 0 for one plane shared by the batch, D for (E, D) planes
// (block-coordinate trainable mode, where a frozen env starts from its
// cached prefix state).  Every CTA of env e copies row e into its psi,
// whether psi lives in shared memory or in the workspace; the stride is a
// runtime argument of the one kernel, so with identical rows the per-env
// launch is the shared launch bit for bit.  G (tape) and R (angles) are
// independent capacities: 244 gates and 211 angles for 12-qubit LiH in
// trainable mode, where the tapes embed the warm-start circuit.

#include <cuda_runtime.h>
#include <math.h>

#include "gates.cuh"
#include "philox.cuh"

namespace {

using namespace gates;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Largest qubit count whose psi and lambda (16 D bytes) stay in shared
// memory; above it they live in the global workspace.
constexpr int kSmemStateMaxQubits = 13;

struct Shared {
  double* red;   // 2 * kWarps energy partials
  float* pre;    // D: psi (shared memory or global workspace)
  float* pim;
  float* lre;    // D: lambda
  float* lim;
  float* x;      // R: iterate
  float* m;
  float* v;
  float* bx;     // best iterate
  float* dx;     // gradient
  float* ct;     // cos(x / 2)
  float* st;     // sin(x / 2)
  float* scal;   // [0] current energy, [1] best energy
  float* gpart;  // 2 x kWarps gradient partials (double-buffered)
  Tape old_tape;
  Tape new_tape;
  int* map;      // R
  int* flips;    // G_f
  int* flag;     // [0] last CTA of its env, [1] best start
  int* err_t;    // G error kinds on the target (noise variant)
  int* err_c;    // G error kinds on the control
};

// Error kinds of every gate of `tape` at `tag` into err_t / err_c; the
// caller's next barrier publishes them.
__device__ void draw_errors(const Shared& sh, const Tape& tape, int G,
                            const int* __restrict__ seeds, int e, int tag,
                            unsigned thr1, unsigned thr2) {
  const unsigned k0 = (unsigned)seeds[2 * e], k1 = (unsigned)seeds[2 * e + 1];
  for (int g = threadIdx.x; g < G; g += kThreads)
    philox::error_kinds(tape.kind[g], g, tag, k0, k1, thr1, thr2,
                        sh.err_t[g], sh.err_c[g]);
}

// Pauli k on qubit q: on psi (forward), or, with kAdjoint, undone on psi
// and transposed onto lambda.
template <bool kAdjoint>
__device__ void error_pass(const Shared& sh, int k, int q, int n) {
  const int half = 1 << (n - 1);
  for (int p = threadIdx.x; p < half; p += kThreads) {
    const int i0 = pair_low(p, q);
    const int i1 = i0 | (1 << q);
    philox::pauli_pair<false>(k, sh.pre[i0], sh.pim[i0], sh.pre[i1],
                              sh.pim[i1]);
    if (kAdjoint)
      philox::pauli_pair<true>(k, sh.lre[i0], sh.lim[i0], sh.lre[i1],
                               sh.lim[i1]);
  }
  __syncthreads();
}

// Both error Paulis of gate g (block-uniform: they live in shared memory).
template <bool kAdjoint>
__device__ void gate_errors(const Shared& sh, int g, int t, int c, int n) {
  if (sh.err_t[g]) error_pass<kAdjoint>(sh, sh.err_t[g], t, n);
  if (sh.err_c[g]) error_pass<kAdjoint>(sh, sh.err_c[g], c < 0 ? 0 : c, n);
}

// psi <- psi0, trig table of x, dx <- 0.
__device__ void begin_pass(const Shared& sh, const float* __restrict__ p0re,
                           const float* __restrict__ p0im, int D, int R) {
  for (int i = threadIdx.x; i < D; i += kThreads) {
    sh.pre[i] = __ldg(p0re + i);
    sh.pim[i] = __ldg(p0im + i);
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float s, c;
    sincosf(0.5f * sh.x[r], &s, &c);
    sh.st[r] = s;
    sh.ct[r] = c;
    sh.dx[r] = 0.f;
  }
  __syncthreads();
}

// psi <- tape(x) psi, each gate followed by its drawn errors in the noise
// variant.
__device__ void forward(const Shared& sh, const Tape& tape, int G, int n,
                        bool noise) {
  const int half = 1 << (n - 1);
  for (int g = 0; g < G; ++g) {
    const int k = tape.kind[g];
    if (k == kNone) continue;
    const int t = tape.tq[g], c = tape.cq[g], sl = tape.slot[g];
    const Coef u = sl >= 0 ? gate_coef(k, sh.ct[sl], sh.st[sl])
                           : gate_coef(k, 1.f, 0.f);
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int i0 = pair_low(p, t);
      if (c >= 0 && !((i0 >> c) & 1)) continue;
      const int i1 = i0 | (1 << t);
      const float a0r = sh.pre[i0], a0i = sh.pim[i0];
      const float a1r = sh.pre[i1], a1i = sh.pim[i1];
      float b0r, b0i, b1r, b1i;
      cmul2(u.u00r, u.u00i, a0r, a0i, u.u01r, u.u01i, a1r, a1i, b0r, b0i);
      cmul2(u.u10r, u.u10i, a0r, a0i, u.u11r, u.u11i, a1r, a1i, b1r, b1i);
      sh.pre[i0] = b0r;
      sh.pim[i0] = b0i;
      sh.pre[i1] = b1r;
      sh.pim[i1] = b1i;
    }
    __syncthreads();
    if (noise) gate_errors<false>(sh, g, t, c, n);
  }
}

// lambda <- 2 conj(H psi); scal[0] <- Re<psi|H psi> / <psi|psi>.
__device__ void h_energy(const Shared& sh, const float* __restrict__ wre,
                         const float* __restrict__ wim, int n_groups, int D) {
  double raw = 0.0, nn = 0.0;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float hr = 0.f, hi = 0.f;
    for (int f = 0; f < n_groups; ++f) {
      const int j = i ^ sh.flips[f];
      const float wr = __ldg(wre + (size_t)f * D + i);
      const float wi = __ldg(wim + (size_t)f * D + i);
      const float pr = sh.pre[j], pi = sh.pim[j];
      hr = fmaf(wr, pr, hr);
      hr = fmaf(-wi, pi, hr);
      hi = fmaf(wr, pi, hi);
      hi = fmaf(wi, pr, hi);
    }
    const float pr = sh.pre[i], pi = sh.pim[i];
    sh.lre[i] = 2.f * hr;
    sh.lim[i] = -2.f * hi;
    raw += (double)pr * hr + (double)pi * hi;
    nn += (double)pr * pr + (double)pi * pi;
  }
  for (int off = 16; off > 0; off >>= 1) {
    raw += __shfl_xor_sync(0xffffffffu, raw, off);
    nn += __shfl_xor_sync(0xffffffffu, nn, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh.red[2 * warp] = raw;
    sh.red[2 * warp + 1] = nn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a += sh.red[2 * w];
      b += sh.red[2 * w + 1];
    }
    sh.scal[0] = (float)(a / b);
  }
  __syncthreads();
}

// Keep the better of (x, E) and (bx, best E).
__device__ void track_best(const Shared& sh, int R) {
  const bool better = sh.scal[0] < sh.scal[1];
  if (better)
    for (int r = threadIdx.x; r < R; r += kThreads) sh.bx[r] = sh.x[r];
  __syncthreads();
  if (threadIdx.x == 0 && better) sh.scal[1] = sh.scal[0];
  __syncthreads();
}

// Adjoint sweep over the tape: undo each gate on psi (U^H), carry lambda
// back (U^T), and add 1/2 Im[(P psi)^T lambda] into dx[slot]; in the noise
// variant each gate's drawn errors are undone first.  A gradient row is
// summed in a fixed order (warp shuffles, then thread 0 over the warps),
// so the kernel is deterministic; the warp partials alternate between two
// buffers, which lets thread 0 sum gate g's while the others start on the
// next gate.
__device__ void backward(const Shared& sh, const Tape& tape, int G, int n,
                         bool noise) {
  const int half = 1 << (n - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int parity = 0;
  for (int g = G - 1; g >= 0; --g) {
    const int k = tape.kind[g];
    if (k == kNone) continue;
    const int t = tape.tq[g], c = tape.cq[g], sl = tape.slot[g];
    if (noise) gate_errors<true>(sh, g, t, c, n);
    float* gbuf = sh.gpart + parity * kWarps;
    parity ^= 1;
    const bool has_grad = sl >= 0 && (k == kRX || k == kRY || k == kRZ);
    const Coef u = sl >= 0 ? gate_coef(k, sh.ct[sl], sh.st[sl])
                           : gate_coef(k, 1.f, 0.f);
    float gp = 0.f;
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int i0 = pair_low(p, t);
      if (c >= 0 && !((i0 >> c) & 1)) continue;
      const int i1 = i0 | (1 << t);
      const float a0r = sh.pre[i0], a0i = sh.pim[i0];
      const float a1r = sh.pre[i1], a1i = sh.pim[i1];
      const float l0r = sh.lre[i0], l0i = sh.lim[i0];
      const float l1r = sh.lre[i1], l1i = sh.lim[i1];
      if (has_grad) {
        float q0r, q0i, q1r, q1i;
        generator(k, a0r, a0i, a1r, a1i, q0r, q0i, q1r, q1i);
        gp += 0.5f * (q0r * l0i + q0i * l0r + q1r * l1i + q1i * l1r);
      }
      float b0r, b0i, b1r, b1i;           // U^H (a0, a1)
      cmul2(u.u00r, -u.u00i, a0r, a0i, u.u10r, -u.u10i, a1r, a1i, b0r, b0i);
      cmul2(u.u01r, -u.u01i, a0r, a0i, u.u11r, -u.u11i, a1r, a1i, b1r, b1i);
      float m0r, m0i, m1r, m1i;           // U^T (l0, l1)
      cmul2(u.u00r, u.u00i, l0r, l0i, u.u10r, u.u10i, l1r, l1i, m0r, m0i);
      cmul2(u.u01r, u.u01i, l0r, l0i, u.u11r, u.u11i, l1r, l1i, m1r, m1i);
      sh.pre[i0] = b0r;
      sh.pim[i0] = b0i;
      sh.pre[i1] = b1r;
      sh.pim[i1] = b1i;
      sh.lre[i0] = m0r;
      sh.lim[i0] = m0i;
      sh.lre[i1] = m1r;
      sh.lim[i1] = m1i;
    }
    if (has_grad) {                       // block-uniform branch
      for (int off = 16; off > 0; off >>= 1)
        gp += __shfl_xor_sync(0xffffffffu, gp, off);
      if (lane == 0) gbuf[warp] = gp;
    }
    __syncthreads();
    if (has_grad && threadIdx.x == 0) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += gbuf[w];
      sh.dx[sl] += acc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_adam_v2_kernel(Tape old_g, Tape new_g, const int* __restrict__ map_idx,
                     const float* __restrict__ p0re,
                     const float* __restrict__ p0im,
                     const float* __restrict__ wre,
                     const float* __restrict__ wim,
                     const int* __restrict__ flips,
                     const float* __restrict__ starts,
                     const float* __restrict__ active,
                     const int* __restrict__ seeds,
                     float* __restrict__ x_opt, float* __restrict__ e_new,
                     float* best_x, float* best_e, unsigned int* arrived,
                     float* work, int S, int G, int R, int n, int n_groups,
                     int psi0_stride, int iters, float lr, double b1,
                     double b2, float omb1, float omb2, float eps,
                     unsigned thr1, unsigned thr2) {
  extern __shared__ double smem[];
  const bool noise = seeds != nullptr;
  const int D = 1 << n;
  const int e = blockIdx.x / S;
  const int row = blockIdx.x;             // e * S + s
  const float* p0r = p0re + (size_t)e * psi0_stride;   // this env's psi0
  const float* p0i = p0im + (size_t)e * psi0_stride;
  Shared sh;
  sh.red = smem;
  float* f = reinterpret_cast<float*>(smem + 2 * kWarps);
  float* state = f;
  if (work == nullptr) {
    f += 4 * D;
  } else {
    state = work + (size_t)row * 4 * D;
  }
  sh.pre = state;
  sh.pim = state + D;
  sh.lre = state + 2 * D;
  sh.lim = state + 3 * D;
  sh.x = f; f += R;
  sh.m = f; f += R;
  sh.v = f; f += R;
  sh.bx = f; f += R;
  sh.dx = f; f += R;
  sh.ct = f; f += R;
  sh.st = f; f += R;
  sh.scal = f; f += 2;
  sh.gpart = f; f += 2 * kWarps;
  int* ip = reinterpret_cast<int*>(f);
  int* tapes[8];
  for (int a = 0; a < 8; ++a) { tapes[a] = ip; ip += G; }
  sh.old_tape = {tapes[0], tapes[1], tapes[2], tapes[3]};
  sh.new_tape = {tapes[4], tapes[5], tapes[6], tapes[7]};
  sh.map = ip; ip += R;
  sh.flips = ip; ip += n_groups;
  sh.flag = ip; ip += 2;
  sh.err_t = ip; ip += noise ? G : 0;
  sh.err_c = ip;

  const int* src[8] = {old_g.kind, old_g.tq, old_g.cq, old_g.slot,
                       new_g.kind, new_g.tq, new_g.cq, new_g.slot};
  for (int idx = threadIdx.x; idx < 8 * G; idx += kThreads)
    tapes[idx / G][idx % G] = src[idx / G][(size_t)e * G + idx % G];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sh.map[r] = map_idx[(size_t)e * R + r];
    const float x0 = starts[(size_t)row * R + r];
    sh.x[r] = x0;
    sh.bx[r] = x0;
    sh.m[r] = 0.f;
    sh.v[r] = 0.f;
  }
  for (int q = threadIdx.x; q < n_groups; q += kThreads)
    sh.flips[q] = flips[q];
  if (threadIdx.x == 0) sh.scal[1] = INFINITY;
  __syncthreads();

  // b^t as a running product in double from the exact rates: the bias
  // corrections are then the plain version's 1 - b^t rounded once to
  // float (1.f - powf(0.999f, t) is off by 1.3e-5 relative at t = 1,
  // since 0.999f = 0.99900001)
  double b1t = 1.0, b2t = 1.0;
  const float b1f = (float)b1, b2f = (float)b2;
  for (int it = 0; it < iters; ++it) {
    if (noise) draw_errors(sh, sh.old_tape, G, seeds, e, it, thr1, thr2);
    begin_pass(sh, p0r, p0i, D, R);
    forward(sh, sh.old_tape, G, n, noise);
    h_energy(sh, wre, wim, n_groups, D);
    track_best(sh, R);
    backward(sh, sh.old_tape, G, n, noise);
    b1t *= b1;
    b2t *= b2;
    const float bc1 = (float)(1.0 - b1t);
    const float bc2 = (float)(1.0 - b2t);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const float gr = sh.dx[r] * active[(size_t)e * R + r];
      const float mm = b1f * sh.m[r] + omb1 * gr;
      const float vv = b2f * sh.v[r] + omb2 * gr * gr;
      const float mhat = mm / bc1;
      const float vhat = vv / bc2;
      sh.x[r] = sh.x[r] - lr * mhat / (sqrtf(vhat) + eps);
      sh.m[r] = mm;
      sh.v[r] = vv;
    }
    __syncthreads();
  }

  // the final iterate may beat the tracked best
  if (noise) draw_errors(sh, sh.old_tape, G, seeds, e, iters, thr1, thr2);
  begin_pass(sh, p0r, p0i, D, R);
  forward(sh, sh.old_tape, G, n, noise);
  h_energy(sh, wre, wim, n_groups, D);
  track_best(sh, R);

  for (int r = threadIdx.x; r < R; r += kThreads)
    best_x[(size_t)row * R + r] = sh.bx[r];
  if (threadIdx.x == 0) best_e[row] = sh.scal[1];
  __threadfence();                        // publish before arriving
  __syncthreads();
  if (threadIdx.x == 0) sh.flag[0] =
      atomicAdd(&arrived[e], 1u) == (unsigned int)(S - 1);
  __syncthreads();
  if (!sh.flag[0]) return;

  // last CTA of env e: the other starts' results are visible (L1 bypassed)
  __threadfence();
  if (threadIdx.x == 0) {                 // first minimum, as argmin
    int b = 0;
    float be = __ldcg(best_e + (size_t)e * S);
    for (int s = 1; s < S; ++s) {
      const float v = __ldcg(best_e + (size_t)e * S + s);
      if (v < be) {
        be = v;
        b = s;
      }
    }
    sh.flag[1] = b;
  }
  __syncthreads();
  const size_t best_row = (size_t)e * S + sh.flag[1];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float xo = __ldcg(best_x + best_row * R + r);
    x_opt[(size_t)e * R + r] = xo;
    sh.bx[r] = xo;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int mj = sh.map[r];
    sh.x[r] = mj >= 0 ? sh.bx[mj] : 0.f;  // x_new
  }
  __syncthreads();

  if (noise)                              // a fresh realization for e_new
    draw_errors(sh, sh.new_tape, G, seeds, e, iters + 1, thr1, thr2);
  begin_pass(sh, p0r, p0i, D, R);
  forward(sh, sh.new_tape, G, n, noise);
  h_energy(sh, wre, wim, n_groups, D);
  if (threadIdx.x == 0) e_new[e] = sh.scal[0];
}

bool state_in_smem(int n) { return n <= kSmemStateMaxQubits; }

size_t smem_bytes(int G, int R, int n, int n_groups, bool noise) {
  const size_t state = state_in_smem(n) ? (size_t)4 << n : 0;
  return sizeof(double) * 2 * kWarps +
         sizeof(float) * (state + (size_t)7 * R + 2 + 2 * kWarps) +
         sizeof(int) * ((size_t)(noise ? 10 : 8) * G + R + n_groups + 2);
}


}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks it against the
// card's per-block limit before launching); noise: the noise variant.
size_t fused_adam_v2_smem_bytes(int G, int R, int n, int n_groups,
                                int noise) {
  return smem_bytes(G, R, n, n_groups, noise != 0);
}

// Floats of global workspace for psi and lambda of E x S starts: 0 when
// they live in shared memory.
size_t fused_adam_v2_workspace_floats(int E, int S, int n) {
  return state_in_smem(n) ? 0 : (size_t)E * S * 4 << n;
}

const char* fused_adam_v2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs asynchronously on `stream`.  best_x (E, S, R) and best_e (E, S) are
// scratch; arrived (E,) must be zero; work is null or holds
// fused_adam_v2_workspace_floats(E, S, n) floats.  A non-null `seeds`
// (E x 2 int32) launches the noise variant with fire thresholds thr1
// (after rotations) and thr2 (after CX) out of 2^24.  psi0_stride is 0
// for (1, D) psi0 planes shared by the envs, D for (E, D) planes.  b1 and
// b2 are Adam's exact rates.
int fused_adam_v2_launch(const int* okind, const int* otq, const int* ocq,
                         const int* oslot, const int* nkind, const int* ntq,
                         const int* ncq, const int* nslot, const int* map_idx,
                         const float* p0re, const float* p0im,
                         const float* wre, const float* wim, const int* flips,
                         const float* starts, const float* active,
                         const int* seeds, float* x_opt, float* e_new,
                         float* best_x, float* best_e, unsigned int* arrived,
                         float* work, int E, int S, int G, int R, int n,
                         int n_groups, int psi0_stride, int iters, float lr,
                         double b1, double b2, float omb1, float omb2,
                         float eps, unsigned thr1, unsigned thr2,
                         void* stream) {
  if (E < 1 || S < 1 || G < 1 || R < 1 || n < 7 || n > 18 ||
      n_groups < 1 || iters < 0 || (work == nullptr) != state_in_smem(n) ||
      (psi0_stride != 0 && psi0_stride != 1 << n))
    return (int)cudaErrorInvalidValue;
  const Tape old_g = {okind, otq, ocq, oslot};
  const Tape new_g = {nkind, ntq, ncq, nslot};
  const size_t bytes = smem_bytes(G, R, n, n_groups, seeds != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      fused_adam_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_adam_v2_kernel<<<E * S, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      old_g, new_g, map_idx, p0re, p0im, wre, wim, flips, starts, active,
      seeds, x_opt, e_new, best_x, best_e, arrived, work, S, G, R, n,
      n_groups, psi0_stride, iters, lr, b1, b2, omb1, omb2, eps, thr1, thr2);
  return (int)cudaGetLastError();
}

}  // extern "C"
