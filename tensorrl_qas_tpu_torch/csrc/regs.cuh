// The register core of the fused Adam kernels (fused_adam_v1.cu,
// fused_adam_v2.cu): a thread holds 2^RB amplitudes of psi (and of lambda
// in the adjoint) in registers, Amps<RB>; the physical index of register j
// of thread t is (t << RB) | j, so physical bits [0, RB) pick the register
// and the bits above it the lane (and, in fused_adam_v2.cu, the warp).  A
// gate on a register bit needs no communication, one on a lane bit takes
// its partner by __shfl_xor_sync, and a control is a predicate on the
// thread's own index.  Each gate dispatches on one switch to a body whose
// register indices are constants (a runtime index would put the arrays in
// local memory), so every function here is __forceinline__.
#pragma once

#include <cuda_runtime.h>

#include "gates.cuh"
#include "philox.cuh"

namespace regs {

using namespace gates;

// The form of a gate's 2x2 matrix, which fixes the arithmetic a pair
// takes (8 FMAs forward where a general complex 2x2 takes 16):
//   kDiag  RZ, Z        u01 = u10 = 0
//   kReal  RY, H, X, CX every entry real
//   kAnti  RX, Y        u00, u11 real, u01, u10 imaginary
enum : int { kDiag = 0, kReal = 1, kAnti = 2 };

__device__ __forceinline__ int gate_form(int k) {
  if (k == kRZ || k == kZ) return kDiag;
  if (k == kRX || k == kY) return kAnti;
  return kReal;
}

// The one switch a gate dispatches on: 10 form + 5 control + slot, the
// slot the target's register bit (0 .. 3) or 4 for a lane bit.
__device__ __forceinline__ int gate_case(int k, bool ctl, int tp, int rb) {
  return 10 * gate_form(k) + 5 * ctl + (tp < rb ? tp : 4);
}

// Which parts of the diagonal and off-diagonal entries a form has, and the
// rotation of that form (whose generator its gradient takes).
template <int F>
struct Form {
  static constexpr bool kDiagIm = F == kDiag;
  static constexpr bool kOff = F != kDiag;
  static constexpr bool kOffRe = F == kReal;
  static constexpr bool kOffIm = F == kAnti;
  static constexpr int kRot = F == kDiag ? kRZ : F == kReal ? kRY : kRX;
};

// out += c * a with the parts of c that may be non-zero.
template <bool kRe, bool kIm>
__device__ __forceinline__ void cmac(float cr, float ci, float ar, float ai,
                                     float& outr, float& outi) {
  if (kRe) {
    outr = fmaf(cr, ar, outr);
    outi = fmaf(cr, ai, outi);
  }
  if (kIm) {
    outr = fmaf(-ci, ai, outr);
    outi = fmaf(ci, ar, outi);
  }
}

// b = d a + o q for a form F: d a diagonal entry, o an off-diagonal one.
template <int F>
__device__ __forceinline__ void combine(float dr, float di, float ar,
                                        float ai, float orr, float oi,
                                        float qr, float qi, float& br,
                                        float& bi) {
  using T = Form<F>;
  float r = 0.f, i = 0.f;
  cmac<true, T::kDiagIm>(dr, di, ar, ai, r, i);
  if (T::kOff) cmac<T::kOffRe, T::kOffIm>(orr, oi, qr, qi, r, i);
  br = r;
  bi = i;
}

// psi and lambda of one thread: 2^RB amplitudes each.
template <int RB>
struct Amps {
  float pr[1 << RB], pi[1 << RB];
  float lr[1 << RB], li[1 << RB];
};

// CALL with the constant A equal to the runtime register bit `a`: the
// register arrays are then indexed by constants only (a runtime index
// would put them in local memory).  Every function CALL reaches is
// __forceinline__, so the arrays stay in registers.
#define WITH_REG_BIT(a, CALL)                      \
  switch (a) {                                     \
    case 0: { constexpr int A = 0; CALL; } break;  \
    case 1: { constexpr int A = 1; CALL; } break;  \
    case 2: { constexpr int A = 2; CALL; } break;  \
    case 3: { constexpr int A = 3 < RB ? 3 : RB - 1; CALL; } break; \
    default: { constexpr int A = RB - 1; CALL; }   \
  }

// X(F, C, A) for every gate case (gate_case): form F, control C, slot A.
#define FOR_GATE_CASES(X)                                                  \
  X(0, 0, 0) X(0, 0, 1) X(0, 0, 2) X(0, 0, 3) X(0, 0, 4)                   \
  X(0, 1, 0) X(0, 1, 1) X(0, 1, 2) X(0, 1, 3) X(0, 1, 4)                   \
  X(1, 0, 0) X(1, 0, 1) X(1, 0, 2) X(1, 0, 3) X(1, 0, 4)                   \
  X(1, 1, 0) X(1, 1, 1) X(1, 1, 2) X(1, 1, 3) X(1, 1, 4)                   \
  X(2, 0, 0) X(2, 0, 1) X(2, 0, 2) X(2, 0, 3) X(2, 0, 4)                   \
  X(2, 1, 0) X(2, 1, 1) X(2, 1, 2) X(2, 1, 3) X(2, 1, 4)

// Register index of the low end of pair k of register bit A.
template <int A>
__device__ __forceinline__ constexpr int pair_j0(int k) {
  return ((k >> A) << (A + 1)) | (k & ((1 << A) - 1));
}

__device__ __forceinline__ float warp_sum(float v, unsigned mask, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v, unsigned mask,
                                           int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// Control predicate of amplitude j: control bit cp set; always true for
// an uncontrolled gate (kCtl false), which then takes no predicate.
template <bool kCtl>
__device__ __forceinline__ bool ctl_on(int cp, int pbase, int j) {
  return !kCtl || (((pbase | j) >> cp) & 1);
}

// psi <- U psi on register bit A for a gate of form F.
template <int RB, int A, int F, bool C>
__device__ __forceinline__ void reg_fwd(Amps<RB>& s, const Coef& u, int cp,
                                        int pbase) {
#pragma unroll
  for (int k = 0; k < (1 << (RB - 1)); ++k) {
    const int j0 = pair_j0<A>(k), j1 = j0 | (1 << A);
    if (!ctl_on<C>(cp, pbase, j0)) continue;
    const float a0r = s.pr[j0], a0i = s.pi[j0];
    const float a1r = s.pr[j1], a1i = s.pi[j1];
    combine<F>(u.u00r, u.u00i, a0r, a0i, u.u01r, u.u01i, a1r, a1i, s.pr[j0],
               s.pi[j0]);
    combine<F>(u.u11r, u.u11i, a1r, a1i, u.u10r, u.u10i, a0r, a0i, s.pr[j1],
               s.pi[j1]);
  }
}

// psi <- U psi on lane bit lb for a gate of form F: the partner by shuffle
// (none for a diagonal gate).
template <int RB, int F, bool C>
__device__ __forceinline__ void lane_fwd(Amps<RB>& s, const Coef& u, int lb,
                                         int cp, int pbase, unsigned mask) {
  const int beta = (threadIdx.x >> lb) & 1;
  // own row of U: (u00, u01) on bit 0, (u11, u10) on bit 1
  const float dr = beta ? u.u11r : u.u00r, di = beta ? u.u11i : u.u00i;
  const float orr = beta ? u.u10r : u.u01r, oi = beta ? u.u10i : u.u01i;
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    float qr = 0.f, qi = 0.f;
    if (Form<F>::kOff) {
      qr = __shfl_xor_sync(mask, s.pr[j], 1 << lb);
      qi = __shfl_xor_sync(mask, s.pi[j], 1 << lb);
    }
    if (ctl_on<C>(cp, pbase, j))
      combine<F>(dr, di, s.pr[j], s.pi[j], orr, oi, qr, qi, s.pr[j], s.pi[j]);
  }
}

// One gate case forward: a register bit A < RB, or the lane bit tp.
template <int RB, int F, bool C, int A>
__device__ __forceinline__ void fwd_case(Amps<RB>& s, const Coef& u, int tp,
                                         int cp, int pbase, unsigned mask) {
  if constexpr (A < RB)
    reg_fwd<RB, A, F, C>(s, u, cp, pbase);
  else
    lane_fwd<RB, F, C>(s, u, tp - RB, cp, pbase, mask);
}

// psi <- U psi for a gate of case `c` (gate_case) on physical bit tp (a
// register or lane bit), control bit cp (-1: none).
template <int RB>
__device__ __forceinline__ void gate_fwd(Amps<RB>& s, const Coef& u, int c,
                                         int tp, int cp, unsigned mask) {
  const int pbase = threadIdx.x << RB;
#define FWD_CASE(F, C, A)                                         \
  case 10 * (F) + 5 * (C) + (A):                                  \
    fwd_case<RB, F, (C) != 0, A>(s, u, tp, cp, pbase, mask);      \
    break;
  switch (c) { FOR_GATE_CASES(FWD_CASE) }
#undef FWD_CASE
}

// Adjoint step on register bit A for a gate of form F: psi <- U^H psi,
// lambda <- U^T lambda; returns this thread's part of the gradient row,
// 1/2 Im[(P psi)^T lambda] summed over its pairs with the generator of
// the form's rotation.  The term is computed for every gate (the caller
// drops it for gates without an angle): one body per case, not two.
template <int RB, int A, int F, bool C>
__device__ __forceinline__ float reg_adj(Amps<RB>& s, const Coef& u, int cp,
                                         int pbase) {
  float gps[2] = {0.f, 0.f};              // two chains of the row sum
#pragma unroll
  for (int kk = 0; kk < (1 << (RB - 1)); ++kk) {
    float& gp = gps[kk & 1];
    const int j0 = pair_j0<A>(kk), j1 = j0 | (1 << A);
    if (!ctl_on<C>(cp, pbase, j0)) continue;
    const float a0r = s.pr[j0], a0i = s.pi[j0];
    const float a1r = s.pr[j1], a1i = s.pi[j1];
    const float l0r = s.lr[j0], l0i = s.li[j0];
    const float l1r = s.lr[j1], l1i = s.li[j1];
    {                                     // see reg_adj's note
      float q0r, q0i, q1r, q1i;
      generator(Form<F>::kRot, a0r, a0i, a1r, a1i, q0r, q0i, q1r, q1i);
      gp += 0.5f * (q0r * l0i + q0i * l0r + q1r * l1i + q1i * l1r);
    }
    combine<F>(u.u00r, -u.u00i, a0r, a0i, u.u10r, -u.u10i, a1r, a1i,
               s.pr[j0], s.pi[j0]);
    combine<F>(u.u11r, -u.u11i, a1r, a1i, u.u01r, -u.u01i, a0r, a0i,
               s.pr[j1], s.pi[j1]);
    combine<F>(u.u00r, u.u00i, l0r, l0i, u.u10r, u.u10i, l1r, l1i, s.lr[j0],
               s.li[j0]);
    combine<F>(u.u11r, u.u11i, l1r, l1i, u.u01r, u.u01i, l0r, l0i, s.lr[j1],
               s.li[j1]);
  }
  return gps[0] + gps[1];
}

// The adjoint step on lane bit lb: each thread holds one end of every
// pair and adds its own half of the gradient row.
template <int RB, int F, bool C>
__device__ __forceinline__ float lane_adj(Amps<RB>& s, const Coef& u, int lb,
                                          int cp, int pbase, unsigned mask) {
  const int beta = (threadIdx.x >> lb) & 1;
  // own rows of U^H (psi) and U^T (lambda): bit 0 (u00*, u10*) and
  // (u00, u10), bit 1 (u11*, u01*) and (u11, u01)
  const float dr = beta ? u.u11r : u.u00r, di = beta ? u.u11i : u.u00i;
  const float orr = beta ? u.u01r : u.u10r, oi = beta ? u.u01i : u.u10i;
  float gps[2] = {0.f, 0.f};              // two chains of the row sum
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    float& gp = gps[j & 1];
    float qar = 0.f, qai = 0.f, qlr = 0.f, qli = 0.f;
    if (Form<F>::kOff) {
      qar = __shfl_xor_sync(mask, s.pr[j], 1 << lb);
      qai = __shfl_xor_sync(mask, s.pi[j], 1 << lb);
      qlr = __shfl_xor_sync(mask, s.lr[j], 1 << lb);
      qli = __shfl_xor_sync(mask, s.li[j], 1 << lb);
    }
    if (!ctl_on<C>(cp, pbase, j)) continue;
    const float ar = s.pr[j], ai = s.pi[j], lr = s.lr[j], li = s.li[j];
    {                                     // see reg_adj's note
      float q0r, q0i, q1r, q1i;
      if (beta)
        generator(Form<F>::kRot, qar, qai, ar, ai, q0r, q0i, q1r, q1i);
      else
        generator(Form<F>::kRot, ar, ai, qar, qai, q0r, q0i, q1r, q1i);
      gp += beta ? 0.5f * (q1r * li + q1i * lr) : 0.5f * (q0r * li + q0i * lr);
    }
    combine<F>(dr, -di, ar, ai, orr, -oi, qar, qai, s.pr[j], s.pi[j]);
    combine<F>(dr, di, lr, li, orr, oi, qlr, qli, s.lr[j], s.li[j]);
  }
  return gps[0] + gps[1];
}

// One gate case in the adjoint: a register bit A < RB, or the lane bit tp.
template <int RB, int F, bool C, int A>
__device__ __forceinline__ float adj_case(Amps<RB>& s, const Coef& u, int tp,
                                          int cp, int pbase, unsigned mask) {
  if constexpr (A < RB)
    return reg_adj<RB, A, F, C>(s, u, cp, pbase);
  else
    return lane_adj<RB, F, C>(s, u, tp - RB, cp, pbase, mask);
}

// Adjoint step of a gate of case `c` (see gate_fwd); returns this
// thread's part of the gradient row (meaningful for gates with an angle).
template <int RB>
__device__ __forceinline__ float gate_adj(Amps<RB>& s, const Coef& u, int c,
                                          int tp, int cp, unsigned mask) {
  const int pbase = threadIdx.x << RB;
  float gp = 0.f;
#define ADJ_CASE(F, C, A)                                             \
  case 10 * (F) + 5 * (C) + (A):                                      \
    gp = adj_case<RB, F, (C) != 0, A>(s, u, tp, cp, pbase, mask);     \
    break;
  switch (c) { FOR_GATE_CASES(ADJ_CASE) }
#undef ADJ_CASE
  return gp;
}

// Pauli k on the amplitude whose physical bit is `beta`, given its
// partner's; with kTranspose its transpose (philox.cuh:pauli_pair).
template <bool kTranspose>
__device__ __forceinline__ void pauli_one(int k, int beta, float& r, float& i,
                                          float pr, float pi) {
  if (k == kX) {
    r = pr;
    i = pi;
  } else if (k == kY) {                   // bit 0: -i a1; bit 1: i a0
    const float sg = (kTranspose ? -1.f : 1.f) * (beta ? -1.f : 1.f);
    r = sg * pi;
    i = -sg * pr;
  }
}

// Pauli k (X or Y) on register bit A.
template <int RB, int A, bool kAdjoint>
__device__ __forceinline__ void reg_pauli(Amps<RB>& s, int k) {
#pragma unroll
  for (int kk = 0; kk < (1 << (RB - 1)); ++kk) {
    const int j0 = pair_j0<A>(kk), j1 = j0 | (1 << A);
    philox::pauli_pair<false>(k, s.pr[j0], s.pi[j0], s.pr[j1], s.pi[j1]);
    if (kAdjoint)
      philox::pauli_pair<true>(k, s.lr[j0], s.li[j0], s.lr[j1], s.li[j1]);
  }
}

// Pauli k on physical bit `pos`: on psi (forward), or, with kAdjoint, undone
// on psi and transposed onto lambda.  On a warp bit X and Y go through
// `region` (4 D floats), with barriers before and after.
template <int RB, bool kAdjoint, bool kWarpBits = true>
__device__ __forceinline__ void pauli(Amps<RB>& s, int k, int pos,
                                      float* region, int D, unsigned mask) {
  const int tid = threadIdx.x, pbase = tid << RB;
  if (k == kZ) {                          // a sign: no partner on any bit
#pragma unroll
    for (int j = 0; j < (1 << RB); ++j)
      if (((pbase | j) >> pos) & 1) {
        s.pr[j] = -s.pr[j];
        s.pi[j] = -s.pi[j];
        if (kAdjoint) {
          s.lr[j] = -s.lr[j];
          s.li[j] = -s.li[j];
        }
      }
    return;
  }
  if (pos < RB) {
    WITH_REG_BIT(pos, (reg_pauli<RB, A, kAdjoint>(s, k)));
    return;
  }
  const int tb = pos - RB, beta = (tid >> tb) & 1;
  const int part = pbase ^ (1 << pos);
  const bool lane = !kWarpBits || tb < 5;
  if (!lane) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < (1 << RB); ++j) {
      region[pbase | j] = s.pr[j];
      region[D + (pbase | j)] = s.pi[j];
      if (kAdjoint) {
        region[2 * D + (pbase | j)] = s.lr[j];
        region[3 * D + (pbase | j)] = s.li[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < (1 << RB); ++j) {
    float qr, qi, mr = 0.f, mi = 0.f;
    if (lane) {
      qr = __shfl_xor_sync(mask, s.pr[j], 1 << tb);
      qi = __shfl_xor_sync(mask, s.pi[j], 1 << tb);
      if (kAdjoint) {
        mr = __shfl_xor_sync(mask, s.lr[j], 1 << tb);
        mi = __shfl_xor_sync(mask, s.li[j], 1 << tb);
      }
    } else {
      qr = region[part | j];
      qi = region[D + (part | j)];
      if (kAdjoint) {
        mr = region[2 * D + (part | j)];
        mi = region[3 * D + (part | j)];
      }
    }
    pauli_one<false>(k, beta, s.pr[j], s.pi[j], qr, qi);
    if (kAdjoint) pauli_one<true>(k, beta, s.lr[j], s.li[j], mr, mi);
  }
  if (!lane) __syncthreads();
}

}  // namespace regs
