// The depolarizing-error draw of the fused Adam kernels (fused_adam_v1.cu,
// fused_adam_v2.cu): Philox4x32-10 (Salmon et al., SC'11, with Random123's
// constants) and the map from its words to error-gate kinds.  The plain
// PyTorch twin, and the definition of the draw, are
// tensorrl_qas_tpu_torch/sim/noise.py (philox4x32, depolarizing_draw):
//   key = (seeds[e, 0], seeds[e, 1]), counter = (gate g, tag, 0, 0);
//   fire iff (w0 >> 8) < threshold, threshold = ceil(p 2^24) from the host;
//   c3 = ((w1 >> 8) * 3 >> 24) + 1, c15 = ((w2 >> 8) * 15 >> 24) + 1.
// Everything is integer arithmetic, so kernel and plain version draw the
// same errors bit for bit.  Replaces the TPU generator calls of
// tensorrl_qas_tpu/ops/pallas_opt.py:draw_noise / noise_kinds (and their
// twins in pallas_opt2d.py), whose bits no other device reproduces.
#pragma once

#include <cuda_runtime.h>

#include "gates.cuh"

namespace philox {

struct Words {
  unsigned w0, w1, w2, w3;
};

__device__ __forceinline__ Words philox4x32_10(Words c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.w0);
    const unsigned lo0 = 0xD2511F53u * c.w0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.w2);
    const unsigned lo1 = 0xCD9E8D57u * c.w2;
    c = {hi1 ^ c.w1 ^ k0, lo1, hi0 ^ c.w3 ^ k1, lo0};
  }
  return c;
}

// Error-gate kinds (k_t on the target, k_c on the control; 0 = none) after
// gate g of kind `kind` at `tag`: after RX/RY/RZ one of X/Y/Z with
// probability thr1 / 2^24, after CX one of the 15 non-identity Pauli pairs
// (code c15: c15 % 4 on the target, c15 / 4 on the control) with
// probability thr2 / 2^24.
__device__ __forceinline__ void error_kinds(int kind, int g, int tag,
                                            unsigned key0, unsigned key1,
                                            unsigned thr1, unsigned thr2,
                                            int& kt, int& kc) {
  using namespace gates;
  kt = 0;
  kc = 0;
  const bool rot = kind >= kRX && kind <= kRZ;
  const bool cx = kind == kCX;
  if (!rot && !cx) return;
  const Words w =
      philox4x32_10({(unsigned)g, (unsigned)tag, 0u, 0u}, key0, key1);
  const unsigned u = w.w0 >> 8;
  if (rot && u < thr1) {
    kt = kX - 1 + (int)(((w.w1 >> 8) * 3u) >> 24) + 1;
  } else if (cx && u < thr2) {
    const int c15 = (int)(((w.w2 >> 8) * 15u) >> 24) + 1;
    kt = (c15 & 3) ? kX - 1 + (c15 & 3) : 0;
    kc = (c15 >> 2) ? kX - 1 + (c15 >> 2) : 0;
  }
}

// Pauli k (kX / kY / kZ) on the amplitude pair (a0, a1) whose qubit bit is
// 0 / 1; with kTranspose its transpose (Y^T = -Y; X, Z symmetric), which
// carries the adjoint cotangent back.  Swaps and signs only: exact.
template <bool kTranspose>
__device__ __forceinline__ void pauli_pair(int k, float& a0r, float& a0i,
                                           float& a1r, float& a1i) {
  using namespace gates;
  if (k == kX) {
    const float tr = a0r, ti = a0i;
    a0r = a1r;
    a0i = a1i;
    a1r = tr;
    a1i = ti;
  } else if (k == kY) {                  // (a0, a1) -> (-i a1, i a0)
    const float s = kTranspose ? -1.f : 1.f;
    const float n0r = s * a1i, n0i = -s * a1r;
    const float n1r = -s * a0i, n1i = s * a0r;
    a0r = n0r;
    a0i = n0i;
    a1r = n1r;
    a1i = n1i;
  } else if (k == kZ) {
    a1r = -a1r;
    a1i = -a1i;
  }
}

}  // namespace philox
