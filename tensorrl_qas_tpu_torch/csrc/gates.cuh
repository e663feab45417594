// Gate device functions shared by the fused Adam kernels (fused_adam_v1.cu,
// fused_adam_v2.cu): the CUDA counterpart of _gate_class / _gate_coeffs of
// tensorrl_qas_tpu/ops/pallas_apply.py for the 1-qubit gate kinds and CX.
// RXX/RYY/RZZ are not taken here; the wrappers reject them.
#pragma once

#include <cuda_runtime.h>

namespace gates {

// circuits/tape.py GateKind
enum : int { kNone = 0, kRX = 1, kRY = 2, kRZ = 3, kCX = 4, kX = 5, kY = 6,
             kZ = 7, kH = 8 };

// One tape: per gate its kind, target qubit, control qubit (-1: none) and
// angle slot (-1: no angle).
struct Tape {
  const int* kind;
  const int* tq;
  const int* cq;
  const int* slot;
};

struct Coef {
  float u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i;
};

// 2x2 unitary of a gate kind; c = cos(theta/2), s = sin(theta/2).
__device__ __forceinline__ Coef gate_coef(int k, float c, float s) {
  switch (k) {
    case kRX: return {c, 0.f, 0.f, -s, 0.f, -s, c, 0.f};
    case kRY: return {c, 0.f, -s, 0.f, s, 0.f, c, 0.f};
    case kRZ: return {c, -s, 0.f, 0.f, 0.f, 0.f, c, s};
    case kCX:
    case kX: return {0.f, 0.f, 1.f, 0.f, 1.f, 0.f, 0.f, 0.f};
    case kY: return {0.f, 0.f, 0.f, -1.f, 0.f, 1.f, 0.f, 0.f};
    case kZ: return {1.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f, 0.f};
    case kH: {
      const float r = 0.70710678118654752f;
      return {r, 0.f, r, 0.f, r, 0.f, -r, 0.f};
    }
    default: return {1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f};
  }
}

// (ar + i ai) * (br + i bi) + (cr + i ci) * (dr + i di)
__device__ __forceinline__ void cmul2(float ar, float ai, float br, float bi,
                                      float cr, float ci, float dr, float di,
                                      float& outr, float& outi) {
  outr = ar * br - ai * bi + cr * dr - ci * di;
  outi = ar * bi + ai * br + cr * di + ci * dr;
}

// Index of the q-th amplitude whose bit t is 0 (the low half of pair q).
__device__ __forceinline__ int pair_low(int q, int t) {
  return ((q >> t) << (t + 1)) | (q & ((1 << t) - 1));
}

// Generator P of a rotation applied to the post-gate pair (a0, a1):
// X (a1, a0), Y (-i a1, i a0), Z (a0, -a1).
__device__ __forceinline__ void generator(int k, float a0r, float a0i,
                                          float a1r, float a1i, float& q0r,
                                          float& q0i, float& q1r,
                                          float& q1i) {
  if (k == kRX) {
    q0r = a1r; q0i = a1i; q1r = a0r; q1i = a0i;
  } else if (k == kRY) {
    q0r = a1i; q0i = -a1r; q1r = -a0i; q1i = a0r;
  } else {
    q0r = a0r; q0i = a0i; q1r = -a1r; q1i = -a1i;
  }
}

}  // namespace gates
