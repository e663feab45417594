// csim: compact C++ statevector engine on the host.
//
// The port's copy of the JAX package's native engine (the same source and
// flags give the same float64 costs bit for bit), filling the role qulacs
// (C++/SIMD) plays for the reference (SURVEY.md section 2.2):
//   1. an independent oracle for cross-checking the simulators,
//   2. the host backend of the noiseless COBYLA optimizer (each scipy
//      iterate evaluates here with no device round trip).
//
// Same conventions as sim/apply.py: little-endian (qubit q = bit q),
// qiskit rotation signs, gate tape of (kind, target, control, angle_slot)
// with NONE-padding; Pauli sums in (flip, sign_mask, iphase) mask form.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC csim.cpp -o libcsim.so
// (ops/build.py:build_host builds it on demand into build/, and
// native/__init__.py binds it).

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

using cplx = std::complex<double>;

namespace {

enum Kind : int32_t {
  NONE = 0, RX = 1, RY = 2, RZ = 3, CX = 4, X = 5, Y = 6, Z = 7, H = 8,
  RXX = 9, RYY = 10, RZZ = 11
};

struct U2 {
  cplx u00, u01, u10, u11;
};

U2 gate_matrix(int32_t kind, double theta) {
  const double c = std::cos(0.5 * theta), s = std::sin(0.5 * theta);
  const cplx i(0.0, 1.0);
  switch (kind) {
    case RX: return {c, -i * s, -i * s, c};
    case RY: return {c, -s, s, c};
    case RZ: return {c - i * s, 0.0, 0.0, c + i * s};
    case CX:
    case X:  return {0.0, 1.0, 1.0, 0.0};
    case Y:  return {0.0, -i, i, 0.0};
    case Z:  return {1.0, 0.0, 0.0, -1.0};
    case H: {
      const double r = 1.0 / std::sqrt(2.0);
      return {r, r, r, -r};
    }
    default: return {1.0, 0.0, 0.0, 1.0};
  }
}

inline void apply_controlled_1q(cplx* psi, int64_t dim, const U2& u,
                                int32_t target, int32_t control) {
  const int64_t tmask = int64_t(1) << target;
  const int64_t cmask = control >= 0 ? (int64_t(1) << control) : 0;
  // iterate over pairs (i, i | tmask) with target bit 0 in i
  for (int64_t base = 0; base < dim; ++base) {
    if (base & tmask) continue;
    if (cmask && !(base & cmask)) continue;
    const int64_t hi = base | tmask;
    const cplx a = psi[base], b = psi[hi];
    psi[base] = u.u00 * a + u.u01 * b;
    psi[hi] = u.u10 * a + u.u11 * b;
  }
}

// exp(-i theta (P (x) P) / 2) on (qa, qb), P in {X, Y, Z} — the SU(4)
// action-set rotations (same flip-and-phase form as sim/apply.py
// _apply_two_pauli_rot).  Both mask bits flip together, so the pair
// members share the parity phase.
inline void apply_two_pauli_rot(cplx* psi, int64_t dim, int32_t kind,
                                double theta, int32_t qa, int32_t qb) {
  const double c = std::cos(0.5 * theta), s = std::sin(0.5 * theta);
  const cplx mis(0.0, -s);  // -i sin(t/2)
  const int64_t amask = int64_t(1) << qa, bmask = int64_t(1) << qb;
  const int64_t mask = amask | bmask;
  if (kind == RZZ) {  // diagonal: phase by (-1)^parity
    for (int64_t i = 0; i < dim; ++i) {
      const double sign = ((i & amask) != 0) ^ ((i & bmask) != 0) ? -1. : 1.;
      psi[i] *= (c + mis * sign);
    }
    return;
  }
  for (int64_t i = 0; i < dim; ++i) {
    if (i & amask) continue;            // canonical pair member: qa bit 0
    const int64_t j = i ^ mask;
    const double p = (i & bmask) ? 1.0 : 0.0;   // shared pair parity
    const double ph = kind == RYY ? (2.0 * p - 1.0) : 1.0;  // XX: +1
    const cplx a = psi[i], b = psi[j];
    psi[i] = c * a + mis * ph * b;
    psi[j] = c * b + mis * ph * a;
  }
}

// splitmix64: tiny deterministic PRNG for trajectory sampling (seeded per
// energy evaluation; every qulacs evaluation samples noise afresh, so the
// COBYLA inner loop sees a new trajectory per iterate).
struct Rng64 {
  uint64_t s;
  explicit Rng64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
    return lo + int64_t(next() % uint64_t(hi - lo));
  }
};

inline void apply_pauli(cplx* psi, int64_t dim, int code, int32_t q) {
  // code: 0 = identity, 1/2/3 = X/Y/Z (qulacs DepolarizingNoise table)
  if (code == 0) return;
  const int32_t kind = code == 1 ? X : code == 2 ? Y : Z;
  apply_controlled_1q(psi, dim, gate_matrix(kind, 0.0), q, -1);
}

inline int parity64(uint64_t v) {
#if defined(__GNUC__)
  return __builtin_parityll(v);
#else
  v ^= v >> 32; v ^= v >> 16; v ^= v >> 8; v ^= v >> 4; v ^= v >> 2;
  v ^= v >> 1;
  return int(v & 1);
#endif
}

}  // namespace

extern "C" {

// Apply a gate tape in place to the interleaved complex state (re, im).
void csim_apply_tape(int32_t n_qubits, const int32_t* kind,
                     const int32_t* tq, const int32_t* cq,
                     const int32_t* slot, int32_t n_gates,
                     const double* angles, double* state /* 2*2^n */) {
  cplx* psi = reinterpret_cast<cplx*>(state);
  const int64_t dim = int64_t(1) << n_qubits;
  for (int32_t g = 0; g < n_gates; ++g) {
    if (kind[g] == NONE) continue;
    const double theta = slot[g] >= 0 ? angles[slot[g]] : 0.0;
    if (kind[g] >= RXX && kind[g] <= RZZ) {
      apply_two_pauli_rot(psi, dim, kind[g], theta, tq[g], cq[g]);
      continue;
    }
    const U2 u = gate_matrix(kind[g], theta);
    apply_controlled_1q(psi, dim, u, tq[g], cq[g]);
  }
}

// Apply a gate tape with depolarizing-trajectory noise, mirroring the
// reference's qulacs semantics (``VQE_qulacs_noise.py:32-54``): after every
// rotation, with probability p1 a uniform random Pauli on its target; after
// every CNOT, with probability p2 one of the 15 non-identity Pauli pairs on
// (control, target) (TwoQubitDepolarizingNoise convention).  Same channel
// layout as the JAX twin sim/noise.py:apply_tape_depolarizing.
void csim_apply_tape_depolarizing(int32_t n_qubits, const int32_t* kind,
                                  const int32_t* tq, const int32_t* cq,
                                  const int32_t* slot, int32_t n_gates,
                                  const double* angles, double p1, double p2,
                                  uint64_t seed, double* state) {
  cplx* psi = reinterpret_cast<cplx*>(state);
  const int64_t dim = int64_t(1) << n_qubits;
  Rng64 rng(seed);
  for (int32_t g = 0; g < n_gates; ++g) {
    if (kind[g] == NONE) continue;
    const double theta = slot[g] >= 0 ? angles[slot[g]] : 0.0;
    if (kind[g] >= RXX && kind[g] <= RZZ) {
      apply_two_pauli_rot(psi, dim, kind[g], theta, tq[g], cq[g]);
      continue;
    }
    const U2 u = gate_matrix(kind[g], theta);
    apply_controlled_1q(psi, dim, u, tq[g], cq[g]);
    if (kind[g] >= RX && kind[g] <= RZ) {
      if (rng.uniform() < p1)
        apply_pauli(psi, dim, int(rng.randint(1, 4)), tq[g]);
    } else if (kind[g] == CX && cq[g] >= 0) {
      if (rng.uniform() < p2) {
        const int j = int(rng.randint(1, 16));
        apply_pauli(psi, dim, j / 4, cq[g]);
        apply_pauli(psi, dim, j % 4, tq[g]);
      }
    }
  }
}

// <psi|H|psi> for a Pauli sum in mask form; iphase given as ny mod 4
// ((-i)^ny: 0 -> 1, 1 -> -i, 2 -> -1, 3 -> +i).
double csim_pauli_expectation(int32_t n_qubits, const double* state,
                              int32_t n_terms, const uint32_t* flip,
                              const uint32_t* sign_mask,
                              const int32_t* ny_mod4,
                              const double* weights) {
  const cplx* psi = reinterpret_cast<const cplx*>(state);
  const int64_t dim = int64_t(1) << n_qubits;
  static const cplx iphase_table[4] = {{1, 0}, {0, -1}, {-1, 0}, {0, 1}};
  double total = 0.0;
  for (int32_t k = 0; k < n_terms; ++k) {
    cplx acc(0.0, 0.0);
    const uint64_t f = flip[k], sm = sign_mask[k];
    for (int64_t idx = 0; idx < dim; ++idx) {
      const double sign = parity64(uint64_t(idx) & sm) ? -1.0 : 1.0;
      acc += std::conj(psi[idx]) * (sign * psi[idx ^ f]);
    }
    total += weights[k] * (iphase_table[ny_mod4[k] & 3] * acc).real();
  }
  return total;
}

// Convenience: energy of a tape applied to an initial state (the COBYLA
// inner loop), avoiding two boundary crossings per iterate.
double csim_tape_energy(int32_t n_qubits, const int32_t* kind,
                        const int32_t* tq, const int32_t* cq,
                        const int32_t* slot, int32_t n_gates,
                        const double* angles, const double* psi0,
                        int32_t n_terms, const uint32_t* flip,
                        const uint32_t* sign_mask, const int32_t* ny_mod4,
                        const double* weights, double* scratch) {
  const int64_t dim = int64_t(1) << n_qubits;
  std::memcpy(scratch, psi0, sizeof(double) * 2 * dim);
  csim_apply_tape(n_qubits, kind, tq, cq, slot, n_gates, angles, scratch);
  return csim_pauli_expectation(n_qubits, scratch, n_terms, flip, sign_mask,
                                ny_mod4, weights);
}

// Noisy twin of csim_tape_energy: one depolarizing trajectory per call
// (the reference's COBYLA optimizes a freshly-sampled noisy energy each
// iterate — seed should change per evaluation for protocol parity).
double csim_tape_energy_depolarizing(
    int32_t n_qubits, const int32_t* kind, const int32_t* tq,
    const int32_t* cq, const int32_t* slot, int32_t n_gates,
    const double* angles, double p1, double p2, uint64_t seed,
    const double* psi0, int32_t n_terms, const uint32_t* flip,
    const uint32_t* sign_mask, const int32_t* ny_mod4,
    const double* weights, double* scratch) {
  const int64_t dim = int64_t(1) << n_qubits;
  std::memcpy(scratch, psi0, sizeof(double) * 2 * dim);
  csim_apply_tape_depolarizing(n_qubits, kind, tq, cq, slot, n_gates,
                               angles, p1, p2, seed, scratch);
  return csim_pauli_expectation(n_qubits, scratch, n_terms, flip, sign_mask,
                                ny_mod4, weights);
}

}  // extern "C"
