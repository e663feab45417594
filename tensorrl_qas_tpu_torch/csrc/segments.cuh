// The segments of the sweep kernels (fused_adam_v2_sweep.cu, B2 at 19-20
// qubits; apply_tape_sweep.cu, B3f / B3b at 17-20): a tape cut into runs of
// consecutive live gates whose qubits, with qubits 0..4, fit one chunk of
// 2^kChunkBits amplitudes, and a chunk's amplitudes in a segment.  Twin of
// the rule: tensorrl_qas_tpu_torch/ops/fused_adam2d.py:sweep_segments, word
// for word.
#pragma once

#include <cuda_runtime.h>

namespace segments {

constexpr int kLaneQubits = 5;          // local in every segment

// Schedule words of one tape of one env: [0] the segments, [1 .. G + 1]
// each segment's first index into the live-gate list and the end,
// [G + 2 .. 2 G + 1] each segment's local-qubit mask, [2 G + 2 .. 3 G + 1]
// the live gates in tape order; -1 where unused.
__host__ __device__ __forceinline__ int words(int G) { return 3 * G + 2; }

// The lowest qubits not in `m` added until it holds kChunkBits.
template <int kChunkBits>
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

// Env e's segments of the (E, G) tape (kind, tq, cq) into `w` (words(G)
// ints), by one thread: each live gate joins the current segment unless
// its qubits above qubit 4 (a control or a two-qubit rotation's second
// qubit included) would give the segment more than kChunkBits - 5; then a
// new segment starts.  A tape with no live gate has one empty segment.
template <int kChunkBits>
__device__ void build(const int* kind, const int* tq, const int* cq, int e,
                      int G, int n, int* w) {
  for (int k = 0; k < words(G); ++k) w[k] = -1;
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
    if (__ldg(kind + at) == 0) continue;
    const int t = __ldg(tq + at), c = __ldg(cq + at);
    unsigned q = 1u << t;
    if (c >= 0) q |= 1u << c;
    q &= ~low;
    if (nl > begin[nseg] && __popc(cur | q) > room) {
      mask[nseg] = (int)fill_local<kChunkBits>(low | cur, n);
      begin[++nseg] = nl;
      cur = 0;
    }
    cur |= q;
    live[nl++] = g;
  }
  mask[nseg] = (int)fill_local<kChunkBits>(low | cur, n);
  begin[++nseg] = nl;
  w[0] = nseg;
}

// Local bit of qubit q in a segment's mask.
__device__ __forceinline__ int local_bit(unsigned mask, int q) {
  return __popc(mask & ((1u << q) - 1u));
}

// The global index of chunk `chunk`'s first amplitude (chunk bit b ->
// qubit nq[b]) and of its local amplitude l (local bit b -> qubit lq[b]).
template <int kChunkBits>
__device__ __forceinline__ int chunk_base(const int* nq, int chunk, int n) {
  int i = 0;
  for (int b = 0; b < n - kChunkBits; ++b) i |= ((chunk >> b) & 1) << nq[b];
  return i;
}

template <int kChunkBits>
__device__ __forceinline__ int local_index(const int* lq, int l) {
  int i = l & ((1 << kLaneQubits) - 1);
#pragma unroll
  for (int b = kLaneQubits; b < kChunkBits; ++b)
    i |= ((l >> b) & 1) << lq[b];
  return i;
}

}  // namespace segments
