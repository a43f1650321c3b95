// The shared-memory layout and the two products of a flash forward on the
// wgmma machinery of wgmma_tile.cuh, shared by K1f (flash_fwd.cu, 128-key
// tiles) and the race's two-pass kernels (flash_probe.cu, key tiles of 64
// or 128).
//
// A consumer warpgroup owns 64 rows of a QM-row Q tile.  S = Q K^T takes
// both operands from shared memory, K-major; O += P V takes P from
// registers (the A fragments frag_a rounds from the f32 scores) and V from
// shared memory, MN-major.  Both are issued, not committed: the caller
// commits and waits, so that one product can run under the other's
// softmax.
#pragma once

#include "wgmma_tile.cuh"

namespace ff {
namespace wg {

// Shared memory of a forward CTA: the QM-row Q tile, then S stages of
// BN-row K tiles and S of V tiles, the ring's barriers and the Q tile's,
// and 1024 bytes to align the base (tiles start on 1024 bytes).
template <int HDP, int QM, int BN, int S>
struct FwdSmem {
  using QT = Tile<HDP, QM>;
  using KT = Tile<HDP, BN>;
  static constexpr int kK = QT::kBytes;
  static constexpr int kV = kK + S * KT::kBytes;
  static constexpr int kBars = kV + S * KT::kBytes;
  static constexpr int kBytes = kBars + (int)sizeof(Ring<S>) + 8 + 1024;
};

// S (64 x BN per warpgroup, f32, BN / 2 floats per thread) = Q K^T, from
// the warpgroup's 64 rows of the Q tile qs (QM rows) and the K tile kt
// (BN rows).
template <int HDP, int QM, int BN>
__device__ __forceinline__ void issue_scores(float* s, const uint8_t* qs,
                                             const uint8_t* kt, int wgi) {
  using QT = Tile<HDP, QM>;
  using KT = Tile<HDP, BN>;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < BN / 64; ++nb) {
      mma_ss_n64(s + 32 * nb, QT::kmajor(qs, wgi * 64, kk),
                 KT::kmajor(kt, 64 * nb, kk), kk > 0);
    }
  }
}

// O += P V, P in registers (BN / 16 bf16 A fragments), V the tile vt (BN
// rows) read MN-major.
template <int HDP, int BN>
__device__ __forceinline__ void issue_pv(float (*acc)[Tile<HDP, BN>::kW / 2],
                                         const uint32_t (*pa)[4],
                                         const uint8_t* vt) {
  using KT = Tile<HDP, BN>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < KT::kPanels; ++p) {
      mma_rs<KT::kW>(acc[p], pa[kk], KT::mnmajor(vt, kk, p), 1);
    }
  }
}

}  // namespace wg
}  // namespace ff
