// Flash-attention backward (K1b) for Hopper (sm_90a).
//
// Replaces the TPU kernels flexflow_tpu/ops/pallas_kernels.py::_dq_kernel and
// ::_dkv_kernel (launched by _bwd_call, the VJP of flash_attention_lse), and
// the delta preprocess _cotangent_delta_lanes; in bf16 also
// ::_dq_stream_kernel and ::_dkv_stream_kernel (launched by
// _bwd_stream_call, the streamed backward K1sb), whose sequential third
// grid axis is the tile loop inside each CTA of the wgmma pair below.
// Given q, k, v, the forward's o and lse, the output cotangent do and the
// optional lse cotangent g_lse:
//
//   delta = rowsum(o * do) - g_lse                      (f32)
//   p     = exp(s * scale - lse),  s = q k^T            (recomputed, f32)
//   ds    = p * (do v^T - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
//
// The cast points are the reference's: products of input-type operands
// accumulated in f32, the scale applied after the dot, p and ds rounded to
// the operand type before their products (p.astype(do.dtype) for dv,
// ds.astype(k/q.dtype) for dq/dk), dq/dk/dv accumulated in f32 and written
// in the input type.
//
// Two passes with no atomics, in both instantiations: two launches on the
// same inputs give the same bits.
//   1. dq: one CTA per (bh, q tile).  It first computes delta for its rows
//      from o and do (and g_lse), writes it to the delta buffer, then
//      streams the k/v tiles up to the causal diagonal.
//   2. dk/dv: one CTA per (bh, key tile), launched after pass 1 on the same
//      stream (it reads pass 1's delta); it streams the q/do tiles from the
//      diagonal on and computes the transposed score tile s^T = k q^T
//      directly, so no reduction crosses threads.
// Rows past t (a ragged last tile) are zero-filled and masked, so every
// t >= 1 runs; the causal loops skip the tiles above the diagonal.
//
// Bound.  Five t x t x hd products (s, dp, dq in pass 1; s^T, dp^T, dv, dk
// in pass 2, s and dp recomputed): 10 b h hd t^2 / 2 tensor-core FLOPs
// when causal, at long t bound by operations (0.174 ms at (16, 8, 2048,
// 64) bf16 against 0.032 ms of bytes).
//
// bf16: wgmma from TMA-fed shared memory (wg_dq_kernel, wg_dkv_kernel; the
// machinery of wgmma_tile.cuh).  CTAs of three warpgroups: a producer whose
// one thread keeps TMA loads in flight through an mbarrier ring (three
// stages, two where three do not fit) and gives its registers up
// (setmaxnreg), and two consumer warpgroups of 64 rows each, every product
// a wgmma on the f32 accumulators' registers:
//   dq pass, 128 query rows per CTA, 64-key K/V tiles streamed: S = Q K^T
//     and dP = dO V^T from shared memory; P = exp(S scale - lse) and dS =
//     P (dP - delta) on the accumulators; dS rounded to bf16 in registers
//     is the A operand of dQ += dS K (K read MN-major by the descriptor's
//     transpose bit); dQ scaled once at the end.
//   dk/dv pass, 128 key rows per CTA (64 per warpgroup: the dK and dV
//     accumulators take 128 registers a thread at hd 128), 64-row Q/dO
//     tiles and their lse/delta streamed: S^T = K Q^T, so P^T and dS^T come
//     out as A fragments; dV += P^T dO, dP^T = V dO^T, dK += dS^T Q.
// Each warpgroup stops at its own causal diagonal and skips the tiles its
// rows cannot see; the head dim is padded to a tile width of 32, 64 or 128
// (zero-filled by the tensor maps, masked at the stores, the scale from
// the true hd).
//
// The same pair is the kernel race's bf16 b2, replacing
// tools/probe_flash_bwd_variants.py::_bwd_call_lanes (:155; _dq_kernel_lanes
// :37, _dkv_kernel_lanes :91): its dq pass takes the caller's delta (the
// DIN instantiation) and reads neither o nor g_lse, and the race's block
// sets the rows of both passes' streamed tiles (ff_flash_bwd_row_state).
// Block 64 is K1b's tiling; block 128 streams 128-key K/V tiles in the dq
// pass (S and dP of 64 x 128 per warpgroup) and 128-row Q/dO tiles in the
// dk/dv pass, multiplied in two sub-tiles of 64 query columns (64 x 128
// S^T and dP^T would take 128 registers a thread beside dK and dV's).
//
// f32: the FMA kernels (flash_dq_kernel, flash_dkv_kernel): wgmma takes f32
// only as TF32.  128-thread CTAs over 64-row tiles staged through shared
// memory as f32 (16 row groups x 8 lanes; a thread owns 4 rows and 8
// strided columns of a 64 x 64 score tile and 4 rows x hd/8 columns of its
// accumulator).
#include "common.cuh"
#include "wgmma_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int kBlock = 64;     // q and k tile edge
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kRows = 4;       // tile rows per thread
constexpr int kCols = 8;       // score-tile columns per thread
constexpr int kPLd = kBlock + 1;

// Pass 1: dq and delta.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ g_lse, float* __restrict__ delta,
                T* __restrict__ dq, int t, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                   // kBlock x ld
  float* dos = qs + kBlock * ld;      // kBlock x ld
  float* ks = dos + kBlock * ld;      // kBlock x ld
  float* vs = ks + kBlock * ld;       // kBlock x ld
  float* dss = vs + kBlock * ld;      // kBlock x kPLd
  float* lse_s = dss + kBlock * kPLd; // kBlock
  float* delta_s = lse_s + kBlock;    // kBlock

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const size_t slab = (size_t)bh * t * hd;
  const size_t row_base = (size_t)bh * t;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int nj = hd / 8;

  ff::load_tile(qs, q + slab, q0, kBlock, t, hd, ld);
  ff::load_tile(dos, dout + slab, q0, kBlock, t, hd, ld);
  __syncthreads();

  // delta for this tile's rows: each row group reduces its 4 rows over its
  // 8 lanes (o read once from global memory, do from the staged tile).
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < t) {
      const T* orow = o + slab + (size_t)qp * hd;
      for (int d = tx; d < hd; d += 8) acc = fmaf(ff::to_float(orow[d]), dos[r * ld + d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tx == 0) {
      float dl = 0.f, ls = 0.f;
      if (qp < t) {
        dl = acc - (g_lse != nullptr ? g_lse[row_base + qp] : 0.f);
        ls = lse[row_base + qp];
        delta[row_base + qp] = dl;
      }
      delta_s[r] = dl;
      lse_s[r] = ls;
    }
  }

  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(t, q0 + kBlock) : t;
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    const int kn = min(kBlock, kend - k0);
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    ff::load_tile(ks, k + slab, k0, kn, t, hd, ld);
    ff::load_tile(vs, v + slab, k0, kn, t, hd, ld);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], dv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty * kRows + i) * ld + d];
        dv[i] = dos[(ty * kRows + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const float kv = c < kn ? ks[c * ld + d] : 0.f;
        const float vv = c < kn ? vs[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i], kv, s[i][j]);
          dp[i][j] = fmaf(dv[i], vv, dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qp = q0 + r;
      const float ls = lse_s[r], dl = delta_s[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool masked = kp >= kend || (causal && kp > qp);
        const float p = masked ? 0.f : expf(s[i][j] * scale - ls);
        dss[r * kPLd + tx + 8 * j] = ff::round_through<T>(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();  // dss complete

    for (int c = 0; c < kn; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(ty * kRows + i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float kv = ks[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= t) continue;
    T* row = dq + slab + (size_t)qp * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) row[tx + 8 * j] = ff::from_float<T>(acc[i][j] * scale);
    }
  }
}

// Pass 2: dk and dv.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int t, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* ks = smem;                     // kBlock x ld
  float* vs = ks + kBlock * ld;         // kBlock x ld
  float* qs = vs + kBlock * ld;         // kBlock x ld
  float* dos = qs + kBlock * ld;        // kBlock x ld
  float* pts = dos + kBlock * ld;       // kBlock x kPLd: p^T, rounded
  float* dsts = pts + kBlock * kPLd;    // kBlock x kPLd: ds^T, rounded
  float* lse_s = dsts + kBlock * kPLd;  // kBlock
  float* delta_s = lse_s + kBlock;      // kBlock

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const size_t slab = (size_t)bh * t * hd;
  const size_t row_base = (size_t)bh * t;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int nj = hd / 8;

  ff::load_tile(ks, k + slab, k0, kBlock, t, hd, ld);
  ff::load_tile(vs, v + slab, k0, kBlock, t, hd, ld);

  float adk[kRows][NJ], adv[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // Query tiles that see this key tile: all, or from the diagonal on.
  for (int q0 = causal ? k0 : 0; q0 < t; q0 += kBlock) {
    const int qn = min(kBlock, t - q0);
    __syncthreads();  // the previous tile's readers are done with qs/dos/pts
    ff::load_tile(qs, q + slab, q0, qn, t, hd, ld);
    ff::load_tile(dos, dout + slab, q0, qn, t, hd, ld);
    if (threadIdx.x < kBlock) {
      const int r = threadIdx.x;
      lse_s[r] = r < qn ? lse[row_base + q0 + r] : 0.f;
      delta_s[r] = r < qn ? delta[row_base + q0 + r] : 0.f;
    }
    __syncthreads();

    float st[kRows][kCols], dpt[kRows][kCols];  // [key row][query column]
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[kRows], vv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = ks[(ty * kRows + i) * ld + d];
        vv[i] = vs[(ty * kRows + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const float qv = c < qn ? qs[c * ld + d] : 0.f;
        const float dov = c < qn ? dos[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          st[i][j] = fmaf(kv[i], qv, st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov, dpt[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int kp = k0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const bool masked = c >= qn || kp >= t || (causal && kp > q0 + c);
        const float p = masked ? 0.f : expf(st[i][j] * scale - lse_s[c]);
        pts[r * kPLd + c] = ff::round_through<T>(p);
        dsts[r * kPLd + c] = ff::round_through<T>(p * (dpt[i][j] - delta_s[c]));
      }
    }
    __syncthreads();  // pts/dsts complete

    for (int c = 0; c < qn; ++c) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = pts[(ty * kRows + i) * kPLd + c];
        dsv[i] = dsts[(ty * kRows + i) * kPLd + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float dov = dos[c * ld + tx + 8 * j];
          const float qv = qs[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            adv[i][j] = fmaf(pv[i], dov, adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + ty * kRows + i;
    if (kp >= t) continue;
    T* krow = dk + slab + (size_t)kp * hd;
    T* vrow = dv + slab + (size_t)kp * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        krow[tx + 8 * j] = ff::from_float<T>(adk[i][j] * scale);
        vrow[tx + 8 * j] = ff::from_float<T>(adv[i][j]);
      }
    }
  }
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       const float* g_lse, float* delta, void* dq, void* dk,
                       void* dv, int bh, int t, int hd, int causal,
                       float scale, cudaStream_t stream) {
  using T = float;
  const size_t tile = (size_t)kBlock * (hd + 1);
  const size_t ptile = (size_t)kBlock * kPLd;
  const size_t smem_dq = sizeof(float) * (4 * tile + ptile + 2 * kBlock);
  const size_t smem_dkv = sizeof(float) * (4 * tile + 2 * ptile + 2 * kBlock);
  // Above 48 KB dynamic shared memory needs an opt-in per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlock - 1) / kBlock);
  flash_dq_kernel<T, NJ><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, g_lse, delta, static_cast<T*>(dq), t,
      hd, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, NJ><<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), t, hd, causal, scale);
  return cudaGetLastError();
}

#define FF_BWD_ARGS q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, bh, t, hd, causal, scale, s

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* g_lse, float* delta, void* dq, void* dk,
                         void* dv, int bh, int t, int hd, int causal,
                         float scale, cudaStream_t s) {
  if (hd <= 32) return launch_f32<4>(FF_BWD_ARGS);
  if (hd <= 64) return launch_f32<8>(FF_BWD_ARGS);
  if (hd <= 96) return launch_f32<12>(FF_BWD_ARGS);
  return launch_f32<16>(FF_BWD_ARGS);
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernels
// ---------------------------------------------------------------------------

using namespace ff::wg;
using bf16 = __nv_bfloat16;

constexpr int kWgBM = 128;       // dq pass: query rows per CTA
constexpr int kWgBN = 64;        // K1b's streamed tile: K/V keys, Q/dO rows
constexpr int kWgKM = 128;       // dk/dv pass: key rows per CTA
constexpr int kSubQ = 64;        // dk/dv pass: query columns per product
constexpr int kWgThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemMax = 227 * 1024;

// Shared memory of the dq pass at BN keys per streamed tile and a ring of
// S stages: the Q and dO tiles, S stages of K and V tiles, the barriers.
template <int HDP, int BN, int S>
struct DqSmem {
  using QT = Tile<HDP, kWgBM>;
  using KT = Tile<HDP, BN>;
  static constexpr int kDo = QT::kBytes;
  static constexpr int kK = 2 * QT::kBytes;
  static constexpr int kV = kK + S * KT::kBytes;
  static constexpr int kBars = kV + S * KT::kBytes;
  static constexpr int kBytes = kBars + (int)sizeof(Ring<S>) + 8 + 1024;
};

// Shared memory of the dk/dv pass at QN query rows per streamed tile: the
// K and V tiles, S stages of Q and dO tiles and of their lse and delta.
// Each of those is one TMA box from the flat (bh t) f32 arrays.  A box
// must start on 16 bytes, and row bh t + qi0 need not, so the box starts
// at that row rounded down to a multiple of 4 and holds QN + 4 values; each
// lands in a slot of kRowSlot floats, so every box starts on 512 bytes.
template <int HDP, int QN, int S>
struct DkvSmem {
  using KT = Tile<HDP, kWgKM>;
  using QT = Tile<HDP, QN>;
  static constexpr int kRowBox = QN + 4;
  static constexpr int kRowSlot = 2 * QN;
  static constexpr int kV = KT::kBytes;
  static constexpr int kQ = 2 * KT::kBytes;
  static constexpr int kDo = kQ + S * QT::kBytes;
  static constexpr int kRowVals = kDo + S * QT::kBytes;  // lse, delta
  static constexpr int kRowBytes = 2 * kRowSlot * 4;      // per stage
  static constexpr int kBars = kRowVals + S * kRowBytes;
  static constexpr int kBytes = kBars + (int)sizeof(Ring<S>) + 8 + 1024;
};

// Ring depths: three stages where they fit 227 KiB, else two (hd 128 with
// tiles of 128 rows: three stages of K and V, or of Q and dO, take 192 KiB
// beside the 64 KiB of resident tiles).
template <int HDP, int BN>
__host__ __device__ constexpr int dq_stages() {
  return DqSmem<HDP, BN, 3>::kBytes <= kSmemMax ? 3 : 2;
}
template <int HDP, int QN>
__host__ __device__ constexpr int dkv_stages() {
  return DkvSmem<HDP, QN, 3>::kBytes <= kSmemMax ? 3 : 2;
}
template <int HDP, int BN>
using DqS = DqSmem<HDP, BN, dq_stages<HDP, BN>()>;
template <int HDP, int QN>
using DkvS = DkvSmem<HDP, QN, dkv_stages<HDP, QN>()>;

// K1b (every tile width at 64-row tiles) and b2 (hd 64 and 128, tiles of
// 64 or 128 rows) fit at their depths; at hd 128 and 128 rows both passes
// take two stages.
static_assert(dq_stages<32, 64>() == 3 && dkv_stages<32, 64>() == 3, "hd 32");
static_assert(dq_stages<64, 64>() == 3 && dkv_stages<64, 64>() == 3, "hd 64");
static_assert(dq_stages<128, 64>() == 3 && dkv_stages<128, 64>() == 3,
              "hd 128");
static_assert(dq_stages<64, 128>() == 3 && dkv_stages<64, 128>() == 3,
              "hd 64, tiles of 128");
static_assert(DqS<128, 128>::kBytes <= kSmemMax &&
                  DkvS<128, 128>::kBytes <= kSmemMax,
              "hd 128, tiles of 128: two stages");

// Stores a warpgroup's 64 x HDP accumulator (in panels), times mul, as
// bf16 rows of a (t, hd) slab: rows[h] < t, columns < hd.
template <int W, int P>
__device__ __forceinline__ void store_acc(bf16* slab, const float (*acc)[W / 2],
                                          const int* rows, int t, int hd,
                                          float mul) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= t) continue;
    bf16* out = slab + (size_t)rows[h] * hd;
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
#pragma unroll
      for (int b = 0; b < W / 8; ++b) {
        const int col = pp * W + 8 * b + 2 * tq;
        if (col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[pp][4 * b + 2 * h] * mul,
                                    acc[pp][4 * b + 2 * h + 1] * mul);
        }
      }
    }
  }
}

// dQ += dS K, dS in registers (bf16 A fragments), the BN-key tile kt read
// MN-major: issued, not committed.
template <int HDP, int BN>
__device__ __forceinline__ void issue_dq(float (*acc)[Tile<HDP, BN>::kW / 2],
                                         const uint32_t (*da)[4],
                                         const uint8_t* kt) {
  using KT = Tile<HDP, BN>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int pp = 0; pp < KT::kPanels; ++pp) {
      mma_rs<KT::kW>(acc[pp], da[kk], KT::mnmajor(kt, kk, pp), 1);
    }
  }
}

// Pass 1: dq, from delta = rowsum(o do) - g_lse that it reduces for its
// rows and writes (K1b), or with DIN from the caller's delta (b2).  BN
// keys per streamed K/V tile.
template <int HDP, int BN, bool DIN>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_dq_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_do,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ g_lse,
             float* __restrict__ delta, bf16* __restrict__ dq, int t, int hd,
             int causal, float scale) {
  using QT = Tile<HDP, kWgBM>;
  using KT = Tile<HDP, BN>;
  constexpr int kStages = dq_stages<HDP, BN>();
  using SM = DqSmem<HDP, BN, kStages>;
  using R = Ring<kStages>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* qs = sm;
  uint8_t* dos = sm + SM::kDo;
  uint8_t* ks = sm + SM::kK;
  uint8_t* vs = sm + SM::kV;
  R* ring = reinterpret_cast<R*>(sm + SM::kBars);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + 1);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBM;  // longest rows first
  const int kend = causal ? min(t, q0 + kWgBM) : t;
  const int nk = (kend + BN - 1) / BN;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    ring->init(8);  // each of the 8 consumer warps releases every stage
    bar_init(q_bar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      bar_expect(q_bar, 2 * QT::kBytes);
      QT::load(qs, &map_q, q_bar, q0, bh);
      QT::load(dos, &map_do, q_bar, q0, bh);
      for (int j = 0; j < nk; ++j) {
        ring->acquire(j, 2 * KT::kBytes);
        const int st = R::stage(j);
        KT::load(ks + st * KT::kBytes, &map_k, &ring->full[st], j * BN, bh);
        KT::load(vs + st * KT::kBytes, &map_v, &ring->full[st], j * BN, bh);
      }
    }
  } else {
    reg_alloc<240>();
    constexpr int kW = KT::kW, kP = KT::kPanels, kAcc = kW / 2;
    constexpr int kS = BN / 2;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = q0 + wgi * 64;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const int kend_wg = causal ? min(t, r0 + 64) : t;
    const int nk_wg = r0 < t ? (kend_wg + BN - 1) / BN : 0;
    const float sl2 = scale * kLog2e;
    const size_t base = (size_t)bh * t;

    float dl[2] = {0.f, 0.f};
    if constexpr (DIN) {
      // The caller's delta, for the two rows this thread holds.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dl[h] = rows[h] < t ? delta[base + rows[h]] : 0.f;
      }
    } else {
      // delta = rowsum(o do) - g_lse for the warp's 16 rows, written for
      // the dk/dv pass and kept for the two rows this thread holds.
      for (int rr = 0; rr < 16; ++rr) {
        const int row = r0 + warp * 16 + rr;
        float a = 0.f;
        if (row < t) {
          const bf16* orow = o + (base + row) * hd;
          const bf16* drow = dout + (base + row) * hd;
          for (int d = 2 * lane; d < hd; d += 64) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(orow + d));
            const float2 y = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(drow + d));
            a = fmaf(x.x, y.x, a);
            a = fmaf(x.y, y.y, a);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (row < t) {
          a -= g_lse != nullptr ? g_lse[base + row] : 0.f;
          if (lane == 0) delta[base + row] = a;
        }
        if (rr == g) dl[0] = a;
        if (rr == g + 8) dl[1] = a;
      }
    }
    float ls2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls2[h] = rows[h] < t ? lse[base + rows[h]] * kLog2e : 0.f;
    }

    float acc[kP][kAcc];
#pragma unroll
    for (int pp = 0; pp < kP; ++pp)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[pp][i] = 0.f;

    if (nk_wg > 0) {
      // Tile j's S and dP are issued before tile j-1's dQ += dS K, and
      // tile j's dS is computed while that product runs.
      float s[kS], dp[kS];
      uint32_t da[BN / 16][4];
      bar_wait(q_bar, 0);
      for (int j = 0; j < nk_wg; ++j) {
        ring->wait(j);
        const uint8_t* kt = ks + R::stage(j) * KT::kBytes;
        const uint8_t* vt = vs + R::stage(j) * KT::kBytes;
        pin<kS>(s);
        pin<kS>(dp);
#pragma unroll
        for (int pp = 0; pp < kP; ++pp) pin<kAcc>(acc[pp]);
        mma_fence();
        // S = Q K^T and dP = dO V^T (64 x BN per warpgroup, in 64-key
        // blocks), f32.
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb) {
            mma_ss_n64(s + 32 * nb, QT::kmajor(qs, wgi * 64, kk),
                       KT::kmajor(kt, 64 * nb, kk), kk > 0);
          }
        }
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb) {
            mma_ss_n64(dp + 32 * nb, QT::kmajor(dos, wgi * 64, kk),
                       KT::kmajor(vt, 64 * nb, kk), kk > 0);
          }
        }
        mma_commit();
        if (j > 0) issue_dq<HDP, BN>(acc, da, ks + R::stage(j - 1) * KT::kBytes);
        mma_commit();
        mma_wait<1>();  // S and dP have landed; dQ may still run
        pin<kS>(s);
        pin<kS>(dp);

        // P = exp(S scale - lse), dS = P (dP - delta), in place of S.
        const int k0 = j * BN;
        const bool edge = k0 + BN > t || (causal && k0 + BN - 1 > r0);
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int h = frag_half(i);
          float p = exp2_approx(fmaf(s[i], sl2, -ls2[h]));
          if (edge) {
            const int col = k0 + frag_col(i, tq);
            if (col >= t || (causal && col > rows[h])) p = 0.f;
          }
          s[i] = p * (dp[i] - dl[h]);
        }
        mma_wait<0>();
#pragma unroll
        for (int pp = 0; pp < kP; ++pp) pin<kAcc>(acc[pp]);
        if (j > 0) ring->release(j - 1);
        // dS rounded to bf16 in registers: the A operand of dQ += dS K.
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) frag_a(da[kk], s, kk);
      }
#pragma unroll
      for (int pp = 0; pp < kP; ++pp) pin<kAcc>(acc[pp]);
      mma_fence();
      issue_dq<HDP, BN>(acc, da, ks + R::stage(nk_wg - 1) * KT::kBytes);
      mma_commit();
      mma_wait<0>();
#pragma unroll
      for (int pp = 0; pp < kP; ++pp) pin<kAcc>(acc[pp]);
      ring->release(nk_wg - 1);
    }
    // Tiles past the warpgroup's diagonal: waited for, then released (see
    // Ring).
    for (int j = nk_wg; j < nk; ++j) {
      ring->wait(j);
      ring->release(j);
    }
    store_acc<kW, kP>(dq + base * hd, acc, rows, t, hd, scale);
  }
}

// Pass 2: dk and dv, QN query rows (and their lse and delta) per streamed
// tile, each multiplied in sub-tiles of kSubQ columns.
template <int HDP, int QN>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_dkv_kernel(const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_lse,
              const __grid_constant__ CUtensorMap map_delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int hd,
              int causal, float scale) {
  using KT = Tile<HDP, kWgKM>;
  using QT = Tile<HDP, QN>;
  constexpr int kStages = dkv_stages<HDP, QN>();
  using SM = DkvSmem<HDP, QN, kStages>;
  using R = Ring<kStages>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* ks = sm;
  uint8_t* vs = sm + SM::kV;
  uint8_t* qs = sm + SM::kQ;
  uint8_t* dos = sm + SM::kDo;
  uint8_t* rv = sm + SM::kRowVals;
  R* ring = reinterpret_cast<R*>(sm + SM::kBars);
  uint64_t* k_bar = reinterpret_cast<uint64_t*>(ring + 1);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kWgKM;  // the first key tiles see the most rows
  const int i0 = causal ? k0 / QN : 0;
  const int nq = (t + QN - 1) / QN;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    ring->init(8);
    bar_init(k_bar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      bar_expect(k_bar, 2 * KT::kBytes);
      KT::load(ks, &map_k, k_bar, k0, bh);
      KT::load(vs, &map_v, k_bar, k0, bh);
      for (int i = i0; i < nq; ++i) {
        const int j = i - i0;
        ring->acquire(j, 2 * QT::kBytes + 2 * SM::kRowBox * 4);
        const int st = R::stage(j);
        uint64_t* bar = &ring->full[st];
        QT::load(qs + st * QT::kBytes, &map_q, bar, i * QN, bh);
        QT::load(dos + st * QT::kBytes, &map_do, bar, i * QN, bh);
        float* r = reinterpret_cast<float*>(rv + st * SM::kRowBytes);
        const int r0 = (bh * t + i * QN) & ~3;
        tma_row(r, &map_lse, bar, r0);
        tma_row(r + SM::kRowSlot, &map_delta, bar, r0);
      }
    }
  } else {
    reg_alloc<240>();
    constexpr int kW = QT::kW, kP = QT::kPanels, kAcc = kW / 2;
    constexpr int kS = kSubQ / 2;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int kr0 = k0 + wgi * 64;  // this warpgroup's first key
    const int keys[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};
    const bool live = kr0 < t;
    const float sl2 = scale * kLog2e;

    float adk[kP][kAcc], adv[kP][kAcc];
#pragma unroll
    for (int pp = 0; pp < kP; ++pp)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) adk[pp][i] = adv[pp][i] = 0.f;
    if (live) bar_wait(k_bar, 0);

    for (int i = i0; i < nq; ++i) {
      const int j = i - i0;
      ring->wait(j);  // also for a skipped tile: see Ring
      const int st = R::stage(j);
      const uint8_t* qt = qs + st * QT::kBytes;
      const uint8_t* dot = dos + st * QT::kBytes;
      const float* rows_t =
          reinterpret_cast<const float*>(rv + st * SM::kRowBytes) +
          ((bh * t + i * QN) & 3);
#pragma unroll
      for (int c = 0; c < QN / kSubQ; ++c) {
        const int qi0 = i * QN + c * kSubQ;
        // Skip a sub-tile no key of this warpgroup sees (all its rows
        // above the diagonal), one past t, and every sub-tile when all
        // the warpgroup's keys lie past t.
        if (live && (QN == kSubQ || qi0 < t) &&
            !(causal && qi0 + kSubQ - 1 < kr0)) {
          const float* lse_t = rows_t + c * kSubQ;
          const float* dl_t = lse_t + SM::kRowSlot;

          // S^T = K Q^T (64 keys x kSubQ queries per warpgroup), f32.
          float s[kS];
          pin<kS>(s);
          mma_fence();
#pragma unroll
          for (int kk = 0; kk < HDP / 16; ++kk) {
            mma_ss_n64(s, KT::kmajor(ks, wgi * 64, kk),
                       QT::kmajor(qt, c * kSubQ, kk), kk > 0);
          }
          mma_commit();
          mma_wait<0>();
          pin<kS>(s);

          // P^T = exp(S^T scale - lse[query]), masked above the diagonal
          // and past t; rounded to bf16 as the A operand of dV += P^T dO.
          const bool edge =
              qi0 + kSubQ > t || (causal && kr0 + 63 > qi0);
#pragma unroll
          for (int b = 0; b < kS / 4; ++b) {
            const float L[2] = {lse_t[8 * b + 2 * tq],
                                lse_t[8 * b + 2 * tq + 1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i2 = 4 * b + e;
              const int col = qi0 + frag_col(i2, tq);
              const float ls2 = L[e & 1] * kLog2e;
              float p = exp2_approx(fmaf(s[i2], sl2, -ls2));
              if (edge && (col >= t || (causal && keys[frag_half(i2)] > col))) {
                p = 0.f;
              }
              s[i2] = p;
            }
          }
          uint32_t pa[kSubQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < kSubQ / 16; ++kk) frag_a(pa[kk], s, kk);

          // dV += P^T dO and dP^T = V dO^T.
          float dp[kS];
          pin<kS>(dp);
#pragma unroll
          for (int pp = 0; pp < kP; ++pp) pin<kAcc>(adv[pp]);
          mma_fence();
#pragma unroll
          for (int kk = 0; kk < kSubQ / 16; ++kk) {
#pragma unroll
            for (int pp = 0; pp < kP; ++pp) {
              mma_rs<kW>(adv[pp], pa[kk],
                         QT::mnmajor(dot, c * kSubQ / 16 + kk, pp), 1);
            }
          }
#pragma unroll
          for (int kk = 0; kk < HDP / 16; ++kk) {
            mma_ss_n64(dp, KT::kmajor(vs, wgi * 64, kk),
                       QT::kmajor(dot, c * kSubQ, kk), kk > 0);
          }
          mma_commit();
          mma_wait<0>();
          pin<kS>(dp);
#pragma unroll
          for (int pp = 0; pp < kP; ++pp) pin<kAcc>(adv[pp]);

          // dS^T = P^T (dP^T - delta[query]), rounded to bf16: dK += dS^T
          // Q.
#pragma unroll
          for (int b = 0; b < kS / 4; ++b) {
            const float D[2] = {dl_t[8 * b + 2 * tq], dl_t[8 * b + 2 * tq + 1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i2 = 4 * b + e;
              s[i2] = s[i2] * (dp[i2] - D[e & 1]);
            }
          }
          uint32_t da[kSubQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < kSubQ / 16; ++kk) frag_a(da[kk], s, kk);
#pragma unroll
          for (int pp = 0; pp < kP; ++pp) pin<kAcc>(adk[pp]);
          mma_fence();
#pragma unroll
          for (int kk = 0; kk < kSubQ / 16; ++kk) {
#pragma unroll
            for (int pp = 0; pp < kP; ++pp) {
              mma_rs<kW>(adk[pp], da[kk],
                         QT::mnmajor(qt, c * kSubQ / 16 + kk, pp), 1);
            }
          }
          mma_commit();
          mma_wait<0>();
#pragma unroll
          for (int pp = 0; pp < kP; ++pp) pin<kAcc>(adk[pp]);
        }
      }
      ring->release(j);
    }
    const size_t slab = (size_t)bh * t * hd;
    store_acc<kW, kP>(dk + slab, adk, keys, t, hd, scale);
    store_acc<kW, kP>(dv + slab, adv, keys, t, hd, 1.f);
  }
}

// Both passes at BN rows per streamed tile (the dq pass's keys, the dk/dv
// pass's queries); DIN: the dq pass reads the caller's delta (o, g_lse
// unused) instead of writing it.
template <int HDP, int BN, bool DIN>
cudaError_t launch_wg(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      const float* g_lse, float* delta, void* dq, void* dk,
                      void* dv, int bh, int t, int hd, int causal,
                      float scale, cudaStream_t stream) {
  if ((long long)bh * t > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Pass 1 streams BN-key K/V tiles past 128-row Q/dO tiles; pass 2
  // streams BN-row Q/dO tiles (and their lse/delta) past 128-key K/V
  // tiles.
  using Dkv = DkvS<HDP, BN>;
  CUtensorMap q_bm, do_bm, k_bn, v_bn, k_km, v_km, q_qn, do_qn, m_lse, m_delta;
  cudaError_t err = tile_map<HDP, kWgBM>(&q_bm, q, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, kWgBM>(&do_bm, dout, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, BN>(&k_bn, k, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, BN>(&v_bn, v, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, kWgKM>(&k_km, k, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, kWgKM>(&v_km, v, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, BN>(&q_qn, q, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, BN>(&do_qn, dout, hd, t, bh);
  if (err == cudaSuccess)
    err = map_row_f32(&m_lse, lse, (uint64_t)bh * t, Dkv::kRowBox);
  if (err == cudaSuccess)
    err = map_row_f32(&m_delta, delta, (uint64_t)bh * t, Dkv::kRowBox);
  if (err != cudaSuccess) return err;
  constexpr int smem_dq = DqS<HDP, BN>::kBytes;
  constexpr int smem_dkv = Dkv::kBytes;
  err = cudaFuncSetAttribute(wg_dq_kernel<HDP, BN, DIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wg_dkv_kernel<HDP, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  wg_dq_kernel<HDP, BN, DIN><<<dim3(bh, (t + kWgBM - 1) / kWgBM), kWgThreads,
                               smem_dq, stream>>>(
      q_bm, do_bm, k_bn, v_bn, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, g_lse, delta,
      static_cast<bf16*>(dq), t, hd, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wg_dkv_kernel<HDP, BN><<<dim3(bh, (t + kWgKM - 1) / kWgKM), kWgThreads,
                           smem_dkv, stream>>>(
      k_km, v_km, q_qn, do_qn, m_lse, m_delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, hd, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          const float* g_lse, float* delta, void* dq, void* dk,
                          void* dv, int bh, int t, int hd, int causal,
                          float scale, cudaStream_t s) {
  FF_WG_WIDTH_DISPATCH((launch_wg<HDP, kWgBN, false>(FF_BWD_ARGS)));
}

template <int HDP, int BN, bool DIN>
cudaError_t attrs_wg(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, wg_dq_kernel<HDP, BN, DIN>)
                 : cudaFuncGetAttributes(&a, wg_dkv_kernel<HDP, BN>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = which == 0 ? DqS<HDP, BN>::kBytes : DkvS<HDP, BN>::kBytes;
  return err;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, t, hd) contiguous, 16-byte aligned, of
// one type (dtype: ff::kFloat32 or ff::kBFloat16); lse, delta: (bh, t) f32;
// g_lse: (bh, t) f32 or null (no lse cotangent).  delta is scratch that the
// first pass writes and the second reads.  hd a multiple of 8 in [8, 128].
// Launches both passes on the stream; returns the first cudaError_t (0 =
// both launched).
extern "C" int ff_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            const void* g_lse, void* delta, void* dq, void* dk,
                            void* dv, int bh, int t, int hd, int causal,
                            float scale, int dtype, void* stream) {
  if (bh < 1 || t < 1 || (t + kBlock - 1) / kBlock > 65535 || hd < 8 ||
      hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* g_f = static_cast<const float*>(g_lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == ff::kFloat32)
    return (int)dispatch_f32(q, k, v, o, dout, lse_f, g_f, delta_f, dq, dk,
                             dv, bh, t, hd, causal, scale, s);
  if (dtype == ff::kBFloat16)
    return (int)dispatch_bf16(q, k, v, o, dout, lse_f, g_f, delta_f, dq, dk,
                              dv, bh, t, hd, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = registers per thread, local (spill) bytes per thread and the
// dynamic shared memory of the bf16 kernel `which` (0: dq pass, 1: dk/dv
// pass) at head dim hd's tile width.
extern "C" int ff_flash_bwd_attrs(int which, int hd, int* out) {
  if (which < 0 || which > 1 || hd < 8 || hd > 128)
    return (int)cudaErrorInvalidValue;
  FF_WG_WIDTH_DISPATCH(((int)attrs_wg<HDP, kWgBN, false>(which, out)));
}

// The race's bf16 b2 (tools/probe_flash_bwd_variants.py::_bwd_call_lanes)
// on K1b's pair: dq, dk, dv from the caller's lse and delta (neither o nor
// g_lse is read), with ff_flash_probe_bwd's arguments (flash_probe_bwd.cu):
// dtype ff::kBFloat16, hd 64 or 128, block (the rows of either pass's
// streamed tile) 64 or 128.  At block 64 it is K1b's tiling: given K1b's
// delta, K1b's bits.  lse and delta are read by TMA boxes: their bases must
// be 16-byte aligned.
extern "C" int ff_flash_bwd_row_state(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int bh,
                                      int t, int hd, int causal, float scale,
                                      int dtype, int block, void* stream) {
  if (dtype != ff::kBFloat16 || bh < 1 || bh > 65535 || t < 1 ||
      (t + kWgBM - 1) / kWgBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = const_cast<float*>(static_cast<const float*>(delta));
#define FF_ROW_STATE_CALL(HD, BN)                                          \
  if (hd == HD && block == BN)                                             \
    return (int)launch_wg<HD, BN, true>(q, k, v, nullptr, dout, lse_f,     \
                                        nullptr, delta_f, dq, dk, dv, bh,  \
                                        t, hd, causal, scale, s);
  FF_ROW_STATE_CALL(64, 64)
  FF_ROW_STATE_CALL(64, 128)
  FF_ROW_STATE_CALL(128, 64)
  FF_ROW_STATE_CALL(128, 128)
#undef FF_ROW_STATE_CALL
  return (int)cudaErrorInvalidValue;
}

// out[0..2] as ff_flash_bwd_attrs, for b2's pass `which` at head dim hd
// (64 or 128) and block (64 or 128).
extern "C" int ff_flash_bwd_row_state_attrs(int which, int hd, int block,
                                            int* out) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
#define FF_ROW_STATE_ATTRS(HD, BN) \
  if (hd == HD && block == BN) return (int)attrs_wg<HD, BN, true>(which, out);
  FF_ROW_STATE_ATTRS(64, 64)
  FF_ROW_STATE_ATTRS(64, 128)
  FF_ROW_STATE_ATTRS(128, 64)
  FF_ROW_STATE_ATTRS(128, 128)
#undef FF_ROW_STATE_ATTRS
  return (int)cudaErrorInvalidValue;
}
