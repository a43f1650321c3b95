// Flash-attention forward (K1f) for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_kernels.py::_fwd_kernel
// (launched by _fwd_call, reached through flash_attention_lse); in bf16
// also ::_fwd_stream_kernel (launched by _fwd_stream_call, the streamed
// forward K1s), whose sequential third grid axis is the K/V tile loop
// inside each CTA of wg_fwd_kernel below, and the kernel race's
// tools/probe_flash_variants.py::_v2_kernel (launched by _call, :204), the
// row state of K1f itself less the lse: wg_fwd_kernel with key tiles of
// the race's block (64 or 128) and no lse store (ff_flash_fwd_row_state).  Same function: softmax(q k^T / sqrt(hd)) v over (bh, t, hd) slabs, causal or
// not, returning o in the input type and lse = m + log(l) in f32.  The cast
// points are the reference's: scores in f32, the scale applied after the
// dot, p rounded to v's type before P.V, l summed from the f32 p.
//
// Bound.  At long t the kernel is bound by its tensor-core operations:
// 4 b h hd t^2 / 2 FLOPs when causal, against 2 (t hd) bytes of q, k, v and
// o per row (at (16, 8, 2048, 64) bf16 causal 0.070 ms of operations
// against 0.016 ms of bytes).  At the serving prefill's t <= 128 it is
// bound by launch latency.
//
// bf16: wgmma from TMA-fed shared memory (wg_fwd_kernel, the machinery of
// wgmma_tile.cuh; its two products are flash_wg.cuh's, shared with the
// race's two-pass kernels).  One CTA per (bh, 128-row q tile), heaviest
// causal tiles first, of three warpgroups: a producer whose one thread keeps
// TMA loads in flight (q once, then the 128-key K/V tiles through a
// three-stage mbarrier ring) and gives its registers up (setmaxnreg), and
// two consumer warpgroups of 64 query rows each.  A consumer computes S = Q
// K^T by wgmma with both operands in shared memory, runs the online softmax
// on the f32 accumulator in registers (exp2 with log2(e) folded into the
// scale; the row max and sum over the four threads of a quad), rounds P to
// bf16 in registers as the A operand of O += P V (V read MN-major by the
// descriptor's transpose bit), and stops at its own causal diagonal: tiles
// below it run unmasked, the straddling one masked.  The head dim is padded
// to a tile width of 32, 64 or 128: the tensor maps zero-fill the columns
// past hd (and the rows past t), the stores mask them, and the scale uses
// the true hd, so every hd of the gate runs here.  The two warpgroups'
// products and softmaxes interleave on the SM; a persistent tile scheduler
// and ping-pong between the warpgroups are later work.
//
// f32: the FMA kernel (flash_fwd_kernel).  wgmma takes f32 only as TF32,
// which would round the operands to 10 mantissa bits: f32 products stay
// on the FMA pipes in f32, so the f32 parity steps keep their contract.
// One CTA of 128 threads per (bh, 64-row q tile); K/V stream through
// shared memory in 64-key tiles with the running (m, l, acc) in f32
// registers; 16 row groups x 8 lanes, a thread owning 4 query rows and 8
// strided key columns of a score tile.
#include "common.cuh"
#include "flash_wg.cuh"
#include "wgmma_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 8;       // key columns per thread in a score tile
constexpr int kPLd = kBlockK + 1;

// NJ bounds the head dim: hd <= 8 * NJ (the per-thread accumulator columns).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, int hd, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                  // kBlockQ x ld
  float* ks = qs + kBlockQ * ld;     // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x ld
  float* ps = vs + kBlockK * ld;     // kBlockQ x kPLd

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const size_t slab = (size_t)bh * t * hd;
  const int ty = threadIdx.x / 8;  // row group: rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 8;  // lane within the row group
  const int nj = hd / 8;

  ff::load_tile(qs, q + slab, q0, kBlockQ, t, hd, ld);

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = ff::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Keys this tile needs: all of them, or up to its last row when causal.
  const int kend = causal ? min(t, q0 + kBlockQ) : t;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    const int kn = min(kBlockK, kend - k0);
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    ff::load_tile(ks, k + slab, k0, kn, t, hd, ld);
    ff::load_tile(vs, v + slab, k0, kn, t, hd, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const float kv = c < kn ? ks[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = ff::kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool masked = kp >= kend || (causal && kp > qp);
        s[i][j] = masked ? ff::kNegInf : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * kRows + i) * kPLd + tx + 8 * j] = ff::round_through<T>(p);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // ps complete

    for (int c = 0; c < kn; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float vv = vs[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= t) continue;
    T* orow = o + slab + (size_t)qp * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) orow[tx + 8 * j] = ff::from_float<T>(acc[i][j] / l[i]);
    }
    if (tx == 0) lse[(size_t)bh * t + qp] = m[i] + logf(l[i]);
  }
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int t, int hd, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (hd + 1) +
                       (size_t)kBlockQ * kPLd);
  // Above 48 KB dynamic shared memory needs an opt-in per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<float, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, t, hd,
      causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int t, int hd, int causal,
                         float scale, cudaStream_t stream) {
  if (hd <= 32) return launch_f32<4>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
  if (hd <= 64) return launch_f32<8>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
  if (hd <= 96) return launch_f32<12>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
  return launch_f32<16>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel
// ---------------------------------------------------------------------------

using namespace ff::wg;

constexpr int kWgBM = 128;     // query rows per CTA: two consumer warpgroups
// Keys per streamed K/V tile.  128 ran 5-8 % faster than 64 on an H100 at
// the 2k and 8k causal shapes, despite the masked half tile at each
// warpgroup's diagonal; at hd 128 q and the ring take 224 KiB of the 227.
constexpr int kWgBN = 128;
constexpr int kStages = 3;     // K/V ring depth
constexpr int kWgThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;

// The online softmax on one tile of raw scores s (kS per thread, keys
// from k0): with `edge`, keys past t (and, causal, past the row) are
// masked with the finite -1e30; the row max m stays in raw units, so the
// exponent is one FFMA, (s - m) scale log2(e), before ex2.  Leaves p in s,
// adds it to this thread's share l of the row sum (after scaling l by
// corr), and returns corr = exp(m_old - m_new) for the output rows.
template <int kS>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, int k0, int t,
                                             int causal, bool edge,
                                             const int* rows, int tq,
                                             float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int h = frag_half(i);
    if (edge) {
      const int col = k0 + frag_col(i, tq);
      if (col >= t || (causal && col > rows[h])) s[i] = ff::kNegInf;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2_approx((m[h] - mx[h]) * sl2);
    m[h] = mx[h];
    ms[h] = mx[h] * sl2;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int h = frag_half(i);
    s[i] = exp2_approx(fmaf(s[i], sl2, -ms[h]));
    l[h] += s[i];
  }
}

template <int HDP, int BN>
using K1fSmem = FwdSmem<HDP, kWgBM, BN, kStages>;
// q and the ring at every (width, key tile) instantiated: at hd 128 and
// 128 keys they take 224 KiB of the 227.
static_assert(K1fSmem<128, 128>::kBytes <= 227 * 1024, "hd 128, 128 keys");
static_assert(K1fSmem<128, 64>::kBytes <= 227 * 1024, "hd 128, 64 keys");
static_assert(K1fSmem<64, 128>::kBytes <= 227 * 1024, "hd 64, 128 keys");
static_assert(K1fSmem<64, 64>::kBytes <= 227 * 1024, "hd 64, 64 keys");

// BN keys per streamed K/V tile (K1f: kWgBN, the race's v2: its block);
// LSE: write the lse (K1f), or o alone (v2).
template <int HDP, int BN, bool LSE>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int t,
              int hd, int causal, float scale) {
  using QT = Tile<HDP, kWgBM>;
  using KT = Tile<HDP, BN>;
  using SM = K1fSmem<HDP, BN>;
  using R = Ring<kStages>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* qs = sm;
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
    // Producer: one thread issues every load.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      bar_expect(q_bar, QT::kBytes);
      QT::load(qs, &map_q, q_bar, q0, bh);
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
    constexpr int kS = BN / 2;  // score accumulator floats per thread
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = q0 + wgi * 64;  // this warpgroup's first row
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    // Key tiles this warpgroup needs: up to its own diagonal when causal,
    // none when all its rows lie past t.
    const int kend_wg = causal ? min(t, r0 + 64) : t;
    const int nk_wg = r0 < t ? (kend_wg + BN - 1) / BN : 0;
    const float sl2 = scale * kLog2e;
    // A tile needs the mask when it reaches past t or past the diagonal.
    auto edge = [&](int j) {
      return (j + 1) * BN > t || (causal && (j + 1) * BN - 1 > r0);
    };

    float acc[kP][kAcc];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[p][i] = 0.f;
    float m[2] = {ff::kNegInf, ff::kNegInf}, l[2] = {0.f, 0.f};

    if (nk_wg > 0) {
      // Tile j's S = Q K^T is issued before tile j-1's O += P V and its
      // softmax runs while that product does (FA3's intra-warpgroup
      // overlap); O is rescaled once the product has landed.
      float s[kS], corr[2];
      uint32_t pa[BN / 16][4];
      bar_wait(q_bar, 0);
      ring->wait(0);
      pin<kS>(s);
      mma_fence();
      issue_scores<HDP, kWgBM, BN>(s, qs, ks, wgi);
      mma_commit();
      mma_wait<0>();
      pin<kS>(s);
      softmax_tile<kS>(s, m, l, corr, 0, t, causal, edge(0), rows, tq, sl2);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) frag_a(pa[kk], s, kk);
      for (int j = 1; j < nk_wg; ++j) {
        ring->wait(j);
        pin<kS>(s);
#pragma unroll
        for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
        mma_fence();
        issue_scores<HDP, kWgBM, BN>(s, qs, ks + R::stage(j) * KT::kBytes,
                                     wgi);
        mma_commit();
        issue_pv<HDP, BN>(acc, pa, vs + R::stage(j - 1) * KT::kBytes);
        mma_commit();
        mma_wait<1>();  // S has landed; P V may still run
        pin<kS>(s);
        softmax_tile<kS>(s, m, l, corr, j * BN, t, causal, edge(j), rows,
                         tq, sl2);
        mma_wait<0>();
#pragma unroll
        for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
        ring->release(j - 1);
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[p][i] *= corr[frag_half(i)];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) frag_a(pa[kk], s, kk);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
      mma_fence();
      issue_pv<HDP, BN>(acc, pa, vs + R::stage(nk_wg - 1) * KT::kBytes);
      mma_commit();
      mma_wait<0>();
#pragma unroll
      for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
      ring->release(nk_wg - 1);
    }
    // Every warp waits for every tile, also one it skips: a release before
    // the tile's loads completed could count towards the stage's previous
    // phase and free it early.
    for (int j = nk_wg; j < nk; ++j) {
      ring->wait(j);
      ring->release(j);
    }

    // o = acc / l in bf16, lse = m scale + log l (with LSE); rows past t
    // and columns past hd are not stored.
    const size_t base = (size_t)bh * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (rows[h] >= t) continue;
      __nv_bfloat16* orow = o + (base + rows[h]) * hd;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
#pragma unroll
        for (int b = 0; b < kW / 8; ++b) {
          const int col = p * kW + 8 * b + 2 * tq;
          if (col < hd) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[p][4 * b + 2 * h] / l[h],
                                      acc[p][4 * b + 2 * h + 1] / l[h]);
          }
        }
      }
      if (LSE && tq == 0) lse[base + rows[h]] = m[h] * scale + logf(l[h]);
    }
  }
}

template <int HDP, int BN, bool LSE>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      float* lse, int bh, int t, int hd, int causal,
                      float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = tile_map<HDP, kWgBM>(&mq, q, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, BN>(&mk, k, hd, t, bh);
  if (err == cudaSuccess) err = tile_map<HDP, BN>(&mv, v, hd, t, bh);
  if (err != cudaSuccess) return err;
  constexpr int smem = K1fSmem<HDP, BN>::kBytes;
  err = cudaFuncSetAttribute(wg_fwd_kernel<HDP, BN, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kWgBM - 1) / kWgBM);
  wg_fwd_kernel<HDP, BN, LSE><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, t, hd, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                          float* lse, int bh, int t, int hd, int causal,
                          float scale, cudaStream_t stream) {
  FF_WG_WIDTH_DISPATCH((launch_wg<HDP, kWgBN, true>(q, k, v, o, lse, bh, t, hd,
                                                    causal, scale, stream)));
}

template <int HDP, int BN, bool LSE>
cudaError_t attrs_wg(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, wg_fwd_kernel<HDP, BN, LSE>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = K1fSmem<HDP, BN>::kBytes;
  return err;
}

}  // namespace

// q, k, v, o: (bh, t, hd) contiguous, 16-byte aligned, of one type (dtype:
// ff::kFloat32 or ff::kBFloat16); lse: (bh, t) f32.  hd a multiple of 8 in
// [8, 128].  Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int t, int hd,
                            int causal, float scale, int dtype,
                            void* stream) {
  if (bh < 1 || t < 1 || (t + kBlockQ - 1) / kBlockQ > 65535 ||
      hd < 8 || hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == ff::kFloat32)
    return (int)dispatch_f32(q, k, v, o, lse_f, bh, t, hd, causal, scale, s);
  if (dtype == ff::kBFloat16)
    return (int)dispatch_bf16(q, k, v, o, lse_f, bh, t, hd, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = registers per thread, local (spill) bytes per thread and the
// dynamic shared memory of the bf16 kernel at head dim hd's tile width.
extern "C" int ff_flash_fwd_attrs(int hd, int* out) {
  if (hd < 8 || hd > 128) return (int)cudaErrorInvalidValue;
  FF_WG_WIDTH_DISPATCH(((int)attrs_wg<HDP, kWgBN, true>(out)));
}

// The race's bf16 v2 (the row state; tools/probe_flash_variants.py::
// _v2_kernel) on K1f's kernel: o alone, key tiles of `block` (64 or 128),
// with ff_flash_probe_fwd's arguments (flash_probe.cu): variant must be 0,
// dtype ff::kBFloat16, hd 64 or 128.  At block 128 it is K1f's instantiation
// less the lse store, so its o is K1f's bit for bit.
extern "C" int ff_flash_fwd_row_state(int variant, const void* q,
                                      const void* k, const void* v, void* o,
                                      int bh, int t, int hd, int causal,
                                      float scale, int dtype, int block,
                                      void* stream) {
  if (variant != 0 || dtype != ff::kBFloat16 || bh < 1 || t < 1 ||
      (t + kWgBM - 1) / kWgBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_ROW_STATE_CALL(HD, BN)                                          \
  if (hd == HD && block == BN)                                             \
    return (int)launch_wg<HD, BN, false>(q, k, v, o, nullptr, bh, t, hd,   \
                                         causal, scale, s);
  FF_ROW_STATE_CALL(64, 64)
  FF_ROW_STATE_CALL(64, 128)
  FF_ROW_STATE_CALL(128, 64)
  FF_ROW_STATE_CALL(128, 128)
#undef FF_ROW_STATE_CALL
  return (int)cudaErrorInvalidValue;
}

// out[0..2] as ff_flash_fwd_attrs, for v2's instantiation at head dim hd
// (64 or 128) and key tile block (64 or 128).
extern "C" int ff_flash_fwd_row_state_attrs(int hd, int block, int* out) {
#define FF_ROW_STATE_ATTRS(HD, BN) \
  if (hd == HD && block == BN) return (int)attrs_wg<HD, BN, false>(out);
  FF_ROW_STATE_ATTRS(64, 64)
  FF_ROW_STATE_ATTRS(64, 128)
  FF_ROW_STATE_ATTRS(128, 64)
  FF_ROW_STATE_ATTRS(128, 128)
#undef FF_ROW_STATE_ATTRS
  return (int)cudaErrorInvalidValue;
}
