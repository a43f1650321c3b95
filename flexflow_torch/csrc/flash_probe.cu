// Flash-forward variants of the kernel race (P1) for Hopper (sm_90a):
// three ways to keep the softmax bookkeeping of causal or non-causal
// attention over (bh, t, hd) slabs, computing o only (no lse).
//
// Replaces the TPU kernels of tools/probe_flash_variants.py (launched by
// _call, :204):
//   * _v2_kernel (:46), the row state: online softmax, acc = acc corr + p v,
//     l = l corr + sum p.  The TPU remedy was a layout of m and l that needs
//     no cross-lane broadcast per tile.  Here m and l live in every thread
//     that holds a part of the row (the quad of the accumulator fragment),
//     both reduced over the quad once per key tile, and the correction
//     multiplies the register accumulator once per key tile.  That is
//     K1f's formulation: the bf16 v2 is K1f's wg_fwd_kernel (flash_fwd.cu,
//     ff_flash_fwd_row_state) at the race's key tile, without the lse.
//   * _v3_kernel (:103), two passes: pass 1 the masked scores and the row
//     max, pass 2 p = exp(s - m), l = sum p and acc += p v with no
//     corrections at all.  The TPU staged s in a (block_q, t) f32 VMEM
//     scratch.  That does not fit 227 KB of shared memory (1 MB for a
//     128-row tile at t = 2048), so pass 2 recomputes the scores: s stays
//     out of device memory as on the TPU, at twice the Q.K^T products
//     (1.5x the forward's).  Staging s in a global workspace instead would
//     write and read 4 b h t^2 / 2 bytes (2.1 GB at the 2k training shape,
//     0.64 ms at 3.35 TB/s, more than K1f's whole time), while the
//     recomputed products are 0.035 ms of tensor-core time there.
//     Each thread keeps a running max of its own scores and the quad
//     reduces it once, after pass 1 ("one max per row"); l likewise after
//     pass 2.
//   * _v4_kernel (:174), the full row: one softmax over the whole masked
//     row, keys above the diagonal included (2x the causal products), with
//     no causal skip of key tiles.  A full row of scores fits neither the
//     registers nor shared memory at these t, so it is the two passes of
//     v3 over every key tile of the row, the mask applied per element:
//     3x the causal function's products.  Without a causal mask it is v3.
// The cast points are K1f's: f32 scores, the scale after the dot, the
// finite -1e30 mask, p rounded to v's type before P.V, l summed from the
// f32 p.
//
// Two machineries, one per type.
//   * bf16 v3 and v4: wg_two_pass_kernel, K1f's wg_fwd_kernel shape on
//     wgmma_tile.cuh and flash_wg.cuh (ff_flash_probe_fwd_wg).  One CTA per
//     (bh, 128-row q tile), heaviest causal tiles first, of three
//     warpgroups: a producer whose one thread keeps TMA loads in flight
//     through a three-stage mbarrier ring (K1f's depth, at every head dim
//     and key tile) and gives its registers up, and two consumer
//     warpgroups of 64 rows.  S = Q K^T is a wgmma from shared memory, P
//     the A operand of O += P V in registers, the row max and sum taken
//     over the quad; exp2 with log2(e) folded into the scale, as K1f.  One
//     tile counter runs through both passes: pass 1 streams K alone into
//     tiles 0 .. nk - 1, its products back to back with the max of tile j
//     under the product of tile j + 1; pass 2 streams K and V into tiles
//     nk .. 2 nk - 1, the exp and sum of tile j under the P V of tile j - 1,
//     with no correction since the max is final.  v4 issues every product
//     of every key tile, those wholly above the diagonal too, where the
//     mask makes p an exact 0.  Every wait traps after 2 s, as K1f's do
//     (wgmma_tile.cuh, bar_wait): a fault of the ring's phases fails the
//     launch instead of hanging the card.  (bf16 v2: flash_fwd.cu.)
//   * f32 v2, v3 and v4: mma_tile.cuh (ff_flash_probe_fwd).  One CTA of 4
//     warps per (bh, 64-row q tile), 16 query rows per warp; key tiles of
//     BN (the race's block, 64 or 128) stream through a cp.async ring of
//     two stages, or one where two do not fit shared memory (hd 128 and BN
//     128).  The products run on the FMA pipes in f32, with no TF32
//     (wgmma takes f32 only as TF32).
//
// Bound.  At the race's shapes each variant is bound by its products:
// 4 b h hd t^2 / 2 FLOPs for the causal function (v3 spends 1.5x that, v4
// 3x).  On one machinery the race measures what the bookkeeping costs
// beside the products: v3 drops every correction of v2 and K1f for 0.5x
// more products, v4 also drops the causal skip.
#include "flash_wg.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace ff::tile;

template <int HD, int BN>
__host__ __device__ constexpr size_t fwd_smem(int stages) {
  return sizeof(float) * ((size_t)(kBM + 2 * stages * BN) * pitch<float>(HD) +
                          pbuf_floats(BN));
}

// Two cp.async stages when they fit, else one.
template <int HD, int BN>
__host__ __device__ constexpr int fwd_stages() {
  return fwd_smem<HD, BN>(2) <= kSmemMax ? 2 : 1;
}

// The scaled, masked scores of a warp's 16 rows against key tile k0..k0+BN.
template <int HD, int BN>
__device__ __forceinline__ void scores(float (*s)[4], const float* qw,
                                       const float* kt, int k0,
                                       const int* rows, int t, int causal,
                                       float scale) {
  constexpr int kLd = pitch<float>(HD);
  const int tq = (threadIdx.x & 31) & 3;
  zero<BN / 8>(s);
  warp_abt<HD, BN>(s, qw, kLd, kt, kLd);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * tq + (e & 1);
      const bool masked = col >= t || (causal && col > rows[e >> 1]);
      s[nt][e] = masked ? ff::kNegInf : s[nt][e] * scale;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// v2: the row state
// ---------------------------------------------------------------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads)
row_state_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int t,
                 int causal, float scale) {
  using T = float;
  constexpr int S = fwd_stages<HD, BN>();
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* ks = qs + kBM * kLd;                  // S stages x BN x kLd
  T* vs = ks + S * BN * kLd;               // S stages x BN x kLd
  float* pbuf = reinterpret_cast<float*>(vs + S * BN * kLd);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const size_t slab = (size_t)blockIdx.y * t * HD;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = qs + warp * 16 * kLd;
  float* wbuf = pbuf + warp * 16 * (BN + 4);
  const int nk = ((causal ? min(t, q0 + kBM) : t) + BN - 1) / BN;
  auto issue = [&](int j, int st) {
    async_tile<T, HD, BN>(ks + st * BN * kLd, k + slab, j * BN, t);
    async_tile<T, HD, BN>(vs + st * BN * kLd, v + slab, j * BN, t);
  };
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  issue(0, 0);
  cp_commit();

  // The row state, whole in each thread of the row's quad.
  float m[2] = {ff::kNegInf, ff::kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  zero<HD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue);
    float s[BN / 8][4];
    scores<HD, BN>(s, qw, ks + st * BN * kLd, j * BN, rows, t, causal,
                   scale);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    warp_pv<BN, HD>(acc, s, vs + st * BN * kLd, kLd, wbuf);
    ring_done<S>(j, nk, issue);
  }
  store_rows<T, HD>(o + slab, acc, q0 + warp * 16, t, 1.f / l[0], 1.f / l[1]);
}

// ---------------------------------------------------------------------------
// f32 v3 (SKIP: the causal loop stops at the diagonal) and v4 (every key
// tile)
// ---------------------------------------------------------------------------

template <int HD, int BN, bool SKIP>
__global__ void __launch_bounds__(kThreads)
two_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int t,
                int causal, float scale) {
  using T = float;
  constexpr int S = fwd_stages<HD, BN>();
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* ks = qs + kBM * kLd;                  // S stages x BN x kLd
  T* vs = ks + S * BN * kLd;               // S stages x BN x kLd
  float* pbuf = reinterpret_cast<float*>(vs + S * BN * kLd);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const size_t slab = (size_t)blockIdx.y * t * HD;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = qs + warp * 16 * kLd;
  float* wbuf = pbuf + warp * 16 * (BN + 4);
  const int nk = ((SKIP && causal ? min(t, q0 + kBM) : t) + BN - 1) / BN;
  auto issue_k = [&](int j, int st) {
    async_tile<T, HD, BN>(ks + st * BN * kLd, k + slab, j * BN, t);
  };
  auto issue_kv = [&](int j, int st) {
    issue_k(j, st);
    async_tile<T, HD, BN>(vs + st * BN * kLd, v + slab, j * BN, t);
  };
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  issue_k(0, 0);
  cp_commit();

  // Pass 1: each thread's running max of its scores, reduced once.
  float m[2] = {ff::kNegInf, ff::kNegInf};
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue_k);
    float s[BN / 8][4];
    scores<HD, BN>(s, qw, ks + st * BN * kLd, j * BN, rows, t, causal,
                   scale);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
    ring_done<S>(j, nk, issue_k);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  // Pass 2: p = exp(s - m) against the final max; no corrections.
  issue_kv(0, 0);
  cp_commit();
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  zero<HD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue_kv);
    float s[BN / 8][4];
    scores<HD, BN>(s, qw, ks + st * BN * kLd, j * BN, rows, t, causal,
                   scale);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
    warp_pv<BN, HD>(acc, s, vs + st * BN * kLd, kLd, wbuf);
    ring_done<S>(j, nk, issue_kv);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_rows<T, HD>(o + slab, acc, q0 + warp * 16, t, 1.f / l[0], 1.f / l[1]);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// f32 only: the bf16 v2 is K1f's kernel (flash_fwd.cu), the bf16 v3 and v4
// wg_two_pass_kernel below.
template <int HD, int BN>
cudaError_t launch_variant(int variant, const void* q, const void* k,
                           const void* v, void* o, int bh, int t, int causal,
                           float scale, cudaStream_t stream) {
  using T = float;
  using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, float);
  const Kernel kernel = variant == 0   ? &row_state_kernel<HD, BN>
                        : variant == 1 ? &two_pass_kernel<HD, BN, true>
                                       : &two_pass_kernel<HD, BN, false>;
  const size_t smem = fwd_smem<HD, BN>(fwd_stages<HD, BN>());
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 v3 and v4: wgmma from TMA-fed shared memory
// ---------------------------------------------------------------------------

namespace wgk {

using namespace ff::wg;

constexpr int kWgBM = 128;       // query rows per CTA: two consumer warpgroups
constexpr int kStages = 3;       // the ring's depth, K1f's
constexpr int kWgThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;
using R = Ring<kStages>;

template <int HD, int BN>
using TwoPassSmem = FwdSmem<HD, kWgBM, BN, kStages>;
// Every instantiation's q tile and K/V ring fit the 227 KiB a block may
// take; at hd 128 and block 128 they take 224 KiB of it, as K1f's do.
static_assert(TwoPassSmem<64, 64>::kBytes <= (int)kSmemMax, "hd 64 bn 64");
static_assert(TwoPassSmem<64, 128>::kBytes <= (int)kSmemMax, "hd 64 bn 128");
static_assert(TwoPassSmem<128, 64>::kBytes <= (int)kSmemMax, "hd 128 bn 64");
static_assert(TwoPassSmem<128, 128>::kBytes <= (int)kSmemMax, "hd 128 bn 128");

// A consumer thread's two rows (fragment rows g and g + 8 of its warp) and
// the edges a key tile of BN keys may cross.
template <int BN>
struct Rows {
  int t, causal, r0, tq, row[2];

  // Tile j reaches past t, or (causal) past the warpgroup's first row.
  __device__ __forceinline__ bool edge(int j) const {
    return (j + 1) * BN > t || (causal && (j + 1) * BN - 1 > r0);
  }
  // Tile j's raw scores s (BN / 2 per thread) with keys past t and,
  // causal, past the row set to the finite -1e30.
  __device__ __forceinline__ void mask(float* s, int j) const {
    if (!edge(j)) return;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = j * BN + frag_col(i, tq);
      if (col >= t || (causal && col > row[frag_half(i)])) s[i] = ff::kNegInf;
    }
  }
};

// Pass 1 on tile j, whose S = Q K^T was issued into cur: issues the next
// tile's into nxt when the warpgroup has one, folds tile j's masked scores
// into the thread's row maxima m while that product runs, and releases
// tile j.
template <int HD, int BN>
__device__ __forceinline__ void max_step(float* cur, float* nxt, int j,
                                         int nk_wg, R* ring,
                                         const uint8_t* qs, const uint8_t* ks,
                                         int wgi, const Rows<BN>& r,
                                         float* m) {
  using KT = Tile<HD, BN>;
  constexpr int kS = BN / 2;
  if (j + 1 < nk_wg) {
    ring->wait(j + 1);
    pin<kS>(nxt);
    mma_fence();
    issue_scores<HD, kWgBM, BN>(nxt, qs, ks + R::stage(j + 1) * KT::kBytes,
                                wgi);
    mma_commit();
    mma_wait<1>();  // cur has landed; nxt may still run
  } else {
    mma_wait<0>();
  }
  pin<kS>(cur);
  r.mask(cur, j);
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int h = frag_half(i);
    m[h] = fmaxf(m[h], cur[i]);
  }
  ring->release(j);
}

// Pass 2's p = exp(s - m) of tile j, in place, against the final row max
// (ms = m scale log2(e)), and its share of the row sum l.
template <int BN>
__device__ __forceinline__ void exp_tile(float* s, int j, const Rows<BN>& r,
                                         const float* ms, float sl2,
                                         float* l) {
  r.mask(s, j);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = frag_half(i);
    s[i] = exp2_approx(fmaf(s[i], sl2, -ms[h]));
    l[h] += s[i];
  }
}

// v3 (SKIP: a causal CTA and each of its warpgroups stop at their
// diagonal) and v4 (every key tile of the row), on (bh, t, HD) slabs.
template <int HD, int BN, bool SKIP>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_two_pass_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, int t, int causal,
                   float scale) {
  using QT = Tile<HD, kWgBM>;
  using KT = Tile<HD, BN>;
  using SM = TwoPassSmem<HD, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* qs = sm;
  uint8_t* ks = sm + SM::kK;
  uint8_t* vs = sm + SM::kV;
  R* ring = reinterpret_cast<R*>(sm + SM::kBars);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + 1);

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBM;  // longest rows first
  const bool skip = SKIP && causal;
  const int nk = ((skip ? min(t, q0 + kWgBM) : t) + BN - 1) / BN;
  const int p2 = nk;  // pass 2's first tile on the ring
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    ring->init(8);  // each of the 8 consumer warps releases every stage
    bar_init(q_bar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {
    // Producer: one thread issues every load, K alone for pass 1, then K
    // and V for pass 2 (a box counts its zero-filled bytes too).
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      bar_expect(q_bar, QT::kBytes);
      QT::load(qs, &map_q, q_bar, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int st = R::stage(j);
        ring->acquire(j, KT::kBytes);
        KT::load(ks + st * KT::kBytes, &map_k, &ring->full[st], j * BN, bh);
      }
      for (int j = 0; j < nk; ++j) {
        const int st = R::stage(p2 + j);
        ring->acquire(p2 + j, 2 * KT::kBytes);
        KT::load(ks + st * KT::kBytes, &map_k, &ring->full[st], j * BN, bh);
        KT::load(vs + st * KT::kBytes, &map_v, &ring->full[st], j * BN, bh);
      }
    }
  } else {
    reg_alloc<240>();
    constexpr int kW = KT::kW, kP = KT::kPanels, kAcc = kW / 2;
    constexpr int kS = BN / 2;  // score accumulator floats per thread
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2;
    Rows<BN> r;
    r.t = t;
    r.causal = causal;
    r.r0 = q0 + wgi * 64;  // this warpgroup's first row
    r.tq = lane & 3;
    r.row[0] = r.r0 + warp * 16 + g;
    r.row[1] = r.row[0] + 8;
    // Key tiles this warpgroup computes: v3 up to its own diagonal, v4
    // all; none when all its rows lie past t.
    const int kend_wg = skip ? min(t, r.r0 + 64) : t;
    const int nk_wg = r.r0 < t ? (kend_wg + BN - 1) / BN : 0;
    const float sl2 = scale * kLog2e;

    // Pass 1: the row max, products back to back over two score buffers.
    float m[2] = {ff::kNegInf, ff::kNegInf};
    if (nk_wg > 0) {
      float s0[kS], s1[kS];
      bar_wait(q_bar, 0);
      ring->wait(0);
      pin<kS>(s0);
      mma_fence();
      issue_scores<HD, kWgBM, BN>(s0, qs, ks, wgi);
      mma_commit();
      for (int j = 0; j < nk_wg; j += 2) {
        max_step<HD, BN>(s0, s1, j, nk_wg, ring, qs, ks, wgi, r, m);
        if (j + 1 < nk_wg) {
          max_step<HD, BN>(s1, s0, j + 1, nk_wg, ring, qs, ks, wgi, r, m);
        }
      }
    }
    // Every warp waits for every tile, also one it skips: a release before
    // the tile's loads completed could count towards the stage's previous
    // phase and free it early.
    for (int j = nk_wg; j < nk; ++j) {
      ring->wait(j);
      ring->release(j);
    }
    // The row max, reduced over the quad, in the exponent's units.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2)) * sl2;
    }

    // Pass 2: tile j's S is issued before tile j - 1's O += P V and its
    // exp runs while that product does.
    float acc[kP][kAcc];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[p][i] = 0.f;
    float l[2] = {0.f, 0.f};
    if (nk_wg > 0) {
      float s[kS];
      uint32_t pa[BN / 16][4];
      ring->wait(p2);
      pin<kS>(s);
      mma_fence();
      issue_scores<HD, kWgBM, BN>(s, qs, ks + R::stage(p2) * KT::kBytes, wgi);
      mma_commit();
      mma_wait<0>();
      pin<kS>(s);
      exp_tile<BN>(s, 0, r, m, sl2, l);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) frag_a(pa[kk], s, kk);
      for (int j = 1; j < nk_wg; ++j) {
        ring->wait(p2 + j);
        pin<kS>(s);
#pragma unroll
        for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
        mma_fence();
        issue_scores<HD, kWgBM, BN>(s, qs, ks + R::stage(p2 + j) * KT::kBytes,
                                    wgi);
        mma_commit();
        issue_pv<HD, BN>(acc, pa, vs + R::stage(p2 + j - 1) * KT::kBytes);
        mma_commit();
        mma_wait<1>();  // S has landed; P V may still run
        pin<kS>(s);
        exp_tile<BN>(s, j, r, m, sl2, l);
        mma_wait<0>();
#pragma unroll
        for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
        ring->release(p2 + j - 1);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) frag_a(pa[kk], s, kk);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
      mma_fence();
      issue_pv<HD, BN>(acc, pa, vs + R::stage(p2 + nk_wg - 1) * KT::kBytes);
      mma_commit();
      mma_wait<0>();
#pragma unroll
      for (int p = 0; p < kP; ++p) pin<kAcc>(acc[p]);
      ring->release(p2 + nk_wg - 1);
    }
    for (int j = nk_wg; j < nk; ++j) {
      ring->wait(p2 + j);
      ring->release(p2 + j);
    }

    // o = acc / l in bf16; rows past t are not stored.
    const size_t base = (size_t)bh * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (r.row[h] >= t) continue;
      __nv_bfloat16* orow = o + (base + r.row[h]) * HD;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
#pragma unroll
        for (int b = 0; b < kW / 8; ++b) {
          const int col = p * kW + 8 * b + 2 * r.tq;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[p][4 * b + 2 * h] / l[h],
                                    acc[p][4 * b + 2 * h + 1] / l[h]);
        }
      }
    }
  }
}

template <int HD, int BN, bool SKIP>
cudaError_t launch_two_pass(const void* q, const void* k, const void* v,
                            void* o, int bh, int t, int causal, float scale,
                            cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = tile_map<HD, kWgBM>(&mq, q, HD, t, bh);
  if (err == cudaSuccess) err = tile_map<HD, BN>(&mk, k, HD, t, bh);
  if (err == cudaSuccess) err = tile_map<HD, BN>(&mv, v, HD, t, bh);
  if (err != cudaSuccess) return err;
  constexpr int smem = TwoPassSmem<HD, BN>::kBytes;
  err = cudaFuncSetAttribute(wg_two_pass_kernel<HD, BN, SKIP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kWgBM - 1) / kWgBM, bh);
  wg_two_pass_kernel<HD, BN, SKIP><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), t, causal, scale);
  return cudaGetLastError();
}

template <int HD, int BN>
cudaError_t attrs_two_pass(int variant, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, variant == 1 ? wg_two_pass_kernel<HD, BN, true>
                       : wg_two_pass_kernel<HD, BN, false>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = TwoPassSmem<HD, BN>::kBytes;
  return err;
}

}  // namespace wgk

}  // namespace

// The race's f32 kernels on mma_tile.cuh.  q, k, v, o: (bh, t, hd) f32
// contiguous, 16-byte aligned (dtype must be ff::kFloat32).  variant: 0 row
// state (v2), 1 two passes (v3), 2 full row (v4).  hd in {64, 128}, block
// (the key tile) in {64, 128}, every t >= 1, 1 <= bh <= 65535.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int ff_flash_probe_fwd(int variant, const void* q, const void* k,
                                  const void* v, void* o, int bh, int t,
                                  int hd, int causal, float scale, int dtype,
                                  int block, void* stream) {
  if (variant < 0 || variant > 2 || dtype != ff::kFloat32 || bh < 1 ||
      bh > 65535 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_PROBE_CALL(HD, BN)                                              \
  if (hd == HD && block == BN)                                             \
    return (int)launch_variant<HD, BN>(variant, q, k, v, o, bh, t, causal, \
                                       scale, s);
  FF_PROBE_CALL(64, 64)
  FF_PROBE_CALL(64, 128)
  FF_PROBE_CALL(128, 64)
  FF_PROBE_CALL(128, 128)
#undef FF_PROBE_CALL
  return (int)cudaErrorInvalidValue;
}

// bf16 v3 (variant 1) and v4 (variant 2) on the wgmma machinery, with
// ff_flash_probe_fwd's arguments (dtype must be ff::kBFloat16).
extern "C" int ff_flash_probe_fwd_wg(int variant, const void* q,
                                     const void* k, const void* v, void* o,
                                     int bh, int t, int hd, int causal,
                                     float scale, int dtype, int block,
                                     void* stream) {
  if (variant < 1 || variant > 2 || dtype != ff::kBFloat16 || bh < 1 ||
      bh > 65535 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_PROBE_WG_CALL(HD, BN)                                            \
  if (hd == HD && block == BN)                                              \
    return (int)(variant == 1                                               \
                     ? wgk::launch_two_pass<HD, BN, true>(q, k, v, o, bh, t, \
                                                          causal, scale, s)  \
                     : wgk::launch_two_pass<HD, BN, false>(                  \
                           q, k, v, o, bh, t, causal, scale, s));
  FF_PROBE_WG_CALL(64, 64)
  FF_PROBE_WG_CALL(64, 128)
  FF_PROBE_WG_CALL(128, 64)
  FF_PROBE_WG_CALL(128, 128)
#undef FF_PROBE_WG_CALL
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = registers per thread, local (spill) bytes per thread and the
// dynamic shared memory of wg_two_pass_kernel for variant 1 (v3) or 2 (v4)
// at head dim hd and key tile block.
extern "C" int ff_flash_probe_wg_attrs(int variant, int hd, int block,
                                       int* out) {
  if (variant < 1 || variant > 2) return (int)cudaErrorInvalidValue;
#define FF_PROBE_WG_ATTRS(HD, BN) \
  if (hd == HD && block == BN)    \
    return (int)wgk::attrs_two_pass<HD, BN>(variant, out);
  FF_PROBE_WG_ATTRS(64, 64)
  FF_PROBE_WG_ATTRS(64, 128)
  FF_PROBE_WG_ATTRS(128, 64)
  FF_PROBE_WG_ATTRS(128, 128)
#undef FF_PROBE_WG_ATTRS
  return (int)cudaErrorInvalidValue;
}
