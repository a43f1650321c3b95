// Flash-decode for Hopper (sm_90a), split-K: one query token per (batch,
// head) against a padded KV cache.
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_kernels.py::_decode_kernel
// (launched by flash_decode).  Same function: q (B, h, hd) attends the keys
// of cache (B, S, h, hd) at positions < lengths[b], with a streaming
// softmax in f32 (the scale after the dot, the finite -1e30 mask), p
// rounded to v's type before P.V, l summed from the f32 p, and the output
// in q's type.  The TPU grid walked each slot's key blocks in sequence on
// one core, carrying (m, l, acc) in VMEM scratch from one grid step to the
// next.
//
// Design.  Grid (B h, splits): the key range [0, S) is cut into `splits`
// chunks of ceil(S / splits) keys, and CTA (bh, i) takes chunk i of slot
// b's first lengths[b] keys.  The host picks `splits` from S, B and h alone
// (kernels.decode_splits): lengths live on the device, and reading them
// would cost every decode step a host sync.  A CTA whose chunk starts at or
// past lengths[b] writes an empty partial (m = -1e30, l = 0, acc = 0).
//   * Scores.  A key row (hd elements) is read by L lanes with one 16-byte
//     load each (L the power of two that covers the row; lanes past hd
//     hold zeros), so a warp scores 32 / L keys at once and reduces each
//     dot over its L lanes by xor shuffles.  Each key group of L lanes
//     loads the K and V rows of kUnroll keys before it computes, so every
//     load of a short chunk is in flight at once.
//   * P.V.  The same lanes own the same dims of the V rows: each group
//     keeps its own (m, l, acc) online, rescaled once per kUnroll keys.
//     At the end the groups of a warp merge by shuffles, and the four
//     warps' partials once through shared memory.  No per-key chain
//     through global memory and no block barrier inside the key loop.
//   * Merge.  Each CTA writes its (m, l, acc[hd]) in f32 to a scratch,
//     fences, and one thread takes an integer ticket of its (b, head).
//     The CTA that draws the last ticket resets it to 0 and merges the
//     splits' partials in split order, two at a time as merge_lse does
//     (weights exp(m_i - m); an empty split's is 0), divides by l and
//     writes o.  One
//     launch, no float atomic: the merge order is fixed, so two launches
//     on the same inputs give the same bits.  With one split the CTA
//     writes o itself and takes no ticket.
//   * CUDA graphs.  No host sync and no allocation: the caller passes the
//     partials (torch's caching allocator) and the tickets (one zeroed
//     buffer per device, left zeroed by every launch).  Two launches that
//     run at once on one device must not share the tickets.
//
// Bound.  HBM bytes: the K and V rows of the valid keys, 2 len hd itemsize
// per (b, head), plus q and o; the partials stay in L2.  At the serving
// shape (8 slots x 128 keys, 8 heads, hd 64, bf16) that is under 1 MB, a
// quarter of a microsecond at 3.35 TB/s, so the launch and the two
// dependent rounds of loads (the chunk's K/V rows, then the partials) are
// the time; the grid gives the 132 SMs several CTAs each.  At long caches
// the chunks stream K and V at the memory rate.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 128;
// Keys per lane group whose K and V rows are loaded before any is used.
constexpr int kUnroll = 8;
// The most splits a launch takes (the last CTA walks them in order).
constexpr int kMaxSplits = 128;

// 16-byte loads: 8 bf16 or 4 f32 elements, converted to f32.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ void to_floats(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void to_floats_bf16(const uint4& r, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* out) {
  if constexpr (sizeof(T) == 4) {
    to_floats(r, out);
  } else {
    to_floats_bf16(r, out);
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part,
                    unsigned int* __restrict__ tickets, int S, int h, int hd,
                    float scale) {
  constexpr int V = kVec<T>;          // elements per lane and key
  constexpr int G = kThreads / L;     // key groups per CTA
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "L: a power of two");
  __shared__ float acc_s[kWarps][kMaxHd];
  __shared__ float ml_s[kWarps][2];
  __shared__ int last_s;

  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bh / h, head = bh - b * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / L, d0 = (tid % L) * V;  // key group; first dim
  const bool has = d0 < hd;  // lanes past the row hold zeros
  const int chunk = (S + splits - 1) / splits;
  // q is loaded beside lengths[b], before the branch that needs the length.
  uint4 qr = make_uint4(0u, 0u, 0u, 0u);
  if (has) qr = __ldg(reinterpret_cast<const uint4*>(q + (size_t)bh * hd + d0));
  // Callers pass 1 <= lengths[b] <= S; the clamp keeps reads in bounds.
  const int len = min(max(lengths[b], 0), S);
  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  const int stride = hd + 2;  // a partial: m, l, acc[hd]
  const size_t row = (size_t)h * hd;  // between consecutive positions
  const size_t off = (size_t)b * S * row + (size_t)head * hd + d0;

  if (k0 >= k1 && splits > 1) {
    // An empty split: weight 0 in the merge, and no 0 * garbage there.
    float* pp = part + ((size_t)bh * splits + split) * stride;
    if (tid < hd) pp[2 + tid] = 0.f;
    if (tid == 0) {
      pp[0] = ff::kNegInf;
      pp[1] = 0.f;
    }
  } else {
    float qv[V];
    unpack<T>(qr, qv);
    float m = ff::kNegInf, l = 0.f, acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;

    // Every thread runs the same trip count: the shuffles need the warp.
    for (int base = k0; base < k1; base += G * kUnroll) {
      uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * G + grp;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (has && j < k1) {
          kr[u] = __ldg(reinterpret_cast<const uint4*>(ck + off + (size_t)j * row));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(cv + off + (size_t)j * row));
        }
      }
      float s[kUnroll], mx = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[V], dot = 0.f;
        unpack<T>(kr[u], kf);
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qv[i], kf[i], dot);
#pragma unroll
        for (int o = L / 2; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u] = base + u * G + grp < k1 ? dot * scale : ff::kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = base + u * G + grp < k1 ? expf(s[u] - mx) : 0.f;
        l += p;
        const float pr = ff::round_through<T>(p);
        float vf[V];
        unpack<T>(vr[u], vf);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(pr, vf[i], acc[i]);
      }
      m = mx;
    }

    // The warp's key groups merge; lanes L apart own the same dims.
#pragma unroll
    for (int o = L; o < 32; o *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float lo = __shfl_xor_sync(0xffffffffu, l, o);
      const float mn = fmaxf(m, mo);
      const float a = expf(m - mn), c = expf(mo - mn);
      l = l * a + lo * c;
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[i] = acc[i] * a + __shfl_xor_sync(0xffffffffu, acc[i], o) * c;
      m = mn;
    }
    if (lane < L && has) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc_s[warp][d0 + i] = acc[i];
    }
    if (lane == 0) {
      ml_s[warp][0] = m;
      ml_s[warp][1] = l;
    }
    __syncthreads();
    // The four warps merge, in order, one dim per thread.
    if (tid < hd) {
      float mm = ml_s[0][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, ml_s[w][0]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(ml_s[w][0] - mm);
        a += wt * acc_s[w][tid];
        ls += wt * ml_s[w][1];
      }
      if (splits == 1) {
        out[(size_t)bh * hd + tid] = ff::from_float<T>(a / ls);
      } else {
        float* pp = part + ((size_t)bh * splits + split) * stride;
        pp[2 + tid] = a;
        if (tid == 0) {
          pp[0] = mm;
          pp[1] = ls;
        }
      }
    }
    if (splits == 1) return;
  }

  // The ticket: the partial is stored and fenced before it is counted, so
  // the CTA that counts last sees every split's partial.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int prev = atomicAdd(tickets + bh, 1u);
    last_s = prev == (unsigned int)(splits - 1);
  }
  __syncthreads();
  if (!last_s) return;
  if (tid == 0) tickets[bh] = 0u;  // zeroed for the next launch
  __threadfence();
  // The last CTA merges the splits in split order, one dim per thread, as
  // merge_lse does two partials at a time; the loop is unrolled so that
  // the loads of several splits are in flight at once.  __ldcg reads L2,
  // where the other CTAs' stores are.
  if (tid < hd) {
    const float* base = part + (size_t)bh * splits * stride;
    float mm = ff::kNegInf, ls = 0.f, a = 0.f;
#pragma unroll 8
    for (int i = 0; i < splits; ++i) {
      const float* pi = base + (size_t)i * stride;
      const float mi = __ldcg(pi), li = __ldcg(pi + 1), ai = __ldcg(pi + 2 + tid);
      const float mn = fmaxf(mm, mi);
      const float c = expf(mm - mn), wt = expf(mi - mn);
      ls = ls * c + li * wt;
      a = a * c + ai * wt;
      mm = mn;
    }
    out[(size_t)bh * hd + tid] = ff::from_float<T>(a / ls);
  }
}

template <typename T, int L>
cudaError_t launch_l(const void* q, const void* ck, const void* cv,
                     const int* lengths, void* out, float* part,
                     unsigned int* tickets, int B, int S, int h, int hd,
                     int splits, float scale, cudaStream_t stream) {
  const dim3 grid(B * h, splits);
  decode_split_kernel<T, L><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), lengths, static_cast<T*>(out), part, tickets,
      S, h, hd, scale);
  return cudaGetLastError();
}

// L: the power of two of lanes that covers a row of hd elements in 16-byte
// loads.
template <typename T>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const int* lengths, void* out, float* part,
                   unsigned int* tickets, int B, int S, int h, int hd,
                   int splits, float scale, cudaStream_t stream) {
  const int loads = hd / kVec<T>;
#define FF_DECODE_L(LL)                                                      \
  if (loads <= LL)                                                           \
    return launch_l<T, LL>(q, ck, cv, lengths, out, part, tickets, B, S, h, \
                           hd, splits, scale, stream);
  FF_DECODE_L(1)
  FF_DECODE_L(2)
  FF_DECODE_L(4)
  FF_DECODE_L(8)
  FF_DECODE_L(16)
  FF_DECODE_L(32)
#undef FF_DECODE_L
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, h, hd); cache_k, cache_v: (B, S, h, hd); lengths: (B,) int32
// on the device.  All contiguous, 16-byte aligned, of one type (dtype:
// ff::kFloat32 or ff::kBFloat16); hd a multiple of 8 in [8, 128].  splits
// in [1, min(S, 128)]; above 1, partials is f32 scratch of B h splits
// (hd + 2) floats and tickets B h zeroed unsigned ints, which the launch
// leaves zeroed.  Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_flash_decode(const void* q, const void* cache_k,
                               const void* cache_v, const void* lengths,
                               void* out, void* partials, void* tickets,
                               int B, int S, int h, int hd, int splits,
                               float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || h < 1 || (long long)B * h > 0x7fffffffLL || hd < 8 ||
      hd > kMaxHd || hd % 8 != 0 || splits < 1 || splits > S ||
      splits > kMaxSplits ||
      (splits > 1 && (partials == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* part = static_cast<float*>(partials);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  if (dtype == ff::kFloat32)
    return (int)launch<float>(q, cache_k, cache_v, len, out, part, tk, B, S, h,
                              hd, splits, scale, s);
  if (dtype == ff::kBFloat16)
    return (int)launch<__nv_bfloat16>(q, cache_k, cache_v, len, out, part, tk,
                                      B, S, h, hd, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
