// Flash-decode for Hopper (sm_90a): one query token per (batch, head)
// against a padded KV cache.
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_kernels.py::_decode_kernel
// (launched by flash_decode).  Same function: q (B, h, hd) attends the keys
// of cache (B, S, h, hd) at positions < lengths[b], with a streaming
// softmax in f32, p rounded to v's type before P.V, and the output in q's
// type.
//
// Design.  One CTA of 128 threads per (b, head).  The CTA walks only the
// first lengths[b] cache rows, 128 keys at a time (the TPU grid streamed
// the masked tail too).  Each thread scores one key (a full hd-long dot from
// 16-byte loads), the tile's max and sum are block-wide f32 reductions, and
// for P.V the threads split as hd lanes x (128 / hd) key groups, each lane
// reading consecutive dims of a value row (coalesced), with the group
// partials summed once at the end.
//
// Bound.  HBM bytes: 2 * len * hd * itemsize per (b, head), plus q and the
// output.  The B * h CTAs (64 at the serving shape) leave most of the 132
// SMs idle, so the kernel sits well below the memory roofline; splitting
// the key range over several CTAs (split-K) with an lse merge is the later
// fix.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Block-wide max (is_max) or sum of one value per thread.
__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red may be rewritten by the next reduction
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const int* __restrict__ lengths,
                    T* __restrict__ out, int S, int h, int hd, float scale) {
  __shared__ float qs[128];
  __shared__ float ps[kThreads];
  __shared__ float part[kThreads];
  __shared__ float red[kWarps];

  const int b = blockIdx.x / h;
  const int head = blockIdx.x - b * h;
  const int tid = threadIdx.x;
  // Callers pass 1 <= lengths[b] <= S; the clamp keeps reads in bounds.
  const int len = min(max(lengths[b], 0), S);

  const T* qrow = q + ((size_t)b * h + head) * hd;
  for (int d = tid; d < hd; d += kThreads) qs[d] = ff::to_float(qrow[d]);
  const size_t row_stride = (size_t)h * hd;  // between consecutive positions
  const T* kbase = ck + (size_t)b * S * row_stride + (size_t)head * hd;
  const T* vbase = cv + (size_t)b * S * row_stride + (size_t)head * hd;

  const int groups = kThreads / hd;  // key groups of the P.V split (>= 1)
  const int dim = tid % hd;
  const int grp = tid / hd;
  const bool pv_lane = grp < groups;

  float m = ff::kNegInf, l = 0.f, acc = 0.f;
  __syncthreads();  // qs ready

  for (int s0 = 0; s0 < len; s0 += kThreads) {
    const int sp = s0 + tid;
    float sc = ff::kNegInf;
    if (sp < len) {
      const T* krow = kbase + (size_t)sp * row_stride;
      float dot = 0.f;
      for (int d0 = 0; d0 < hd; d0 += 8) {
        float kv[8];
        ff::load8(krow + d0, kv);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qs[d0 + i], kv[i], dot);
      }
      sc = dot * scale;
    }
    const float m_new = fmaxf(m, block_reduce(sc, red, true));
    const float p = sp < len ? expf(sc - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + block_reduce(p, red, false);
    m = m_new;
    ps[tid] = ff::round_through<T>(p);
    __syncthreads();  // ps complete
    if (pv_lane) {
      acc *= corr;
      const int n = min(kThreads, len - s0);
      for (int j = grp; j < n; j += groups) {
        acc = fmaf(ps[j], ff::to_float(vbase[(size_t)(s0 + j) * row_stride + dim]), acc);
      }
    }
    __syncthreads();  // ps is rewritten by the next tile
  }

  if (pv_lane) part[tid] = acc;
  __syncthreads();
  if (tid < hd) {
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += part[g * hd + tid];
    out[((size_t)b * h + head) * hd + tid] = ff::from_float<T>(a / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const int* lengths, void* out, int B, int S, int h, int hd,
                   float scale, cudaStream_t stream) {
  flash_decode_kernel<T><<<B * h, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), lengths, static_cast<T*>(out), S, h, hd,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, h, hd); cache_k, cache_v: (B, S, h, hd); lengths: (B,) int32
// on the device.  All contiguous, 16-byte aligned, of one type (dtype:
// ff::kFloat32 or ff::kBFloat16); hd a multiple of 8 in [8, 128].  Returns
// the launch's cudaError_t (0 = launched).
extern "C" int ff_flash_decode(const void* q, const void* cache_k,
                               const void* cache_v, const void* lengths,
                               void* out, int B, int S, int h, int hd,
                               float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || h < 1 || (long long)B * h > 0x7fffffffLL || hd < 8 ||
      hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == ff::kFloat32)
    return (int)launch<float>(q, cache_k, cache_v, len, out, B, S, h, hd, scale, s);
  if (dtype == ff::kBFloat16)
    return (int)launch<__nv_bfloat16>(q, cache_k, cache_v, len, out, B, S, h, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
