// Embedding row kernels for Hopper (sm_90a): the row gather (K4) and the
// deterministic in-place row scatter-add (K5) of the row-sparse embedding
// update path.
//
// Replace the TPU kernels flexflow_tpu/ops/pallas_kernels.py::_gather_kernel
// (launched by gather_rows) and ::_scatter_add_kernel (launched by
// _scatter_rows_128, fed by _collapse_runs).  Same functions:
//
//   gather_rows:       out[i, :] = table[ids[i], :]          (n, D) <- (R, D)
//   scatter_add_rows:  table[ids[i], :] += upd[i, :]          in place
//
// moving only the addressed rows of the (R, D) f32 table.  The TPU forms'
// (R, 1, D) row view, scalar-prefetch grid and (P, 128) lane repack are
// Mosaic's constraints and have no counterpart here: any D is taken.
//
// Out-of-range ids (outside [0, R)) never address memory outside the
// table: the gather writes a NaN row for them (jnp.take's fill), the
// scatter drops their updates.  The plain versions in
// flexflow_torch/ops/kernels.py do the same.
//
// Design.  A group of G threads (G a power of two, <= 32, chosen by the
// wrapper so that G 16-byte vectors cover a row where they can) owns one
// row: 16-byte loads and stores when D % 4 == 0 and the pointers allow it,
// 4-byte ones otherwise.
//
// The scatter has no float atomics.  The wrapper sorts the ids stably
// (torch.sort(stable=True): batch order is kept within a row) and passes
// the sorted ids with the permutation.  The group at the first sorted
// position of each run of equal ids is that row's only writer: it sums the
// run's update rows in f32 in sorted order, starting from 0, and adds the
// sum to the table row once.  Rows have one writer each, so there is no
// race, and the order of every sum is fixed: two launches on the same
// inputs give bit-identical tables.
//
// Bound.  Bytes: the gather reads the distinct addressed rows and the ids
// and writes n rows; the scatter reads the ids and n update rows and reads
// and writes each distinct row once.  Both are far from any compute limit.
// A long run of one id is summed by one group, so a heavily skewed batch
// is latency-bound on that group's loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Id, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, const Id* __restrict__ ids,
                   float* __restrict__ out, long long R, int D, int n,
                   int log_g) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t >> log_g;
  const int lane = (int)(t & ((1 << log_g) - 1));
  if (i >= n) return;
  const int G = 1 << log_g;
  const long long row = (long long)ids[i];
  float* dst = out + (size_t)i * D;
  if (row < 0 || row >= R) {
    for (int c = lane; c < D; c += G) dst[c] = __int_as_float(0x7fc00000);
    return;
  }
  const float* src = table + (size_t)row * D;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < D / 4; c += G) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < D; c += G) dst[c] = __ldg(src + c);
  }
}

template <typename Id, bool kVec>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float* __restrict__ table, const Id* __restrict__ sid,
                        const long long* __restrict__ perm,
                        const float* __restrict__ upd, long long R, int D,
                        int n, int log_g) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t >> log_g;
  const int lane = (int)(t & ((1 << log_g) - 1));
  if (i >= n) return;
  const int G = 1 << log_g;
  const Id row = sid[i];
  if (i > 0 && sid[i - 1] == row) return;  // not the first of its run
  if ((long long)row < 0 || (long long)row >= R) return;
  long long end = i + 1;
  while (end < n && sid[end] == row) ++end;
  float* dst = table + (size_t)row * D;
  if (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < D / 4; c += G) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (long long j = i; j < end; ++j) {
        const float4 u =
            __ldg(reinterpret_cast<const float4*>(upd + (size_t)perm[j] * D) + c);
        acc.x += u.x;
        acc.y += u.y;
        acc.z += u.z;
        acc.w += u.w;
      }
      float4 v = d4[c];
      v.x += acc.x;
      v.y += acc.y;
      v.z += acc.z;
      v.w += acc.w;
      d4[c] = v;
    }
  } else {
    for (int c = lane; c < D; c += G) {
      float acc = 0.f;
#pragma unroll 4
      for (long long j = i; j < end; ++j) acc += __ldg(upd + (size_t)perm[j] * D + c);
      dst[c] += acc;
    }
  }
}

int blocks_for(int n, int log_g) {
  return (int)((((long long)n << log_g) + kThreads - 1) / kThreads);
}

template <typename Id>
cudaError_t launch_gather(const void* table, const void* ids, void* out,
                          long long R, int D, int n, int log_g, int vec,
                          cudaStream_t stream) {
  const float* tb = static_cast<const float*>(table);
  const Id* id = static_cast<const Id*>(ids);
  float* o = static_cast<float*>(out);
  if (vec)
    gather_rows_kernel<Id, true><<<blocks_for(n, log_g), kThreads, 0, stream>>>(
        tb, id, o, R, D, n, log_g);
  else
    gather_rows_kernel<Id, false><<<blocks_for(n, log_g), kThreads, 0, stream>>>(
        tb, id, o, R, D, n, log_g);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_scatter(void* table, const void* sid, const void* perm,
                           const void* upd, long long R, int D, int n,
                           int log_g, int vec, cudaStream_t stream) {
  float* tb = static_cast<float*>(table);
  const Id* s = static_cast<const Id*>(sid);
  const long long* p = static_cast<const long long*>(perm);
  const float* u = static_cast<const float*>(upd);
  if (vec)
    scatter_add_rows_kernel<Id, true>
        <<<blocks_for(n, log_g), kThreads, 0, stream>>>(tb, s, p, u, R, D, n, log_g);
  else
    scatter_add_rows_kernel<Id, false>
        <<<blocks_for(n, log_g), kThreads, 0, stream>>>(tb, s, p, u, R, D, n, log_g);
  return cudaGetLastError();
}

bool bad_args(long long R, int D, int n, int log_g) {
  return R < 1 || D < 1 || n < 1 || log_g < 0 || log_g > 5 ||
         ((long long)n << log_g) / kThreads >= 0x7fffffffLL;
}

}  // namespace

// table: (R, D) f32; ids: (n,) int32 (id64 = 0) or int64 (id64 = 1); out:
// (n, D) f32.  All contiguous on the device; vec = 1 only when D % 4 == 0
// and table and out are 16-byte aligned.  2^log_g threads per row.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_gather_rows(const void* table, const void* ids, void* out,
                              long long R, int D, int n, int log_g, int id64,
                              int vec, void* stream) {
  if (bad_args(R, D, n, log_g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id64) return (int)launch_gather<long long>(table, ids, out, R, D, n, log_g, vec, s);
  return (int)launch_gather<int>(table, ids, out, R, D, n, log_g, vec, s);
}

// table: (R, D) f32, updated in place; sorted_ids: (n,) int32 or int64,
// sorted ascending with equal ids in batch order; perm: (n,) int64, the
// batch position of each sorted id; upd: (n, D) f32 in batch order.  All
// contiguous on the device; vec = 1 only when D % 4 == 0 and table and upd
// are 16-byte aligned.  Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_scatter_add_rows(void* table, const void* sorted_ids,
                                   const void* perm, const void* upd,
                                   long long R, int D, int n, int log_g,
                                   int id64, int vec, void* stream) {
  if (bad_args(R, D, n, log_g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id64)
    return (int)launch_scatter<long long>(table, sorted_ids, perm, upd, R, D, n,
                                          log_g, vec, s);
  return (int)launch_scatter<int>(table, sorted_ids, perm, upd, R, D, n, log_g,
                                  vec, s);
}
