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
// The row window of a row-sharded table.  A rank that holds rows
// [row_start, row_start + R) of a table split by row ranges over its mesh
// (flexflow_torch/ops/embedding.py) launches both kernels on its block
// with row_start and the global ids: each works on loc = id - row_start.
// In a windowed launch the gather writes a zero row where loc is outside
// [0, R) (JAX's masked take, whose psum over the shards then assembles
// full rows) and the scatter drops those updates in its binning pass.  A
// launch without a window is row_start = 0 with the NaN fill.
//
// What bounds the gather.  At the DLRM step (2048 ids, 256-byte rows) it
// moves 0.5 MB each way, 3.2e-4 ms at 3.35 TB/s; the launch and its chain
// of round trips (the ids, then the rows, then the stores draining) take
// ten times that.  So every row is in flight at once: a group of threads
// per id, each thread issuing its loads before its first store; and one
// launch serves up to three tables of one (R, D) gathered by the same ids
// (the lazy optimizers' param, m and v), one id load for all three.  A
// form that moved rows by cp.async.bulk through shared memory on an
// mbarrier, and one that handed a warp's ids out by __shfl_sync, were
// slower on the card (PERF.md §6).
//
// Scatter rows.  A group of G threads (G a power of two, <= 32, chosen by
// the wrapper so that G 16-byte vectors cover a row where they can) owns
// one row: 16-byte loads and stores when D % 4 == 0 and the pointers
// allow it, 4-byte ones otherwise.
//
// The scatter's arithmetic: each distinct row's updates are summed in f32
// from +0.0 in batch order, and the sum is added to the row once.  Rows
// have one writer each and every sum has a fixed order, so there is no
// atomic and two launches on the same inputs give the same bits.
//
// What bounds the scatter.  Its bytes are tiny (at the DLRM step, 2048 ids
// and 2048 x 64 f32 updates: 4.7e-4 ms at 3.35 TB/s), so it is bound by
// latency: the launches, the dependent loads, and for a row named k times
// a chain of k adds that must run in batch order.  The TPU form groups
// equal ids with a global sort (_collapse_runs); a library sort here is
// several launches and allocations, most of the time of the old port.  But
// the function needs no order between distinct rows, only that the
// updates of one row meet in one writer in batch order.  So the scatter
// bins instead of sorting, with no library call:
//
//   * CTA b of the G CTAs owns the rows whose hash (a fixed 64-bit integer
//     mix, so the stacked tables' offsets spread) scales to b.  Each
//     CTA streams the whole id vector in batch order with coalesced loads
//     and compacts the positions of its own ids, in batch order, with a
//     warp ballot and a popc prefix.
//   * It enters each of its ids in an open-addressed hash table (2 slots
//     per id) as it finds them, in rounds of reads, writes and checks
//     between barriers, with no atomics (a compare-and-swap per id
//     serialises on the slot of a row that repeats).
//     One warp then walks the entries in batch order 32 at a time
//     (__match_any_sync over slots): it numbers the distinct rows in order
//     of first appearance and counts them, scans the counts, and on a
//     second walk places each position in its row's segment, in batch
//     order.
//   * A group of G lanes per distinct row sums the segment's update rows
//     and writes the row once.  A row named
//     kLong times or more is summed by the whole CTA instead, through a
//     staging tile in shared memory, so that its segment streams with the
//     CTA's loads in flight and not one group's.
//
// Route, chosen on the host from n alone (the ids are never read back,
// which would cost a device-to-host sync; kernels.scatter_plan): while one
// CTA's shared memory holds the grouping arrays of all n ids
// (kBytesPerEntry each; the wrapper's cap is 4096 ids), even a flood of
// one row fits, and one launch does everything.  Above the cap the arrays
// live in a scratch the wrapper allocates (ff_scatter_scratch_bytes): a
// first launch counts each CTA's ids, and the same kernel, its CTA's
// region placed by those counts, bins into the scratch.  Every CTA reads all n ids (from
// L2), so this route costs G x n id reads; it serves batches above the
// DLRM step's.  A row named k times is still a chain of k dependent adds:
// a heavily skewed batch is bound by that chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// K4: row gather
// ---------------------------------------------------------------------------

// Tables one launch gathers by the same ids (the lazy optimizers' param and
// state tables) and their outputs.
constexpr int kMaxTables = 3;

struct Tables {
  const float* table[kMaxTables];
  float* out[kMaxTables];
};

__device__ __forceinline__ float nan_row(float) {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float4 nan_row(float4) {
  const float x = __int_as_float(0x7fc00000);
  return make_float4(x, x, x, x);
}

// The value of a row the launch does not hold: zeros in a windowed launch,
// else NaN.
template <typename V>
__device__ __forceinline__ V fill_row(bool window) {
  return window ? V{} : nan_row(V{});
}

// Row `row` of table t, as `cols` values of type V.
template <typename V>
__device__ __forceinline__ const V* src_row(const Tables& p, int t,
                                            long long row, int cols) {
  return reinterpret_cast<const V*>(p.table[t]) + (size_t)row * cols;
}

// A group of 2^log_g threads per id (the wrapper's choice: enough 16-byte
// vectors, or floats, to cover a row where 32 threads can), V = float4 for
// 16-byte rows and pointers, else float.  Each thread loads its id (the
// group's loads of one id coalesce into one request) and issues its loads
// from every table, kBatch columns apart, before its first store.  The
// grid is at most one wave; threads past it loop.  The tables hold rows
// [start, start + R) (module comment).
template <typename Id, typename V, int T>
__global__ void __launch_bounds__(kThreads)
gather_regs_kernel(Tables p, const Id* __restrict__ ids, long long start,
                   long long R, int cols, int n, int log_g, bool window) {
  constexpr int kBatch = T == 1 ? 4 : 2;  // columns a thread holds a table
  const int G = 1 << log_g;
  const long long all = (long long)n << log_g;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < all;
       t += (long long)gridDim.x * kThreads) {
    const long long i = t >> log_g;
    const int lane = (int)(t & (G - 1));
    const long long row = (long long)__ldg(ids + i) - start;
    const bool live = row >= 0 && row < R;
    for (int c0 = lane; c0 < cols; c0 += G * kBatch) {
      V val[T][kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k * G;
        if (c >= cols) break;
#pragma unroll
        for (int u = 0; u < T; ++u)
          val[u][k] = live ? __ldg(src_row<V>(p, u, row, cols) + c)
                           : fill_row<V>(window);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k * G;
        if (c >= cols) break;
#pragma unroll
        for (int u = 0; u < T; ++u)
          reinterpret_cast<V*>(p.out[u])[(size_t)i * cols + c] = val[u][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5: binned scatter-add
// ---------------------------------------------------------------------------

typedef unsigned long long u64;

// Ids a thread reads per chunk of the compaction (a warp's span of the
// chunk is 32 x kPer consecutive ids): the DLRM step's 2048 are one chunk.
constexpr int kPer = 8;
// Staged update rows a thread reads ahead while it sums a long segment.
constexpr int kStageBatch = 16;
// A row named at least kLong times is summed by the whole CTA through a
// staging tile in shared memory: one group has too few loads in flight to
// stream a long segment (16 lanes x 16 rows of 16 bytes is 4 KiB in
// flight, where the CTA's 256 threads keep 32 KiB).  Each thread stages up
// to kStageLoads vectors per tile; the binned route stages through
// kStageBytes of shared memory, the single-launch route through its hash
// table, dead by then.
constexpr int kLong = 64;
constexpr int kStageLoads = 8;
constexpr int kStageBytes = kStageLoads * kThreads * 16;
// Bytes of grouping arrays per id (see Groups), and the dynamic shared
// memory a CTA may take beside the compaction's few static words: the
// single-launch route takes n ids while n x kBytesPerEntry fits it (4468).
constexpr int kBytesPerEntry = 52;
constexpr int kMaxDynamicShared = 232448 - 64;
constexpr u64 kEmpty = ~0ull;

// splitmix64's finaliser: spreads consecutive rows (the tables' offsets
// plus small ids) over owners and hash slots.
__device__ __forceinline__ u64 mix(u64 x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// Owner CTA and hash slot: the hash's low and high halves scaled to the
// range by a multiply (no division).
__device__ __forceinline__ int owner(u64 row, int ctas) {
  return (int)(((mix(row) & 0xffffffffull) * (u64)ctas) >> 32);
}

__device__ __forceinline__ int home_slot(u64 row, int slots) {
  return (int)(((mix(row) >> 32) * (u64)slots) >> 32);
}

// One CTA's grouping arrays: m entries (ids it owns), nd distinct rows.
// Carved from memory laid out for `cap` entries (shared memory, or the
// scratch), the CTA's region starting at entry e0.
struct Groups {
  u64* keys;    // [P] hash slots: kEmpty or a row (P = 2 cap, or 2 m)
  u64* row;     // [nd] the row of distinct d
  int* pos;     // [m] batch positions of the CTA's ids, in batch order
  int* slot;    // [m] the hash slot of each entry
  int* dist;    // [P] the distinct index of a slot (-1: none yet)
  int* cnt;     // [nd] updates of distinct d
  int* off;     // [nd] start, after placement end, of d's segment
  int* sorted;  // [m] positions grouped by row, batch order within each
};

__device__ __forceinline__ Groups carve(unsigned char* base, long long cap,
                                        long long e0) {
  u64* w = reinterpret_cast<u64*>(base);
  int* i = reinterpret_cast<int*>(w + 3 * cap);
  Groups g;
  g.keys = w + 2 * e0;
  g.row = w + 2 * cap + e0;
  g.pos = i + e0;
  g.slot = i + cap + e0;
  g.dist = i + 2 * cap + 2 * e0;
  g.cnt = i + 4 * cap + e0;
  g.off = i + 5 * cap + e0;
  g.sorted = i + 6 * cap + e0;
  return g;
}

__device__ __forceinline__ void add_to(float& acc, float u) { acc += u; }

__device__ __forceinline__ void add_to(float4& acc, const float4& u) {
  acc.x += u.x;
  acc.y += u.y;
  acc.z += u.z;
  acc.w += u.w;
}

// Sums updates sorted[begin, end) of one row in batch order from +0.0 and
// adds the sum to the row once; the group's lanes split the columns.
template <bool kVec>
__device__ __forceinline__ void add_segment(float* __restrict__ dst,
                                            const float* __restrict__ upd,
                                            const int* sorted, int begin,
                                            int end, int D, int lane,
                                            int width) {
  if (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* u4 = reinterpret_cast<const float4*>(upd);
    const int D4 = D / 4;
    for (int c = lane; c < D4; c += width) {
      float4 v = d4[c];  // in flight while the updates are summed
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = begin; j < end; ++j)
        add_to(acc, __ldg(u4 + (size_t)sorted[j] * D4 + c));
      add_to(v, acc);
      d4[c] = v;
    }
  } else {
    for (int c = lane; c < D; c += width) {
      const float v = dst[c];
      float acc = 0.f;
      for (int j = begin; j < end; ++j) acc += __ldg(upd + (size_t)sorted[j] * D + c);
      dst[c] = v + acc;
    }
  }
}

// The whole CTA sums segment sorted[begin, end) of one row, tile by tile
// through `stage` (tile_rows update rows of `cols` vectors), thread t < cols
// owning column t: the same adds, in the same order, as add_segment.
template <typename V>
__device__ __forceinline__ void add_segment_staged(
    V* __restrict__ dst, const V* __restrict__ upd, const int* sorted,
    int begin, int end, int cols, int tile_rows, V* stage) {
  const int t = threadIdx.x;
  V v{}, acc{};
  if (t < cols) v = dst[t];
  for (int t0 = begin; t0 < end; t0 += tile_rows) {
    const int elems = min(tile_rows, end - t0) * cols;
    V buf[kStageLoads];
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int i = min(t + k * kThreads, elems - 1);
      const int r = i / cols;
      buf[k] = __ldg(upd + (size_t)sorted[t0 + r] * cols + (i - r * cols));
    }
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k)
      if (t + k * kThreads < elems) stage[t + k * kThreads] = buf[k];
    __syncthreads();
    if (t < cols) {
      for (int i = t; i < elems; i += kStageBatch * cols) {
        V u[kStageBatch];
#pragma unroll
        for (int k = 0; k < kStageBatch; ++k)
          u[k] = stage[min(i + k * cols, elems - cols + t)];
#pragma unroll
        for (int k = 0; k < kStageBatch; ++k)
          if (i + k * cols < elems) add_to(acc, u[k]);
      }
    }
    __syncthreads();  // the stage is refilled next
  }
  if (t < cols) {
    add_to(v, acc);
    dst[t] = v;
  }
}

// Grid: `ctas` CTAs, CTA b owning the rows with owner(row) == b, a row being
// id - start (the window, module comment).  With
// kShared its arrays are in dynamic shared memory laid out for n entries
// (the compiler then issues shared loads and stores, not generic
// ones); otherwise in `scratch`, laid out for n entries, its region after
// the ids that CTAs 0..b-1 own (counts[c], from count_owned_kernel).
template <typename Id, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float* __restrict__ table, const Id* __restrict__ ids,
                        const float* __restrict__ upd, long long start,
                        long long R, int D, int n, int log_g,
                        const int* __restrict__ counts,
                        unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[kWarps];
  __shared__ int nd_s, nl_s;
  const int ctas = gridDim.x, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1;
  Groups g;
  if constexpr (kShared) {
    g = carve(smem, n, 0);
  } else {
    long long e0 = 0;
    for (int c = 0; c < b; ++c) e0 += counts[c];
    g = carve(scratch, n, e0);
  }

  // 1. The positions of this CTA's ids in batch order, each id's row
  // entered in the hash table (2 slots per id it can own) as it is found.
  const int P = 2 * (kShared ? n : counts[b]);
  if (P == 0) return;
  for (int s = threadIdx.x; s < P; s += kThreads) {
    g.keys[s] = kEmpty;
    g.dist[s] = -1;
  }
  __syncthreads();
  int m = 0;
  for (int base = 0; base < n; base += kThreads * kPer) {
    const int w0 = base + warp * 32 * kPer;
    u64 rows[kPer];
    unsigned own[kPer];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = w0 + j * 32 + lane;
      rows[j] = i < n ? (u64)((long long)__ldg(ids + i) - start) : kEmpty;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = (long long)rows[j] >= 0 && (long long)rows[j] < R &&
                      owner(rows[j], ctas) == b;
      own[j] = __ballot_sync(0xffffffffu, ok);
      mine += __popc(own[j]);
    }
    if (lane == 0) wsum[warp] = mine;
    __syncthreads();
    int at = m, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? wsum[w] : 0;
      all += wsum[w];
    }
    const int at0 = at;
    int slot[kPer];
    bool open = false;  // an id of this thread has no slot yet
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      slot[j] = -1;
      if ((own[j] >> lane) & 1u) {
        g.pos[at + __popc(own[j] & lt)] = w0 + j * 32 + lane;
        slot[j] = home_slot(rows[j], P);
        open = true;
      }
      at += __popc(own[j]);
    }
    // Rounds of linear probing without atomics.  Between barriers an id
    // reads the table, walking past slots of other rows to its row's slot
    // (done) or to the first empty one; every id of one row reaches the
    // same one.  Then it writes its row there; after a barrier one row
    // survives in the slot and owns it for good, and the ids of the rows
    // that lost walk on in the next round.
    while (__syncthreads_or(open)) {
      bool write[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        write[j] = false;
        if (slot[j] < 0) continue;
        int s = slot[j];
        while (g.keys[s] != kEmpty && g.keys[s] != rows[j]) s = s + 1 == P ? 0 : s + 1;
        write[j] = g.keys[s] == kEmpty;
        slot[j] = s;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (write[j]) g.keys[slot[j]] = rows[j];
      __syncthreads();
      open = false;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        open |= write[j] && g.keys[slot[j]] != rows[j];
    }
    at = at0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((own[j] >> lane) & 1u) g.slot[at + __popc(own[j] & lt)] = slot[j];
      at += __popc(own[j]);
    }
    m += all;
  }
  if (m == 0) return;

  // 2. One warp, in batch order: number and count the distinct rows, scan
  // the counts, place each position in its row's segment.
  if (warp == 0) {
    int nd = 0;
    for (int e0 = 0; e0 < m; e0 += 32) {
      const int e = e0 + lane;
      const bool live = e < m;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      int s = 0, d = 0;
      unsigned peers = 0;
      if (live) {
        s = g.slot[e];
        peers = __match_any_sync(mask, s);
        d = g.dist[s];
      }
      const bool lead = live && (peers & lt) == 0;  // the earliest of its row
      const unsigned fresh = __ballot_sync(0xffffffffu, lead && d < 0);
      if (lead && d < 0) {
        d = nd + __popc(fresh & lt);
        g.dist[s] = d;
        g.row[d] = g.keys[s];
        g.cnt[d] = 0;
      }
      if (lead) g.cnt[d] += __popc(peers);
      nd += __popc(fresh);
      __syncwarp();
    }
    int run = 0;
    for (int d0 = 0; d0 < nd; d0 += 32) {
      const int d = d0 + lane;
      const int c = d < nd ? g.cnt[d] : 0;
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (d < nd) g.off[d] = run + x - c;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
    __syncwarp();
    for (int e0 = 0; e0 < m; e0 += 32) {
      const int e = e0 + lane;
      const bool live = e < m;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      int d = 0;
      unsigned peers = 0;
      if (live) {
        d = g.dist[g.slot[e]];
        peers = __match_any_sync(mask, d);
        g.sorted[g.off[d] + __popc(peers & lt)] = g.pos[e];
      }
      __syncwarp();
      if (live && (peers & lt) == 0) g.off[d] += __popc(peers);
      __syncwarp();
    }
    // The rows named kLong times or more, listed in pos (dead by now).
    int nl = 0;
    for (int d0 = 0; d0 < nd; d0 += 32) {
      const int d = d0 + lane;
      const bool named = d < nd && g.cnt[d] >= kLong;
      const unsigned longs = __ballot_sync(0xffffffffu, named);
      if (named) g.pos[nl + __popc(longs & lt)] = d;
      nl += __popc(longs);
    }
    if (lane == 0) {
      nd_s = nd;
      nl_s = nl;
    }
  }
  __syncthreads();

  // 3. One group of 2^log_g lanes per distinct row; the whole CTA per
  // long one, where a staging tile holds an update row and a thread owns a
  // column.
  typedef typename std::conditional<kVec, float4, float>::type V;
  const int nd = nd_s;
  const int width = 1 << log_g;
  const int cols = kVec ? D / 4 : D;
  V* stage = reinterpret_cast<V*>(kShared ? reinterpret_cast<unsigned char*>(g.keys)
                                          : smem);
  const int stage_bytes = kShared ? 16 * n : kStageBytes;
  const int tile_rows =
      min(kStageLoads * kThreads, stage_bytes / (int)sizeof(V)) / cols;
  const bool staging = cols <= kThreads && tile_rows > 0;
  for (int d = threadIdx.x >> log_g; d < nd; d += kThreads >> log_g) {
    if (staging && g.cnt[d] >= kLong) continue;
    const int end = g.off[d];
    add_segment<kVec>(table + (size_t)g.row[d] * D, upd, g.sorted,
                      end - g.cnt[d], end, D, threadIdx.x & (width - 1),
                      width);
  }
  if (!staging) return;
  for (int k = 0; k < nl_s; ++k) {
    const int d = g.pos[k];
    const int end = g.off[d];
    add_segment_staged<V>(reinterpret_cast<V*>(table + (size_t)g.row[d] * D),
                          reinterpret_cast<const V*>(upd), g.sorted,
                          end - g.cnt[d], end, cols, tile_rows, stage);
  }
}

// counts[b] = the number of ids CTA b of the scatter owns.
template <typename Id>
__global__ void __launch_bounds__(kThreads)
count_owned_kernel(const Id* __restrict__ ids, long long start, long long R,
                   int n, int* __restrict__ counts) {
  __shared__ int wsum[kWarps];
  int c = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long r = (long long)__ldg(ids + i) - start;
    c += r >= 0 && r < R && owner((u64)r, gridDim.x) == (int)blockIdx.x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 0;
    for (int w = 0; w < kWarps; ++w) all += wsum[w];
    counts[blockIdx.x] = all;
  }
}

template <typename Id, typename V>
cudaError_t launch_regs(const Tables& p, int T, const Id* ids, long long start,
                        long long R, int cols, int n, int log_g, bool window,
                        int ctas, cudaStream_t s) {
  if (T == 1)
    gather_regs_kernel<Id, V, 1><<<ctas, kThreads, 0, s>>>(
        p, ids, start, R, cols, n, log_g, window);
  else if (T == 2)
    gather_regs_kernel<Id, V, 2><<<ctas, kThreads, 0, s>>>(
        p, ids, start, R, cols, n, log_g, window);
  else
    gather_regs_kernel<Id, V, 3><<<ctas, kThreads, 0, s>>>(
        p, ids, start, R, cols, n, log_g, window);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_gather(const Tables& p, int T, const void* ids,
                          long long start, long long R, int D, int n, int vec,
                          int log_g, bool window, int ctas, cudaStream_t s) {
  const Id* id = static_cast<const Id*>(ids);
  if (vec)
    return launch_regs<Id, float4>(p, T, id, start, R, D / 4, n, log_g,
                                   window, ctas, s);
  return launch_regs<Id, float>(p, T, id, start, R, D, n, log_g, window, ctas,
                                s);
}

template <typename Id, bool kVec>
cudaError_t launch_scatter(float* table, const Id* ids, const float* upd,
                           long long start, long long R, int D, int n,
                           int log_g, int ctas, unsigned char* scratch,
                           long long scratch_bytes, cudaStream_t stream) {
  if (scratch == nullptr) {
    auto* kernel = scatter_add_rows_kernel<Id, kVec, true>;
    if ((long long)kBytesPerEntry * n > kMaxDynamicShared)
      return cudaErrorInvalidValue;
    const int smem = kBytesPerEntry * n;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<ctas, kThreads, smem, stream>>>(table, ids, upd, start, R, D, n,
                                             log_g, nullptr, nullptr);
    return cudaGetLastError();
  }
  const long long arrays = (long long)kBytesPerEntry * n;
  if (scratch_bytes < arrays + 4LL * ctas) return cudaErrorInvalidValue;
  int* counts = reinterpret_cast<int*>(scratch + arrays);
  count_owned_kernel<Id><<<ctas, kThreads, 0, stream>>>(ids, start, R, n,
                                                        counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_add_rows_kernel<Id, kVec, false>
      <<<ctas, kThreads, kStageBytes, stream>>>(table, ids, upd, start, R, D,
                                                n, log_g, counts, scratch);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t dispatch_scatter(void* table, const void* ids, const void* upd,
                             long long start, long long R, int D, int n,
                             int log_g, int vec, int ctas, void* scratch,
                             long long scratch_bytes, cudaStream_t s) {
  float* tb = static_cast<float*>(table);
  const Id* id = static_cast<const Id*>(ids);
  const float* u = static_cast<const float*>(upd);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (vec)
    return launch_scatter<Id, true>(tb, id, u, start, R, D, n, log_g, ctas,
                                    sc, scratch_bytes, s);
  return launch_scatter<Id, false>(tb, id, u, start, R, D, n, log_g, ctas, sc,
                                   scratch_bytes, s);
}

bool bad_args(long long R, int D, int n, int log_g) {
  return R < 1 || D < 1 || n < 1 || log_g < 0 || log_g > 5 ||
         ((long long)n << log_g) / kThreads >= 0x7fffffffLL;
}

}  // namespace

// T in [1, 3] tables t0..t2, each (R, D) f32, gathered into o0..o2, each
// (n, D) f32, by the same ids: (n,) int32 (id64 = 0) or int64 (id64 = 1).
// All contiguous on the device; vec = 1 only when D % 4 == 0 and every
// table and output is 16-byte aligned.  2^log_g threads per id, ctas the
// grid.  The tables hold rows [row_start, row_start + R) of the ids'
// range; window = 1 writes zero rows for ids outside it, window = 0 (with
// row_start = 0) NaN rows.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int ff_gather_rows(int T, const void* t0, const void* t1,
                              const void* t2, void* o0, void* o1, void* o2,
                              const void* ids, long long R, int D, int n,
                              int id64, int vec, int log_g, int ctas,
                              long long row_start, int window, void* stream) {
  if (T < 1 || T > kMaxTables || bad_args(R, D, n, log_g) || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const Tables p = {{static_cast<const float*>(t0),
                     static_cast<const float*>(t1),
                     static_cast<const float*>(t2)},
                    {static_cast<float*>(o0), static_cast<float*>(o1),
                     static_cast<float*>(o2)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id64)
    return (int)launch_gather<long long>(p, T, ids, row_start, R, D, n, vec,
                                         log_g, window != 0, ctas, s);
  return (int)launch_gather<int>(p, T, ids, row_start, R, D, n, vec, log_g,
                                 window != 0, ctas, s);
}

// table: (R, D) f32, rows [row_start, row_start + R) of the ids' range,
// updated in place (updates of ids outside it are dropped); ids: (n,)
// int32 or int64 in batch order; upd: (n, D) f32.  All contiguous on the device; vec = 1 only when
// D % 4 == 0 and table and upd are 16-byte aligned.  ctas: the grid (the
// owners of the rows), in [1, 1024].  scratch null: one launch, binning
// in shared memory (n x kBytesPerEntry must fit it); else a counting
// launch and the binning launch over scratch, which holds
// ff_scatter_scratch_bytes(n, ctas) bytes, 8-byte aligned.  Returns the
// first launch's error (0 = launched).
extern "C" int ff_scatter_add_rows(void* table, const void* ids,
                                   const void* upd, long long R, int D, int n,
                                   int log_g, int id64, int vec, int ctas,
                                   void* scratch, long long scratch_bytes,
                                   long long row_start, void* stream) {
  if (bad_args(R, D, n, log_g) || n > (1 << 30) || ctas < 1 || ctas > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id64)
    return (int)dispatch_scatter<long long>(table, ids, upd, row_start, R, D,
                                            n, log_g, vec, ctas, scratch,
                                            scratch_bytes, s);
  return (int)dispatch_scatter<int>(table, ids, upd, row_start, R, D, n,
                                    log_g, vec, ctas, scratch, scratch_bytes,
                                    s);
}

// Bytes of the scratch ff_scatter_add_rows's two-launch route takes for n
// ids over ctas CTAs: the grouping arrays, then one count per CTA.
extern "C" long long ff_scatter_scratch_bytes(long long n, int ctas) {
  return (long long)kBytesPerEntry * n + 4LL * ctas;
}
