// Hopper tile machinery of the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu, the race's two-pass kernels of flash_probe.cu): TMA tensor
// maps and loads that complete on an mbarrier, the mbarrier ring,
// shared-memory matrix descriptors for the 128- and 64-byte swizzles,
// wgmma (operands in shared memory, or A in registers) and setmaxnreg.
// Nothing here is specific to attention.
//
// Layout of a tile in shared memory.  A (rows x HDP) bf16 tile, HDP the
// padded width (32, 64 or 128 columns), is stored as HDP / W panels of
// (rows x W), W = 64 columns (one 128-byte row, 128-byte swizzle) or, for
// HDP = 32, W = 32 (one 64-byte row, 64-byte swizzle).  TMA writes each
// panel as one box of (W, rows, 1) of a 3-D (hd, t, bh) tensor map, so
// the swizzle is the hardware's and the wgmma descriptors below read it
// back: K-major (the W columns are the product's K dim, rows its M or N)
// or MN-major (rows are the K dim, the W columns its N).  Columns past hd
// and rows past t are zero-filled by the tensor map.  Panel bases are
// multiples of 1024 bytes, as the swizzle pattern needs.
//
// Accumulator fragments (PTX ISA, "Register fragment layout for the
// accumulator matrix D" of wgmma .m64nNk16): warp w of the warpgroup owns
// rows 16 w .. 16 w + 15; d[4 j + e] is row 16 w + g + 8 (e >> 1), column
// 8 j + 2 tq + (e & 1), g = lane / 4, tq = lane % 4.  The A fragment of a
// 16-bit m64nNk16 product in registers has the same thread-to-element map
// for its 64 x 16 block, two values per register (the lower column in the
// low half): a[0] = (g, 2tq..+1), a[1] = (g + 8, 2tq..+1), a[2] = (g,
// 2tq + 8..+9), a[3] = (g + 8, 2tq + 8..+9).  So columns 16 kk .. 16 kk +
// 15 of an f32 accumulator, rounded pair by pair, are the A operand of the
// next product's k-step kk (frag_a below).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {
namespace wg {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the
// libraries link no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D map over a contiguous (n, rows, cols) bf16 array, boxes of
// (box_cols, box_rows, 1); reads past any edge fill zeros.
inline cudaError_t map_3d(CUtensorMap* map, const void* base, uint64_t cols,
                          uint64_t rows, uint64_t n, uint32_t box_cols,
                          uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cols, rows, n};
  const cuuint64_t strides[2] = {cols * 2, cols * rows * 2};  // bytes
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(base), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over n contiguous f32 values, boxes of `box` values; reads past n
// fill zeros.  Encoded as the one row of a 2-D map: only row 0 is
// addressed, so its stride is n * 4 rounded up to the 16 bytes a stride
// must be a multiple of.
inline cudaError_t map_row_f32(CUtensorMap* map, const void* base, uint64_t n,
                               uint32_t box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {n, 1};
  const cuuint64_t strides[1] = {(n * 4 + 15) / 16 * 16};
  const cuuint32_t boxes[2] = {box, 1};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(base), dims, strides, boxes, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (launches ask for
// 1024 bytes more than they use).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any thread uses the barriers.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for: the
// full box sizes of the TMA loads that complete on it (a box counts all
// its bytes, the zero-filled ones too).
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One test of the phase of parity `parity` (a fresh barrier is in phase 0:
// parity 1 passes at once).
__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A bound on bar_wait: waits of a sound protocol last microseconds.
constexpr uint32_t kWaitTrapNs = 2000000000u;

// Waits for the completion of the phase of parity `parity`, and traps when
// it has not completed within kWaitTrapNs of the device's nanosecond
// clock: a protocol fault (a wait on a phase that never comes) then fails
// the launch with an error instead of hanging the card.  After a first
// test, the loop is one asm block that holds the clock's low 32 bits
// (their difference is exact below 4.29 s) in one register: the waits sit
// where every accumulator register is live, and the same loop in C, with
// two more, spilled the race's two-pass kernel at hd 128 and 128-key tiles.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  uint32_t t0;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t0));
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 dt;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\n"
      "mov.u32 dt, %%globaltimer_lo;\n"
      "sub.u32 dt, dt, %2;\n"
      "setp.gt.u32 p, dt, %3;\n"
      "@p trap;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(t0), "n"(kWaitTrapNs)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Loads values [c0, c0 + box) of a map_row_f32 map; c0 must be a multiple
// of 4 (a box starts on 16 bytes).
__device__ __forceinline__ void tma_row(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(0)
      : "memory");
}

// A ring of S stages over tiles j = 0, 1, ...: tile j lives in stage j % S
// and its barriers' phase parity is (j / S) & 1.  full[s] completes when the
// producer's loads of the stage land; empty[s] when every consumer warp has
// released it.  The producer waits empty with the parity flipped, so its
// first pass over the ring does not wait.  A consumer waits for tile j
// before it releases it, even when it has no work on it: otherwise its
// release could count towards the stage's previous phase.
template <int S>
struct Ring {
  uint64_t full[S];
  uint64_t empty[S];

  __device__ void init(uint32_t consumer_arrivals) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], consumer_arrivals);
    }
  }
  static __device__ __forceinline__ int stage(int j) { return j % S; }
  static __device__ __forceinline__ uint32_t parity(int j) {
    return (uint32_t)(j / S) & 1u;
  }
  // Producer: waits for stage j % S to be free, then announces `bytes`.
  __device__ __forceinline__ void acquire(int j, uint32_t bytes) {
    bar_wait(&empty[stage(j)], parity(j) ^ 1u);
    bar_expect(&full[stage(j)], bytes);
  }
  // Consumer: waits for tile j's loads.
  __device__ __forceinline__ void wait(int j) {
    bar_wait(&full[stage(j)], parity(j));
  }
  // Consumer warp: done with tile j (lane 0 arrives for the warp).
  __device__ __forceinline__ void release(int j) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bar_arrive(&empty[stage(j)]);
  }
};

// ---------------------------------------------------------------------------
// register budget (warp specialisation)
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// shared-memory matrix descriptors
// ---------------------------------------------------------------------------

// start address, leading and stride byte offsets (16-byte units, 14 bits
// each), base offset 0 (panel bases are 1024-aligned) and layout type
// (1: 128-byte swizzle, 2: 64-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)layout << 62);
}

// A bf16 tile of ROWS rows and HDP (padded) columns in panels, as the file
// header describes.
template <int HDP, int ROWS>
struct Tile {
  static constexpr int kW = HDP >= 64 ? 64 : 32;  // columns per panel
  static constexpr int kRowBytes = kW * 2;        // 128 or 64
  static constexpr int kPanels = HDP / kW;
  static constexpr int kPanelBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;
  static constexpr uint32_t kLayout = kW == 64 ? 1u : 2u;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static_assert(HDP % kW == 0 && kPanelBytes % 1024 == 0, "panel layout");

  // Loads rows [row0, row0 + ROWS) of head bh, every panel, onto bar.
  static __device__ __forceinline__ void load(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0, int bh) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      tma_3d(dst + p * kPanelBytes, map, bar, p * kW, row0, bh);
    }
  }
  // K-major operand: rows [r0, r0 + 64) (M, or N = 64), columns
  // [16 kk, 16 kk + 16) (K).  8-row groups lie kRowBytes * 8 apart; the
  // leading offset is unused inside one swizzle row.
  static __device__ __forceinline__ uint64_t kmajor(const uint8_t* base,
                                                    int r0, int kk) {
    const int col = kk * 16;
    const uint32_t a = smem_u32(base) + (col / kW) * kPanelBytes +
                       r0 * kRowBytes + (col % kW) * 2;
    return make_desc(a, 16, 8 * kRowBytes, kLayout);
  }
  // MN-major operand: rows [16 kk, 16 kk + 16) (K), the kW columns of
  // panel p (N).  8-row groups along K lie kRowBytes * 8 apart (stride
  // offset); panels lie kPanelBytes apart (leading offset).
  static __device__ __forceinline__ uint64_t mnmajor(const uint8_t* base,
                                                     int kk, int p) {
    const uint32_t a =
        smem_u32(base) + p * kPanelBytes + kk * 16 * kRowBytes;
    return make_desc(a, kPanelBytes, 8 * kRowBytes, kLayout);
  }
};

// Returns CALL with HDP the padded tile width of the width `hd` in scope:
// 32, 64 or 128 (hd <= 128).
#define FF_WG_WIDTH_DISPATCH(CALL)                          \
  do {                                                      \
    if (hd <= 32) { constexpr int HDP = 32; return CALL; }  \
    if (hd <= 64) { constexpr int HDP = 64; return CALL; }  \
    { constexpr int HDP = 128; return CALL; }               \
  } while (0)

template <int HDP, int ROWS>
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int hd,
                            int t, int bh) {
  using L = Tile<HDP, ROWS>;
  return map_3d(map, base, hd, t, bh, L::kW, ROWS, L::kSwizzle);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous window of a wgmma.
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A . B^T, both bf16 in shared memory, K-major.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A . B, A bf16 in registers (fragment layout), B
// bf16 in shared memory, MN-major.
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) (+)= A . B, as mma_rs_n64.
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x W, W = 64 or 32) (+)= A (registers) . B (MN-major).
template <int W>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db, int accumulate) {
  if constexpr (W == 64) {
    mma_rs_n64(d, a, db, accumulate);
  } else {
    static_assert(W == 32, "wgmma N");
    mma_rs_n32(d, a, db, accumulate);
  }
}

// 2^x by the special-function unit (relative error below 2^-22; -inf and
// large negative x give 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from columns 16 kk .. 16 kk + 15 of an f32
// accumulator in fragment layout, rounded to bf16.
__device__ __forceinline__ void frag_a(uint32_t* a, const float* d, int kk) {
  const float* c = d + 8 * kk;
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// The accumulator element d[i]'s row half (0: row g, 1: row g + 8) and
// column (within the accumulator) for this thread.
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int tq) {
  return 8 * (i >> 2) + 2 * tq + (i & 1);
}

}  // namespace wg
}  // namespace ff
