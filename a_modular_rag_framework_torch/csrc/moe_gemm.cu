// Grouped expert products of a mixture-of-experts layer for Hopper
// (sm_90a): wgmma on bf16 tiles fed by TMA through an mbarrier ring.
//
// Replaces no TPU kernel: the JAX package has no expert layer. It was
// added for DeepSeek-V2-Lite's routed experts (models/deepseek_v2.py,
// ops/moe.py), where each of 64 experts multiplies the tokens routed to it
// by its own weights: a product per expert over a varying number of rows.
//
// Two launches a layer. The tokens arrive permuted by expert (rows of
// expert e are rows offsets[e] .. offsets[e] + counts[e] of the permuted
// activations) and the work is cut into tiles of 128 rows of one expert x
// 256 output columns:
//
//   gate-up (MODE 0): h = SiLU(x . Wg^T) * (x . Wu^T), bf16 out. A tile's
//     256 columns are 128 gate columns and the same 128 up columns (two TMA
//     boxes side by side in the ring stage), so SiLU(g) * u is formed in
//     the registers that hold both and only h is written.
//   down (MODE 1): y = h . Wd^T, f32 out, each row scaled by its routing
//     weight and written to its slot's row (out_rows), so the combine back
//     to tokens is a fixed-order sum over each token's top-k slots.
//
// What bounds it on an H100: operations. At the benchmark's shape (about
// 960,000 routed slots a call, widths 2048 / 1408) a layer is 2*3*2048*1408
// operations a slot, 16.6 TFLOP, against 0.7 GB of expert weights and
// 12 GB of activations in and out: ~1,000 operations a byte, far above the
// card's ~295. So the design feeds the tensor cores: persistent blocks (one
// per SM) walk the tiles in order (the 11 or 8 column tiles of one row
// tile run side by side, sharing its rows in L2, and an expert's row tiles
// follow each other, sharing its weights); a producer warp keeps a 4-stage
// ring of 64-deep K chunks in flight (48 KB a stage: 128 rows of
// activations and 256 rows of weights, 128-byte swizzle); two consumer
// warpgroups each run wgmma m64n256k16 on their 64 rows, keeping one
// wgmma group in flight while the previous chunk's stage is released. The
// tile table (expert, first row, rows of each row tile, and their number)
// is computed on the card by ops/moe.py, so nothing waits for the host.
// Rows past an expert's end inside its last tile are computed from the
// next expert's rows (or TMA's zeros) and never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                  // rows per tile (2 x 64)
constexpr int kBN = 256;                  // output columns per tile
constexpr int kStages = 4;                // TMA ring depth
constexpr int kABytes = kBM * 128;        // 128 rows x 64 bf16
constexpr int kBHalf = 128 * 128;         // 128 weight rows x 64 bf16
constexpr int kStageBytes = kABytes + 2 * kBHalf;
constexpr int kThreads = 2 * 128 + 32;    // two consumer warpgroups + producer
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                         2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma operand in shared memory, K-major, 128-byte swizzle: rows of 128
// bytes (64 bf16), 8-row groups 1024 bytes apart; a k16 step within the
// row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);  // start address
  d |= static_cast<uint64_t>(1) << 16;                 // LBO (unused here)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;         // SBO: 8-row group
  d |= static_cast<uint64_t>(1) << 62;                 // 128B swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// keeps the compiler from moving the epilogue's accumulator reads above
// the wait for the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, bf16 in, f32 accumulate.
// Fragment: thread t of the warpgroup holds d[4j + {0,1}] at row
// 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t % 4) + {0,1}, and
// d[4j + {2,3}] eight rows below (j = 0 .. 31).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// One launch: every (row tile, column tile) pair, row tiles read from the
// tile table (n_mtiles[0] of them), column tiles `n_ntiles`, K in `KC`
// chunks of 64. MODE 0: amap is the permuted activations [rows, K], b0map /
// b1map the gate / up weights [E, F, K]; out is bf16 [rows, out_ld] and
// column tile j writes columns 128 j .. 128 j + 127. MODE 1: amap is h
// [rows, K], b0map = b1map the down weights [E, H, K]; out is f32
// [*, out_ld], row r of the permuted order goes to out row out_rows[r],
// scaled by row_scale[r], and column tile j writes 256 j .. 256 j + 255.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    moe_gemm(const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ CUtensorMap b0map,
             const __grid_constant__ CUtensorMap b1map,
             const int* __restrict__ tile_expert,
             const int* __restrict__ tile_row0,
             const int* __restrict__ tile_rows,
             const int* __restrict__ n_mtiles, int n_ntiles, int KC,
             void* __restrict__ out, int out_ld,
             const int* __restrict__ out_rows,
             const float* __restrict__ row_scale) {
  constexpr int kBStep = MODE == 0 ? 128 : 256;  // weight rows a column tile
  constexpr int kB1Off = MODE == 0 ? 0 : 128;    // second box's row offset
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kStages);
  const int tid = threadIdx.x;
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int total = n_mtiles[0] * n_ntiles;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_id >= 8) {  // producer warp: one thread issues every load
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int m = t / n_ntiles, nt = t % n_ntiles;
        const int e = tile_expert[m], r0 = tile_row0[m];
        for (int c = 0; c < KC; ++c) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, kStageBytes);
          const uint32_t base = smem_u32(smem + stage * kStageBytes);
          tma_load_2d(base, &amap, full0 + 8 * stage, c * 64, r0);
          tma_load_3d(base + kABytes, &b0map, full0 + 8 * stage, c * 64,
                      nt * kBStep, e);
          tma_load_3d(base + kABytes + kBHalf, &b1map, full0 + 8 * stage,
                      c * 64, nt * kBStep + kB1Off, e);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 ----
  const int wg = warp_id / 4;
  const int lane = tid % 32;
  const int lrow = wg * 64 + (warp_id % 4) * 16 + lane / 4;  // and lrow + 8
  const int lcol = 2 * (lane % 4);
  float acc[128];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int m = t / n_ntiles, nt = t % n_ntiles;
    const int r0 = tile_row0[m], rows = tile_rows[m];
    int prev = -1;
    for (int c = 0; c < KC; ++c) {
      mbar_wait(full0 + 8 * stage, phase);
      wgmma_fence();
      const uint32_t base = smem_u32(smem + stage * kStageBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16(acc, sw128_desc(base + wg * 8192 + 32 * kk),
                         sw128_desc(base + kABytes + 32 * kk),
                         (c | kk) != 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait1();  // the previous chunk's products are done
      if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait0();
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(empty0 + 8 * prev);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lrow + 8 * half;
      if (r >= rows) continue;
      if constexpr (MODE == 0) {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) +
                             (size_t)(r0 + r) * out_ld + nt * 128 + lcol;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int a = 4 * j + 2 * half, b = 4 * (j + 16) + 2 * half;
          __nv_bfloat162 h;
          h.x = __float2bfloat16(silu(acc[a]) * acc[b]);
          h.y = __float2bfloat16(silu(acc[a + 1]) * acc[b + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = h;
        }
      } else {
        const int slot = r0 + r;
        const float w = row_scale[slot];
        float* dst = static_cast<float*>(out) + (size_t)out_rows[slot] * out_ld +
                     nt * 256 + lcol;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int a = 4 * j + 2 * half;
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(w * acc[a], w * acc[a + 1]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// bf16 [planes, rows, K] (planes 1 for a 2-D tensor), boxes of box_rows x
// 64 columns, 128B swizzle; out-of-bounds rows and columns read as zero
cudaError_t make_map(CUtensorMap* map, const void* ptr, int planes, int rows,
                     int K, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2,
                                 (cuuint64_t)K * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const cuuint32_t rank = planes == 0 ? 2 : 3;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidPitchValue;
}

template <int MODE>
cudaError_t launch(const CUtensorMap& amap, const CUtensorMap& b0,
                   const CUtensorMap& b1, const int* tile_expert,
                   const int* tile_row0, const int* tile_rows,
                   const int* n_mtiles, int n_ntiles, int KC, void* out,
                   int out_ld, const int* out_rows, const float* row_scale,
                   int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gemm<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  moe_gemm<MODE><<<blocks, kThreads, kSmem, stream>>>(
      amap, b0, b1, tile_expert, tile_row0, tile_rows, n_mtiles, n_ntiles,
      KC, out, out_ld, out_rows, row_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: bf16 [rows, H], the routed tokens permuted by expert; w_gate, w_up:
// bf16 [E, F, H]; w_down: bf16 [E, H, F]; h: bf16 [rows, F] scratch; y: f32
// [out_rows_n, H]. The tile table (int32, device): tile_expert, tile_row0,
// tile_rows for each row tile of 128 (at most max_mtiles), n_mtiles[0] of
// them used; out_rows (int32) and row_scale (f32) per permuted row. H a
// multiple of 256, F of 128, both of 64 (K chunks); every pointer 16-byte
// aligned. Launches gate-up then down on `stream` with `blocks` persistent
// blocks each; does not synchronise, allocates nothing. Returns a
// cudaError_t (0 = both launches accepted; cudaErrorInvalidValue for
// arguments out of range; cudaErrorInvalidPitchValue where a tensor map is
// refused).
int moe_gemm_launch(const void* x, const void* w_gate, const void* w_up,
                    const void* w_down, void* h, void* y, int rows, int E,
                    int H, int F, const int* tile_expert, const int* tile_row0,
                    const int* tile_rows, const int* n_mtiles,
                    const int* out_rows, const float* row_scale, int blocks,
                    void* stream) {
  if (rows < 1 || E < 1 || H < 256 || H % 256 != 0 || F < 128 ||
      F % 128 != 0 || blocks < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap, umap, hmap, dmap;
  cudaError_t err = make_map(&xmap, x, 0, rows, H, kBM);
  if (err == cudaSuccess) err = make_map(&gmap, w_gate, E, F, H, 128);
  if (err == cudaSuccess) err = make_map(&umap, w_up, E, F, H, 128);
  if (err == cudaSuccess) err = make_map(&hmap, h, 0, rows, F, kBM);
  if (err == cudaSuccess) err = make_map(&dmap, w_down, E, H, F, 128);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  err = launch<0>(xmap, gmap, umap, tile_expert, tile_row0, tile_rows,
                  n_mtiles, F / 128, H / 64, h, F, nullptr, nullptr, blocks,
                  st);
  if (err != cudaSuccess) return (int)err;
  err = launch<1>(hmap, dmap, dmap, tile_expert, tile_row0, tile_rows,
                  n_mtiles, H / 256, F / 64, y, H, out_rows, row_scale,
                  blocks, st);
  return (int)err;
}

const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
