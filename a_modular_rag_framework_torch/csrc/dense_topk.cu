// Fused dense similarity + exact top-k for Hopper (sm_90a): wgmma on bf16
// planes, fed by TMA through an mbarrier ring.
//
// Replaces a_modular_rag_framework_tpu/ops/topk.py::dense_topk_pallas (its
// body is _topk_kernel): for each query row, top_k(q . D^T) over the whole
// corpus, without ever writing the [B, N] score matrix to device memory.
// Order is (score descending, id ascending) -- lax.top_k's tie order -- and
// rows >= N never win, even against all-negative scores.
//
// What bounds it on an H100: the scores, 2*B*N*d operations. At the
// engine's main shape (B 4096 x N 1,034,000 x d 64, bf16 corpus) that is
// 5.4e11, against 0.13 GB of corpus: far above the card's ~295 operations
// per byte, so the tensor cores, not memory, are the limit. The results
// stay f32-faithful: the wrapper splits each f32 query row exactly into
// three bf16 planes (hi + mid + lo == q, ops/topk.py::split_bf16x3), each
// plane x bf16-corpus product is exact in f32 and wgmma accumulates in
// f32, so the scores are the f32 dot products up to summation order (and
// bit-exact on integer-valued inputs). That is three bf16 passes: 1.64 ms
// at 989 TFLOP/s at the main shape. An f32 corpus is split the same way
// and the plane pairs (i, j) with i + j <= 2 are kept (six passes); the
// dropped terms are below f32 resolution.
//
// The design:
//
//   pass 1, grid = (query tiles, fastest) x (corpus splits), about one
//     block per SM (ops/topk.py chooses the splits). A block holds NWG x 64
//     query rows: NWG consumer warpgroups of 64 rows and one producer
//     warp. The producer TMA-loads the three Q planes once (they stay
//     resident), then streams the split's corpus in tiles of 128 rows x 64
//     bf16 columns (one 128-byte swizzle row each) through a 3-stage ring
//     with full / empty mbarriers; TMA zero-fills rows >= N and columns
//     >= d. Per tile each consumer warpgroup issues (d/16) x 3
//     wgmma.mma_async m64n128k16 into 64 f32 registers per thread. The
//     query tile is the fastest grid index, so the blocks resident at one
//     time share corpus splits and the corpus is read from HBM about
//     once, then served from L2. NWG = 2 where the resident planes and
//     the lists fit shared memory (d <= 128, k small), else 1.
//   selection, from the accumulators: each thread owns two query rows and
//     keeps their current k-th (score, id) in registers. A quick pass per
//     tile counts, per row, its scores that reach the threshold; one or
//     two go to a 32-slot per-row buffer in shared memory (a shared atomic
//     on the row's count). Three or more, a full buffer, or the split's
//     last tile take a branch-free pass over all 64 scores. A warp's 16
//     rows are its own, so no block barrier is needed: when a buffer would
//     overflow, and after the split's last tile, the warp sorts each
//     buffer (a 32-lane bitonic sort) and merges it with the row's sorted
//     list in one step (each element's rank by binary search), then
//     refreshes the thresholds and retries what did not fit. The lists
//     live in shared memory where they fit, else in the partial outputs
//     [B, S, k]. The first tile of a split starts from a lower bound of
//     each row's k-th best score (k <= 32), so warm-up is one merge, not
//     k insertions.
//   pass 2, one warp per row: a k-round merge of the S sorted lists (each
//     round a warp arg-best over the list heads), ties broken by list.
//
// What holds it back: the selection runs on the consumer warpgroups
// between their wgmma batches, so the tensor cores idle whenever both
// warpgroups select at once. tools/profile_dense_topk.py times the kernel
// against a copy without the selection; PERF.md has the numbers.
// Overlapping the two needs a second accumulator per warpgroup.
//
// The TPU kernel ran its corpus tiles in order on one core and carried the
// running top-k from step to step; here blocks run in parallel and in no
// order, hence the split + merge.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTN = 128;                  // corpus rows per tile (wgmma N)
constexpr int kStages = 3;                // TMA ring depth
constexpr int kCand = 32;                 // candidate slots per query row
constexpr int kMaxK = 256;
constexpr int kMaxD = 256;         // resident query planes
constexpr int kMaxDStream = 2048;  // query planes streamed with the corpus
constexpr int kMaxSplits = 1024;
constexpr int kIdNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBoxBytes = 64 * 128;       // 64 rows x 64 bf16
constexpr int kStageBytes = kTN * 128;    // 128 rows x 64 bf16
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;

// (score desc, id asc)
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// ... and the list index last, so the merge's order is total
__device__ __forceinline__ bool better3(float s, int i, int l, float t, int j,
                                        int m) {
  return s > t || (s == t && (i < j || (i == j && l < m)));
}

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

// keeps the compiler from moving accumulator reads / writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, bf16 in, f32 accumulate.
// Fragment: thread t of the warpgroup holds d[4j + {0,1}] at row
// 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t % 4) + {0,1}, and
// d[4j + {2,3}] eight rows below.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Merge the candidate buffer of local row `lr` (n <= 32 entries, in any
// order) into the row's sorted list L (length k, in device memory) and
// publish the new k-th entry as the row's threshold. One warp.
__device__ __forceinline__ void merge_row(float* cs_row, int* ci_row, int n,
                                          float* Ls, int* Li, int k,
                                          float* thr_s, int* thr_i, int lane) {
  float cs = lane < n ? cs_row[lane] : -INFINITY;
  int ci = lane < n ? ci_row[lane] : kIdNone;
  // bitonic sort over the 32 lanes, best first
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(kFull, cs, stride);
      const int oi = __shfl_xor_sync(kFull, ci, stride);
      const bool keep_better = ((lane & size) == 0) == ((lane & stride) == 0);
      if (keep_better == better(os, oi, cs, ci)) {
        cs = os;
        ci = oi;
      }
    }
  }
  cs_row[lane] = cs;
  ci_row[lane] = ci;
  float ls[kMaxK / 32];
  int li[kMaxK / 32], pe[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    if (e < k) {
      ls[j] = Ls[e];
      li[j] = Li[e];
    }
  }
  __syncwarp();
  // rank of each candidate: its lane + list entries better than it
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(Ls[mid], Li[mid], cs, ci))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int pc = lane + lo;
  // rank of each list entry: its index + candidates better than it
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    if (e < k) {
      int a = 0, b = n;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (better(cs_row[mid], ci_row[mid], ls[j], li[j]))
          a = mid + 1;
        else
          b = mid;
      }
      pe[j] = e + a;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    if (e < k && pe[j] < k) {
      Ls[pe[j]] = ls[j];
      Li[pe[j]] = li[j];
      if (pe[j] == k - 1) {
        *thr_s = ls[j];
        *thr_i = li[j];
      }
    }
  }
  if (lane < n && pc < k) {
    Ls[pc] = cs;
    Li[pc] = ci;
    if (pc == k - 1) {
      *thr_s = cs;
      *thr_i = ci;
    }
  }
  __syncwarp();
}

// Q planes [3, B, dpad] and the corpus planes [P, N, dpad] (bf16) arrive
// through tensor maps with 64 x 64 and 64 x 128 boxes. With smem_lists
// the running lists live in shared memory and are copied to part_s /
// part_i at the end; otherwise the merges work on part_s / part_i. With
// STREAM the query planes' chunks ride in the ring beside the corpus's
// (no resident planes) and blockIdx.x is the split, blockIdx.y the query
// tile.
template <int NWG, int P, bool STREAM>
__global__ void __launch_bounds__(NWG * 128 + 32)
    topk_partial(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap dmap, int B, int N,
                 int KC, int k, int S, int slice, int smem_lists,
                 float* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int kRows = NWG * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kQStage = 3 * NWG * kBoxBytes;  // a stage's query chunk
  uint8_t* qs = smem;  // resident: [3][KC][NWG] boxes; STREAM: [kStages]
  uint8_t* ring = qs + (STREAM ? kStages * kQStage : 3 * KC * NWG * kBoxBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  float* cand_s = reinterpret_cast<float*>(bars + 2 * kStages + 2);
  int* cand_i = reinterpret_cast<int*>(cand_s + kRows * kCand);
  int* cnt = cand_i + kRows * kCand;
  float* thr_s = reinterpret_cast<float*>(cnt + kRows);
  int* thr_i = reinterpret_cast<int*>(thr_s + kRows);
  float* lst_s = reinterpret_cast<float*>(thr_i + kRows);  // [kRows][k]
  int* lst_i = reinterpret_cast<int*>(lst_s + kRows * k);

  const int tid = threadIdx.x;
  // warp-uniform for the compiler too, so the consumers' wgmma path is not
  // seen as divergent
  const int warp_id = __shfl_sync(kFull, tid / 32, 0);
  const int row0 = (STREAM ? blockIdx.y : blockIdx.x) * kRows;
  const int split = STREAM ? blockIdx.x : blockIdx.y;
  const int n_begin = split * slice;  // slice is a multiple of kTN
  const int n_end = min(N, n_begin + slice);
  const int tiles = n_end > n_begin ? (n_end - n_begin + kTN - 1) / kTN : 0;
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kStages);
  const uint32_t qbar = smem_u32(bars + 2 * kStages);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWG * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_id >= NWG * 4) {  // producer warp: one thread issues every load
    if (tid == NWG * 128) {
      if constexpr (!STREAM) {
        mbar_expect_tx(qbar, 3 * KC * NWG * kBoxBytes);
        for (int i = 0; i < 3; ++i)
          for (int c = 0; c < KC; ++c)
            for (int w = 0; w < NWG; ++w)
              tma_load_3d(smem_u32(qs + ((i * KC + c) * NWG + w) * kBoxBytes),
                          &qmap, qbar, c * 64, row0 + w * 64, i);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t)
        for (int c = 0; c < KC; ++c)
          for (int p = 0; p < P; ++p) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            mbar_expect_tx(full0 + 8 * stage,
                           kStageBytes + (STREAM ? kQStage : 0));
            tma_load_3d(smem_u32(ring + stage * kStageBytes), &dmap,
                        full0 + 8 * stage, c * 64, n_begin + t * kTN, p);
            if constexpr (STREAM) {
              for (int i = 0; i < 3; ++i)
                for (int w = 0; w < NWG; ++w)
                  tma_load_3d(smem_u32(qs + stage * kQStage +
                                       (i * NWG + w) * kBoxBytes),
                              &qmap, full0 + 8 * stage, c * 64,
                              row0 + w * 64, i);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int lane = tid % 32;
  const int wrow = wg * 64 + warp * 16;  // this warp's 16 local rows
  const int lrow = wrow + lane / 4;      // this thread's rows: lrow, lrow + 8
  auto list_s = [&](int lr) {
    return smem_lists ? lst_s + lr * k
                      : part_s + ((size_t)(row0 + lr) * S + split) * k;
  };
  auto list_i = [&](int lr) {
    return smem_lists ? lst_i + lr * k
                      : part_i + ((size_t)(row0 + lr) * S + split) * k;
  };
  for (int r = 0; r < 16; ++r) {
    if (row0 + wrow + r < B) {
      float* ls = list_s(wrow + r);
      int* li = list_i(wrow + r);
      for (int e = lane; e < k; e += 32) {
        ls[e] = -INFINITY;
        li[e] = kIdNone;
      }
    }
  }
  if (lane < 16) {
    const bool real = row0 + wrow + lane < B;  // padding rows never take
    thr_s[wrow + lane] = real ? -INFINITY : INFINITY;
    thr_i[wrow + lane] = real ? kIdNone : -1;
    cnt[wrow + lane] = 0;
  }
  __syncwarp();
  float ts0 = thr_s[lrow], ts1 = thr_s[lrow + 8];
  int ti0 = thr_i[lrow], ti1 = thr_i[lrow + 8];

  const uint32_t qbase = smem_u32(qs) + wg * kBoxBytes;
  if constexpr (!STREAM) mbar_wait(qbar, 0);

  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int c = 0; c < KC; ++c) {
      for (int p = 0; p < P; ++p) {
        mbar_wait(full0 + 8 * stage, phase);
        fence_acc(acc);
        wgmma_fence();
        const uint32_t b = smem_u32(ring + stage * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = sw128_desc(b + 32 * kk);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            if (P == 1 || i + p <= 2) {
              const uint64_t da = sw128_desc(
                  STREAM ? qbase + stage * kQStage + i * NWG * kBoxBytes +
                               32 * kk
                         : qbase + (i * KC + c) * NWG * kBoxBytes + 32 * kk);
              wgmma_m64n128k16(acc, da, db, (c | p | kk | i) != 0 ? 1 : 0);
            }
          }
        }
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
        mbar_arrive(empty0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    // selection from the accumulators. Quick pass, every tile: per row,
    // how many of this thread's 32 scores reach the row's threshold (>=,
    // so an equal score with a lower id is not missed), and the last two
    // such. A thread-row with one or two pushes them (after the exact
    // (score, id) test) with one shared atomic; three or more, a full
    // buffer, or the split's last tile (the only one that can reach past
    // n_end, and where the buffers are merged a last time) send the warp
    // through the full path below.
    const int n0 = n_begin + t * kTN;
    const int col0 = n0 + 2 * (lane & 3);  // id of column 0 of this thread
    const bool last = t == tiles - 1;
    if (t == 0 && k <= 32 && n0 + kTN <= n_end) {
      // warm-up: a lower bound of each row's k-th best score in this tile
      // (each of the row's four threads has m = ceil(k / 4) scores at or
      // above the least of their m-th best ones), so the first tile sends
      // tens of candidates per row, not all 128
      const int m = (k + 3) / 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // one row at a time: fewer registers
        float top[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) top[i] = -INFINITY;
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          if (((j >> 1) & 1) != r) continue;
          float v = acc[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float hi = fmaxf(top[i], v);
            v = fminf(top[i], v);
            top[i] = hi;
          }
        }
        float b = top[0];
#pragma unroll
        for (int i = 1; i < 8; ++i)
          if (i < m) b = top[i];
        b = fminf(b, __shfl_xor_sync(kFull, b, 1));
        b = fminf(b, __shfl_xor_sync(kFull, b, 2));
        if (r == 0 && ts0 == -INFINITY) ts0 = b;
        if (r == 1 && ts1 == -INFINITY) ts1 = b;
      }
    }
    int q[2] = {0, 0}, ja[2] = {0, 0}, jb[2] = {0, 0};
    float va[2] = {0.f, 0.f}, vb[2] = {0.f, 0.f};  // a: last, b: the one before
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int r = (j >> 1) & 1;
      if (acc[j] >= (r ? ts1 : ts0)) {
        vb[r] = va[r];
        jb[r] = ja[r];
        va[r] = acc[j];
        ja[r] = j;
        ++q[r];
      }
    }
    uint64_t done = 0;
    bool full = last || q[0] > 2 || q[1] > 2;
    if (!full) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ts = r ? ts1 : ts0;
        const int ti = r ? ti1 : ti0;
        const int ida = col0 + 8 * (ja[r] >> 2) + (ja[r] & 1);
        const int idb = col0 + 8 * (jb[r] >> 2) + (jb[r] & 1);
        const bool pa = q[r] >= 1 && better(va[r], ida, ts, ti);
        const bool pb = q[r] == 2 && better(vb[r], idb, ts, ti);
        const int n = pa + pb;
        if (n) {
          const int lr = lrow + 8 * r;
          int slot = atomicAdd(&cnt[lr], n);
          if (pa && slot < kCand) {
            cand_s[lr * kCand + slot] = va[r];
            cand_i[lr * kCand + slot] = ida;
            done |= 1ull << ja[r];
          }
          slot += pa;
          if (pb && slot < kCand) {
            cand_s[lr * kCand + slot] = vb[r];
            cand_i[lr * kCand + slot] = idb;
            done |= 1ull << jb[r];
          }
          full |= slot + pb > kCand;
        }
      }
    }
    if (!__any_sync(kFull, full)) continue;

    // full path, branch-free per element: mark the survivors (bit b of
    // m0 / m1 is column 8 (b / 2) + 2 (lane % 4) + b % 2 of the row),
    // reserve their slots with one shared atomic per row, store those that
    // fit; the rest retry after a merge
    while (true) {
      uint32_t m0 = 0, m1 = 0;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const bool second = (j >> 1) & 1;
        const int id = n0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const bool c = !((done >> j) & 1) && id < n_end &&
                       better(acc[j], id, second ? ts1 : ts0,
                              second ? ti1 : ti0);
        const int bit = 2 * (j >> 2) + (j & 1);
        if (second)
          m1 |= static_cast<uint32_t>(c) << bit;
        else
          m0 |= static_cast<uint32_t>(c) << bit;
      }
      const int c0 = __popc(m0), c1 = __popc(m1);
      const int s0 = c0 ? atomicAdd(&cnt[lrow], c0) : 0;
      const int s1 = c1 ? atomicAdd(&cnt[lrow + 8], c1) : 0;
      bool overflow = false;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const bool second = (j >> 1) & 1;
        const int bit = 2 * (j >> 2) + (j & 1);
        const uint32_t m = second ? m1 : m0;
        const int slot = (second ? s1 : s0) + __popc(m & ((1u << bit) - 1));
        const bool c = (m >> bit) & 1;
        const bool fits = c && slot < kCand;
        overflow |= c && slot >= kCand;
        if (fits) {
          const int lr = lrow + (second ? 8 : 0);
          cand_s[lr * kCand + slot] = acc[j];
          cand_i[lr * kCand + slot] =
              n0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        }
        done |= static_cast<uint64_t>(fits) << j;
      }
      __syncwarp();
      const bool ovf = __any_sync(kFull, overflow);
      if (ovf || t == tiles - 1) {
        unsigned pending = __ballot_sync(kFull, lane < 16 && cnt[wrow + lane] > 0);
        while (pending) {
          const int r = __ffs(pending) - 1;
          pending &= pending - 1;
          const int lr = wrow + r;
          merge_row(cand_s + lr * kCand, cand_i + lr * kCand,
                    min(cnt[lr], kCand), list_s(lr), list_i(lr), k,
                    thr_s + lr, thr_i + lr, lane);
          if (lane == 0) cnt[lr] = 0;
          __syncwarp();
        }
        ts0 = thr_s[lrow];
        ts1 = thr_s[lrow + 8];
        ti0 = thr_i[lrow];
        ti1 = thr_i[lrow + 8];
      }
      if (!ovf) break;
    }
  }
  if (smem_lists) {
    for (int r = 0; r < 16; ++r) {
      const int gr = row0 + wrow + r;
      if (gr < B) {
        const size_t o = ((size_t)gr * S + split) * k;
        const float* ls = list_s(wrow + r);
        const int* li = list_i(wrow + r);
        for (int e = lane; e < k; e += 32) {
          part_s[o + e] = ls[e];
          part_i[o + e] = li[e];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
               int B, int S, int k, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  extern __shared__ int heads_all[];  // [kMergeWarps][S]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= B) return;  // warp-uniform; no block-wide barrier follows
  int* heads = heads_all + warp * S;
  for (int s = lane; s < S; s += 32) heads[s] = 0;
  __syncwarp();
  const float* ps = part_s + (size_t)row * S * k;
  const int* pi = part_i + (size_t)row * S * k;
  for (int o = 0; o < k; ++o) {
    float bs = -INFINITY;
    int bi = kIdNone, bl = S;
    for (int s = lane; s < S; s += 32) {
      const int h = heads[s];
      if (h < k) {
        const float v = ps[(size_t)s * k + h];
        const int id = pi[(size_t)s * k + h];
        if (better3(v, id, s, bs, bi, bl)) {
          bs = v;
          bi = id;
          bl = s;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (better3(os, oi, ol, bs, bi, bl)) {
        bs = os;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_s[(size_t)row * k + o] = bs;
      out_i[(size_t)row * k + o] = bi == kIdNone ? -1 : bi;
    }
    if (bl < S && lane == (bl & 31)) heads[bl] += 1;
    __syncwarp();
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

// [planes, rows, dpad] bf16, boxes of box_rows x 64 columns, 128B swizzle;
// out-of-bounds rows and columns read as zero. cudaErrorNotSupported when
// cuTensorMapEncodeTiled cannot be found, cudaErrorInvalidPitchValue when
// it refuses the map.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int planes, int rows,
                     int dpad, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)dpad, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)dpad * 2,
                                 (cuuint64_t)dpad * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidPitchValue;
}

// dynamic shared memory of topk_partial; ops/topk.py mirrors it
size_t partial_smem(int nwg, int KC, int k, int smem_lists, bool stream) {
  return 1024 + (size_t)3 * (stream ? kStages : KC) * nwg * kBoxBytes +
         (size_t)kStages * kStageBytes + (2 * kStages + 2) * sizeof(uint64_t) +
         (size_t)nwg * 64 * (kCand * 8 + 12) +
         (smem_lists ? (size_t)nwg * 64 * k * 8 : 0);
}

template <int NWG, int P, bool STREAM = false>
cudaError_t launch_partial(const CUtensorMap& qmap, const CUtensorMap& dmap,
                           int B, int N, int KC, int k, int S, int slice,
                           int smem_lists, float* part_s, int* part_i,
                           cudaStream_t stream) {
  const size_t smem = partial_smem(NWG, KC, k, smem_lists, STREAM);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial<NWG, P, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (B + NWG * 64 - 1) / (NWG * 64);
  const dim3 grid = STREAM ? dim3(S, q_tiles) : dim3(q_tiles, S);
  topk_partial<NWG, P, STREAM><<<grid, NWG * 128 + 32, smem, stream>>>(
      qmap, dmap, B, N, KC, k, S, slice, smem_lists, part_s, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_planes: bf16 [3, B, dpad]; d_planes: bf16 [P, N, dpad] (P = 1 for a
// bf16 corpus, 3 for the planes of an f32 one); dpad a multiple of 16,
// <= 2048 (above 256 the query planes stream: nwg 1, B < 64 * 65536);
// both 16-byte aligned. nwg: consumer warpgroups per block (64
// query rows each; 2 only for dpad <= 128); smem_lists: keep the running
// lists in shared memory (it must fit). The corpus is cut into S splits of
// `slice` rows (a multiple of 128, none empty). Scratch part_s / part_i
// hold [B, S, k]; outputs are [B, k]. Returns a cudaError_t (0 = both
// launches accepted; cudaErrorInvalidValue for arguments out of range;
// see make_map for the tensor maps). Launches on `stream`, does not
// synchronise, allocates nothing.
int dense_topk_launch(const void* q_planes, const void* d_planes, int P,
                      int B, int N, int dpad, int k, int nwg, int smem_lists,
                      int S, int slice, void* part_s, void* part_i,
                      void* out_s, void* out_i, void* stream) {
  const int KC = (dpad + 63) / 64;
  const bool stream_q = dpad > kMaxD;
  if (B < 1 || N < 1 || dpad < 16 || dpad % 16 != 0 || dpad > kMaxDStream ||
      (stream_q && (nwg != 1 || (B + 63) / 64 > 65535)) ||
      k < 1 || k > kMaxK || k > N || S < 1 || S > kMaxSplits ||
      slice < kTN || slice % kTN != 0 || (long long)slice * (S - 1) >= N ||
      (P != 1 && P != 3) || (nwg != 1 && nwg != 2) || (nwg == 2 && KC > 2) ||
      reinterpret_cast<uintptr_t>(q_planes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_planes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, dmap;
  cudaError_t err = make_map(&qmap, q_planes, 3, B, dpad, 64);
  if (err == cudaSuccess) err = make_map(&dmap, d_planes, P, N, dpad, kTN);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  const int sl = smem_lists ? 1 : 0;
  if (stream_q)
    err = P == 1 ? launch_partial<1, 1, true>(qmap, dmap, B, N, KC, k, S,
                                              slice, sl, ps, pi, st)
                 : launch_partial<1, 3, true>(qmap, dmap, B, N, KC, k, S,
                                              slice, sl, ps, pi, st);
  else if (nwg == 2)
    err = P == 1 ? launch_partial<2, 1>(qmap, dmap, B, N, KC, k, S, slice, sl,
                                        ps, pi, st)
                 : launch_partial<2, 3>(qmap, dmap, B, N, KC, k, S, slice, sl,
                                        ps, pi, st);
  else
    err = P == 1 ? launch_partial<1, 1>(qmap, dmap, B, N, KC, k, S, slice, sl,
                                        ps, pi, st)
                 : launch_partial<1, 3>(qmap, dmap, B, N, KC, k, S, slice, sl,
                                        ps, pi, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = sizeof(int) * kMergeWarps * (size_t)S;
  topk_merge<<<(B + kMergeWarps - 1) / kMergeWarps, kMergeThreads, smem2,
               st>>>(ps, pi, B, S, k, static_cast<float*>(out_s),
                     static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* dense_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
