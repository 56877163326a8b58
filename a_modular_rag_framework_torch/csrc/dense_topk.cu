// Fused dense similarity + exact top-k for Hopper (sm_90a).
//
// Replaces a_modular_rag_framework_tpu/ops/topk.py::dense_topk_pallas (its
// body is _topk_kernel): for each query row, top_k(q . D^T) over the whole
// corpus, without ever writing the [B, N] score matrix to device memory.
// Order is (score descending, id ascending) -- lax.top_k's tie order -- and
// corpus rows >= N are never read, so padding can never win, even against
// all-negative scores.
//
// What bounds it on an H100: at the engine's width (d = 64, bf16 corpus)
// each corpus row is 128 bytes and meets every query of a tile, so the work
// is B*N*d FMAs over N*d*2 bytes streamed once per query tile: FMA- and
// shared-memory-bound, not tensor-core-bound (d = 64 is too shallow for
// wgmma to pay off before the selection does). The design:
//
//   pass 1, grid = (ceil(B/64) query tiles) x (S corpus splits): a block
//     stages 64 query rows (f32) and walks its split of D in 64-row tiles
//     (bf16 or f32 read, f32 FMA accumulate, a 4x4 register tile per
//     thread, features in chunks of 64 so any d works). Each query row
//     keeps a sorted top-k in shared memory; a warp owns a row and inserts
//     only candidates that beat the row's current k-th entry (one ballot
//     per 32 candidates), so after warm-up most tiles cost one compare.
//     Writes partial lists [B, S, k].
//   pass 2, one warp per row: a k-round merge of the S sorted lists (each
//     round a warp arg-best over the list heads).
//
// The TPU kernel ran its corpus tiles in order on one core and carried the
// running top-k from step to step; here blocks run in parallel and in no
// order, hence the split + merge. No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;       // query rows per block
constexpr int kTN = 64;       // corpus rows per tile
constexpr int kDC = 64;       // feature columns per staged chunk
constexpr int kLd = kDC + 1;  // padded shared-memory row stride
constexpr int kMaxK = 256;
constexpr int kMaxSplits = 1024;
constexpr int kIdNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// (score desc, id asc)
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// ... and the list index last, so the merge's order is total
__device__ __forceinline__ bool better3(float s, int i, int l, float t, int j,
                                        int m) {
  return s > t || (s == t && (i < j || (i == j && l < m)));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Warp-cooperative insertion of (cs, cid) into the sorted list (ls, li) of
// length k. The caller guarantees the candidate beats ls[k-1].
__device__ __forceinline__ void warp_insert(float* ls, int* li, int k,
                                            float cs, int cid, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int e = base + lane;
    const bool b = e < k && better(ls[e], li[e], cs, cid);
    pos += __popc(__ballot_sync(kFull, b));
  }
  float vs[kMaxK / 32];
  int vi[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    if (e >= pos && e < k - 1) {
      vs[j] = ls[e];
      vi[j] = li[e];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    if (e >= pos && e < k - 1) {
      ls[e + 1] = vs[j];
      li[e + 1] = vi[j];
    }
  }
  if (lane == 0) {
    ls[pos] = cs;
    li[pos] = cid;
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_partial(const float* __restrict__ q, const T* __restrict__ D, int B,
                 int N, int d, int k, int S, long long slice,
                 float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [kQB][kLd]
  float* ds = qs + kQB * kLd;                      // [kTN][kLd]
  float* sc = ds + kTN * kLd;                      // [kQB][kTN]
  float* ts = sc + kQB * kTN;                      // [kQB][k]
  int* ti = reinterpret_cast<int*>(ts + kQB * k);  // [kQB][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // corpus rows tx + 16*j, j < 4
  const int row0 = blockIdx.x * kQB;
  const int split = blockIdx.y;
  const long long n_begin = (long long)split * slice;
  const long long n_end = min((long long)N, n_begin + slice);
  const int nchunks = (d + kDC - 1) / kDC;

  for (int e = tid; e < kQB * k; e += kThreads) {
    ts[e] = -INFINITY;
    ti[e] = kIdNone;
  }

  for (long long n0 = n_begin; n0 < n_end; n0 += kTN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = ch * kDC;
      __syncthreads();  // the previous tile's readers of qs / ds / sc are done
      if (nchunks > 1 || n0 == n_begin) {
        for (int e = tid; e < kQB * kDC; e += kThreads) {
          const int r = e / kDC, c = e % kDC;
          const int gr = row0 + r, gc = c0 + c;
          qs[r * kLd + c] =
              (gr < B && gc < d) ? q[(size_t)gr * d + gc] : 0.f;
        }
      }
      for (int e = tid; e < kTN * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        const long long gr = n0 + r;
        const int gc = c0 + c;
        ds[r * kLd + c] =
            (gr < n_end && gc < d) ? to_f32(D[(size_t)gr * d + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDC; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * kLd + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ds[(tx + 16 * j) * kLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[(ty * 4 + i) * kTN + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // selection: warp w owns rows w, w + 8, ...
    for (int r = warp; r < kQB; r += kWarps) {
      if (row0 + r >= B) break;  // warp-uniform
      float* ls = ts + r * k;
      int* li = ti + r * k;
#pragma unroll
      for (int j = 0; j < kTN / 32; ++j) {
        const int col = lane + 32 * j;
        const long long g = n0 + col;
        const int gid = (int)g;
        const float s = sc[r * kTN + col];
        const bool cand = g < n_end && better(s, gid, ls[k - 1], li[k - 1]);
        unsigned m = __ballot_sync(kFull, cand);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cs = __shfl_sync(kFull, s, src);
          const int cid = __shfl_sync(kFull, gid, src);
          if (better(cs, cid, ls[k - 1], li[k - 1]))
            warp_insert(ls, li, k, cs, cid, lane);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kQB * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const int gr = row0 + r;
    if (gr < B) {
      const size_t o = ((size_t)gr * S + split) * k + j;
      part_s[o] = ts[e];
      part_i[o] = ti[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
               int B, int S, int k, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  extern __shared__ int heads_all[];  // [kWarps][S]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
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

template <typename T>
cudaError_t launch_partial(const float* q, const T* D, int B, int N, int d,
                           int k, int S, long long slice, float* part_s,
                           int* part_i, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kQB * kLd + kTN * kLd + kQB * kTN) +
      (sizeof(float) + sizeof(int)) * (size_t)kQB * k;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kQB - 1) / kQB, S);
  topk_partial<T><<<grid, kThreads, smem, stream>>>(q, D, B, N, d, k, S,
                                                    slice, part_s, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch part_s / part_i hold [B, S, k]; outputs are [B, k]. Returns a
// cudaError_t (0 = both launches accepted). Launches on `stream`, does not
// synchronise, allocates nothing.
int dense_topk_launch(const void* q, const void* D, int d_is_bf16, int B,
                      int N, int d, int k, int S, void* part_s, void* part_i,
                      void* out_s, void* out_i, void* stream) {
  if (B < 1 || N < 1 || d < 1 || k < 1 || k > kMaxK || k > N || S < 1 ||
      S > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = ((long long)N + S - 1) / S;
  const long long slice = (rows + kTN - 1) / kTN * kTN;
  cudaError_t err =
      d_is_bf16
          ? launch_partial(static_cast<const float*>(q),
                           static_cast<const __nv_bfloat16*>(D), B, N, d, k,
                           S, slice, static_cast<float*>(part_s),
                           static_cast<int*>(part_i), st)
          : launch_partial(static_cast<const float*>(q),
                           static_cast<const float*>(D), B, N, d, k, S, slice,
                           static_cast<float*>(part_s),
                           static_cast<int*>(part_i), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = sizeof(int) * kWarps * (size_t)S;
  topk_merge<<<(B + kWarps - 1) / kWarps, kThreads, smem2, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i), B,
      S, k, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* dense_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
