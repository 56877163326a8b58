// Hash embedding of packed text bytes on the card: tokenize, crc32, signed
// buckets and unit rows, one warp per text.
//
// Replaces no TPU kernel. The JAX package hashes its queries on the host
// (a_modular_rag_framework_tpu/models/hash_embed.py: a Python or native C++
// featurizer, then a one-hot einsum on the device), and the port did the
// same in one host thread (csrc/text_native.cpp::hash_embed_batch). This
// kernel computes that function, bit for bit, from the bytes the host packs
// (models/hash_embed.py::pack_texts):
//
//   - a row is the bytes [offsets[r], offsets[r + 1]), cut at its first NUL
//     (the C path reads a NUL-terminated string; the packing puts a NUL
//     between rows);
//   - tokens are the runs of [a-zA-Z0-9], lowered in ASCII only;
//   - features are the unigrams, then the '_'-joined bigrams, cut at
//     max_features in that order;
//   - h = crc32(feature) (zlib's: reflected polynomial 0xEDB88320, register
//     preset to ~0, final complement), bucket h % dim, sign +1 where bit 16
//     of h is set, else -1;
//   - row = acc / max((float)sqrt(double sum acc^2), 1e-9f).
//
// The sums are small integers, so the order of the shared-memory atomics
// cannot change a bit; the square sum is exact in double, and the square
// root and the division are IEEE-rounded (__dsqrt_rn, __fdiv_rn), as on
// the host.
//
// A bigram's crc is chained, never built as a string: the register after
// token a (before the final complement) is fed '_' and then b's bytes, which
// equals crc32(a + "_" + b).
//
// What bounds it on an H100: bytes, and they are few. At the dense path's
// shape (4,096 questions of 14-22 words, ~116 bytes each) it reads ~0.48 MB
// of text and 16 KB of offsets and writes 1 MB of rows: ~0.45 us at
// 3.35 TB/s. The work is ~3 table lookups a byte. A warp walks its row in
// 32-byte steps (one byte a lane; token starts and ends found by ballot),
// then each lane hashes whole tokens: a row's tokens are hashed in
// parallel, a token's bytes in series. Every row of a 4,096 batch is
// resident at once (8 warps a block at d 64), so the kernel is bound by the
// latency of its few dependent loads, not by bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPoly = 0xEDB88320u;

__device__ __forceinline__ bool is_alnum(unsigned c) {
  return (c - 'a' < 26u) || (c - 'A' < 26u) || (c - '0' < 10u);
}

__device__ __forceinline__ unsigned lower(unsigned c) {
  return (c - 'A' < 26u) ? c + ('a' - 'A') : c;
}

__device__ __forceinline__ uint32_t crc_step(const uint32_t* table,
                                             uint32_t s, unsigned c) {
  return table[(s ^ c) & 0xffu] ^ (s >> 8);
}

__device__ __forceinline__ void add_feature(int* acc, uint32_t h, int dim) {
  atomicAdd(acc + h % static_cast<uint32_t>(dim),
            ((h >> 16) & 1u) ? 1 : -1);
}

// Shared memory: the crc table (256 words), then per warp its bucket sums
// (dim ints) and, for its first max_features tokens, their starts, ends
// and crc registers (3 x max_features words).
__global__ void hash_embed_kernel(const uint8_t* __restrict__ data,
                                  int nbytes,
                                  const int* __restrict__ offsets, int B,
                                  int dim, int max_features,
                                  float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* table = smem;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? kPoly ^ (c >> 1) : c >> 1;
    table[i] = c;
  }
  __syncthreads();  // the only block barrier: warps are independent below

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;
  int* acc = reinterpret_cast<int*>(smem + 256) +
             static_cast<size_t>(warp) * (dim + 3 * max_features);
  int* tstart = acc + dim;
  int* tend = tstart + max_features;
  uint32_t* treg = reinterpret_cast<uint32_t*>(tend + max_features);
  for (int d = lane; d < dim; d += 32) acc[d] = 0;

  // Rows are clamped to the buffer: bad offsets read nothing outside it.
  const int begin = min(max(offsets[row], 0), nbytes);
  int end = min(max(offsets[row + 1], begin), nbytes);
  const unsigned below = (1u << lane) - 1u;

  // 1. Token spans, in order, until max_features tokens have ended or the
  //    row has: the features never reach past the first max_features
  //    tokens.
  int nstart = 0, nend = 0;
  unsigned carry = 0;  // 1 when the byte before this step is alphanumeric
  for (int base = begin; base < end && nend < max_features; base += 32) {
    const int p = base + lane;
    const unsigned c = p < end ? data[p] : 1u;
    const unsigned nul = __ballot_sync(kFull, c == 0u);
    if (nul) end = min(end, base + __ffs(nul) - 1);
    const bool inside = p < end;
    const unsigned alnum = __ballot_sync(kFull, inside && is_alnum(c));
    const unsigned valid = __ballot_sync(kFull, inside);
    const unsigned prev = (alnum << 1) | carry;
    const unsigned starts = alnum & ~prev;
    const unsigned ends = ~alnum & prev & valid;
    if ((starts >> lane) & 1u) {
      const int j = nstart + __popc(starts & below);
      if (j < max_features) tstart[j] = p;
    }
    if ((ends >> lane) & 1u) {
      const int j = nend + __popc(ends & below);
      if (j < max_features) tend[j] = p;
    }
    nstart += __popc(starts);
    nend += __popc(ends);
    carry = alnum >> 31;
  }
  if (nend < max_features && nstart > nend) {
    if (lane == 0) tend[nend] = end;  // a token open at the row's end
    ++nend;
  }
  const int ntok = min(nend, max_features);
  __syncwarp();

  // 2. Unigrams: one lane a token; its crc register is kept for bigrams.
  for (int j = lane; j < ntok; j += 32) {
    uint32_t s = ~0u;
    for (int p = tstart[j], e = tend[j]; p < e; ++p)
      s = crc_step(table, s, lower(data[p]));
    treg[j] = s;
    add_feature(acc, ~s, dim);
  }
  __syncwarp();

  // 3. Bigrams while the budget lasts: token j's register, '_', token j+1.
  const int nbig = min(ntok - 1, max_features - ntok);
  for (int j = lane; j < nbig; j += 32) {
    uint32_t s = crc_step(table, treg[j], '_');
    for (int p = tstart[j + 1], e = tend[j + 1]; p < e; ++p)
      s = crc_step(table, s, lower(data[p]));
    add_feature(acc, ~s, dim);
  }
  __syncwarp();

  // 4. Unit row: the square sum in double (exact: the sums are integers).
  double sq = 0.0;
  for (int d = lane; d < dim; d += 32) {
    const double a = acc[d];
    sq += a * a;
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
  float norm = __double2float_rn(__dsqrt_rn(sq));
  if (norm < 1e-9f) norm = 1e-9f;
  float* orow = out + static_cast<size_t>(row) * dim;
  for (int d = lane; d < dim; d += 32)
    orow[d] = __fdiv_rn(static_cast<float>(acc[d]), norm);
}

// Shared memory a block of `warps` rows asks for (the layout above).
long long smem_bytes(int warps, int dim, int max_features) {
  return 4LL * (256 + (long long)warps * (dim + 3LL * max_features));
}

// Rows a block: up to 8, as many as fit the 48 KB of shared memory a block
// gets without opting in; 0 where not even one row's fits.
int launch_warps(int dim, int max_features) {
  int warps = 8;
  while (warps > 0 && smem_bytes(warps, dim, max_features) > 48 * 1024)
    --warps;
  return warps;
}

}  // namespace

extern "C" {

// data: uint8 [nbytes] (may be null when nbytes is 0); offsets: int32
// [B + 1]; out: f32 [B, dim]. Returns a cudaError_t (0 = the launch was
// accepted; cudaErrorInvalidValue for arguments out of range, or where one
// row's shared memory exceeds 48 KB). Launches on `stream`, does not
// synchronise, allocates nothing.
int hash_embed_launch(const void* data, int nbytes, const void* offsets,
                      int B, int dim, int max_features, void* out,
                      void* stream) {
  if (B < 1 || nbytes < 0 || nbytes > 0x7fffffff - 32 || dim < 1 ||
      max_features < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = launch_warps(dim, max_features);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + warps - 1) / warps;
  hash_embed_kernel<<<blocks, 32 * warps,
                      (size_t)smem_bytes(warps, dim, max_features),
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes,
      static_cast<const int*>(offsets), B, dim, max_features,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hash_embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
