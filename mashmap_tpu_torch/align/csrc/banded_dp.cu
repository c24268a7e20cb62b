// Banded unit-cost edit-distance DP rows for a batch of alignment pieces.
//
// Replaces mashmap_tpu/align/kernel.py::banded_dp_rows (:48), a jitted
// lax.scan over P dependent rows (not Pallas). For piece b and row i,
// band column c holds D[i][j = i + lo[b] + c]:
//
//   M[c]  = min(prev[c] + (q[i-1] != r[clip(j-1, 0, R-1)]),   // diag
//               prev[c+1] + 1)                                 // up
//           (up alone where j == 0; INF where j is not in [1, m])
//   row[c] = min(min_{c' <= c} (M[c'] - c') + c, INF)          // left moves
//           (INF where j is not in [0, m])
//
// and every row is written saturated at CAP as uint16, row 0 included:
// out is (B, P+1, W). All P rows are computed, also those past n[b], as
// the JAX function does.
//
// Design (a first, simple kernel): one thread block per piece and one
// thread per band column (W = 64, 128, 256 or 1024, the aligner's
// buckets). The previous row sits in shared memory, double-buffered, with
// prev[W] = INF for the up move past the band. The in-row min-scan is an
// inclusive warp scan by __shfl_up_sync, then one value per warp through
// shared memory. The arithmetic is the JAX function's, in int32, so the
// rows are bit-identical to it and to the plain PyTorch version.
//
// What bounds it on this card: the least time is the larger of the rows
// written, B*(P+1)*W*2 bytes (4.3 GB for the (4096, 1024) bucket at
// B = 512) over 3.35 TB/s, and the 7 int32 operations a cell that the
// recurrence needs done one cell after another (the substitution compare,
// the diag and up adds, their min, the left add, its min, the saturation)
// over the int32 rate; at every bucket the bytes are the larger. The
// kernel spends more: each row costs two block barriers and a five-step
// shuffle scan (five shuffles and mins a cell, where the recurrence needs
// one), and at W = 64 (two warps a block) the barrier latency is
// the likely limit; the blocks in flight (up to 32 per SM at W = 64)
// hide part of it.
//
// C ABI (ctypes): banded_dp_launch(...) returns the cudaError_t of the
// launch (0 on success); it does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kCap = 65535;

template <int W>
__global__ void __launch_bounds__(W) banded_dp_kernel(
    const uint8_t* __restrict__ q,           // (B, P)
    const uint8_t* __restrict__ r,           // (B, R)
    const int32_t* __restrict__ m,           // (B,)
    const int32_t* __restrict__ lo,          // (B,)
    const uint8_t* __restrict__ free_start,  // (B,) bool
    uint16_t* __restrict__ out,              // (B, P + 1, W)
    int P, int R) {
  constexpr int kWarps = W / 32;
  __shared__ int prev[2][W + 1];
  __shared__ int warp_min[kWarps];

  const int b = blockIdx.x;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const uint8_t* qb = q + static_cast<size_t>(b) * P;
  const uint8_t* rb = r + static_cast<size_t>(b) * R;
  const int mb = m[b];
  const int lob = lo[b];
  uint16_t* ob = out + static_cast<size_t>(b) * (P + 1) * W;

  // row 0: j = lo + c
  int j = lob + c;
  int v = (j >= 0 && j <= mb) ? (free_start[b] ? 0 : j) : kInf;
  prev[0][c] = v;
  if (c == 0) {
    prev[0][W] = kInf;
    prev[1][W] = kInf;
  }
  ob[c] = static_cast<uint16_t>(min(v, kCap));
  __syncthreads();

  int cur = 0;
  for (int i = 1; i <= P; ++i) {
    j = i + lob + c;
    int jr = j - 1;
    jr = jr < 0 ? 0 : (jr > R - 1 ? R - 1 : jr);
    const int sub = (qb[i - 1] != rb[jr]) ? 1 : 0;
    const int up = prev[cur][c + 1] + 1;
    int M = min(prev[cur][c] + sub, up);
    const bool at_j0 = (j == 0);
    if (at_j0) M = up;
    if (!((j >= 1 && j <= mb) || at_j0)) M = kInf;

    // inclusive min-scan of M - c over the block
    int x = M - c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x = min(x, y);
    }
    if (lane == 31) warp_min[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) x = min(x, warp_min[w]);
    int row = min(x + c, kInf);
    if (!(j >= 0 && j <= mb)) row = kInf;
    prev[cur ^ 1][c] = row;
    ob[static_cast<size_t>(i) * W + c] = static_cast<uint16_t>(min(row, kCap));
    // the next row reads prev[cur ^ 1]; warp_min is rewritten only after
    // every warp has passed this barrier
    __syncthreads();
    cur ^= 1;
  }
}

template <int W>
cudaError_t launch(const uint8_t* q, const uint8_t* r, const int32_t* m,
                   const int32_t* lo, const uint8_t* fs, uint16_t* out, int B,
                   int P, int R, cudaStream_t stream) {
  banded_dp_kernel<W><<<B, W, 0, stream>>>(q, r, m, lo, fs, out, P, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" int banded_dp_launch(const void* q, const void* r, const void* m,
                                const void* lo, const void* free_start,
                                void* out, int B, int P, int R, int W,
                                void* stream) {
  const auto* q8 = static_cast<const uint8_t*>(q);
  const auto* r8 = static_cast<const uint8_t*>(r);
  const auto* m32 = static_cast<const int32_t*>(m);
  const auto* lo32 = static_cast<const int32_t*>(lo);
  const auto* fs8 = static_cast<const uint8_t*>(free_start);
  auto* o16 = static_cast<uint16_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: return launch<64>(q8, r8, m32, lo32, fs8, o16, B, P, R, s);
    case 128: return launch<128>(q8, r8, m32, lo32, fs8, o16, B, P, R, s);
    case 256: return launch<256>(q8, r8, m32, lo32, fs8, o16, B, P, R, s);
    case 1024: return launch<1024>(q8, r8, m32, lo32, fs8, o16, B, P, R, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
