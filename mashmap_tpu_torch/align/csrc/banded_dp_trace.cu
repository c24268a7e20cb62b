// Banded unit-cost edit distance, end state and traceback for a batch of
// alignment pieces, in one kernel: only each piece's result and edit path
// leave the card.
//
// Replaces mashmap_tpu/align/kernel.py::banded_dp_rows (:48), a jitted
// lax.scan over the DP rows (not Pallas), together with what the JAX
// package's host does with those rows: the end state and escalation test
// (mashmap_tpu/align/driver.py:277-293) and traceback_batch
// (mashmap_tpu/align/kernel.py:171). For piece b and row i, band column c
// holds D[i][j = i + lo[b] + c]:
//
//   D(c)   = prev[c] + (q[i-1] != r[clip(j-1, 0, R-1)])  if 1 <= j <= m
//   U(c)   = prev[c+1] + 1   (prev[W] = INF)             if 0 <= j <= m
//   M[c]   = min(D(c), U(c))         (a masked term is INF)
//   row[c] = min(min_{c' <= c} (M[c'] - c') + c, INF)
//            (INF unless 0 <= j <= m)
//
// the JAX function's arithmetic in int32, for rows 1..n[b] only (no later
// row is read). Each cell also stores, in 2 bits, the predecessor that
// traceback_batch takes there, tested on the values saturated at CAP as the
// host read them: diag if j >= 1 and prev[c] + sub == row[c]; else up if
// c + 1 < W and prev[c+1] + 1 == row[c]; else left if c >= 1, j >= 1 and
// row[c-1] + 1 == row[c]; else none. Row n gives the end state (the first
// argmin for a free-end piece, the cell at j = m otherwise; e, the band's
// slack, ok), and one thread walks the codes from (n, end_j) to row 0,
// writing the op codes in reverse order. Each piece's record is six int32
// (ok, e, end_j, start_j, dead end, path length) and then its ops, padded
// with 255 to the record's end.
//
// Design. Warp per piece for W = 64 and 128 (several pieces a block, no
// block barrier): a lane holds W/32 consecutive columns in registers; the
// in-row min-scan is a serial scan over the lane's columns, a five-step
// __shfl_up_sync scan of the lanes' totals, and the lane's carry-in; the up
// move reads the next lane's first column by __shfl_down_sync. The codes
// (P*W/4 bytes a piece) stay in shared memory with q and r, so nothing of
// the band reaches device memory. Block per piece for W = 256 (4 warps of 2
// columns a lane) and 1024 (8 warps of 4): one barrier a row. Before it,
// each warp scans its columns with its last column's up move left out,
// since that move reads the next warp's first column of row i-1; after it,
// lanes l < w add that move to warp l's total (the first columns of row
// i-1 sit in `edge`), and one __reduce_min_sync gives warp w's carry.
// `edge` and the warp totals are double-buffered by row parity, which is
// what makes one barrier a row enough. Their codes go to a device-memory
// scratch (65,536 and 1,048,576 B a piece at P = 1024 and 4096).
//
// What bounds it on this card: the int32 operations the recurrence needs,
// one cell after another (7 a cell of rows 1..n: the substitution compare,
// the diag and up adds, their min, the left add, its min, the saturation),
// over the int32 rate; the bytes (inputs, and the records written) are far
// fewer. A row is a chain of dependent steps (the shuffle scan, and in
// block mode the barrier), so a piece's time is its rows times that
// chain's latency, hidden only by the other pieces resident on the SM; the
// walk is one dependent load a step (shared memory at W <= 128, device
// memory above), at most P + W steps.
//
// C ABI (ctypes): banded_dp_trace_launch(...) returns the cudaError_t of
// the launch (0 on success) and does not synchronise;
// banded_dp_trace_scratch(B, P, W) is the device scratch (bytes) that a
// launch of B pieces needs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kCap = 65535;
constexpr int kBig = 0x3fffffff;   // identity of the min-scans
constexpr unsigned kFull = 0xffffffffu;
constexpr int kResBytes = 24;      // six int32 before a piece's ops
constexpr int kKeyShift = 11;      // argmin key: value << 11 | column
constexpr int kKeyMask = (1 << kKeyShift) - 1;

enum : int { kOk = 0, kE, kEndJ, kStartJ, kDead, kLen };
enum : unsigned { kNone = 0, kDiag = 1, kUp = 2, kLeft = 3 };
// align/kernel.py OP_MATCH, OP_INS, OP_DEL, OP_SUB; 255 pads
constexpr uint8_t kOpMatch = 0, kOpIns = 1, kOpDel = 2, kOpSub = 3;
constexpr uint8_t kOpPad = 255;

template <int W, int NT, int PPB>
struct Cfg {
  static constexpr int kCpt = W / NT;      // band columns a thread holds
  static constexpr int kWarps = NT / 32;   // warps a piece
  static constexpr int kPairs = W / 32;    // uint2 code words a DP row
  static constexpr bool kBlock = kWarps > 1;
  static_assert(W % NT == 0 && NT % 32 == 0, "geometry");
  static_assert(!kBlock || PPB == 1, "a piece of several warps fills a block");
  static_assert(W < (1 << kKeyShift), "argmin key");

  // shared memory: [codes, warp mode][edge/warp-total header, block
  // mode][q (P) and r (R) of each piece]
  __host__ __device__ static size_t codes_bytes(int P) {
    return kBlock ? 0 : size_t(PPB) * P * kPairs * sizeof(uint2);
  }
  __host__ __device__ static size_t header_bytes() {
    return kBlock ? ((5 * kWarps + 2) * sizeof(int) + 7) / 8 * 8 : 0;
  }
  __host__ __device__ static size_t smem_bytes(int P, int R) {
    return codes_bytes(P) + header_bytes() + size_t(PPB) * (P + R);
  }
};

__device__ __forceinline__ int sat(int x) { return min(x, kCap); }

template <int W, int NT, int PPB>
__global__ void __launch_bounds__(NT * PPB) banded_dp_trace_kernel(
    const uint8_t* __restrict__ q,           // (B, P)
    const uint8_t* __restrict__ r,           // (B, R)
    const int32_t* __restrict__ n,           // (B,)
    const int32_t* __restrict__ m,           // (B,)
    const int32_t* __restrict__ lo,          // (B,)
    const uint8_t* __restrict__ free_start,  // (B,) bool
    const uint8_t* __restrict__ free_end,    // (B,) bool
    uint2* __restrict__ codes_g,             // (B, P, W/32), block mode
    uint8_t* __restrict__ out,               // (B, rec)
    int B, int P, int R, int L, int rec) {
  using G = Cfg<W, NT, PPB>;
  constexpr int kCpt = G::kCpt, kWarps = G::kWarps, kPairs = G::kPairs;
  extern __shared__ __align__(16) unsigned char smem[];

  const int slot = threadIdx.x / NT;
  const int t = threadIdx.x % NT;
  const int lane = t & 31;
  const int w = t >> 5;
  const int b = blockIdx.x * PPB + slot;
  // warp mode: a whole warp leaves (there is no block barrier); block
  // mode launches exactly B blocks
  if (b >= B) return;

  const size_t cb = G::codes_bytes(P);
  uint2* codes = G::kBlock
      ? codes_g + size_t(b) * P * kPairs
      : reinterpret_cast<uint2*>(smem) + size_t(slot) * P * kPairs;
  int* wmin = reinterpret_cast<int*>(smem + cb);   // [2][kWarps]
  int* edge = wmin + 2 * kWarps;                   // [2][kWarps + 1]
  int* red = edge + 2 * (kWarps + 1);              // [kWarps]
  uint8_t* sq = smem + cb + G::header_bytes() + size_t(slot) * (P + R);
  uint8_t* sr = sq + P;

  const uint8_t* qb = q + size_t(b) * P;
  const uint8_t* rb = r + size_t(b) * R;
  for (int x = t; x < P; x += NT) sq[x] = qb[x];
  for (int x = t; x < R; x += NT) sr[x] = rb[x];

  const int nb = min(max(n[b], 0), P);
  const int mb = m[b];
  const int lob = lo[b];
  const bool fs = free_start[b] != 0;
  const bool fe = free_end[b] != 0;
  const int c0 = t * kCpt;   // this thread's first band column

  // row 0: j = lo + c
  int prev[kCpt];
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    const int j = lob + c0 + k;
    prev[k] = (j >= 0 && j <= mb) ? (fs ? 0 : j) : kInf;
  }
  if constexpr (G::kBlock) {
    if (lane == 0) edge[w] = prev[0];
    if (t == 0) {
      edge[kWarps] = kInf;
      edge[2 * kWarps + 1] = kInf;
    }
    __syncthreads();
  } else {
    __syncwarp();
  }

  for (int i = 1; i <= nb; ++i) {
    const int buf = i & 1;
    // row i-1 at each warp's first column
    const int* eprev = edge + (buf ^ 1) * (kWarps + 1);
    const int qi = sq[i - 1];
    const int jb = i + lob + c0;   // j of this thread's first column
    int sub[kCpt], M[kCpt], s[kCpt];
    // prev[c + 1] of this thread's last column: the next lane's first;
    // lane 31 has none in warp mode, and in block mode takes the next
    // warp's after the barrier
    int up_last = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 31) up_last = kInf;
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      const int j = jb + k;
      const int jr = min(max(j - 1, 0), R - 1);
      sub[k] = qi != sr[jr] ? 1 : 0;
      const int up = (k + 1 < kCpt ? prev[k + 1] : up_last) + 1;
      const int d = (j >= 1 && j <= mb) ? prev[k] + sub[k] : kInf;
      const int u = (j >= 0 && j <= mb) ? up : kInf;
      M[k] = min(d, u);
      s[k] = min(k ? s[k - 1] : kBig, M[k] - (c0 + k));
    }
    // inclusive min-scan of the lanes' totals, then each lane's carry-in
    int x = s[kCpt - 1];
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int y = __shfl_up_sync(kFull, x, dd);
      if (lane >= dd) x = min(x, y);
    }
    int carry = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) carry = kBig;
    if constexpr (G::kBlock) {
      int* wm = wmin + buf * kWarps;
      if (lane == 31) wm[w] = x;
      __syncthreads();
      // lane l < w: warp l's total with its last column's up move
      int tl = kBig;
      if (lane < w) {
        const int cl = (lane + 1) * 32 * kCpt - 1;
        const int jl = i + lob + cl;
        const int ul = (jl >= 0 && jl <= mb) ? eprev[lane + 1] + 1 : kInf;
        tl = min(wm[lane], ul - cl);
      }
      carry = min(carry, __reduce_min_sync(kFull, tl));
      if (lane == 31) {
        up_last = eprev[w + 1];   // kInf past the last warp
        constexpr int k = kCpt - 1;
        const int j = jb + k;
        if (j >= 0 && j <= mb) {
          M[k] = min(M[k], up_last + 1);
          s[k] = min(s[k], M[k] - (c0 + k));
        }
      }
    }
    int row[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      const int j = jb + k;
      const int v = min(min(carry, s[k]) + c0 + k, kInf);
      row[k] = (j >= 0 && j <= mb) ? v : kInf;
    }
    // row[c0 - 1]: everything before this thread's first column
    const int left0 = (jb - 1 >= 0 && jb - 1 <= mb)
                          ? min(carry + c0 - 1, kInf) : kInf;

    uint2* crow = codes + size_t(i - 1) * kPairs + w * kCpt;
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      const int c = c0 + k;
      const int j = jb + k;
      const int v = sat(row[k]);
      const int uv = sat(k + 1 < kCpt ? prev[k + 1] : up_last);
      const int lv = sat(k ? row[k - 1] : left0);
      unsigned code = kNone;
      if (j >= 1 && sat(prev[k]) + sub[k] == v) {
        code = kDiag;
      } else if (c + 1 < W && uv + 1 == v) {
        code = kUp;
      } else if (c >= 1 && j >= 1 && lv + 1 == v) {
        code = kLeft;
      }
      const unsigned b0 = __ballot_sync(kFull, code & 1u);
      const unsigned b1 = __ballot_sync(kFull, code >> 1);
      if (lane == k) crow[k] = make_uint2(b0, b1);
    }
    if constexpr (G::kBlock) {
      if (lane == 0) edge[buf * (kWarps + 1) + w] = row[0];
    }
#pragma unroll
    for (int k = 0; k < kCpt; ++k) prev[k] = row[k];
  }

  // end state from row n: the first argmin (free end) or the cell at
  // j = m, as a key value << 11 | column
  const int cend_fixed = mb - nb - lob;
  int key = kBig;
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    const int c = c0 + k;
    const int j = nb + lob + c;
    const int v = (j >= 0 && j <= mb) ? sat(prev[k]) : kCap;
    if (fe || c == cend_fixed) key = min(key, (v << kKeyShift) | c);
  }
  key = __reduce_min_sync(kFull, key);
  if constexpr (G::kBlock) {
    if (lane == 0) red[w] = key;
    __syncthreads();   // also orders the codes in device memory
    key = kBig;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) key = min(key, red[x]);
  } else {
    __syncwarp();      // the codes in shared memory, for the walk
  }
  const bool in_band = key != kBig;
  const int e = in_band ? key >> kKeyShift : kCap;
  const int d = mb - nb;
  const int slack = min(min(0, d) - lob, (lob + W - 1) - max(0, d));
  const bool ok = in_band && e < kCap && e <= slack;
  const int end_j = fe ? (key & kKeyMask) + nb + lob : mb;

  uint8_t* rec_b = out + size_t(b) * rec;
  uint8_t* ops_b = rec_b + kResBytes;
  int len = 0;
  if (t == 0) {
    int i = nb, j = end_j, dead = 0;
    if (ok) {
      while (i > 0) {
        const int c = j - i - lob;
        if (len >= L || c < 0 || c >= W) {
          dead = 1;
          break;
        }
        const int th = c / kCpt;
        const uint2 wd = codes[size_t(i - 1) * kPairs + (th >> 5) * kCpt
                               + (c - th * kCpt)];
        const int sh = th & 31;
        const unsigned code =
            ((wd.x >> sh) & 1u) | (((wd.y >> sh) & 1u) << 1);
        uint8_t op;
        if (code == kDiag) {
          op = sq[i - 1] != sr[min(max(j - 1, 0), R - 1)] ? kOpSub
                                                           : kOpMatch;
          --i;
          --j;
        } else if (code == kUp) {
          op = kOpIns;
          --i;
        } else if (code == kLeft) {
          op = kOpDel;
          --j;
        } else {
          dead = 1;
          break;
        }
        ops_b[len++] = op;
      }
    }
    int32_t* res = reinterpret_cast<int32_t*>(rec_b);
    res[kOk] = ok ? 1 : 0;
    res[kE] = e;
    res[kEndJ] = end_j;
    res[kStartJ] = ok ? j : 0;
    res[kDead] = dead;
    res[kLen] = len;
  }
  if (w == 0) {
    len = __shfl_sync(kFull, len, 0);
    for (int x = len + lane; x < rec - kResBytes; x += 32) ops_b[x] = kOpPad;
  }
}

template <int W, int NT, int PPB>
cudaError_t launch(const uint8_t* q, const uint8_t* r, const int32_t* n,
                   const int32_t* m, const int32_t* lo, const uint8_t* fs,
                   const uint8_t* fe, uint2* codes, uint8_t* out, int B,
                   int P, int R, int L, int rec, cudaStream_t stream) {
  using G = Cfg<W, NT, PPB>;
  const size_t smem = G::smem_bytes(P, R);
  auto kern = banded_dp_trace_kernel<W, NT, PPB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (B + PPB - 1) / PPB;
  kern<<<grid, NT * PPB, smem, stream>>>(q, r, n, m, lo, fs, fe, codes, out,
                                         B, P, R, L, rec);
  return cudaGetLastError();
}

}  // namespace

// (W, threads a piece, pieces a block) of each bucket width
#define DP_TRACE_CASES(X) \
  X(64, 32, 8)            \
  X(128, 32, 4)           \
  X(256, 128, 1)          \
  X(1024, 256, 1)

extern "C" long long banded_dp_trace_scratch(int B, int P, int W) {
#define X(w_, nt_, ppb_)                                             \
  if (W == w_)                                                       \
    return Cfg<w_, nt_, ppb_>::kBlock                                \
        ? static_cast<long long>(B) * P * (w_ / 32) * sizeof(uint2)  \
        : 0;
  DP_TRACE_CASES(X)
#undef X
  return -1;
}

extern "C" int banded_dp_trace_launch(
    const void* q, const void* r, const void* n, const void* m,
    const void* lo, const void* free_start, const void* free_end,
    void* codes, void* out, int B, int P, int R, int W, int L, int rec,
    void* stream) {
  const auto* q8 = static_cast<const uint8_t*>(q);
  const auto* r8 = static_cast<const uint8_t*>(r);
  const auto* n32 = static_cast<const int32_t*>(n);
  const auto* m32 = static_cast<const int32_t*>(m);
  const auto* lo32 = static_cast<const int32_t*>(lo);
  const auto* fs8 = static_cast<const uint8_t*>(free_start);
  const auto* fe8 = static_cast<const uint8_t*>(free_end);
  auto* c2 = static_cast<uint2*>(codes);
  auto* o8 = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define X(w_, nt_, ppb_)                                                  \
  if (W == w_)                                                            \
    return static_cast<int>(launch<w_, nt_, ppb_>(                        \
        q8, r8, n32, m32, lo32, fs8, fe8, c2, o8, B, P, R, L, rec, s));
  DP_TRACE_CASES(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}
