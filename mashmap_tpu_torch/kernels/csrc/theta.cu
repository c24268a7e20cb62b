// Sliding bottom-s threshold (theta) over block rows, for Hopper (sm_90a).
//
// Replaces mashmap_tpu/kernels/winnow_pallas.py::theta_chunk_pallas.
// For each block row c and offset j:
//   theta[c, j] = s-th smallest DISTINCT rank of cur[c, j:] U nxt[c, :j],
//                 or RSENT (INT32_MAX) when fewer than s are present.
//
// Design: one warp per block row (a block is one warp). A row's sorted
// bottom-s set lives in registers, E = ceil(s/32) slots per lane (slot
// lane*E + k), padded to SP = 32*E with RSENT.
//   * insert: a value at or above the set's s-th slot is a no-op (a
//     duplicate of it, larger than a full set, or RSENT), which is the
//     common case once the set is full; otherwise a warp vote finds
//     duplicates, a warp sum gives the insert position, and the slots
//     shift right by one with the carry taken from the previous lane.
//   * pass 1 walks the row backward and stores the suffix set every K
//     offsets into a global checkpoint array (n_seg x SP per row).
//   * pass 2 walks forward one K-offset segment at a time: it rebuilds
//     the segment's K suffix sets from the next checkpoint into shared
//     memory, then for each offset merges the suffix set with the
//     running prefix set of nxt (also mirrored in shared memory) and
//     inserts nxt[j] into the prefix set.
//   * merge: for each element x of one set, #(other set <= x) and
//     "x is in the other set" come from a binary search in the other
//     set; with a warp prefix count of those duplicates, x's rank among
//     the distinct union is known, and theta is the element whose rank
//     is s (the rank-count form of winnow.py::_merge_theta).
// What bounds it on this card: the bytes are tiny (cur, nxt and theta
// once each, ~12 bytes per offset) and the arithmetic per offset is
// O(s) compares, so the kernel is bound by the latency of the dependent
// per-offset chain (one merge and two inserts per offset, in order).
// The design keeps every step on-chip (registers and shared memory),
// skips most inserts with one compare, and runs one independent chain
// per warp so that the SM interleaves many rows. The TPU kernel's
// 32-row tiles with (n_seg, 32, s) and (256, 32, s) scratch would need
// megabytes of fast memory per program; here a row needs
// (K+1)*SP + K ints of shared memory (21 KB at s=130).

#include <cuda_runtime.h>
#include <stdint.h>

#define RSENT 0x7fffffff
#define FULL_MASK 0xffffffffu

template <int E>
__device__ __forceinline__ int set_slot(const int (&st)[E], int slot) {
  // value of global slot `slot` (broadcast to every lane)
  const int owner = slot / E;
  const int kk = slot - owner * E;
  int mine = RSENT;
#pragma unroll
  for (int k = 0; k < E; ++k)
    if (k == kk) mine = st[k];
  return __shfl_sync(FULL_MASK, mine, owner);
}

// Insert v (warp-uniform, v < the set's s-th slot) into the sorted set.
// Returns true if the set changed (v was not a duplicate).
template <int E>
__device__ __forceinline__ bool set_insert(int (&st)[E], int v, int s,
                                           int lane) {
  int lt = 0;
  bool dup = false;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    lt += st[k] < v;
    dup |= st[k] == v;
  }
  if (__any_sync(FULL_MASK, dup)) return false;
  int pos = lt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pos += __shfl_xor_sync(FULL_MASK, pos, off);
  const int carry = __shfl_up_sync(FULL_MASK, st[E - 1], 1);
  const int base = lane * E;
  int nw[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int g = base + k;
    const int prev = (k == 0) ? carry : st[k > 0 ? k - 1 : 0];
    const int x = g < pos ? st[k] : (g == pos ? v : prev);
    nw[k] = g < s ? x : RSENT;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) st[k] = nw[k];
  return true;
}

// #(sorted RSENT-padded set[0:s] <= x)
__device__ __forceinline__ int count_le(const int* set, int s, int x) {
  int lo = 0, n = s;
  while (n > 0) {
    const int half = n >> 1;
    if (set[lo + half] <= x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Candidates of set X for the s-th distinct of X U Y: the x whose rank
// among the distinct union is exactly s (RSENT if none).
template <int E>
__device__ __forceinline__ int rank_side(const int* X, const int* Y, int s,
                                         int lane) {
  const int base = lane * E;
  int xv[E], le[E], dupc[E];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int x = X[base + k];
    xv[k] = x;
    const int c = (x == RSENT) ? 0 : count_le(Y, s, x);
    le[k] = c;
    cnt += (c > 0 && Y[c - 1] == x) ? 1 : 0;
    dupc[k] = cnt;
  }
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  const int excl = incl - cnt;
  int best = RSENT;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int f = base + k + 1 + le[k] - (excl + dupc[k]);
    if (xv[k] != RSENT && f == s && xv[k] < best) best = xv[k];
  }
  return best;
}

template <int E>
__device__ __forceinline__ int merge_theta(const int* A, const int* B, int s,
                                           int lane) {
  int th = min(rank_side<E>(A, B, s, lane), rank_side<E>(B, A, s, lane));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    th = min(th, __shfl_xor_sync(FULL_MASK, th, off));
  return th;
}

template <int E>
__global__ void __launch_bounds__(32)
theta_kernel(const int* __restrict__ cur, const int* __restrict__ nxt,
             int* __restrict__ out, int* __restrict__ ckpt, int s_b, int s,
             int K, int n_seg) {
  extern __shared__ int smem[];
  constexpr int SP = 32 * E;
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  int* seg = smem;                 // K x SP suffix sets of one segment
  int* pre_sh = smem + K * SP;     // SP: the prefix set, mirrored
  int* obuf = pre_sh + SP;         // K theta values of one segment
  const int* cr = cur + row * s_b;
  const int* nr = nxt + row * s_b;
  int* orow = out + row * s_b;
  int* ck = ckpt + row * (size_t)n_seg * SP;

  // ---- pass 1: suffix sets, backward; ck[m] = bottom-s of cur[m*K:]
  int st[E];
#pragma unroll
  for (int k = 0; k < E; ++k) st[k] = RSENT;
  int last = RSENT;
  for (int m = n_seg - 1; m >= 1; --m) {
    for (int t = K - 1; t >= 0; --t) {
      const int j = m * K + t;
      const int v = j < s_b ? __ldg(cr + j) : RSENT;
      if (v < last && set_insert<E>(st, v, s, lane))
        last = set_slot<E>(st, s - 1);
    }
#pragma unroll
    for (int k = 0; k < E; ++k) ck[m * SP + lane * E + k] = st[k];
  }

  // ---- pass 2: forward over segments
  int pre[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    pre[k] = RSENT;
    pre_sh[lane * E + k] = RSENT;
  }
  int plast = RSENT;
  for (int m = 0; m < n_seg; ++m) {
    int sf[E];
    if (m + 1 < n_seg) {
#pragma unroll
      for (int k = 0; k < E; ++k) sf[k] = ck[(m + 1) * SP + lane * E + k];
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) sf[k] = RSENT;
    }
    int slast = set_slot<E>(sf, s - 1);
    __syncwarp();
    for (int t = K - 1; t >= 0; --t) {
      const int j = m * K + t;
      const int v = j < s_b ? __ldg(cr + j) : RSENT;
      if (v < slast && set_insert<E>(sf, v, s, lane))
        slast = set_slot<E>(sf, s - 1);
#pragma unroll
      for (int k = 0; k < E; ++k) seg[t * SP + lane * E + k] = sf[k];
    }
    __syncwarp();
    const int t_end = min(K, s_b - m * K);
    for (int t = 0; t < t_end; ++t) {
      const int j = m * K + t;
      const int th = merge_theta<E>(seg + t * SP, pre_sh, s, lane);
      if (lane == 0) obuf[t] = th;
      const int v = __ldg(nr + j);
      if (v < plast && set_insert<E>(pre, v, s, lane)) {
        plast = set_slot<E>(pre, s - 1);
        __syncwarp();
#pragma unroll
        for (int k = 0; k < E; ++k) pre_sh[lane * E + k] = pre[k];
        __syncwarp();
      }
    }
    __syncwarp();
    for (int t = lane; t < t_end; t += 32) orow[m * K + t] = obuf[t];
    __syncwarp();
  }
}

template <int E>
static cudaError_t launch(const int* cur, const int* nxt, int* out, int* ckpt,
                          int C, int s_b, int s, int K, cudaStream_t stream) {
  const int SP = 32 * E;
  const int n_seg = (s_b + K - 1) / K;
  const size_t smem = sizeof(int) * ((size_t)K * SP + SP + K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        theta_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  theta_kernel<E><<<C, 32, smem, stream>>>(cur, nxt, out, ckpt, s_b, s, K,
                                           n_seg);
  return cudaGetLastError();
}

extern "C" int theta_chunk_launch(const void* cur, const void* nxt, void* out,
                                  void* ckpt, int C, int s_b, int s, int K,
                                  void* stream) {
  if (C <= 0 || s_b <= 0) return 0;
  const int E = (s + 31) / 32;
  const int* c = static_cast<const int*>(cur);
  const int* n = static_cast<const int*>(nxt);
  int* o = static_cast<int*>(out);
  int* ck = static_cast<int*>(ckpt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (E) {
    case 1: e = launch<1>(c, n, o, ck, C, s_b, s, K, st); break;
    case 2: e = launch<2>(c, n, o, ck, C, s_b, s, K, st); break;
    case 3: e = launch<3>(c, n, o, ck, C, s_b, s, K, st); break;
    case 4: e = launch<4>(c, n, o, ck, C, s_b, s, K, st); break;
    case 5: e = launch<5>(c, n, o, ck, C, s_b, s, K, st); break;
    case 6: e = launch<6>(c, n, o, ck, C, s_b, s, K, st); break;
    case 7: e = launch<7>(c, n, o, ck, C, s_b, s, K, st); break;
    case 8: e = launch<8>(c, n, o, ck, C, s_b, s, K, st); break;
    case 9: e = launch<9>(c, n, o, ck, C, s_b, s, K, st); break;
    case 10: e = launch<10>(c, n, o, ck, C, s_b, s, K, st); break;
    case 11: e = launch<11>(c, n, o, ck, C, s_b, s, K, st); break;
    case 12: e = launch<12>(c, n, o, ck, C, s_b, s, K, st); break;
    case 13: e = launch<13>(c, n, o, ck, C, s_b, s, K, st); break;
    case 14: e = launch<14>(c, n, o, ck, C, s_b, s, K, st); break;
    case 15: e = launch<15>(c, n, o, ck, C, s_b, s, K, st); break;
    case 16: e = launch<16>(c, n, o, ck, C, s_b, s, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
