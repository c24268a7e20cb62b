// Sliding bottom-s threshold (theta) at sketch sizes above 512, for
// Hopper (sm_90a).
//
// Replaces mashmap_tpu/kernels/winnow_pallas.py::theta_chunk_pallas (and
// its XLA twin winnow.py::_theta_chunk) where s > 512, the largest s
// whose sets theta.cu holds in registers (16 slots a lane). It computes
// what theta.cu computes: for each block row c and offset j,
//   theta[c, j] = s-th smallest DISTINCT rank of cur[c, j:] U nxt[c, :j],
//                 or RSENT (INT32_MAX) when fewer than s are present.
//
// Two kernels, with per-row checkpoints between them (ck_s[m], the
// bottom-s distinct ranks of cur[mK:], and ck_p[m], those of nxt[:mK],
// ck_p[0] empty; K = SEG_K = 128):
//   * kernel A (theta_wide_scan_kernel), one block of K threads per (row,
//     direction): a scan over the row's segments, backward over cur and
//     forward over nxt. Each step merges one segment's K ranks into the
//     previous checkpoint T at once: a thread keeps its rank if it is not
//     RSENT, not held by a thread before it and not in T (a binary search
//     of T), the kept ranks place themselves in a sorted list by counting,
//     and every rank goes to its place in the union, T[i] to
//     i + #(kept < T[i]), a kept u to #(T < u) + #(kept < u); only what
//     lands below s is written. Bottom-s of a union is associative, so the
//     checkpoints are exact. T is the checkpoint this block wrote one step
//     before, read back after a __syncthreads (which makes the block's
//     global writes visible to all its threads): kernel A holds no set in
//     shared memory, only the segment.
//   * kernel B (theta_wide_chain_kernel), one warp per (row, segment m),
//     offsets j0 = mK <= j < j1 = min(j0 + K, S_B). Bottom-s of a union is
//     associative and the s-th distinct rank of X U Y is the s-th of
//     X U bottom_s(Y), so
//       theta(j) = s-th distinct rank of B_m U D(j),
//       B_m  = bottom_s(ck_s[m+1] U ck_p[m])  (cur[j1:], nxt[:j0]; read-only)
//       D(j) = cur[j:j1] U nxt[j0:j]          (a multiset of j1 - j0 ranks).
//     The chain first builds B_m, its one set, by a warp merge of the two
//     checkpoints, 32 slots of each a round (merge_base: places by
//     searches of the other round's window over shuffles, a rank both hold
//     written once), stopping once s ranks are placed; RSENT fills the
//     slots from the union's size up. Only D(j)'s useful ranks can move theta:
//     v < B_m[s-1] and v not in B_m (B_m[s-1] is RSENT while B_m is short,
//     so the one test also drops RSENT). D' keeps them sorted and distinct
//     in static shared memory, each with its count in D(j) and
//     bless = #(B_m < v): entry i has place i + 1 + bless in the union, so
//     theta is the entry of place s, or else B_m[s-1-t], t the entries of
//     place below s. From j to j+1 one cur[j] leaves D(j) and nxt[j]
//     enters: a count moves, or an entry is deleted or inserted (a binary
//     search of 8 probes and a shift of at most 4 rounds of 32), and theta
//     is recomputed only then. Offsets where neither rank is useful are
//     skipped by a ballot over 32 offsets at a time.
//
// What this does about the serial chain: no part walks a whole row and no
// step shifts an s-wide array. Kernel A is n_seg merges a row, each about
// s/K + log2 N steps a thread. Outside the one merge that builds B_m
// (about s/32 rounds of two coalesced loads and two 6-step searches),
// no operation of kernel B reads or writes more than K = 128 slots: D(j)
// holds j1 - j0 ranks, so D' never exceeds 128 entries.
//
// B_m is a sorted array of N ints (N is SP = 32*ceil(s/32) rounded up to a
// power of two), RSENT past its elements, slot g at address g, searched by
// count_lt (log2(N) + 1 probes, none of them a branch). It lives in
// dynamic shared memory while N <= SMEM_SET_MAX = 16384, that is
// s <= 16384 (kernels/theta.py::WIDE_SMEM_S_MAX, where the wrapper
// chooses); above that line the same code runs on per-chain arrays in the
// device scratch (the GMEM instances), through L1 and L2. D' (3 x 128
// ints) is static shared memory on both routes.
//
// Bound: bytes. The function reads cur and nxt and writes theta once each
// (0.0216 ms at 1208 rows of 4982, s = 680, on an H100's 3.35 TB/s; its
// operations, ceil(log2 s) + 1 a set insert, take less). The kernels also
// move 2*SP ints of checkpoint per chain.

#include <cuda_runtime.h>

#define RSENT 0x7fffffff
#define FULL_MASK 0xffffffffu

constexpr int SMEM_SET_MAX = 16384;      // largest N kernel B keeps in smem
constexpr int SMEM_BLOCK_MAX = 232448;   // shared bytes a block may opt into

// the set's array length: SP rounded up to a power of two
static inline int set_len(int s) {
  const int sp = 32 * ((s + 31) / 32);
  int n = 32;
  while (n < sp) n <<= 1;
  return n;
}

// #(Y[0:N] < x), N a power of two; found gets whether x is in Y.
// log2(N) + 1 probes, none of them a branch.
__device__ __forceinline__ int count_lt(const int* Y, int N, int x,
                                        bool& found) {
  int pos = 0;
  for (int step = N >> 1; step > 0; step >>= 1)
    pos += Y[pos + step - 1] < x ? step : 0;
  pos += Y[pos] < x ? 1 : 0;
  found = pos < N && Y[pos] == x;
  return pos;
}

// ---- kernel A: the checkpoints by a scan over segments --------------------

constexpr int SEG_K = 128;           // offsets a segment, threads of kernel A
constexpr int SEG_W = SEG_K / 32;    // chunks of 32 offsets a segment

// count_lt on a checkpoint of SP slots read as N (a power of two >= SP)
// with RSENT past SP: #(Y < x), and found gets whether x is in Y.
__device__ __forceinline__ int count_lt_ck(const int* Y, int SP, int N,
                                           int x, bool& found) {
  int pos = 0;
  for (int step = N >> 1; step > 0; step >>= 1) {
    const int g = pos + step - 1;
    pos += (g < SP ? Y[g] : RSENT) < x ? step : 0;
  }
  pos += (pos < SP ? Y[pos] : RSENT) < x ? 1 : 0;
  found = pos < SP && Y[pos] == x;
  return pos;
}

// Block w scans row w/2, the suffix checkpoints if w is even (segments
// n_seg-1 down to 0 of cur, each merge written to ck_s[m]), else the
// prefix ones (ck_p[0] empty, segment m of nxt merged into ck_p[m+1]).
// Three barriers a merge: the segment loaded (and the previous merge
// written), the kept ranks known, their sorted list complete.
__global__ void __launch_bounds__(SEG_K)
theta_wide_scan_kernel(const int* __restrict__ cur,
                       const int* __restrict__ nxt, int* ck_s, int* ck_p,
                       int C, int s_b, int s, int n_seg, int N) {
  __shared__ int vals[SEG_K];  // the segment's ranks, one a thread
  __shared__ int kv[SEG_K];    // the kept ones in place, RSENT elsewhere
  __shared__ int ks[SEG_K];    // the kept ones sorted, RSENT past them
  const int t = threadIdx.x;
  const int w = blockIdx.x;
  if (w >= 2 * C) return;  // block-uniform
  const bool suffix = (w & 1) == 0;
  const int SP = 32 * ((s + 31) / 32);
  const int row = w >> 1;
  const int* src = (suffix ? cur : nxt) + (size_t)row * s_b;
  int* ck = (suffix ? ck_s : ck_p) + (size_t)row * n_seg * SP;
  if (!suffix)
    for (int g = t; g < SP; g += SEG_K) ck[g] = RSENT;
  const int* T = ck;  // the previous checkpoint, size live ranks
  int size = 0;
  const int n_merge = suffix ? n_seg : n_seg - 1;
  for (int i = 0; i < n_merge; ++i) {
    const int m = suffix ? n_seg - 1 - i : i;
    int* out = ck + (size_t)(suffix ? m : m + 1) * SP;
    const int j = m * SEG_K + t;
    const int v = j < s_b ? __ldg(src + j) : RSENT;
    vals[t] = v;
    __syncthreads();
    bool keep = v != RSENT;
    for (int u = 0; u < SEG_K; ++u) keep = keep && !(u < t && vals[u] == v);
    int t_lt = 0;  // #(T < v)
    if (keep && size > 0) {
      bool in_t;
      t_lt = count_lt_ck(T, SP, N, v, in_t);
      keep = !in_t;
    }
    kv[t] = keep ? v : RSENT;
    ks[t] = RSENT;
    const int n_kept = __syncthreads_count(keep);
    int rk = 0;  // #(kept < v)
    for (int u = 0; u < SEG_K; ++u) rk += kv[u] < v ? 1 : 0;
    if (keep) {
      ks[rk] = v;
      if (t_lt + rk < s) out[t_lt + rk] = v;
    }
    __syncthreads();
    for (int g = t; g < size; g += SEG_K) {
      const int x = T[g];
      bool f;
      const int p = g + count_lt(ks, SEG_K, x, f);
      if (p < s) out[p] = x;
    }
    const int new_size = min(s, size + n_kept);
    for (int g = new_size + t; g < SP; g += SEG_K) out[g] = RSENT;
    T = out;
    size = new_size;
  }
}

// ---- kernel B: one chain per (row, segment), one warp a block ------------

// #(w < x) over the 32 sorted values w of a warp's lanes, by shuffles.
__device__ __forceinline__ int count_lt_warp(int w, int x) {
  int pos = 0;
  for (int step = 16; step > 0; step >>= 1)
    pos += __shfl_sync(FULL_MASK, w, pos + step - 1) < x ? step : 0;
  return pos + (__shfl_sync(FULL_MASK, w, pos) < x ? 1 : 0);
}

// The base: bottom-s of A U P, two sorted checkpoints in device memory
// (sp_a and SP slots, RSENT past their ranks; sp_a = 0 for no A), into S.
// A warp merge: each round loads the next 32 slots of each, and the
// smallest 32 of those 64 are the merge's next 32 (A's copy first where
// both hold a rank). A rank of A in lane l goes to l + #(P's window < a),
// one of P to l + #(A's window <= p) (searches of the other window by
// shuffles); a P rank is dropped where A's window or the last A rank
// merged holds it, and the rest go to their places in the distinct union,
// those below s written. Stops once s ranks are placed or both run out.
// Returns the base's size, min(s, |A U P|).
__device__ __forceinline__ int merge_base(const int* A, const int* P,
                                          int sp_a, int SP, int* S, int s,
                                          int lane) {
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int ia = 0, ip = 0, size = 0, last_a = RSENT;
  while (size < s) {
    const int a = ia + lane < sp_a ? __ldg(A + ia + lane) : RSENT;
    const int p = ip + lane < SP ? __ldg(P + ip + lane) : RSENT;
    if (!__any_sync(FULL_MASK, a != RSENT || p != RSENT)) break;
    const int ra = count_lt_warp(p, a);  // P's window below a
    const int c = count_lt_warp(a, p);   // A's window below p
    const int a_c = __shfl_sync(FULL_MASK, a, c & 31);  // on every lane
    const bool in_a = c < 32 && a_c == p;
    const int rp = c + (in_a ? 1 : 0);
    const bool dup = p != RSENT && (in_a || p == last_a);
    const int qa = lane + ra, qp = lane + rp;  // places in this round
    const unsigned dm = __ballot_sync(FULL_MASK, dup);
    const unsigned p_lt_a = ra == 32 ? FULL_MASK : (1u << ra) - 1u;
    const int da = size + qa - __popc(dm & p_lt_a);
    const int dp = size + qp - __popc(dm & below);
    const bool ta = qa < 32 && a != RSENT, tp = qp < 32 && p != RSENT && !dup;
    if (ta && da < s) S[da] = a;
    if (tp && dp < s) S[dp] = p;
    const int n_a = __popc(__ballot_sync(FULL_MASK, qa < 32));
    size += __popc(__ballot_sync(FULL_MASK, ta)) +
            __popc(__ballot_sync(FULL_MASK, tp));
    if (n_a > 0) last_a = __shfl_sync(FULL_MASK, a, n_a - 1);
    ia += n_a;
    ip += 32 - n_a;
  }
  return min(size, s);
}

// theta from the base and D' (dv ranks, dbl bless, L entries): D''s
// entry i has place i + 1 + dbl[i] in the union; theta is the entry of
// place s, or else S[s-1-t], t the entries of place below s (RSENT when
// the union holds fewer than s ranks). Places rise with i, so it stops
// at the first chunk that reaches s.
__device__ __forceinline__ int delta_theta(const int* dv, const int* dbl,
                                           int L, const int* S, int s,
                                           int lane) {
  int t = 0, hit = RSENT;
  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    const int r = i < L ? i + 1 + dbl[i] : s + 1;
    if (r == s) hit = dv[i];
    t += __popc(__ballot_sync(FULL_MASK, r < s));
    if (__any_sync(FULL_MASK, r >= s)) break;
  }
  hit = __reduce_min_sync(FULL_MASK, hit);
  return hit != RSENT ? hit : S[s - 1 - t];
}

// One copy of x (an entry of D') leaves D(j): its count falls, and at 0
// its entry goes, the entries above it moving down one place, 32 at a
// time, lowest first. RSENT enters the last slot as part of the move: a
// store of it by one lane after the move lost the last entry on the
// card. Returns whether the entry went.
__device__ __forceinline__ bool delta_remove(int* dv, int* dc, int* dbl,
                                             int& L, int x, int lane) {
  bool f;
  const int pos = count_lt(dv, SEG_K, x, f);
  int c = 0;
  if (lane == 0) {
    c = dc[pos] - 1;
    if (c > 0) dc[pos] = c;
  }
  c = __shfl_sync(FULL_MASK, c, 0);
  if (c == 0) {
    for (int lo = pos; lo < L; lo += 32) {
      const int g = lo + lane;
      const bool mv = g < L;
      const bool in = g + 1 < L;
      const int a = in ? dv[g + 1] : RSENT, b = in ? dc[g + 1] : 0,
                e = in ? dbl[g + 1] : 0;
      __syncwarp();
      if (mv) {
        dv[g] = a;
        dc[g] = b;
        dbl[g] = e;
      }
    }
    --L;
  }
  __syncwarp();
  return c == 0;
}

// One copy of v (useful, bless vb) enters D(j): its count rises, or it is
// inserted with count 1, the entries from its place up moving up one
// place, 32 at a time, top first. Returns whether an entry came.
__device__ __forceinline__ bool delta_add(int* dv, int* dc, int* dbl,
                                          int& L, int v, int vb, int lane) {
  bool f;
  const int pos = count_lt(dv, SEG_K, v, f);
  if (f) {
    if (lane == 0) ++dc[pos];
  } else {
    for (int top = L - 1; top >= pos; top -= 32) {
      const int g = top - lane;
      const bool mv = g >= pos;
      const int a = mv ? dv[g] : 0, b = mv ? dc[g] : 0, e = mv ? dbl[g] : 0;
      __syncwarp();
      if (mv) {
        dv[g + 1] = a;
        dc[g + 1] = b;
        dbl[g + 1] = e;
      }
    }
    __syncwarp();
    if (lane == 0) {
      dv[pos] = v;
      dc[pos] = 1;
      dbl[pos] = vb;
    }
    ++L;
  }
  __syncwarp();
  return !f;
}

template <bool GMEM>
__global__ void __launch_bounds__(32)
theta_wide_chain_kernel(const int* __restrict__ cur,
                        const int* __restrict__ nxt,
                        const int* __restrict__ ck_s,
                        const int* __restrict__ ck_p, int* __restrict__ out,
                        int* __restrict__ sets, int C, int s_b, int s,
                        int n_seg, int N) {
  extern __shared__ int smem[];
  __shared__ int dv[SEG_K], dc[SEG_K], dbl[SEG_K];  // D': rank, count, bless
  const int lane = threadIdx.x;
  const int chain = blockIdx.x;
  if (chain >= C * n_seg) return;
  const int SP = 32 * ((s + 31) / 32);
  int* S = GMEM ? sets + (size_t)chain * N : smem;  // the base B_m
  const int row = chain / n_seg;
  const int m = chain - row * n_seg;
  const size_t rb = (size_t)row * s_b;
  const size_t cb = (size_t)chain * SP;
  const bool tail = m + 1 == n_seg;  // the row's last segment: no ck_s[m+1]
  // the base: bottom-s of ck_s[m+1] U ck_p[m]
  const int size =
      merge_base(ck_s + cb + SP, ck_p + cb, tail ? 0 : SP, SP, S, s, lane);
  for (int g = size + lane; g < N; g += 32) S[g] = RSENT;
  __syncwarp();
  const int top = S[s - 1];  // RSENT while the base holds fewer than s
  const int j0 = m * SEG_K;
  const int j1 = min(j0 + SEG_K, s_b);
  const unsigned below = (1u << lane) - 1u;
  // the segment's ranks, lane l holding offset j0 + 32q + l in slot q;
  // useful: below the base's s-th and not in the base
  int cv[SEG_W], nv[SEG_W], cbl[SEG_W], nb[SEG_W];
  unsigned cu[SEG_W], nu[SEG_W];  // ballots of the useful ones
#pragma unroll
  for (int q = 0; q < SEG_W; ++q) {
    const int j = j0 + 32 * q + lane;
    cv[q] = j < j1 ? __ldg(cur + rb + j) : RSENT;
    nv[q] = j < j1 ? __ldg(nxt + rb + j) : RSENT;
    bool in_c = true, in_n = true;
    cbl[q] = cv[q] < top ? count_lt(S, N, cv[q], in_c) : 0;
    nb[q] = nv[q] < top ? count_lt(S, N, nv[q], in_n) : 0;
    cu[q] = __ballot_sync(FULL_MASK, !in_c);
    nu[q] = __ballot_sync(FULL_MASK, !in_n);
  }
  // D' at j0 from the useful ranks of cur[j0:j1]: compacted in offset
  // order into dc (ci), a rank's first copy keeps it (kept ones in dbl),
  // its count is its copies, its place the kept ranks below it
  int ci[SEG_W], U = 0;
#pragma unroll
  for (int q = 0; q < SEG_W; ++q) {
    ci[q] = U + __popc(cu[q] & below);
    if ((cu[q] >> lane) & 1) dc[ci[q]] = cv[q];
    U += __popc(cu[q]);
  }
  __syncwarp();
  int cnt[SEG_W];
  bool first[SEG_W];
#pragma unroll
  for (int q = 0; q < SEG_W; ++q) {
    const bool mine = (cu[q] >> lane) & 1;
    cnt[q] = 0;
    first[q] = mine;
    for (int u = 0; mine && u < U; ++u) {
      const int y = dc[u];
      cnt[q] += y == cv[q] ? 1 : 0;
      first[q] = first[q] && !(u < ci[q] && y == cv[q]);
    }
    if (mine) dbl[ci[q]] = first[q] ? cv[q] : RSENT;
  }
  __syncwarp();
  int rk[SEG_W], L = 0;
#pragma unroll
  for (int q = 0; q < SEG_W; ++q) {
    rk[q] = 0;
    for (int u = 0; first[q] && u < U; ++u) rk[q] += dbl[u] < cv[q] ? 1 : 0;
    L += __popc(__ballot_sync(FULL_MASK, first[q]));
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < SEG_W; ++q) {
    if (first[q]) {
      dv[rk[q]] = cv[q];
      dc[rk[q]] = cnt[q];
      dbl[rk[q]] = cbl[q];
    }
    if (32 * q + lane >= L) dv[32 * q + lane] = RSENT;
  }
  __syncwarp();
  int th = delta_theta(dv, dbl, L, S, s, lane);
  // the walk: a step from j to j+1 takes one cur[j] out of D(j) and puts
  // nxt[j] in; only where either is useful (and they differ) can D'
  // change, and theta is recomputed only where an entry came or went
#pragma unroll
  for (int q = 0; q < SEG_W; ++q) {
    const int cb0 = j0 + 32 * q;
    if (cb0 >= j1) break;  // warp-uniform
    const int j = cb0 + lane;
    unsigned events = __ballot_sync(FULL_MASK, j + 1 < j1 && cv[q] != nv[q])
                      & (cu[q] | nu[q]);
    const int n = min(32, j1 - cb0);
    int mine = RSENT, done = 0;  // offsets cb0 .. cb0+done-1 have theta
    for (;;) {
      const int t = events ? __ffs(events) - 1 : n - 1;
      if (lane >= done && lane <= t) mine = th;
      done = t + 1;
      if (!events) break;
      events &= events - 1u;
      const int x = __shfl_sync(FULL_MASK, cv[q], t);
      const int v = __shfl_sync(FULL_MASK, nv[q], t);
      const int vb = __shfl_sync(FULL_MASK, nb[q], t);
      bool chg = false;
      if ((cu[q] >> t) & 1) chg = delta_remove(dv, dc, dbl, L, x, lane);
      if ((nu[q] >> t) & 1)
        chg = delta_add(dv, dc, dbl, L, v, vb, lane) || chg;
      if (chg) th = delta_theta(dv, dbl, L, S, s, lane);
    }
    if (j < j1) out[rb + j] = mine;
  }
}

// ---- host side -----------------------------------------------------------

template <bool GMEM>
static size_t smem_bytes(int N) {
  return GMEM ? 0 : sizeof(int) * (size_t)N;
}

// allow kernel B's blocks their dynamic shared memory (above 48 KB only
// on opt-in); kernel A's is static
template <bool GMEM>
static cudaError_t set_smem(int N) {
  if (GMEM) return cudaSuccess;
  if (smem_bytes<GMEM>(N) > SMEM_BLOCK_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(theta_wide_chain_kernel<GMEM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<GMEM>(N));
}

template <bool GMEM>
static cudaError_t launch(const int* cur, const int* nxt, int* out,
                          int* scratch, int C, int s_b, int s,
                          cudaStream_t stream) {
  const int n_seg = (s_b + SEG_K - 1) / SEG_K;
  const int SP = 32 * ((s + 31) / 32);
  const int N = set_len(s);
  cudaError_t err = set_smem<GMEM>(N);
  if (err != cudaSuccess) return err;
  int* ck_s = scratch;
  int* ck_p = ck_s + (size_t)C * n_seg * SP;
  int* sets = GMEM ? ck_p + (size_t)C * n_seg * SP : nullptr;
  theta_wide_scan_kernel<<<2 * C, SEG_K, 0, stream>>>(cur, nxt, ck_s, ck_p,
                                                     C, s_b, s, n_seg, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  theta_wide_chain_kernel<GMEM><<<C * n_seg, 32, smem_bytes<GMEM>(N),
                                  stream>>>(cur, nxt, ck_s, ck_p, out, sets,
                                            C, s_b, s, n_seg, N);
  return cudaGetLastError();
}

template <bool GMEM>
static cudaError_t occupancy(int s, int* warps_a, int* warps_b) {
  const int N = set_len(s);
  int na = 0, nb = 0;
  cudaError_t err = set_smem<GMEM>(N);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &na, theta_wide_scan_kernel, SEG_K, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, theta_wide_chain_kernel<GMEM>, 32, smem_bytes<GMEM>(N));
  *warps_a = na * SEG_W;
  *warps_b = nb;
  return err;
}

// Launch both kernels on `stream`. scratch holds 2*C*n_seg*SP ints (the S
// checkpoints, the P checkpoints), and with gmem another C*n_seg*N for
// kernel B's bases. gmem = 0 puts the bases in shared memory and needs
// s <= 16384. K must be SEG_K (128).
extern "C" int theta_wide_launch(const void* cur, const void* nxt, void* out,
                                 void* scratch, int C, int s_b, int s, int K,
                                 int gmem, void* stream) {
  if (C <= 0 || s_b <= 0) return 0;
  if (K != SEG_K || s < 1) return (int)cudaErrorInvalidValue;
  auto* c = static_cast<const int*>(cur);
  auto* n = static_cast<const int*>(nxt);
  auto* o = static_cast<int*>(out);
  auto* sc = static_cast<int*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  return gmem ? (int)launch<true>(c, n, o, sc, C, s_b, s, st)
              : (int)launch<false>(c, n, o, sc, C, s_b, s, st);
}

// Resident warps per SM of each kernel at sketch size s on this route, as
// the occupancy calculator gives them for this build (kernel A: resident
// blocks times SEG_K / 32).
extern "C" int theta_wide_occupancy(int s, int gmem, int* warps_a,
                                    int* warps_b) {
  return gmem ? (int)occupancy<true>(s, warps_a, warps_b)
              : (int)occupancy<false>(s, warps_a, warps_b);
}
