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
// The schedule is theta.cu's, unchanged (see its header):
//   * kernel A (theta_wide_ckpt_kernel), one warp per (row, direction):
//     walks cur backward and nxt forward once, stores the suffix and
//     prefix sets at every K-th offset, and logs what each insert into
//     the suffix set pushed out of slot s-1 (ev[j]; RSENT if the set was
//     not full, -1 where the insert was a no-op);
//   * kernel B (theta_wide_chain_kernel), one warp per (row, K-offset
//     segment): steps the suffix set by removing cur[j] and appending
//     ev[j], the prefix set by inserting nxt[j], visits only the offsets
//     where a set may change, merges in full at the segment's first offset
//     and where a prefix insert pushed theta itself out of the prefix set,
//     and otherwise moves theta by one place in the union (step_theta).
//
// Only where a set lives changes. A set is a sorted array of N ints (N is
// SP = 32*ceil(s/32) rounded up to a power of two), RSENT past its
// elements, slot g at address g: a warp touches slots k*32 + lane
// together, one per bank. The array is its own sorted mirror, so the
// position of a rank, membership, theta's predecessor and successor, and
// the merge's counts are binary searches of log2(N) + 1 probes (the same
// address on every lane, except in the merge). An insert or a removal
// moves the slots above its position by one place, 32 at a time (read,
// __syncwarp, write): top down for an insert, bottom up for a removal.
//
// Each warp is a block of its own. Kernel A's set (N ints) and kernel B's
// two (2N ints) live in dynamic shared memory while 2N ints fit one
// block's 227 KB: N <= SMEM_SET_MAX = 16384, that is s <= 16384
// (kernels/theta.py::WIDE_SMEM_S_MAX, where the wrapper chooses). Above
// that line the same code runs on per-warp arrays in the device scratch
// (the GMEM instances), through L1 and L2.
//
// The bytes are theta.cu's (cur, nxt and theta once each, the eviction
// log, 2*SP ints of checkpoint per chain). The work is the shifts (up to
// s/32 shared-memory round trips a lane per insert or removal) and the
// merges (at most 2*SP/32 binary searches a lane, stopped once a rank
// reaches s). A simple kernel first: at s = 3780 a warp's two sets take
// 32 KB, so 6 chains share an SM.

#include <cuda_runtime.h>

#define RSENT 0x7fffffff
#define FULL_MASK 0xffffffffu

constexpr int SMEM_SET_MAX = 16384;      // largest N with 2N ints in a block
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

// largest element of Y below th, or -1
__device__ __forceinline__ int pred(const int* Y, int N, int th) {
  bool f;
  const int i = count_lt(Y, N, th, f);
  return i > 0 ? Y[i - 1] : -1;
}

// smallest element of Y above th, or RSENT
__device__ __forceinline__ int succ(const int* Y, int N, int th) {
  bool f;
  const int i = count_lt(Y, N, th, f) + (f ? 1 : 0);
  return i < N ? Y[i] : RSENT;
}

// Insert v (warp-uniform, v < last, the set's slot s-1) into the sorted
// set S. Returns true if the set changed (v was not in it), and then sets
// last to the new slot s-1. Slots pos..s-2 move up one place, the top 32
// first; a chunk's reads and the next chunk's writes touch other slots.
__device__ __forceinline__ bool set_insert(int* S, int N, int v, int s,
                                           int lane, int& last) {
  bool dup;
  const int pos = count_lt(S, N, v, dup);
  if (dup) return false;  // warp-uniform
  for (int top = s - 2; top >= pos; top -= 32) {
    const int g = top - lane;
    const int y = g >= pos ? S[g] : RSENT;
    __syncwarp();
    if (g >= pos) S[g + 1] = y;
  }
  __syncwarp();  // every lane's search and reads are done
  if (lane == 0) S[pos] = v;
  __syncwarp();
  last = S[s - 1];
  return true;
}

// Remove x (warp-uniform, present in the set) and put e in slot s-1: the
// inverse of an insert of x that pushed e out of slot s-1. Slots
// pos+1..s-1 move down one place, the lowest 32 first.
__device__ __forceinline__ void set_remove_append(int* S, int N, int x,
                                                  int e, int s, int lane) {
  bool found;
  const int pos = count_lt(S, N, x, found);
  for (int lo = pos; lo < s - 1; lo += 32) {
    const int g = lo + lane;
    const int y = g < s - 1 ? S[g + 1] : RSENT;
    __syncwarp();
    if (g < s - 1) S[g] = y;
  }
  __syncwarp();
  if (lane == 0) S[s - 1] = e;
  __syncwarp();
}

// Candidates of set X for the s-th distinct of X U Y, X's slots 32 at a
// time: x in slot g has rank g + 1 + #(Y <= x) - #(X's elements up to x
// that Y holds) in the distinct union (a ballot's running count gives the
// last). Returns the x of rank exactly s on this lane (RSENT if none).
// Stops at X's first RSENT, or once a rank reaches s (the union then holds
// s ranks and theta is known); n_live and n_dup get X's elements and
// those that Y holds, complete when it did not stop at a rank.
__device__ __forceinline__ int rank_side(const int* X, const int* Y, int N,
                                         int s, int lane, int& n_live,
                                         int& n_dup) {
  int best = RSENT, live_c = 0, dup_c = 0;
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes <= this one
  for (int base = 0; base < s; base += 32) {
    const int g = base + lane;
    const int x = g < s ? X[g] : RSENT;
    const bool live = x != RSENT;
    bool in_y = false;
    const int lt = live ? count_lt(Y, N, x, in_y) : 0;
    const unsigned dm = __ballot_sync(FULL_MASK, live && in_y);
    const unsigned lm = __ballot_sync(FULL_MASK, live);
    const int f = g + 1 + lt + (in_y ? 1 : 0) - (dup_c + __popc(dm & upto));
    if (live && f == s) best = x;
    dup_c += __popc(dm);
    live_c += __popc(lm);
    if (__any_sync(FULL_MASK, live && f >= s) || lm != FULL_MASK) break;
  }
  n_live = live_c;
  n_dup = dup_c;
  return best;
}

// theta of a U b, and in ucnt the size of the distinct union (which
// step_theta reads while theta is RSENT; exact then, as neither side
// stopped at a rank)
__device__ __forceinline__ int merge_theta(const int* a, const int* b,
                                           int N, int s, int lane,
                                           int& ucnt) {
  int na, da, nb, db;
  const int th = min(rank_side(a, b, N, s, lane, na, da),
                     rank_side(b, a, N, s, lane, nb, db));
  ucnt = na + nb - da;
  return __reduce_min_sync(FULL_MASK, th);
}

// theta.cu's step_theta on sets in memory: the union lost x unless pre
// holds it and gained v unless suf held it, and theta moves to its
// predecessor or successor in the union, or stays; under an RSENT theta
// ucnt tells when the union reaches s ranks, and theta is its largest.
__device__ __forceinline__ int step_theta(int th, int& ucnt, const int* suf,
                                          const int* pre, int N, int x,
                                          bool s_low, int v, bool p_low,
                                          bool s_chg, int s) {
  bool x_in_p, v_in_s;
  count_lt(pre, N, x, x_in_p);
  count_lt(suf, N, v, v_in_s);
  const bool rem = s_low && !x_in_p;
  const bool add = p_low && !v_in_s && !(s_chg && v == x);
  const int net = (int)add - (int)rem;
  if (th == RSENT) {
    ucnt += net;
    if (ucnt < s) return RSENT;
    return max(pred(suf, N, RSENT), pred(pre, N, RSENT));
  }
  if (net == 1 || (net == 0 && rem && x == th))
    return max(pred(suf, N, th), pred(pre, N, th));
  if (net == -1) {
    const int best = min(succ(suf, N, th), succ(pre, N, th));
    if (best == RSENT) ucnt = s - 1;  // the union fell below s ranks
    return best;
  }
  return th;
}

// a set's first SP slots to and from the checkpoints, in slot order
__device__ __forceinline__ void store_set(int* dst, const int* S, int SP,
                                          int lane) {
  for (int g = lane; g < SP; g += 32) dst[g] = S[g];
}

// ---- kernel A: checkpoints of S and P every K offsets, eviction log ------

constexpr int GROUP = 4;  // chunks of 32 offsets loaded ahead of their use

// theta.cu's walk_row with the set in memory: the suffix walk (SUFFIX)
// goes backward over cur, takes a chunk's candidates (v < slot s-1) from
// its highest lane down, logs ev and stores the set after the chunk; the
// prefix walk goes forward over nxt, lowest lane first, and stores the
// set before the chunk. ck gets the set at offset m*K in slot m.
template <bool SUFFIX>
__device__ __forceinline__ void walk_row(const int* __restrict__ src,
                                         int* __restrict__ ck,
                                         int* __restrict__ evrow, int* S,
                                         int N, int SP, int s_b, int s,
                                         int K, int lane) {
  for (int g = lane; g < N; g += 32) S[g] = RSENT;
  __syncwarp();
  const int n_chunk = (s_b + 31) / 32;
  const int n_grp = (n_chunk + GROUP - 1) / GROUP;
  int last = RSENT;  // slot s-1 of the set
  int buf[GROUP], nbuf[GROUP];
  auto load = [&](int g, int (&b)[GROUP]) {
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      const int j = (g * GROUP + q) * 32 + lane;
      b[q] = (g >= 0 && g < n_grp && j < s_b) ? __ldg(src + j) : RSENT;
    }
  };
  load(SUFFIX ? n_grp - 1 : 0, buf);
  for (int gi = 0; gi < n_grp; ++gi) {
    const int g = SUFFIX ? n_grp - 1 - gi : gi;
    load(SUFFIX ? g - 1 : g + 1, nbuf);
#pragma unroll
    for (int qi = 0; qi < GROUP; ++qi) {
      const int q = SUFFIX ? GROUP - 1 - qi : qi;
      const int ci = g * GROUP + q;
      if (ci >= n_chunk) continue;  // warp-uniform
      const int v = buf[q];
      if (!SUFFIX && (ci * 32) % K == 0)
        store_set(ck + (size_t)(ci * 32 / K) * SP, S, SP, lane);
      int e = -1;
      unsigned cand = __ballot_sync(FULL_MASK, v < last);
      int lsrc = SUFFIX ? 31 - __clz(cand) : __ffs(cand) - 1;
      int x = __shfl_sync(FULL_MASK, v, lsrc & 31);
      while (cand) {
        cand &= ~(1u << lsrc);
        const int nsrc = SUFFIX ? 31 - __clz(cand) : __ffs(cand) - 1;
        const int xn = __shfl_sync(FULL_MASK, v, nsrc & 31);
        const int old = last;
        if (x < last && set_insert(S, N, x, s, lane, last) && lane == lsrc)
          e = old;
        lsrc = nsrc;
        x = xn;
      }
      if (SUFFIX) {
        const int j = ci * 32 + lane;
        if (j < s_b) evrow[j] = e;
        if ((ci * 32) % K == 0)
          store_set(ck + (size_t)(ci * 32 / K) * SP, S, SP, lane);
      }
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) buf[q] = nbuf[q];
  }
}

// one warp a block: block w walks row w/2, the suffix set if w is even
template <bool GMEM>
__global__ void __launch_bounds__(32)
theta_wide_ckpt_kernel(const int* __restrict__ cur,
                       const int* __restrict__ nxt, int* __restrict__ ck_s,
                       int* __restrict__ ck_p, int* __restrict__ ev,
                       int* __restrict__ sets, int C, int s_b, int s, int K,
                       int n_seg, int N) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const int w = blockIdx.x;
  if (w >= 2 * C) return;
  const int SP = 32 * ((s + 31) / 32);
  int* S = GMEM ? sets + (size_t)w * N : smem;
  const int row = w >> 1;
  const size_t rb = (size_t)row * s_b;
  const size_t cb = (size_t)row * n_seg * SP;
  if ((w & 1) == 0)
    walk_row<true>(cur + rb, ck_s + cb, ev + rb, S, N, SP, s_b, s, K, lane);
  else
    walk_row<false>(nxt + rb, ck_p + cb, nullptr, S, N, SP, s_b, s, K,
                    lane);
}

// ---- kernel B: one chain per (row, segment), one warp a block ------------
template <bool GMEM>
__global__ void __launch_bounds__(32)
theta_wide_chain_kernel(const int* __restrict__ cur,
                        const int* __restrict__ nxt,
                        const int* __restrict__ ck_s,
                        const int* __restrict__ ck_p,
                        const int* __restrict__ ev, int* __restrict__ out,
                        int* __restrict__ sets, int C, int s_b, int s, int K,
                        int n_seg, int N) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const int chain = blockIdx.x;
  if (chain >= C * n_seg) return;
  const int SP = 32 * ((s + 31) / 32);
  int* suf = GMEM ? sets + (size_t)chain * 2 * N : smem;
  int* pre = suf + N;
  const size_t cb = (size_t)chain * SP;
  for (int g = lane; g < N; g += 32) {
    suf[g] = g < SP ? __ldg(ck_s + cb + g) : RSENT;
    pre[g] = g < SP ? __ldg(ck_p + cb + g) : RSENT;
  }
  __syncwarp();
  const int row = chain / n_seg;
  const int m = chain - row * n_seg;
  const size_t rb = (size_t)row * s_b;
  int plast = pre[s - 1];
  int th = RSENT, ucnt = 0;
  bool stale = true;
  const int j1 = min(m * K + K, s_b);
  for (int cb0 = m * K; cb0 < j1; cb0 += 32) {
    const int j = cb0 + lane;
    const bool in = j < j1;
    const int cv = in ? __ldg(cur + rb + j) : RSENT;
    const int nv = in ? __ldg(nxt + rb + j) : RSENT;
    const int evv = in ? __ldg(ev + rb + j) : -1;
    // only the offsets where a set may change are visited (theta.cu)
    unsigned events =
        __ballot_sync(FULL_MASK, in && (evv != -1 || nv < plast));
    const int n = min(32, j1 - cb0);
    int mine = RSENT, done = 0;  // offsets cb0 .. cb0+done-1 have theta
    for (;;) {
      const int t = events ? __ffs(events) - 1 : n;
      const int upto = events ? t + 1 : n;
      if (upto > done) {
        if (stale) {
          th = merge_theta(suf, pre, N, s, lane, ucnt);
          stale = false;
        }
        if (lane >= done && lane < upto) mine = th;
        done = upto;
      }
      if (!events) break;
      events &= events - 1u;
      const int e = __shfl_sync(FULL_MASK, evv, t);
      const int x = __shfl_sync(FULL_MASK, cv, t);
      const int v = __shfl_sync(FULL_MASK, nv, t);
      const bool s_chg = e != -1;
      if (s_chg) set_remove_append(suf, N, x, e, s, lane);
      bool p_chg = false;
      const int p_out = plast;  // what an insert pushes out of slot s-1
      if (v < plast && set_insert(pre, N, v, s, lane, plast)) p_chg = true;
      const bool s_low = s_chg && x <= th;
      const bool p_low = p_chg && v <= th;
      if (s_low || p_low) {
        if (th != RSENT && p_chg && p_out == th)
          stale = true;  // merge in full at the next offset
        else
          th = step_theta(th, ucnt, suf, pre, N, x, s_low, v, p_low, s_chg,
                          s);
      }
    }
    if (in) out[rb + j] = mine;
  }
}

// ---- host side -----------------------------------------------------------

template <bool GMEM>
static size_t smem_bytes(int n_sets, int N) {
  return GMEM ? 0 : sizeof(int) * (size_t)n_sets * N;
}

// allow the blocks their dynamic shared memory (above 48 KB only on opt-in)
template <bool GMEM>
static cudaError_t set_smem(int N) {
  if (GMEM) return cudaSuccess;
  if (smem_bytes<GMEM>(2, N) > SMEM_BLOCK_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      theta_wide_ckpt_kernel<GMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<GMEM>(1, N));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(theta_wide_chain_kernel<GMEM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<GMEM>(2, N));
}

template <bool GMEM>
static cudaError_t launch(const int* cur, const int* nxt, int* out,
                          int* scratch, int C, int s_b, int s, int K,
                          cudaStream_t stream) {
  const int n_seg = (s_b + K - 1) / K;
  const int SP = 32 * ((s + 31) / 32);
  const int N = set_len(s);
  cudaError_t err = set_smem<GMEM>(N);
  if (err != cudaSuccess) return err;
  int* ck_s = scratch;
  int* ck_p = ck_s + (size_t)C * n_seg * SP;
  int* ev = ck_p + (size_t)C * n_seg * SP;
  int* sets = GMEM ? ev + (size_t)C * s_b : nullptr;
  theta_wide_ckpt_kernel<GMEM><<<2 * C, 32, smem_bytes<GMEM>(1, N),
                                 stream>>>(cur, nxt, ck_s, ck_p, ev, sets, C,
                                           s_b, s, K, n_seg, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  theta_wide_chain_kernel<GMEM><<<C * n_seg, 32, smem_bytes<GMEM>(2, N),
                                  stream>>>(cur, nxt, ck_s, ck_p, ev, out,
                                            sets, C, s_b, s, K, n_seg, N);
  return cudaGetLastError();
}

template <bool GMEM>
static cudaError_t occupancy(int s, int* warps_a, int* warps_b) {
  const int N = set_len(s);
  int na = 0, nb = 0;
  cudaError_t err = set_smem<GMEM>(N);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &na, theta_wide_ckpt_kernel<GMEM>, 32, smem_bytes<GMEM>(1, N));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, theta_wide_chain_kernel<GMEM>, 32, smem_bytes<GMEM>(2, N));
  *warps_a = na;
  *warps_b = nb;
  return err;
}

// Launch both kernels on `stream`. scratch holds 2*C*n_seg*SP + C*s_b
// ints (the S checkpoints, the P checkpoints, the eviction log), and with
// gmem another 2*C*n_seg*N for the sets (kernel A uses the first 2*C*N).
// gmem = 0 puts the sets in shared memory and needs s <= 16384. K is a
// multiple of 32.
extern "C" int theta_wide_launch(const void* cur, const void* nxt, void* out,
                                 void* scratch, int C, int s_b, int s, int K,
                                 int gmem, void* stream) {
  if (C <= 0 || s_b <= 0) return 0;
  if (K <= 0 || K % 32 != 0 || s < 1) return (int)cudaErrorInvalidValue;
  auto* c = static_cast<const int*>(cur);
  auto* n = static_cast<const int*>(nxt);
  auto* o = static_cast<int*>(out);
  auto* sc = static_cast<int*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  return gmem ? (int)launch<true>(c, n, o, sc, C, s_b, s, K, st)
              : (int)launch<false>(c, n, o, sc, C, s_b, s, K, st);
}

// Resident warps per SM of each kernel at sketch size s on this route, as
// the occupancy calculator gives them for this build.
extern "C" int theta_wide_occupancy(int s, int gmem, int* warps_a,
                                    int* warps_b) {
  return gmem ? (int)occupancy<true>(s, warps_a, warps_b)
              : (int)occupancy<false>(s, warps_a, warps_b);
}
