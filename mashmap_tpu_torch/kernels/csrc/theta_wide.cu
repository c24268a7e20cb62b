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
// Two kernels, with the checkpoints of theta.cu's schedule between them
// (ck_s[m], the bottom-s distinct ranks of cur[mK:], and ck_p[m], those
// of nxt[:mK], ck_p[0] empty; K = SEG_K = 128):
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
//   * kernel B (theta_wide_chain_kernel), one warp per (row, K-offset
//     segment): a prologue walks its segment backward from ck_s[m+1]
//     (RSENT for the row's last segment), inserting cur[j] into the suffix
//     set one offset at a time, and keeps what each insert pushed out of
//     slot s-1 (ev[j]; RSENT if the set was not full, -1 where the insert
//     was a no-op) in registers, K/32 a lane; the walk ends at ck_s[m]
//     (the JAX kernel's pass 2 rebuilds a segment's suffix sets from
//     checkpoint m+1 the same way). Then it steps the suffix set by
//     removing cur[j] and appending ev[j], the prefix set by inserting
//     nxt[j], visits only the offsets where a set may change, merges in
//     full at the segment's first offset and where a prefix insert pushed
//     theta itself out of the prefix set, and otherwise moves theta by one
//     place in the union (step_theta), as theta.cu does.
//
// What this does about the serial chain: a kernel A that walks each row
// once per direction (theta.cu's) makes one insert after another, each a
// binary search and a shift of up to s/32 rounds; at s = 3780 that chain
// of some 4300 inserts a row would set the time. Here no part walks a
// whole row: kernel A is n_seg merges a row, each about s/K + log2 N
// steps a thread, and the inserts move into kernel B's C * n_seg
// independent chains of at most K inserts each.
//
// A set of kernel B is a sorted array of N ints (N is SP = 32*ceil(s/32)
// rounded up to a power of two), RSENT past its elements, slot g at
// address g: a warp touches slots k*32 + lane together, one per bank. The
// array is its own sorted mirror, so the position of a rank, membership,
// theta's predecessor and successor, and the merge's counts are binary
// searches of log2(N) + 1 probes (the same address on every lane, except
// in the merge). An insert or a removal moves the slots above its
// position by one place, 32 at a time (read, __syncwarp, write): top down
// for an insert, bottom up for a removal. Kernel B's two sets (2N ints)
// live in dynamic shared memory while they fit one block's 227 KB:
// N <= SMEM_SET_MAX = 16384, that is s <= 16384
// (kernels/theta.py::WIDE_SMEM_S_MAX, where the wrapper chooses). Above
// that line the same code runs on per-warp arrays in the device scratch
// (the GMEM instances), through L1 and L2.
//
// Bound: bytes. The function reads cur and nxt and writes theta once each
// (0.0216 ms at 1208 rows of 4982, s = 680, on an H100's 3.35 TB/s; its
// operations, ceil(log2 s) + 1 a set insert, take less). The kernels also
// move 2*SP ints of checkpoint per chain.

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

// a[q], a register array's entry at a q known only at run time
__device__ __forceinline__ int pick(const int (&a)[SEG_W], int q) {
  int r = a[0];
#pragma unroll
  for (int i = 1; i < SEG_W; ++i) r = q == i ? a[i] : r;
  return r;
}

// ---- kernel B: one chain per (row, segment), one warp a block ------------
template <bool GMEM>
__global__ void __launch_bounds__(32)
theta_wide_chain_kernel(const int* __restrict__ cur,
                        const int* __restrict__ nxt,
                        const int* __restrict__ ck_s,
                        const int* __restrict__ ck_p, int* __restrict__ out,
                        int* __restrict__ sets, int C, int s_b, int s,
                        int n_seg, int N) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const int chain = blockIdx.x;
  if (chain >= C * n_seg) return;
  const int SP = 32 * ((s + 31) / 32);
  int* suf = GMEM ? sets + (size_t)chain * 2 * N : smem;
  int* pre = suf + N;
  const int row = chain / n_seg;
  const int m = chain - row * n_seg;
  const size_t rb = (size_t)row * s_b;
  const size_t cb = (size_t)chain * SP;
  const bool tail = m + 1 == n_seg;  // the row's last segment: no ck_s[m+1]
  for (int g = lane; g < N; g += 32) {
    suf[g] = g < SP && !tail ? __ldg(ck_s + cb + SP + g) : RSENT;
    pre[g] = g < SP ? __ldg(ck_p + cb + g) : RSENT;
  }
  __syncwarp();
  const int j0 = m * SEG_K;
  const int j1 = min(j0 + SEG_K, s_b);
  // prologue: the segment's eviction log, walking it backward from
  // S(j1) = ck_s[m+1] to S(j0) = ck_s[m]; a chunk's candidates
  // (v < slot s-1) go in from its highest lane down, and lane l keeps
  // ev[j0 + 32q + l] in ev[q]
  int ev[SEG_W];
  {
    int last = suf[s - 1];
#pragma unroll
    for (int qi = 0; qi < SEG_W; ++qi) {
      const int q = SEG_W - 1 - qi;
      const int j = j0 + 32 * q + lane;
      const int v = j < j1 ? __ldg(cur + rb + j) : RSENT;
      int e = -1;
      unsigned cand = __ballot_sync(FULL_MASK, v < last);
      int lsrc = 31 - __clz(cand);
      int x = __shfl_sync(FULL_MASK, v, lsrc & 31);
      while (cand) {
        cand &= ~(1u << lsrc);
        const int nsrc = 31 - __clz(cand);
        const int xn = __shfl_sync(FULL_MASK, v, nsrc & 31);
        const int old = last;
        if (x < last && set_insert(suf, N, x, s, lane, last) && lane == lsrc)
          e = old;
        lsrc = nsrc;
        x = xn;
      }
      ev[q] = e;
    }
  }
  int plast = pre[s - 1];
  int th = RSENT, ucnt = 0;
  bool stale = true;
  for (int cb0 = j0; cb0 < j1; cb0 += 32) {
    const int j = cb0 + lane;
    const bool in = j < j1;
    const int cv = in ? __ldg(cur + rb + j) : RSENT;
    const int nv = in ? __ldg(nxt + rb + j) : RSENT;
    const int evv = in ? pick(ev, (cb0 - j0) >> 5) : -1;
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
static size_t smem_bytes(int N) {
  return GMEM ? 0 : sizeof(int) * (size_t)2 * N;
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
// checkpoints, the P checkpoints), and with gmem another 2*C*n_seg*N for
// kernel B's sets. gmem = 0 puts those sets in shared memory and needs
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
