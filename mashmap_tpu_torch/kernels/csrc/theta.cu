// Sliding bottom-s threshold (theta) over block rows, for Hopper (sm_90a).
//
// Replaces mashmap_tpu/kernels/winnow_pallas.py::theta_chunk_pallas.
// For each block row c and offset j:
//   theta[c, j] = s-th smallest DISTINCT rank of cur[c, j:] U nxt[c, :j],
//                 or RSENT (INT32_MAX) when fewer than s are present.
// With S_j the bottom-s set of cur[j:] and P_j that of nxt[:j], theta[j]
// is the s-th distinct element of S_j U P_j.
//
// A row's offsets form a dependent chain (S_j comes from S_{j+1}, P_{j+1}
// from P_j), so one warp per row leaves an H100 with a few warps per SM
// and the row's chain sets the time. This file cuts each row into
// independent chains in two kernels:
//   * kernel A (theta_ckpt_kernel), one warp per (row, direction): walks
//     cur backward and nxt forward once, stores S and P at every K-th
//     offset, and logs for every j what inserting cur[j] into S_{j+1}
//     pushed out of slot s-1 (ev[j]; RSENT if the set was not full, -1
//     where the insert was a no-op).
//   * kernel B (theta_chain_kernel), one warp per (row, K-offset segment):
//     starts from the segment's two checkpoints and walks forward; S
//     steps by removing cur[j] and appending ev[j] in slot s-1 (the exact
//     inverse of A's insert), P by inserting nxt[j]. Only offsets where a
//     set may change are visited (a ballot over each 32 offsets); the
//     offsets between two visits share one theta. theta is merged in full
//     at the segment's first offset. After that a change above theta
//     leaves it, and a change at or below it moves theta by one place in
//     the union, to its predecessor or successor (step_theta), or while
//     theta is RSENT (fewer than s ranks) to the union's largest once it
//     holds s; only where the prefix insert pushed theta itself out of P
//     is the next offset merged in full again.
// A set lives in registers, E = ceil(s/32) slots per lane (slot lane*E +
// k), RSENT-padded to SP = 32*E. An insert is skipped with one compare
// against slot s-1; otherwise a warp vote finds duplicates, a warp sum
// gives the position, and slots shift by one with the carry taken from
// the neighbouring lane. The merge counts, for each element x of one set,
// #(other set <= x) and "x is in the other set" by a fixed-step binary
// search of the other set's shared-memory mirror; with a warp prefix
// count of those duplicates x's rank in the distinct union is known, and
// theta is the element of rank s (the rank-count form of
// winnow.py::_merge_theta).
// The bytes are few (cur, nxt and theta once each, the eviction log, and
// 2*SP ints of checkpoint per chain); the work is the warp-wide set
// operations (O(E) int32 instructions per lane per insert, removal or
// step of theta). The design keeps many chains resident (C * S_B / K
// warps, 32 per SM at s=130) and does O(E) work, not a merge, at most
// offsets where a set changed.

#include <cuda_runtime.h>

#define RSENT 0x7fffffff
#define FULL_MASK 0xffffffffu

constexpr int WARPS_A = 4;  // warps per block of kernel A
constexpr int WARPS_B = 4;  // chains per block of kernel B

// blocks of kernel B per SM that the register allocation must allow
__host__ __device__ constexpr int min_blocks_b(int E) {
  return E <= 8 ? 8 : (E <= 12 ? 6 : 4);
}

// a set's shared-memory mirror: SP rounded up to a power of two
__host__ __device__ constexpr int mirror_len(int E) {
  int n = 32;
  while (n < 32 * E) n <<= 1;
  return n;
}

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

// Insert v (warp-uniform, v < last, the set's slot s-1) into the sorted
// set. Returns true if the set changed (v was not a duplicate), and then
// sets last to the new slot s-1. The four warp operations depend only on
// the set before the insert, so they issue together.
template <int E>
__device__ __forceinline__ bool set_insert(int (&st)[E], int v, int s,
                                           int lane, int& last) {
  int lt = 0;
  bool dup = false;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    lt += st[k] < v;
    dup |= st[k] == v;
  }
  const unsigned dups = __ballot_sync(FULL_MASK, dup);
  const int pos = __reduce_add_sync(FULL_MASK, lt);
  const int carry = __shfl_up_sync(FULL_MASK, st[E - 1], 1);
  const int below = set_slot<E>(st, s - 2);  // unused when s == 1
  if (dups) return false;
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
  last = pos == s - 1 ? v : below;  // v < last puts v at or below s-1
  return true;
}

// Remove x (warp-uniform, present in the set) and put e in slot s-1:
// the inverse of an insert of x that pushed e out of slot s-1.
template <int E>
__device__ __forceinline__ void set_remove_append(int (&st)[E], int x, int e,
                                                  int s, int lane) {
  int lt = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) lt += st[k] < x;
  const int pos = __reduce_add_sync(FULL_MASK, lt);
  const int carry = __shfl_down_sync(FULL_MASK, st[0], 1);
  const int base = lane * E;
  int nw[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int g = base + k;
    const int next = (k == E - 1) ? carry : st[k < E - 1 ? k + 1 : 0];
    nw[k] = g < pos ? st[k] : (g < s - 1 ? next : (g == s - 1 ? e : RSENT));
  }
#pragma unroll
  for (int k = 0; k < E; ++k) st[k] = nw[k];
}

// #(sorted set Y[0:N] <= x), N a power of two, and whether x is in Y:
// log2(N) + 1 probes, none of them a branch.
template <int N>
__device__ __forceinline__ int count_le(const int* Y, int x, bool& found) {
  int pos = 0;
  bool eq = false;
#pragma unroll
  for (int step = N / 2; step > 0; step >>= 1) {
    const int y = Y[pos + step - 1];
    eq |= y == x;
    pos += y <= x ? step : 0;
  }
  const int y = Y[pos];
  eq |= y == x;
  found = eq;
  return pos + (y <= x ? 1 : 0);
}

// Candidates of set X (this lane's slots xv) for the s-th distinct of
// X U Y: the x whose rank among the distinct union is exactly s (RSENT
// if none); n_dup gets how many elements of X are in Y.
template <int E>
__device__ __forceinline__ int rank_side(const int (&xv)[E], const int* Y,
                                         int s, int lane, int& n_dup) {
  constexpr int N = mirror_len(E);
  const int base = lane * E;
  int le[E], dupc[E];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    bool in_y;
    le[k] = count_le<N>(Y, xv[k], in_y);
    cnt += (in_y && xv[k] != RSENT) ? 1 : 0;
    dupc[k] = cnt;
  }
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  const int excl = incl - cnt;
  n_dup = __shfl_sync(FULL_MASK, incl, 31);  // X's elements that are in Y
  int best = RSENT;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int f = base + k + 1 + le[k] - (excl + dupc[k]);
    if (xv[k] != RSENT && f == s && xv[k] < best) best = xv[k];
  }
  return best;
}

// theta of a U b, and in ucnt the size of the distinct union (which
// step_theta reads while theta is RSENT)
template <int E>
__device__ __forceinline__ int merge_theta(const int (&a)[E], const int* A_sh,
                                           const int (&b)[E], const int* B_sh,
                                           int s, int lane, int& ucnt) {
  int dup_a, dup_b, n = 0;
  const int th = min(rank_side<E>(a, B_sh, s, lane, dup_a),
                     rank_side<E>(b, A_sh, s, lane, dup_b));
#pragma unroll
  for (int k = 0; k < E; ++k) n += (a[k] != RSENT) + (b[k] != RSENT);
  ucnt = __reduce_add_sync(FULL_MASK, n) - dup_a;
  return __reduce_min_sync(FULL_MASK, th);
}

// theta after one step of kernel B whose changes at or below th are s_low
// (x left the suffix set) and p_low (v entered the prefix set); suf and
// pre are the sets after the step, and the prefix insert did not push a
// th < RSENT out of pre. Every rank at or below th is then in suf U pre
// exactly, so the union lost x unless pre holds it and gained v unless
// the suffix set held it (it holds it now, or v == x), and theta moves to
// its predecessor (net +1, or x was theta and v replaced it) or its
// successor (net -1) in the union, or stays. Under an RSENT theta the
// union holds fewer than s ranks, neither set is truncated, and ucnt
// (the union's size) tells when it reaches s: theta is then its largest.
template <int E>
__device__ __forceinline__ int step_theta(int th, int& ucnt,
                                          const int (&suf)[E],
                                          const int (&pre)[E], int x,
                                          bool s_low, int v, bool p_low,
                                          bool s_chg, int s) {
  bool x_in_p = false, v_in_s = false;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    x_in_p |= pre[k] == x;
    v_in_s |= suf[k] == v;
  }
  x_in_p = __any_sync(FULL_MASK, x_in_p);
  v_in_s = __any_sync(FULL_MASK, v_in_s);
  const bool rem = s_low && !x_in_p;
  const bool add = p_low && !v_in_s && !(s_chg && v == x);
  const int net = (int)add - (int)rem;
  if (th == RSENT) {
    ucnt += net;
    if (ucnt < s) return RSENT;
    int best = -1;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (suf[k] != RSENT) best = max(best, suf[k]);
      if (pre[k] != RSENT) best = max(best, pre[k]);
    }
    return __reduce_max_sync(FULL_MASK, best);
  }
  if (net == 1 || (net == 0 && rem && x == th)) {
    int best = -1;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (suf[k] < th) best = max(best, suf[k]);
      if (pre[k] < th) best = max(best, pre[k]);
    }
    return __reduce_max_sync(FULL_MASK, best);
  }
  if (net == -1) {
    int best = RSENT;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (suf[k] > th) best = min(best, suf[k]);
      if (pre[k] > th) best = min(best, pre[k]);
    }
    best = __reduce_min_sync(FULL_MASK, best);
    if (best == RSENT) ucnt = s - 1;  // the union fell below s ranks
    return best;
  }
  return th;
}

// Checkpoints and sets in global scratch are stored slot k*32 + lane, so
// that a warp's loads and stores of one k are contiguous.
template <int E>
__device__ __forceinline__ void store_set(int* dst, const int (&st)[E],
                                          int lane) {
#pragma unroll
  for (int k = 0; k < E; ++k) dst[k * 32 + lane] = st[k];
}

template <int E>
__device__ __forceinline__ void load_set(int (&st)[E], const int* src,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < E; ++k) st[k] = __ldg(src + k * 32 + lane);
}

// ---- kernel A: checkpoints of S and P every K offsets, eviction log ------

constexpr int GROUP = 4;  // chunks of 32 offsets loaded ahead of their use

// One walk of kernel A over a row's offsets, in groups of GROUP chunks
// with the next group's loads in flight. The suffix walk (SUFFIX) goes
// backward over cur, takes a chunk's candidates (v < slot s-1) from its
// highest lane down, logs ev and stores the set after the chunk; the
// prefix walk goes forward over nxt, lowest lane first, and stores the
// set before the chunk. ck gets the set at offset m*K in slot m.
template <int E, bool SUFFIX>
__device__ __forceinline__ void walk_row(const int* __restrict__ src,
                                         int* __restrict__ ck,
                                         int* __restrict__ evrow, int s_b,
                                         int s, int K, int lane) {
  constexpr int SP = 32 * E;
  const int n_chunk = (s_b + 31) / 32;
  const int n_grp = (n_chunk + GROUP - 1) / GROUP;
  int st[E];
#pragma unroll
  for (int k = 0; k < E; ++k) st[k] = RSENT;
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
        store_set<E>(ck + (ci * 32 / K) * SP, st, lane);
      int e = -1;
      unsigned cand = __ballot_sync(FULL_MASK, v < last);
      // candidates in walk order; one that fell to or above slot s-1
      // since the ballot is skipped with a compare
      int lsrc = SUFFIX ? 31 - __clz(cand) : __ffs(cand) - 1;
      int x = __shfl_sync(FULL_MASK, v, lsrc & 31);
      while (cand) {
        cand &= ~(1u << lsrc);
        const int nsrc = SUFFIX ? 31 - __clz(cand) : __ffs(cand) - 1;
        const int xn = __shfl_sync(FULL_MASK, v, nsrc & 31);
        const int old = last;
        if (x < last && set_insert<E>(st, x, s, lane, last) && lane == lsrc)
          e = old;
        lsrc = nsrc;
        x = xn;
      }
      if (SUFFIX) {
        const int j = ci * 32 + lane;
        if (j < s_b) evrow[j] = e;
        if ((ci * 32) % K == 0)
          store_set<E>(ck + (ci * 32 / K) * SP, st, lane);
      }
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) buf[q] = nbuf[q];
  }
}

template <int E>
__global__ void __launch_bounds__(32 * WARPS_A)
theta_ckpt_kernel(const int* __restrict__ cur, const int* __restrict__ nxt,
                  int* __restrict__ ck_s, int* __restrict__ ck_p,
                  int* __restrict__ ev, int C, int s_b, int s, int K,
                  int n_seg) {
  constexpr int SP = 32 * E;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS_A + (threadIdx.x >> 5);
  if (w >= 2 * C) return;  // warp-uniform
  const int row = w >> 1;
  const size_t rb = (size_t)row * s_b;
  const size_t cb = (size_t)row * n_seg * SP;
  if ((w & 1) == 0)
    walk_row<E, true>(cur + rb, ck_s + cb, ev + rb, s_b, s, K, lane);
  else
    walk_row<E, false>(nxt + rb, ck_p + cb, nullptr, s_b, s, K, lane);
}

// ---- kernel B: one chain per (row, segment) ------------------------------
template <int E>
__global__ void __launch_bounds__(32 * WARPS_B, min_blocks_b(E))
theta_chain_kernel(const int* __restrict__ cur, const int* __restrict__ nxt,
                   const int* __restrict__ ck_s, const int* __restrict__ ck_p,
                   const int* __restrict__ ev, int* __restrict__ out, int C,
                   int s_b, int s, int K, int n_seg) {
  constexpr int SP = 32 * E;
  constexpr int N = mirror_len(E);
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int chain = blockIdx.x * WARPS_B + wib;
  if (chain >= C * n_seg) return;  // warp-uniform
  int* suf_sh = smem + wib * 2 * N;  // mirrors for the merge's searches
  int* pre_sh = suf_sh + N;
  for (int i = SP + lane; i < N; i += 32) {
    suf_sh[i] = RSENT;
    pre_sh[i] = RSENT;
  }
  const int row = chain / n_seg;
  const int m = chain - row * n_seg;
  const size_t rb = (size_t)row * s_b;
  int suf[E], pre[E];
  load_set<E>(suf, ck_s + (size_t)chain * SP, lane);
  load_set<E>(pre, ck_p + (size_t)chain * SP, lane);
  int plast = set_slot<E>(pre, s - 1);
  int th = RSENT, ucnt = 0;
  bool stale = true, s_dirty = true, p_dirty = true;
  const int j1 = min(m * K + K, s_b);
  for (int cb = m * K; cb < j1; cb += 32) {
    const int j = cb + lane;
    const bool in = j < j1;
    const int cv = in ? __ldg(cur + rb + j) : RSENT;
    const int nv = in ? __ldg(nxt + rb + j) : RSENT;
    const int evv = in ? __ldg(ev + rb + j) : -1;
    // only the offsets where a set may change are visited: an S change
    // (ev != -1) or a P insert candidate (nxt < slot s-1, which only
    // falls); the offsets between two visits share one theta
    unsigned events =
        __ballot_sync(FULL_MASK, in && (evv != -1 || nv < plast));
    const int n = min(32, j1 - cb);
    int mine = RSENT, done = 0;  // offsets cb .. cb+done-1 have their theta
    for (;;) {
      const int t = events ? __ffs(events) - 1 : n;
      const int upto = events ? t + 1 : n;
      if (upto > done) {
        if (stale) {
          if (s_dirty) {
#pragma unroll
            for (int k = 0; k < E; ++k) suf_sh[lane * E + k] = suf[k];
          }
          if (p_dirty) {
#pragma unroll
            for (int k = 0; k < E; ++k) pre_sh[lane * E + k] = pre[k];
          }
          __syncwarp();
          th = merge_theta<E>(suf, suf_sh, pre, pre_sh, s, lane, ucnt);
          __syncwarp();
          stale = s_dirty = p_dirty = false;
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
      if (s_chg) {
        set_remove_append<E>(suf, x, e, s, lane);
        s_dirty = true;
      }
      bool p_chg = false;
      const int p_out = plast;  // what an insert pushes out of slot s-1
      if (v < plast && set_insert<E>(pre, v, s, lane, plast))
        p_chg = p_dirty = true;
      const bool s_low = s_chg && x <= th;
      const bool p_low = p_chg && v <= th;
      if (s_low || p_low) {
        if (th != RSENT && p_chg && p_out == th)
          stale = true;  // merge in full at the next offset
        else
          th = step_theta<E>(th, ucnt, suf, pre, x, s_low, v, p_low, s_chg,
                             s);
      }
    }
    if (in) out[rb + j] = mine;
  }
}

// ---- host side -----------------------------------------------------------

static size_t smem_b(int E) {
  return sizeof(int) * 2 * (size_t)mirror_len(E) * WARPS_B;
}

template <int E>
static cudaError_t launch(const int* cur, const int* nxt, int* out,
                          int* scratch, int C, int s_b, int s, int K,
                          cudaStream_t stream) {
  const int n_seg = (s_b + K - 1) / K;
  int* ck_s = scratch;
  int* ck_p = ck_s + (size_t)C * n_seg * 32 * E;
  int* ev = ck_p + (size_t)C * n_seg * 32 * E;
  const int grid_a = (2 * C + WARPS_A - 1) / WARPS_A;
  theta_ckpt_kernel<E><<<grid_a, 32 * WARPS_A, 0, stream>>>(
      cur, nxt, ck_s, ck_p, ev, C, s_b, s, K, n_seg);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long chains = (long)C * n_seg;
  const int grid_b = (int)((chains + WARPS_B - 1) / WARPS_B);
  theta_chain_kernel<E><<<grid_b, 32 * WARPS_B, smem_b(E), stream>>>(
      cur, nxt, ck_s, ck_p, ev, out, C, s_b, s, K, n_seg);
  return cudaGetLastError();
}

template <int E>
static cudaError_t occupancy(int* warps_a, int* warps_b) {
  int na = 0, nb = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &na, theta_ckpt_kernel<E>, 32 * WARPS_A, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, theta_chain_kernel<E>, 32 * WARPS_B, smem_b(E));
  *warps_a = na * WARPS_A;
  *warps_b = nb * WARPS_B;
  return err;
}

// one template instance per E = ceil(s/32) in 1..16 (s <= 512)
#define THETA_FOR_E(E, F, ...)                  \
  switch (E) {                                  \
    case 1: return (int)F<1>(__VA_ARGS__);      \
    case 2: return (int)F<2>(__VA_ARGS__);      \
    case 3: return (int)F<3>(__VA_ARGS__);      \
    case 4: return (int)F<4>(__VA_ARGS__);      \
    case 5: return (int)F<5>(__VA_ARGS__);      \
    case 6: return (int)F<6>(__VA_ARGS__);      \
    case 7: return (int)F<7>(__VA_ARGS__);      \
    case 8: return (int)F<8>(__VA_ARGS__);      \
    case 9: return (int)F<9>(__VA_ARGS__);      \
    case 10: return (int)F<10>(__VA_ARGS__);    \
    case 11: return (int)F<11>(__VA_ARGS__);    \
    case 12: return (int)F<12>(__VA_ARGS__);    \
    case 13: return (int)F<13>(__VA_ARGS__);    \
    case 14: return (int)F<14>(__VA_ARGS__);    \
    case 15: return (int)F<15>(__VA_ARGS__);    \
    case 16: return (int)F<16>(__VA_ARGS__);    \
    default: return (int)cudaErrorInvalidValue; \
  }

// Launch both kernels on `stream`. scratch holds 2*C*n_seg*SP + C*s_b
// ints: the S checkpoints, the P checkpoints, the eviction log. K is a
// multiple of 32.
extern "C" int theta_chunk_launch(const void* cur, const void* nxt, void* out,
                                  void* scratch, int C, int s_b, int s, int K,
                                  void* stream) {
  if (C <= 0 || s_b <= 0) return 0;
  if (K <= 0 || K % 32 != 0) return (int)cudaErrorInvalidValue;
  THETA_FOR_E((s + 31) / 32, launch, static_cast<const int*>(cur),
              static_cast<const int*>(nxt), static_cast<int*>(out),
              static_cast<int*>(scratch), C, s_b, s, K,
              static_cast<cudaStream_t>(stream))
}

// Resident warps per SM of each kernel at sketch size s, as the
// occupancy calculator gives them for this build.
extern "C" int theta_occupancy(int s, int* warps_a, int* warps_b) {
  THETA_FOR_E((s + 31) / 32, occupancy, warps_a, warps_b)
}
