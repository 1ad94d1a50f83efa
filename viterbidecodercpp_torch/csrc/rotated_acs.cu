// Rotated in-place add-compare-select for 64 <= S <= 4096 states (Hopper).
//
// Replaces the JAX package's TPU kernel ops/rotated_pallas.py
// (_make_kernel, launched by _acs_rotated_padded) and computes exactly
// what it computes: logical state s lives at slot rotr_n(s, t) after t
// steps (n = K-1), so at phase phi = t mod n slot p pairs with slot
// p ^ 2^j, j = n-1-phi, and the butterfly writes in place.  Each slot
// takes two candidates (self + bm, partner + (max_error - bm)), clamps
// (saturating) or masks (wrapping), and applies the regime's tie rule;
// slots with bit j set take the c_hi branch.  Renormalisation is gated on
// slot 0 (state 0 at every phase) and subtracts the frame minimum.  Slot
// decision bits are packed 32 per word, slot p at bit p%32 of word p>>5.
//
// What bounds it on the H100: the trellis is a sequential recurrence, so
// each frame is a chain of T dependent steps, and the time is one step's
// latency times T, spread over as many frames as the SMs hold at once.
// Operations (about 10 int32 per state per step at R = 2) and bytes (the
// metric carry never leaves the SM) are far below the card's rates; the
// step latency is what there is to cut.  A block per frame with shared
// metrics (the first design, kept below for S >= 2048) paid per step a
// global symbol load, a branch metric rebuilt per slot, shared-memory
// reads, two minimum reductions and a __syncthreads(), ~1,800 cycles.
//
// Design (S <= 1024 and R <= 5, every registry code of the class): one
// warp per frame, no shared memory for metrics and no barrier.
//   * Lane l holds the S/32 slots l + 32k in registers.  The partner
//     p ^ dist is a register of the same lane (k ^ dist/32) for dist >= 32
//     and one __shfl_xor_sync for dist < 32.
//   * The kernel is a template on n and the time loop runs in groups of n
//     unrolled steps, so dist, each slot's parity and register index are
//     constants; the only branch inside a group is the renorm gate.
//   * A step has at most 2^R <= 32 distinct branch metrics.  Symbols are
//     staged per warp in tiles of up to 32 steps (the next tile loaded
//     into registers while the current one is used), and per tile lane j
//     tabulates pattern j's metric for every step, with the exact
//     abs-diff, so out-of-range symbols stay exact.  The pattern of slot
//     l + 32k at phase phi is the xor of a per-lane and a per-register part
//     (the tap parities are linear), both tabulated by the wrapper; a step
//     costs one shared load and one __shfl_sync per register, issued a
//     step ahead of the selects that use them.
//   * Renorm: slot 0's new metric is tested with one warp vote; only then
//     is the frame minimum taken (__reduce_min_sync) and subtracted.
//   * Decision word k is the __ballot_sync of register k; lane k stores it.
// S = 2048 and 4096 would need 64 and 128 metric registers per lane, and
// R > 5 has more patterns than lanes, so those keep the block design (one
// thread per slot, metrics double-buffered in shared memory, one barrier
// a step); the wrapper picks the design.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define VDT_MAX_R 16
#define VDT_WARP_MAX_N 10        // warp design up to S = 1024
#define VDT_WARP_MAX_R 5         // and R <= 5: 32 branch patterns a step
#define VDT_FRAMES_PER_BLOCK 2   // warps (frames) per block, warp design

struct AcsParams {
  int B, T, n, R;
  int high, low, max_error, cap, thr, saturating;
  int gmask[VDT_MAX_R];  // polynomial taps 1..K-1 (bit 0 never matters)
};

struct WarpParams {
  int B, T, R;
  int high, low, max_error, cap, thr;
  // branch pattern of slot l + 32k at phase phi: apat[phi][l] ^ cpat[phi][k]
  // (bit r set: rate r expects the high level)
  int apat[VDT_WARP_MAX_N][32];
  int cpat[VDT_WARP_MAX_N][32];
};

// rotl within n bits; k in [0, n), x < 2^n
__device__ __forceinline__ int rotl_n(int x, int k, int n, int mask) {
  return ((x << k) | (x >> (n - k))) & mask;
}

// Load this lane's share of the symbol tile of TS steps that starts at
// step t0 (nothing past T): TS x R ints, lane l holding ints l + 32i.
template <int TS>
__device__ __forceinline__ void fetch_tile(int (&pre)[VDT_WARP_MAX_R],
                                           const int* __restrict__ sym_b,
                                           int t0, int T, int R, int lane) {
  const int cnt = min(TS, T - t0) * R;
  const int* src = sym_b + (size_t)t0 * R;
#pragma unroll
  for (int i = 0; i < VDT_WARP_MAX_R; ++i) {
    const int idx = lane + 32 * i;
    if (i < R && idx < cnt) pre[i] = __ldg(src + idx);
  }
}

// Lane j's entry of the branch-metric table of a symbol tile, for R
// rates known at compile time: vt[s * 32 + j] is the metric of pattern j at
// step s, sum_r |(bit r of j ? high : low) - sym[s][r]| (exact for any
// symbols).
template <int TS, int R>
__device__ __forceinline__ void build_table(const int* __restrict__ tile,
                                            int* __restrict__ vt,
                                            const WarpParams& p, int lane) {
  int e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) e[r] = ((lane >> r) & 1) ? p.high : p.low;
#pragma unroll 8
  for (int s = 0; s < TS; ++s) {
    int acc = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) acc += abs(e[r] - tile[s * R + r]);
    vt[s * 32 + lane] = acc;
  }
}

// Stage a symbol tile (this lane's share in `pre`) and build its table of
// branch metrics.  Runs once per tile, off the per-step chain.
template <int TS>
__device__ __forceinline__ void stage_tile(const int (&pre)[VDT_WARP_MAX_R],
                                           int* __restrict__ tile,
                                           int* __restrict__ vt,
                                           const WarpParams& p, int lane) {
  const int R = p.R;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < VDT_WARP_MAX_R; ++i)
    if (i < R) tile[lane + 32 * i] = pre[i];
  __syncwarp();
  switch (R) {
    case 1: build_table<TS, 1>(tile, vt, p, lane); break;
    case 2: build_table<TS, 2>(tile, vt, p, lane); break;
    case 3: build_table<TS, 3>(tile, vt, p, lane); break;
    case 4: build_table<TS, 4>(tile, vt, p, lane); break;
    default: build_table<TS, 5>(tile, vt, p, lane); break;
  }
  __syncwarp();
}

// Branch metrics of one step at phase PHI for each of the lane's
// registers: register k takes the table entry of its pattern by a shuffle
// (v: this lane's entry of the step's table).
template <int N, int PHI>
__device__ __forceinline__ void branch_metrics(int (&bm)[(1 << N) / 32],
                                               const int apat, const int v,
                                               const WarpParams& p) {
#pragma unroll
  for (int k = 0; k < (1 << N) / 32; ++k)
    bm[k] = __shfl_sync(0xffffffffu, v, apat ^ p.cpat[PHI][k]);
}

// The add-compare-select of one step at compile-time phase PHI: new
// metrics, decision words (word k stored by lane k at pk_t[k * B]) and the
// renorm gated on slot 0 (lane 0, register 0).
template <int N, bool SAT, int PHI>
__device__ __forceinline__ void acs_step(int (&m)[(1 << N) / 32],
                                         const int (&bm)[(1 << N) / 32],
                                         unsigned& acc,
                                         int* __restrict__ pk_t,
                                         const WarpParams& p, int lane) {
  constexpr int NR = (1 << N) / 32;
  constexpr int dist = 1 << (N - 1 - PHI);
  constexpr unsigned FULL = 0xffffffffu;
  int nm[NR];
  unsigned myword = 0;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    int part;
    bool odd;  // odd state lands on the hi slot
    if constexpr (dist >= 32) {
      part = m[k ^ (dist >> 5)];
      odd = (k & (dist >> 5)) != 0;
    } else {
      part = __shfl_xor_sync(FULL, m[k], dist);
      odd = (lane & dist) != 0;
    }
    int e_self = m[k] + bm[k];
    int e_part = part + (p.max_error - bm[k]);
    bool c_lo, c_hi;
    if constexpr (SAT) {
      e_self = min(e_self, p.cap);
      e_part = min(e_part, p.cap);
      c_lo = e_part <= e_self;  // SIMD tie -> predecessor 1
      c_hi = e_part >= e_self;
    } else {
      e_self &= p.cap;
      e_part &= p.cap;
      c_lo = e_self > e_part;   // scalar tie -> predecessor 0
      c_hi = e_self < e_part;
    }
    nm[k] = odd ? (c_hi ? e_self : e_part) : (c_lo ? e_part : e_self);
    const unsigned word = __ballot_sync(FULL, odd ? c_hi : c_lo);
    if (lane == k) myword = word;
  }
  if (lane < NR) *pk_t = (int)myword;
  if (__any_sync(FULL, lane == 0 && nm[0] >= p.thr)) {
    int mn = nm[0];
#pragma unroll
    for (int k = 1; k < NR; ++k) mn = min(mn, nm[k]);
    mn = __reduce_min_sync(FULL, mn);
#pragma unroll
    for (int k = 0; k < NR; ++k) nm[k] -= mn;
    acc += (unsigned)mn;
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) m[k] = nm[k];
}

// Steps PHI .. N-1 of a group of N steps (GUARD: only the first nsteps).
// The next step's branch metrics are computed before this step's selects,
// in the same straight-line code, so the compiler overlaps them.
template <int N, bool SAT, bool GUARD, int PHI>
__device__ __forceinline__ void acs_group(int (&m)[(1 << N) / 32],
                                          int (&bm)[(1 << N) / 32],
                                          const int (&apat)[N],
                                          const int* __restrict__ vt,
                                          int* __restrict__ pk,
                                          size_t pk_step, unsigned& acc,
                                          const WarpParams& p, int lane,
                                          int nsteps) {
  if constexpr (PHI < N) {
    if (GUARD && PHI >= nsteps) return;
    int bmn[(1 << N) / 32];
    if constexpr (PHI + 1 < N)
      branch_metrics<N, PHI + 1>(bmn, apat[PHI + 1], vt[(PHI + 1) * 32], p);
    acs_step<N, SAT, PHI>(m, bm, acc, pk, p, lane);
    if constexpr (PHI + 1 < N) {
#pragma unroll
      for (int k = 0; k < (1 << N) / 32; ++k) bm[k] = bmn[k];
      acs_group<N, SAT, GUARD, PHI + 1>(m, bm, apat, vt, pk + pk_step,
                                        pk_step, acc, p, lane, nsteps);
    }
  }
}

template <int N, bool SAT>
__global__ void __launch_bounds__(32 * VDT_FRAMES_PER_BLOCK)
    rotated_acs_warp(const int* __restrict__ m_in,
                     const int* __restrict__ sym, int* __restrict__ m_out,
                     int* __restrict__ packed, int* __restrict__ acc_out,
                     const WarpParams p) {
  constexpr int S = 1 << N;
  constexpr int NR = S / 32;
  constexpr int G = 32 / N;  // groups of N steps per symbol tile
  constexpr int TS = G * N;  // steps per tile, <= 32
  __shared__ int tiles[VDT_FRAMES_PER_BLOCK][32 * VDT_WARP_MAX_R];
  __shared__ int tables[VDT_FRAMES_PER_BLOCK][32 * 32];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * VDT_FRAMES_PER_BLOCK + wib;
  if (b >= p.B) return;  // the whole warp: nothing waits on it
  const int B = p.B, T = p.T, R = p.R;
  int* tile = tiles[wib];
  int* vt = tables[wib];

  int m[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k)
    m[k] = m_in[(size_t)(lane + 32 * k) * B + b];  // phase 0: slot == state
  int apat[N];
#pragma unroll
  for (int phi = 0; phi < N; ++phi) apat[phi] = p.apat[phi][lane];
  const int* sym_b = sym + (size_t)b * T * R;
  int pre[VDT_WARP_MAX_R];
  fetch_tile<TS>(pre, sym_b, 0, T, R, lane);
  // lane k < NR stores decision word k of step t at pk + t * pk_step
  int* pk = packed + (size_t)min(lane, NR - 1) * B + b;
  const size_t pk_step = (size_t)NR * B;
  unsigned acc = 0;
  int gi = 0;  // group within the current tile
  for (int t0 = 0; t0 < T; t0 += N) {
    if (gi == 0) {
      stage_tile<TS>(pre, tile, vt, p, lane);
      fetch_tile<TS>(pre, sym_b, t0 + TS, T, R, lane);
    }
    const int* vt_g = vt + gi * N * 32 + lane;
    int* pk_t = pk + (size_t)t0 * pk_step;
    int bm[NR];
    branch_metrics<N, 0>(bm, apat[0], vt_g[0], p);
    if (t0 + N <= T)
      acs_group<N, SAT, false, 0>(m, bm, apat, vt_g, pk_t, pk_step, acc, p,
                                  lane, N);
    else
      acs_group<N, SAT, true, 0>(m, bm, apat, vt_g, pk_t, pk_step, acc, p,
                                 lane, T - t0);
    gi = gi + 1 == G ? 0 : gi + 1;
  }
  // back to state order: slot q holds logical state rotl_n(q, T mod n)
  const int rot = T % N;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int slot = lane + 32 * k;
    m_out[(size_t)rotl_n(slot, rot, N, S - 1) * B + b] = m[k];
  }
  if (lane == 0) acc_out[b] = (int)acc;
}

// The block design (S >= 2048): one thread block per frame, one thread
// per slot (S/1024 slots per thread above S = 1024), metrics
// double-buffered in shared memory (2 x 16 KB at S = 4096), one
// __syncthreads() a step, the renorm applied lazily from per-warp minima,
// branch values rebuilt from the taps with __popc.
template <int SPT>
__global__ void rotated_acs_kernel(const int* __restrict__ m_in,
                                   const int* __restrict__ sym,
                                   int* __restrict__ m_out,
                                   int* __restrict__ packed,
                                   int* __restrict__ acc_out,
                                   const AcsParams p) {
  extern __shared__ int smem[];  // 2 x S metrics
  __shared__ int red[2][32];     // per-warp minima, double-buffered
  const int nthr = blockDim.x;
  const int S = nthr * SPT;
  const int W = S >> 5;
  const int smask = S - 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int n = p.n;
  const int B = p.B;

  int* cur = smem;
  int* nxt = smem + S;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = tid + k * nthr;
    cur[s] = m_in[(size_t)s * B + b];  // phase 0: slot order == state order
  }
  __syncthreads();

  const int* sym_b = sym + (size_t)b * p.T * p.R;
  unsigned acc = 0;
  int sub = 0;
  int phi = 0;
  for (int t = 0; t < p.T; ++t) {
    if (t > 0) {
      // renorm of step t-1: gate on slot 0, subtract the frame minimum
      const int v = lane < nwarps ? red[(t - 1) & 1][lane] : INT_MAX;
      const int mn = __reduce_min_sync(0xffffffffu, v);
      sub = cur[0] >= p.thr ? mn : 0;
      acc += (unsigned)sub;
    }
    const int dist = 1 << (n - 1 - phi);
    int h[SPT], bm[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      h[k] = rotl_n((tid + k * nthr) & ~dist, phi, n, smask);
      bm[k] = 0;
    }
    const int* sym_t = sym_b + (size_t)t * p.R;
#pragma unroll
    for (int r = 0; r < VDT_MAX_R; ++r) {
      if (r < p.R) {
        const int sv = __ldg(sym_t + r);
        const int g = p.gmask[r];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const int e = (__popc((h[k] << 1) & g) & 1) ? p.high : p.low;
          bm[k] += abs(e - sv);
        }
      }
    }
    int local_min = INT_MAX;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int slot = tid + k * nthr;
      int e_self = cur[slot] - sub + bm[k];
      int e_part = cur[slot ^ dist] - sub + (p.max_error - bm[k]);
      bool c_lo, c_hi;
      if (p.saturating) {
        e_self = min(e_self, p.cap);
        e_part = min(e_part, p.cap);
        const int diff = e_part - e_self;
        c_lo = diff <= 0;  // SIMD tie -> predecessor 1
        c_hi = diff >= 0;
      } else {
        e_self &= p.cap;
        e_part &= p.cap;
        const int diff = e_self - e_part;
        c_lo = diff > 0;   // scalar tie -> predecessor 0
        c_hi = diff < 0;
      }
      const bool odd = (slot & dist) != 0;  // odd state lands on the hi slot
      const int nm = odd ? (c_hi ? e_self : e_part) : (c_lo ? e_part : e_self);
      nxt[slot] = nm;
      local_min = min(local_min, nm);
      const unsigned word = __ballot_sync(0xffffffffu, odd ? c_hi : c_lo);
      if (lane == 0) packed[((size_t)t * W + (slot >> 5)) * B + b] = (int)word;
    }
    const int wmin = __reduce_min_sync(0xffffffffu, local_min);
    if (lane == 0) red[t & 1][warp] = wmin;
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    phi = phi + 1 == n ? 0 : phi + 1;
  }
  if (p.T > 0) {
    const int v = lane < nwarps ? red[(p.T - 1) & 1][lane] : INT_MAX;
    const int mn = __reduce_min_sync(0xffffffffu, v);
    sub = cur[0] >= p.thr ? mn : 0;
    acc += (unsigned)sub;
  }
  // back to state order: slot q holds logical state rotl_n(q, T mod n)
  const int rot = p.T % n;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int slot = tid + k * nthr;
    m_out[(size_t)rotl_n(slot, rot, n, smask) * B + b] = cur[slot] - sub;
  }
  if (tid == 0) acc_out[b] = (int)acc;
}

extern "C" int vdt_rotated_acs(const void* m_in, const void* sym, void* m_out,
                               void* packed, void* acc, int B, int T, int K,
                               int R, const void* gmask, const void* apat,
                               const void* cpat, int high, int low,
                               int max_error, int cap, int thr, int saturating,
                               void* stream) {
  // apat/cpat given: the warp design (the wrapper's choice, n <= 10 and
  // R <= 5);
  // null: the block design, which computes branch values from gmask.
  const int n = K - 1;
  const int S = 1 << n;
  if (S < 64 || S > 4096 || R < 1 || R > VDT_MAX_R || B < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* mi = static_cast<const int*>(m_in);
  const int* sy = static_cast<const int*>(sym);
  int* mo = static_cast<int*>(m_out);
  int* pk = static_cast<int*>(packed);
  int* ac = static_cast<int*>(acc);
  if (apat != nullptr) {
    if (n > VDT_WARP_MAX_N || R > VDT_WARP_MAX_R || cpat == nullptr)
      return (int)cudaErrorInvalidValue;
    WarpParams w;
    w.B = B;
    w.T = T;
    w.R = R;
    w.high = high;
    w.low = low;
    w.max_error = max_error;
    w.cap = cap;
    w.thr = thr;
    const int* ap = static_cast<const int*>(apat);  // (n, 32)
    const int* cp = static_cast<const int*>(cpat);  // (n, S / 32)
    const int nr = S / 32;
    for (int phi = 0; phi < VDT_WARP_MAX_N; ++phi)
      for (int i = 0; i < 32; ++i) {
        w.apat[phi][i] = phi < n ? ap[phi * 32 + i] : 0;
        w.cpat[phi][i] = phi < n && i < nr ? cp[phi * nr + i] : 0;
      }
    const int blocks = (B + VDT_FRAMES_PER_BLOCK - 1) / VDT_FRAMES_PER_BLOCK;
    const int threads = 32 * VDT_FRAMES_PER_BLOCK;
#define VDT_WARP_LAUNCH(NN)                                              \
  if (saturating)                                                        \
    rotated_acs_warp<NN, true><<<blocks, threads, 0, st>>>(mi, sy, mo, pk, \
                                                           ac, w);        \
  else                                                                   \
    rotated_acs_warp<NN, false><<<blocks, threads, 0, st>>>(mi, sy, mo,   \
                                                            pk, ac, w)
    switch (n) {
      case 6: VDT_WARP_LAUNCH(6); break;
      case 7: VDT_WARP_LAUNCH(7); break;
      case 8: VDT_WARP_LAUNCH(8); break;
      case 9: VDT_WARP_LAUNCH(9); break;
      default: VDT_WARP_LAUNCH(10); break;
    }
#undef VDT_WARP_LAUNCH
    return (int)cudaGetLastError();
  }
  AcsParams p;
  p.B = B;
  p.T = T;
  p.n = n;
  p.R = R;
  p.high = high;
  p.low = low;
  p.max_error = max_error;
  p.cap = cap;
  p.thr = thr;
  p.saturating = saturating;
  const int* g = static_cast<const int*>(gmask);
  for (int r = 0; r < VDT_MAX_R; ++r) p.gmask[r] = r < R ? g[r] : 0;
  const int spt = S > 1024 ? S / 1024 : 1;
  const int nthr = S / spt;
  const size_t shmem = 2 * (size_t)S * sizeof(int);
  switch (spt) {
    case 1:
      rotated_acs_kernel<1><<<B, nthr, shmem, st>>>(mi, sy, mo, pk, ac, p);
      break;
    case 2:
      rotated_acs_kernel<2><<<B, nthr, shmem, st>>>(mi, sy, mo, pk, ac, p);
      break;
    default:
      rotated_acs_kernel<4><<<B, nthr, shmem, st>>>(mi, sy, mo, pk, ac, p);
      break;
  }
  return (int)cudaGetLastError();
}
