// Lane-resident state-order add-compare-select for S <= 32 states (Hopper).
//
// Replaces the JAX package's TPU kernel ops/acs_pallas.py
// (_make_kernel, launched by _acs_pallas_padded; wrapped by acs_pallas) for
// the codes the port routes to it, K = 2..6, and computes what it computes
// with the abs-diff branch metric of jax_core.acs_scan.  At each step the
// new state s = 2h + b (H = S/2) takes the better of predecessors h and
// h + H:
//   even (b = 0): e00 = m[h] + bm(h),  e10 = m[h + H] + ibm(h)
//   odd  (b = 1): e01 = m[h] + ibm(h), e11 = m[h + H] + bm(h)
// with bm(h) = sum_r |bt[r][h] - sym[r]| and ibm = max_error - bm.  The
// candidates clamp to metric_max (saturating; ties go to predecessor 1) or
// are masked with it (wrapping; ties go to predecessor 0).  Renormalisation
// is gated on the new state-0 metric >= threshold and subtracts the frame
// minimum into acc.  State s's decision is bit s of the step's one word
// (W = 1): the ViterbiDecisionBits layout, bits >= S zero.
//
// What bounds it on the H100: a frame is a chain of T dependent steps over
// a state vector of 2..32 ints, and at the lane path's batch (B = 512,
// S = 16: 256 warps on 132 SMs) each warp has a scheduler to itself.  So
// the time is T x one step, and a step costs its dependent chain plus the
// issue stalls the chain leaves unfilled.  Bytes (R symbols in, one word
// out per frame per step) and operations are far below the card's rates,
// and a recurrence at this batch cannot reach them: the operations bound
// at B = 512, T = 2052 is ~8.5 us, while 2052 dependent steps of even 40 ns
// take 82 us.  The first design's step
// (~450 ns) waited on a global symbol load issued one step ahead, took the
// frame minimum on every step (log2 S dependent shuffles), stored a word
// every step and ran a 16-rate loop and the regime as run-time branches.
//
// Design: one lane per state, S lanes per frame, 32 / S frames per warp,
// two warps a block; no barrier.
//   * The kernel is a template on n = K - 1 and on the regime, so the step
//     has no run-time rate loop and no regime branch.  Its chain is the two
//     predecessor shuffles, two add-and-clamps (VIADDMNMX) and a minimum.
//   * Symbols are staged per warp in tiles of up to 32 steps, read
//     straight from the caller's (B, T, R) layout (a frame's tile is
//     contiguous); the next tile is loaded into registers while the steps
//     of the current one run.
//   * Branch metrics are made per tile, off the chain, into a shared table
//     read a step ahead: where 2^R <= S, each frame's 2^R pattern metrics
//     (a lane makes one entry per S / 2^R steps; R a compile-time case up
//     to 5), else every lane its own state's metric (R > 5 with a run-time
//     rate loop, exact for every R <= 16).  Both are the exact abs-diff,
//     so symbols outside the soft range stay exact.
//   * Renorm: one warp vote on "my frame's state 0 >= threshold"; only
//     when it fires is the segment minimum taken and subtracted in the
//     frames whose own gate fired.  The next step's predecessor shuffles
//     are issued before the vote and corrected after it.
//   * Steps run in groups of S: lane s keeps step s's __ballot_sync (every
//     frame's decision word) and stores its frame's word once a group, one
//     store a lane per S steps instead of one a step.  Frames past B in a
//     live warp run every shuffle and ballot and skip loads and stores.
// Measured by tools/torch_kernel_ab.py --path lane on an NVIDIA H100 80GB
// HBM3 at 700 W, against the first design in the same process (the run of
// this source that PERF.md section 5 reports): Basic K=5 SOFT16 B=512
// T=2052 in 0.2066-0.2115 ms against 0.8811-0.8978 ms; 168 SM cycles a step
// (clock64, 1.98 GHz), 141 with the renorm vote taken out.  What binds it
// now is latency and stalls, not issue: the step is 14 instructions but
// 168 cycles.  The predicate results (vote, decision compare) stall issue
// ~13 cycles each, which a warp alone on its scheduler leaves unfilled, and
// the vote's branch splits the step, so the step's shared load sinks below
// it onto the chain (SASS).  A thread per frame with all 16 metrics in
// registers took 458-554 cycles a step.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define VDT_MAX_R 16         // rates the kernel takes
#define VDT_WARPS 2          // warps a block
#define VDT_TILE_INTS 512    // symbol ints a warp stages a tile
#define VDT_PRE (VDT_TILE_INTS / 32)  // of which a lane prefetches
#define VDT_MAX_TS 32        // steps a tile

struct LaneParams {
  int B, T, R;
  int ts;     // steps a tile: a power of two, (32 / S) ts R <= VDT_TILE_INTS
  int table;  // 1: per frame the 2^R pattern metrics (2^R <= S); 0: a
              // metric per lane
  int high, low, max_error, cap, thr;
  int pat[32];  // branch pattern of state s: bit r set where bt[r][s >> 1]
                // is the high level
};

// Branch metrics of one tile for a compile-time R: this lane's pattern q
// against its frame's staged symbols tf at steps st0, st0 + si, ... < n,
// into vt[lane], vt[lane + 32], ...
template <int R>
__device__ __forceinline__ void build_fixed(const int* __restrict__ tf,
                                            int* __restrict__ vt, int q,
                                            int st0, int si, int n, int high,
                                            int low) {
  int e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) e[r] = ((q >> r) & 1) ? high : low;
  for (int st = st0; st < n; st += si, vt += 32) {
    int a = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) a += abs(e[r] - tf[st * R + r]);
    *vt = a;
  }
}

// The same for any R <= VDT_MAX_R known at run time, one step a row.
__device__ __forceinline__ void build_any(const int* __restrict__ tf,
                                          int* __restrict__ vt, int q, int R,
                                          int n, int high, int low) {
  int e[VDT_MAX_R];
#pragma unroll
  for (int r = 0; r < VDT_MAX_R; ++r) e[r] = ((q >> r) & 1) ? high : low;
  for (int st = 0; st < n; ++st, vt += 32) {
    const int* x = tf + st * R;
    int a = 0;
#pragma unroll
    for (int r = 0; r < VDT_MAX_R; ++r)
      if (r < R) a += abs(e[r] - x[r]);
    *vt = a;
  }
}

// Load this lane's share of the warp's symbol tile at step t0 (cnt_r =
// steps in the tile x R ints per frame): slot[i] = frame << 16 | offset of
// tile int lane + 32 i, or -1 where it is past the tile or its frame past B.
__device__ __forceinline__ void fetch_tile(int (&pre)[VDT_PRE],
                                           const int (&slot)[VDT_PRE],
                                           const int* __restrict__ sym_w,
                                           size_t TR, int t0r, int cnt_r) {
#pragma unroll
  for (int i = 0; i < VDT_PRE; ++i) {
    const int c = slot[i];
    const int j = c & 0xffff;
    if (c >= 0 && j < cnt_r)
      pre[i] = __ldg(sym_w + (size_t)(c >> 16) * TR + t0r + j);
  }
}

// A step's addends for branch metric v: (v, me - v) on an even state,
// (me - v, v) on an odd one (selects, which the compiler does not fold into
// the adds on the chain).
__device__ __forceinline__ void addends(int v, int me, bool odd, int& a0,
                                        int& a1) {
  const int w = me - v;
  a0 = odd ? w : v;
  a1 = odd ? v : w;
}

// The carry of one lane (state) from step to step.
struct LaneCarry {
  int lo, hi;      // the step's predecessor metrics m[h], m[h + H]
  int nm;          // the last step's new metric
  int a0, a1;      // the step's addends
  const int* vp;   // this lane's entry of the step's branch metric
  unsigned acc;    // renorm total (state 0)
};

// One ACS step; returns the warp's ballot of decisions (frame f's word is
// bits [f S, f S + S)).
template <int N, bool SAT>
__device__ __forceinline__ unsigned acs_step(LaneCarry& c, int E, int h,
                                             int seg, bool odd, int me,
                                             int cap, int thr0) {
  constexpr int S = 1 << N;
  constexpr int H = S >> 1;
  constexpr unsigned FULL = 0xffffffffu;
  c.vp += E;
  const int vn = *c.vp;  // the next step's metric (a spare row at the end)
  int c0, c1;
  bool dec;
  if constexpr (SAT) {
    c0 = min(c.lo + c.a0, cap);
    c1 = min(c.hi + c.a1, cap);
    dec = c1 <= c0;  // SIMD tie -> predecessor 1
  } else {
    c0 = (c.lo + c.a0) & cap;
    c1 = (c.hi + c.a1) & cap;
    dec = c1 < c0;   // scalar tie -> predecessor 0
  }
  int nm = min(c0, c1);
  // the next step's predecessors, before the renorm gate resolves
  c.lo = __shfl_sync(FULL, nm, h, S);
  c.hi = __shfl_sync(FULL, nm, h + H, S);
  if (__any_sync(FULL, nm >= thr0)) {
    const unsigned fired = __ballot_sync(FULL, nm >= thr0);
    int mn = nm;
    if constexpr (S == 32) {
      mn = __reduce_min_sync(FULL, mn);
    } else {
#pragma unroll
      for (int off = H; off > 0; off >>= 1)
        mn = min(mn, __shfl_xor_sync(FULL, mn, off, S));
    }
    // lo and hi come from this lane's own frame: the same subtrahend
    const int sub = ((fired >> seg) & 1u) ? mn : 0;
    nm -= sub;
    c.lo -= sub;
    c.hi -= sub;
    c.acc += (unsigned)sub;
  }
  c.nm = nm;
  addends(vn, me, odd, c.a0, c.a1);
  return __ballot_sync(FULL, dec);
}

// 128 registers at most: 16 warps an SM, so B = 4096 frames of S = 16 run
// in one wave
template <int N, bool SAT>
__global__ void __launch_bounds__(32 * VDT_WARPS, 16 / VDT_WARPS)
    lane_acs_kernel(const int* __restrict__ m_in, const int* __restrict__ sym,
                    int* __restrict__ m_out, int* __restrict__ packed,
                    int* __restrict__ acc_out, const LaneParams p) {
  constexpr int S = 1 << N;
  constexpr int H = S >> 1;
  constexpr int F = 32 >> N;  // frames a warp
  constexpr unsigned FULL = 0xffffffffu;
  constexpr unsigned SMASK = S == 32 ? FULL : ((1u << S) - 1u);
  __shared__ int tiles[VDT_WARPS][VDT_TILE_INTS];
  __shared__ int tables[VDT_WARPS][(VDT_MAX_TS + 1) * 32];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b0 = (blockIdx.x * VDT_WARPS + wib) * F;  // the warp's first frame
  const int B = p.B, T = p.T, R = p.R, ts = p.ts;
  if (b0 >= B) return;  // the whole warp: no shuffle waits on it
  const int s = lane & (S - 1);
  const int f = lane >> N;
  const int b = b0 + f;
  const bool live = b < B;
  const int h = s >> 1;
  const bool odd = (s & 1) != 0;
  const int seg = lane & ~(S - 1);  // the frame's first lane in the warp
  int* tile = tiles[wib];
  int* vt = tables[wib];

  // What this lane builds (pattern q of frame fb at steps st0, st0 + si,
  // ...) and where it reads its own metric (vt[col + st * E]).
  const int pat = p.pat[s];
  int q, fb, st0, si, col, E;
  if (p.table) {
    const int le = lane & ((F << R) - 1);
    E = F << R;  // entries a step, a divisor of 32
    q = le & ((1 << R) - 1);
    fb = le >> R;
    st0 = lane >> (5 - N + R);
    si = 1 << (N - R);
    col = (f << R) + pat;
  } else {
    E = 32;
    q = pat;
    fb = f;
    st0 = 0;
    si = 1;
    col = lane;
  }
  const int* tf = tile + fb * ts * R;

  const int per_frame = ts * R;
  const int tile_ints = F * per_frame;
  int slot[VDT_PRE], pre[VDT_PRE];
#pragma unroll
  for (int i = 0; i < VDT_PRE; ++i) {
    const int idx = lane + 32 * i;
    const int ff = idx / per_frame;
    slot[i] = idx < tile_ints && b0 + ff < B
                  ? (ff << 16) | (idx - ff * per_frame) : -1;
    pre[i] = 0;
  }
  const size_t TR = (size_t)T * R;
  const int* sym_w = sym + (size_t)b0 * TR;

  const int me = p.max_error, cap = p.cap;
  const int thr0 = s == 0 ? p.thr : INT_MAX;  // only state 0 votes

  LaneCarry c;
  c.nm = live ? m_in[(size_t)s * B + b] : 0;
  c.lo = __shfl_sync(FULL, c.nm, h, S);
  c.hi = __shfl_sync(FULL, c.nm, h + H, S);
  c.acc = 0;
  fetch_tile(pre, slot, sym_w, TR, 0, min(ts, T) * R);
  for (int t0 = 0; t0 < T; t0 += ts) {
    const int n = min(ts, T - t0);
    __syncwarp();  // the last tile's table is read
#pragma unroll
    for (int i = 0; i < VDT_PRE; ++i)
      if (lane + 32 * i < tile_ints) tile[lane + 32 * i] = pre[i];
    __syncwarp();
    switch (R) {
      case 1: build_fixed<1>(tf, vt + lane, q, st0, si, n, p.high, p.low); break;
      case 2: build_fixed<2>(tf, vt + lane, q, st0, si, n, p.high, p.low); break;
      case 3: build_fixed<3>(tf, vt + lane, q, st0, si, n, p.high, p.low); break;
      case 4: build_fixed<4>(tf, vt + lane, q, st0, si, n, p.high, p.low); break;
      case 5: build_fixed<5>(tf, vt + lane, q, st0, si, n, p.high, p.low); break;
      default: build_any(tf, vt + lane, q, R, n, p.high, p.low); break;
    }
    __syncwarp();
    if (t0 + ts < T)
      fetch_tile(pre, slot, sym_w, TR, (t0 + ts) * R, min(ts, T - t0 - ts) * R);
    c.vp = vt + col;
    addends(*c.vp, me, odd, c.a0, c.a1);
    // groups of S steps (ts is a multiple of S): lane s keeps step s's
    // ballot and stores its frame's word once a group
    for (int g = 0; g < n; g += S) {
      const int cnt = min(S, n - g);
      unsigned mine = 0;
      if (cnt == S) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const unsigned w = acs_step<N, SAT>(c, E, h, seg, odd, me, cap, thr0);
          if (s == k) mine = w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (k < cnt) {
            const unsigned w =
                acs_step<N, SAT>(c, E, h, seg, odd, me, cap, thr0);
            if (s == k) mine = w;
          }
        }
      }
      if (live && s < cnt)
        packed[(size_t)(t0 + g + s) * B + b] = (int)((mine >> seg) & SMASK);
    }
  }
  if (live) {
    m_out[(size_t)s * B + b] = c.nm;
    if (s == 0) acc_out[b] = (int)c.acc;
  }
}

extern "C" int vdt_lane_acs(const void* m_in, const void* sym, void* m_out,
                            void* packed, void* acc, int B, int T, int K,
                            int R, const void* pat, int high, int low,
                            int max_error, int cap, int thr, int saturating,
                            void* stream) {
  // pat: S ints, the branch pattern of each state (ops/lane.py
  // _lane_patterns)
  const int n = K - 1;
  if (n < 1 || n > 5 || R < 1 || R > VDT_MAX_R || B < 1 || T < 0 ||
      pat == nullptr)
    return (int)cudaErrorInvalidValue;
  const int S = 1 << n;
  const int F = 32 >> n;
  LaneParams p;
  p.B = B;
  p.T = T;
  p.R = R;
  p.ts = VDT_MAX_TS;
  while (F * p.ts * R > VDT_TILE_INTS) p.ts >>= 1;
  p.table = (1 << R) <= S;
  p.high = high;
  p.low = low;
  p.max_error = max_error;
  p.cap = cap;
  p.thr = thr;
  const int* pt = static_cast<const int*>(pat);
  for (int i = 0; i < 32; ++i) p.pat[i] = i < S ? pt[i] : 0;
  const int frames = VDT_WARPS * F;  // a block
  const int blocks = (B + frames - 1) / frames;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* mi = static_cast<const int*>(m_in);
  const int* sy = static_cast<const int*>(sym);
  int* mo = static_cast<int*>(m_out);
  int* pk = static_cast<int*>(packed);
  int* ac = static_cast<int*>(acc);
#define VDT_LANE_LAUNCH(NN)                                                \
  if (saturating)                                                          \
    lane_acs_kernel<NN, true><<<blocks, 32 * VDT_WARPS, 0, st>>>(          \
        mi, sy, mo, pk, ac, p);                                            \
  else                                                                     \
    lane_acs_kernel<NN, false><<<blocks, 32 * VDT_WARPS, 0, st>>>(         \
        mi, sy, mo, pk, ac, p)
  switch (n) {
    case 1: VDT_LANE_LAUNCH(1); break;
    case 2: VDT_LANE_LAUNCH(2); break;
    case 3: VDT_LANE_LAUNCH(3); break;
    case 4: VDT_LANE_LAUNCH(4); break;
    default: VDT_LANE_LAUNCH(5); break;
  }
#undef VDT_LANE_LAUNCH
  return (int)cudaGetLastError();
}
