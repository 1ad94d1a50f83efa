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
// What bounds it on the H100: a frame is a chain of T dependent steps of a
// few dozen instructions each, over a state vector of 2..32 ints.  The time
// is the latency of one step's chain (two shuffles for the predecessors,
// log2 S dependent shuffles for the minimum, one for state 0, a ballot)
// times T; the frames run side by side.  Bytes are small: R symbols in and
// one word out per frame per step.
//
// Design: one lane per state, S lanes per frame, 32 / S frames per warp; no
// shared memory and no barrier.  Lane s reads m[h] and m[h + H] with
// __shfl_sync over a segment of width S, the frame minimum is an
// xor-shuffle reduction within the segment, and one __ballot_sync gives
// every frame's decision bits, shifted down by the frame's segment.  A
// lane's column bt[.][h] of the branch table is loaded into registers once
// (the table is exact for any symbols, unlike the TPU kernel's symmetric
// shortcut), and the next step's symbols load while the current step
// computes.  Symbols arrive time-major, (T, R, B), so one step's loads of
// neighbouring frames are neighbouring addresses.  Frames past B in a live
// warp run every shuffle and ballot and skip their loads and stores.

#include <cstdint>
#include <cuda_runtime.h>

#define VDT_MAX_R 16
#define VDT_MAX_H 16
#define VDT_THREADS 64

struct LaneParams {
  int B, T, R;
  int max_error, cap, thr, saturating;
  int bt[VDT_MAX_R * VDT_MAX_H];  // bt[r * H + h]
};

template <int N>
__global__ void __launch_bounds__(VDT_THREADS)
    lane_acs_kernel(const int* __restrict__ m_in, const int* __restrict__ sym,
                    int* __restrict__ m_out, int* __restrict__ packed,
                    int* __restrict__ acc_out, const LaneParams p) {
  constexpr int S = 1 << N;
  constexpr int H = S >> 1;
  constexpr unsigned FULL = 0xffffffffu;
  constexpr unsigned SMASK = S == 32 ? FULL : ((1u << S) - 1u);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int B = p.B;
  // a warp whose first frame is past B leaves whole: no shuffle waits on it
  if (((g - lane) >> N) >= B) return;
  const int s = g & (S - 1);
  const int b = g >> N;
  const bool live = b < B;
  const int h = s >> 1;
  const bool odd = (s & 1) != 0;
  const int seg = lane & ~(S - 1);  // the frame's first lane in the warp

  int bt[VDT_MAX_R];
#pragma unroll
  for (int r = 0; r < VDT_MAX_R; ++r) bt[r] = r < p.R ? p.bt[r * H + h] : 0;

  int m = live ? m_in[(size_t)s * B + b] : 0;
  unsigned acc = 0;
  int nxt[VDT_MAX_R];
#pragma unroll
  for (int r = 0; r < VDT_MAX_R; ++r)
    nxt[r] = (r < p.R && live && p.T > 0) ? __ldg(sym + (size_t)r * B + b) : 0;
  for (int t = 0; t < p.T; ++t) {
    int cur[VDT_MAX_R];
#pragma unroll
    for (int r = 0; r < VDT_MAX_R; ++r) cur[r] = nxt[r];
    if (live && t + 1 < p.T) {
      const int* st = sym + (size_t)(t + 1) * p.R * B + b;
#pragma unroll
      for (int r = 0; r < VDT_MAX_R; ++r)
        if (r < p.R) nxt[r] = __ldg(st + (size_t)r * B);
    }
    int bm = 0;
#pragma unroll
    for (int r = 0; r < VDT_MAX_R; ++r)
      if (r < p.R) bm += abs(bt[r] - cur[r]);
    const int ibm = p.max_error - bm;
    const int lo = __shfl_sync(FULL, m, h, S);
    const int hi = __shfl_sync(FULL, m, h + H, S);
    int c0 = lo + (odd ? ibm : bm);
    int c1 = hi + (odd ? bm : ibm);
    bool dec;
    if (p.saturating) {
      c0 = min(c0, p.cap);
      c1 = min(c1, p.cap);
      dec = c1 <= c0;  // SIMD tie -> predecessor 1
    } else {
      c0 &= p.cap;
      c1 &= p.cap;
      dec = c0 > c1;   // scalar tie -> predecessor 0
    }
    const int nm = dec ? c1 : c0;
    int mn = nm;
#pragma unroll
    for (int off = H; off > 0; off >>= 1)
      mn = min(mn, __shfl_xor_sync(FULL, mn, off, S));
    const int m0 = __shfl_sync(FULL, nm, 0, S);
    const int sub = m0 >= p.thr ? mn : 0;
    m = nm - sub;
    acc += (unsigned)sub;
    const unsigned word = (__ballot_sync(FULL, dec) >> seg) & SMASK;
    if (live && s == 0) packed[(size_t)t * B + b] = (int)word;
  }
  if (live) {
    m_out[(size_t)s * B + b] = m;
    if (s == 0) acc_out[b] = (int)acc;
  }
}

extern "C" int vdt_lane_acs(const void* m_in, const void* sym, void* m_out,
                            void* packed, void* acc, int B, int T, int K,
                            int R, const void* bt, int max_error, int cap,
                            int thr, int saturating, void* stream) {
  const int n = K - 1;
  if (n < 1 || n > 5 || R < 1 || R > VDT_MAX_R || B < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  const int H = 1 << (n - 1);
  LaneParams p;
  p.B = B;
  p.T = T;
  p.R = R;
  p.max_error = max_error;
  p.cap = cap;
  p.thr = thr;
  p.saturating = saturating;
  const int* tab = static_cast<const int*>(bt);
  for (int i = 0; i < VDT_MAX_R * VDT_MAX_H; ++i)
    p.bt[i] = i < R * H ? tab[i] : 0;
  const long long threads = (long long)B << n;
  const int blocks = (int)((threads + VDT_THREADS - 1) / VDT_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* mi = static_cast<const int*>(m_in);
  const int* sy = static_cast<const int*>(sym);
  int* mo = static_cast<int*>(m_out);
  int* pk = static_cast<int*>(packed);
  int* ac = static_cast<int*>(acc);
#define VDT_LANE_LAUNCH(NN) \
  lane_acs_kernel<NN><<<blocks, VDT_THREADS, 0, st>>>(mi, sy, mo, pk, ac, p)
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
