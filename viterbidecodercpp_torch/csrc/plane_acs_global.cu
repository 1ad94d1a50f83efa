// Plane add-compare-select for S >= 2^19 states, K >= 20 (Hopper), with
// the frame's metrics in global memory.
//
// Replaces the JAX package's TPU kernel ops/bigstate_pallas.py
// (_make_kernel, launched by _acs_plane_padded) where csrc/plane_acs.cu
// cannot hold a frame: one frame's int32 metrics are 2 MB at K=20 and
// 4 MB at K=21, past the 1 MB of a portable cluster of eight blocks.  It
// computes what that kernel computes, bit for bit: the rotated in-place
// schedule (slot q pairs with q ^ 2^j at phase phi, j = n-1-phi), two
// candidates a slot, the saturating clamp or wrapping mask and the
// regime's tie rule, the renorm gated on slot 0 that subtracts the frame
// minimum over all S slots, and the JAX plane word layout
// [b, row0 + t, (q >> 7) >> 5, q & 127].
//
// Design: each frame's slot-order metrics live in two global buffers that
// take turns (4 MB at K=20, which L2 holds at small B); one launch a
// trellis step over (S/32/256 blocks, B frames).  Each thread owns the
// same 32 slots q = (wr << 12) | (k << 7) | lane and the same decision
// word (wr, lane) as in plane_acs.cu, reads its slots and their partners
// from the step's input buffer and writes the new values to the other one,
// so no step needs a barrier across blocks.  The renorm is deferred and
// exact: step t writes its clamped or masked values unrenormalised, folds
// each block's minimum into a per-frame cell with atomicMin and its slot-0
// value into another; step t+1 applies sub = slot0_t >= thr ? min_t : 0
// to every value it loads (self and partner), before the branch-metric add
// and the clamp, exactly where the JAX step's renorm left it, and adds sub
// to the frame's renorm total.  Cells rotate over three steps: step t
// reads cell t-1, folds into cell t and resets cell t+1, which step t-1
// read last.  After the last step one launch applies the last subtraction
// and writes the state-order metrics and acc.  A step's 2^R branch metrics
// come from per-block tables (csrc/plane_acs.cu's pattern tables: the
// thread part tpat, the register part kpat[phi][k] read from a device
// table of the (n, 32) patterns).
//
// What bounds it on the H100: the host's launches, one a step.  At K=20,
// B=4, T=531 the host took 22.81 ms to enqueue a call's 533 launches and
// its kernels were busy 5.10 ms of the 22.92 ms call (chip_smoke.py phase
// 4e, one run on an H100 80GB HBM3 at 700 W).  On the device a step moves
// bytes: it reads each frame's metrics twice (self and partner) and writes
// them once, 12 S bytes a frame, from L2 where the two buffers fit (50 MB)
// and from HBM past it.  This first design is the simple one; one
// persistent kernel with a grid barrier, or a CUDA graph of the steps,
// takes the launches off the host (later work).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define VDT_MAX_R 16
#define VDT_MIN_N 13  // S/32 words fill one block
#define VDT_MAX_N 30  // slot indices are int
#define VDT_GROUP_R 8  // rates per branch-metric table (256 entries)
#define VDT_THREADS 256  // decision words a block

struct GlobalParams {
  int B, T, n, R;
  int high, low, max_error, cap, thr;
  int t, phi;       // the step and its phase
  int n_phys, row0;  // rows per frame in the decision buffer, first row
  int gmask[VDT_MAX_R];
};

__device__ __forceinline__ int rotl_n(int x, int k, int n, int mask) {
  const unsigned u = (unsigned)x;
  return (int)(((u << k) | (u >> (n - k))) & (unsigned)mask);
}

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// cells: mins[3][B], slot0s[3][B], acc[B] (int32, after the buffers)
struct Cells {
  int* mins;
  int* slot0s;
  int* acc;
};

__device__ __forceinline__ Cells cells_of(int* c, int B) {
  return Cells{c, c + 3 * B, c + 6 * B};
}

// the subtraction step t-1 left for step t (cell (t + 2) % 3)
__device__ __forceinline__ int deferred_sub(const Cells& c, int t, int B,
                                            int b, int thr) {
  const int i = ((t + 2) % 3) * B + b;
  return c.slot0s[i] >= thr ? c.mins[i] : 0;
}

// entry: slot q of frame b holds state rotl_n(q, phase0); the cells start
// with no pending subtraction (cell 2) and an empty minimum (cell 0)
__global__ void plane_global_init(const int* __restrict__ m_in,
                                  int* __restrict__ buf,
                                  int* __restrict__ cells, int B, int n,
                                  int phase0) {
  const int S = 1 << n;
  const int q = blockIdx.x * VDT_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  buf[(size_t)b * S + q] =
      m_in[(size_t)rotl_n(q, phase0, n, S - 1) * B + b];
  if (q == 0) {
    const Cells c = cells_of(cells, B);
    c.mins[2 * B + b] = 0;
    c.slot0s[2 * B + b] = 0;
    c.mins[b] = INT_MAX;
    c.acc[b] = 0;
  }
}

template <int NG, bool SAT>
__global__ void __launch_bounds__(VDT_THREADS)
    plane_global_step(const int* __restrict__ m_cur, int* __restrict__ m_next,
                      const int* __restrict__ sym,
                      const int* __restrict__ kpat, int* __restrict__ packed,
                      int* __restrict__ cells,
                      const __grid_constant__ GlobalParams p) {
  __shared__ int dl[VDT_MAX_R], dh[VDT_MAX_R];
  __shared__ int bmt[NG << VDT_GROUP_R];
  __shared__ int kp[32];
  __shared__ int red[VDT_THREADS / 32];
  const int n = p.n;
  const int R = p.R;
  const int S = 1 << n;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int word_id = blockIdx.x * VDT_THREADS + tid;
  const int tb = ((word_id >> 7) << 12) | (word_id & 127);
  const Cells c = cells_of(cells, p.B);
  const int sub = deferred_sub(c, p.t, p.B, b, p.thr);
  if (tid < R) {
    const int sv = sym[((size_t)b * p.T + p.t) * R + tid];
    dl[tid] = abs(p.low - sv);
    dh[tid] = abs(p.high - sv);
  }
  if (tid < 32) kp[tid] = kpat[p.phi * 32 + tid] << 2;
  __syncthreads();
  // the step's branch metrics: entry e of group e >> 8 sums dh (bit i of e
  // set) or dl over the group's rates
  for (int e = tid; e < (NG << VDT_GROUP_R); e += VDT_THREADS) {
    const int r0 = (e >> VDT_GROUP_R) * VDT_GROUP_R;
    int v = 0;
#pragma unroll
    for (int i = 0; i < VDT_GROUP_R; ++i)
      if (r0 + i < R) v = wadd(v, ((e >> i) & 1) ? dh[r0 + i] : dl[r0 + i]);
    bmt[e] = v;
  }
  __syncthreads();

  const int dist = 1 << (n - 1 - p.phi);
  const int h2 = rotl_n(tb & ~dist, p.phi, n, S - 1) << 1;
  int tpat = 0;
#pragma unroll
  for (int r = 0; r < NG * VDT_GROUP_R; ++r)
    if (r < R) tpat |= (__popc(h2 & p.gmask[r]) & 1) << r;
  tpat <<= 2;
  const int* mb = m_cur + (size_t)b * S;
  int* nb = m_next + (size_t)b * S;
  unsigned word = 0;
  int lmin = INT_MAX;
  int s0 = 0;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const int q = tb | (k << 7);
    const int off = tpat ^ kp[k];
    int bm;
    if constexpr (NG == 1) {
      bm = *reinterpret_cast<const int*>(
          reinterpret_cast<const char*>(bmt) + off);
    } else {
      bm = wadd(bmt[(off >> 2) & 255], bmt[256 + (off >> 10)]);
    }
    // the deferred renorm first, then the add and the clamp
    int e_self = wadd(wsub(mb[q], sub), bm);
    int e_part = wadd(wsub(mb[q ^ dist], sub), wsub(p.max_error, bm));
    bool c_lo, c_hi;
    if constexpr (SAT) {
      e_self = min(e_self, p.cap);
      e_part = min(e_part, p.cap);
      const int diff = wsub(e_part, e_self);
      c_lo = diff <= 0;  // SIMD tie -> predecessor 1
      c_hi = diff >= 0;
    } else {
      e_self &= p.cap;
      e_part &= p.cap;
      const int diff = e_self - e_part;
      c_lo = diff > 0;   // scalar tie -> predecessor 0
      c_hi = diff < 0;
    }
    const bool odd = (q & dist) != 0;
    const bool ch = odd ? c_hi : c_lo;
    const int nm = ch != odd ? e_part : e_self;
    nb[q] = nm;
    if (ch) word |= 1u << k;
    lmin = min(lmin, nm);
    if (k == 0) s0 = nm;
  }
  packed[((size_t)b * p.n_phys + p.row0 + p.t) * (size_t)(S >> 5) +
         word_id] = (int)word;
  lmin = __reduce_min_sync(0xffffffffu, lmin);
  if ((tid & 31) == 0) red[tid >> 5] = lmin;
  const int cur = (p.t % 3) * p.B + b;
  if (word_id == 0) {
    c.slot0s[cur] = s0;
    c.mins[((p.t + 1) % 3) * p.B + b] = INT_MAX;  // step t+1 folds here
    c.acc[b] = wadd(c.acc[b], sub);
  }
  __syncthreads();
  if (tid < 32) {
    int v = tid < VDT_THREADS / 32 ? red[tid] : INT_MAX;
    v = __reduce_min_sync(0xffffffffu, v);
    if (tid == 0) atomicMin(&c.mins[cur], v);
  }
}

// exit: the last step's subtraction, then slot q to state rotl_n(q, age)
__global__ void plane_global_finish(const int* __restrict__ buf,
                                    const int* __restrict__ cells,
                                    int* __restrict__ m_out,
                                    int* __restrict__ acc_out, int B, int T,
                                    int n, int age, int thr) {
  const int S = 1 << n;
  const int q = blockIdx.x * VDT_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const Cells c = cells_of(const_cast<int*>(cells), B);
  const int sub = deferred_sub(c, T, B, b, thr);
  m_out[(size_t)rotl_n(q, age, n, S - 1) * B + b] =
      wsub(buf[(size_t)b * S + q], sub);
  if (q == 0) acc_out[b] = wadd(c.acc[b], sub);
}

template <int NG, bool SAT>
static int steps(int* buf, const int* sy, const int* kpat, int* pk,
                 int* cells, GlobalParams p, int phase0, cudaStream_t st,
                 int* launched) {
  const size_t S = (size_t)1 << p.n;
  const dim3 grid((unsigned)(S / 32 / VDT_THREADS), (unsigned)p.B);
  for (int t = 0; t < p.T; ++t) {
    p.t = t;
    p.phi = (phase0 + t) % p.n;
    const int* cur = buf + (size_t)(t & 1) * S * p.B;
    int* next = buf + (size_t)((t + 1) & 1) * S * p.B;
    plane_global_step<NG, SAT><<<grid, VDT_THREADS, 0, st>>>(
        cur, next, sy, kpat, pk, cells, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
  }
  return (int)cudaSuccess;
}

// scratch: 2 B S + 7 B int32 (the two metric buffers, then the cells);
// kpat: the (n, 32) int32 register parts of the branch patterns on the
// device (ops/plane.py _plane_patterns), each in [0, 2^R); *launched: the
// kernels launched (T + 2 when it returns cudaSuccess)
extern "C" int vdt_plane_acs_global(const void* m_in, const void* sym,
                                    void* m_out, void* packed, void* acc,
                                    void* scratch, const void* kpat, int B,
                                    int T, int K, int R, const void* gmask,
                                    int high, int low, int max_error,
                                    int cap, int thr, int saturating,
                                    int phase0, int n_phys, int row0,
                                    void* stream, int* launched) {
  const int n = K - 1;
  if (n < VDT_MIN_N || n > VDT_MAX_N || R < 1 || R > VDT_MAX_R || B < 1 ||
      B > 65535 || T < 0 || phase0 < 0 || phase0 >= n || row0 < 0 ||
      row0 + T > n_phys || gmask == nullptr || kpat == nullptr ||
      scratch == nullptr || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  *launched = 0;
  GlobalParams p = {};
  p.B = B;
  p.T = T;
  p.n = n;
  p.R = R;
  p.high = high;
  p.low = low;
  p.max_error = max_error;
  p.cap = cap;
  p.thr = thr;
  p.n_phys = n_phys;
  p.row0 = row0;
  const int* g = static_cast<const int*>(gmask);
  for (int r = 0; r < VDT_MAX_R; ++r) p.gmask[r] = r < R ? g[r] : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t S = (size_t)1 << n;
  int* buf = static_cast<int*>(scratch);
  int* cells = buf + 2 * S * B;
  const dim3 grid((unsigned)(S / VDT_THREADS), (unsigned)B);
  plane_global_init<<<grid, VDT_THREADS, 0, st>>>(
      static_cast<const int*>(m_in), buf, cells, B, n, phase0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  const int* sy = static_cast<const int*>(sym);
  const int* kp = static_cast<const int*>(kpat);
  int* pk = static_cast<int*>(packed);
  auto run = saturating
                  ? (R <= VDT_GROUP_R ? steps<1, true> : steps<2, true>)
                  : (R <= VDT_GROUP_R ? steps<1, false> : steps<2, false>);
  const int err = run(buf, sy, kp, pk, cells, p, phase0, st, launched);
  if (err != (int)cudaSuccess) return err;
  const int age = (int)(((long long)phase0 + T) % n);
  plane_global_finish<<<grid, VDT_THREADS, 0, st>>>(
      buf + (size_t)(T & 1) * S * B, cells, static_cast<int*>(m_out),
      static_cast<int*>(acc), B, T, n, age, thr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return (int)cudaSuccess;
}
