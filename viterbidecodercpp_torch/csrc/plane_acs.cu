// Plane add-compare-select for 8192 <= S <= 65536 states (Hopper).
//
// Replaces the JAX package's TPU kernel ops/bigstate_pallas.py
// (_make_kernel, launched by _acs_plane_padded) and computes exactly what
// it computes: the rotated in-place schedule - logical state s at slot
// rotr_n(s, t) after t steps (n = K-1), so at phase phi slot q pairs with
// q ^ 2^j, j = n-1-phi - with two candidates per slot (self + bm, partner
// + (max_error - bm)), the saturating clamp or wrapping mask and the
// regime's tie rule; slots with bit j set take the c_hi branch.  The
// renorm is gated on slot 0 (state 0 at every phase) and subtracts the
// frame minimum over all S slots.  The decision bits keep the JAX plane
// layout: slot q is plane row q >> 7, lane q & 127, and its bit is bit
// (q >> 7) & 31 of word [b, row0 + t, (q >> 7) >> 5, q & 127].
//
// What bounds it on the H100: shared memory.  One frame's int32 metrics
// are 32 KB at K=14, 64 KB at K=15, 128 KB at K=16 and 256 KB at K=17,
// over the 227 KB one block can have.  Double buffering would not fit
// K=16, and 64 KB+ per frame leaves few frames per SM, so each step is a
// chain of dependent phases of one block: the partner reads, a
// frame-wide minimum, the in-place writes.  The frames resident per SM
// set the throughput: on an H100 80GB HBM3 (700 W), a Cassini (K=15)
// call at B=512, T=2062 took 70 ms with two frames per SM (64 registers
// a thread, a few spilled) and 103 ms with one (122 registers).
//
// Design: one thread per decision word (wr, lane), which owns the 32
// slots q = (wr << 12) | (k << 7) | lane, k = 0..31, and ORs their
// decision bits into its own word, so there is no ballot and consecutive
// threads store consecutive words.  A frame is one thread block of
// S/32 threads (256 at K=14, 512 at K=15, 1024 at K=16); at K=17 it is a
// cluster of two 1024-thread blocks on two SMs, block r holding slots
// [r S/2, (r+1) S/2) - only the phase that pairs across the top bit reads
// the partner from the other block's shared memory (distributed shared
// memory), and the frame minimum and slot 0 are read there too.  The
// metrics sit in one int32 buffer (above 48 KB only after
// cudaFuncSetAttribute) and the butterfly is in place: every thread reads
// its slots' self and partner values and keeps the 32 new values in
// registers; after a barrier, the warps' minima and the new slot-0 value
// give the renorm, and the renormalised values are written back before a
// second barrier (cluster-wide barriers at K=17).  int32 keeps the kernel
// exact for any int32 input metrics and symbols, as the plain version
// is.  The branch value of a slot is computed from the polynomial taps:
// h = rotl_n(q & ~2^j, phi), parity((h << 1) & g[r]) selects
// |high - sym_r| or |low - sym_r|; threads r < R fetch step t+1's symbols
// while step t computes.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define VDT_MAX_R 16

struct PlaneParams {
  int B, T, n, R;
  int high, low, max_error, cap, thr, saturating, phase0;
  int n_phys, row0;  // rows per frame in the decision buffer, first row
  int gmask[VDT_MAX_R];
};

// rotl within n bits; k in [0, n), x < 2^n
__device__ __forceinline__ int rotl_n(int x, int k, int n, int mask) {
  return ((x << k) | (x >> (n - k))) & mask;
}

// int32 arithmetic that wraps, as the plain version's does
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// W threads (decision words) per block, CL blocks (a cluster) per frame;
// up to K=15 two frames share an SM (registers capped at 64 a thread)
template <int W, int CL>
__global__ void __launch_bounds__(W, W <= 512 ? 2 : 1)
    plane_acs_kernel(const int* __restrict__ m_in, const int* __restrict__ sym,
                     int* __restrict__ m_out, int* __restrict__ packed,
                     int* __restrict__ acc_out, const PlaneParams p) {
  extern __shared__ int m[];           // this block's SB = 32 W metrics
  __shared__ int red[32];              // per-warp minima of the step
  __shared__ int slot0;                // the step's new slot-0 metric
  __shared__ int dlo[2][VDT_MAX_R];    // per step: |low - sym_r|
  __shared__ int dhl[2][VDT_MAX_R];    //   and |high - sym_r| - |low - sym_r|
  constexpr int SB = W << 5;
  constexpr int NWARPS = W >> 5;
  const int smask = SB * CL - 1;
  const int n = p.n;
  const int R = p.R;
  const int tid = threadIdx.x;
  int rank = 0;
  if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / CL;
  const int word_id = rank * W + tid;  // word (wr, lane) of a row
  const int lane = word_id & 127;
  const int wr = word_id >> 7;
  const int wlane = tid & 31;
  const int* sym_b = sym + (size_t)b * p.T * R;
  int* out = packed + ((size_t)b * p.n_phys + p.row0) * (W * CL) + word_id;
  // the other block of the cluster: partner half, minima and slot 0
  int* other_m = m;
  const int* other_red = red;
  const int* slot0_src = &slot0;
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    other_m = cluster.map_shared_rank(m, rank ^ 1);
    other_red = cluster.map_shared_rank(red, rank ^ 1);
    slot0_src = cluster.map_shared_rank(&slot0, 0);
  }
  auto barrier = [] {
    if constexpr (CL > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };

  // entry layout at age phase0: slot q holds state rotl_n(q, phase0)
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int q = (wr << 12) | (k << 7) | lane;
    m[q & (SB - 1)] = m_in[(size_t)rotl_n(q, p.phase0, n, smask) * p.B + b];
  }
  int sv = 0;
  if (tid < R && p.T > 0) {
    sv = __ldg(sym_b + tid);
    dlo[0][tid] = abs(p.low - sv);
    dhl[0][tid] = abs(p.high - sv) - abs(p.low - sv);
  }
  if (tid < R && p.T > 1) sv = __ldg(sym_b + R + tid);
  barrier();

  unsigned acc = 0;
  int phi = p.phase0;
  for (int t = 0; t < p.T; ++t) {
    const int buf = t & 1;
    const int dist = 1 << (n - 1 - phi);
    // at K=17 the top-bit phase pairs each slot with the other block
    const int* pm = (CL > 1 && dist >= SB) ? other_m : m;
    int base = 0;
    for (int r = 0; r < R; ++r) base += dlo[buf][r];
    int nm[32];
    unsigned word = 0;
    int lmin = INT_MAX;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int q = (wr << 12) | (k << 7) | lane;
      const int h2 = rotl_n(q & ~dist, phi, n, smask) << 1;
      int bm = base;
#pragma unroll
      for (int r = 0; r < VDT_MAX_R; ++r) {
        if (r >= R) break;
        if (__popc(h2 & p.gmask[r]) & 1) bm += dhl[buf][r];
      }
      int e_self = wadd(m[q & (SB - 1)], bm);
      int e_part = wadd(pm[(q ^ dist) & (SB - 1)], p.max_error - bm);
      bool c_lo, c_hi;
      if (p.saturating) {
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
      const bool odd = (q & dist) != 0;  // odd state lands on the hi slot
      nm[k] = odd ? (c_hi ? e_self : e_part) : (c_lo ? e_part : e_self);
      word |= (unsigned)(odd ? c_hi : c_lo) << k;
      lmin = min(lmin, nm[k]);
    }
    out[(size_t)t * (W * CL)] = (int)word;
    lmin = __reduce_min_sync(0xffffffffu, lmin);
    if (wlane == 0) red[tid >> 5] = lmin;
    if (word_id == 0) slot0 = nm[0];
    barrier();  // every read of step t is done; minima published
    int v = wlane < NWARPS ? red[wlane] : INT_MAX;
    if constexpr (CL > 1) {
      if (wlane < NWARPS) v = min(v, other_red[wlane]);
    }
    const int mn = __reduce_min_sync(0xffffffffu, v);
    const int sub = *slot0_src >= p.thr ? mn : 0;
    acc += (unsigned)sub;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      m[((wr << 12) | (k << 7) | lane) & (SB - 1)] = wsub(nm[k], sub);
    }
    if (tid < R && t + 1 < p.T) {
      dlo[buf ^ 1][tid] = abs(p.low - sv);
      dhl[buf ^ 1][tid] = abs(p.high - sv) - abs(p.low - sv);
      if (t + 2 < p.T) sv = __ldg(sym_b + (size_t)(t + 2) * R + tid);
    }
    barrier();  // step t's metrics are written
    phi = phi + 1 == n ? 0 : phi + 1;
  }
  // back to state order: slot q holds logical state rotl_n(q, age); no
  // block reads another's shared memory after the last barrier
  const int age = (int)(((long long)p.phase0 + p.T) % n);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int q = (wr << 12) | (k << 7) | lane;
    m_out[(size_t)rotl_n(q, age, n, smask) * p.B + b] = m[q & (SB - 1)];
  }
  if (word_id == 0) acc_out[b] = (int)acc;
}

template <int W, int CL>
static int launch(const int* mi, const int* sy, int* mo, int* pk, int* ac,
                  const PlaneParams& p, cudaStream_t st) {
  const size_t shmem = (size_t)(W << 5) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      plane_acs_kernel<W, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (CL == 1) {
    plane_acs_kernel<W, CL><<<p.B, W, shmem, st>>>(mi, sy, mo, pk, ac, p);
    return (int)cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.B * CL);
    cfg.blockDim = dim3(W);
    cfg.dynamicSmemBytes = shmem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, plane_acs_kernel<W, CL>, mi, sy, mo, pk, ac,
                           p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
}

extern "C" int vdt_plane_acs(const void* m_in, const void* sym, void* m_out,
                             void* packed, void* acc, int B, int T, int K,
                             int R, const void* gmask, int high, int low,
                             int max_error, int cap, int thr, int saturating,
                             int phase0, int n_phys, int row0, void* stream) {
  const int n = K - 1;
  if (n < 13 || n > 16 || R < 1 || R > VDT_MAX_R || B < 1 || T < 0 ||
      phase0 < 0 || phase0 >= n || row0 < 0 || row0 + T > n_phys)
    return (int)cudaErrorInvalidValue;
  PlaneParams p;
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
  p.phase0 = phase0;
  p.n_phys = n_phys;
  p.row0 = row0;
  const int* g = static_cast<const int*>(gmask);
  for (int r = 0; r < VDT_MAX_R; ++r) p.gmask[r] = r < R ? g[r] : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* mi = static_cast<const int*>(m_in);
  const int* sy = static_cast<const int*>(sym);
  int* mo = static_cast<int*>(m_out);
  int* pk = static_cast<int*>(packed);
  int* ac = static_cast<int*>(acc);
  switch (n) {
    case 13:
      return launch<256, 1>(mi, sy, mo, pk, ac, p, st);
    case 14:
      return launch<512, 1>(mi, sy, mo, pk, ac, p, st);
    case 15:
      return launch<1024, 1>(mi, sy, mo, pk, ac, p, st);
    default:
      return launch<1024, 2>(mi, sy, mo, pk, ac, p, st);
  }
}
