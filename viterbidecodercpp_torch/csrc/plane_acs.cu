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
// What bounds it on the H100: the issue of per-slot work.  One frame's
// int32 metrics are 32 KB at K=14, 64 KB at K=15, 128 KB at K=16 and
// 256 KB at K=17, over the 227 KB one block can have, so each step is a
// chain of dependent phases of one block (the partner reads, a frame-wide
// minimum, the in-place writes) and the frames resident per SM set the
// throughput: two up to K=15 (64 registers a thread), one above.  Within
// a step each frame issues S selects, and with two frames an SM their
// int32 work, not the barriers, sets the step: one Cassini frame alone on
// an SM steps in 3.68-3.94 us, two in 6.61-6.84 us (the B = 1 and B = 264
// rows of the batch sweep of tools/torch_kernel_ab.py --path plane,
// T = 2062, two runs on an H100 80GB HBM3 at 700 W).  The first design
// rebuilt each slot's branch value from the polynomial taps - a rotation
// and R x (AND, __popc, parity, predicated add), ~30 operations a slot at
// Cassini (R=6), six of them __popc at a quarter of the int32 rate -
// tested the regime per slot and kept per-slot addresses in (spilled)
// registers.
// On the same card, Cassini B=512, T=2062: 73.5 ms (18.9 us a two-frame
// step) then, 26.3-28.7 ms for this design (that tool and chip_smoke.py
// phase 4b).  The pattern tables alone (the regime still tested per
// slot, the addresses still in registers) took it to 28.8-29.2 ms at 38
// SASS instructions a slot; the design below issues 26, three of them
// shared loads.
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
// is.
//
// Branch metrics from per-step pattern tables.  Slot q at phase phi
// expects the high level on rate r where parity((h << 1) & g[r]) = 1,
// h = rotl_n(q & ~2^j, phi); bit r of its branch pattern is that parity.
// The thread part (wr << 12) | lane and the register part k << 7 of q are
// disjoint bits, the rotation permutes bits and the parity is linear
// over GF(2), so the pattern is tpat(phi) ^ kpat[phi][k]: the thread
// computes tpat once a step (R __popc, not 32 R), and kpat, an (n, 32)
// table the wrapper builds from the taps (ops/plane.py
// _plane_patterns), rides in the kernel's parameters, read through the
// uniform datapath.  A step has 2^R distinct branch metrics: between the
// two barriers of step t, threads e < 256 NG tabulate step t+1's, entry p
// the sum over r of |high - sym_r| (bit r of p set) or |low - sym_r|, the
// same exact int32 abs-diff as before, from values that threads r < R
// put in shared memory a step earlier (their symbols fetched a step
// before that).  The table is read only before the first barrier of a
// step and written only after it, so one buffer serves.  A slot's branch
// metric is one xor and one shared load; half of Cassini's phases read
// it with 2-way bank conflicts (counted on the host from the patterns).
// The rest of a slot's work is compile-time where it can be: the regime
// (SAT) is a template parameter, a slot's own metric is at a constant
// offset from the thread's base, and its partner's offset is one OR of a
// per-step thread part and a per-step register part.  Rates come in
// groups of up to 8, one 256-entry table each: NG = 1 for R <= 8 (every
// registry code), NG = 2 for 9 <= R <= 16, where bm is the sum of two
// entries (a compile-time dispatch on NG: less code than keeping the
// per-slot tap loop for R > 8).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define VDT_MAX_R 16
#define VDT_MAX_N 16
#define VDT_GROUP_R 8  // rates per branch-metric table (256 entries)

struct PlaneParams {
  int B, T, n, R;
  int high, low, max_error, cap, thr, phase0;
  int n_phys, row0;  // rows per frame in the decision buffer, first row
  int gmask[VDT_MAX_R];
  // the register part of slot q's branch pattern at phase phi, as a byte
  // offset into the table: 4 * pattern(rotl_n((k << 7) & ~2^j, phi))
  int kpat[VDT_MAX_N][32];
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

// One step's branch-metric tables from its per-rate |low - sym_r| (dl)
// and |high - sym_r| (dh): entry e of group g = e >> 8 is the sum over
// the group's rates 8g + i of dh (bit i of e set) or dl.  Entries past a
// group's 2^R_g patterns are never read.
template <int NG, int W>
__device__ __forceinline__ void build_tables(int* __restrict__ bmt,
                                             const int* __restrict__ dl,
                                             const int* __restrict__ dh,
                                             int R, int tid) {
  for (int e = tid; e < (NG << VDT_GROUP_R); e += W) {
    const int r0 = (e >> VDT_GROUP_R) * VDT_GROUP_R;
    int v = 0;
#pragma unroll
    for (int i = 0; i < VDT_GROUP_R; ++i)
      if (r0 + i < R) v = wadd(v, ((e >> i) & 1) ? dh[r0 + i] : dl[r0 + i]);
    bmt[e] = v;
  }
}

// W threads (decision words) per block, CL blocks (a cluster) per frame,
// NG branch-metric tables, saturating (SAT) or wrapping arithmetic; up to
// K=15 two frames share an SM (registers capped at 64 a thread)
template <int W, int CL, int NG, bool SAT>
__global__ void __launch_bounds__(W, W <= 512 ? 2 : 1)
    plane_acs_kernel(const int* __restrict__ m_in, const int* __restrict__ sym,
                     int* __restrict__ m_out, int* __restrict__ packed,
                     int* __restrict__ acc_out,
                     const __grid_constant__ PlaneParams p) {
  extern __shared__ int m[];            // this block's SB = 32 W metrics
  __shared__ int red[32];               // per-warp minima of the step
  __shared__ int slot0;                 // the step's new slot-0 metric
  __shared__ int dlo[2][VDT_MAX_R];     // |low - sym_r|, |high - sym_r| of
  __shared__ int dhi[2][VDT_MAX_R];     //   step s at [s & 1]
  __shared__ int bmt[NG << VDT_GROUP_R];  // the step's branch metrics
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
  const int tb = (wr << 12) | lane;    // the thread part of its slots
  // this block's slots of the thread: slot k at mt[k << 7]
  int* const mt = m + (tb & (SB - 1));
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
  // threads r < R: |low - sym|, |high - sym| of step s into [s & 1]
  auto put_dist = [&](int s, int sv) {
    dlo[s & 1][tid] = abs(p.low - sv);
    dhi[s & 1][tid] = abs(p.high - sv);
  };

  // entry layout at age phase0: slot q holds state rotl_n(q, phase0)
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int q = tb | (k << 7);
    mt[k << 7] = m_in[(size_t)rotl_n(q, p.phase0, n, smask) * p.B + b];
  }
  int sv = 0;  // threads r < R: symbol r of step t + 2
  if (tid < R) {
    if (p.T > 0) put_dist(0, __ldg(sym_b + tid));
    if (p.T > 1) put_dist(1, __ldg(sym_b + R + tid));
    if (p.T > 2) sv = __ldg(sym_b + 2 * R + tid);
  }
  barrier();
  if (p.T > 0) build_tables<NG, W>(bmt, dlo[0], dhi[0], R, tid);
  barrier();

  unsigned acc = 0;
  int phi = p.phase0;
  for (int t = 0; t < p.T; ++t) {
    const int dist = 1 << (n - 1 - phi);
    // the partner of slot k, byte offset (pt | ((k << 7) ^ kd)) << 2 in pm:
    // the pairing bit lies in the thread part or in the register part; at
    // K=17 the top-bit phase pairs each slot with the other block
    const char* pm = reinterpret_cast<const char*>(
        (CL > 1 && dist >= SB) ? other_m : m);
    const int kd = (dist & (31 << 7)) << 2;
    const int pt = ((tb ^ dist) & (SB - 1) & ~(31 << 7)) << 2;
    // the thread part of the step's branch patterns, as a byte offset
    const int h2 = rotl_n(tb & ~dist, phi, n, smask) << 1;
    int tpat = 0;
#pragma unroll
    for (int r = 0; r < NG * VDT_GROUP_R; ++r)
      if (r < R) tpat |= (__popc(h2 & p.gmask[r]) & 1) << r;
    tpat <<= 2;
    const int* kpat = p.kpat[phi];
    int nm[32];
    unsigned word = 0;
    int lmin = INT_MAX;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int off = tpat ^ kpat[k];
      int bm;
      if constexpr (NG == 1) {
        bm = *reinterpret_cast<const int*>(
            reinterpret_cast<const char*>(bmt) + off);
      } else {
        bm = wadd(bmt[(off >> 2) & 255], bmt[256 + (off >> 10)]);
      }
      int e_self = wadd(mt[k << 7], bm);
      int e_part = wadd(
          *reinterpret_cast<const int*>(pm + (pt | ((k << 9) ^ kd))),
          wsub(p.max_error, bm));
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
      // odd state lands on the hi slot; the decision picks the partner
      // where it differs from the slot's parity
      const bool odd = ((tb | (k << 7)) & dist) != 0;
      const bool c = odd ? c_hi : c_lo;
      nm[k] = c != odd ? e_part : e_self;
      if (c) word |= 1u << k;
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
    for (int k = 0; k < 32; ++k) mt[k << 7] = wsub(nm[k], sub);
    if (tid < R && t + 2 < p.T) {
      put_dist(t + 2, sv);
      if (t + 3 < p.T) sv = __ldg(sym_b + (size_t)(t + 3) * R + tid);
    }
    // step t+1's table, from the values put a step earlier
    if (t + 1 < p.T)
      build_tables<NG, W>(bmt, dlo[(t + 1) & 1], dhi[(t + 1) & 1], R, tid);
    barrier();  // step t's metrics and step t+1's table are written
    phi = phi + 1 == n ? 0 : phi + 1;
  }
  // back to state order: slot q holds logical state rotl_n(q, age); no
  // block reads another's shared memory after the last barrier
  const int age = (int)(((long long)p.phase0 + p.T) % n);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int q = tb | (k << 7);
    m_out[(size_t)rotl_n(q, age, n, smask) * p.B + b] = mt[k << 7];
  }
  if (word_id == 0) acc_out[b] = (int)acc;
}

template <int W, int CL, int NG, bool SAT>
static int launch(const int* mi, const int* sy, int* mo, int* pk, int* ac,
                  const PlaneParams& p, cudaStream_t st) {
  const size_t shmem = (size_t)(W << 5) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      plane_acs_kernel<W, CL, NG, SAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (CL == 1) {
    plane_acs_kernel<W, CL, NG, SAT><<<p.B, W, shmem, st>>>(mi, sy, mo, pk,
                                                            ac, p);
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
    e = cudaLaunchKernelEx(&cfg, plane_acs_kernel<W, CL, NG, SAT>, mi, sy, mo,
                           pk, ac, p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
}

template <int NG, bool SAT>
static int launch_n(const int* mi, const int* sy, int* mo, int* pk, int* ac,
                    const PlaneParams& p, cudaStream_t st) {
  switch (p.n) {
    case 13:
      return launch<256, 1, NG, SAT>(mi, sy, mo, pk, ac, p, st);
    case 14:
      return launch<512, 1, NG, SAT>(mi, sy, mo, pk, ac, p, st);
    case 15:
      return launch<1024, 1, NG, SAT>(mi, sy, mo, pk, ac, p, st);
    default:
      return launch<1024, 2, NG, SAT>(mi, sy, mo, pk, ac, p, st);
  }
}

// kpat: the (n, 32) int32 register parts of the branch patterns
// (ops/plane.py _plane_patterns), bit r set where rate r expects high
extern "C" int vdt_plane_acs(const void* m_in, const void* sym, void* m_out,
                             void* packed, void* acc, int B, int T, int K,
                             int R, const void* gmask, const void* kpat,
                             int high, int low, int max_error, int cap,
                             int thr, int saturating, int phase0, int n_phys,
                             int row0, void* stream) {
  const int n = K - 1;
  if (n < 13 || n > VDT_MAX_N || R < 1 || R > VDT_MAX_R || B < 1 || T < 0 ||
      phase0 < 0 || phase0 >= n || row0 < 0 || row0 + T > n_phys ||
      gmask == nullptr || kpat == nullptr)
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
  p.phase0 = phase0;
  p.n_phys = n_phys;
  p.row0 = row0;
  const int* g = static_cast<const int*>(gmask);
  for (int r = 0; r < VDT_MAX_R; ++r) p.gmask[r] = r < R ? g[r] : 0;
  const int* kp = static_cast<const int*>(kpat);
  for (int phi = 0; phi < VDT_MAX_N; ++phi)
    for (int k = 0; k < 32; ++k) {
      const int v = phi < n ? kp[phi * 32 + k] : 0;
      if (v < 0 || v >= (1 << R)) return (int)cudaErrorInvalidValue;
      p.kpat[phi][k] = v << 2;
    }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* mi = static_cast<const int*>(m_in);
  const int* sy = static_cast<const int*>(sym);
  int* mo = static_cast<int*>(m_out);
  int* pk = static_cast<int*>(packed);
  int* ac = static_cast<int*>(acc);
  if (R <= VDT_GROUP_R) {
    return saturating ? launch_n<1, true>(mi, sy, mo, pk, ac, p, st)
                      : launch_n<1, false>(mi, sy, mo, pk, ac, p, st);
  }
  return saturating ? launch_n<2, true>(mi, sy, mo, pk, ac, p, st)
                    : launch_n<2, false>(mi, sy, mo, pk, ac, p, st);
}
