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
// each frame is a chain of T dependent steps; each step needs every slot
// of the previous step (the partner read) and the frame minimum (the
// renorm).  The time is the per-step latency of one barrier plus a
// two-level min reduction, times T, spread over as many frames as the
// SMs hold at once.  Bytes are small: the metric carry never leaves the
// SM, only symbols come in and one decision word per 32 slots goes out.
//
// Design: one thread block per frame, one thread per slot (S/1024 slots
// per thread above S = 1024).  The frame's metrics sit in shared memory,
// double-buffered (2 x 16 KB at S = 4096), so a step reads one buffer and
// writes the other and needs one __syncthreads().  The renorm of step t
// is applied lazily when step t+1 reads its inputs: each warp publishes
// its minimum (__reduce_min_sync) into a double-buffered slot, and after
// the barrier every warp reduces those partials itself.  A warp covers 32
// consecutive slots, so __ballot_sync yields decision word p>>5 directly.
// The slot's expected symbols are computed, not looked up: the branch
// value for half-state h is parity((h << 1) & G[r]) ? high : low with
// __popc, so no (n, R, S) slot table has to fit in shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define VDT_MAX_R 16

struct AcsParams {
  int B, T, n, R;
  int high, low, max_error, cap, thr, saturating;
  int gmask[VDT_MAX_R];  // polynomial taps 1..K-1 (bit 0 never matters)
};

// rotl within n bits; k in [0, n), x < 2^n
__device__ __forceinline__ int rotl_n(int x, int k, int n, int mask) {
  return ((x << k) | (x >> (n - k))) & mask;
}

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
                               int R, const void* gmask, int high, int low,
                               int max_error, int cap, int thr, int saturating,
                               void* stream) {
  const int n = K - 1;
  const int S = 1 << n;
  if (S < 64 || S > 4096 || R < 1 || R > VDT_MAX_R || B < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* mi = static_cast<const int*>(m_in);
  const int* sy = static_cast<const int*>(sym);
  int* mo = static_cast<int*>(m_out);
  int* pk = static_cast<int*>(packed);
  int* ac = static_cast<int*>(acc);
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
