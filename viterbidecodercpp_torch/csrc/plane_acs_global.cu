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
// Design: one persistent kernel a call, like the TPU kernel's one
// pallas_call over the whole time loop.  A cooperative launch places
// every block at once; the grid is min(tiles, blocks the card holds), a
// tile being 8192 slots (256 decision words) of one frame, and block g
// walks the tiles_per_block consecutive tiles from g * tiles_per_block
// (ops/plane.py global_grid), so a block's tiles at one step belong to
// one frame until a block takes more than a frame, and its branch-metric
// table is built once a frame a step.  The call runs in phases separated
// by grid barriers (cooperative_groups' grid sync): the entry (slot q of
// frame b takes state rotl_n(q, phase0)), one phase a trellis step, and
// the exit (state order, the last subtraction, acc).  Each frame's
// slot-order metrics live in two global buffers that take turns (16 MB at
// K=20 B=4, which the 50 MB L2 holds); each thread owns the same 32
// slots q = (wr << 12) | (k << 7) | lane and the same decision word
// (wr, lane) as in plane_acs.cu, reads its slots and their partners from
// the step's input buffer and writes the new values to the other one.
// Every load of a value another block wrote in this launch (the buffers,
// the renorm cells) goes through L2 (ld.global.cg): the L1 of an SM is
// not coherent with another SM's stores.  The renorm is deferred and
// exact: step t writes its clamped or masked values unrenormalised, folds
// each block's minimum of a frame into a per-frame cell with atomicMin
// and its slot-0 value into another; step t+1 applies
// sub = slot0_t >= thr ? min_t : 0 to every value it loads (self and
// partner), before the branch-metric add and the clamp, exactly where the
// JAX step's renorm left it, and adds sub to the frame's renorm total.
// Cells rotate over three steps: step t reads cell t-1, folds into cell t
// and resets cell t+1, which step t-1 read last; the barrier between two
// steps orders each fold and reset before the reads that follow.  A
// step's 2^R branch metrics come from per-block tables (csrc/plane_acs.cu's
// pattern tables: the thread part tpat, the register part kpat[phi][k]
// read from a device table of the (n, 32) patterns).
//
// Each thread issues the loads of 8 slots (self and partner) before their
// stores: the two buffers are one allocation, so the compiler keeps every
// load behind the stores before it, and a thread that loaded a slot at a
// time waited out a round trip to L2 for each.
//
// What bounds it on the H100: L2 round trips and the grid barrier, not
// the card's int32 rate (the bound in chip_smoke.py phase 4e, 8
// operations a state: 0.53 ms at K=20 B=4 T=531).  ptxas: 78-80
// registers, no spills, 3 blocks of 256 threads an SM (396 resident).
// At K=20 B=4 (grid 256, a tile a block) a step takes ~8 us: ~5.4 us of
// slot work, which moves 12 S B bytes (25 MB) through L2, ~1.5 us of grid
// barrier and ~1.1 us of table builds, minima, word stores and the entry
// and exit (tools/torch_global_variants.py: the kernel without its slot
// loop, and without its step barrier, in turns; one run on an H100 80GB
// HBM3 at 700 W).  Runs of consecutive tiles of one frame are 5-6% faster
// than blocks striding over frames once a block takes several tiles (the
// same tool); loads of 4 slots in flight (64 registers, 4 blocks an SM)
// are 6-23% slower.  The next lever keeps a block's slots in shared
// memory across steps and exchanges through L2 only on the phases whose
// partner lies in another block.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define VDT_MAX_R 16
#define VDT_MIN_N 13  // S/32 words fill one tile
#define VDT_MAX_N 30  // slot indices are int
#define VDT_GROUP_R 8  // rates per branch-metric table (256 entries)
#define VDT_THREADS 256  // decision words a tile (and threads a block)
#define VDT_TILE_LOG 13  // 8192 slots a tile
#define VDT_GROUP_K 8  // slots whose loads a thread keeps in flight

struct GlobalParams {
  int B, T, n, R;
  int high, low, max_error, cap, thr;
  int phase0;
  int n_phys, row0;  // rows per frame in the decision buffer, first row
  int tiles_per_block;
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
  return __ldcg(c.slot0s + i) >= thr ? __ldcg(c.mins + i) : 0;
}

// the block's minimum of frame b's new values into cell *dst (every
// thread of the block calls it)
__device__ __forceinline__ void fold_min(int v, int* red, int* dst) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < VDT_THREADS / 32 ? red[threadIdx.x] : INT_MAX;
    v = __reduce_min_sync(0xffffffffu, v);
    if (threadIdx.x == 0) atomicMin(dst, v);
  }
}

// scratch buf: the two (B, S) slot-order metric buffers, then the cells
template <int NG, bool SAT>
__global__ void __launch_bounds__(VDT_THREADS)
    plane_acs_global(const int* __restrict__ m_in, int* buf,
                     const int* __restrict__ sym,
                     const int* __restrict__ kpat, int* __restrict__ packed,
                     int* __restrict__ m_out, int* __restrict__ acc_out,
                     const __grid_constant__ GlobalParams p) {
  __shared__ int dl[VDT_MAX_R], dh[VDT_MAX_R];
  __shared__ int bmt[NG << VDT_GROUP_R];
  __shared__ int kp[32];
  __shared__ int red[VDT_THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  const int n = p.n;
  const int R = p.R;
  const int B = p.B;
  const int S = 1 << n;
  const size_t SB = (size_t)S * B;
  const int tpf_log = n - VDT_TILE_LOG;  // tiles a frame, log2
  const int tile_mask = (1 << tpf_log) - 1;
  const int first = blockIdx.x * p.tiles_per_block;
  const int last = min(first + p.tiles_per_block, B << tpf_log);
  const int tid = threadIdx.x;
  const Cells c = cells_of(buf + 2 * SB, B);

  // entry: slot q of frame b holds state rotl_n(q, phase0); the cells
  // start with no pending subtraction (cell 2) and an empty minimum (0)
  for (int i = first; i < last; ++i) {
    const int b = i >> tpf_log;
    const int base = (i & tile_mask) << VDT_TILE_LOG;
    for (int k = 0; k < 32; ++k) {
      const int q = base | (k * VDT_THREADS) | tid;
      buf[(size_t)b * S + q] =
          m_in[(size_t)rotl_n(q, p.phase0, n, S - 1) * B + b];
    }
    if (base == 0 && tid == 0) {
      c.mins[2 * B + b] = 0;
      c.slot0s[2 * B + b] = 0;
      c.mins[b] = INT_MAX;
      c.acc[b] = 0;
    }
  }
  grid.sync();

  for (int t = 0; t < p.T; ++t) {
    const int phi = (p.phase0 + t) % n;
    const int dist = 1 << (n - 1 - phi);
    const int* cur = buf + (size_t)(t & 1) * SB;
    int* next = buf + (size_t)((t + 1) & 1) * SB;
    const int cell = (t % 3) * B;
    // the last step's readers of kp passed the barrier
    if (tid < 32) kp[tid] = kpat[phi * 32 + tid] << 2;
    int fb = -1;  // the frame whose table is built
    int sub = 0;
    int lmin = INT_MAX;
    for (int i = first; i < last; ++i) {
      const int b = i >> tpf_log;
      if (b != fb) {
        if (fb >= 0) fold_min(lmin, red, c.mins + cell + fb);
        __syncthreads();  // the tables' last readers are done
        if (tid < R) {
          const int sv = sym[((size_t)b * p.T + t) * R + tid];
          dl[tid] = abs(p.low - sv);
          dh[tid] = abs(p.high - sv);
        }
        __syncthreads();
        // the step's branch metrics: entry e of group e >> 8 sums dh
        // (bit i of e set) or dl over the group's rates
        for (int e = tid; e < (NG << VDT_GROUP_R); e += VDT_THREADS) {
          const int r0 = (e >> VDT_GROUP_R) * VDT_GROUP_R;
          int v = 0;
#pragma unroll
          for (int j = 0; j < VDT_GROUP_R; ++j)
            if (r0 + j < R)
              v = wadd(v, ((e >> j) & 1) ? dh[r0 + j] : dl[r0 + j]);
          bmt[e] = v;
        }
        __syncthreads();
        fb = b;
        sub = deferred_sub(c, t, B, b, p.thr);
        lmin = INT_MAX;
      }
      const int word_id = ((i & tile_mask) * VDT_THREADS) | tid;
      const int tb = ((word_id >> 7) << 12) | (word_id & 127);
      const int h2 = rotl_n(tb & ~dist, phi, n, S - 1) << 1;
      int tpat = 0;
#pragma unroll
      for (int r = 0; r < NG * VDT_GROUP_R; ++r)
        if (r < R) tpat |= (__popc(h2 & p.gmask[r]) & 1) << r;
      tpat <<= 2;
      const int* mb = cur + (size_t)b * S;
      int* nb = next + (size_t)b * S;
      unsigned word = 0;
      int s0 = 0;
      // a group's loads all go out before its stores: both buffers are
      // one allocation, so no load moves above an earlier store
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += VDT_GROUP_K) {
        int self[VDT_GROUP_K], part[VDT_GROUP_K];
#pragma unroll
        for (int j = 0; j < VDT_GROUP_K; ++j) {
          const int q = tb | ((k0 + j) << 7);
          self[j] = __ldcg(mb + q);
          part[j] = __ldcg(mb + (q ^ dist));
        }
#pragma unroll
        for (int j = 0; j < VDT_GROUP_K; ++j) {
          const int k = k0 + j;
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
          int e_self = wadd(wsub(self[j], sub), bm);
          int e_part = wadd(wsub(part[j], sub), wsub(p.max_error, bm));
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
          __stcg(nb + q, nm);
          if (ch) word |= 1u << k;
          lmin = min(lmin, nm);
          if (k == 0) s0 = nm;
        }
      }
      packed[((size_t)b * p.n_phys + p.row0 + t) * (size_t)(S >> 5) +
             word_id] = (int)word;
      if (word_id == 0) {
        __stcg(c.slot0s + cell + b, s0);
        __stcg(c.mins + ((t + 1) % 3) * B + b, INT_MAX);  // step t+1's
        __stcg(c.acc + b, wadd(__ldcg(c.acc + b), sub));
      }
    }
    if (fb >= 0) fold_min(lmin, red, c.mins + cell + fb);
    grid.sync();
  }

  // exit: the last step's subtraction, then slot q to state rotl_n(q, age)
  const int age = (int)(((long long)p.phase0 + p.T) % n);
  const int* fin = buf + (size_t)(p.T & 1) * SB;
  for (int i = first; i < last; ++i) {
    const int b = i >> tpf_log;
    const int base = (i & tile_mask) << VDT_TILE_LOG;
    const int sub = deferred_sub(c, p.T, B, b, p.thr);
    for (int k = 0; k < 32; ++k) {
      const int q = base | (k * VDT_THREADS) | tid;
      m_out[(size_t)rotl_n(q, age, n, S - 1) * B + b] =
          wsub(__ldcg(fin + (size_t)b * S + q), sub);
    }
    if (base == 0 && tid == 0) acc_out[b] = wadd(__ldcg(c.acc + b), sub);
  }
}

typedef void (*GlobalKernel)(const int*, int*, const int*, const int*, int*,
                             int*, int*, GlobalParams);

static GlobalKernel kernel_of(int R, int saturating) {
  return saturating ? (R <= VDT_GROUP_R ? plane_acs_global<1, true>
                                        : plane_acs_global<2, true>)
                    : (R <= VDT_GROUP_R ? plane_acs_global<1, false>
                                        : plane_acs_global<2, false>);
}

// the blocks of the kernel instance for (R, saturating) one SM of the
// current device holds at once, and the device's SM count; refuses a
// device without cooperative launches
extern "C" int vdt_plane_acs_global_resident(int R, int saturating,
                                             int* blocks_per_sm, int* sms) {
  if (R < 1 || R > VDT_MAX_R || blocks_per_sm == nullptr || sms == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel_of(R, saturating), VDT_THREADS, 0);
  return (int)e;
}

// scratch: 2 B S + 7 B int32 (the two metric buffers, then the cells);
// kpat: the (n, 32) int32 register parts of the branch patterns on the
// device (ops/plane.py _plane_patterns), each in [0, 2^R); grid and
// tiles_per_block: ops/plane.py global_grid, at most the resident blocks
// (a cooperative launch refuses more)
extern "C" int vdt_plane_acs_global(const void* m_in, const void* sym,
                                    void* m_out, void* packed, void* acc,
                                    void* scratch, const void* kpat, int B,
                                    int T, int K, int R, const void* gmask,
                                    int high, int low, int max_error,
                                    int cap, int thr, int saturating,
                                    int phase0, int n_phys, int row0,
                                    int grid, int tiles_per_block,
                                    void* stream) {
  const int n = K - 1;
  if (n < VDT_MIN_N || n > VDT_MAX_N || R < 1 || R > VDT_MAX_R || B < 1 ||
      B > 65535 || T < 0 || phase0 < 0 || phase0 >= n || row0 < 0 ||
      row0 + T > n_phys || gmask == nullptr || kpat == nullptr ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B << (n - VDT_TILE_LOG);
  if (tiles > INT_MAX || grid < 1 || tiles_per_block < 1 ||
      (long long)grid * tiles_per_block < tiles ||
      (long long)(grid - 1) * tiles_per_block >= tiles)
    return (int)cudaErrorInvalidValue;
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
  p.phase0 = phase0;
  p.n_phys = n_phys;
  p.row0 = row0;
  p.tiles_per_block = tiles_per_block;
  const int* g = static_cast<const int*>(gmask);
  for (int r = 0; r < VDT_MAX_R; ++r) p.gmask[r] = r < R ? g[r] : 0;
  const int* mi = static_cast<const int*>(m_in);
  int* buf = static_cast<int*>(scratch);
  const int* sy = static_cast<const int*>(sym);
  const int* kp = static_cast<const int*>(kpat);
  int* pk = static_cast<int*>(packed);
  int* mo = static_cast<int*>(m_out);
  int* ac = static_cast<int*>(acc);
  void* args[] = {&mi, &buf, &sy, &kp, &pk, &mo, &ac, &p};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of(R, saturating)), dim3(grid),
      dim3(VDT_THREADS), args, 0, static_cast<cudaStream_t>(stream));
}
