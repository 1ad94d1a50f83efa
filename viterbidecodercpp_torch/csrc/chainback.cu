// Batched traceback walk over packed decision rows (Hopper).
//
// Replaces the JAX package's TPU kernel ops/chainback_pallas.py
// (_make_kernel, launched by _chainback_padded; wrapped by
// chainback_pallas and walk_rows).  It computes what that kernel does:
// one walk state per frame, rows newest to oldest; in slot order the
// state is first un-rotated by the row's rotation,
// q = ((s >> rot) | (s << (n - rot))) & (S - 1), with rot = rots[t] when
// given and the one-shot schedule (t + 1) mod n otherwise; the bit is
// (word[q >> 5] >> (q & 31)) & 1 (a word index outside [0, W) reads 0);
// s <- (s >> 1) | (d << (n - 1)) unless valid[t] == 0.  Every row emits
// its bit; the wrapper slices the data-bit range.
//
// What bounds it on the H100: each frame is a chain of N rows, each
// needing the state the newer row produced.  Bytes are one word a row a
// frame plus a byte of output, a few microseconds at the memory's rate;
// the first design (one thread per frame, kept below for W > 8) loaded the
// word the state selects, so every row paid an L2 round trip on the chain
// (~226 ns a row).
//
// Design (W <= 8: the lane path's W = 1, Voyager's W = 2, the CDMA codes'
// W = 8): a row's words do not depend on the state, only the choice among
// them does.  So each thread (one per frame, 32 frames a block) copies
// whole tiles of rows - every word, the rotation and the valid flag - by
// cp.async into one of two shared buffers, neighbouring frames on
// neighbouring addresses, while it walks the other tile.  The walk over a
// tile is unrolled, a template on the mode (slot order with streamed or
// scheduled rotations, state order; valid mask or none), so every shared
// offset is a constant and the loads run ahead of the state; the chain per
// row is a rotate, a W-way select, a shift and a mask.  Above W = 8 a tile
// of whole rows would read W times the words the walk needs; there the
// dependent-load walk stays, picked by the wrapper.

#include <cstdint>
#include <cuda_runtime.h>

#define VDT_TILED_MAX_W 8     // widest row the tiled walk takes
#define VDT_WALK_THREADS 32  // frames per block of the tiled walk

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A load from shared memory that the compiler keeps where it is written:
// it may not sink it below the select that picks among the loaded words,
// which would put the load back on the state chain.
__device__ __forceinline__ int lds(const int* p) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// Rows per tile of the tiled walk (two tiles of W + 2 fields x 32 frames:
// 40 KB at W = 8; 16 rows measured faster than 32 at W = 2).
#define VDT_WALK_TILE 16

#define VDT_WALK_AHEAD 4  // rows read from shared memory ahead of the chain

template <int W>
struct WalkRow {
  int w[W];
  int rot;
  int valid;
};

template <int W, bool ROTS, bool VALID>
__device__ __forceinline__ void read_row(
    WalkRow<W>& r, const int (*__restrict__ rowbuf)[W + 2][VDT_WALK_THREADS],
    int i, int f) {
#pragma unroll
  for (int w = 0; w < W; ++w) r.w[w] = lds(&rowbuf[i][w][f]);
  if constexpr (ROTS) r.rot = lds(&rowbuf[i][W][f]);
  if constexpr (VALID) r.valid = lds(&rowbuf[i][W + 1][f]);
}

// Copy the rows top, top-1, ... of one tile (GUARD: only `rows` of them)
// into dst by cp.async, as one commit group.
template <int W, bool ROTS, bool VALID, bool GUARD>
__device__ __forceinline__ void copy_tile(
    int (*__restrict__ dst)[W + 2][VDT_WALK_THREADS],
    const int* __restrict__ packed, const int* __restrict__ rots,
    const int* __restrict__ valid, int top, int rows, int B, int b, int f) {
  constexpr int TR = VDT_WALK_TILE;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (!GUARD || i < rows) {
      const int t = top - i;
      const int* src = packed + (size_t)t * W * B + b;
#pragma unroll
      for (int w = 0; w < W; ++w)
        cp_async4(&dst[i][w][f], src + (size_t)w * B);
      if constexpr (ROTS) cp_async4(&dst[i][W][f], rots + t);
      if constexpr (VALID) cp_async4(&dst[i][W + 1][f], valid + t);
    }
  }
  cp_async_commit();
}

// Walk the rows of one tile, newest first: row i of the tile is row
// top - i of the walk (GUARD: only the first `rows`).  SLOT: slot order,
// ROTS: streamed rotations (else the one-shot schedule in `sched`), VALID:
// a per-row valid mask.  Row i + VDT_WALK_AHEAD is read from shared memory
// before row i's chain runs, so the chain is ALU work only.
template <int W, bool SLOT, bool ROTS, bool VALID, bool GUARD>
__device__ __forceinline__ void walk_tile(
    const int (*__restrict__ rowbuf)[W + 2][VDT_WALK_THREADS], int f,
    int& s, int& sched, unsigned char*& out, size_t B, int rows, int n,
    int smask) {
  constexpr int TR = VDT_WALK_TILE;
  constexpr int AHEAD = VDT_WALK_AHEAD;
  WalkRow<W> ahead[AHEAD];
#pragma unroll
  for (int i = 0; i < AHEAD; ++i)
    read_row<W, ROTS, VALID>(ahead[i], rowbuf, i, f);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (GUARD && i >= rows) return;
    const WalkRow<W> cur = ahead[i % AHEAD];
    if (i + AHEAD < TR)
      read_row<W, ROTS, VALID>(ahead[i % AHEAD], rowbuf, i + AHEAD, f);
    int q = s;
    if constexpr (SLOT) {
      const int rot = ROTS ? cur.rot : sched;
      q = ((s >> rot) | (int)((unsigned)s << (n - rot))) & smask;
      if constexpr (!ROTS) sched = sched == 0 ? n - 1 : sched - 1;
    }
    const int widx = q >> 5;
    unsigned word = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) word = widx == w ? (unsigned)cur.w[w] : word;
    const int d = (int)((word >> (q & 31)) & 1u);
    *out = (unsigned char)d;
    out -= B;
    if (!VALID || cur.valid != 0) s = (s >> 1) | (d << (n - 1));
  }
}

// The tiled walk (W <= 8): one thread per frame, 32 frames a block.  Tile j
// (rows N-1-j*TR down) is copied by cp.async - every word of its rows, the
// rotation and the valid flag - into one of two shared buffers while tile
// j-1 is walked; a thread copies and reads only its own frame's column.
template <int W, bool SLOT, bool ROTS, bool VALID>
__global__ void __launch_bounds__(VDT_WALK_THREADS)
    chainback_tiled(const int* __restrict__ packed,
                    const int* __restrict__ start,
                    const int* __restrict__ rots,
                    const int* __restrict__ valid,
                    unsigned char* __restrict__ bits, int N, int B, int n) {
  constexpr int TR = VDT_WALK_TILE;
  __shared__ int buf[2][TR][W + 2][VDT_WALK_THREADS];
  const int f = threadIdx.x;
  const int b = blockIdx.x * VDT_WALK_THREADS + f;
  if (b >= B) return;
  const int smask = (1 << n) - 1;
  const int ntiles = (N + TR - 1) / TR;
  // copy tile j (rows past the oldest skipped); one commit group per tile
  auto issue = [&](int j) {
    const int top = N - 1 - j * TR;
    if (j >= ntiles)
      cp_async_commit();
    else if (top + 1 >= TR)
      copy_tile<W, ROTS, VALID, false>(buf[j & 1], packed, rots, valid, top,
                                       TR, B, b, f);
    else
      copy_tile<W, ROTS, VALID, true>(buf[j & 1], packed, rots, valid, top,
                                      top + 1, B, b, f);
  };
  issue(0);
  int s = start[b];
  int sched = N % n;  // the one-shot schedule: row t is rotated by (t+1) mod n
  unsigned char* out = bits + (size_t)(N - 1) * B + b;
  for (int j = 0; j < ntiles; ++j) {
    // tile j + 1 goes to the buffer tile j - 1 was walked from (its values
    // were read and used above, in this thread)
    issue(j + 1);
    cp_async_wait<1>();  // tile j has landed
    const int top = N - 1 - j * TR;
    if (top + 1 >= TR)
      walk_tile<W, SLOT, ROTS, VALID, false>(buf[j & 1], f, s, sched, out, B,
                                             TR, n, smask);
    else
      walk_tile<W, SLOT, ROTS, VALID, true>(buf[j & 1], f, s, sched, out, B,
                                            top + 1, n, smask);
  }
  cp_async_wait<0>();
}

// The dependent-load walk (W > 8): one thread per frame, the row's word
// loaded after the state that selects it is known.
__global__ void chainback_kernel(const int* __restrict__ packed,
                                 const int* __restrict__ start,
                                 const int* __restrict__ rots,
                                 const int* __restrict__ valid,
                                 unsigned char* __restrict__ bits, int N,
                                 int W, int B, int n, int slot_order) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int smask = (1 << n) - 1;
  int s = start[b];
  for (int t = N - 1; t >= 0; --t) {
    int q = s;
    if (slot_order) {
      const int rot = rots ? __ldg(rots + t) : (t + 1) % n;
      q = ((s >> rot) | (int)((unsigned)s << (n - rot))) & smask;
    }
    const int widx = q >> 5;
    const unsigned word =
        (widx >= 0 && widx < W)
            ? (unsigned)__ldg(packed + ((size_t)t * W + widx) * B + b)
            : 0u;
    const int d = (int)((word >> (q & 31)) & 1u);
    bits[(size_t)t * B + b] = (unsigned char)d;
    if (!valid || __ldg(valid + t) != 0) s = (s >> 1) | (d << (n - 1));
  }
}

extern "C" int vdt_chainback(const void* packed, const void* start,
                             const void* rots, const void* valid, void* bits,
                             int N, int W, int B, int K, int slot_order,
                             int tiled, void* stream) {
  // tiled != 0: the tiled walk (the wrapper's choice, W <= 8)
  const int n = K - 1;
  if (n < 1 || n > 30 || W < 1 || B < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pk = static_cast<const int*>(packed);
  const int* sa = static_cast<const int*>(start);
  const int* ro = static_cast<const int*>(rots);
  const int* va = static_cast<const int*>(valid);
  unsigned char* bi = static_cast<unsigned char*>(bits);
  if (tiled) {
    if (W > VDT_TILED_MAX_W || (W & (W - 1)) || (!slot_order && rots))
      return (int)cudaErrorInvalidValue;
    const int blocks = (B + VDT_WALK_THREADS - 1) / VDT_WALK_THREADS;
#define VDT_TILED(WW, SL, RO, VA)                                      \
  chainback_tiled<WW, SL, RO, VA><<<blocks, VDT_WALK_THREADS, 0, st>>>( \
      pk, sa, ro, va, bi, N, B, n)
#define VDT_TILED_MODES(WW)                                 \
  if (!slot_order) {                                        \
    if (va) VDT_TILED(WW, false, false, true);              \
    else VDT_TILED(WW, false, false, false);                \
  } else if (ro) {                                          \
    if (va) VDT_TILED(WW, true, true, true);                \
    else VDT_TILED(WW, true, true, false);                  \
  } else {                                                  \
    if (va) VDT_TILED(WW, true, false, true);               \
    else VDT_TILED(WW, true, false, false);                 \
  }
    switch (W) {
      case 1: VDT_TILED_MODES(1); break;
      case 2: VDT_TILED_MODES(2); break;
      case 4: VDT_TILED_MODES(4); break;
      default: VDT_TILED_MODES(8); break;
    }
#undef VDT_TILED_MODES
#undef VDT_TILED
    return (int)cudaGetLastError();
  }
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  chainback_kernel<<<blocks, threads, 0, st>>>(pk, sa, ro, va, bi, N, W, B,
                                                n, slot_order);
  return (int)cudaGetLastError();
}
