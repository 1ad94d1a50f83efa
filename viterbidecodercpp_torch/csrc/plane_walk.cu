// Frame-major traceback walk over plane decision rows (Hopper).
//
// Replaces the JAX package's TPU kernel ops/bigstate_pallas.py
// (_make_walk_kernel, launched by _walk_frames_padded; wrapped by
// walk_plane_frames, which chainback_plane uses).  It computes what that
// kernel does: one walk state per frame, rows newest to oldest; row t
// reads slot q = rotr_n(s, rot) with rot = rots[t] (or (t + 1) mod n when
// no rots are given), and the decision bit is bit (q >> 7) & 31 of word
// [b, t, (q >> 7) >> 5, q & 127] of the (B, n_phys, WRr, 128) buffer;
// s <- (s >> 1) | (d << (n - 1)) unless valid[t] == 0, where the row
// emits its bit and keeps the state.  Every row emits its bit.
//
// What bounds it on the H100: dependent-load latency.  The word a row
// reads depends on the state the row before produced, and a Cassini
// decision buffer (2 KB a row a frame, 2.16 GB at B=512 T=2062) is far
// past the 50 MB L2, so a walk that waits for each row pays a
// device-memory round trip a row (~700 ns measured: 1.42-1.46 ms for 2062
// rows); more frames or more SMs do not shorten a chain.  The bytes
// bound (the one word a row a frame the path needs) stays out of reach
// of any dependent chain.
//
// Design: one warp per frame, 5 rows a group (plane_walk_group.cuh): the
// 31 candidate words of the group's rows are loaded at once, one round
// trip for 5 rows, and the rows resolve from a ballot of their bits.
// Speculation reads up to 31 sectors a group where the path needs 5
// words: ~0.2 GB at B=512, well under the round trips' time.  The rows of a frame are n_phys apart, so the kernel walks a
// window [0, N) of a larger buffer in place (the decoder's padded rows
// are never read); the bits go out (B, N) 32 rows at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "plane_walk_group.cuh"

constexpr int kWarps = 4;  // frames a block

template <bool ROTS, bool VALID>
__global__ void __launch_bounds__(32 * kWarps)
    plane_walk_kernel(const int* __restrict__ packed,
                      const int* __restrict__ start,
                      const int* __restrict__ rots,
                      const int* __restrict__ valid,
                      unsigned char* __restrict__ bits, int N, int n_phys,
                      int B, int n) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const int W = 1 << (n - 5);  // words per row: WRr * 128
  plane_walk::walk_chain<ROTS, VALID>(
      packed + (size_t)b * n_phys * W, W, n, __ldg(start + b), 0, N, rots,
      valid, bits + (size_t)b * N, 0, N, 0);
}

extern "C" int vdt_plane_walk(const void* packed, const void* start,
                              const void* rots, const void* valid, void* bits,
                              int N, int n_phys, int B, int K, void* stream) {
  const int n = K - 1;
  if (n < 13 || n > 30 || B < 1 || N < 0 || N > n_phys)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(packed);
  const int* st = static_cast<const int*>(start);
  const int* r = static_cast<const int*>(rots);
  const int* v = static_cast<const int*>(valid);
  unsigned char* out = static_cast<unsigned char*>(bits);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kWarps - 1) / kWarps;
  const int threads = 32 * kWarps;
  if (r && v)
    plane_walk_kernel<true, true><<<blocks, threads, 0, cs>>>(
        p, st, r, v, out, N, n_phys, B, n);
  else if (r)
    plane_walk_kernel<true, false><<<blocks, threads, 0, cs>>>(
        p, st, r, v, out, N, n_phys, B, n);
  else if (v)
    plane_walk_kernel<false, true><<<blocks, threads, 0, cs>>>(
        p, st, r, v, out, N, n_phys, B, n);
  else
    plane_walk_kernel<false, false><<<blocks, threads, 0, cs>>>(
        p, st, r, v, out, N, n_phys, B, n);
  return (int)cudaGetLastError();
}
