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
// reads depends on the state the previous row produced, so each frame is
// a chain of N loads, and the time is N x memory latency; one word of
// each row of each frame is read, a small fraction of the buffer.
//
// Design: one thread per frame.  The TPU kernel's word-row select tree
// and lane broadcast (a 128-lane matmul by ones) exist to pick one word
// out of a vector tile; a thread just loads the word it needs.  The
// rows of a frame are n_phys apart, so the kernel walks a window
// [0, N) of a larger buffer in place (the decoder's padded rows are
// never read).  The bits are stored (B, N) row by row.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void plane_walk_kernel(const int* __restrict__ packed,
                                  const int* __restrict__ start,
                                  const int* __restrict__ rots,
                                  const int* __restrict__ valid,
                                  unsigned char* __restrict__ bits, int N,
                                  int n_phys, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int smask = (1 << n) - 1;
  const int W = 1 << (n - 5);  // words per row: WRr * 128
  const int* pf = packed + (size_t)b * n_phys * W;
  unsigned char* out = bits + (size_t)b * N;
  int s = start[b];
  for (int t = N - 1; t >= 0; --t) {
    const int rot = rots ? __ldg(rots + t) : (t + 1) % n;
    const int q = ((s >> rot) | (int)((unsigned)s << (n - rot))) & smask;
    const int row = q >> 7;
    const unsigned word =
        (unsigned)__ldg(pf + (size_t)t * W + ((row >> 5) << 7) + (q & 127));
    const int d = (int)((word >> (row & 31)) & 1u);
    out[t] = (unsigned char)d;
    if (!valid || __ldg(valid + t) != 0) s = (s >> 1) | (d << (n - 1));
  }
}

extern "C" int vdt_plane_walk(const void* packed, const void* start,
                              const void* rots, const void* valid, void* bits,
                              int N, int n_phys, int B, int K, void* stream) {
  const int n = K - 1;
  if (n < 13 || n > 30 || B < 1 || N < 0 || N > n_phys)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  plane_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<const int*>(start),
      static_cast<const int*>(rots), static_cast<const int*>(valid),
      static_cast<unsigned char*>(bits), N, n_phys, B, n);
  return (int)cudaGetLastError();
}
