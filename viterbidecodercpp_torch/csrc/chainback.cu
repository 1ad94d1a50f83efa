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
// What bounds it on the H100: the walk is a chain of dependent loads, one
// per row per frame - the word to read depends on the state the previous
// row produced - so its time is rows x load latency, not bandwidth; the
// whole decision tensor is read about once (one word per row per frame).
//
// Design: one thread per frame, frames on consecutive threads, so the
// row's words of neighbouring frames are neighbouring addresses and the
// bit stores coalesce.  Nothing is staged: at bring-up the chain latency
// is accepted and measured.

#include <cstdint>
#include <cuda_runtime.h>

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
                             void* stream) {
  const int n = K - 1;
  if (n < 1 || n > 30 || W < 1 || B < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  chainback_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<const int*>(start),
      static_cast<const int*>(rots), static_cast<const int*>(valid),
      static_cast<unsigned char*>(bits), N, W, B, n, slot_order);
  return (int)cudaGetLastError();
}
