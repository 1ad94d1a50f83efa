// Block-parallel truncated traceback over plane decision rows (Hopper).
//
// Replaces the JAX package's TPU kernel ops/bigstate_pallas.py
// (_make_walk_trunc_kernel, launched by _walk_trunc_padded; wrapped by
// chainback_plane_truncated) and reproduces its bits exactly, cold starts
// included.  With total_rows = total_bits + n and L = block, O = overlap,
// tile t walks rows t*L + i for i = L+O-1 down to 0; a row at or past
// total_rows is skipped (state held, bit never committed).  Its start
// state is end_state[b] when t*L + L + O >= total_rows (the window
// reaches the stream's end, so the walk is exact) and 0 otherwise (the
// survivors merge over the O overlap rows).  Row r reads slot
// q = rotr_n(s, rots[r]) (or (r + 1) mod n), bit (q >> 7) & 31 of word
// [b, r, (q >> 7) >> 5, q & 127].  The tile commits rows [t*L, t*L + L),
// and the output holds rows [n, total_rows) as (B, total_bits) bits.
//
// What bounds it on the H100: dependent-load latency, as in the exact
// walk, but each chain is only L + O rows long and there are
// B * ceil(total_rows / L) chains in flight instead of B.  The price is
// re-reading O rows per tile.
//
// Design: one thread per (frame, tile), frames on consecutive threads;
// each thread writes its committed bits straight to their place in the
// (B, total_bits) output, so no slicing pass follows.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void plane_walk_trunc_kernel(const int* __restrict__ packed,
                                        const int* __restrict__ ends,
                                        const int* __restrict__ rots,
                                        unsigned char* __restrict__ bits,
                                        int B, int NB, int n_phys, int n,
                                        int total_bits, int L, int O) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * NB) return;
  const int b = idx % B;
  const int tile = idx / B;
  const int smask = (1 << n) - 1;
  const int W = 1 << (n - 5);  // words per row: WRr * 128
  const int total_rows = total_bits + n;
  const int lo = tile * L;
  const int* pf = packed + (size_t)b * n_phys * W;
  unsigned char* out = bits + (size_t)b * total_bits;
  int s = lo + L + O >= total_rows ? ends[b] : 0;
  const int top = min(L + O, total_rows - lo);  // rows past the end skip
  for (int i = top - 1; i >= 0; --i) {
    const int r = lo + i;
    const int rot = rots ? __ldg(rots + r) : (r + 1) % n;
    const int q = ((s >> rot) | (int)((unsigned)s << (n - rot))) & smask;
    const int row = q >> 7;
    const unsigned word =
        (unsigned)__ldg(pf + (size_t)r * W + ((row >> 5) << 7) + (q & 127));
    const int d = (int)((word >> (row & 31)) & 1u);
    s = (s >> 1) | (d << (n - 1));
    if (i < L && r >= n) out[r - n] = (unsigned char)d;
  }
}

extern "C" int vdt_plane_walk_trunc(const void* packed, const void* ends,
                                    const void* rots, void* bits, int B,
                                    int n_phys, int K, int total_bits,
                                    int block, int overlap, void* stream) {
  const int n = K - 1;
  const long long total_rows = (long long)total_bits + n;
  if (n < 13 || n > 30 || B < 1 || total_bits < 0 || block < 1 ||
      overlap < 0 || total_rows > n_phys)
    return (int)cudaErrorInvalidValue;
  const int NB = (int)((total_rows + block - 1) / block);
  const long long work = (long long)B * NB;
  if (work > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (int)((work + threads - 1) / threads);
  plane_walk_trunc_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<const int*>(ends),
      static_cast<const int*>(rots), static_cast<unsigned char*>(bits), B, NB,
      n_phys, n, total_bits, block, overlap);
  return (int)cudaGetLastError();
}
