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
// walk (plane_walk.cu), but each chain is only L + O rows long and there
// are B * ceil(total_rows / L) chains in flight instead of B.  Once the
// chains run in one wave, bytes start to count too: speculation reads up
// to 31 sectors a 5-row group, ~0.3 GB for Cassini's 2560 chains at B=512
// (~0.1 ms at 3.35 TB/s, the order of the round trips' time).
//
// Design: one warp per (frame, tile), frames on consecutive warps, on the
// exact walk's group step (plane_walk_group.cuh): 5 rows a round trip.
// Each warp writes its committed bits straight to their place in the
// (B, total_bits) output, 32 rows at a time, so no slicing pass follows.

#include <cstdint>
#include <cuda_runtime.h>

#include "plane_walk_group.cuh"

constexpr int kWarps = 4;  // chains a block

template <bool ROTS>
__global__ void __launch_bounds__(32 * kWarps)
    plane_walk_trunc_kernel(const int* __restrict__ packed,
                            const int* __restrict__ ends,
                            const int* __restrict__ rots,
                            unsigned char* __restrict__ bits, int B, int NB,
                            int n_phys, int n, int total_bits, int L, int O) {
  const int idx = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (idx >= B * NB) return;  // a whole warp
  const int b = idx % B;
  const int tile = idx / B;
  const int W = 1 << (n - 5);  // words per row: WRr * 128
  const int total_rows = total_bits + n;
  const int lo = tile * L;
  const long long top = (long long)lo + L + O;
  // rows past the end skip; the tile commits rows [lo, lo + L) from row n
  const int hi = (int)min(top, (long long)total_rows);
  const int commit_hi = (int)min((long long)lo + L, (long long)hi);
  const int s = top >= total_rows ? __ldg(ends + b) : 0;
  plane_walk::walk_chain<ROTS, false>(
      packed + (size_t)b * n_phys * W, W, n, s, lo, hi, rots, nullptr,
      bits + (size_t)b * total_bits, max(lo, n), commit_hi, n);
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
  const int blocks = (int)((work + kWarps - 1) / kWarps);
  const int* p = static_cast<const int*>(packed);
  const int* e = static_cast<const int*>(ends);
  const int* r = static_cast<const int*>(rots);
  unsigned char* out = static_cast<unsigned char*>(bits);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (r)
    plane_walk_trunc_kernel<true><<<blocks, 32 * kWarps, 0, cs>>>(
        p, e, r, out, B, NB, n_phys, n, total_bits, block, overlap);
  else
    plane_walk_trunc_kernel<false><<<blocks, 32 * kWarps, 0, cs>>>(
        p, e, r, out, B, NB, n_phys, n, total_bits, block, overlap);
  return (int)cudaGetLastError();
}
