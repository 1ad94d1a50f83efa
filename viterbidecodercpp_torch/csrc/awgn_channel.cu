// A BER batch's channel in one pass: the convolutional encoder with its
// K-1 zero tail, BPSK, AWGN from noise already drawn, and the quantiser to
// the soft-decision range (Hopper).
//
// Replaces no TPU kernel.  On the TPU, XLA fuses the JAX package's
// encode -> modulate -> add noise -> quantise chain (utils/testsig.py,
// ops/encoder.py) into a few passes; eager torch runs it as ~30 kernels,
// most of them full passes over the batch's bits or symbols.  This kernel
// computes, for frame b, step t < T = N + K - 1 and rate r < R, with
// x[t] the data bit (zero before step 0 and on the K-1 tail steps) and
// reg_t = sum_i x[t - i] << i (i < K; bit i of G taps the input i steps
// back):
//   s     = parity(G[r] & reg_t) ? +1 : -1
//   noisy = s + sigma * n[b, t, r]
//   y     = noisy * scale + mean
//   q     = y >= 0 ? floor(y + 0.5) : ceil(y - 0.5)     (std::round)
//   out   = (int)clamp(q, low, high)
// each operation rounded to float32 on its own, as the plain chain's torch
// ops round (the _rn intrinsics keep -fmad from contracting them into an
// FMA).  sigma, scale = f32(mag) * norm and mean are 0-d float32 tensors
// the wrapper made with the plain chain's own torch ops, read here from
// device memory, so the host neither reads nor recomputes them.
//
// What bounds it on the H100: bytes.  It reads the noise (4 B a symbol) and
// the data bits (1 B a step) and writes the int32 symbols (4 B a symbol):
// at Voyager's B = 16384 x 2048 bits, 33.6 MB + 269.2 MB + 269.2 MB, 0.171
// ms at 3.35 TB/s.  The encoder's work is a few integer operations a
// symbol.
//
// Design: a block takes one frame's tile of about VDT_CH_TILE symbols
// (whole steps, the tiles of a frame balanced).  Each thread first starts
// its loads of noise, VDT_CH_VEC float4s in the (B, T, R) order of the
// noise and the output, neighbouring threads on neighbouring addresses, so
// that they are in flight while the warps pack the tile's input bits, and
// the K-1 before it, into 32-bit words in shared memory with
// __ballot_sync (one coalesced byte load a lane).  A step's K-bit
// register is then a funnel shift of two words and a bit reversal, made
// once a step, and an output bit one popc; each thread stores its symbols
// as int4s.  Where a frame's symbols do not start on a 16-byte boundary,
// at most three scalar symbols at each end of a tile go one a thread.  At
// the cell's shape it runs at about 70% of the bound, and at 85% of the
// rate at which a plain device copy of the noise reads and writes.

#include <cuda_runtime.h>

// 64 threads a block, two float4s a thread: measured faster than 32, 96,
// 128 and 256 threads and than one, three or four float4s a thread.
#define VDT_CH_THREADS 64
#define VDT_CH_VEC 2  // float4s a thread loads before the bits are packed
// symbols a block (whole steps; a tile may pass it by less than one step)
#define VDT_CH_TILE (4 * VDT_CH_THREADS * VDT_CH_VEC)
#define VDT_CH_MAX_K 32  // a step's register is one 32-bit word

struct ChannelArgs {
  const unsigned char* bits;  // (B, N) data bits
  const float* noise;         // (B, T, R), 16-byte aligned
  int* out;                   // (B, T, R), 16-byte aligned
  const int* g;               // (R,) taps
  const float* sigma;         // 0-d
  const float* scale;         // 0-d
  const float* mean;          // 0-d
  int N, T, R, K;
  int tile_steps, tiles;      // steps a tile, tiles a frame
  int low, high;
};

// The K-bit register of tile step u: stream bit k of the tile is
// x[t0 - (K-1) + k], so bits u .. u+K-1 are x[t-K+1] .. x[t], the oldest
// at the bottom; reversed, bit i is x[t-i].
__device__ __forceinline__ unsigned step_register(const unsigned* words,
                                                  int K, int u) {
  const int w = u >> 5;
  const unsigned long long v =
      (unsigned long long)words[w] | ((unsigned long long)words[w + 1] << 32);
  return __brev((unsigned)(v >> (u & 31)) << (32 - K));
}

// The channel symbol of a step's register at tap g, from noise value n.
// round_half_away(y) is floor(y + 0.5) for y >= 0 and ceil(y - 0.5) below:
// both are the truncation of y + copysign(0.5, y) rounded to float32 (y =
// -0 gives -0.5 and 0, as floor(0.5) does), and a truncated value outside
// [low, high] clamps to the same int in float or after the conversion.
__device__ __forceinline__ int channel_symbol(unsigned reg, unsigned g,
                                              float n, float sigma,
                                              float scale, float mean,
                                              int low, int high) {
  const float s = (__popc(g & reg) & 1) ? 1.0f : -1.0f;
  const float noisy = __fadd_rn(s, __fmul_rn(sigma, n));
  const float y = __fadd_rn(__fmul_rn(noisy, scale), mean);
  const int q = __float2int_rz(__fadd_rn(y, copysignf(0.5f, y)));
  return min(max(q, low), high);
}

// Four symbols from tile symbol j on.
__device__ __forceinline__ int4 channel_symbols4(
    const unsigned* words, const unsigned* g, int K, int R, int j, float4 n,
    float sigma, float scale, float mean, int low, int high) {
  int u = j / R, r = j - u * R;
  unsigned reg = step_register(words, K, u);
  const float nv[4] = {n.x, n.y, n.z, n.w};
  int q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] = channel_symbol(reg, g[r], nv[k], sigma, scale, mean, low, high);
    if (++r == R && k < 3) {
      r = 0;
      reg = step_register(words, K, ++u);
    }
  }
  return make_int4(q[0], q[1], q[2], q[3]);
}

__global__ void __launch_bounds__(VDT_CH_THREADS)
    awgn_channel(const ChannelArgs a) {
  extern __shared__ unsigned smem[];
  unsigned* g = smem;            // (R,) taps
  unsigned* words = smem + a.R;  // the tile's input bits, 32 a word
  const int b = blockIdx.x / a.tiles;
  const int t0 = (blockIdx.x - b * a.tiles) * a.tile_steps;
  const int steps = min(a.tile_steps, a.T - t0);
  const int R = a.R, K = a.K;
  const long long e0 = ((long long)b * a.T + t0) * R;  // the tile's symbols
  const long long e1 = e0 + (long long)steps * R;
  const long long a0 = min((e0 + 3) & ~3LL, e1);      // the 16-byte body
  const long long a1 = max(e1 & ~3LL, a0);
  const int head = (int)(a0 - e0), tail = (int)(e1 - a1);
  const float4* n4 = reinterpret_cast<const float4*>(a.noise);
  int4* o4 = reinterpret_cast<int4*>(a.out);
  const long long i0 = (a0 >> 2) + threadIdx.x, i1 = a1 >> 2;

  // the noise first: its loads are in flight while the bits are packed
  float4 nv[VDT_CH_VEC];
#pragma unroll
  for (int k = 0; k < VDT_CH_VEC; ++k)
    if (i0 + k * VDT_CH_THREADS < i1) nv[k] = n4[i0 + k * VDT_CH_THREADS];
  const bool edge = (int)threadIdx.x < head + tail;
  const long long ee = (int)threadIdx.x < head
                           ? e0 + threadIdx.x
                           : a1 + ((int)threadIdx.x - head);
  const float ne = edge ? a.noise[ee] : 0.0f;

  for (int i = threadIdx.x; i < R; i += VDT_CH_THREADS)
    g[i] = (unsigned)a.g[i];
  // the windows of steps 0 .. steps-1 reach stream bit steps + K - 2, in
  // word (steps - 1) / 32 + 1 at most (K - 1 <= 31)
  const int nwords = ((steps - 1) >> 5) + 2;
  const unsigned char* x = a.bits + (long long)b * a.N;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int w = threadIdx.x >> 5; w < nwords; w += VDT_CH_THREADS / 32) {
    const int s = t0 - (K - 1) + (w << 5) + lane;
    const int bit = (s >= 0 && s < a.N) ? (x[s] & 1) : 0;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) words[w] = word;
  }
  __syncthreads();

  const float sigma = *a.sigma, scale = *a.scale, mean = *a.mean;
  if (edge) {
    const int j = (int)(ee - e0);
    const int u = j / R;
    a.out[ee] = channel_symbol(step_register(words, K, u), g[j - u * R], ne,
                               sigma, scale, mean, a.low, a.high);
  }
#pragma unroll
  for (int k = 0; k < VDT_CH_VEC; ++k) {
    const long long i = i0 + k * VDT_CH_THREADS;
    if (i < i1)
      o4[i] = channel_symbols4(words, g, K, R, (int)((i << 2) - e0), nv[k],
                               sigma, scale, mean, a.low, a.high);
  }
  // the rest of a tile past VDT_CH_TILE symbols (by less than one step)
  for (long long i = i0 + VDT_CH_VEC * VDT_CH_THREADS; i < i1;
       i += VDT_CH_THREADS)
    o4[i] = channel_symbols4(words, g, K, R, (int)((i << 2) - e0), n4[i],
                             sigma, scale, mean, a.low, a.high);
}

extern "C" int vdt_awgn_channel(const void* bits, const void* noise,
                                void* out, const void* g, const void* sigma,
                                const void* scale, const void* mean, int B,
                                int N, int K, int R, int low, int high,
                                void* stream) {
  if (B < 1 || N < 0 || K < 2 || K > VDT_CH_MAX_K || R < 1 ||
      ((unsigned long long)noise & 15) || ((unsigned long long)out & 15))
    return (int)cudaErrorInvalidValue;
  ChannelArgs a;
  a.bits = static_cast<const unsigned char*>(bits);
  a.noise = static_cast<const float*>(noise);
  a.out = static_cast<int*>(out);
  a.g = static_cast<const int*>(g);
  a.sigma = static_cast<const float*>(sigma);
  a.scale = static_cast<const float*>(scale);
  a.mean = static_cast<const float*>(mean);
  a.N = N;
  a.T = N + K - 1;
  a.R = R;
  a.K = K;
  a.low = low;
  a.high = high;
  // tiles of whole steps, at most VDT_CH_TILE symbols unless a step alone
  // has more, balanced over the frame
  const long long syms = (long long)a.T * R;
  long long tiles = (syms + VDT_CH_TILE - 1) / VDT_CH_TILE;
  if (tiles > a.T) tiles = a.T;
  a.tile_steps = (int)((a.T + tiles - 1) / tiles);
  a.tiles = (a.T + a.tile_steps - 1) / a.tile_steps;
  const long long blocks = (long long)B * a.tiles;
  const size_t smem =
      (size_t)(R + ((a.tile_steps - 1) >> 5) + 2) * sizeof(unsigned);
  if (blocks > 0x7fffffffLL || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  awgn_channel<<<(unsigned)blocks, VDT_CH_THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
