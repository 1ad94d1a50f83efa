// The row step shared by the two plane walks (plane_walk.cu and
// plane_walk_trunc.cu): one warp walks one chain of rows, 5 rows a group,
// with every candidate word of the group's rows loaded at once.
//
// The walk: row t reads slot q = rotr_n(s, rot_t), bit (q >> 7) & 31 of
// word ((q >> 12) << 7) | (q & 127) of the row, and the state becomes
// s' = (s >> 1) | (d << (n - 1)) unless the row is not valid, where it
// keeps s.  Each row's word depends on the bit the row above gave, so a
// chain is a series of dependent loads: one device-memory round trip a
// row when each row waits for the last.
//
// Group step.  At the top row t0 of a group the warp knows s.  The state
// before row t0 - j is s with the j path bits of rows t0 .. t0-j+1
// applied, so the group's kGroup = 5 rows have 31 candidate words, the
// nodes of a binary tree in heap order: node x's children are 2x + 1 (bit
// 0) and 2x + 2 (bit 1), so node 2^j - 1 + i is row t0 - j under path
// bits i (row t0's bit highest).  Lane l < 31 holds node l, computes its
// state, q and word address and issues its load: all loads of the group
// are in flight together, one round trip for 5 rows.  A ballot gathers
// the nodes' bits into every lane, and the rows resolve from it by
// shifts, x <- 2x + 1 + bit x, 5 steps whatever the group's row count g
// (nodes below row t0 - g + 1 load nothing and give 0, and only rows in
// the group move the state).  Five rows a group was measured against
// four (28% slower) and six (level, two loads a lane): PERF.md, PR 8.
//
// Off the chain: a node's rotation, row pointer and what its bits do to
// s (valid rows only: s_c = (s >> v) | c, c the node's bits at valid rows
// placed at the top) depend only on the rows, so the next group's are
// computed while this group's words are in flight, and so is the store
// of the group before.  That code is straight-line (rots and valid are
// template parameters, the last group's set-up is clamped, not skipped),
// so the compiler can place it between the loads and their first use.
// Bits go out 32 rows at a time: lane l holds the bit of row chunk + l of
// the current 32-row chunk and stores it as one byte when the chunk is
// done, a coalesced 32-byte store.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace plane_walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 5;                   // rows a group
constexpr int kNodes = (1 << kGroup) - 1;  // candidate words a group

// This lane's node of a group: its row, the rotation of that row, and
// what its path bits do to the group's entry state.
struct Node {
  const int* row;  // the node's row; null when it lies below the group
  int rot, nrot;   // rotation and n - rotation
  int v, c;        // s_c = (s >> v) | c
};

struct Group {
  Node node;
  unsigned vmask;  // bit m: row t0 - m is in the group and valid
};

// Set-up of the group whose top row is t0 with g >= 0 rows; rot_top is
// row t0's rotation when there are no rots.  The lane's node is at depth
// nj with path ni.  All lanes call it (a ballot).
template <bool ROTS, bool VALID>
__device__ __forceinline__ Group group_setup(
    const int* __restrict__ pf, int W, int n, int t0, int g, int rot_top,
    const int* __restrict__ rots, const int* __restrict__ valid, int nj,
    int ni) {
  const int lane = threadIdx.x & 31;
  Group grp;
  grp.vmask = (1u << g) - 1u;
  if constexpr (VALID) {
    const bool ok = lane < g && __ldg(valid + max(t0 - lane, 0)) != 0;
    grp.vmask &= __ballot_sync(kFull, ok);
  }
  const int t = max(t0 - nj, 0);
  Node& nd = grp.node;
  nd.row = nj < g ? pf + (size_t)t * W : nullptr;
  int rot = rot_top - nj;
  if (rot < 0) rot += n;
  if constexpr (ROTS) rot = __ldg(rots + t);
  nd.rot = rot;
  nd.nrot = n - rot;
  // the node's bits at the valid rows above it, in the order they enter
  // the state (row t0's first, so lowest)
  int v = 0, c = 0;
#pragma unroll
  for (int m = 0; m < kGroup - 1; ++m) {
    if (m < nj && ((grp.vmask >> m) & 1u)) {
      c |= ((ni >> (nj - 1 - m)) & 1) << v;
      ++v;
    }
  }
  nd.v = v;
  nd.c = c << (n - v);
  return grp;
}

// Walk rows [lo, hi) of one frame from state s, newest to oldest, and
// store the bit of each row r in [emit_lo, emit_hi) at out[r - emit_off].
// All 32 lanes of the warp call it with the same arguments.
template <bool ROTS, bool VALID>
__device__ __forceinline__ void walk_chain(
    const int* __restrict__ pf, int W, int n, int s, int lo, int hi,
    const int* __restrict__ rots, const int* __restrict__ valid,
    unsigned char* __restrict__ out, int emit_lo, int emit_hi,
    int emit_off) {
  const int lane = threadIdx.x & 31;
  const int smask = (1 << n) - 1;
  // lane 31 holds no node: kGroup marks it never in a group
  const int nj = lane < kNodes ? 31 - __clz(lane + 1) : kGroup;
  const int ni = lane < kNodes ? lane + 1 - (1 << nj) : 0;
  if (hi <= lo) return;
  // The 32-row chunk whose bits the lanes hold, and this lane's bit of row
  // chunk + lane.  emit() takes a resolved group: top row et, lowest row
  // glo, path bits ei (row et's highest).  A group spans at most two
  // chunks, and completes the second only when it is the chain's last.
  int chunk = (hi - 1) & ~31;
  int mine = 0;
  auto emit = [&](int et, int glo, int ei) {
    int r = chunk + lane;
    if (r >= glo && r <= et) mine = (ei >> (r - glo)) & 1;
    bool done = glo <= max(chunk, lo);
    if (done && r >= emit_lo && r < emit_hi)
      out[r - emit_off] = (unsigned char)mine;
    chunk -= done ? 32 : 0;
    r = chunk + lane;
    if (done && r >= glo && r <= et) mine = (ei >> (r - glo)) & 1;
    done = done && glo <= max(chunk, lo);
    if (done && r >= emit_lo && r < emit_hi)
      out[r - emit_off] = (unsigned char)mine;
    chunk -= done ? 32 : 0;
  };
  int t0 = hi - 1;
  int g = min(kGroup, t0 - lo + 1);
  int rot_top = hi % n;  // (t0 + 1) mod n
  Group cur = group_setup<ROTS, VALID>(pf, W, n, t0, g, rot_top, rots,
                                       valid, nj, ni);
  // the group before, still to emit: none yet (a group above the chunk)
  int et = hi + 31, eg = 0, ei = 0;
  for (;;) {
    // the group's candidate words: one round trip
    const Node& nd = cur.node;
    const int sc = (s >> nd.v) | nd.c;
    const int q = ((sc >> nd.rot) | (int)((unsigned)sc << nd.nrot)) & smask;
    const int shift = (q >> 7) & 31;
    const unsigned word =
        nd.row ? (unsigned)__ldg(nd.row + ((q >> 12) << 7) + (q & 127)) : 0u;
    // while the words are in flight: the group before's bits and the
    // next group's set-up
    emit(et, et - eg + 1, ei);
    const int tn = t0 - g;
    const int gn = min(kGroup, tn - lo + 1);
    int rot_next = rot_top - g;
    if (rot_next < 0) rot_next += n;
    const Group nxt = group_setup<ROTS, VALID>(pf, W, n, tn, max(gn, 0),
                                               rot_next, rots, valid, nj, ni);
    // every node's bit in every lane, then kGroup steps down the tree
    const unsigned bal = __ballot_sync(kFull, (word >> shift) & 1u);
    int x = 0;
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      const int d = (int)(bal >> x) & 1;
      x = 2 * x + 1 + d;
      if ((cur.vmask >> m) & 1u) s = (s >> 1) | (d << (n - 1));
    }
    et = t0;
    eg = g;
    ei = (x - kNodes) >> (kGroup - g);
    if (gn <= 0) break;
    t0 = tn;
    g = gn;
    rot_top = rot_next;
    cur = nxt;
  }
  emit(et, et - eg + 1, ei);
}

}  // namespace plane_walk
