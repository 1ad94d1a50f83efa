"""A plain reference for LTE's tail-biting convolutional code: the encoder
and the rate matching of 3GPP TS 36.212 (5.1.3.1, 5.1.4.2), written from
the standard's equations, and the circular Viterbi decode in plain
torch, written from the trellis rules alone.

It imports torch only: nothing of ``viterbidecodercpp_torch``, nothing
of the JAX package.  ``bench_port/reference/tailbiting.py`` is a frozen
copy of it.

Encoder (36.212 5.1.3.1): the generators are given as in the standard,
octal 133, 171 and 165 with the most significant of their 7 bits the tap
of the current input c_k, and d_k^(i) = sum_j g_i(j) c_((k - j) mod L)
mod 2.  The shift register starts from the frame's last 6 bits.

Rate matching (36.212 5.1.4.2): each stream d^(i) goes through the
32-column sub-block interleaver (dummy bits first, rows written in
turn, columns permuted by Table 5.1.4-2, read out column by column);
the three read-outs are concatenated into w, and e_k is the k-th bit of
w, read circularly, that is not a dummy bit.

Decode, with the arithmetic of ``bench_port/reference/viterbi.py``:

  * a state is the last K-1 input bits, newest at bit 0; from
    predecessor ``p = (s >> 1) | (b << (K-2))`` into state ``s`` the
    register ``s | (b << (K-1))`` is put through the polynomials G
    (bit i of G taps the input i steps back), output bit r being
    ``parity(G[r] & register)``;
  * a branch metric is the sum over the R symbols of ``|level - symbol|``,
    ``high`` for an output bit 1 and ``low`` for 0, the symbols clamped
    to [low, high] first;
  * saturating arithmetic clamps a candidate to the metric maximum and a
    tie keeps the predecessor with leading bit 1; wrapping masks it and a
    tie keeps leading bit 0;
  * after each step, where state 0's metric has reached the threshold,
    the frame's minimum is subtracted from every state and added to its
    accumulated total;
  * tail-biting: every state starts at the same metric (``init_start``),
    the trellis runs over the frame three times in a row, the walk starts
    at the first state of least metric after step 3L, and the decoded
    bits are the inputs of steps [L, 2L) along that path.  The decision
    bit read at row t is the input of step t - (K-1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["DECODE_TYPES", "OCTAL_GENERATORS", "COLUMN_PERMUTATION",
           "Trellis", "trellis", "encode", "rate_match_positions", "match",
           "dematch", "decode"]

# decode type -> (soft high, soft low, error-margin scale, metric bits)
DECODE_TYPES = {"SOFT16": (127, -127, 5, 16),
                "SOFT8": (3, -3, 2, 8),
                "HARD8": (1, -1, 3, 8)}

# 36.212 5.1.3.1: G0, G1, G2 in octal, as the standard writes them
OCTAL_GENERATORS = ("133", "171", "165")

# 36.212 Table 5.1.4-2, the inter-column permutation of the sub-block
# interleaver for convolutionally coded channels
COLUMN_PERMUTATION = (1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23,
                      15, 31, 0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6,
                      22, 14, 30)


def encode(bits: torch.Tensor,
           generators: Sequence[str] = OCTAL_GENERATORS) -> torch.Tensor:
    """(N, L) information bits c -> (N, L, 3) coded bits d^(0..2)."""
    N, L = bits.shape
    c = bits.to(torch.int64)
    outs = []
    for octal in generators:
        g = [int(ch) for ch in format(int(octal, 8), "07b")]  # g(0)..g(6)
        d = torch.zeros(N, L, dtype=torch.int64, device=bits.device)
        for j in range(7):
            if g[j]:
                # c_((k - j) mod L) for every k
                d += c[:, (torch.arange(L, device=bits.device) - j) % L]
        outs.append(d % 2)
    return torch.stack(outs, dim=-1)


def _interleave(D: int) -> list:
    """One stream's sub-block interleaver read-out: for each of the K_pi
    output bits, the index k of the d_k it carries, or None (a dummy)."""
    C = 32
    R = -(-D // C)
    N_D = R * C - D
    y = [None] * N_D + list(range(D))          # written row by row
    return [y[r * C + COLUMN_PERMUTATION[j]]   # read column by column
            for j in range(C) for r in range(R)]


def rate_match_positions(L: int, E: int, R: int = 3) -> list:
    """The E sent bits e_k as mother-code positions ``k * R + i`` of
    d_k^(i) (the decoder's symbol order)."""
    v = _interleave(L)
    w = [None if k is None else k * R + i for i in range(R) for k in v]
    e, j = [], 0
    while len(e) < E:
        if w[j % len(w)] is not None:
            e.append(w[j % len(w)])
        j += 1
    return e


def match(coded: torch.Tensor, E: int) -> torch.Tensor:
    """(N, L, R) coded bits -> (N, E) sent bits."""
    N, L, R = coded.shape
    pos = torch.tensor(rate_match_positions(L, E, R), device=coded.device)
    return coded.reshape(N, L * R)[:, pos]


def dematch(soft: torch.Tensor, L: int, low: int, high: int,
            R: int = 3) -> torch.Tensor:
    """(N, E) received soft values -> (N, L * R) int32 soft symbols: the
    copies of each position summed, clamped to [low, high]; 0 where a
    position was never sent."""
    N, E = soft.shape
    out = torch.zeros(N, L * R, dtype=torch.int64, device=soft.device)
    for k, p in enumerate(rate_match_positions(L, E, R)):
        out[:, p] += soft[:, k].to(torch.int64)
    return out.clamp(low, high).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Trellis:
    K: int
    G: Tuple[int, ...]
    high: int
    low: int
    metric_max: int
    init_start: int
    threshold: int
    saturating: bool

    @property
    def R(self) -> int:
        return len(self.G)

    @property
    def S(self) -> int:
        return 1 << (self.K - 1)


def trellis(K: int, G: Sequence[int], decode_type: str,
            arith: str = "saturating",
            metric_bits: Optional[int] = None) -> Trellis:
    """The trellis constants of a code under a decode type;
    ``metric_bits`` overrides the type's metric width."""
    if arith not in ("saturating", "wrapping"):
        raise ValueError(f"unknown arithmetic {arith!r}")
    high, low, scale, bits = DECODE_TYPES[decode_type]
    metric_max = (1 << (metric_bits or bits)) - 1
    # the margin is computed in the narrow unsigned metric type
    margin = ((high - low) * len(G) * scale) & metric_max
    return Trellis(K=int(K), G=tuple(int(g) & ((1 << K) - 1) for g in G),
                   high=high, low=low, metric_max=metric_max, init_start=0,
                   threshold=metric_max - margin,
                   saturating=arith == "saturating")


def _parity(x: torch.Tensor) -> torch.Tensor:
    p = torch.zeros_like(x)
    while bool(x.any()):
        p ^= x & 1
        x = x >> 1
    return p


def decode(tr: Trellis, symbols: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Circular decode of (F, L, R) soft symbols: (bits (F, L) uint8, the
    best end state's metric (F,) int64, accumulated total (F,) int64)."""
    F, L, R = symbols.shape
    if L < tr.K - 1:
        raise ValueError("a tail-biting frame needs L >= K-1")
    dev = symbols.device
    s = torch.arange(tr.S, dtype=torch.int64, device=dev)
    b = torch.arange(2, dtype=torch.int64, device=dev)[:, None]
    pred = (s >> 1) | (b << (tr.K - 2))                     # (2, S)
    reg = s | (b << (tr.K - 1))
    level = torch.stack([torch.where(_parity(reg & g) == 1, tr.high, tr.low)
                         for g in tr.G], dim=-1)            # (2, S, R)
    sym = symbols.to(torch.int64).clamp(tr.low, tr.high)
    sym = torch.cat([sym, sym, sym], dim=1)                 # (F, 3L, R)
    m = torch.full((tr.S, F), tr.init_start, dtype=torch.int64, device=dev)
    acc = torch.zeros(F, dtype=torch.int64, device=dev)
    dec = torch.empty(3 * L, tr.S, F, dtype=torch.bool, device=dev)
    for t in range(3 * L):
        # (2, S, F): each transition's candidate
        bm = (level[:, :, None, :] - sym[None, None, :, t, :]).abs().sum(-1)
        cand = m[pred] + bm
        if tr.saturating:
            cand = cand.clamp(max=tr.metric_max)
            dec[t] = cand[1] <= cand[0]
        else:
            cand = cand & tr.metric_max
            dec[t] = cand[0] > cand[1]
        m = torch.minimum(cand[0], cand[1])
        gate = m[0] >= tr.threshold
        if bool(gate.any()):
            sub = torch.where(gate, m.min(dim=0).values, 0)
            m = m - sub
            acc = acc + sub
    best = torch.argmin(m, dim=0)                           # first minimum
    metric = m[best, torch.arange(F, device=dev)]
    state = best
    frames = torch.arange(F, device=dev)
    bits = torch.empty(F, L, dtype=torch.uint8, device=dev)
    for t in range(3 * L - 1, L + tr.K - 2, -1):
        d = dec[t, state, frames].to(torch.int64)
        j = t - (tr.K - 1)                                  # its input step
        if L <= j < 2 * L:
            bits[:, j - L] = d.to(torch.uint8)
        state = (state >> 1) | (d << (tr.K - 2))
    return bits, metric, acc
