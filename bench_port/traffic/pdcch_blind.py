"""Blind decoding of LTE's PDCCH: a control-channel monitor decodes every
CCE-aligned candidate of a 20 MHz control region, at every aggregation
level (AL) and every DCI size, every subframe.

The inputs, made at set-up from the seed: ``pool`` groups of
``subframes`` subframes, each the CCE-ordered soft bits of its control
region (``cces`` x ``cce_bits`` int16).  In each subframe ``sent``
PDCCHs ({AL: count}) lie at free CCE-aligned places, each an L-bit frame
(a DCI payload and its CRC, random bits) of a size drawn from the
configuration's, tail-biting encoded and rate matched to E = AL x
``cce_bits`` bits by the frozen reference (``reference/tailbiting.py``);
the other CCEs carry noise only.  BPSK, AWGN at ``esno_db`` a coded
bit, quantisation as ``channel.py``'s.

One call is one DCI size over one group: ``ratematch.dematch`` of each
AL's candidates (every CCE-aligned one) into one (B, 3L) buffer, B = 157
x ``subframes``, then one ``ViterbiDecoder.decode_tailbiting``.  The four
sizes of a group run in turn, then the next group; one caller, closed
loop, the host at most ``AHEAD`` calls ahead of the card (as
``batch_decode``'s); the window closes with a device synchronise.

Params (``workloads/<cell>.json``): ``subframes``, ``pool``, ``sent``,
``warmup`` (groups of calls before the window), ``check_groups``,
``check_frames`` and ``check_sent`` (the sample the comparison reads:
that many groups, and in each, for every size and AL, that many
candidates drawn over the batch and that many of the sent PDCCHs; each
call's outputs are those of its last run in the window).

Compared with the frozen reference exactly: each sampled candidate's
bits, best-state metric and renormalisation total, the reference
de-matching the same soft bits itself.  Standard error shows the share
of the sent DCIs decoded right at each AL.
"""

import dataclasses
import sys
import time

import numpy as np

# calls the host may run ahead of the device
AHEAD = 4


@dataclasses.dataclass
class Blind:
    dec: object             # the program's ViterbiDecoder
    dematch: object         # the program's ratematch.dematch
    tr: object              # the reference trellis
    pool: list              # (subframes, cces * cce_bits) int16 a group
    sizes: list             # L of each DCI size
    levels: list            # the ALs
    ncand: dict             # AL -> candidates a subframe
    offset: dict            # AL -> its first row in a call's batch
    bufs: list              # (B, 3L) int32 a size, the call's symbols
    sent: dict              # (group, size index, AL) -> (rows, data)
    cce_bits: int
    low: int
    high: int

    @property
    def B(self) -> int:
        return self.bufs[0].shape[0]

    @property
    def subframes(self) -> int:
        return self.pool[0].shape[0]

    def slot(self, n: int) -> tuple:
        """(group, size index) of call ``n``."""
        return (n // len(self.sizes)) % len(self.pool), n % len(self.sizes)

    def call(self, n: int):
        g, i = self.slot(n)
        L, grp, buf, S = self.sizes[i], self.pool[g], self.bufs[i], \
            self.subframes
        for a in self.levels:
            nc, E = self.ncand[a], a * self.cce_bits
            lo = self.offset[a]
            self.dematch(grp[:, :nc * E].unflatten(1, (nc, E)), L,
                         low=self.low, high=self.high,
                         out=buf[lo:lo + S * nc].view(S, nc, 3 * L))
        return self.dec.decode_tailbiting(buf, L)

    def where(self, rows: np.ndarray) -> list:
        """[(AL, subframes, candidates, positions in ``rows``)] of batch
        rows ``rows``."""
        out = []
        for a in self.levels:
            lo, n = self.offset[a], self.subframes * self.ncand[a]
            pos = np.flatnonzero((rows >= lo) & (rows < lo + n))
            if pos.size:
                r = rows[pos] - lo
                out.append((a, r // self.ncand[a], r % self.ncand[a], pos))
        return out


def _program():
    """The program's modules; a clean refusal where it cannot decode a
    tail-biting frame."""
    from bench_port.harness import BenchError
    try:
        import viterbidecodercpp_torch as vp
        from viterbidecodercpp_torch import ratematch
    except ImportError as e:
        raise BenchError(f"the program has no rate de-matching: {e}") \
            from None
    if not hasattr(vp.ViterbiDecoder, "decode_tailbiting"):
        raise BenchError("the program has no ViterbiDecoder."
                         "decode_tailbiting: it cannot decode a tail-biting "
                         "frame")
    return vp, ratematch


def octal_generators(K: int, G) -> list:
    """G in the port's convention (bit i taps the input i steps back) as
    36.212 writes it: octal, the most significant bit the current input."""
    return [format(int(format(g, f"0{K}b")[::-1], 2), "o") for g in G]


def _places(rng, n: int, cces: int, sent: dict) -> dict:
    """{AL: (n, count) candidate index} of each subframe's sent PDCCHs:
    the largest AL first, each at a random free CCE-aligned place."""
    busy = np.zeros((n, cces), bool)
    out = {}
    for a in sorted(sent, reverse=True):
        nc, k = cces // a, sent[a]
        free = ~busy[:, :nc * a].reshape(n, nc, a).any(-1)
        score = np.where(free, rng.random((n, nc)), -1.0)
        pick = np.argsort(-score, axis=1, kind="stable")[:, :k]
        if (np.take_along_axis(score, pick, 1) < 0).any():
            raise ValueError(f"no room for {k} PDCCHs at AL {a}")
        for j in range(k):
            cols = pick[:, j:j + 1] * a + np.arange(a)
            busy[np.arange(n)[:, None], cols] = True
        out[a] = pick
    return out


def _setup(run) -> Blind:
    vp, ratematch = _program()
    import torch

    from bench_port import channel
    from bench_port.reference import tailbiting as ref

    cfg, p = run.cell.config, run.cell.params
    K, G = int(cfg["K"]), tuple(cfg["G"])
    if octal_generators(K, G) != list(cfg["generators_octal"]):
        raise ValueError("G and generators_octal name different encoders")
    dev = torch.device(run.device)
    code = vp.CodeSpec(cfg["code"], K, G)
    dconf = vp.get_decode_config(vp.DecodeType(cfg["decode_type"]), len(G),
                                 arith=cfg["arith"])
    dec = vp.ViterbiDecoder(code, dconf, device=dev)
    run.mark("program imported")
    tr = ref.trellis(K, G, cfg["decode_type"], cfg["arith"])
    S, n_pool = int(p["subframes"]), int(p["pool"])
    cces, cb = int(cfg["cces"]), int(cfg["cce_bits"])
    levels = [int(a) for a in cfg["aggregation_levels"]]
    sizes = [int(d) + int(cfg["crc_bits"]) for d in cfg["dci_payload_bits"]]
    ncand = {a: cces // a for a in levels}
    offset, B = {}, 0
    for a in levels:
        offset[a], B = B, B + S * ncand[a]
    sent = {int(a): int(k) for a, k in p["sent"].items()}

    # where each PDCCH lies and its size: host draws from the seed
    rng = run.rng(2)
    N = n_pool * S
    places = _places(rng, N, cces, sent)
    size_of = {a: rng.integers(0, len(sizes), places[a].shape)
               for a in places}
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    x = torch.zeros(N, cces * cb, dtype=torch.int8, device=dev)
    rows_of, data_of = {}, {}
    gens = cfg["generators_octal"]
    for a in sorted(places):
        E = a * cb
        for i, L in enumerate(sizes):
            u, j = np.nonzero(size_of[a] == i)          # subframe, slot
            if not u.size:
                continue
            c = places[a][u, j]
            data = torch.randint(0, 2, (u.size, L), generator=gen,
                                 dtype=torch.uint8, device=dev)
            e = ref.match(ref.encode(data, gens), E)    # (n, E) bits
            cols = torch.as_tensor(c[:, None] * E + np.arange(E), device=dev)
            x[torch.as_tensor(u, device=dev)[:, None], cols] = \
                (2 * e - 1).to(torch.int8)
            for g in np.unique(u // S):
                k = np.flatnonzero(u // S == g)
                rows = offset[a] + (u[k] % S) * ncand[a] + c[k]
                rows_of[(int(g), i, a)] = rows
                data_of[(int(g), i, a)] = data[torch.as_tensor(k,
                                                               device=dev)]
    # BPSK, AWGN, quantisation (channel.channel's arithmetic, a zero
    # signal where nothing is sent)
    sigma = channel.awgn_sigma(float(cfg["esno_db"]), 1)
    high, low = tr.high, tr.low
    mean, mag = (high + low) / 2.0, (high - low) / 2.0
    scale = mag / (1.0 + sigma * sigma) ** 0.5
    pool = []
    for g in range(n_pool):
        sig = x[g * S:(g + 1) * S].to(torch.float32)
        noise = torch.randn(sig.shape, generator=gen, dtype=torch.float32,
                            device=dev)
        q = channel.round_half_away((sig + sigma * noise) * scale + mean)
        pool.append(torch.clamp(q, low, high).to(
            getattr(torch, cfg["symbol_dtype"])))
    del x
    sent_all = {k: (rows_of[k], data_of[k]) for k in rows_of}
    bufs = [torch.zeros(B, 3 * L, dtype=torch.int32, device=dev)
            for L in sizes]
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.mark(f"{n_pool} groups of {S} subframes made")
    return Blind(dec, ratematch.dematch, tr, pool, sizes, levels, ncand,
                 offset, bufs, sent_all, cb, low, high)


def _loop(b: Blind, seconds: float, keep=None) -> int:
    """Calls back to back for ``seconds``; returns the calls made.
    ``keep[slot]`` receives the last outputs of each slot it holds."""
    import torch

    cuda = b.pool[0].device.type == "cuda"
    done = [torch.cuda.Event() for _ in range(AHEAD)] if cuda else None
    n = 0
    t_end = time.perf_counter() + seconds
    while True:
        if cuda and n >= AHEAD:
            done[n % AHEAD].synchronize()
        if time.perf_counter() >= t_end:
            return n
        out = b.call(n)
        if cuda:
            done[n % AHEAD].record()
        if keep is not None and b.slot(n) in keep:
            keep[b.slot(n)] = out
        n += 1


def symbols(b: Blind, calls: int) -> int:
    """Mother-code symbols of the first ``calls`` calls: B x L x 3 each
    (a candidate's symbols once, not its three copies)."""
    k = len(b.sizes)
    return sum(b.B * 3 * L * (calls // k + (i < calls % k))
               for i, L in enumerate(b.sizes))


def _sample(run, b: Blind) -> dict:
    """{(group, size index): sorted batch rows} the comparison reads."""
    from bench_port.harness import sample_frames

    p = run.cell.params
    rng = run.rng(1)
    groups = sorted(rng.choice(len(b.pool), min(int(p["check_groups"]),
                                                len(b.pool)), replace=False))
    out = {}
    for g in groups:
        for i in range(len(b.sizes)):
            rows = []
            for a in b.levels:
                n = b.subframes * b.ncand[a]
                rows.append(b.offset[a] + sample_frames(
                    rng, n, int(p["check_frames"])))
                sent = b.sent.get((int(g), i, a))
                if sent is not None:
                    k = min(int(p["check_sent"]), len(sent[0]))
                    rows.append(rng.choice(sent[0], k, replace=False))
            out[(int(g), i)] = np.unique(np.concatenate(rows))
    return out


def _reference(tr, b: Blind, sample: dict) -> dict:
    """{slot: (bits, metric, acc)} of the frozen reference on the sampled
    candidates' soft bits, which it de-matches itself."""
    import torch

    from bench_port.reference import tailbiting as ref

    out = {}
    for (g, i), rows in sample.items():
        L, grp = b.sizes[i], b.pool[g]
        syms = torch.empty(len(rows), 3 * L, dtype=torch.int32)
        for a, sf, c, pos in b.where(rows):
            E = a * b.cce_bits
            cols = torch.as_tensor(c[:, None] * E + np.arange(E),
                                   device=grp.device)
            soft = grp[torch.as_tensor(sf, device=grp.device)[:, None],
                       cols].cpu()
            syms[torch.as_tensor(pos)] = ref.dematch(soft, L, b.low, b.high)
        bits, metric, acc = ref.decode(tr, syms.reshape(len(rows), L, 3))
        out[(g, i)] = (bits.numpy(), metric.numpy(), acc.numpy())
    return out


def _compare(want: dict, got: dict) -> list:
    nbit = nmet = nacc = 0
    for k, (bits, metric, acc) in got.items():
        wb, wm, wa = want[k]
        nbit += int((bits != wb).sum())
        nmet += int((metric != wm).sum())
        nacc += int((acc != wa).sum())
    return [["bit_mismatches", nbit], ["metric_mismatches", nmet],
            ["acc_mismatches", nacc]]


def control(run, metric_bits: int) -> list:
    """The comparison's numbers with the reference at ``metric_bits``-bit
    metrics in the program's place, on the run's inputs and sample."""
    from bench_port.reference import tailbiting as ref

    b = _setup(run)
    sample = _sample(run, b)
    cfg = run.cell.config
    low = ref.trellis(cfg["K"], cfg["G"], cfg["decode_type"], cfg["arith"],
                      metric_bits)
    return _compare(_reference(b.tr, b, sample), _reference(low, b, sample))


def _recovered(b: Blind, keep: dict) -> dict:
    """{AL: [sent DCIs decoded right, sent DCIs]} over the kept calls."""
    import torch

    out = {a: [0, 0] for a in b.levels}
    for (g, i), res in keep.items():
        if res is None:
            continue
        for a in b.levels:
            sent = b.sent.get((g, i, a))
            if sent is None:
                continue
            rows = torch.as_tensor(sent[0], device=res[0].device)
            ok = (res[0].index_select(0, rows) == sent[1]).all(dim=1)
            out[a][0] += int(ok.sum())
            out[a][1] += len(sent[0])
    return out


def run(run) -> dict:
    import torch

    from bench_port import profiling, spans

    p = run.cell.params
    b = _setup(run)
    cuda = run.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sample = _sample(run, b)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # every size's shapes, twice
    for n in range(int(p["warmup"]) * len(b.sizes)):
        b.call(n)
    sync()
    run.mark(f"{p['warmup']} warm-up groups of calls")

    keep = {k: None for k in sample}
    setup_s = time.time() - run.t_start
    t0 = time.perf_counter()
    calls = _loop(b, run.seconds, keep)
    sync()
    window_s = time.perf_counter() - t0
    shapes = [{"S": b.tr.S, "B": b.B, "T": 3 * L, "R": 3,
               "W": max(b.tr.S // 32, 1), "data_bits": L, "K": b.tr.K}
              for L in b.sizes]
    rec = {"attempted": calls, "failed": 0, "setup_s": setup_s,
           "window_s": window_s, "calls": calls,
           "symbols": symbols(b, calls), "shapes": shapes}
    if run.trace:
        rec["trace"] = profiling.trace_window(
            lambda: b.call(0), lambda s: {"calls": _loop(b, s)})
        rec["span_window"] = spans.span_window(
            lambda: b.call(0), lambda s: {"calls": _loop(b, s)},
            run.device)
    rec["device"] = {
        "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda
        else 0}

    # -- the comparison, once the window has closed ----------------------
    shares = _recovered(b, keep)
    got = {}
    for k, res in keep.items():
        if res is not None:
            rows = torch.as_tensor(sample[k], device=res[0].device)
            got[k] = [x.index_select(0, rows).cpu().numpy().astype(np.int64)
                      for x in res]
    want = _reference(b.tr, b, {k: sample[k] for k in got})
    print(f"pdcch_blind: {calls} calls ({b.B} candidates each) in "
          f"{window_s:.4f} s; compared {sum(len(sample[k]) for k in got)} "
          f"candidates of {len(got)} calls with the reference; sent DCIs "
          f"decoded right by AL: " + ", ".join(
              f"{a}: {ok}/{n} ({ok / n if n else float('nan'):.6f})"
              for a, (ok, n) in shares.items()), file=sys.stderr)
    rec["recovered"] = {str(a): v for a, v in shares.items()}
    # a sampled call the window never reached counts as unchecked
    rec["checks"] = _compare(want, got) + [
        ["batches_unchecked", len(sample) - len(got)]]
    return rec
