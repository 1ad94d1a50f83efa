"""The port's BER engine (ber.py) against the JAX package's, on the CPU.

Exact where the two share their randomness or none is drawn: the host
chain (the same native mt19937 channel into bit-exact decoders), one
batch's decode-and-count fed the JAX package's own channel output, and
the stopping arithmetic (bit budget, error budget, timeout slices).  The
device loop draws from a torch.Generator, not a jax.random key, so its
curve is held statistically against the in-repo CPU curve, with
tests/test_ber.py's window.  The data-parallel point (``group=``) runs
in a fleet of gloo ranks on the CPU, which run this file as a script and
import no jax.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import viterbidecodercpp_torch as pt  # noqa: E402
from viterbidecodercpp_torch import ber  # noqa: E402
from viterbidecodercpp_torch.parallel import launch  # noqa: E402

WORLD = 4
# the data-parallel points: Basic K=3 SOFT16 at 1 dB, 64-bit blocks, two
# frames a rank a batch (STEP bits a batch over the fleet)
DP_CODE, DP_MODE, DP_EBNO, DP_BLOCK, DP_BATCH = \
    "Basic K=3 R=1/2", "SOFT16", 1.0, 64, 2
DP_STEP = WORLD * DP_BATCH * DP_BLOCK
DP_SEED = 7
# point -> (generator index, max_bits, rank 0's timeout)
DP_POINTS = {"five": (0, 5 * DP_STEP, None),
             "five_again": (0, 5 * DP_STEP, None),
             "past": (1, 5 * DP_STEP // 2, None),
             "timeout": (2, 100 * DP_STEP, 1e-9)}


def _dp_kw():
    code = pt.get_code(DP_CODE)
    return code, pt.get_decode_config(pt.DecodeType(DP_MODE), code.R), \
        dict(block_bits=DP_BLOCK, batch=DP_BATCH, max_errors=10 ** 6,
             device="cpu")


def _rank_main(rank: int, init_method: str, out: str) -> None:
    """Every DP_POINTS point over the fleet; rank 0 alone has a timeout
    on the "timeout" point."""
    import torch.distributed as dist

    launch.initialize(init_method, WORLD, rank, device="cpu")
    code, config, kw = _dp_kw()
    got = {}
    for name, (index, max_bits, timeout) in DP_POINTS.items():
        p = ber.measure_point(
            code, config, DP_EBNO,
            generator=ber.rank_generator(DP_SEED, index, rank, "cpu"),
            max_bits=max_bits, group=dist.group.WORLD,
            timeout_seconds=timeout if rank == 0 else None, **kw)
        got[name] = [p.total_bits, p.total_bit_errors]
    with open(out, "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viterbidecodercpp_tpu as vt  # noqa: E402
from viterbidecodercpp_torch.utils import native  # noqa: E402
from viterbidecodercpp_tpu import ber as jax_ber  # noqa: E402
from viterbidecodercpp_tpu.ops import jax_core  # noqa: E402
from viterbidecodercpp_tpu.utils import native as jax_native  # noqa: E402
from viterbidecodercpp_tpu.utils import testsig as jax_testsig  # noqa: E402

def _pair(name, mode):
    jc, tc = vt.get_code(name), pt.get_code(name)
    return (jc, vt.get_decode_config(vt.DecodeType(mode), jc.R),
            tc, pt.get_decode_config(pt.DecodeType(mode), tc.R))


def _same(a, b):
    assert (a.EbNo_dB, a.ber, a.total_bits, a.total_bit_errors) == \
        (b.EbNo_dB, b.ber, b.total_bits, b.total_bit_errors)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("name,mode,ebno", [
    ("Voyager", "SOFT16", 2.0),             # rotated route
    ("Basic K=5 R=1/2", "HARD8", 3.0),      # lane route
    ("DAB Radio", "SOFT8", 1.5),            # R=4
])
def test_host_chain_point_equals_jax(name, mode, ebno):
    assert jax_native.ensure_built()
    jc, jcfg, tc, tcfg = _pair(name, mode)
    kw = dict(seed=3, block_bits=256, batch=4, max_bits=3000)
    want = jax_ber.measure_point_host_chain(jc, jcfg, ebno, **kw)
    got = ber.measure_point_host_chain(tc, tcfg, ebno, device="cpu", **kw)
    assert want.total_bit_errors > 0
    _same(got, want)


@pytest.mark.parametrize("name,mode,ebno,B,N", [
    ("Voyager", "SOFT8", 0.5, 3, 96),
    ("Basic K=5 R=1/2", "SOFT16", 0.5, 3, 96),
    ("Cassini", "HARD8", -2.0, 1, 40),
])
def test_batch_decode_and_count_equals_jax(name, mode, ebno, B, N):
    """One batch of the JAX package's channel (its own key, its own
    quantiser) through the port's decode-and-count half and through the
    JAX loop body's (_decode_for_ber + count_bit_errors)."""
    jc, jcfg, tc, tcfg = _pair(name, mode)
    spec = jax_core.make_static_spec(jc, jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    tx = jax.random.bernoulli(k1, 0.5, (B, N)).astype(jnp.uint8)
    syms = jax_testsig.awgn_quantize(
        jax_testsig.modulate_encode(jc, tx, True), k2, ebno, jc.R, spec)
    want = int(jax_testsig.count_bit_errors(
        jax_ber._decode_for_ber(spec, False, syms, N), tx))
    dec = pt.ViterbiDecoder(tc, tcfg, traceback_length=N, device="cpu")
    got = ber.decode_errors(dec, torch.as_tensor(np.array(syms)),
                            torch.as_tensor(np.array(tx)))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert want > 0 and int(got) == want


def test_stop_arithmetic_equals_jax():
    """The same budgets end both loops on the same totals: the bit stop
    (2.5 batches -> 3), the error stop before the bit stop, and the
    timeout slices of four batches, at 60 dB (no errors) and at -20 dB
    (errors in every batch)."""
    jc, jcfg, tc, tcfg = _pair("Basic K=3 R=1/2", "HARD8")
    B, N = 2, 32
    step = B * N
    cases = [(60.0, dict(max_bits=5 * step // 2)),
             (60.0, dict(max_bits=10 * step, timeout_seconds=1e-9)),
             (60.0, dict(max_bits=6 * step, timeout_seconds=1e3)),
             (-20.0, dict(max_bits=40 * step, max_errors=1)),
             (-20.0, dict(max_bits=40 * step, max_errors=1,
                        timeout_seconds=1e-9))]
    for i, (ebno, kw) in enumerate(cases):
        want = jax_ber.measure_point(jc, jcfg, ebno, key=jax.random.PRNGKey(i),
                                     block_bits=N, batch=B, **kw)
        got = ber.measure_point(tc, tcfg, ebno, generator=_gen(i),
                                block_bits=N, batch=B, device="cpu", **kw)
        assert got.total_bits == want.total_bits, (ebno, kw)
        if ebno > 10:
            assert got.total_bit_errors == want.total_bit_errors == 0
        else:
            assert got.total_bits == step
            assert got.total_bit_errors >= 1 and want.total_bit_errors >= 1
    # the int32 cap: thresholds one batch below INT32_MAX
    assert ber.capped_budgets(1 << 40, 1 << 40, step) == \
        ((1 << 31) - 1 - step,) * 2
    assert ber.capped_budgets(1000, 7, step) == (1000, 7)


def test_measure_point_checks_its_device():
    tc, tcfg = pt.get_code("Voyager"), pt.get_decode_config(
        pt.DecodeType.SOFT8, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ber.measure_point(tc, tcfg, 3.0, generator=_gen(0), max_bits=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ber.sweep(tc, tcfg, max_points=1)
    with pytest.raises(ValueError, match="unsupported device"):
        ber.measure_point(tc, tcfg, 3.0, generator=_gen(0), max_bits=1,
                          device="meta")


def test_sweep_stops_at_first_zero_error_point():
    jc, jcfg, tc, tcfg = _pair("Basic K=3 R=1/2", "HARD8")
    kw = dict(seed=4, EbNo_start=1.0, EbNo_step=30.0, max_points=6,
              block_bits=64, batch=2, max_bits=256)
    res = ber.sweep(tc, tcfg, device="cpu", **kw)
    assert res.EbNo_dB == [1.0, 31.0]
    assert res.points[0].total_bit_errors > 0
    assert res.points[1].total_bit_errors == 0 and res.ber[1] == 0.0
    # the host chain seeds point i with seed + i, as the JAX package does
    got = ber.sweep(tc, tcfg, host_chain=True, device="cpu", **kw)
    want = jax_ber.sweep(jc, jcfg, host_chain=True, **kw)
    assert len(got.points) == len(want.points) == 2
    for a, b in zip(got.points, want.points):
        _same(a, b)
    # point generators: one stream a point, whatever the others drew
    a = torch.rand(4, generator=ber.point_generator(4, 1, "cpu"))
    b = torch.rand(4, generator=ber.point_generator(4, 1, "cpu"))
    c = torch.rand(4, generator=ber.point_generator(4, 2, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_voyager_point_within_window_of_cpu_curve():
    """Statistical: Voyager SOFT16 at 1.5 dB, 2048-bit blocks (the
    curve's own), against data_snr_ber_cpu.json with test_ber.py's
    tolerance (a 1.3x window widened to 5 sigma of the count)."""
    with open(os.path.join(ROOT, "data_snr_ber_cpu.json")) as f:
        rec = next(r for r in json.load(f)
                   if r["name"] == "Voyager" and r["decode_type"] == "SOFT16")
    r = dict(zip(rec["EbNo_dB"], rec["ber"]))[1.5]
    tc, tcfg = pt.get_code("Voyager"), pt.get_decode_config(
        pt.DecodeType.SOFT16, 2)
    p = ber.measure_point(tc, tcfg, 1.5, generator=_gen(2024),
                          block_bits=2048, batch=16, max_bits=2 * 16 * 2048,
                          device="cpu")
    n = p.total_bit_errors
    assert p.total_bits == 2 * 16 * 2048 and n > 300
    sigma_rel = 5.0 / max(np.sqrt(max(n, 1)), 1.0)
    lo = min(r / 1.3, r * (1 - sigma_rel))
    hi = max(r * 1.3, r * (1 + sigma_rel))
    assert lo <= p.ber <= hi, (p, r)


def test_native_is_the_ports_own_build():
    lib = native.ensure_built()
    assert lib.vdt_abi_version() == native.ABI_VERSION
    assert native.BUILD_DIR.parent.name == "viterbidecodercpp_torch"
    assert list(native.BUILD_DIR.glob("libvdtsigchain-*.so"))


@pytest.fixture(scope="module")
def dp_fleet(tmp_path_factory):
    """Each rank's (total_bits, total_bit_errors) of every DP_POINTS
    point, from one 4-rank gloo fleet."""
    work = tmp_path_factory.mktemp("ber_fleet")
    me = os.path.abspath(__file__)
    launch.spawn_fleet(
        lambda r, init: [sys.executable, me, str(r), init,
                         str(work / f"rank{r}.json")], WORLD, timeout=300)
    outs = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as f:
            outs.append(json.load(f))
    for name in DP_POINTS:           # the totals are global: equal on all
        assert len({tuple(o[name]) for o in outs}) == 1, name
    return outs[0]


def test_group_point_totals_equal_the_ranks_single_runs(dp_fleet):
    """A data-parallel point is the sum of the ranks' own points from the
    same rank generators: bits (world x batch x block a batch) and
    errors."""
    code, config, kw = _dp_kw()
    bits = errors = 0
    for r in range(WORLD):
        p = ber.measure_point(
            code, config, DP_EBNO,
            generator=ber.rank_generator(DP_SEED, 0, r, "cpu"),
            max_bits=5 * DP_STEP // WORLD, **kw)
        bits += p.total_bits
        errors += p.total_bit_errors
    assert dp_fleet["five"] == [bits, errors] == [5 * DP_STEP, errors]
    assert errors > 0


def test_group_point_repeats_from_the_same_seeds(dp_fleet):
    assert dp_fleet["five_again"] == dp_fleet["five"]
    # another point index draws other streams
    a = torch.rand(4, generator=ber.rank_generator(1, 0, 2, "cpu"))
    b = torch.rand(4, generator=ber.rank_generator(1, 0, 3, "cpu"))
    c = torch.rand(4, generator=ber.rank_generator(1, 1, 2, "cpu"))
    assert not torch.equal(a, b) and not torch.equal(a, c)


def test_group_point_stops_at_the_first_batch_past_max_bits(dp_fleet):
    # 2.5 batches of the fleet -> 3, as the JAX mesh point stops
    assert dp_fleet["past"][0] == 3 * DP_STEP
    assert ber.capped_budgets(1 << 40, 1 << 40, DP_STEP) == \
        ((1 << 31) - 1 - DP_STEP,) * 2


def test_group_point_timeout_on_one_rank_ends_every_rank(dp_fleet):
    """Rank 0's clock expires (the others have no timeout): every rank
    ends the point after the first slice of four batches, with the same
    totals, and none waits in a collective the others left."""
    assert dp_fleet["timeout"][0] == 4 * DP_STEP


def test_group_and_host_chain_are_exclusive():
    code, config, _ = _dp_kw()
    with pytest.raises(ValueError, match="mutually exclusive"):
        ber.sweep(code, config, host_chain=True, group=object(),
                  max_points=1, device="cpu")
