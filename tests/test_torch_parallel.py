"""The port's parallel layer against the JAX package's, exactly.

One module-scoped fleet of 4 gloo ranks on the CPU (``launch.spawn_fleet``)
runs every case once: the ranks read the cases' global inputs from an
.npz file, decode their own blocks with ``block_sp.decode_stream_sp`` or
``frame_dp.decode_dp`` on each route, and write their tiles back.  The
parent runs the JAX functions on the same inputs over the conftest's
virtual CPU devices and compares bits, ``halo_mismatches`` and error
totals exactly.  The ranks run this file as a script and import no jax.
"""

import argparse
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WORLD = 4
BACKENDS = ("auto", "torch")


# -- the ranks ---------------------------------------------------------------

def _rank_main(rank: int, init_method: str, work: str) -> None:
    import torch.distributed as dist

    import viterbidecodercpp_torch as pt
    from viterbidecodercpp_torch.decoder import select_backend
    from viterbidecodercpp_torch.ops import torch_core
    from viterbidecodercpp_torch.parallel import block_sp, frame_dp, launch
    from viterbidecodercpp_torch.parallel import mesh as pmesh

    launch.initialize(init_method, WORLD, rank, device="cpu")
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    arrays = np.load(os.path.join(work, "inputs.npz"))
    out = {}
    for name, c in cases.items():
        mesh = pmesh.make_mesh(c["mesh"], c["axes"], "cpu")
        if mesh.get_coordinate() is None:
            continue
        code = pt.get_code(c["code"]) if isinstance(c["code"], str) else \
            pt.CodeSpec(*c["code"])
        config = pt.get_decode_config(pt.DecodeType(c["mode"]), code.R)
        spec = torch_core.make_static_spec(code, config)
        syms = torch.from_numpy(arrays[name + "/syms"])
        for backend in BACKENDS:
            key = f"{name}/{backend}"
            out[key + "/route"] = select_backend(spec, torch.device("cpu"),
                                                 backend)
            try:
                if c["kind"] == "dp":
                    group = mesh.get_group("data")
                    bits, errs = frame_dp.decode_dp(
                        code, config,
                        launch.local_block(syms, mesh, ("data", None, None)),
                        c["total_bits"], group=group, backend=backend,
                        reference_bits=launch.local_block(
                            arrays[name + "/ref"], mesh, ("data", None)),
                        device="cpu")
                    out[key + "/bits"] = bits.numpy()
                    out[key + "/errs"] = int(errs)
                    continue
                if c.get("uneven"):
                    tile = torch.tensor_split(
                        syms, pmesh.axis_size(mesh, "time"),
                        dim=1)[mesh.get_local_rank("time")]
                else:
                    axes = ("data" if "data" in c["axes"] else None, "time",
                            None)
                    tile = launch.local_block(syms, mesh, axes)
                res = block_sp.decode_stream_sp(
                    spec, mesh, tile, overlap=c["overlap"],
                    end_state=c.get("end_state", 0),
                    total_rows=c["total_rows"], backend=backend,
                    device="cpu")
                out[key + "/bits"] = res.bits.numpy()
                out[key + "/mism"] = int(res.halo_mismatches)
            except ValueError as exc:
                out[key + "/error"] = str(exc)
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--work", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.init_method, a.work)
    sys.exit(0)


# -- the parent: the cases and the JAX package's results ---------------------

import jax.numpy as jnp  # noqa: E402

import viterbidecodercpp_tpu as vt  # noqa: E402
from viterbidecodercpp_torch.parallel import launch  # noqa: E402
from viterbidecodercpp_tpu.ops import jax_core, numpy_ref as ref  # noqa: E402
from viterbidecodercpp_tpu.parallel import block_sp, frame_dp  # noqa: E402
from viterbidecodercpp_tpu.parallel.mesh import make_mesh  # noqa: E402

DAB_FIC = ("DAB FIC mother", 7, (109, 79, 83, 109))


def _stream(syms: np.ndarray, R: int, ntime: int, pad_to: int = None):
    """(B, T, R) int32 symbols padded with zeros to a multiple of ntime
    rows (or to ``pad_to`` rows), and the true row count."""
    syms = np.atleast_2d(syms)
    B, T = syms.shape[0], syms.shape[1] // R
    pad_T = pad_to or -(-T // ntime) * ntime
    arr = np.zeros((B, pad_T, R), np.int32)
    arr[:, :T] = syms.reshape(B, T, R)
    return arr, T


def _sp(code, mode, arr, T, ntime, overlap, **kw):
    c = dict(kind="sp", code=code, mode=mode, mesh=[ntime], axes=["time"],
             overlap=overlap, total_rows=T)
    c.update(kw)
    return c, arr


@functools.lru_cache(maxsize=None)
def _cases():
    """name -> (case, symbols); data as in tests/test_parallel.py."""
    cases = {}
    V = vt.get_code("Voyager")

    # test_parallel.py:44 - noisy Voyager stream over 4 tiles
    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, 64, dtype=np.uint8)
    syms = ref.encode_bytes(V, data, 127, -127).astype(np.int64)
    syms = np.clip(syms + rng.randint(-40, 41, syms.shape), -127, 127)
    cases["noise4"] = _sp("Voyager", "SOFT16", *_stream(syms, 2, 4), 4, 96)

    # test_parallel.py:111 - frame-DP x time-SP on a 2 x 2 mesh
    rng = np.random.RandomState(13)
    data = rng.randint(0, 256, (2, 64), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(V, d, 127, -127) for d in data])
    syms = np.clip(syms.astype(np.int64)
                   + rng.randint(-30, 31, syms.shape), -127, 127)
    arr, T = _stream(syms, 2, 2)
    cases["mesh2x2"] = (dict(kind="sp", code="Voyager", mode="SOFT16",
                             mesh=[2, 2], axes=["data", "time"], overlap=96,
                             total_rows=T), arr)

    # test_parallel.py:225 - noise at the stream head, 2 tiles
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, 64, dtype=np.uint8)
    syms = ref.encode_bytes(V, data, 127, -127).astype(np.int64)
    head = 4 * V.K * V.R
    syms[:head] = rng.randint(-127, 128, head)
    cases["head2"] = _sp("Voyager", "SOFT16", *_stream(syms, 2, 2), 2, 128)

    # test_parallel.py:259 - pure noise, overlap 2: nonzero mismatches;
    # and a clean stream at overlap 96: none
    rng = np.random.RandomState(5)
    T = 1024 + V.K - 1
    arr = rng.randint(-127, 128, (1, -(-T // 4) * 4, 2)).astype(np.int32)
    cases["undersized"] = _sp("Voyager", "SOFT16", arr, T, 4, 2)
    data = rng.randint(0, 256, 128, dtype=np.uint8)
    syms = ref.encode_bytes(V, data, 127, -127)
    cases["clean4"] = _sp("Voyager", "SOFT16", *_stream(syms, 2, 4), 4, 96)

    # test_parallel.py:84 - Cassini over 2 tiles
    C = vt.get_code("Cassini")
    rng = np.random.RandomState(7)
    data = rng.randint(0, 256, 24, dtype=np.uint8)
    syms = ref.encode_bytes(C, data, 127, -127)
    cases["cassini2"] = _sp("Cassini", "SOFT16", *_stream(syms, C.R, 2), 2,
                            64)

    # test_parallel.py:142 - DAB FIC punctured stream over 4 tiles
    from viterbidecodercpp_tpu import puncture
    from viterbidecodercpp_tpu.ops import encoder
    D = vt.CodeSpec(*DAB_FIC)
    mask = puncture.schedule_mask(puncture.dab_fic_schedule(D))
    rng = np.random.RandomState(21)
    data = rng.randint(0, 256, 32 * 24 // 8, dtype=np.uint8)
    full = ref.encode_bytes(D, data, 127, -127)
    rx = np.asarray(encoder.depuncture(
        jnp.asarray(full[mask.astype(bool)][None, :]), mask, neutral=0))
    cases["punctured4"] = _sp(list(DAB_FIC), "SOFT16",
                              *_stream(rx, D.R, 4), 4, 96)

    # test_parallel.py:325 - the rotated route against JAX use_pallas=True
    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, 96, dtype=np.uint8)
    syms = ref.encode_bytes(V, data, 127, -127).astype(np.int64)
    syms = np.clip(syms + rng.randint(-40, 41, syms.shape), -127, 127)
    cases["rotated4"] = _sp("Voyager", "SOFT16", *_stream(syms, 2, 4), 4,
                            128, pallas=True)

    # the lane route: Basic K=5 against JAX use_pallas=True
    K5 = vt.get_code("Basic K=5 R=1/2")
    rng = np.random.RandomState(17)
    data = rng.randint(0, 256, 64, dtype=np.uint8)
    syms = ref.encode_bytes(K5, data, 127, -127).astype(np.int64)
    syms = np.clip(syms + rng.randint(-50, 51, syms.shape), -127, 127)
    cases["lane4"] = _sp("Basic K=5 R=1/2", "SOFT16",
                         *_stream(syms, 2, 4), 4, 64, pallas=True)

    # test_parallel.py:360 - K=9 SOFT8 on the 2 x 2 mesh
    K9 = vt.get_code("CDMA IS-95A")
    cfg = vt.get_decode_config(vt.DecodeType.SOFT8, K9.R)
    hi, lo = cfg.soft_decision_high, cfg.soft_decision_low
    rng = np.random.RandomState(11)
    data = rng.randint(0, 256, (4, 64), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(K9, d, hi, lo) for d in data])
    syms = np.clip(syms.astype(np.int64)
                   + rng.randint(-1, 2, syms.shape), lo, hi)
    arr, T = _stream(syms, K9.R, 2)
    cases["k9_2x2"] = (dict(kind="sp", code="CDMA IS-95A", mode="SOFT8",
                            mesh=[2, 2], axes=["data", "time"], overlap=128,
                            total_rows=T), arr)

    # a stream that is not tail-terminated: the walk starts at the
    # encoder's final state
    rng = np.random.RandomState(23)
    bits = rng.randint(0, 2, 400).astype(np.uint8)
    syms = np.where(ref.encode_bits(V, bits, terminate=False) == 1, 127,
                    -127).astype(np.int32)
    tail = bits[-(V.K - 1):]
    end_state = int(sum(int(b) << i for i, b in enumerate(tail)))
    cases["end_state"] = _sp("Voyager", "SOFT16", *_stream(syms, 2, 4), 4,
                             64, end_state=end_state)

    # padding past total_rows at the limit (one tile minus the overlap):
    # random symbols, which only the valid mask keeps out of the walk
    rng = np.random.RandomState(29)
    data = rng.randint(0, 256, 40, dtype=np.uint8)
    syms = ref.encode_bytes(V, data, 127, -127)
    arr, T = _stream(syms, 2, 4, pad_to=400)
    arr[:, T:] = rng.randint(-127, 128, arr[:, T:].shape)
    assert T == 326 and T > 3 * 100 + 24
    cases["padding"] = _sp("Voyager", "SOFT16", arr, T, 4, 24)

    # the two ValueErrors: a stream that does not split evenly, and
    # padding past one tile minus the overlap
    arr = rng.randint(-127, 128, (1, 401, 2)).astype(np.int32)
    cases["uneven"] = _sp("Voyager", "SOFT16", arr, 401, 4, 32, uneven=True)
    arr = rng.randint(-127, 128, (1, 400, 2)).astype(np.int32)
    cases["overpadded"] = _sp("Voyager", "SOFT16", arr, 332, 4, 32)

    # test_parallel.py:18 - frame-DP with its error total, noisy frames
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (16, 8), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(V, d, 127, -127) for d in data])
    syms = np.clip(syms + rng.normal(0, 110, syms.shape), -127,
                   127).astype(np.int32)
    cases["frame_dp"] = (dict(kind="dp", code="Voyager", mode="SOFT16",
                              mesh=[WORLD], axes=["data"], total_bits=64),
                         syms.reshape(16, -1, 2))
    return cases


def _refs():
    data = np.random.RandomState(0).randint(0, 256, (16, 8), dtype=np.uint8)
    return {"frame_dp": np.unpackbits(data, axis=1, bitorder="big")}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    work = tmp_path_factory.mktemp("fleet")
    cases = _cases()
    refs = _refs()
    with open(work / "cases.json", "w") as f:
        json.dump({k: c for k, (c, _) in cases.items()}, f)
    arrays = {k + "/syms": a for k, (_, a) in cases.items()}
    arrays.update({k + "/ref": r for k, r in refs.items()})
    np.savez(work / "inputs.npz", **arrays)
    me = os.path.abspath(__file__)
    launch.spawn_fleet(
        lambda r, init: [sys.executable, me, "--rank", str(r),
                         "--init-method", init, "--work", str(work)],
        WORLD, timeout=300)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


def _code(c):
    code = vt.get_code(c["code"]) if isinstance(c["code"], str) else \
        vt.CodeSpec(*c["code"])
    config = vt.get_decode_config(vt.DecodeType(c["mode"]), code.R)
    return code, config, jax_core.make_static_spec(code, config)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's (bits, halo mismatches or error total)."""
    c, arr = _cases()[name]
    code, config, spec = _code(c)
    mesh = make_mesh(tuple(c["mesh"]), tuple(c["axes"]))
    if c["kind"] == "dp":
        bits, errs = frame_dp.decode_dp(
            spec, mesh, jnp.asarray(arr), c["total_bits"],
            reference_bits=jnp.asarray(_refs()[name]))
        return np.asarray(bits), int(errs)
    bits, mism = block_sp.decode_stream_sp(
        spec, mesh, jnp.asarray(arr), overlap=c["overlap"],
        end_state=c.get("end_state", 0), total_rows=c["total_rows"],
        use_pallas=c.get("pallas", False))
    return np.asarray(bits), int(mism)


def _assemble(fleet, name, backend):
    """The ranks' blocks of case ``name`` put back in mesh order, and the
    summed count each rank returned (equal on every rank)."""
    c, _ = _cases()[name]
    shape = c["mesh"] if len(c["mesh"]) == 2 else \
        c["mesh"] + [1] if c["axes"] == ["data"] else [1] + c["mesh"]
    key = f"{name}/{backend}"
    count = "/errs" if c["kind"] == "dp" else "/mism"
    rows, totals = [], set()
    for d in range(shape[0]):
        row = []
        for t in range(shape[1]):
            out = fleet[d * shape[1] + t]
            row.append(out[key + "/bits"])
            totals.add(int(out[key + count]))
        rows.append(np.concatenate(row, axis=1))
    assert len(totals) == 1, totals
    return np.concatenate(rows, axis=0), totals.pop()


ROUTES = {"noise4": "rotated", "mesh2x2": "rotated", "head2": "rotated",
          "undersized": "rotated", "clean4": "rotated", "cassini2": "plane",
          "punctured4": "rotated", "rotated4": "rotated", "lane4": "lane",
          "k9_2x2": "rotated", "end_state": "rotated", "padding": "rotated"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_decode_stream_sp_equals_jax(fleet, name, backend):
    """Bits on every row (padding rows included) and the summed halo
    mismatches equal the JAX package's, on the kernel route ``auto``
    takes (its plain versions on the CPU) and on the plain scan."""
    route = str(fleet[0][f"{name}/{backend}/route"])
    assert route == (ROUTES[name] if backend == "auto" else "torch")
    got, mism = _assemble(fleet, name, backend)
    want, want_mism = _jax(name)
    np.testing.assert_array_equal(got, want)
    assert mism == want_mism
    if name == "undersized":
        assert mism > 0
    else:
        assert mism == 0
    c, arr = _cases()[name]
    if name in ("clean4", "cassini2", "punctured4", "end_state", "padding"):
        # clean streams decode exactly: row t carries data bit t - (K-1)
        code, config, _ = _code(c)
        T = c["total_rows"]
        seq, _, _ = ref.viterbi_decode(code, config,
                                       arr[0, :T].reshape(-1),
                                       T - (code.K - 1),
                                       end_state=c.get("end_state", 0))
        np.testing.assert_array_equal(got[0, code.K - 1:T], seq)


@pytest.mark.parametrize("name", ["uneven", "overpadded"])
def test_decode_stream_sp_refuses_like_jax(fleet, name):
    """A stream that does not split evenly over the tiles, and padding
    past one tile minus the overlap: every rank raises ValueError on both
    routes, where the JAX package raises ValueError."""
    for out in fleet:
        for backend in BACKENDS:
            msg = str(out[f"{name}/{backend}/error"])
            assert ("tiles differ" if name == "uneven" else "padding") in msg
    with pytest.raises(ValueError):
        _jax(name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_dp_equals_jax(fleet, backend):
    """Frame-DP on noisy frames: bits and the error total summed over the
    ranks equal the JAX package's, and the total is the sum of the
    ranks' own counts."""
    got, errs = _assemble(fleet, "frame_dp", backend)
    want, want_errs = _jax("frame_dp")
    np.testing.assert_array_equal(got, want)
    assert errs == want_errs > 0
    assert errs == int((got != _refs()["frame_dp"]).sum())
