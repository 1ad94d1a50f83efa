"""Multi-process runs of the port's parallel layer on the CPU (the twins of
tests/test_multiprocess.py): the dryrun fleet over gloo, the fleet
launcher's failure paths, the hybrid mesh in one process, and the
entry points' refusals (no card, NCCL with more ranks than cards)."""

import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import ber
from viterbidecodercpp_torch.ops import torch_core
from viterbidecodercpp_torch.parallel import block_sp, frame_dp, launch


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_fleet(world):
    """Frame-DP, a data-parallel BER point and time-SP over every rank
    (and the 2 x 2 data x time mesh at 4 ranks), each exact."""
    launch.launch_processes(world, timeout=240, device="cpu")


def test_spawn_fleet_failure_paths():
    """spawn_fleet reports a failed rank with every rank's output, kills
    the ranks still running at once, enforces its timeout and the
    success token."""
    ok = [sys.executable, "-c", "print('TOKEN ok')"]
    bad = [sys.executable, "-c", "print('boom'); raise SystemExit(3)"]
    slow = [sys.executable, "-c", "import time; time.sleep(120)"]

    outs = launch.spawn_fleet(lambda r, init: ok, 2, success_token="TOKEN")
    assert len(outs) == 2 and all("TOKEN" in o for o in outs)
    with pytest.raises(RuntimeError, match="boom"):
        launch.spawn_fleet(lambda r, init: bad, 1)
    with pytest.raises(RuntimeError, match="success"):
        launch.spawn_fleet(lambda r, init: ok, 1, success_token="ABSENT")
    # a rank that fails ends a fleet whose other rank would wait forever
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] failed"):
        launch.spawn_fleet(lambda r, init: slow if r == 0 else bad, 2)
    assert time.monotonic() - t0 < 60
    with pytest.raises(RuntimeError, match="did not finish"):
        launch.spawn_fleet(lambda r, init: slow, 2, timeout=1.0)
    # every rank gets the same fresh file:// store
    seen = []
    launch.spawn_fleet(lambda r, init: seen.append(init) or ok, 3)
    assert len(set(seen)) == 1 and seen[0].startswith("file://")


@pytest.fixture
def world_of_one(tmp_path):
    launch.initialize("file://" + str(tmp_path / "store"), 1, 0,
                      device="cpu")
    yield
    dist.destroy_process_group()


def test_hybrid_mesh_single_process(world_of_one):
    """make_hybrid_mesh in a one-rank group: DCN axes outer, the sizes
    must cover every rank; the layout is host-major at any world size;
    local_block keeps this rank's block and refuses an uneven split."""
    mesh = launch.make_hybrid_mesh(dcn={"data": 1}, ici={"time": 1},
                                   device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "time")
    assert tuple(mesh.mesh.shape) == (1, 1)
    with pytest.raises(ValueError):
        launch.make_hybrid_mesh(dcn={"data": 3}, ici={"time": 1},
                                device_type="cpu")
    with pytest.raises(ValueError):
        launch.make_hybrid_mesh(device_type="cpu")
    names, ranks = launch._hybrid_ranks({"data": 2}, {"time": 4}, 8)
    assert names == ("data", "time")
    np.testing.assert_array_equal(ranks, np.arange(8).reshape(2, 4))
    with pytest.raises(ValueError):
        launch._hybrid_ranks({"data": 2}, {"time": 4}, 6)
    x = torch.arange(12).reshape(2, 6)
    assert torch.equal(launch.local_block(x, mesh, ("data", "time")), x)


def test_entry_points_refuse_without_a_card_or_with_nccl_on_cpu(
        monkeypatch):
    """No fallback: the parallel entry points raise on a machine without
    a card unless given device="cpu", NCCL refuses CPU ranks and more
    ranks than cards, naming gloo."""
    code = pt.get_code("Voyager")
    config = pt.get_decode_config(pt.DecodeType.SOFT16, code.R)
    spec = torch_core.make_static_spec(code, config)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frame_dp.decode_dp(code, config, np.zeros((1, 8, 2)), 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            block_sp.decode_stream_sp(spec, None, np.zeros((1, 8, 2)),
                                      overlap=4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ber.sweep(code, config, group=object(), max_points=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.initialize("file:///nowhere", 2, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.dryrun_worker("file:///nowhere", 2, 0)
    with pytest.raises(ValueError, match="gloo"):
        launch.initialize("file:///nowhere", 2, 0, backend="nccl",
                          device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="gloo"):
        launch.initialize("file:///nowhere", 4, 1, backend="nccl")
