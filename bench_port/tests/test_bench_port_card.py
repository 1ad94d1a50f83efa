"""On the card: each one-card cell at a tiny size through the kernels,
correct, with a traced run's per-layer metrics inside their ranges.
Skips without a card (``pytest -m cuda bench_port/tests`` on the
chip)."""

import pytest

from bench_port_tiny import tiny_tree
from bench_port import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")


@pytest.mark.parametrize("cell", ["voyager-batch", "cassini-batch",
                                  "voyager-stream"])
def test_cell_on_card(cell, card, tmp_path):
    bench = tiny_tree(tmp_path)
    for trace in (False, True):
        out = harness.run_cell(cell, 77, 0.5, trace, device="cuda",
                               t_start=0.0, bench_dir=bench)
        assert out["correct"], out["checks"]
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    for name, m in out["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
        if name.startswith("device_idle_share"):
            assert 0 <= m["value"] <= 1
