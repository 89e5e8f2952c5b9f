"""On the card: a small cell through the kernel route is correct under the
cell's own limit, and the traced readings come out. Skips without a card
(run it on the card with ``python -m pytest -q -m cuda perfbench/tests``)."""
import pytest
import torch

import perfbench_tiny
from perfbench import cells, run


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_small_cell_on_the_card(name):
    _card()
    c = perfbench_tiny.tiny(name, docs=2000, vocab=8192, dim=300,
                            pool=2048)
    c.spec["limits"] = cells.load(name).spec["limits"]
    result, checks = run.run_cell(c, seed=2 ** 31 + 77, seconds=2.0,
                                  trace=True, device="cuda")
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
    assert result["breakdown"]["device_ops"]
    assert result["metrics"]


@pytest.mark.cuda
def test_device_ms_reads_one_card_alike_by_any_name():
    """Per-card timing on one card is the one-card timing: no card list,
    the card by index, and four logical shards of it read one time."""
    _card()
    from perfbench import devtime

    def fn():
        torch.cuda._sleep(2_000_000)
    ms = [devtime.device_ms(fn, reps=5, cards=cards)
          for cards in (None, [torch.device("cuda", 0)], ["cuda:0"] * 4)]
    assert max(ms) / min(ms) < 1.1, ms


@pytest.mark.cuda
def test_small_cell_on_a_mesh_of_logical_shards():
    """A (4, 1) mesh of four logical shards of the card: correct, one card
    counted and read, and the solve's roofline read."""
    _card()
    c = perfbench_tiny.tiny("prod_5m_shard4.bulk_q16", docs=2000,
                            vocab=8192, dim=300, pool=2048)
    c.spec["limits"] = cells.load(c.name).spec["limits"]
    c.spec["mesh"], c.chips = {"shape": [4, 1], "axes": ["data", "model"]}, 4
    result, checks = run.run_cell(c, seed=2 ** 31 + 78, seconds=2.0,
                                  trace=True,
                                  devices=[torch.device("cuda", 0)] * 4)
    assert result["correct"], checks
    dev = result["device"]
    assert dev["count"] == 1 and len(dev["busy_s_by_card"]) == 1
    assert dev["memory_peak_bytes_by_card"] == [dev["memory_peak_bytes"]]
    assert "solve_roofline" in result["metrics"]
