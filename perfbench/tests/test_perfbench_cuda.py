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
