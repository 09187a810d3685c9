"""On the card (marked ``cuda``; skips without one): a short run of the
cell at 4,096 keys through the CUDA path is correct, and the control is
not.  ``python -m pytest portbench/tests -m cuda`` on the chip."""

import pytest

from portbench import harness


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cell_on_card_is_correct(card):
    res = harness.run_cell(harness.load_cell("stock.ticks"), 2**31 + 5, 2.0, keys=4096)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_control_on_card_is_not_correct(card):
    res = harness.run_cell(harness.load_cell("stock.ticks"), 2**31 + 6, 2.0, keys=4096,
                           engine={"enforce_windows": False})
    assert not res["correct"]
