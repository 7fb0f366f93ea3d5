"""On the card: a short run of each cell at its own size comes out
correct, and the control at the small size does not. Skips without a
card."""

import time

import pytest

import smallcells
from harness import spec

B = spec.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_short_run_at_the_cells_size_is_correct(name, card):
    import run

    cell = spec.find_cell(name, B)
    line = run.execute(cell, 2_500_000_003, 2.0, False, card,
                       time.perf_counter())
    assert line["correct"] is True, line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name, card):
    cell = smallcells.small_cell(name)
    r = cell.driver(cell, 2_500_000_005, card)
    r.setup()
    if cell.traffic["kind"] == "render":
        r.window(0.3)
    r.free_program()
    lim = cell.limits["numbers"]
    assert all(v <= lim[k]["limit"] for k, v in r.check().items())
    assert any(v > lim[k]["limit"] for k, v in r.control().items())
