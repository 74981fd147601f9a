"""The control fails the limits: the reference put in the program's place
and computed in TF32 (the nearest precision below the float32 the
configurations state), and a training step with half of the image's rows
left out of the loss. At a tiny size on the CPU here; at each cell's own
size on the card."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import run
from port_bench.tests import tinyroot

REPO = Path(__file__).resolve().parents[2]


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell, side", [
    ("tinyroom.tinytrain", "tf32"), ("tinyroom.tinytrain", "half"),
    ("tinyroom.tinyview", "tf32")])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_at_a_tiny_size(tmp_path, cell, side, seed):
    torch.set_num_threads(2)
    root = tinyroot.make(tmp_path)
    spec = run.load_cell(root, cell)
    c = spec["kind"].Cell(root, spec["config"], spec["traffic"], seed, "cpu")
    c.setup()
    c.window(0.3, False)
    c.release()
    c.check(False)
    assert not fails(c.numbers, spec["limits"]), c.numbers
    assert fails(c.control(side), spec["limits"])


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_at_the_cells_size(card, cell):
    """On the card: three seeds of the cell at its own size, the program
    within its limits and the TF32 control outside them."""
    spec = run.load_cell(REPO, cell)
    for seed in (101, 202, 303):
        c = spec["kind"].Cell(REPO, spec["config"], spec["traffic"], seed,
                              card)
        c.setup()
        c.window(1.0, False)
        c.release()
        torch.cuda.empty_cache()
        c.check(False)
        assert not fails(c.numbers, spec["limits"]), c.numbers
        assert fails(c.control("tf32"), spec["limits"])
        del c
        torch.cuda.empty_cache()
