"""Fixtures of the benchmark's own tests (``pytest benchmark/``): the cells
cut to sizes the CPU runs in seconds.  Their drivers then run the port's
plain versions (``device='cpu'``) against the reference; what needs the
card is marked ``cuda`` and skips without one."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import common


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def small_config(name: str) -> dict:
    """A configuration file's dict at a CPU size: its preset, head and gate
    as they are, frames and grid cut."""
    cfg = copy.deepcopy(common.read_json(common.ROOT / "benchmark" / "configs"
                                         / f"{name}.json"))
    if name == "grasp":
        cfg.update(image_h=128, image_w=80)
        cfg["roi"]["memsize"] = 16
    else:
        cfg.update(image_h=81, image_w=81, window_h=81, window_w=81)
        cfg["roi"]["memsize"] = 20
    return cfg


SMALL = {
    "grasp.batch": dict(batch=6, batches=2, check_block=4, object_margin_px=3,
                        block_rows=[1, 3], block_cols=[1, 2]),
    "autodriving.batch": dict(batch=4, batches=2, check_block=4, object_margin_px=3),
    "grasp.stream": dict(chunk_pairs=8, period=32, objects_hw=[[32, 24], [16, 16]],
                         check_block=8),
}
SECONDS = {"grasp.batch": 0.3, "autodriving.batch": 0.3, "grasp.stream": 0.5}


def small_cell(name: str, seed: int = 2**31 + 77) -> common.Cell:
    """The cell ``name`` as its files define it, cut to a CPU size."""
    cell = common.load_cell(name, seed, SECONDS[name], False)
    cell.config = small_config(cell.config["name"])
    cell.params = dict(cell.params, **SMALL[name])
    if "sim" in cell.params:
        cell.params["sim"] = dict(cell.params["sim"], m=16, n=16, n_substeps=100)
    cell.device = torch.device("cpu")
    return cell


@pytest.fixture
def cell_factory():
    return small_cell
