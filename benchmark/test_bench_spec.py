"""The benchmark's files: BENCHMARK.json and every file it names parse and
fit together; a cell and a metric are added by adding files; the command
refuses to run without a card; nothing it loads is JAX or the JAX
package."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import common
from benchmark.run import Reading, metrics_of

ROOT = common.ROOT
SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_and_files_fit_together():
    assert SPEC["paths"] == ["benchmark"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        cfg = common.read_json(ROOT / c["file"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        common.Cell(c["name"], cfg, "", {}, {}, 0, 1, False).pipeline_config()
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        wl = common.read_json(ROOT / "benchmark" / "workloads" / f"{w['name']}.json")
        assert (wl["config"], wl["traffic"], wl["why"]) == (w["config"], w["traffic"], w["why"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.py").is_file()
        assert {m["name"] for m in metrics_of(SPEC, w["name"], False)} >= {"setup_s"}
        assert len(metrics_of(SPEC, w["name"], False)) >= 2
        assert metrics_of(SPEC, w["name"], True)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert m["moves"] in {x["name"] for x in metrics_of(SPEC, c, False)}
        assert callable(common.load_module("layer_metrics", m["name"]).read)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A new configuration, cell and per-layer metric from new files and
    new entries only; the harness finds them by name and runs the cell."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = common.read_json(ROOT / "benchmark" / "configs" / "grasp.json")
    cfg.update(name="tiny", image_h=96, image_w=128, window_h=64, window_w=96)
    cfg["roi"]["memsize"] = 16
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    wl = common.read_json(ROOT / "benchmark" / "workloads" / "grasp.batch.json")
    wl.update(config="tiny", why="a dummy cell")
    wl["params"].update(batch=4, batches=2, check_block=4, object_margin_px=3,
                        block_rows=[1, 3], block_cols=[1, 3])
    (tmp_path / "benchmark" / "workloads" / "tiny.batch.json").write_text(json.dumps(wl))
    (tmp_path / "benchmark" / "layer_metrics" / "dummy.pairs.py").write_text(
        "def read(r):\n    return r.host.get('pairs_per_s')\n")
    spec["configs"].append({"name": "tiny", "source": "a test", "file":
                            "benchmark/configs/tiny.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.batch", "config": "tiny", "traffic": "batch",
                              "chips": 1, "why": "a dummy cell"})
    spec["end_to_end"][0]["workloads"].append("tiny.batch")
    spec["per_layer"].append({"name": "dummy.pairs", "unit": "pairs/s", "better": "higher",
                              "source": "host_clock", "layer": "step",
                              "moves": "pairs_per_s", "workloads": ["tiny.batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = common.load_cell("tiny.batch", 5, 0.2, False, root=tmp_path)
    import torch

    cell.device = torch.device("cpu")
    out = common.load_module("traffic", cell.traffic, root=tmp_path).run(cell)
    assert common.judge(out["checks"], cell.limits)
    names = [m["name"] for m in metrics_of(spec, "tiny.batch", True)]
    assert "dummy.pairs" in names
    reader = common.load_module("layer_metrics", "dummy.pairs", root=tmp_path)
    reading = Reading(cell, None, 0, out["host"], {})
    assert reader.read(reading) == out["host"]["pairs_per_s"] > 0


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_result(tmp_path):
    """Without a card the run fails and prints no result line: it never
    falls back to the CPU; nor does it run where the port is absent."""
    args = ["--workload", "grasp.batch", "--seed", str(2**31 + 9), "--seconds", "1",
            "--trace", "0"]
    res = _run(args, ROOT)
    assert res.returncode != 0 and '"correct"' not in res.stdout
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = _run(args, tmp_path)
    assert res.returncode != 0 and '"correct"' not in res.stdout


FORBIDDEN = ("jax", "jaxlib", "flax", "nsof_tpu")


def test_foreign_modules_by_whole_top_level_name():
    code = ("import sys, types\n"
            "from benchmark import common\n"
            "import nsof_tpu_torch\n"
            "assert common.foreign_modules() == [], common.foreign_modules()\n"
            "sys.modules['nsof_tpu.ops'] = types.ModuleType('nsof_tpu.ops')\n"
            "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
            "print(common.foreign_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "['jaxlib', 'nsof_tpu']"


def test_what_a_run_loads_is_neither_jax_nor_the_jax_package():
    """Every module of the harness, every driver and reader, and the port's
    entries they call, imported in one process: no JAX, no nsof_tpu."""
    code = ("import pathlib, sys\n"
            "from benchmark import common, run, calibrate, roofline\n"
            "for kind in ('traffic', 'layer_metrics'):\n"
            "    for f in sorted((common.HERE / kind).glob('*.py')):\n"
            "        if f.stem != '__init__': common.load_module(kind, f.stem)\n"
            "from nsof_tpu_torch.pipelines import segmentation, stream\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    roots = set(ast.literal_eval(res.stdout.strip()))
    assert not roots & set(FORBIDDEN) and "nsof_tpu_torch" in roots


def test_reference_imports_nothing_of_the_port():
    for path in sorted((common.HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN + ("nsof_tpu_torch",), (path, n)
    code = ("import sys\nimport benchmark.reference.segmentation, "
            "benchmark.reference.frame_sim\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    roots = set(ast.literal_eval(res.stdout.strip()))
    assert not roots & set(FORBIDDEN + ("nsof_tpu_torch",))


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    """One short run of each cell on the card, as the check runs it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in SPEC["workloads"]:
        res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", w["name"],
                              "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
