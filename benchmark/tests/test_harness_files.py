"""Every file of the benchmark parses and is found by the name BENCHMARK.json
gives it; BENCHMARK.json keeps to the contract's shape; a new cell needs new
files only."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness as H

SPEC = H.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m.get("workloads", []):
            e = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
            assert c in e.get("workloads", CELLS)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = H.Cell(cell)
    assert c.traffic["mode"] in ("train_step", "infer_batch")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    for kind in ("programs", "reference", "counts", "modes"):
        assert (H.ROOT / kind / f"{c.module(kind).__name__.split('.')[-1]}.py").exists()
    assert c.end_to_end and c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_config_files(conf):
    entry = next(c for c in SPEC["configs"] if c["name"] == conf)
    data = H.read_json(H.REPO / entry["file"])
    assert data["name"] == conf and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []


def test_new_cell_needs_new_files_only(tmp_path):
    """A throwaway cell added in a copy, as files only, runs on the CPU."""
    shutil.copytree(H.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "biomedclip_mona.finetune_b8", "config": "biomedclip_mona",
                              "traffic": "finetune_b8", "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "biomedclip_mona.finetune_b256" in m.get("workloads", []):
            m["workloads"].append("biomedclip_mona.finetune_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = H.read_json(H.ROOT / "traffic" / "finetune_b256.json")
    traffic.update(batch=8, trace_seconds=0.1)
    (tmp_path / "benchmark" / "traffic" / "finetune_b8.json").write_text(json.dumps(traffic))
    shutil.copy(H.ROOT / "workloads" / "biomedclip_mona.finetune_b256.json",
                tmp_path / "benchmark" / "workloads" / "biomedclip_mona.finetune_b8.json")
    code = ("import torch, json\n"
            "from benchmark import run\n"
            "from benchmark.tests.harness_tiny import SIZES\n"
            "rc = run.main(['--workload', 'biomedclip_mona.finetune_b8', '--seed', '7',"
            " '--seconds', '0.2', '--trace', '0'], device=torch.device('cpu'),"
            " overrides=SIZES['biomedclip_mona'])\n"
            "assert rc == 0\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(H.REPO)])}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["attempted"] >= 1 and "train_img_s" in line["metrics"]


def test_no_result_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    a run exits with another code than 0 and prints no result."""
    shutil.copytree(H.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.REPO / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
