"""The manifest keeps to the benchmark's contract, every cell's files are
found by name, a cell, configuration, mix and metric added as new files
are found without editing a file that exists, and the FLOP and byte
arithmetic matches hand-worked counts."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import flops, manifest
from benchmark.reference import model

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


@pytest.fixture(scope="module")
def doc():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_sizes(doc):
    assert set(doc) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= int(doc["run_seconds"]) <= 51
    assert 1 <= len(doc["paths"]) <= 16 and 1 <= len(doc["configs"]) <= 24
    assert 1 <= len(doc["workloads"]) <= 24 and 1 <= len(doc["end_to_end"]) <= 16
    assert 1 <= len(doc["per_layer"]) <= 128 and len(doc["command"]) <= 32
    for p in doc["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in doc["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")


def test_names_and_units_use_the_allowed_characters(doc):
    entries = doc["configs"] + doc["workloads"] + doc["end_to_end"] + doc["per_layer"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        kind_names = [e["name"] for e in doc[kind]]
        assert len(set(kind_names)) == len(kind_names)
    metric_names = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for w in doc["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in doc["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in doc["configs"] + doc["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in doc["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_entries_have_exactly_the_contract_keys(doc):
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in doc["end_to_end"])
    four = sum(w["chips"] == 4 for w in doc["workloads"])
    assert four <= max(1, len(doc["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(doc):
    man = manifest.Manifest.load()
    for w in doc["workloads"]:
        e2e = man.end_to_end_names(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = man.per_layer_names(w["name"])
        assert per_layer
        for name in per_layer:
            assert man.metric(name)["moves"] in e2e


def test_every_cells_files_are_found_by_name(doc):
    man = manifest.Manifest.load()
    for c in doc["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and any(path.is_relative_to(ROOT / p) for p in doc["paths"])
        cfg = man.config(c["name"])
        assert cfg["name"] == c["name"] and model(cfg["model"]).forward_flops > 0
    for w in doc["workloads"]:
        mix = man.traffic(w["traffic"])
        assert mix["entry"] in ("engine", "engine_fresh", "reconstruction_fresh")
        assert man.limits(w["name"])
        for name in man.end_to_end_names(w["name"]) + man.per_layer_names(w["name"]):
            assert callable(man.reader(name))


def _digests(folder: Path) -> dict:
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path, doc):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "benchmark")
    here = root / "benchmark"
    (here / "configs" / "tiny_cnn-p3.json").write_text(json.dumps(
        {**json.loads((here / "configs" / "mnist_cnn-p10.json").read_text()),
         "name": "tiny_cnn-p3", "partner_weights": [1, 2, 3]}))
    (here / "traffic" / "pairs.json").write_text(json.dumps(
        {"entry": "engine", "coalitions": [[2]], "per_request": 2, "sample": 2}))
    (here / "limits" / "tiny_cnn-p3.pairs.json").write_text(json.dumps(
        {"limits": {"v_gap_max": 0.5}}))
    (here / "metrics" / "batches_per_s.pairs.py").write_text(
        "def read(ctx):\n    return ctx['batches_done'] / ctx['window_s']\n")
    new = json.loads(json.dumps(doc))
    new["configs"].append({"name": "tiny_cnn-p3", "source": "x",
                           "file": "benchmark/configs/tiny_cnn-p3.json", "reduced": [],
                           "why": "a test"})
    new["workloads"].append({"name": "tiny_cnn-p3.pairs", "config": "tiny_cnn-p3",
                             "traffic": "pairs", "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "batches_per_s.pairs", "unit": "batches/s",
                             "better": "higher", "source": "program_span", "layer": "coalition engine",
                             "moves": "retrain_coalitions_per_s",
                             "workloads": ["tiny_cnn-p3.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    man = manifest.Manifest.load(root, here)
    assert man.config(man.workload("tiny_cnn-p3.pairs")["config"])["partner_weights"] == [1, 2, 3]
    assert man.traffic("pairs")["per_request"] == 2
    assert man.limits("tiny_cnn-p3.pairs") == {"v_gap_max": 0.5}
    assert man.per_layer_names("tiny_cnn-p3.pairs") == ["batches_per_s.pairs"]
    assert man.reader("batches_per_s.pairs")({"batches_done": 6, "window_s": 3.0}) == 2.0
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_forward_flops_by_hand():
    # conv 26x26x(3x3x1)x32 + conv 24x24x(3x3x32)x64 + dense 9216x128 + 128x10,
    # 2 FLOPs a multiply-add
    assert model("mnist_cnn").forward_flops == 2 * (
        26 * 26 * 9 * 32 + 24 * 24 * 9 * 32 * 64 + 9216 * 128 + 1280) == 23_984_896
    assert model("cifar10_cnn").forward_flops == 2 * (
        32 * 32 * 27 * 32 + 30 * 30 * 288 * 32 + 15 * 15 * 288 * 64 + 13 * 13 * 576 * 64
        + 2304 * 512 + 5120) == 41_482_240


def test_training_and_kernel_arithmetic_by_hand():
    cfg = {"minibatch_count": 10}
    sizes = [981, 1963, 2945]
    # a FedAvg member drops n mod 10 rows an epoch; a lone partner passes all
    assert flops.train_rows(cfg, sizes, (0, 2), 2) == 2 * (980 + 2940)
    assert flops.train_rows(cfg, sizes, (1,), 1) == 1963
    assert flops.retrain_flops(cfg, 10, sizes, (0, 2), 1, 100) == 3 * 10 * 3920 + 10 * 100
    b, k, dp = 64, 200, 1_199_888
    assert flops.recon_kernel_flops(b, k, dp) == 2 * 64 * 200 * 1_199_888
    assert flops.recon_kernel_bytes(b, k, dp) == 4 * (200 * dp + 64 * 200 + dp + 64 * dp)
    assert flops.recon_flops(5, 10, 3, k, dp) == 3 * (2 * k * dp + 50)


def test_model_parameter_counts_are_the_published_widths():
    import torch
    for name, count in (("mnist_cnn", 1_199_882), ("cifar10_cnn", 1_250_858)):
        params = model(name).init(torch.Generator().manual_seed(0))
        assert sum(t.numel() for d in params.values() for t in d.values()) == count
