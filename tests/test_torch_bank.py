"""The port's program bank (`mplc_tpu_torch/contrib/bank.py`) and kernel
build folder (`ops/cuda_build.py`, `utils.enable_compile_cache_from_env`),
on the CPU: the key's fields, the shared and per-game scopes, the FIFO
store, the manifest's round trip, `bank_stats` under the JAX package's
keys, `holds_persistent`, the planner's "bank_cost_model" basis, v(S) bit
for bit with the bank on and off, and libraries named by a digest of
their source and flags, so a shared folder never serves another source's
library."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mplc_tpu.contrib import bank as jbank
from mplc_tpu.contrib import planner as jplanner
from mplc_tpu_torch import constants, utils
from mplc_tpu_torch.contrib import bank, planner
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.reconstruct import ReconstructionEvaluator
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.live import LiveGame
from mplc_tpu_torch.obs import devcost, metrics
from mplc_tpu_torch.ops import cuda_build

from test_torch_live import port_scenario, synth_rounds

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_bank(monkeypatch):
    monkeypatch.delenv(constants.COMPILE_CACHE_DIR_ENV, raising=False)
    monkeypatch.delenv(constants.PROGRAM_BANK_ENV, raising=False)
    bank.reset_bank()
    yield
    bank.reset_bank()


def _sweep(eng):
    eng.evaluate(powerset_order(3))
    return np.array([eng.charac_fct_values[s] for s in powerset_order(3)])


def test_bank_is_on_by_default_and_off_under_its_knob(monkeypatch):
    assert isinstance(CharacteristicEngine(port_scenario()).program_bank, bank.ProgramBank)
    monkeypatch.setenv(constants.PROGRAM_BANK_ENV, "0")
    assert CharacteristicEngine(port_scenario()).program_bank is None
    monkeypatch.delenv(constants.PROGRAM_BANK_ENV)
    # the JAX bank's exemption of the deterministic reduce guards XLA
    # compiles; the port compiles nothing, so the bank stays on
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    assert isinstance(CharacteristicEngine(port_scenario()).program_bank, bank.ProgramBank)


def test_per_game_key_never_hashes_the_staged_data():
    """The per-game key is the engine's fingerprint less its data digest:
    a sweep's acquires never copy the staged data to the host to hash it,
    and two engines of one game share their keys."""
    eng = CharacteristicEngine(port_scenario())
    _sweep(eng)
    assert bank._PROGRAMS and eng._digest is None
    twin = CharacteristicEngine(port_scenario())
    assert (twin.program_bank.program_key(twin.multi_pipe, None, 4)
            == eng.program_bank.program_key(eng.multi_pipe, None, 4))
    assert twin._digest is None


def test_every_batch_acquires_its_program_with_its_flops():
    eng = CharacteristicEngine(port_scenario())
    metrics.reset()
    _sweep(eng)
    programs = bank._PROGRAMS
    # one program a (slot count, width) the sweep ran: singles, the merged
    # 3-slot bucket (pairs and the grand coalition)
    shapes = sorted((e["slot_count"] or 0, e["width"]) for e in programs.values())
    assert shapes == sorted({(b["slot_count"] or 0, b["width"]) for b in eng.batch_log})
    assert all(e["kind"] == "train" and e["cost"]["flops"] > 0 for e in programs.values())
    snap = metrics.snapshot()["counters"]
    assert snap["bank.programs"] == len(programs)
    assert snap.get("bank.hits", 0) == len(eng.batch_log) - len(programs)


def test_bank_off_gives_the_same_bits(monkeypatch):
    on = _sweep(CharacteristicEngine(port_scenario()))
    monkeypatch.setenv(constants.PROGRAM_BANK_ENV, "0")
    off = _sweep(CharacteristicEngine(port_scenario()))
    assert on.tobytes() == off.tobytes()
    assert bank.bank_stats()["enabled"] is False


def test_live_bank_off_gives_the_same_bits(monkeypatch):
    game = LiveGame(port_scenario())
    assert game.engine.program_bank.shared
    rounds = synth_rounds(game._init_params, 3, 2, seed=1)
    for d, w in rounds:
        game.append_round(d, w)
    on = game.query("exact")
    assert any(e["kind"] == "recon" for e in bank._PROGRAMS.values())
    monkeypatch.setenv(constants.PROGRAM_BANK_ENV, "0")
    off_game = LiveGame(port_scenario())
    assert off_game.engine.program_bank is None
    for d, w in rounds:
        off_game.append_round(d, w)
    assert off_game.query("exact").scores.tobytes() == on.scores.tobytes()
    assert off_game._recon.values == game._recon.values


def test_program_key_fields():
    eng = CharacteristicEngine(port_scenario())
    b = eng.program_bank
    pipe = eng.multi_pipe
    key = b.program_key(pipe, None, 4)
    assert len(key) == 24 and key == b.program_key(pipe, None, 4)
    assert len({key, b.program_key(pipe, None, 8), b.program_key(pipe, 3, 4),
                b.program_key(eng.single_pipe, None, 4),
                b.program_key(eng._slot_pipe(3), 3, 4)}) == 5
    # the epochs: another scenario's engine of 3 epochs
    eng3 = CharacteristicEngine(port_scenario(epoch_count=3))
    assert eng3.program_bank.program_key(eng3.multi_pipe, None, 4) != key
    # per-game scope: another seed is another game; shared scope: one shape
    other = CharacteristicEngine(port_scenario(seed=5))
    assert other.program_bank.program_key(other.multi_pipe, None, 4) != key
    s1, s2 = bank.ProgramBank(eng, shared=True), bank.ProgramBank(other, shared=True)
    assert s1.program_key(pipe, None, 4) == s2.program_key(other.multi_pipe, None, 4)
    assert s1.program_key(pipe, None, 4) != key


def test_recon_key_fields(monkeypatch):
    game = LiveGame(port_scenario())
    game.append_round(*synth_rounds(game._init_params, 3, 1, seed=2)[0])
    recon = game._evaluator()
    b = game.engine.program_bank
    keys = {b.recon_key(recon, 8), b.recon_key(recon, 16)}
    monkeypatch.setattr(recon, "precision", "bf16")
    keys.add(b.recon_key(recon, 8))
    monkeypatch.setattr(recon, "precision", "fp32")
    monkeypatch.setattr(bank, "_device_kind", lambda device: "NVIDIA H100 80GB HBM3")
    keys.add(b.recon_key(recon, 8))
    monkeypatch.undo()
    # the stream's depth: one more invalidating round
    game.append_round(*synth_rounds(game._init_params, 3, 1, seed=3)[0])
    keys.add(b.recon_key(game._evaluator(), 8))
    assert len(keys) == 5


def test_recon_flops_counts_the_contraction_and_the_evaluation():
    game = LiveGame(port_scenario())
    game.append_round(*synth_rounds(game._init_params, 3, 1, seed=2)[0])
    recon = game._evaluator()
    K, Dp = recon._d2.shape
    eng = game.engine
    calls = []
    eng.trainer.call_log = calls
    with torch.no_grad():
        eng.trainer.evaluate_models(
            {g: {k: t[None].expand((8,) + t.shape) for k, t in d.items()}
             for g, d in recon.recorded.init_params.items()}, eng.test)
    eng.trainer.call_log = None
    assert calls == eng.trainer.eval_calls(8, eng.test)
    from mplc_tpu_torch.mpl.engine import call_flops
    want = 2.0 * 8 * K * Dp + call_flops(eng.model, calls, eng.stacked.x)
    assert bank.recon_flops(recon, 8) == want


def test_store_is_fifo_bounded(monkeypatch):
    eng = CharacteristicEngine(port_scenario())
    monkeypatch.setattr(bank, "_MAX_PROGRAMS", 4)
    for i in range(6):
        eng.program_bank._acquire(f"k{i}", {"kind": "train"}, lambda: 1.0)
    assert list(bank._PROGRAMS) == ["k2", "k3", "k4", "k5"]
    stats = bank.bank_stats()
    assert stats["programs"] == 4 and stats["costed_programs"] == 4


def test_bank_stats_keys_are_the_jax_packages():
    assert set(bank.bank_stats()) == set(jbank.bank_stats())
    assert bank.MANIFEST_NAME == jbank.MANIFEST_NAME
    assert bank._MAX_PROGRAMS == jbank._MAX_PROGRAMS


def test_manifest_round_trip_and_holds_persistent(tmp_path, monkeypatch):
    monkeypatch.setenv(constants.COMPILE_CACHE_DIR_ENV, str(tmp_path))
    eng = CharacteristicEngine(port_scenario())
    assert bank.manifest_dir() == str(tmp_path)
    _sweep(eng)
    doc = json.loads((tmp_path / bank.MANIFEST_NAME).read_text())
    assert sorted(doc) == ["costs", "programs"]
    assert set(doc["programs"]) == set(bank._PROGRAMS) == set(doc["costs"])
    assert not list(tmp_path.glob("*.tmp"))          # replaced atomically
    # a fresh process (an empty store) reads the manifest back
    bank.reset_bank()
    fresh = CharacteristicEngine(port_scenario())
    assert fresh.program_bank.persistent_keys() == set(doc["programs"])
    assert fresh.program_bank.persistent_costs() == doc["costs"]
    plan = [(fresh.single_pipe if b["kind"] == "single" else fresh._slot_pipe(b["slot_count"]),
             b["slot_count"], b["width"]) for b in eng.batch_log]
    assert fresh.program_bank.holds_persistent(plan)
    assert not fresh.program_bank.holds_persistent(plan + [(fresh.single_pipe, None, 999)])
    assert not fresh.program_bank.holds_persistent([])
    monkeypatch.setenv(constants.PROGRAM_BANK_ENV, "0")
    assert not fresh.program_bank.holds_persistent(plan)
    # no folder: no manifest, a process-local bank
    monkeypatch.delenv(constants.COMPILE_CACHE_DIR_ENV)
    assert bank.manifest_dir() is None and fresh.program_bank.persistent_keys() == set()


def test_planner_prices_the_manifest_on_bank_cost_model(tmp_path, monkeypatch):
    eng = CharacteristicEngine(port_scenario())
    assert planner.estimate_eval_seconds(eng) == (planner.DEFAULT_EVAL_SEC, "default")
    monkeypatch.setenv(constants.COMPILE_CACHE_DIR_ENV, str(tmp_path))
    _sweep(eng)
    costs = [c["flops"] for c in eng.program_bank.persistent_costs().values()]
    peak = devcost.peak_flops_per_chip("H100 80GB HBM3", "fp32")
    sec, basis = planner.estimate_eval_seconds(CharacteristicEngine(port_scenario()))
    assert basis == "bank_cost_model"
    assert sec == float(np.median(costs)) / (peak * planner._COST_MODEL_MFU)
    assert planner._COST_MODEL_MFU == jplanner._COST_MODEL_MFU
    # the meter wins once it has seen 8 reconstructed coalitions
    ReconstructionEvaluator(eng).evaluate(powerset_order(3))
    eng.device_meter.note(1, span_sec=0.05, eval_only=True)
    assert planner.estimate_eval_seconds(eng)[1] == "meter"


# -- the kernel build folder ------------------------------------------------

def _fake_nvcc(tmp_path, rc=0) -> str:
    nvcc = tmp_path / f"nvcc{rc}"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; then "
                    "echo built > \"$2\"; fi\n  shift\ndone\n"
                    + (f"echo 'error: bad source' >&2\nexit {rc}\n" if rc else ""))
    nvcc.chmod(0o755)
    return str(nvcc)


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("k_a", "k_b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setenv(constants.COMPILE_CACHE_DIR_ENV, str(tmp_path / "cache"))
    return csrc


def test_libraries_are_named_by_source_and_flags(sources, tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    assert cuda_build.build_dir() == cache
    cuda_build.build(["k_a", "k_b"])
    names = {n: cuda_build.library_name(n) for n in ("k_a", "k_b")}
    assert sorted(p.name for p in cache.iterdir()) == sorted(names.values())
    assert all(len(v.split("-")[1]) == len("0123456789abcdef.so") for v in names.values())
    assert utils.compile_cache_entries(str(cache)) == 2
    builds = metrics.counter("trainer.compiles_total").value
    cuda_build.build(["k_a", "k_b"])
    assert metrics.counter("trainer.compiles_total").value == builds
    # another revision of k_a, sharing the folder: its own library, built
    # once, beside the first (an older mtime would not have been enough)
    (sources / "k_a.cu").write_text("// k_a, revised\n")
    os.utime(sources / "k_a.cu", (0, 0))
    assert cuda_build.library_name("k_a") != names["k_a"]
    cuda_build.build(["k_a", "k_b"])
    assert metrics.counter("trainer.compiles_total").value == builds + 1
    assert (cache / names["k_a"]).exists() and (cache / cuda_build.library_name("k_a")).exists()
    # other flags, another library
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build.library_name("k_b") != names["k_b"]


def test_a_failed_build_raises_and_leaves_no_library(sources, tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path, rc=2))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*bad source"):
        cuda_build.build(["k_a"])
    assert not (tmp_path / "cache" / cuda_build.library_name("k_a")).exists()
    assert not list((tmp_path / "cache").glob(".lib*"))


def test_the_default_folder(tmp_path, monkeypatch):
    monkeypatch.delenv(constants.COMPILE_CACHE_DIR_ENV, raising=False)
    assert utils.enable_compile_cache_from_env() is None
    assert cuda_build.build_dir() == cuda_build.CHECKOUT / "build" / "kernels"
    # an installed package (no checkout around it): a user cache folder
    monkeypatch.setattr(cuda_build, "CHECKOUT", tmp_path / "site-packages")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert cuda_build.build_dir() == tmp_path / "xdg" / "mplc_tpu_torch" / "kernels"
    # a folder that cannot be made warns and falls back
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv(constants.COMPILE_CACHE_DIR_ENV, str(blocker / "sub"))
    with pytest.warns(UserWarning, match="could not be made"):
        assert utils.enable_compile_cache_from_env() is None
    assert utils.compile_cache_entries(None) is None
    assert utils.compile_cache_entries(str(tmp_path / "missing")) is None
