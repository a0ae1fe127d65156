"""The port engine's batch control on the CPU, one torch thread (the
counterparts of tests/test_dispatch_fusion.py:218-296 and
tests/test_donation.py:225):

- each batch is dispatched, then harvested before the next is dispatched,
  each exactly once, in the order of the `engine.batch` records, whether
  or not the trainer reads the device inside a run (early stopping that
  can fire);
- a sweep is bit-equal to its run at one coalition a batch, alone, under a
  seed ensemble, under a fault plan and at another cap;
- the cap: a malformed MPLC_TORCH_COALITIONS_PER_DEVICE warns and falls
  back to the autotune, MPLC_TORCH_BATCH_CAP_CEILING lifts the ceiling, the
  autotune follows the modeled footprint (bytes a coalition and a batch's
  fixed bytes), the device memory is queried once an engine and again
  after a degrade, the `engine.hbm` payload carries the JAX engine's keys;
- `_ladder_exhausted` counts, emits its event, writes its flight dump and
  returns a permanent, classified error;
- MPLC_TORCH_EVAL_CHUNK sets the evaluation chunk at import.

Values are compared exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mplc_tpu_torch import constants, faults
from mplc_tpu_torch.contrib import engine as engine_mod
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data import datasets
from mplc_tpu_torch.obs import metrics, trace
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

SUBSETS = powerset_order(4)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for k in ("FAULT_PLAN", "SEED_ENSEMBLE", "BATCH_CAP_CEILING",
              "COALITIONS_PER_DEVICE", "MAX_CAP_HALVINGS"):
        monkeypatch.delenv(f"MPLC_TORCH_{k}", raising=False)
    monkeypatch.setenv("MPLC_TORCH_RETRY_BACKOFF_SEC", "0")
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    metrics.reset()
    yield
    metrics.reset()


def scenario(epochs: int = 2, early_stopping: bool = False) -> Scenario:
    sc = Scenario(4, [0.1, 0.2, 0.3, 0.4], is_dry_run=True, dataset=datasets.load_titanic(),
                  seed=5, epoch_count=epochs, minibatch_count=2,
                  gradient_updates_per_pass_count=2, is_early_stopping=early_stopping,
                  device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    sc.compute_batch_sizes()
    return sc


def sweep(monkeypatch, **env) -> tuple[np.ndarray, CharacteristicEngine]:
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = CharacteristicEngine(scenario())
    return eng.evaluate(SUBSETS), eng


def _spy(eng, log):
    """Record every dispatch and harvest of `eng`'s pipelines in order."""
    pipes = [eng.single_pipe, eng.multi_pipe] + [eng._slot_pipe(k) for k in range(2, 5)]
    for pipe in pipes:
        inner = pipe.dispatch_async

        def dispatch_async(*a, inner=inner, **kw):
            n = sum(1 for e in log if e[0] == "dispatch")
            log.append(("dispatch", n))
            fetch = inner(*a, **kw)

            def harvest():
                log.append(("harvest", n))
                return fetch()
            return harvest
        pipe.dispatch_async = dispatch_async


@pytest.mark.parametrize("early_stopping", [False, True], ids=["no read", "stops early"])
def test_each_batch_is_harvested_before_the_next_dispatch(monkeypatch, early_stopping):
    """Batches run one after another, recorded in order; with early
    stopping that can fire (patience 10 < 12 epochs) the trainer reads the
    device every epoch, and the loop is the same."""
    monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "2")
    eng = CharacteristicEngine(scenario(epochs=12 if early_stopping else 2,
                                        early_stopping=early_stopping))
    assert eng._multi_cfg.stops_early == early_stopping
    log = []
    _spy(eng, log)
    with trace.collect() as recs:
        eng.evaluate(SUBSETS)
    n = sum(1 for e in log if e[0] == "dispatch")
    assert log == [e for i in range(n) for e in (("dispatch", i), ("harvest", i))]
    # 4 singles at width 2, then the width-3 bucket (10 coalitions), then
    # the width-4 bucket's 1: each batch recorded once, in order
    batches = [(r["attrs"]["ordinal"], r["attrs"]["slot_count"], r["attrs"]["coalitions"])
               for r in recs if r["name"] == "engine.batch"]
    assert batches == [(1, None, 2), (2, None, 2), (3, 3, 2), (4, 3, 2), (5, 3, 2),
                       (6, 3, 2), (7, 3, 2), (8, 4, 1)]
    assert n == len(batches) == len(eng.batch_log)


@pytest.mark.parametrize("env", [
    {},
    {constants.SEED_ENSEMBLE_ENV: "2"},
    {constants.FAULT_PLAN_ENV: "transient@harvest2,oom@batch4"},
    {constants.COALITIONS_PER_DEVICE_ENV: "3"},
], ids=["alone", "seed ensemble", "fault plan", "cap 3"])
def test_sweep_is_bit_equal_at_one_coalition_a_batch(monkeypatch, env):
    """The batch width never changes a value: the sweep (under `env`)
    against the same game at cap 1, each coalition trained alone."""
    wide, wide_eng = sweep(monkeypatch, **env)
    metrics.reset()
    monkeypatch.delenv(constants.FAULT_PLAN_ENV, raising=False)
    narrow, narrow_eng = sweep(monkeypatch, **{constants.COALITIONS_PER_DEVICE_ENV: "1"})
    assert {b["width"] for b in narrow_eng.batch_log} == {1}
    assert max(b["width"] for b in wide_eng.batch_log) > 1
    np.testing.assert_array_equal(wide, narrow)
    assert wide_eng.first_charac_fct_calls_count == narrow_eng.first_charac_fct_calls_count == 15
    for s in wide_eng.charac_fct_samples:
        np.testing.assert_array_equal(wide_eng.charac_fct_samples[s],
                                      narrow_eng.charac_fct_samples[s])


# ---------------------------------------------------------------------------
# the cap
# ---------------------------------------------------------------------------

def test_malformed_cap_knob_warns_and_falls_back(monkeypatch):
    eng = CharacteristicEngine(scenario())
    auto = eng._device_batch_cap()
    monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "sixteen")
    with pytest.warns(UserWarning, match=constants.COALITIONS_PER_DEVICE_ENV):
        assert eng._device_batch_cap() == auto
    monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "-3")
    with pytest.warns(UserWarning):
        assert eng._device_batch_cap() == auto
    monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "24")
    assert eng._device_batch_cap() == 24
    eng._cap_halvings = 2
    assert eng._device_batch_cap() == 6   # the override is halved by the ladder too


def on_card(eng: CharacteristicEngine) -> CharacteristicEngine:
    """`eng` taken for a CUDA engine, whose cap the autotune plans (its
    device memory set by each test; its data stays on the CPU)."""
    eng.device = torch.device("cuda")
    return eng


def test_ceiling_knob_lifts_the_autotune(monkeypatch):
    eng = on_card(CharacteristicEngine(scenario()))
    eng._hbm_bytes = 1 << 50      # memory never binds: the ceiling does
    assert eng._device_batch_cap() == 16
    monkeypatch.setenv(constants.BATCH_CAP_CEILING_ENV, "64")
    assert eng._device_batch_cap() == 64
    monkeypatch.setenv(constants.BATCH_CAP_CEILING_ENV, "wide")
    with pytest.warns(UserWarning, match=constants.BATCH_CAP_CEILING_ENV):
        assert eng._device_batch_cap() == 16


def test_autotune_follows_the_footprint(monkeypatch):
    eng = on_card(CharacteristicEngine(scenario()))
    per = eng._per_coalition_bytes(4)
    # Adam: 2 + k (4 + 2 * 2) parameter copies
    assert per == eng._model_param_bytes() * (2 + 4 * 8)
    # Titanic's rows are 27 features: the evaluation's 16,384 rows in
    # flight, two activations a row, outweigh a gradient call's
    row = eng.model.eval_row_bytes
    fixed = eng._batch_fixed_bytes(4)
    assert fixed == constants.EVAL_ACTIVATIONS_PER_ROW * constants.EVAL_ROWS_IN_FLIGHT * row
    # half the memory holds the fixed bytes and 5 coalitions
    eng._hbm_bytes = 2 * (fixed + 5 * per)
    assert eng._device_batch_cap(4) == 5
    eng._cap_halvings = 1
    assert eng._device_batch_cap(4) == 2
    eng._cap_halvings = 0
    eng._hbm_bytes = 2 * fixed          # no room beside the fixed bytes: 1
    assert eng._device_batch_cap(4) == 1
    # off the card the cap is the ceiling, halved by the ladder
    eng.device = torch.device("cpu")
    assert eng._device_batch_cap(4) == 16
    eng._cap_halvings = 2
    assert eng._device_batch_cap(4) == 4


def test_device_memory_is_queried_once_and_again_after_a_degrade(monkeypatch):
    calls = []
    monkeypatch.setattr(engine_mod, "device_memory_bytes",
                        lambda device: calls.append(device) or 80 << 30)
    eng = on_card(CharacteristicEngine(scenario()))
    eng._device_batch_cap()
    eng._device_batch_cap()
    assert len(calls) == 1
    eng._degrade_cap(faults.InjectedOom("CUDA out of memory: test"))
    eng._device_batch_cap()
    eng._device_batch_cap()
    assert len(calls) == 2
    assert engine_mod.device_memory_bytes is not None


def test_hbm_event_carries_the_jax_engines_keys():
    eng = CharacteristicEngine(scenario())
    with trace.collect() as recs:
        eng.evaluate([(0, 1), (2, 3)])
    hbm = [r["attrs"] for r in recs if r["name"] == "engine.hbm"]
    assert len(hbm) == 1
    # the JAX engine's keys and the port's fixed bytes a batch
    assert set(hbm[0]) == {"param_bytes", "slot_count", "donation", "per_coalition_bytes",
                           "donated_bytes_per_coalition", "cap_before_donation",
                           "cap_after_donation", "cap_effective", "hbm_bytes_limit",
                           "peak_in_use_bytes", "fixed_bytes"}
    assert hbm[0]["fixed_bytes"] == eng._batch_fixed_bytes(3)
    assert hbm[0]["donation"] is False and hbm[0]["donated_bytes_per_coalition"] == 0
    assert hbm[0]["cap_effective"] == eng._device_batch_cap(3) == 16
    assert hbm[0]["per_coalition_bytes"] == eng._per_coalition_bytes(3)


def test_ladder_exhausted_is_recorded_and_permanent(tmp_path):
    eng = CharacteristicEngine(scenario())
    eng._cap_halvings = 3
    oom = faults.InjectedOom("CUDA out of memory: last rung")
    with trace.collect() as recs:
        err = eng._ladder_exhausted(oom)
    assert isinstance(err, faults.LadderExhaustedError)
    assert not faults.is_transient(err) and not faults.is_oom(err)
    assert err.halvings == 3 and err.mode == "2d"
    assert metrics.snapshot()["counters"]["engine.ladder_exhausted"] == 1
    assert [r["attrs"]["action"] for r in recs if r["name"] == "engine.degrade"] == [
        "ladder_exhausted"]
    assert err.postmortem_path and Path(err.postmortem_path).parent == tmp_path / "flight"
    with open(err.postmortem_path) as f:
        doc = json.load(f)
    assert doc["reason"] == "ladder_exhausted" and doc["extra"]["halvings"] == 3
    assert str(err.postmortem_path) in str(err)


def test_eval_chunk_knob_is_read_at_import():
    code = "from mplc_tpu_torch import constants; print(constants.EVAL_CHUNK_SIZE)"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**env, "MPLC_TORCH_EVAL_CHUNK": "512"}, check=True)
    assert out.stdout.strip() == "512"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**env, "MPLC_TORCH_EVAL_CHUNK": "0"}, check=True)
    assert out.stdout.strip() == "2048" and "MPLC_TORCH_EVAL_CHUNK" in out.stderr


def test_gradient_calls_hold_a_fixed_model_count():
    """`TrainConfig.fixed_call_width`: a step's N models in calls of
    exactly M = `Model.grad_call_width` (the last padded with copies of
    its first model, their results dropped) give each model the
    gradients of an unsplit call (Titanic's dense model at M = 3, whose
    per-model arithmetic is the same in any call of two or more models
    here), and the engine's trainers take the rule."""
    import dataclasses

    from mplc_tpu_torch.models import zoo
    from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig

    cfg = TrainConfig(epoch_count=1, minibatch_count=1, gradient_updates_per_pass=1)
    model = dataclasses.replace(zoo.TITANIC_LOGREG, grad_call_width=3)
    whole = MplTrainer(model, cfg)
    split = MplTrainer(model, dataclasses.replace(cfg, fixed_call_width=True))
    g = torch.Generator().manual_seed(0)
    trees = [model.init(g) for _ in range(7)]
    params = {k: {n: torch.stack([t[k][n] for t in trees]) for n in trees[0][k]}
              for k in trees[0]}
    x = torch.rand(7, 20, 27, generator=g)
    y = (torch.rand(7, 20, 1, generator=g) > 0.5).float()
    m = torch.ones(7, 20)
    split.call_log = []
    (ga, (la, (aa, ca))), (gb, (lb, (ab, cb))) = (
        tr._model_grads(params, x, y, m, ()) for tr in (whole, split))
    assert split.call_log == [("grad", 3, 20)] * 3
    for k in ga:
        for n in ga[k]:
            assert ga[k][n].shape == gb[k][n].shape
            assert torch.equal(ga[k][n], gb[k][n]), (k, n)
    assert all(torch.equal(a, b) for a, b in ((la, lb), (aa, ab), (ca, cb)))
    eng = CharacteristicEngine(scenario())
    assert eng._multi_cfg.fixed_call_width
    assert eng._slot_pipe(3).trainer.cfg.fixed_call_width


def test_a_narrower_rerun_pads_its_gradient_calls_to_the_first_width(monkeypatch):
    """At cap 4: the singles (batch 1) and the width-3 slot bucket's 10
    coalitions (batches 2-4) at width 4, then the width-4 bucket's one.
    Batch 3's harvest OOMs: its 4 coalitions run again at width 2, as does
    the rest of the call. Every gradient call of every batch, the re-runs
    included, holds the model's call width (`Model.grad_call_width`), so
    the values are bit-equal to the clean run."""
    monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "4")
    clean, _ = sweep(monkeypatch)
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "oom@harvest3")
    eng = CharacteristicEngine(scenario())
    seen, calls = [], []
    for pipe in [eng.single_pipe] + [eng._slot_pipe(k) for k in (3, 4)]:
        inner = pipe.dispatch_async

        def dispatch_async(coal, *a, inner=inner, **kw):
            seen.append(coal.shape[0])
            out = inner(coal, *a, **kw)
            calls.extend(a[7] if len(a) > 7 else kw.get("call_log") or [])
            return out
        pipe.dispatch_async = dispatch_async
    np.testing.assert_array_equal(eng.evaluate(SUBSETS), clean)
    assert seen == [4, 4, 4, 2, 2, 2, 1]
    M = eng.model.grad_call_width
    grads = [c for c in calls if c[0] == "grad"]
    assert grads and all(models == M for _, models, _ in grads)