"""Device cost on the CPU, one torch thread (`mplc_tpu_torch/obs/devcost.py`
against `mplc_tpu/obs/devcost.py`):

- `fence_interval` (its knob parse included) and `should_fence` equal the
  JAX package's over ordinals 1-1000 and several rates;
- `DeviceMeter`, `meter_delta`, `estimate_device_seconds` (its four bases)
  and `merge_basis` equal the JAX package's on the same notes, exactly;
  eval-only and CPU-degraded batches never enter the fenced rate;
- the peak tables give the H100's figures and None for any other device;
- fences at any rate leave every v(S) of a Titanic sweep bit-equal, under
  a batch-fault plan too; at rate 1 every batch is fenced and counted, and
  each batch's counted FLOPs equal `FlopCounterMode`'s count of the batch
  itself;
- the port's sweep report shows a `device_time` row (basis "fenced") and
  the compute row's FLOP-based utilization from a fenced port stream.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mplc_tpu.obs import devcost as jdevcost
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data import datasets
from mplc_tpu_torch.obs import devcost, metrics, report, trace
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

SUBSETS = powerset_order(4)


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for k in ("DEVICE_FENCE_RATE", "FAULT_PLAN", "NUMERICS_LEDGER", "NUMERICS_AUDIT",
                  "COALITIONS_PER_DEVICE", "SEED_ENSEMBLE"):
            monkeypatch.delenv(pkg + k, raising=False)
    monkeypatch.setenv("MPLC_TORCH_RETRY_BACKOFF_SEC", "0")
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("raw", [None, "0", "1", "0.5", "0.0625", "0.3", "3", "1e-3",
                                 "-1", "nan", "fast"])
def test_fence_interval_and_should_fence_match_jax(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv(constants.DEVICE_FENCE_RATE_ENV, raw)
        monkeypatch.setenv("MPLC_TPU_DEVICE_FENCE_RATE", raw)
    with pytest.warns(UserWarning) if raw in ("-1", "nan", "fast") else _nothing():
        ours = devcost.fence_interval()
    with pytest.warns(UserWarning) if raw in ("-1", "nan", "fast") else _nothing():
        theirs = jdevcost.fence_interval()
    assert ours == theirs
    for rate in (None, 0.0, 1.0, 0.5, 1 / 16, 0.3, 2.5, 1e-4):
        if rate is not None:
            assert devcost.fence_interval(rate) == jdevcost.fence_interval(rate)
    for interval in sorted({ours, 0, 1, 2, 3, 7, 16, 1000}):
        assert [devcost.should_fence(o, interval) for o in range(1, 1001)] == \
            [jdevcost.should_fence(o, interval) for o in range(1, 1001)]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _notes(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(40):
        kind = rng.integers(0, 5)
        out.append(dict(
            coalitions=int(rng.integers(1, 17)), span_sec=float(rng.random()),
            device_sec=float(rng.random() / 2) if kind == 1 else None,
            flops=float(rng.random() * 1e12) if kind in (1, 2) else None,
            bytes_accessed=float(rng.random() * 1e9) if kind == 2 else None,
            eval_only=bool(kind == 3), degraded=bool(kind == 4)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_meter_matches_jax(seed):
    ours, theirs = devcost.DeviceMeter(4), jdevcost.DeviceMeter(4)
    notes = _notes(seed)
    snaps = []
    for i, kw in enumerate(notes):
        ours.note(**kw)
        theirs.note(**kw)
        if i in (9, 29):
            snaps.append((ours.snapshot(), theirs.snapshot()))
    assert devcost._METER_FIELDS == jdevcost._METER_FIELDS
    assert ours.snapshot() == theirs.snapshot()
    (a0, b0), (a1, b1) = snaps
    delta = devcost.meter_delta(a0, a1)
    assert delta == jdevcost.meter_delta(b0, b1)
    for totals in (ours.snapshot(), delta, {}, {"span_sec": 1.5},
                   {"coalitions": 8, "flops": 2e12, "costed_coalitions": 4},
                   {"coalitions": 8, "eval_coalitions": 8, "eval_span_sec": 0.5},
                   {"coalitions": 6, "fenced_coalitions": 2, "fenced_sec": 0.4,
                    "degraded_coalitions": 2, "degraded_span_sec": 3.0}):
        for peak in (None, 67e12, 989e12):
            assert devcost.estimate_device_seconds(totals, peak) == \
                jdevcost.estimate_device_seconds(totals, peak)
    assert ours.device_seconds(67e12) == theirs.device_seconds(67e12)
    bases = [None, "fenced", "cost_model", "host_span", "none"]
    for a in bases:
        for b in bases:
            assert devcost.merge_basis(a, b) == jdevcost.merge_basis(a, b)


def test_eval_only_and_degraded_batches_stay_out_of_the_fenced_rate():
    m = devcost.DeviceMeter(1)
    m.note(4, span_sec=2.0, device_sec=1.0)            # 0.25 s a training coalition
    m.note(64, span_sec=0.5, eval_only=True)
    m.note(8, span_sec=30.0, degraded=True)
    m.note(4, span_sec=2.0)                            # unfenced training
    sec, basis = m.device_seconds()
    assert basis == "fenced"
    assert sec == pytest.approx(0.25 * 8 + 0.5 + 30.0)
    snap = m.snapshot()
    assert (snap["fenced_coalitions"], snap["eval_coalitions"],
            snap["degraded_coalitions"]) == (4, 64, 8)
    # nothing but eval-only and degraded work: no training rate to bill at
    m2 = devcost.DeviceMeter(1)
    m2.note(64, span_sec=0.5, eval_only=True, device_sec=0.1)
    assert m2.device_seconds() == (0.5, "host_span")


def test_peak_tables():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"):
        assert devcost.peak_flops_per_chip(name) == 989e12
        assert devcost.peak_flops_per_chip(name, "tf32") == 494.7e12
        assert devcost.peak_flops_per_chip(name, "fp32") == 67e12
        assert devcost.hbm_bytes_per_s_per_chip(name) == 3.35e12
    for name in ("cpu", "", None, "NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB",
                 "TPU v5 lite"):
        assert devcost.peak_flops_per_chip(name) is None
        assert devcost.hbm_bytes_per_s_per_chip(name) is None


def _scenario() -> Scenario:
    sc = Scenario(4, [0.1, 0.2, 0.3, 0.4], is_dry_run=True, dataset=datasets.load_titanic(),
                  seed=5, epoch_count=2, minibatch_count=2,
                  gradient_updates_per_pass_count=2, is_early_stopping=False, device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def _sweep(monkeypatch, rate: str, plan: str | None = None):
    monkeypatch.setenv(constants.DEVICE_FENCE_RATE_ENV, rate)
    if plan:
        monkeypatch.setenv(constants.FAULT_PLAN_ENV, plan)
        monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "4")
    eng = CharacteristicEngine(_scenario())
    with trace.collect() as records:
        values = eng.evaluate(SUBSETS)
    monkeypatch.delenv(constants.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(constants.COALITIONS_PER_DEVICE_ENV, raising=False)
    return values, eng, records


@pytest.mark.parametrize("plan", [None, "transient@batch2,oom@harvest3"])
def test_fences_leave_every_value_bit_equal(monkeypatch, plan):
    base, eng0, _ = _sweep(monkeypatch, "0", plan)
    assert eng0.device_meter.snapshot()["fenced_batches"] == 0
    for rate in ("1", "0.5", "0.0625"):
        values, eng, records = _sweep(monkeypatch, rate, plan)
        np.testing.assert_array_equal(values, base)
        interval = devcost.fence_interval(float(rate))
        fenced = [r["attrs"]["ordinal"] for r in records if r["name"] == "engine.device_fence"]
        batches = [r["attrs"]["ordinal"] for r in records if r["name"] == "engine.batch"]
        assert fenced == [o for o in batches if devcost.should_fence(o, interval)]
        assert eng.device_meter.snapshot()["fenced_batches"] == len(fenced)
        assert eng.device_meter.snapshot()["batches"] == len(batches)


def test_counted_flops_are_the_batch_flops(monkeypatch):
    """Each batch's FLOPs (logged calls, counted on meta tensors) equal
    FlopCounterMode's count of the same batch run for real (Titanic's
    dense model, which the counter counts alike in any call)."""
    monkeypatch.setenv(constants.DEVICE_FENCE_RATE_ENV, "1")
    eng = CharacteristicEngine(_scenario())
    for subsets in ([(0,), (1,), (3,)], [(0, 1), (1, 2, 3)], [(0, 1, 2, 3)]):
        with trace.collect() as records:
            eng.evaluate(subsets)
        (rec,) = [r for r in records if r["name"] == "engine.batch"]
        k, b = rec["attrs"]["slot_count"], rec["attrs"]["width"]
        pipe = eng.single_pipe if k is None else eng._slot_pipe(k)
        coal = torch.from_numpy(eng._coalition_arrays(subsets, k))
        coal = torch.cat([coal, coal[:1].expand((b - len(subsets),) + coal.shape[1:])])
        gens = [eng.coalition_generator(s) for s in subsets + [subsets[0]] * (b - len(subsets))]
        with FlopCounterMode(display=False) as counter:
            pipe.dispatch_async(coal, gens, eng.stacked, eng.val, eng.test)()
        assert rec["attrs"]["flops"] == float(counter.get_total_flops()) > 0


@pytest.mark.parametrize("name,shape", [("mnist_cnn", (28, 28, 1)), ("cifar10_cnn", (32, 32, 3)),
                                        ("esc50_cnn", (40, 431, 1))])
def test_a_calls_flops_are_its_models_own(name, shape):
    """A gradient call of N models counts N times one model's gradient,
    counted without vmap (the counter takes vmap's grouped convolution's
    backward for an ungrouped one, so the port counts one model and
    scales)."""
    from mplc_tpu_torch.models import zoo
    from mplc_tpu_torch.mpl.engine import call_flops
    from mplc_tpu_torch.ops.metrics import masked_loss_and_metrics
    model = zoo.MODELS[name]
    p = model.init(torch.Generator().manual_seed(0))
    x, L = torch.rand((7,) + shape), model.num_outputs
    y = torch.nn.functional.one_hot(torch.arange(7) % L, L).float()
    drop = tuple(torch.ones((7,) + s, dtype=torch.bool) for _, s in model.dropout) or None

    def loss(q):
        return masked_loss_and_metrics(model.loss_kind, model.apply(q, x, dropout=drop), y,
                                       torch.ones(7))[0]
    with FlopCounterMode(display=False) as counter:
        torch.func.grad(loss)(p)
    one = float(counter.get_total_flops())
    for n in (1, 6, 16):
        assert call_flops(model, [("grad", n, 7)], torch.zeros((1, 7) + shape)) == n * one


def test_report_has_a_fenced_device_time_row(monkeypatch):
    _, eng, records = _sweep(monkeypatch, "1")
    rep = report.sweep_report(records, peak_flops=67e12)
    dt = rep["device_time"]
    assert dt["basis"] == "fenced" and dt["fence_interval"] == 1
    assert dt["fenced_batches"] == len(eng.batch_log) == rep["batches"]["count"]
    assert dt["device_s"] == pytest.approx(eng.device_meter.device_seconds()[0])
    comp = rep["compute"]
    assert comp["model_flops_xla"] == eng.device_meter.snapshot()["flops"] > 0
    assert comp["mfu_xla_basis"] == "device_fenced" and comp["mfu_xla"] > 0
    assert {row["basis"] for row in rep["roofline"]["programs"]} == {"device_fenced"}
    text = report.format_report(rep)
    assert "device      fenced=" in text and "[fenced]" in text
    assert metrics.histogram("engine.device_step_sec").count == len(eng.batch_log)
