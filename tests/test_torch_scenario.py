"""The port's `Scenario` against the JAX package's on the arguments where
they used to part: each case builds both on the same arguments (Titanic, 3
partners, a dry run; the port on the CPU) and expects the same outcome,
the same exception type or the same `aggregation_name` and
`corrupted_datasets`:

(a) `corrupted_datasets=[]` is a list of no specs (the count check
    raises), not the default;
(b) `aggregation_weighting=None` means "data-volume";
(c) `aggregation=` is an alias of `aggregation_weighting`, and a
    conflicting pair raises ValueError with the JAX package's message;
(d) the rest of the constructor: an unknown keyword argument raises the
    JAX package's message; `dataset_proportion` and `is_quick_demo` give
    byte-equal arrays (small synthetic MNIST) and the same refusals; the
    scenario's names; `partner_shards` taken, an indivisible shard count
    raising the JAX package's "must divide" when the engine is built, in
    both packages; `compute_dtype=
    "bfloat16"` computing the model in bf16 under the fp32 precision mode
    in both packages.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.mpl import approaches as japproaches
from mplc_tpu.scenario import Scenario as JScenario
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.mpl import approaches
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]


def _both(**kw):
    """(JAX outcome, port outcome): the built scenario's aggregation name
    and corruption specs, or the exception raised (its type; its message
    too for the conflicting aggregation pair, the one the port copies)."""
    out = []
    for build in (lambda: JScenario(3, AMOUNTS, dataset=jdatasets.load_titanic(),
                                    is_dry_run=True, **kw),
                  lambda: Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(),
                                   is_dry_run=True, device="cpu", **kw)):
        try:
            sc = build()
        except Exception as e:  # noqa: BLE001 - the outcome compared
            out.append((type(e), str(e) if "aggregation" in kw else None))
        else:
            out.append((sc.aggregation_name, list(sc.corrupted_datasets)))
    return out


CASES = {
    "no corruption specs": dict(corrupted_datasets=[]),
    "default corruption": dict(corrupted_datasets=None),
    "weighting None": dict(aggregation_weighting=None),
    "no weighting": dict(),
    "alias": dict(aggregation="uniform"),
    "alias spelled": dict(aggregation="local_score"),
    "alias agreeing": dict(aggregation="data_volume", aggregation_weighting="data-volume"),
    "alias conflicting": dict(aggregation="uniform", aggregation_weighting="local-score"),
    "alias unknown": dict(aggregation="median"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_outcome_as_jax(case):
    jax_out, port_out = _both(**CASES[case])
    assert port_out == jax_out


def test_the_repaired_outcomes():
    """What the cases above pin, spelled out."""
    with pytest.raises(ValueError, match="0 entries for 3 partners"):
        Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                 device="cpu", corrupted_datasets=[])
    sc = Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                  device="cpu", aggregation_weighting=None)
    assert sc.aggregation_name == "data-volume"
    assert sc.corrupted_datasets == ["not_corrupted"] * 3
    sc = Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                  device="cpu", aggregation="uniform")
    assert sc.aggregation_name == "uniform"
    with pytest.raises(ValueError, match="Conflicting aggregation settings"):
        Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                 device="cpu", aggregation="uniform", aggregation_weighting="local-score")


# ---------------------------------------------------------------------------
# (d) the rest of the constructor
# ---------------------------------------------------------------------------

MNIST_SCALE = 0.02
ARRAYS = ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test")


@pytest.fixture
def mnist_env(monkeypatch, tmp_path):
    """Synthetic MNIST at MNIST_SCALE for the JAX loader (no cache)."""
    monkeypatch.setenv("MPLC_TPU_SYNTH_SCALE", str(MNIST_SCALE))
    monkeypatch.delenv("MPLC_TPU_SYNTH_NOISE", raising=False)
    for knob in ("MPLC_TPU_DATA_DIR", "MPLC_TORCH_DATA_DIR"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))


def _outcomes(**kw):
    """(JAX, port): each built on its own fresh synthetic MNIST, a dry run;
    the scenario or the exception raised."""
    out = []
    for build in (lambda: JScenario(3, AMOUNTS, dataset=jdatasets.load_mnist(),
                                    is_dry_run=True, **kw),
                  lambda: Scenario(3, AMOUNTS, dataset=tdatasets.load_mnist(scale=MNIST_SCALE),
                                   is_dry_run=True, device="cpu", **kw)):
        try:
            out.append(build())
        except Exception as e:  # noqa: BLE001 - the outcome compared
            out.append(e)
    return out


@pytest.mark.parametrize("kw", [dict(dataset_proportion=0.3), dict(is_quick_demo=True),
                                dict(is_quick_demo=True, seed=5)],
                         ids=["proportion", "quick demo", "quick demo seed 5"])
def test_shrunk_datasets_are_byte_equal(mnist_env, kw):
    jsc, sc = _outcomes(**kw)
    for name in ARRAYS:
        a, b = getattr(jsc.dataset, name), getattr(sc.dataset, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert (sc.epoch_count, sc.minibatch_count, sc.nb_samples_used) == \
        (jsc.epoch_count, jsc.minibatch_count, jsc.nb_samples_used)
    if kw.get("is_quick_demo"):
        assert (sc.epoch_count, sc.minibatch_count) == (3, 2)
        assert [len(getattr(sc.dataset, n)) for n in ("x_train", "x_val", "x_test")] == \
            [1000, 120, 200]
    else:
        assert len(sc.dataset.x_train) == round(0.3 * 1080)


@pytest.mark.parametrize("kw", [dict(dataset_proportion=0), dict(dataset_proportion=1.5),
                                dict(dataset_proportion=0.5, is_quick_demo=True),
                                dict(unknown_knob=1, other=2)],
                         ids=["proportion 0", "proportion 1.5", "quick demo of a part",
                              "unknown keys"])
def test_refusals_match_jax(mnist_env, kw):
    jerr, err = _outcomes(**kw)
    assert type(jerr) is type(err) and isinstance(err, Exception)
    assert str(err) == str(jerr)
    if "other" in kw:
        assert str(err) == ("Unrecognised parameters ['unknown_knob', 'other'], "
                            "check your configuration")


def test_names_ids_and_partner_shards():
    sc = Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                  device="cpu", scenario_id=7, repeats_count=2, partner_shards=1)
    assert re.fullmatch(r"scenario_7_repeat_2_\d{4}-\d{2}-\d{2}_\d{2}h\d{2}_[0-9a-f]{3}",
                        sc.scenario_name)
    assert sc.short_scenario_name == "3 [0.2, 0.3, 0.5]"
    assert sc.partner_shards == 1 and not sc.save_folder.exists()
    # the 2-D mode: the Scenario takes the value; at a world of 1 the
    # engine raises the JAX package's "must divide" (tests/test_torch_sharding.py)
    sc2 = Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                   device="cpu", partner_shards=3)
    assert sc2.partner_shards == 3
    sc2.instantiate_scenario_partners()
    sc2.split_data(is_logging_enabled=False)
    with pytest.raises(ValueError, match="must divide both the partner count"):
        CharacteristicEngine(sc2)
    from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
    jsc = JScenario(3, AMOUNTS, dataset=jdatasets.load_titanic(), is_dry_run=True,
                    partner_shards=3)
    jsc.instantiate_scenario_partners()
    jsc.split_data(is_logging_enabled=False)
    with pytest.raises(ValueError, match="must divide both the partner count"):
        JEngine(jsc)
    for build in (lambda: JScenario(3, AMOUNTS, dataset=jdatasets.load_titanic(),
                                    is_dry_run=True, partner_shards=0),
                  lambda: Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(),
                                   is_dry_run=True, device="cpu", partner_shards=0)):
        with pytest.raises(ValueError, match="partner_shards must be >= 1"):
            build()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_compute_dtype_under_fp32(monkeypatch, compute_dtype):
    for knob in ("MPLC_TPU_PRECISION", "MPLC_TORCH_PRECISION"):
        monkeypatch.delenv(knob, raising=False)
    scs = [build() for build in (
        lambda: JScenario(3, AMOUNTS, dataset=jdatasets.load_titanic(), is_dry_run=True,
                          compute_dtype=compute_dtype),
        lambda: Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                         device="cpu", compute_dtype=compute_dtype))]
    for sc in scs:
        sc.instantiate_scenario_partners()
        sc.split_data(is_logging_enabled=False)
        sc.compute_batch_sizes()
    jmpl = japproaches.FederatedAverageLearning(scs[0])
    mpl = approaches.FederatedAverageLearning(scs[1])
    assert jmpl.cfg.precision == mpl.cfg.precision == "fp32"
    bf16 = compute_dtype == "bfloat16"
    assert jmpl.cfg.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    assert mpl.cfg.dtype == (torch.bfloat16 if bf16 else torch.float32)
    eng = CharacteristicEngine(scs[1])
    assert eng._multi_cfg.dtype == mpl.cfg.dtype
    assert eng._fingerprint()["compute_dtype"] == compute_dtype
    with pytest.raises(ValueError, match="compute_dtype"):
        Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), is_dry_run=True,
                 device="cpu", compute_dtype="float16")
