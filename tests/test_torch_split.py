"""The advanced split of the PyTorch port against the JAX package's, on
small synthetic MNIST (the same bytes in both packages): each partner's
train, val and test arrays, clusters and sample counts, and the scenario's
`nb_samples_used` and `final_relative_nb_samples`, byte-equal, through
`Scenario.split_data_advanced` on `configs/config_quick_debug.yml`'s
spec and on the `[cli]` phase's of `chip_smoke.py`; both assertion paths
give the JAX package's exception and message."""

import numpy as np
import pytest
import torch

from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.scenario import Scenario as JScenario
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

SCALE = 0.02
SPECS = {
    # configs/config_quick_debug.yml
    "quick debug": ([0.2, 0.5, 0.3], [[4, "shared"], [6, "shared"], [4, "specific"]], 2),
    # chip_smoke.py [cli]: 3 + 3 specific clusters and 4 shared, of 10 labels
    "chip smoke": ([0.1, 0.2, 0.3, 0.4],
                   [[3, "specific"], [3, "specific"], [4, "shared"], [2, "shared"]], 10),
    # more clusters than labels
    "too many clusters": ([0.5, 0.5], [[6, "specific"], [5, "shared"]], 2),
    # more minibatches than a partner's rows
    "too few rows": ([0.2, 0.5, 0.3], [[4, "shared"], [6, "shared"], [4, "specific"]], 10 ** 6),
}
PARTNER_FIELDS = ("cluster_count", "cluster_split_option", "clusters_list",
                  "final_nb_samples", "final_nb_samples_p_cluster")
ARRAYS = ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test")


@pytest.fixture
def datasets(monkeypatch, tmp_path):
    """Synthetic MNIST at SCALE in both packages (no cache, no noise knob)."""
    monkeypatch.setenv("MPLC_TPU_SYNTH_SCALE", str(SCALE))
    monkeypatch.delenv("MPLC_TPU_SYNTH_NOISE", raising=False)
    monkeypatch.delenv("MPLC_TPU_DATA_DIR", raising=False)
    monkeypatch.delenv("MPLC_TORCH_DATA_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    return jdatasets.load_mnist(), tdatasets.load_mnist(scale=SCALE)


def _split(build):
    """The scenario after its advanced split, or the exception it raised."""
    sc = build()
    sc.instantiate_scenario_partners()
    try:
        sc.split_data_advanced(is_logging_enabled=False)
    except Exception as e:  # noqa: BLE001 - the outcome compared
        return e
    return sc


def _both(datasets, case):
    amounts, description, minibatch_count = SPECS[case]
    jd, td = datasets
    kw = dict(samples_split_option=["advanced", description], minibatch_count=minibatch_count,
              is_dry_run=True)
    return (_split(lambda: JScenario(len(amounts), amounts, dataset=jd, **kw)),
            _split(lambda: Scenario(len(amounts), amounts, dataset=td, device="cpu", **kw)))


@pytest.mark.parametrize("case", ["quick debug", "chip smoke"])
def test_advanced_split_is_byte_equal(datasets, case):
    jsc, sc = _both(datasets, case)
    assert sc.nb_samples_used == jsc.nb_samples_used
    assert sc.final_relative_nb_samples == jsc.final_relative_nb_samples
    assert len(sc.partners_list) == len(SPECS[case][0])
    for jp, tp in zip(jsc.partners_list, sc.partners_list):
        for field in PARTNER_FIELDS:
            assert getattr(tp, field) == getattr(jp, field), field
        for name in ARRAYS:
            a, b = getattr(jp, name), getattr(tp, name)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
        assert len(tp.x_train) > 0


@pytest.mark.parametrize("case,message", [
    ("too many clusters", "total requested clusters exceed the number of labels"),
    ("too few rows", "doesn't have enough data samples to create the minibatches")])
def test_advanced_split_assertions_match_jax(datasets, case, message):
    jerr, err = _both(datasets, case)
    assert type(jerr) is type(err) is AssertionError
    assert str(err) == str(jerr) and message in str(err)


def test_chip_smoke_split_gives_every_label(datasets):
    """The `[cli]` phase's spec: 3 + 3 specific clusters and 4 shared ones
    cover the 10 labels, the specific ones disjoint."""
    _, sc = _both(datasets, "chip smoke")
    clusters = [set(p.clusters_list) for p in sc.partners_list]
    assert clusters[0].isdisjoint(clusters[1]) and len(clusters[0] | clusters[1]) == 6
    assert clusters[3] <= clusters[2] and len(clusters[2]) == 4
    assert set().union(*clusters) == set(range(10))
