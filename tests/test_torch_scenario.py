"""The port's `Scenario` against the JAX package's on the arguments where
they used to part: each case builds both on the same arguments (Titanic, 3
partners, a dry run; the port on the CPU) and expects the same outcome,
the same exception type or the same `aggregation_name` and
`corrupted_datasets`:

(a) `corrupted_datasets=[]` is a list of no specs (the count check
    raises), not the default;
(b) `aggregation_weighting=None` means "data-volume";
(c) `aggregation=` is an alias of `aggregation_weighting`, and a
    conflicting pair raises ValueError with the JAX package's message.
"""

import pytest
import torch

from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.scenario import Scenario as JScenario
from mplc_tpu_torch.data import datasets as tdatasets
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
