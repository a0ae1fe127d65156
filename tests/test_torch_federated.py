"""The contributivity methods that read the grand coalition's training, in
the PyTorch port against the JAX package, on the CPU:

(a) Federated SBS linear, quadratic and constant bit-equal to the JAX
    package's on the same history matrices, NaNs and a zero collective
    accuracy included; the warning under another approach than fedavg;
(b) PVRL on Titanic, 3 partners, against the JAX package's `PVRL(0.2)`,
    the port fed JAX's initial params and per-epoch permutations: the same
    selection masks drawn, values within 1e-4;
(c) GTG-Shapley under a seq approach raising ValueError in both packages
    (update recording is fedavg's);
(d) `Scenario.run()` under each of the four approaches this slice adds.
"""

import logging
import types

import numpy as np
import pytest
import torch

import jax

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.mpl.engine import MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.mpl.engine import EpochStreams
from mplc_tpu_torch.scenario import Scenario
from test_torch_slice import _tiny_mnist
from test_torch_sweep import AMOUNTS, _np, _stacked_np

torch.set_num_threads(1)

SBS = {"Federated SBS linear": "Federated step by step linear scores",
       "Federated SBS quadratic": "Federated step by step quadratic scores",
       "Federated SBS constant": "Federated step by step constant scores"}


def _history_scenario(approach="fedavg", zero_round=False, E=6, MB=5, P=3, seed=0):
    """A stand-in scenario holding only what the SBS methods read: a
    history of val accuracies with NaN cells (a partner outside a round),
    and with `zero_round` a round whose collective accuracy is 0."""
    g = np.random.default_rng(seed)
    hist = {i: {"val_accuracy": g.uniform(0.1, 0.9, (E, MB))} for i in range(P)}
    hist[1]["val_accuracy"][2, 1:3] = np.nan
    hist[2]["val_accuracy"][:, 4] = np.nan
    coll = g.uniform(0.2, 0.9, (E, MB))
    if zero_round:
        coll[3, 2] = 0.0
    hist["mpl_model"] = {"val_accuracy": coll, "val_loss": np.zeros((E, MB))}
    return types.SimpleNamespace(
        partners_list=[types.SimpleNamespace(id=i) for i in range(P)], seed=seed,
        multi_partner_learning_approach_key=approach,
        mpl=types.SimpleNamespace(history=types.SimpleNamespace(history=hist)),
        _charac_engine=types.SimpleNamespace(batch_log=[]))


# ---------------------------------------------------------------------------
# (a) the step-by-step scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_round", [False, True], ids=["", "zero_round"])
@pytest.mark.parametrize("method", sorted(SBS))
def test_sbs_is_bit_equal_to_jax(method, zero_round):
    c = Contributivity(_history_scenario(zero_round=zero_round))
    jc = JContributivity(_history_scenario(zero_round=zero_round))
    with np.errstate(invalid="ignore"):
        c.compute_contributivity(method)
        jc.compute_contributivity(method)
    assert c.name == jc.name == SBS[method]
    # a collective accuracy of 0 divides to inf in both packages
    assert np.isfinite(c.contributivity_scores).all() != zero_round
    for a, b in ((c.contributivity_scores, jc.contributivity_scores),
                 (c.normalized_scores, jc.normalized_scores),
                 (c.compute_relative_perf_matrix(), jc.compute_relative_perf_matrix())):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # 30 rounds: 3 skipped at each end
    assert c.compute_relative_perf_matrix().shape == (24, 3)


def test_sbs_warns_under_another_approach(caplog):
    with caplog.at_level(logging.WARNING):
        Contributivity(_history_scenario("seqavg")).compute_contributivity(
            "Federated SBS linear")
        JContributivity(_history_scenario("seqavg")).compute_contributivity(
            "Federated SBS linear")
        Contributivity(_history_scenario()).compute_contributivity("Federated SBS linear")
    text = "Step by step contributivity methods are only suited"
    assert [r.name for r in caplog.records if text in r.getMessage()] == \
        ["mplc_tpu_torch", "mplc_tpu"]


# ---------------------------------------------------------------------------
# (b) PVRL
# ---------------------------------------------------------------------------

class _Recorder:
    """An rng whose binomial draws are recorded."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def binomial(self, *args, **kwargs):
        out = self.rng.binomial(*args, **kwargs)
        self.draws.append(np.array(out))
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


def test_pvrl_matches_jax(monkeypatch):
    game = dict(epoch_count=6, minibatch_count=2, gradient_updates_per_pass_count=2)
    jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **game)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3,
                  device="cpu", is_early_stopping=False, **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    jc, c = JContributivity(jsc), Contributivity(sc)
    jc._rng, c._rng = _Recorder(jc._rng), _Recorder(c._rng)

    # JAX's PVRL: rng = PRNGKey(seed + 99) draws the initial params; epoch e
    # runs a one-epoch chunk on fold_in(rng, e) from state epoch e
    rng = jax.random.PRNGKey(3 + 99)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(minibatch_count=2))
    mask = jc.engine.stacked.mask
    perms = np.stack([np.array(jtr.gen_epoch_streams(jax.random.fold_in(rng, e), mask, e, 1)[0][0])
                      for e in range(game["epoch_count"])])
    init = params_from_numpy(_stacked_np([_np(jzoo.TITANIC_LOGREG.init(rng))]))
    monkeypatch.setattr(c, "_pvrl_start", lambda trainer: (
        None, init, EpochStreams(torch.from_numpy(perms)[None])))

    jc.compute_contributivity("PVRL")
    c.compute_contributivity("PVRL")
    assert c.name == jc.name == "PVRL"
    assert len(c._rng.draws) == len(jc._rng.draws) >= game["epoch_count"]
    for a, b in zip(c._rng.draws, jc._rng.draws):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(c.contributivity_scores, jc.contributivity_scores,
                               rtol=0, atol=1e-4)
    v = c.contributivity_scores
    assert ((v > 0) & (v < 1)).all() and np.abs(v - 0.5).max() > 1e-4   # it learned


# ---------------------------------------------------------------------------
# (c) the retrain-free methods need fedavg's recording
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", ["seq-pure", "seqavg"])
def test_gtg_under_a_seq_approach_raises(approach):
    jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True,
                         multi_partner_learning_approach=approach)
    with pytest.raises(ValueError, match="fedavg approach only"):
        JContributivity(jsc).compute_contributivity("GTG-Shapley")
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), device="cpu",
                  multi_partner_learning_approach=approach, epoch_count=2)
    sc.instantiate_scenario_partners()
    sc.split_data()
    with pytest.raises(ValueError, match="fedavg approach only"):
        Contributivity(sc).compute_contributivity("GTG-Shapley")


# ---------------------------------------------------------------------------
# (d) the Scenario under each new approach
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", ["seq-pure", "seq-with-final-agg", "seqavg", "lflip"])
def test_scenario_runs_every_approach(approach):
    lflip = approach == "lflip"
    sc = Scenario(3, AMOUNTS, is_dry_run=True, device="cpu",
                  dataset=_tiny_mnist() if lflip else tdatasets.load_titanic(),
                  multi_partner_learning_approach=approach, epoch_count=2,
                  minibatch_count=2, gradient_updates_per_pass_count=1 if lflip else 2)
    sc.run()
    h = sc.mpl.history
    assert type(sc.mpl).approach_key == approach
    assert 0.0 <= h.score <= 1.0 and h.nb_epochs_done == 2
    assert not np.isnan(h.history["mpl_model"]["val_loss"]).any()
    for i in range(3):
        assert not np.isnan(h.history[i]["val_accuracy"]).any()
    if lflip:
        assert len(h.theta) == 2 and all(t.shape == (10, 10) for t in h.theta[-1])
        np.testing.assert_allclose([t.sum(1) for t in h.theta[-1]], 1.0, rtol=0, atol=1e-5)
    else:
        assert h.theta is None
    with pytest.raises(KeyError, match="not a valid approach"):
        Scenario(3, AMOUNTS, is_dry_run=True, device="cpu", dataset=tdatasets.load_titanic(),
                 multi_partner_learning_approach="no-such-approach")
