"""Slot execution of the retraining sweep and the deterministic reduce of the
PyTorch port, on the CPU:

(a) the slot trainer against the masked trainer on the same streams, a
    batch of coalitions, on Titanic and a tiny MNIST CNN: within 1e-6 under
    the default reduce, bit-equal under the deterministic one;
(b) the slot trainer against the JAX package's slot trainer on its initial
    params and permutations;
(c) the slot widths and buckets against the JAX engine's, in every mode;
(d) the 5-partner Titanic v(S) table, the same in every bucketing mode and
    masked;
(e) the config guards and the routing;
(f) `ordered_fold` against a numpy left fold, and what `torch.sum` does
    instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.mpl.engine import MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.ops.aggregation import aggregate, aggregation_weights, ordered_fold
from mplc_tpu_torch.scenario import Scenario
from test_torch_slice import _tiny_mnist
from test_torch_sweep import AMOUNTS, _assert_trees_close, _np, _problem, _stacked_np

torch.set_num_threads(1)

AMOUNTS5 = [0.1, 0.15, 0.2, 0.25, 0.3]
MASKS = [[1., 0., 1.], [1., 1., 0.]]
SLOT_IDS = {2: [[0, 2], [0, 1]], 3: [[0, 2, -1], [0, 1, -1]]}


def _port_problem(dataset):
    parts = [Partner(i) for i in range(3)]
    split_basic(dataset, parts, AMOUNTS, "random", 2)
    label_dim = dataset.model.label_dim()
    return (StackedPartners.build(parts, label_dim, "cpu"),
            stage_eval_set(dataset.x_val, dataset.y_val, label_dim, "cpu"))


def _tinier_mnist():
    """The tiny MNIST CNN dataset cut to 150 training rows (the CNN trains
    slowly on the CPU)."""
    d = _tiny_mnist()
    d.x_train, d.y_train = d.x_train[:150], d.y_train[:150]
    return d


DATASETS = {"titanic": tdatasets.load_titanic, "mnist_cnn": _tinier_mnist}


def _train(dataset, coal, **cfg):
    """The state after training a batch of coalitions (`coal`: masks or
    slot ids), every coalition drawing from the same seed: Titanic 2 epochs
    of 2 minibatches of 2 steps, the CNN 1 epoch of 2 minibatches of 1
    step."""
    stacked, val = _port_problem(DATASETS[dataset]())
    cnn = dataset == "mnist_cnn"
    epochs = 1 if cnn else 2
    base = dict(approach="fedavg", aggregator="data-volume", epoch_count=epochs,
                minibatch_count=2, gradient_updates_per_pass=1 if cnn else 2,
                is_early_stopping=False, record_partner_val=True)
    tr = MplTrainer(tzoo.MNIST_CNN if cnn else tzoo.TITANIC_LOGREG,
                    TrainConfig(**{**base, **cfg}))
    gens = [torch.Generator().manual_seed(4) for _ in coal]
    state = tr.init_state(gens, 3, "cpu")
    return tr.epoch_chunk(state, stacked, val, torch.tensor(coal), gens, epochs)


def _leaves(tree):
    return [t for d in tree.values() for t in d.values()]


# ---------------------------------------------------------------------------
# (a) slots against masked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deterministic", [False, True], ids=["sum", "fold"])
@pytest.mark.parametrize("slot_count", [2, 3])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_slot_trainer_matches_masked(dataset, slot_count, deterministic):
    """After tests/test_mpl.py:195-225, coalition-batched: coalitions
    {0, 2} and {0, 1} on 2 slots (or 3, one unused) against their masks."""
    masked = _train(dataset, MASKS, deterministic_reduce=deterministic)
    slots = _train(dataset, SLOT_IDS[slot_count], slot_count=slot_count,
                   deterministic_reduce=deterministic)
    rows = [[0, 2], [0, 1]]                       # each coalition's partners
    m_rows = torch.stack([masked.partner_h[i][:, r] for i, r in enumerate(rows)])
    s_rows = torch.stack([slots.partner_h[i][:, r] for i, r in enumerate(rows)])
    if deterministic:
        for a, b in zip(_leaves(masked.params), _leaves(slots.params)):
            assert torch.equal(a, b)
        assert torch.equal(masked.val_loss_h, slots.val_loss_h)
        assert torch.equal(masked.val_acc_h, slots.val_acc_h)
        assert torch.equal(m_rows, s_rows)
    else:
        for a, b in zip(_leaves(masked.params), _leaves(slots.params)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        torch.testing.assert_close(masked.val_loss_h, slots.val_loss_h, rtol=0, atol=1e-5)
        torch.testing.assert_close(m_rows, s_rows, rtol=0, atol=1e-5)
    assert not torch.isnan(s_rows).any()
    # the partner outside each coalition trained in no slot: its rows stay NaN
    assert torch.isnan(slots.partner_h[0][:, 1]).all()
    assert torch.isnan(slots.partner_h[1][:, 2]).all()


# ---------------------------------------------------------------------------
# (b) against the JAX package's slot trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot_count,ids", [(2, [0, 2]), (3, [0, 2, -1])])
def test_slot_trainer_matches_jax(slot_count, ids):
    (jstacked, jval, jtest), (stacked, val, test), n_test = _problem(2)
    cfg = dict(approach="fedavg", aggregator="data-volume", epoch_count=2,
               minibatch_count=2, gradient_updates_per_pass=2,
               is_early_stopping=False, record_partner_val=True, slot_count=slot_count)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    rng = jax.random.PRNGKey(4)
    jstate = jtr.init_state(rng, 3)
    init_np = _np(jstate.params)
    jstate = jax.jit(jtr.epoch_chunk, static_argnames=("n_epochs",))(
        jstate, jstacked, jval, jnp.array(ids, jnp.int32), rng, n_epochs=2)
    _, jacc = jax.jit(jtr.finalize)(jstate, jtest)
    # the slot path draws each partner's stream as the masked path does
    masked = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**{**cfg, "slot_count": None}))
    perms = np.array(masked.gen_epoch_streams(rng, jstacked.mask, 0, 2)[0])

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(_stacked_np([init_np])))
    tr.epoch_chunk(state, stacked, val, torch.tensor([ids]), None, 2,
                   streams_all=torch.from_numpy(perms)[None])
    _, acc = tr.finalize(state, test)
    _assert_trees_close(state.row(0).params, jstate.params, atol=1e-4)
    ph, jph = state.partner_h[0].numpy(), np.asarray(jstate.partner_h)
    np.testing.assert_array_equal(np.isnan(ph), np.isnan(jph))
    np.testing.assert_allclose(ph[:, [0, 2]], jph[:, [0, 2]], rtol=0, atol=1e-4)
    assert abs(float(acc[0]) - float(jacc)) <= 1.0 / n_test + 1e-6


# ---------------------------------------------------------------------------
# (c) slot widths and buckets against the JAX engine's
# ---------------------------------------------------------------------------

MODES = {"merge": {}, "exact": {"SLOT_MERGE": "0"}, "pow2": {"SLOT_POW2": "1"}}


def _set_mode(monkeypatch, mode):
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in ("SLOT_MERGE", "SLOT_POW2", "NO_SLOTS", "DETERMINISTIC_REDUCE"):
            monkeypatch.delenv(pkg + knob, raising=False)
        for knob, value in MODES[mode].items():
            monkeypatch.setenv(pkg + knob, value)


def _port_engine(partners=5, amounts=AMOUNTS5, **game):
    sc = Scenario(partners, amounts, is_dry_run=True, dataset=tdatasets.load_titanic(),
                  seed=3, device="cpu", **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    return CharacteristicEngine(sc)


@pytest.mark.parametrize("partners", [5, 10])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_slot_widths_and_buckets_match_jax(monkeypatch, mode, partners):
    _set_mode(monkeypatch, mode)
    jsc = build_scenario(dataset=jdatasets.load_titanic(), partners_count=5,
                         amounts_per_partner=AMOUNTS5, is_dry_run=True)
    jeng, eng = JEngine(jsc), _port_engine()
    assert eng.scenario.slot_bucketing == jsc.slot_bucketing == mode
    # the width rule reads only the partner count (tests/test_dispatch_fusion.py)
    jeng.partners_count = eng.partners_count = partners
    widths = [eng._slot_width(k) for k in range(2, partners + 1)]
    assert widths == [jeng._slot_width(k) for k in range(2, partners + 1)]
    multis = [s for s in powerset_order(partners) if len(s) > 1]
    assert eng._slot_buckets(multis) == jeng._slot_buckets(multis)
    if mode == "merge" and partners == 10:
        assert sorted(set(widths)) == [3, 5, 7, 9, 10]


# ---------------------------------------------------------------------------
# (d) one v(S) table in every mode
# ---------------------------------------------------------------------------

def test_value_table_is_the_same_in_every_mode(monkeypatch):
    """After tests/test_dispatch_fusion.py:121-153: the 5-partner Titanic
    v(S) table in masked, exact, merge and pow2 execution."""
    subsets = powerset_order(5)
    game = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
    tables, engines = {}, {}
    for mode in ("merge", "exact", "pow2", "masked"):
        _set_mode(monkeypatch, "merge" if mode == "masked" else mode)
        if mode == "masked":
            monkeypatch.setenv(constants.NO_SLOTS_ENV, "1")
        engines[mode] = eng = _port_engine(**game)
        assert eng.scenario.slot_bucketing == mode
        tables[mode] = eng.evaluate(subsets)
    for mode in ("exact", "pow2", "masked"):
        np.testing.assert_array_equal(tables[mode], tables["merge"])
    # the table must discriminate, or the equality is vacuous
    assert tables["merge"].max() - tables["merge"].min() > 1e-3
    # merge: sizes 2-3 share width 3, sizes 4-5 width 5; singles and
    # masked batches carry no slot count
    log = [(b["kind"], b["slot_count"], b["coalitions"]) for b in engines["merge"].batch_log]
    assert log == [("single", None, 5), ("multi", 3, 16), ("multi", 3, 4), ("multi", 5, 6)]
    assert sorted(engines["merge"]._slot_pipes) == [3, 5]
    assert sorted(engines["exact"]._slot_pipes) == [2, 3, 4, 5]
    assert sorted(engines["pow2"]._slot_pipes) == [2, 4, 5]
    assert [b["slot_count"] for b in engines["masked"].batch_log] == [None] * 3


# ---------------------------------------------------------------------------
# (e) config guards and routing
# ---------------------------------------------------------------------------

def test_slot_config_guards(monkeypatch):
    base = dict(aggregator="uniform", epoch_count=2, minibatch_count=2)
    with pytest.raises(ValueError, match="fedavg and the seq family only"):
        TrainConfig(approach="single", slot_count=2, **base)
    with pytest.raises(ValueError, match="fedavg and the seq family only"):
        TrainConfig(approach="lflip", slot_count=2, **base)
    assert TrainConfig(approach="seqavg", slot_count=2, **base).slot_count == 2
    with pytest.raises(ValueError, match="slot execution is not supported"):
        TrainConfig(approach="fedavg", slot_count=2, record_updates=True, **base)
    assert TrainConfig(approach="fedavg", slot_count=2, **base).slot_count == 2
    # the reduce is read from the environment once, when a config is built
    monkeypatch.delenv(constants.DETERMINISTIC_REDUCE_ENV, raising=False)
    assert TrainConfig(**base).deterministic_reduce is False
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    cfg = TrainConfig(**base)
    monkeypatch.delenv(constants.DETERMINISTIC_REDUCE_ENV)
    assert cfg.deterministic_reduce is True
    # under the deterministic reduce fedavg sweeps run masked, as in JAX
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    eng = _port_engine()
    assert not eng._use_slots and eng.scenario.slot_bucketing == "masked"
    monkeypatch.delenv(constants.DETERMINISTIC_REDUCE_ENV)
    monkeypatch.setenv(constants.NO_SLOTS_ENV, "1")
    assert _port_engine().scenario.slot_bucketing == "masked"


def test_coalition_arrays_pad_slots():
    eng = _port_engine()
    subsets = [(0, 3), (1, 2, 4), (4, 0)]
    np.testing.assert_array_equal(eng._coalition_arrays(subsets, 3),
                                  [[0, 3, -1], [1, 2, 4], [0, 4, -1]])
    np.testing.assert_array_equal(eng._coalition_arrays(subsets),
                                  [[1, 0, 0, 1, 0], [0, 1, 1, 0, 1], [1, 0, 0, 0, 1]])


# ---------------------------------------------------------------------------
# (f) the deterministic reduce
# ---------------------------------------------------------------------------

def _terms(seed=0, B=8, P=10, N=100):
    """[B, P, N] standard-normal terms, with each coalition's partner rows
    outside it zeroed, and the coalition masks [B, P]."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, P)) < 0.5).astype(np.float32)
    mask[:, 0] = 0.0          # a zero row first: the fold starts from it
    mask[:, 1] = 1.0
    terms = rng.standard_normal((B, P, N)).astype(np.float32) * mask[:, :, None]
    return terms, mask


def test_ordered_fold_is_a_left_fold():
    terms, _ = _terms()
    ref = terms[:, 0].copy()
    for i in range(1, terms.shape[1]):
        ref = ref + terms[:, i]
    got = ordered_fold(torch.from_numpy(terms), dim=1).numpy()
    assert got.tobytes() == ref.tobytes()
    flat = terms[0]
    ref0 = flat[0].copy()
    for row in flat[1:]:
        ref0 = ref0 + row
    assert ordered_fold(torch.from_numpy(flat)).numpy().tobytes() == ref0.tobytes()


def test_fold_ignores_zero_rows_where_sum_does_not():
    terms, mask = _terms()
    t = torch.from_numpy(terms)
    folds_differ = sums_differ = 0
    for b in range(terms.shape[0]):
        compact = t[b][torch.from_numpy(mask[b]) > 0]
        folds_differ += int((ordered_fold(t[b]) != ordered_fold(compact)).sum())
        sums_differ += int((torch.sum(t[b], dim=0) != torch.sum(compact, dim=0)).sum())
    assert folds_differ == 0
    # not vacuous: the default reduce does depend on the zero rows
    assert sums_differ > 0


def test_deterministic_aggregate_ignores_zero_rows():
    """aggregation_weights and aggregate under `deterministic`: masked rows
    over P partners give the bits the compact active rows give."""
    terms, mask = _terms(seed=1)
    sizes = np.random.default_rng(2).integers(10, 500, mask.shape[1])
    for b in range(mask.shape[0]):
        active = np.flatnonzero(mask[b])
        leaf = torch.from_numpy(terms[b])
        w = aggregation_weights("data-volume", torch.from_numpy(mask[b]),
                                torch.from_numpy(sizes), torch.zeros(mask.shape[1]),
                                deterministic=True)
        wc = aggregation_weights("data-volume", torch.ones(len(active)),
                                 torch.from_numpy(sizes[active]), torch.zeros(len(active)),
                                 deterministic=True)
        assert torch.equal(w[active], wc)
        full = aggregate({"l": {"w": leaf}}, w, deterministic=True)["l"]["w"]
        compact = aggregate({"l": {"w": leaf[active]}}, wc, deterministic=True)["l"]["w"]
        assert torch.equal(full, compact)
    # batched [B, P] weights fold over the partner axis, row by row
    wb = aggregation_weights("uniform", torch.from_numpy(mask), None, None, deterministic=True)
    out = aggregate({"l": {"w": torch.from_numpy(terms)}}, wb, deterministic=True)["l"]["w"]
    assert out.shape == (mask.shape[0], terms.shape[2])
    assert torch.equal(out[3], aggregate({"l": {"w": torch.from_numpy(terms[3])}}, wb[3],
                                         deterministic=True)["l"]["w"])
