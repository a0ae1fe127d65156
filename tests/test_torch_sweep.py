"""The retraining exact-Shapley sweep of the PyTorch port against the JAX
package, on the CPU:

1. the trainers: the single-partner trainer on the JAX package's initial
   params and permutations; a batch of coalitions against each coalition
   alone; early stopping freezing each coalition of a batch on its own;
2. the sweep: `CharacteristicEngine.evaluate` over the Titanic 3-partner
   powerset against the JAX engine, both masked (`MPLC_TPU_NO_SLOTS=1`,
   `MPLC_TORCH_NO_SLOTS=1`) or both on slots, fed the JAX engine's
   per-coalition initial params (and, at MB = gup = 2, its permutations):
   every v(S) within one test sample, Shapley values within 1e-3, Kendall
   tau-b 1.0; the memo; two sweeps of one seed bit-equal;
3. the slice: a tiny MNIST CNN `Scenario.run()` with "Shapley values" and
   "Independent scores"; an unknown method name logged and ignored.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.contrib.shapley import shapley_from_characteristic as jshapley
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, split_basic as jsplit
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.obs import numerics as jnum
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.obs import numerics as tnum
from mplc_tpu_torch.scenario import Scenario
from test_torch_slice import _tiny_mnist

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stacked_np(trees):
    """Parameter trees stacked on a new leading (coalition) axis, as numpy."""
    return jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]), *trees)


def _titanic(flip_frac=0.0):
    """Titanic in both packages. `flip_frac` of the val labels (rows drawn
    from a seed) are flipped, so that the val loss turns up while training
    goes on and early stopping fires."""
    jd, td = jdatasets.load_titanic(), tdatasets.load_titanic()
    if flip_frac:
        flip = np.random.default_rng(0).random(len(jd.y_val)) < flip_frac
        for d in (jd, td):
            d.y_val = np.where(flip, 1 - d.y_val, d.y_val).astype(d.y_val.dtype)
    return jd, td


def _problem(minibatch_count, flip_frac=0.0):
    """The Titanic 3-partner split staged in both packages: ((stacked, val,
    test) JAX, (stacked, val, test) port, test-set size)."""
    jd, td = _titanic(flip_frac)
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", minibatch_count)
    split_basic(td, tp, AMOUNTS, "random", minibatch_count)
    jax_side = (JStacked.build(jp, 1), JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 1, 128)),
                JEvalSet(*jstack_eval(jd.x_test, jd.y_test, 1, 128)))
    port_side = (StackedPartners.build(tp, 1, "cpu"), stage_eval_set(td.x_val, td.y_val, 1, "cpu"),
                 stage_eval_set(td.x_test, td.y_test, 1, "cpu"))
    return jax_side, port_side, len(td.x_test)


def _jax_single_perms(rng, mask_p, epochs: int) -> np.ndarray:
    """[E, Nmax] permutations the JAX package's `_single_epoch` draws
    (`mplc_tpu/mpl/engine.py:1378-1380`) for one run of `epochs` epochs in
    one chunk: `epoch_chunk` folds the rng by position, `run_epoch` by
    epoch, then the epoch key is folded with 0."""
    out = []
    for e in range(epochs):
        re = jax.random.fold_in(jax.random.fold_in(rng, e), e)
        keys = jax.random.uniform(jax.random.fold_in(re, 0), mask_p.shape) \
            + (1.0 - mask_p) * 1e9
        out.append(np.asarray(jnp.argsort(keys)))
    return np.stack(out)


def _assert_trees_close(a: dict, b, atol):
    for g, d in params_to_numpy(a).items():
        for k, v in d.items():
            np.testing.assert_allclose(v, np.asarray(b[g][k]), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# 1. the trainers
# ---------------------------------------------------------------------------

def test_single_trainer_matches_jax():
    """After tests/test_mpl.py:170: partner 1 alone, 4 epochs, mb 2, gup 4."""
    (jstacked, jval, jtest), (stacked, val, test), n_test = _problem(2)
    cfg = dict(approach="single", aggregator="uniform", epoch_count=4,
               minibatch_count=2, gradient_updates_per_pass=4,
               is_early_stopping=False, record_partner_val=False)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    rng = jax.random.PRNGKey(5)
    mask = jnp.array([0., 1., 0.])
    jstate = jtr.init_state(rng, 3)
    init_np = _np(jstate.params)
    jstate = jax.jit(jtr.epoch_chunk, static_argnames=("n_epochs",))(
        jstate, jstacked, jval, mask, rng, n_epochs=4)
    _, jacc = jax.jit(jtr.finalize)(jstate, jtest)
    perms = _jax_single_perms(rng, jstacked.mask[1], 4)

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(_stacked_np([init_np])))
    tr.epoch_chunk(state, stacked, val, torch.tensor([[0., 1., 0.]]), None, 4,
                   streams_all=torch.from_numpy(perms)[None])
    _, acc = tr.finalize(state, test)
    run = state.row(0)
    assert run.done and run.nb_epochs_done == 4
    # 32 persistent-Adam steps, fp32 rounding
    _assert_trees_close(run.params, jstate.params, atol=1e-4)
    np.testing.assert_allclose(run.val_loss_h[:, 0].numpy(),
                               np.asarray(jstate.val_loss_h)[:, 0], rtol=0, atol=1e-4)
    # one test sample may flip at the decision boundary
    assert abs(float(acc[0]) - float(jacc)) <= 1.0 / n_test + 1e-6
    with pytest.raises(ValueError, match="fedavg approach only"):
        TrainConfig(**{**cfg, "record_updates": True})


@pytest.mark.parametrize("approach,masks", [
    ("fedavg", [[1, 1, 0], [0, 1, 1], [1, 1, 1]]),
    ("single", [[1, 0, 0], [0, 1, 0], [0, 0, 1]])])
def test_batched_coalitions_match_individual(approach, masks):
    """After tests/test_mpl.py:81: the coalitions trained in one batch give
    the params and the accuracy each gives alone, from the same stream."""
    _, (stacked, val, test), _ = _problem(2)
    cfg = TrainConfig(approach=approach, aggregator="uniform", epoch_count=2,
                      minibatch_count=2, gradient_updates_per_pass=2,
                      is_early_stopping=False, record_partner_val=False)
    tr = MplTrainer(tzoo.TITANIC_LOGREG, cfg)
    masks = torch.tensor(masks, dtype=torch.float32)
    gens = lambda n: [torch.Generator().manual_seed(5) for _ in range(n)]  # noqa: E731
    g3 = gens(3)
    batch = tr.epoch_chunk(tr.init_state(g3, 3, "cpu"), stacked, val, masks, g3, 2)
    _, batch_accs = tr.finalize(batch, test)
    for i in range(3):
        g = gens(1)
        alone = tr.epoch_chunk(tr.init_state(g, 3, "cpu"), stacked, val, masks[i:i + 1], g, 2)
        _, acc = tr.finalize(alone, test)
        assert float(acc[0]) == pytest.approx(float(batch_accs[i]), abs=1e-6)
        _assert_trees_close(alone.row(0).params, params_to_numpy(batch.row(i).params),
                            atol=1e-6)


@pytest.mark.parametrize("approach,masks", [
    ("fedavg", [[1, 1, 0], [0, 1, 1], [1, 1, 1], [1, 0, 1]]),
    ("single", [[1, 0, 0], [0, 1, 0], [0, 0, 1]])])
def test_early_stopping_freezes_per_coalition(approach, masks):
    """8 epochs, patience 2, a batch of coalitions on the JAX package's
    initial params and permutations, against the JAX package's vmapped
    trainer: each coalition stops at the JAX epoch; a stopped one keeps its
    params and NaN history rows while the others train on."""
    (jstacked, jval, jtest), (stacked, val, test), n_test = _problem(2, flip_frac=0.3)
    cfg = dict(approach=approach, aggregator="uniform", epoch_count=8,
               minibatch_count=2, gradient_updates_per_pass=2,
               is_early_stopping=True, patience=2, record_partner_val=False)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    jmasks = jnp.array(masks, jnp.float32)
    rngs = jnp.stack([jax.random.PRNGKey(5 + i) for i in range(len(masks))])
    jstate = jax.vmap(lambda r: jtr.init_state(r, 3))(rngs)
    init_np = _np(jstate.params)
    jstate = jax.jit(jax.vmap(jtr.epoch_chunk, in_axes=(0, None, None, 0, 0, None)),
                     static_argnames=("n_epochs",))(jstate, jstacked, jval, jmasks, rngs, 8)
    _, jaccs = jax.jit(jax.vmap(jtr.finalize, in_axes=(0, None)))(jstate, jtest)
    if approach == "single":
        perms = [_jax_single_perms(r, jstacked.mask[int(np.argmax(m))], 8)
                 for r, m in zip(rngs, masks)]
    else:
        perms = [np.asarray(jtr.gen_epoch_streams(r, jstacked.mask, 0, 8)[0]) for r in rngs]

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(init_np))
    tr.epoch_chunk(state, stacked, val, torch.tensor(masks, dtype=torch.float32), None, 8,
                   streams_all=torch.from_numpy(np.stack(perms)))
    _, accs = tr.finalize(state, test)

    nb = state.nb_epochs_done.numpy()
    np.testing.assert_array_equal(nb, np.asarray(jstate.nb_epochs_done))
    assert nb.min() < nb.max() and state.done.all()      # stopped at several epochs
    _assert_trees_close(state.params, _np(jstate.params), atol=1e-4)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), rtol=0, atol=1.0 / n_test + 1e-6)
    vl = state.val_loss_h[:, :, 0].numpy()
    np.testing.assert_array_equal(np.isnan(vl), np.isnan(np.asarray(jstate.val_loss_h)[:, :, 0]))
    for i, n in enumerate(nb):
        assert not np.isnan(vl[i, :n]).any() and np.isnan(vl[i, n:]).all()


# ---------------------------------------------------------------------------
# 2. the sweep against the JAX engine
# ---------------------------------------------------------------------------

# case: (game, inject the JAX permutations too, share of val labels flipped)
CASES = {
    # one full-batch step a pass: training does not depend on the permutations
    "i": (dict(epoch_count=4, minibatch_count=1, gradient_updates_per_pass_count=1), False, 0.0),
    "ii": (dict(epoch_count=4, minibatch_count=2, gradient_updates_per_pass_count=2), True, 0.0),
    # early stopping on (epoch_count > PATIENCE), and it fires
    "iii": (dict(epoch_count=constants.PATIENCE + 2, minibatch_count=1,
                 gradient_updates_per_pass_count=1), False, 0.7),
}


def _engines(monkeypatch, case, slots=False):
    """(JAX engine, port engine, test-set size) of one case's Titanic game,
    the port fed the JAX engine's per-coalition initial params
    `model.init(eng._coalition_rng(s))` (tests/test_sv_parity.py:205) and,
    where the case says so, its permutations. Both engines train the
    multi-partner coalitions masked, or with `slots` on merged slot
    buckets."""
    game, streams, flip_frac = CASES[case]
    # read at construction
    for knob in ("NO_SLOTS", "SLOT_MERGE", "SLOT_POW2", "DETERMINISTIC_REDUCE"):
        for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
            monkeypatch.delenv(pkg + knob, raising=False)
    if not slots:
        monkeypatch.setenv("MPLC_TPU_NO_SLOTS", "1")
        monkeypatch.setenv("MPLC_TORCH_NO_SLOTS", "1")
    jd, td = _titanic(flip_frac)
    jsc = build_scenario(dataset=jd, is_dry_run=True, **game)
    jeng = JEngine(jsc)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=td, seed=3, device="cpu", **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    eng = CharacteristicEngine(sc)
    E = game["epoch_count"]
    jtr = jeng.multi_pipe.trainer

    def batch_start(subsets, single, replicas=None):
        rngs = [jeng._coalition_rng(s) for s in subsets]
        init = params_from_numpy(_stacked_np([jsc.dataset.model.init(r) for r in rngs]))
        perms = None
        if streams:
            perms = torch.from_numpy(np.stack([
                _jax_single_perms(r, jeng.stacked.mask[s[0]], E) if single
                else np.asarray(jtr.gen_epoch_streams(r, jeng.stacked.mask, 0, E)[0])
                for s, r in zip(subsets, rngs)]))
        return [eng.coalition_generator(s) for s in subsets], init, perms

    monkeypatch.setattr(eng, "_batch_start", batch_start)
    return jeng, eng, len(td.x_test)


def _sweep_against_jax(jeng, eng, n_test):
    """Both engines' sweeps of the 3-partner powerset: every v(S) within one
    test sample, Shapley values within 1e-3, Kendall tau-b 1.0."""
    subsets = powerset_order(3)
    jv = np.asarray(jeng.evaluate(subsets))
    v = eng.evaluate(subsets)
    # at most one test sample may flip at a decision boundary
    np.testing.assert_allclose(v, jv, rtol=0, atol=1.0 / n_test + 1e-6)
    sv = shapley_from_characteristic(3, eng.charac_fct_values)
    jsv = jshapley(3, jeng.charac_fct_values)
    np.testing.assert_allclose(sv, jsv, rtol=0, atol=1e-3)
    # the north star's sweep-level check, through both diffs
    ja, jb = jnum.ValueLedger("game"), jnum.ValueLedger("game")
    for s, x, y in zip(subsets, v, jv):
        ja.record(s, float(x))
        jb.record(s, float(y))
    assert tnum.diff_values(v, jv)["kendall_tau"] == 1.0
    assert jnum.diff_ledgers(ja, jb)["kendall_tau"] == 1.0
    assert tnum.kendall_tau_b(sv, jsv) == 1.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_slot_sweep_matches_jax_engine(monkeypatch, case):
    """The port's slot engine against the JAX package's, both on merged
    buckets: the 3-partner multis share one width-3 slot batch."""
    jeng, eng, n_test = _engines(monkeypatch, case, slots=True)
    assert eng.scenario.slot_bucketing == jeng.scenario.slot_bucketing == "merge"
    _sweep_against_jax(jeng, eng, n_test)
    assert [(b["kind"], b["width"], b["slot_count"]) for b in eng.batch_log] == \
        [("single", 4, None), ("multi", 4, 3)]
    assert sorted(jeng._slot_pipes) == sorted(eng._slot_pipes) == [3]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_jax_engine(monkeypatch, case):
    jeng, eng, n_test = _engines(monkeypatch, case)
    _sweep_against_jax(jeng, eng, n_test)
    subsets = powerset_order(3)
    assert [b["kind"] for b in eng.batch_log] == ["single", "multi"]
    assert [b["width"] for b in eng.batch_log] == [4, 4]

    if case == "iii":
        # epochs trained per coalition, each pipe against its JAX twin
        epochs, jepochs = [], []
        for single in (True, False):
            group = [s for s in subsets if (len(s) == 1) == single]
            pipe, jpipe = ((eng.single_pipe, jeng.single_pipe) if single
                           else (eng.multi_pipe, jeng.multi_pipe))
            masks = torch.from_numpy(eng._coalition_arrays(group))
            gens, init, _ = eng._batch_start(group, single)
            epochs += list(pipe.scores(masks, gens, eng.stacked, eng.val, eng.test, init)[1])
            jepochs += list(jpipe.scores(
                jnp.asarray(masks.numpy()), jnp.stack([jeng._coalition_rng(s) for s in group]),
                jeng.stacked, jeng.val, jeng.test, None)[1])
        np.testing.assert_array_equal(epochs, jepochs)
        assert min(epochs) < CASES[case][0]["epoch_count"]     # early stopping fired


def test_memo_trains_nothing_twice(monkeypatch):
    jeng, eng, n_test = _engines(monkeypatch, "i")
    subsets = powerset_order(3)
    jeng.evaluate(subsets)
    first = eng.evaluate(subsets)
    batches, calls = len(eng.batch_log), eng.first_charac_fct_calls_count
    assert calls == 7 and batches == 2
    np.testing.assert_array_equal(eng.evaluate(list(reversed(subsets)))[::-1], first)
    assert eng.not_twice_characteristic([1, 0]) == eng.charac_fct_values[(0, 1)]
    assert (len(eng.batch_log), eng.first_charac_fct_calls_count) == (batches, calls)
    for inc, jinc in zip(eng.increments_values, jeng.increments_values):
        assert sorted(inc) == sorted(jinc)
        for k in inc:
            # a difference of two values, each within one test sample
            assert abs(inc[k] - jinc[k]) <= 2.0 / n_test + 1e-6


def test_two_sweeps_of_one_seed_are_bit_equal():
    def sweep():
        sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3, device="cpu",
                      epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
        sc.instantiate_scenario_partners()
        sc.split_data()
        return CharacteristicEngine(sc).evaluate(powerset_order(3))
    a, b = sweep(), sweep()
    assert [tnum.float_bits(x) for x in a] == [tnum.float_bits(x) for x in b]


# ---------------------------------------------------------------------------
# 3. the slice, and the dispatcher
# ---------------------------------------------------------------------------

def test_port_scenario_shapley_on_mnist_cnn():
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=_tiny_mnist(), epoch_count=1,
                  minibatch_count=2, gradient_updates_per_pass_count=1,
                  is_early_stopping=False,
                  methods=["Shapley values", "Independent scores"], device="cpu")
    sc.run()
    sv, ind = sc.contributivity_list
    eng = sc._charac_engine
    values = eng.charac_fct_values
    assert (sv.name, ind.name) == ("Shapley", "Independent scores raw")
    assert len(values) == 2 ** 3 and all(0.0 <= v <= 1.0 for v in values.values())
    assert np.isfinite(sv.contributivity_scores).all()
    # efficiency: the Shapley values share out v(N)
    assert sv.contributivity_scores.sum() == pytest.approx(values[(0, 1, 2)], abs=1e-9)
    # the independent scores are the singles' memoized values: no batch
    # beyond the sweep's two (singles, then multis) was trained
    np.testing.assert_array_equal(ind.contributivity_scores,
                                  [values[(i,)] for i in range(3)])
    assert [(b["kind"], b["coalitions"]) for b in eng.batch_log] == [("single", 3), ("multi", 4)]
    assert sv.first_charac_fct_calls_count == 7


def test_unknown_method_is_ignored(caplog):
    """After tests/test_contrib.py:278-282: a name neither package knows is
    logged and leaves the scores at zero, as in the JAX package."""
    jc = JContributivity(build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True))
    jc.compute_contributivity("No such method")
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    c = Contributivity(sc)
    with caplog.at_level(logging.WARNING, logger="mplc_tpu_torch"):
        c.compute_contributivity("No such method")
    assert "Unrecognized name of method, statement ignored!" in caplog.text
    np.testing.assert_array_equal(c.contributivity_scores, np.zeros(3))
    np.testing.assert_array_equal(c.contributivity_scores, jc.contributivity_scores)
