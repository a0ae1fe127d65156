"""The seq-family trainers of the PyTorch port (seq-pure, seq-with-final-agg,
seqavg) against the JAX package, on the CPU:

(a) the masked epoch chunk against the JAX package's jitted `epoch_chunk`,
    a batch of two coalitions, uniform and data-volume aggregation, fed
    JAX's initial params, permutations and visit-order keys: params and val
    history within 1e-4, the partner history's NaN cells equal;
(b) the port's slots against its masks, a batch of every multi-partner
    coalition of 4 partners, at each size's exact width and at the full
    width with -1 padding: bit-equal under the deterministic reduce,
    within 1e-6 under the default one;
(c) the port's slots against the JAX package's `_seq_slot_epoch`;
(d) a batch of coalitions against each coalition alone;
(e) early stopping on val column MB-1 freezing the runs of a batch at the
    JAX package's epochs;
(f) the Titanic 3-partner seqavg sweep, both engines on merged slot
    buckets, against the JAX engine: every v(S) within one test sample,
    Kendall tau-b 1.0 through `diff_ledgers`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.mpl.engine import MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.obs import numerics as jnum
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import EpochStreams, MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.obs import numerics as tnum
from mplc_tpu_torch.scenario import Scenario
from test_torch_sweep import (AMOUNTS, _assert_trees_close, _jax_single_perms, _np,
                              _problem, _stacked_np, _titanic)

torch.set_num_threads(1)

SEQ = ["seq-pure", "seq-with-final-agg", "seqavg"]


def jax_seq_streams(jtr, rng, mask_pn, epochs: int) -> EpochStreams:
    """One JAX run's streams of `epochs` epochs in one chunk, as the port
    takes them: the permutations (`gen_epoch_streams`) and the visit-order
    keys `uniform(fold_in(fold_in(fold_in(re, 1), mb), 0), [P])` of
    `_seq_epoch` (`mplc_tpu/mpl/engine.py:1200-1203`), where the epoch key
    re = fold_in(fold_in(rng, e), e)."""
    P = mask_pn.shape[0]
    perms = np.array(jtr.gen_epoch_streams(rng, mask_pn, 0, epochs)[0])
    keys = []
    for e in range(epochs):
        re = jax.random.fold_in(jax.random.fold_in(rng, e), e)
        keys.append([np.asarray(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(jax.random.fold_in(re, 1), mb), 0), (P,)))
            for mb in range(jtr.cfg.minibatch_count)])
    return EpochStreams(torch.from_numpy(perms), order_keys=torch.from_numpy(np.array(keys)))


def stack_streams(runs: list) -> EpochStreams:
    """Runs' `EpochStreams` stacked on a leading run axis."""
    return EpochStreams(*(None if f[0] is None else torch.stack(f) for f in zip(*runs)))


# ---------------------------------------------------------------------------
# (a) the masked epoch chunk against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggregator", ["uniform", "data-volume"])
@pytest.mark.parametrize("approach", SEQ)
def test_masked_seq_chunk_matches_jax(approach, aggregator):
    (jstacked, jval, jtest), (stacked, val, test), n_test = _problem(2)
    cfg = dict(approach=approach, aggregator=aggregator, epoch_count=3,
               minibatch_count=2, gradient_updates_per_pass=2,
               is_early_stopping=False, record_partner_val=True)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    masks = [[1., 1., 1.], [1., 0., 1.]]
    rngs = jnp.stack([jax.random.PRNGKey(5), jax.random.PRNGKey(6)])
    jstate = jax.vmap(lambda r: jtr.init_state(r, 3))(rngs)
    init_np = _np(jstate.params)
    jstate = jax.jit(jax.vmap(jtr.epoch_chunk, in_axes=(0, None, None, 0, 0, None)),
                     static_argnames=("n_epochs",))(
        jstate, jstacked, jval, jnp.array(masks), rngs, 3)
    _, jaccs = jax.jit(jax.vmap(jtr.finalize, in_axes=(0, None)))(jstate, jtest)

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(init_np))
    streams = stack_streams([jax_seq_streams(jtr, r, jstacked.mask, 3) for r in rngs])
    tr.epoch_chunk(state, stacked, val, torch.tensor(masks), None, 3, streams_all=streams)
    _, accs = tr.finalize(state, test)

    assert state.done.all() and state.nb_epochs_done.tolist() == [3, 3]
    _assert_trees_close(state.params, _np(jstate.params), atol=1e-4)
    np.testing.assert_allclose(state.val_loss_h.numpy(), np.asarray(jstate.val_loss_h),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.val_acc_h.numpy(), np.asarray(jstate.val_acc_h),
                               rtol=0, atol=1e-4)
    ph, jph = state.partner_h.numpy(), np.asarray(jstate.partner_h)
    # a non-member's cells stay NaN in both
    np.testing.assert_array_equal(np.isnan(ph), np.isnan(jph))
    assert np.isnan(ph[1, :, 1]).all() and not np.isnan(ph[0]).any()
    np.testing.assert_allclose(ph, jph, rtol=0, atol=1e-4)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), rtol=0, atol=1.0 / n_test + 1e-6)


# ---------------------------------------------------------------------------
# (b) slots against masks, in the port
# ---------------------------------------------------------------------------

AMOUNTS4 = [0.1, 0.2, 0.3, 0.4]
MULTIS4 = [s for s in powerset_order(4) if len(s) > 1]


def _problem4():
    parts = [Partner(i) for i in range(4)]
    d = tdatasets.load_titanic()
    split_basic(d, parts, AMOUNTS4, "random", 2)
    return (StackedPartners.build(parts, 1, "cpu"), stage_eval_set(d.x_val, d.y_val, 1, "cpu"))


def _train4(approach, coal, **cfg):
    """A batch of coalitions of 4 Titanic partners trained for 2 epochs of
    2 minibatches of 2 steps, every coalition from the same seed."""
    stacked, val = _problem4()
    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(
        approach=approach, aggregator="data-volume", epoch_count=2, minibatch_count=2,
        gradient_updates_per_pass=2, is_early_stopping=False, record_partner_val=True,
        **cfg))
    gens = [torch.Generator().manual_seed(4) for _ in coal]
    state = tr.init_state(gens, 4, "cpu")
    return tr.epoch_chunk(state, stacked, val, torch.tensor(coal), gens, 2)


def _leaves(tree):
    return [t for d in tree.values() for t in d.values()]


@pytest.mark.parametrize("deterministic", [False, True], ids=["sum", "fold"])
@pytest.mark.parametrize("approach", SEQ)
def test_seq_slots_match_masks(approach, deterministic):
    masks = np.zeros((len(MULTIS4), 4), np.float32)
    for i, s in enumerate(MULTIS4):
        masks[i, list(s)] = 1.0
    masked = _train4(approach, masks.tolist(), deterministic_reduce=deterministic)
    runs = [("padded", list(range(len(MULTIS4))),
             _train4(approach, [list(s) + [-1] * (4 - len(s)) for s in MULTIS4],
                     slot_count=4, deterministic_reduce=deterministic))]
    for k in (2, 3):
        sel = [i for i, s in enumerate(MULTIS4) if len(s) == k]
        runs.append((f"exact {k}", sel, _train4(
            approach, [list(MULTIS4[i]) for i in sel], slot_count=k,
            deterministic_reduce=deterministic)))
    for _, sel, slots in runs:
        pairs = [(a[sel], b) for a, b in zip(_leaves(masked.params), _leaves(slots.params))]
        pairs += [(masked.val_loss_h[sel], slots.val_loss_h),
                  (masked.partner_h[sel], slots.partner_h)]
        if deterministic:
            for a, b in pairs:
                assert torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))
        else:
            for a, b in pairs:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6, equal_nan=True)
    # a non-member trained in no slot: its history stays NaN
    assert torch.isnan(runs[0][2].partner_h[0][:, 2:]).all()


# ---------------------------------------------------------------------------
# (c) slots against the JAX package's slot epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", SEQ)
@pytest.mark.parametrize("slot_count,ids", [(2, [0, 2]), (3, [2, 0, -1])])
def test_seq_slots_match_jax(approach, slot_count, ids):
    (jstacked, jval, jtest), (stacked, val, test), n_test = _problem(2)
    cfg = dict(approach=approach, aggregator="data-volume", epoch_count=2,
               minibatch_count=2, gradient_updates_per_pass=2,
               is_early_stopping=False, record_partner_val=True, slot_count=slot_count)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    rng = jax.random.PRNGKey(4)
    jstate = jtr.init_state(rng, 3)
    init_np = _np(jstate.params)
    jstate = jax.jit(jtr.epoch_chunk, static_argnames=("n_epochs",))(
        jstate, jstacked, jval, jnp.array(ids, jnp.int32), rng, n_epochs=2)
    _, jacc = jax.jit(jtr.finalize)(jstate, jtest)

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(_stacked_np([init_np])))
    tr.epoch_chunk(state, stacked, val, torch.tensor([ids]), None, 2,
                   streams_all=stack_streams([jax_seq_streams(jtr, rng, jstacked.mask, 2)]))
    _, acc = tr.finalize(state, test)
    _assert_trees_close(state.row(0).params, jstate.params, atol=1e-4)
    ph, jph = state.partner_h[0].numpy(), np.asarray(jstate.partner_h)
    np.testing.assert_array_equal(np.isnan(ph), np.isnan(jph))
    np.testing.assert_allclose(ph, jph, rtol=0, atol=1e-4)
    assert abs(float(acc[0]) - float(jacc)) <= 1.0 / n_test + 1e-6


# ---------------------------------------------------------------------------
# (d) a batch against each coalition alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", SEQ)
def test_batched_seq_coalitions_match_individual(approach):
    _, (stacked, val, test), _ = _problem(2)
    cfg = TrainConfig(approach=approach, aggregator="uniform", epoch_count=2,
                      minibatch_count=2, gradient_updates_per_pass=2,
                      is_early_stopping=False, record_partner_val=False)
    tr = MplTrainer(tzoo.TITANIC_LOGREG, cfg)
    masks = torch.tensor([[1., 1., 0.], [0., 1., 1.], [1., 1., 1.]])
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


# ---------------------------------------------------------------------------
# (e) early stopping on column MB-1
# ---------------------------------------------------------------------------

def test_seq_early_stopping_reads_the_last_column():
    """8 epochs, patience 2, a batch of coalitions on the JAX package's
    initial params and streams, val labels partly flipped so that the val
    loss turns up: each run stops at the JAX epoch, judged on column
    MB-1 (column 0 is never evaluated); a stopped run keeps its params and
    its later history rows stay NaN while the others train on."""
    (jstacked, jval, jtest), (stacked, val, test), n_test = _problem(2, flip_frac=0.3)
    cfg = dict(approach="seqavg", aggregator="uniform", epoch_count=8,
               minibatch_count=2, gradient_updates_per_pass=2,
               is_early_stopping=True, patience=2, record_partner_val=False,
               record_val_history=False)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    masks = [[1, 1, 0], [0, 1, 1], [1, 1, 1], [1, 0, 1]]
    rngs = jnp.stack([jax.random.PRNGKey(5 + i) for i in range(len(masks))])
    jstate = jax.vmap(lambda r: jtr.init_state(r, 3))(rngs)
    init_np = _np(jstate.params)
    jstate = jax.jit(jax.vmap(jtr.epoch_chunk, in_axes=(0, None, None, 0, 0, None)),
                     static_argnames=("n_epochs",))(
        jstate, jstacked, jval, jnp.array(masks, jnp.float32), rngs, 8)
    _, jaccs = jax.jit(jax.vmap(jtr.finalize, in_axes=(0, None)))(jstate, jtest)

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(init_np))
    tr.epoch_chunk(state, stacked, val, torch.tensor(masks, dtype=torch.float32), None, 8,
                   streams_all=stack_streams([jax_seq_streams(jtr, r, jstacked.mask, 8)
                                              for r in rngs]))
    _, accs = tr.finalize(state, test)

    nb = state.nb_epochs_done.numpy()
    np.testing.assert_array_equal(nb, np.asarray(jstate.nb_epochs_done))
    assert nb.min() < nb.max() and state.done.all()      # stopped at several epochs
    _assert_trees_close(state.params, _np(jstate.params), atol=1e-4)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), rtol=0, atol=1.0 / n_test + 1e-6)
    vl = state.val_loss_h.numpy()
    assert np.isnan(vl[:, :, 0]).all()
    np.testing.assert_array_equal(np.isnan(vl), np.isnan(np.asarray(jstate.val_loss_h)))
    for i, n in enumerate(nb):
        assert not np.isnan(vl[i, :n, 1]).any() and np.isnan(vl[i, n:, 1]).all()


# ---------------------------------------------------------------------------
# (f) the seqavg sweep against the JAX engine
# ---------------------------------------------------------------------------

def test_seqavg_sweep_matches_jax_engine(monkeypatch):
    game = dict(epoch_count=4, minibatch_count=2, gradient_updates_per_pass_count=2,
                multi_partner_learning_approach="seqavg")
    for knob in ("NO_SLOTS", "SLOT_MERGE", "SLOT_POW2", "DETERMINISTIC_REDUCE"):
        for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
            monkeypatch.delenv(pkg + knob, raising=False)
    jd, td = _titanic()
    jsc = build_scenario(dataset=jd, is_dry_run=True, **game)
    jeng = JEngine(jsc)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=td, seed=3, device="cpu", **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    eng = CharacteristicEngine(sc)
    assert sc.slot_bucketing == jsc.slot_bucketing == "merge"
    E = game["epoch_count"]
    jtr = jeng.multi_pipe.trainer

    def batch_start(subsets, single, replicas=None):
        rngs = [jeng._coalition_rng(s) for s in subsets]
        init = params_from_numpy(_stacked_np([jsc.dataset.model.init(r) for r in rngs]))
        if single:
            streams = torch.from_numpy(np.stack([
                _jax_single_perms(r, jeng.stacked.mask[s[0]], E) for s, r in zip(subsets, rngs)]))
        else:
            streams = stack_streams([jax_seq_streams(jtr, r, jeng.stacked.mask, E)
                                     for r in rngs])
        return [eng.coalition_generator(s) for s in subsets], init, streams

    monkeypatch.setattr(eng, "_batch_start", batch_start)
    subsets = powerset_order(3)
    jv = np.asarray(jeng.evaluate(subsets))
    v = eng.evaluate(subsets)
    n_test = len(td.x_test)
    # at most one test sample may flip at a decision boundary
    np.testing.assert_allclose(v, jv, rtol=0, atol=1.0 / n_test + 1e-6)
    ja, jb = jnum.ValueLedger("game"), jnum.ValueLedger("game")
    for s, x, y in zip(subsets, v, jv):
        ja.record(s, float(x))
        jb.record(s, float(y))
    assert jnum.diff_ledgers(ja, jb)["kendall_tau"] == 1.0
    assert tnum.diff_values(v, jv)["kendall_tau"] == 1.0
    assert [(b["kind"], b["slot_count"]) for b in eng.batch_log] == [("single", None),
                                                                    ("multi", 3)]
