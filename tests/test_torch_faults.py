"""The partner fault plan, the Scenario's corruption and fused wide steps of
the PyTorch port, against the JAX package on the CPU:

(a) the plan grammar over a table of specs: the same dicts, views,
    canonical repr and number of warnings as `mplc_tpu.faults`;
(b) every corruption kind and the plan's data faults: partner features and
    labels bit-equal to the JAX Scenario's on the same seed; unknown kinds
    raise at construction;
(c) the fault-plan fedavg trainer (dropout at epoch 2, stragglers of delay
    1 and 2) against the JAX trainer on its initial params and
    permutations, masked and on slots: params and history within 1e-4,
    the recorded deltas within 1e-5 and weights within 1e-6, the dropped
    partner's rows exact zeros; one MNIST CNN epoch from the JAX state,
    within Adam's step allowance; the single trainer's freeze;
(d) the engine under a plan (Titanic, 4 partners; after
    tests/test_partner_faults.py): a forever-dropped partner is the
    partner-excluded game (bit for bit masked and under the deterministic
    reduce, within one test sample on slots), a null player; mid-run faults
    leave coalitions without the partner alone; all-dropped coalitions;
    the approach guards;
(e) `step_width_mult`: the fused windows bit-equal to the JAX trainer's,
    k = 2 within 1e-4 of the JAX trainer, k = 1 bit-equal to the
    per-sub-batch stepping.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu import faults as jfaults
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.mpl.engine import MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu_torch import constants, faults
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.reconstruct import record_updates
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partner import CORRUPTION_KINDS
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.scenario import Scenario
from test_torch_lflip import MAX_STEP_SHARE, _problem as _cnn_problem
from test_torch_sweep import _assert_trees_close, _jax_single_perms, _np, _problem, _stacked_np

torch.set_num_threads(1)

_KNOBS = ("PARTNER_FAULT_PLAN", "SEED_ENSEMBLE", "STEP_WIDTH_MULT", "NO_SLOTS",
          "SLOT_MERGE", "SLOT_POW2", "DETERMINISTIC_REDUCE", "PRECISION")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in _KNOBS:
        for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
            monkeypatch.delenv(pkg + knob, raising=False)


def _plan_env(monkeypatch, spec):
    """The partner fault plan `spec` for both packages."""
    monkeypatch.setenv("MPLC_TPU_PARTNER_FAULT_PLAN", spec)
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, spec)


def _leaves(tree):
    return [t for d in tree.values() for t in d.values()]


# ---------------------------------------------------------------------------
# (a) the plan grammar
# ---------------------------------------------------------------------------

SPECS = [
    "dropout@p2:epoch3, straggler@p0:delay2,noisy@p1:sigma0.1,"
    "glabel@p3:frac0.5,straggler@p2:delay1",
    "dropout@p0:epoch1,dropout@p2:epoch3,straggler@p1:delay2,noisy@p1:sigma0.2,"
    "glabel@p3:frac1.0",
    "dropout@p2:delay3", "dropout@p2:epoch0", "glabel@p1:frac1.5", "vanish@p1:epoch2",
    "dropout@2:epoch3", "dropout@p2", "straggler@p1:delay0.5",
    "dropout@p1:epoch2,dropout@p1:epoch5", "noisy@p0:sigma1.25,noisy@p0:sigma2,noisy@p0",
    "straggler@p9:delay1,noisy@p4:sigma0.0,dropout@p1:epoch1", " , ,glabel@p0:frac0",
    "", None,
]


def _caught(fn, *args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, len(caught)


@pytest.mark.parametrize("spec", SPECS)
def test_plan_grammar_matches_jax(spec):
    """The same parse, warnings, clipping (4 partners), views and canonical
    repr as the JAX package, exactly."""
    plan, n_warn = _caught(faults.parse_partner_fault_plan, spec)
    jplan, jn_warn = _caught(jfaults.parse_partner_fault_plan, spec)
    assert plan == jplan and n_warn == jn_warn
    clipped, n_clip = _caught(faults.clip_partner_plan, plan, 4)
    jclipped, jn_clip = _caught(jfaults.clip_partner_plan, jplan, 4)
    assert clipped == jclipped and n_clip == jn_clip
    for view in ("trainer_fault_arrays", "data_fault_specs", "forever_dropped",
                 "normalized_plan_repr"):
        args = (clipped, 4) if view == "trainer_fault_arrays" else (clipped,)
        assert getattr(faults, view)(*args) == getattr(jfaults, view)(*args), view


def test_plan_grammar_cases():
    """tests/test_partner_faults.py's grammar cases, on the port's knob."""
    plan = faults.parse_partner_fault_plan(SPECS[0])
    assert plan == {2: {"dropout": 3, "straggler": 1}, 0: {"straggler": 2},
                    1: {"noisy": 0.1}, 3: {"glabel": 0.5}}
    assert faults.parse_partner_fault_plan(None) == faults.parse_partner_fault_plan("") == {}
    with pytest.warns(UserWarning, match="MPLC_TORCH_PARTNER_FAULT_PLAN: ignoring malformed"):
        assert faults.parse_partner_fault_plan("dropout@p2:epoch0") == {}
    with pytest.warns(UserWarning, match="duplicate"):
        assert faults.parse_partner_fault_plan(SPECS[9]) == {1: {"dropout": 2}}
    plan = faults.parse_partner_fault_plan(SPECS[1])
    assert faults.trainer_fault_arrays(plan, 4) == ((1, 0, 3, 0), (0, 2, 0, 0))
    assert faults.forever_dropped(plan) == frozenset({0})
    assert faults.data_fault_specs(plan) == {1: [("noisy", 0.2)], 3: [("glabel", 1.0)]}
    assert faults.trainer_fault_arrays({1: {"noisy": 0.2}}, 4) == (None, None)
    with pytest.warns(UserWarning, match="ignoring entries"):
        assert set(faults.clip_partner_plan(plan, 2)) == {0, 1}
    assert faults.normalized_plan_repr(plan) == \
        "dropout@p0:1,noisy@p1:0.2,straggler@p1:2,dropout@p2:3,glabel@p3:1.0"


def test_plan_is_read_from_the_port_knob(monkeypatch):
    monkeypatch.setenv("MPLC_TPU_PARTNER_FAULT_PLAN", "dropout@p1:epoch2")
    assert faults.partner_fault_plan_from_env() == {}
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "straggler@p0:delay3")
    assert faults.partner_fault_plan_from_env() == {0: {"straggler": 3}}


# ---------------------------------------------------------------------------
# (b) the Scenario's corruption
# ---------------------------------------------------------------------------

def _scenarios(corrupted, **game):
    """The JAX suite's 3-partner Titanic scenario (`build_scenario`) and the
    port's, both through data_corruption."""
    jsc = build_scenario(dataset=jdatasets.load_titanic(), corrupted_datasets=corrupted,
                         is_dry_run=True, **game)
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=tdatasets.load_titanic(),
                  corrupted_datasets=corrupted, epoch_count=4, minibatch_count=2,
                  gradient_updates_per_pass_count=4, is_early_stopping=False, seed=3,
                  device="cpu", **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    sc.compute_batch_sizes()
    sc.data_corruption()
    return jsc, sc


def _assert_partners_equal(jsc, sc):
    for jp, p in zip(jsc.partners_list, sc.partners_list):
        for attr in ("x_train", "y_train"):
            a, b = np.asarray(getattr(p, attr)), np.asarray(getattr(jp, attr))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (p.id, attr)


@pytest.mark.parametrize("kind", [k for k in CORRUPTION_KINDS if k != "not_corrupted"])
def test_corruption_matches_jax(kind):
    """Partner 0 with the kind's default parameter, partner 2 with an
    explicit one (a proportion, or noisy's sigma): bit-equal features,
    labels and corruption matrices, and the corrupted partners really
    changed (but under `permuted`, whose 2-class permutation may be the
    identity)."""
    jsc, sc = _scenarios([kind, "not_corrupted", (kind, 0.5)])
    _assert_partners_equal(jsc, sc)
    for jp, p in zip(jsc.partners_list, sc.partners_list):
        np.testing.assert_array_equal(p.corruption_matrix, jp.corruption_matrix)
    _, clean = _scenarios(["not_corrupted"] * 3)
    attr = "x_train" if kind == "noisy" else "y_train"
    for i in (0, 2) if kind != "permuted" else ():
        assert not np.array_equal(getattr(sc.partners_list[i], attr),
                                  getattr(clean.partners_list[i], attr)), (kind, i)
    np.testing.assert_array_equal(sc.partners_list[1].y_train, clean.partners_list[1].y_train)
    if kind == "glabel":
        # every label of partner 0 flipped to the one target class
        assert len(np.unique(sc.partners_list[0].y_train)) == 1
    assert sc._data_faults_applied and sc._partner_fault_plan == {}


def test_plan_data_faults_match_jax(monkeypatch):
    spec = "noisy@p1:sigma0.3,glabel@p2:frac0.4,dropout@p0:epoch2"
    _plan_env(monkeypatch, spec)
    jsc, sc = _scenarios(["not_corrupted", "shuffled", "not_corrupted"])
    _assert_partners_equal(jsc, sc)
    assert sc._partner_fault_plan == jsc._partner_fault_plan
    monkeypatch.delenv("MPLC_TPU_PARTNER_FAULT_PLAN")
    monkeypatch.delenv(constants.PARTNER_FAULT_PLAN_ENV)
    _, clean = _scenarios(["not_corrupted", "shuffled", "not_corrupted"])
    assert not np.array_equal(sc.partners_list[1].x_train, clean.partners_list[1].x_train)
    assert not np.array_equal(sc.partners_list[2].y_train, clean.partners_list[2].y_train)
    np.testing.assert_array_equal(sc.partners_list[0].x_train, clean.partners_list[0].x_train)


def test_unknown_corruption_raises_at_construction():
    game = dict(is_dry_run=True, dataset=tdatasets.load_titanic(), device="cpu")
    with pytest.raises(ValueError, match="glabel"):
        Scenario(3, [0.2, 0.3, 0.5], corrupted_datasets=["not_corrupted", "bogus",
                                                         "not_corrupted"], **game)
    with pytest.raises(ValueError, match="one spec per partner"):
        Scenario(3, [0.2, 0.3, 0.5], corrupted_datasets=["not_corrupted"] * 2, **game)


def test_engine_warns_when_the_data_faults_never_ran(monkeypatch):
    _plan_env(monkeypatch, "noisy@p1:sigma0.2")
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=tdatasets.load_titanic(),
                  device="cpu", epoch_count=2, minibatch_count=2)
    sc.instantiate_scenario_partners()
    sc.split_data()
    with pytest.warns(UserWarning, match="uncorrupted game"):
        CharacteristicEngine(sc)


# ---------------------------------------------------------------------------
# (c) the trainers against the JAX package's
# ---------------------------------------------------------------------------

FAULTS = dict(partner_drop_epochs=(0, 0, 2), partner_straggler_delays=(1, 2, 0))
FEDAVG = dict(approach="fedavg", aggregator="data-volume", epoch_count=3, minibatch_count=2,
              gradient_updates_per_pass=2, is_early_stopping=False, record_partner_val=True)
# masked: coalitions {0, 1, 2} and {0, 2}; on 3 slots the same
COALITIONS = {"masked": [[1., 1., 1.], [1., 0., 1.]], "slots": [[0, 1, 2], [0, 2, -1]]}


def _jax_runs(coals, cfg, rng, jstacked, jval):
    """The JAX trainer's state after a chunk of every coalition in turn, from
    one seed, and its permutations [E, P, Nmax]."""
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    chunk = jax.jit(jtr.epoch_chunk, static_argnames=("n_epochs",))
    states = []
    for c in coals:
        coal = jnp.array(c, jnp.int32 if cfg.get("slot_count") else jnp.float32)
        states.append(chunk(jtr.init_state(rng, 3), jstacked, jval, coal, rng,
                            n_epochs=cfg["epoch_count"]))
    masked = JTrainer(jzoo.TITANIC_LOGREG,
                      JConfig(**{**cfg, "slot_count": None, "record_updates": False}))
    perms = np.array(masked.gen_epoch_streams(rng, jstacked.mask, 0, cfg["epoch_count"])[0])
    return jtr.init_state(rng, 3), states, perms


def _port_run(coals, cfg, init_np, perms, stacked, val):
    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    B = len(coals)
    state = tr.init_state(None, 3, "cpu",
                          init_params=params_from_numpy(_stacked_np([init_np] * B)))
    streams = torch.from_numpy(perms)[None].expand(B, -1, -1, -1)
    return tr.epoch_chunk(state, stacked, val, torch.tensor(coals), None,
                          cfg["epoch_count"], streams_all=streams)


@pytest.mark.parametrize("route", sorted(COALITIONS))
def test_fault_plan_fedavg_matches_jax(route):
    """Dropout of partner 2 at epoch 2, stragglers 0 (delay 1) and 1 (delay
    2), 3 epochs of 2 rounds: params, history and the straggler buffer
    within 1e-4 of the JAX trainer's; masked, with recording: deltas within
    1e-5, weights within 1e-6, and partner 2's rows from epoch 2 on exact
    zeros (the recorded delta is local params - round-start global
    params, the straggler's stale start notwithstanding)."""
    (jstacked, jval, _), (stacked, val, _), _ = _problem(2)
    cfg = {**FEDAVG, **FAULTS}
    if route == "slots":
        cfg["slot_count"] = 3
    else:
        cfg["record_updates"] = True
    coals = COALITIONS[route]
    rng = jax.random.PRNGKey(4)
    jinit, jstates, perms = _jax_runs(coals, cfg, rng, jstacked, jval)
    state = _port_run(coals, cfg, _np(jinit.params), perms, stacked, val)
    for b, js in enumerate(jstates):
        run = state.row(b)
        _assert_trees_close(run.params, js.params, atol=1e-4)
        for name in ("val_loss_h", "val_acc_h", "partner_h"):
            got, ref = getattr(run, name).numpy(), np.asarray(getattr(js, name))
            np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=name)
        for g, d in state.stale.items():
            for k, t in d.items():
                np.testing.assert_allclose(t[b].numpy(), np.asarray(js.stale[g][k]),
                                           rtol=0, atol=1e-4)
        if route == "masked":
            _assert_trees_close(run.upd_h, js.upd_h, atol=1e-5)
            np.testing.assert_allclose(run.w_h.numpy(), np.asarray(js.w_h), rtol=0, atol=1e-6)
            MB = cfg["minibatch_count"]
            assert (run.w_h[MB:, 2] == 0).all() and (run.w_h[:MB, 2] > 0).all()
            for t in _leaves(run.upd_h):
                assert (t[MB:, 2] == 0).all() and (t[:MB, 2] != 0).any()
            np.testing.assert_allclose(run.w_h.sum(1).numpy(), 1.0, rtol=0, atol=1e-6)


def test_dropped_partner_changes_only_its_coalitions():
    """Coalition {0, 1} under a plan that only touches partner 2 trains bit
    for bit as it does fault-free."""
    (_, _, _), (stacked, val, _), _ = _problem(2)
    gens = lambda: [torch.Generator().manual_seed(4)]  # noqa: E731
    out = []
    for extra in ({}, {"partner_drop_epochs": (0, 0, 2),
                       "partner_straggler_delays": (0, 0, 1)}):
        tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**FEDAVG, **extra))
        g = gens()
        state = tr.init_state(g, 3, "cpu")
        out.append(tr.epoch_chunk(state, stacked, val, torch.tensor([[1., 1., 0.]]), g, 3))
    for a, b in zip(_leaves(out[0].params), _leaves(out[1].params)):
        assert torch.equal(a, b)


def test_cnn_epoch_under_a_plan_matches_jax():
    """One MNIST CNN epoch (the plan's epoch 2: partner 1 drops, partner 2
    straggles by 1) from the JAX state after epoch 1, against the JAX
    trainer's epoch 2, within Adam's step allowance
    (tests/test_torch_lflip.py): each weight within one learning rate a
    step, at most MAX_STEP_SHARE of them beyond 1e-4."""
    (jstacked, jval), (stacked, val) = _cnn_problem()
    cfg = dict(approach="fedavg", aggregator="uniform", epoch_count=2, minibatch_count=2,
               gradient_updates_per_pass=1, is_early_stopping=False, record_partner_val=False,
               partner_drop_epochs=(0, 2, 0), partner_straggler_delays=(0, 0, 1))
    jtr = JTrainer(jzoo.MNIST_CNN, JConfig(**cfg))
    rng = jax.random.PRNGKey(5)
    mask = jnp.ones(3)
    jrun = jax.jit(jtr.run_epoch)
    before = jrun(jtr.init_state(rng, 3), jstacked, jval, mask, jax.random.fold_in(rng, 0))
    after = jrun(before, jstacked, jval, mask, jax.random.fold_in(rng, 1))
    perms = np.array(jtr.gen_epoch_streams(rng, jstacked.mask, 0, 2)[0])

    tr = MplTrainer(tzoo.MNIST_CNN, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu",
                          init_params=params_from_numpy(_stacked_np([_np(before.params)])))
    state.stale = params_from_numpy(_stacked_np([_np(before.stale)]))
    state.epoch = 1
    tr.run_epoch(state, stacked, val, torch.ones(1, 3), None, torch.from_numpy(perms[1])[None])
    n_far = n_all = 0
    steps = cfg["minibatch_count"] * cfg["gradient_updates_per_pass"]
    for g, d in params_to_numpy(state.row(0).params).items():
        for k, v in d.items():
            diff = np.abs(v - np.asarray(after.params[g][k]))
            assert diff.max() <= steps * 1e-3, (g, k, diff.max())
            n_far += int((diff > 1e-4).sum())
            n_all += diff.size
    assert n_far <= MAX_STEP_SHARE * n_all, (n_far, n_all)
    # the buffer holds the round-start params of epoch 2's rounds
    for g, d in state.stale.items():
        for k, t in d.items():
            assert np.abs(t[0].numpy() - np.asarray(after.stale[g][k])).max() <= steps * 1e-3


def test_single_trainer_freeze_matches_jax():
    """Partner 1 alone, dropped at epoch 2 of 4: the JAX trainer's params
    and history within 1e-4; from epoch 2 on params and Adam state stay
    bit for bit as they were after epoch 1."""
    (jstacked, jval, _), (stacked, val, _), _ = _problem(2)
    cfg = dict(approach="single", aggregator="uniform", epoch_count=4, minibatch_count=2,
               gradient_updates_per_pass=4, is_early_stopping=False,
               record_partner_val=False, partner_drop_epochs=(0, 2, 0))
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    rng = jax.random.PRNGKey(5)
    jstate = jtr.init_state(rng, 3)
    init_np = _np(jstate.params)
    jstate = jax.jit(jtr.epoch_chunk, static_argnames=("n_epochs",))(
        jstate, jstacked, jval, jnp.array([0., 1., 0.]), rng, n_epochs=4)
    perms = torch.from_numpy(_jax_single_perms(rng, jstacked.mask[1], 4))[None]

    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(_stacked_np([init_np])))
    coal = torch.tensor([[0., 1., 0.]])
    tr.run_epoch(state, stacked, val, coal, None, perms[:, 0])
    after1 = [t.clone() for t in _leaves(state.params)]
    mu1 = [t.clone() for t in _leaves(state.opt_state["mu"])]
    tr.epoch_chunk(state, stacked, val, coal, None, 3, streams_all=perms[:, 1:])
    _assert_trees_close(state.row(0).params, jstate.params, atol=1e-4)
    for name in ("val_loss_h", "val_acc_h"):
        np.testing.assert_allclose(getattr(state.row(0), name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=0, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(after1, _leaves(state.params)))
    assert all(torch.equal(a, b) for a, b in zip(mu1, _leaves(state.opt_state["mu"])))
    assert state.row(0).nb_epochs_done == 4


@pytest.mark.parametrize("approach", ["seq-pure", "seqavg", "lflip"])
def test_trainer_faults_need_fedavg_in_both_packages(monkeypatch, approach):
    base = dict(aggregator="uniform", epoch_count=2, minibatch_count=2)
    for cfg_cls in (TrainConfig, JConfig):
        with pytest.raises(ValueError, match="fedavg"):
            cfg_cls(approach=approach, partner_drop_epochs=(0, 2, 0), **base)
    assert TrainConfig(approach="single", partner_straggler_delays=(1, 0, 0), **base)
    _plan_env(monkeypatch, "dropout@p0:epoch2")
    game = dict(epoch_count=2, minibatch_count=2, multi_partner_learning_approach=approach)
    with pytest.raises(ValueError, match="fedavg"):
        JEngine(build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **game))
    with pytest.raises(ValueError, match="fedavg"):
        _engine(partners=3, **game)


# ---------------------------------------------------------------------------
# (d) the engine under a plan
# ---------------------------------------------------------------------------

SUBSETS = powerset_order(4)


def _engine(partners=4, seed=9, **game):
    """tests/test_partner_faults.py's Titanic game in the port: 4 partners
    split 0.1 / 0.2 / 0.3 / 0.4, 2 epochs of 2 minibatches of 2 steps."""
    game = {"epoch_count": 2, "gradient_updates_per_pass_count": 2, "minibatch_count": 2,
            **game}
    amounts = {3: [0.2, 0.3, 0.5], 4: [0.1, 0.2, 0.3, 0.4]}[partners]
    sc = Scenario(partners, amounts, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=seed,
                  is_early_stopping=False, device="cpu", **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    sc.compute_batch_sizes()
    sc.data_corruption()
    return CharacteristicEngine(sc)


def _table(eng):
    return dict(zip(SUBSETS, eng.evaluate(SUBSETS)))


@pytest.mark.parametrize("route", ["masked", "deterministic", "slots"])
def test_forever_dropout_is_the_partner_excluded_game(monkeypatch, route):
    """dropout@p2:epoch1: every v(S) is the fault-free v(S \\ {2}), and v = 0
    where nothing is left; bit for bit masked (`MPLC_TORCH_NO_SLOTS=1`) and
    under the deterministic reduce (the faulty sweep on slots, the clean
    one masked, as in the JAX package); within one test sample on slots
    under the default reduce, where S and S \\ {2} may train at other slot
    widths. Partner 2 is then a null player: Shapley value 0, the others
    the 3-partner restricted game's."""
    if route == "masked":
        monkeypatch.setenv(constants.NO_SLOTS_ENV, "1")
    if route == "deterministic":
        monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    clean = _engine()
    ref = _table(clean)
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p2:epoch1")
    eng = _engine()
    assert eng._use_slots == (route != "masked") and clean._use_slots == (route == "slots")
    vals = _table(eng)
    n_test = len(eng.scenario.dataset.x_test)
    for s in SUBSETS:
        eff = tuple(i for i in s if i != 2)
        expected = ref[eff] if eff else 0.0
        if route == "slots":
            assert abs(vals[s] - expected) <= 1.0 / n_test + 1e-6, s
        else:
            assert vals[s] == expected, (s, vals[s], expected)
    assert eng.first_charac_fct_calls_count == len(SUBSETS)
    # no coalition of partner 2 alone was trained, and the rest trained at
    # their effective size: (i, 2) is a single training of i
    assert sum(b["coalitions"] for b in eng.batch_log) == len(SUBSETS) - 1
    assert sum(b["coalitions"] for b in eng.batch_log if b["kind"] == "single") == 6
    sv = shapley_from_characteristic(4, vals)
    restricted = {tuple(sorted({0: 0, 1: 1, 3: 2}[i] for i in s)): v
                  for s, v in ref.items() if 2 not in s}
    if route != "slots":
        assert sv[2] == 0.0
        np.testing.assert_allclose(sv[[0, 1, 3]],
                                   shapley_from_characteristic(3, restricted), atol=1e-12)


def test_midrun_faults_are_deterministic_and_leave_others_alone(monkeypatch):
    """The same plan twice gives the same bits; coalitions without the
    faulted partner keep their fault-free values; the others change."""
    ref = _table(_engine())
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p3:epoch2,straggler@p3:delay1")
    a, b = _table(_engine()), _table(_engine())
    assert a == b
    assert all(a[s] == ref[s] for s in SUBSETS if 3 not in s)
    assert any(a[s] != ref[s] for s in SUBSETS if 3 in s)


def test_all_dropped_coalitions(monkeypatch):
    """Every member dropped at epoch 2 of 2: the second epoch's rounds have
    no survivor, so they keep the global params (and the single trainer
    freezes), and every value is the 1-epoch game's bit for bit, finite.
    Every member dropped from epoch 1: v = 0 untrained."""
    subsets = [(0, 1), (0,), (1,)]
    one_epoch = _engine(epoch_count=1).evaluate(subsets)
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p0:epoch2,dropout@p1:epoch2")
    vals = _engine().evaluate(subsets)
    assert np.isfinite(vals).all()
    np.testing.assert_array_equal(vals, one_epoch)
    np.testing.assert_array_equal(vals, _engine().evaluate(subsets))
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p0:epoch1,dropout@p1:epoch1")
    eng = _engine()
    np.testing.assert_array_equal(eng.evaluate(subsets), [0.0, 0.0, 0.0])
    assert eng.batch_log == [] and eng.first_charac_fct_calls_count == 3


def test_recording_under_a_plan(monkeypatch):
    """The engine's recording trains through its fault-carrying config: the
    dropped partner's rows are exact zeros from its drop epoch; a plan
    dropping everyone from epoch 1 has nothing to record."""
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p1:epoch2,straggler@p0:delay2")
    eng = _engine(partners=3)
    assert eng._multi_cfg.partner_drop_epochs == (0, 2, 0)
    rec = record_updates(eng)
    MB = eng._multi_cfg.minibatch_count
    assert (rec.weights[MB:, 1] == 0).all() and (rec.weights[:MB, 1] > 0).all()
    assert all((t[MB:, 1] == 0).all() for t in _leaves(rec.deltas))
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV,
                       "dropout@p0:epoch1,dropout@p1:epoch1,dropout@p2:epoch1")
    with pytest.raises(ValueError, match="every partner is dropped"):
        record_updates(_engine(partners=3))


def test_slots_and_masks_are_bit_equal_under_a_plan(monkeypatch):
    """Under the deterministic reduce a faulty batch trains the same bits
    on slots as masked (`tests/test_torch_slots.py`'s contract, with the
    plan's dropout and stragglers on)."""
    (_, _, _), (stacked, val, _), _ = _problem(2)
    out = []
    for route, coal in (("masked", COALITIONS["masked"]), ("slots", COALITIONS["slots"])):
        cfg = {**FEDAVG, **FAULTS, "deterministic_reduce": True,
               "slot_count": 3 if route == "slots" else None}
        tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
        gens = [torch.Generator().manual_seed(4) for _ in coal]
        state = tr.init_state(gens, 3, "cpu")
        out.append(tr.epoch_chunk(state, stacked, val, torch.tensor(coal), gens, 3))
    masked, slots = out
    for a, b in zip(_leaves(masked.params) + _leaves(masked.stale),
                    _leaves(slots.params) + _leaves(slots.stale)):
        assert torch.equal(a, b)
    assert torch.equal(masked.val_loss_h, slots.val_loss_h)


# ---------------------------------------------------------------------------
# (e) step_width_mult
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_fused_windows_match_jax(k):
    """Every (fused) step's row indices and validity, every partner and
    minibatch, bit-equal to the JAX trainer's `_subbatch`; a pass takes
    ceil(gup / k) steps."""
    (jstacked, _, _), (stacked, _, _), _ = _problem(2)
    cfg = dict(approach="fedavg", aggregator="uniform", epoch_count=1, minibatch_count=2,
               gradient_updates_per_pass=5, step_width_mult=k)
    jtr = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    assert tr.cfg.pass_steps == -(-5 // k)
    perms = np.array(jtr.gen_epoch_streams(jax.random.PRNGKey(1), jstacked.mask, 0, 1)[0][0])
    mb_cap = stacked.x.shape[1] // 2
    sb_cap = (mb_cap + 4) // 5
    for mb in range(2):
        for g in range(tr.cfg.pass_steps):
            idx, valid = tr._subbatch(torch.from_numpy(perms)[None], stacked.sizes[None], mb, g,
                                      sb_cap)
            for p in range(3):
                jidx, jvalid = jtr._subbatch(jnp.asarray(perms[p]), jstacked.sizes[p], mb, g,
                                             sb_cap)
                np.testing.assert_array_equal(idx[0, p].numpy(), np.asarray(jidx))
                np.testing.assert_array_equal(valid[0, p].numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("route", ["masked", "slots"])
def test_step_width_two_matches_jax(route):
    """A k = 2 fedavg chunk (gup 3: steps of 2 and 1 base windows) against
    the JAX trainer's: params and history within 1e-4."""
    (jstacked, jval, _), (stacked, val, _), _ = _problem(2)
    cfg = {**FEDAVG, "gradient_updates_per_pass": 3, "step_width_mult": 2}
    if route == "slots":
        cfg["slot_count"] = 3
    coals = COALITIONS[route]
    jinit, jstates, perms = _jax_runs(coals, cfg, jax.random.PRNGKey(4), jstacked, jval)
    state = _port_run(coals, cfg, _np(jinit.params), perms, stacked, val)
    for b, js in enumerate(jstates):
        _assert_trees_close(state.row(b).params, js.params, atol=1e-4)
        np.testing.assert_allclose(state.row(b).partner_h.numpy(), np.asarray(js.partner_h),
                                   rtol=0, atol=1e-4)


def _old_step_rows(self, sizes, g, sb_cap):
    """The per-sub-batch window the trainer took before fused steps."""
    cfg = self.cfg
    mbc, gup = cfg.minibatch_count, cfg.gradient_updates_per_pass
    valid_mb = (sizes // mbc)[..., None]
    sb = (valid_mb + gup - 1) // gup
    ar = torch.arange(sb_cap, device=sizes.device)
    local = g * sb + ar
    return local, valid_mb, (ar < sb) & (local < valid_mb)


@pytest.mark.parametrize("approach", ["fedavg", "seqavg"])
def test_step_width_one_is_the_per_sub_batch_stepping(monkeypatch, approach):
    """k = 1 (explicit, and the knob's default) trains bit for bit as the
    per-sub-batch window did."""
    (_, _, _), (stacked, val, _), _ = _problem(2)
    cfg = {**FEDAVG, "approach": approach}

    def run(**extra):
        tr = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg, **extra))
        gens = [torch.Generator().manual_seed(4) for _ in range(2)]
        state = tr.init_state(gens, 3, "cpu")
        return tr.epoch_chunk(state, stacked, val, torch.tensor(COALITIONS["masked"]), gens, 3)

    new, default = run(step_width_mult=1), run()
    assert TrainConfig(**cfg).step_width_mult == 1
    with monkeypatch.context() as m:
        m.setattr(MplTrainer, "_step_rows", _old_step_rows)
        old = run(step_width_mult=1)
    for a, b, c in zip(_leaves(new.params), _leaves(old.params), _leaves(default.params)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(new.partner_h.nan_to_num(), old.partner_h.nan_to_num())
    # and k = 2 is another trajectory
    two = run(step_width_mult=2)
    assert not all(torch.equal(a, b) for a, b in zip(_leaves(new.params), _leaves(two.params)))


def test_step_width_knob(monkeypatch):
    base = dict(epoch_count=2, minibatch_count=2)
    monkeypatch.setenv(constants.STEP_WIDTH_MULT_ENV, "2")
    cfg = TrainConfig(**base)
    monkeypatch.delenv(constants.STEP_WIDTH_MULT_ENV)
    assert cfg.step_width_mult == 2 and cfg.pass_steps == 4
    monkeypatch.setenv(constants.STEP_WIDTH_MULT_ENV, "0")
    with pytest.warns(UserWarning, match="positive integer"):
        assert TrainConfig(**base).step_width_mult == 1
    with pytest.raises(ValueError, match="step_width_mult"):
        TrainConfig(step_width_mult=0, **base)
    # the single trainer keeps minibatch_count x gup steps
    monkeypatch.setenv(constants.STEP_WIDTH_MULT_ENV, "2")
    eng = _engine(partners=3)
    assert eng._multi_cfg.step_width_mult == 2
    assert eng._fingerprint()["step_width_mult"] == 2
