"""The gradient-call width rule on the CPU, one torch thread
(`TrainConfig.fixed_call_width`, `models/zoo.py` `grad_call_width`):

- every model of the zoo carries the call width chosen for it by cost;
- under the rule a step of N models (1-20, B coalitions x K partner
  slots, and wider) makes ceil(N / M) calls of exactly M models, the last
  padded; without it (the fit, the recording) one call of N; the calls
  the trainer makes are the calls it logs (`call_log`), traced on meta
  tensors through `_model_grads` itself;
- the engine's trainers take the rule and the recording does not;
- padding and splitting leave every model's gradients as its own call of
  M gives them (the dense Titanic model), and an engine's sweep is
  bit-equal to its sweep one coalition a batch.

The card's side, every model's gradient bit-equal at every step width,
is `tests/test_torch_cuda.py::test_gradients_do_not_depend_on_the_step_width_on_the_card`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.reconstruct import record_updates
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data import datasets
from mplc_tpu_torch.models import zoo
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

CFG = TrainConfig(epoch_count=1, minibatch_count=1, gradient_updates_per_pass=1)
RULE = dataclasses.replace(CFG, fixed_call_width=True)
# the widths chosen by the cost of a call on an NVIDIA H100 80GB HBM3
# (`python3 -m mplc_tpu_torch.obs.width_parity --cost-only`)
WIDTHS = {"mnist_cnn": 20, "cifar10_cnn": 20, "imdb_conv1d": 12,
          "esc50_cnn": 8, "titanic_logreg": 160}
SHAPES = {"mnist_cnn": ((28, 28, 1), torch.float32), "cifar10_cnn": ((32, 32, 3), torch.float32),
          "imdb_conv1d": ((500,), torch.int32), "esc50_cnn": ((40, 431, 1), torch.float32),
          "titanic_logreg": ((27,), torch.float32)}
STEPS = list(range(1, 21)) + [b * k for b in (1, 2, 4, 8, 16) for k in range(2, 11)] \
    + [161, 200]


def scenario(partners=4):
    amounts = [(i + 1) / sum(range(1, partners + 1)) for i in range(partners)]
    sc = Scenario(partners, amounts, is_dry_run=True, dataset=datasets.load_titanic(),
                  seed=3, epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2,
                  is_early_stopping=False, device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def test_every_model_has_its_chosen_call_width():
    assert {name: m.grad_call_width for name, m in zoo.MODELS.items()} == WIDTHS


def _logged_calls(model, cfg, n: int, rows: int = 3) -> list:
    """`_model_grads` of n models on meta tensors: the calls it logs, after
    checking that the gradients come back for the n models."""
    shape, dtype = SHAPES[model.name]
    tr = MplTrainer(model, cfg)
    meta = torch.device("meta")
    base = model.init(torch.Generator().manual_seed(0))
    params = {g: {k: t.to(meta).expand((n,) + t.shape) for k, t in d.items()}
              for g, d in base.items()}
    x = torch.empty((n, rows) + shape, dtype=dtype, device=meta)
    drop = tuple(torch.empty((n, rows) + s, dtype=torch.bool, device=meta)
                 for _, s in model.dropout)
    tr.call_log = []
    grads, (loss, _) = tr._model_grads(params, x, torch.empty((n, rows, model.label_dim()),
                                                              device=meta),
                                       torch.empty((n, rows), device=meta), drop)
    assert loss.shape == (n,)
    assert all(t.shape[0] == n for d in grads.values() for t in d.values())
    return tr.call_log


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_the_rule_makes_calls_of_the_models_width(name):
    """ceil(N / M) calls of exactly M models for every step, the last
    holding at least one real model."""
    model = zoo.MODELS[name]
    M = model.grad_call_width
    for n in STEPS:
        calls = -(-n // M)
        assert _logged_calls(model, RULE, n) == [("grad", M, 3)] * calls, n
        assert M * (calls - 1) < n <= M * calls


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_without_the_rule_a_step_is_one_call(name):
    model = zoo.MODELS[name]
    for n in (1, 7, 20):
        assert _logged_calls(model, CFG, n) == [("grad", n, 3)]


def test_the_engines_trainers_take_the_rule_and_the_recording_does_not(monkeypatch):
    """The multi, single and slot trainers split their steps; the recording
    of the grand coalition (P models at one width) makes one call a step."""
    eng = CharacteristicEngine(scenario())
    for pipe in (eng.multi_pipe, eng.single_pipe, eng._slot_pipe(3)):
        assert pipe.trainer.cfg.fixed_call_width
    seen = []
    init = MplTrainer.__init__

    def spy(self, model, cfg):
        seen.append(cfg.fixed_call_width)
        init(self, model, cfg)
    monkeypatch.setattr(MplTrainer, "__init__", spy)
    record_updates(eng)
    assert seen == [False]


@pytest.mark.parametrize("n", [1, 2, 7, 16, 40])
def test_padding_and_splitting_keep_every_models_gradients(n):
    """Each of n models gets the gradients of its own call of M (itself
    padded): the rule's calls of M, split and padded, hold every model
    as its solo call does (the dense Titanic model, whose per-model
    arithmetic does not depend on its neighbours in a call here)."""
    model = zoo.TITANIC_LOGREG
    tr = MplTrainer(model, RULE)
    g = torch.Generator().manual_seed(n)
    trees = [model.init(g) for _ in range(n)]
    params = {k: {q: torch.stack([t[k][q] for t in trees]) for q in trees[0][k]}
              for k in trees[0]}
    x = torch.rand(n, 20, 27, generator=g)
    y = (torch.rand(n, 20, 1, generator=g) > 0.5).float()
    m = torch.ones(n, 20)
    ga, (la, _) = tr._model_grads(params, x, y, m, ())
    for i in range(n):
        one = lambda t: t[i:i + 1]  # noqa: E731
        gi, (li, _) = tr._model_grads({k: {q: one(t) for q, t in d.items()}
                                       for k, d in params.items()}, one(x), one(y), one(m), ())
        assert torch.equal(la[i], li[0])
        for k in ga:
            for q in ga[k]:
                assert torch.equal(ga[k][q][i], gi[k][q][0]), (i, k, q)


def test_a_sweep_is_bit_equal_one_coalition_a_batch():
    """Titanic, 4 partners: the sweep at the default cap against the same
    coalitions requested one at a time (width 1: single calls padded to
    M)."""
    subsets = powerset_order(4)
    whole = CharacteristicEngine(scenario()).evaluate(subsets)
    alone = CharacteristicEngine(scenario())
    one = np.array([alone.evaluate([s])[0] for s in subsets])
    assert [b["width"] for b in alone.batch_log] == [1] * len(subsets)
    np.testing.assert_array_equal(one, whole)


def test_the_probe_picks_the_width_whose_worst_step_is_least_slowed():
    """`width_parity.call_width` on a made-up table of call times (ms by
    width): flat up to 8, then linear. M = 8 slows no step more than
    4/3 (a step of 12 in two calls of 8: 2 x 6 / 9), where M = 12 slows a
    step of 1 1.5x, M = 16 2x and M = 4 a step of 16 2x."""
    from mplc_tpu_torch.obs.width_parity import call_width
    ms = {1: 6.0, 2: 6.0, 4: 6.0, 8: 6.0, 12: 9.0, 16: 12.0}
    assert call_width(ms) == 8
    assert call_width({1: 5.0, 160: 5.0}) == 160       # free padding: the widest
