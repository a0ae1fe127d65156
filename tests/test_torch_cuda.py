"""The port on the card: K1 and K1-bf16 against their plain versions, the
retraining sweep, SVARM, seqavg, lflip, the partner fault plan, fused
wide steps, dropout masks and the CIFAR10 and ESC50 CNNs' training forward
passes against the CPU, fp32 reproducibility (the IMDB model's embedding
gradient too), the CLI's Titanic grid against the CPU's, and the
retrain-free path traced and profiled on the card, every model's
gradients at every step width (the gradient-call width rule), the live
tier, the sweep service's jobs against the solo engine and K1, routed
jobs failed over between two shards on the card against the solo engine,
and a fleet sweep's two worker processes on the card against one shard.

These tests need a CUDA device and skip without one. They import no JAX,
so they run on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import logging
import re

import numpy as np
import pandas as pd
import pytest
import torch

from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.reconstruct import ReconstructionEvaluator, record_updates
from mplc_tpu_torch.convert import params_to_numpy, recorded_run_from_numpy
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data.datasets import load_mnist, load_titanic
from mplc_tpu_torch.main import main as cli_main
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.mpl import dropout
from mplc_tpu_torch.ops import recon_kernel as trk
from mplc_tpu_torch.scenario import Scenario

pytestmark = pytest.mark.cuda

# K1's contract, from the JAX package's kernel tests: the same fp32 sum in
# another association. K1-bf16 is held to the same: its bf16 x bf16
# products are exact in fp32, so only the order of the fp32 sum differs
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, K, D, seed, device):
    rng = np.random.default_rng(seed)
    wn2 = rng.random((B, K)).astype(np.float32)
    wn2[0] = 0.0                         # a coalition with no surviving weight
    return tuple(torch.from_numpy(a).to(device) for a in (
        wn2, rng.standard_normal((K, D)).astype(np.float32),
        rng.standard_normal(D).astype(np.float32)))


# the odd fixture shape, ragged edges on every axis, more than one B tile,
# a slice of the main path's width at B = 64, 32 and 16 (four, two and one
# m16 fragments a block), and an odd D (4-byte copies of d). The inputs
# are standard normal: on them one TF32 product instead of K1's three, or
# MMAs chained over all of K = 200, lands farther from the exact sum than
# the plain fp32 product (tests/test_torch_recon_kernel.py emulates both)
@pytest.mark.parametrize("B,K,D", [(5, 12, 22), (70, 13, 129), (64, 200, 40000),
                                   (1, 1, 1), (16, 200, 40000), (64, 200, 40001),
                                   (32, 200, 40000)])
def test_kernel_matches_plain_version(cuda, B, K, D):
    wn2, d2, init = _inputs(B, K, D, B + K, cuda)
    before, widths = trk.launches, dict(trk.launch_widths)
    got = trk.fused_contract(wn2, d2, init)
    torch.cuda.synchronize()
    assert trk.launches == before + 1
    assert trk.launch_widths[B] == widths.get(B, 0) + 1
    ref = trk.fused_contract_reference(wn2, d2, init)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(got[0], init)     # bit-exact pass-through
    # K1 no farther from the exact (float64) sum than the plain fp32
    # product, or ATOL where that one is nearly exact: at K = 200 K1 lands
    # about 4x nearer, a chained or one-product kernel 3x to 400x farther
    exact = torch.addmm(init.double().reshape(1, -1), wn2.double(), d2.double())
    err, err_plain = ((t.double() - exact).abs().max().item() for t in (got, ref))
    assert err <= max(err_plain, ATOL)


def test_kernel_takes_a_view_that_is_only_4_byte_aligned(cuda):
    """d2 a contiguous view whose base pointer is 4 bytes past an 8-byte
    boundary, with D even: the kernel must see the pointer, not just D,
    and copy d in 4-byte pieces."""
    B, K, D = 16, 200, 40000
    wn2, d2, init = _inputs(B, K, D, 3, cuda)
    flat = torch.empty(K * D + 1, device=cuda)
    view = flat[1:].view(K, D)
    view.copy_(d2)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    got = trk.fused_contract(wn2, view, init)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, trk.fused_contract_reference(wn2, d2, init),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got[0], init)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    wn2, d2, init = _inputs(4, 6, 10, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        trk.fused_contract(wn2.double(), d2, init)
    with pytest.raises(ValueError, match="contiguous"):
        trk.fused_contract(wn2, d2.t().contiguous().t(), init)
    with pytest.raises(ValueError, match="shape"):
        trk.fused_contract(wn2, d2, init[:-1])
    with pytest.raises(ValueError, match="CUDA"):
        trk.fused_contract(wn2, d2.cpu(), init)


def _inputs_bf16(B, K, D, seed, device):
    wn2, d2, init = _inputs(B, K, D, seed, device)
    return wn2.to(torch.bfloat16), d2.to(torch.bfloat16), init


# as for K1, plus odd D (the kernel's narrow route, 2-byte loads of d) and
# a K that is a whole number of staged steps; at K = 200, B = 64, 32 and 16
# (four, two and one m16 fragments a block) on both the 16-byte route (D a
# multiple of 8) and the narrow one; and a K past the 256 columns of wn the
# kernel stages at once
@pytest.mark.parametrize("B,K,D", [(5, 12, 22), (70, 13, 129), (64, 200, 40000),
                                   (1, 1, 1), (64, 64, 40001), (16, 200, 40000),
                                   (32, 200, 40000), (16, 200, 40001),
                                   (5, 600, 1000), (20, 600, 1003)])
def test_bf16_kernel_matches_plain_version(cuda, B, K, D):
    wn2, d2, init = _inputs_bf16(B, K, D, B + K, cuda)
    before, before_f32 = trk.launches_bf16, trk.launches
    widths = dict(trk.launch_widths_bf16)
    got = trk.fused_contract_bf16(wn2, d2, init)
    torch.cuda.synchronize()
    assert trk.launches_bf16 == before + 1 and trk.launches == before_f32
    assert trk.launch_widths_bf16[B] == widths.get(B, 0) + 1
    assert got.dtype == torch.float32 and got.shape == (B, D)
    ref = trk.fused_contract_bf16_reference(wn2, d2, init)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(got[0], init)     # bit-exact pass-through


def test_bf16_kernel_takes_a_view_that_is_only_4_byte_aligned(cuda):
    """d2 a contiguous view whose base pointer is 4 bytes past a 16-byte
    boundary, with D a multiple of 8: the kernel must see the pointer, not
    just D, and take its narrow route."""
    B, K, D = 16, 200, 40000
    wn2, d2, init = _inputs_bf16(B, K, D, 3, cuda)
    flat = torch.empty(K * D + 2, device=cuda, dtype=torch.bfloat16)
    view = flat[2:].view(K, D)
    view.copy_(d2)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = trk.fused_contract_bf16(wn2, view, init)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, trk.fused_contract_bf16_reference(wn2, d2, init),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got[0], init)


def test_bf16_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    wn2, d2, init = _inputs_bf16(4, 6, 10, 0, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        trk.fused_contract_bf16(wn2.float(), d2, init)
    with pytest.raises(ValueError, match="bfloat16"):
        trk.fused_contract_bf16(wn2, d2.float(), init)
    with pytest.raises(ValueError, match="float32"):
        trk.fused_contract_bf16(wn2, d2, init.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        trk.fused_contract_bf16(wn2, d2.t().contiguous().t(), init)
    with pytest.raises(ValueError, match="shape"):
        trk.fused_contract_bf16(wn2, d2, init[:-1])
    with pytest.raises(ValueError, match="CUDA"):
        trk.fused_contract_bf16(wn2, d2.cpu(), init)


def _titanic_sweep(device):
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(), epoch_count=2,
                  minibatch_count=2, gradient_updates_per_pass_count=2,
                  is_early_stopping=False, methods=["Shapley values"], seed=0,
                  device=device)
    sc.run()
    return (np.array([sc._charac_engine.charac_fct_values[s] for s in powerset_order(3)]),
            len(sc.dataset.x_test))


def test_titanic_sweep_on_the_card_matches_the_cpu(cuda):
    (card, n_test), (cpu, _) = _titanic_sweep("cuda"), _titanic_sweep("cpu")
    # one test sample may flip at a decision boundary
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1.0 / n_test + 1e-6)


def test_titanic_sweep_under_a_fault_plan_on_the_card(cuda, monkeypatch):
    """The Titanic sweep on the card under a batch-fault plan (cap 1: 7
    batches): two transients retried, an OOM halving nothing further (cap 1
    stays 1), one at harvest re-run. Every value equals the card's
    fault-free sweep at the same cap: the widths never move, so the bits
    must not either."""
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", "1")
    monkeypatch.setenv("MPLC_TORCH_RETRY_BACKOFF_SEC", "0")
    monkeypatch.delenv("MPLC_TORCH_FAULT_PLAN", raising=False)
    clean, _ = _titanic_sweep("cuda")
    monkeypatch.setenv("MPLC_TORCH_FAULT_PLAN",
                       "transient@batch2,transient@harvest3,oom@batch4,oom@harvest5")
    from mplc_tpu_torch.obs import metrics
    metrics.reset()
    faulted, _ = _titanic_sweep("cuda")
    snap = metrics.snapshot()["counters"]
    assert snap["engine.faults_injected"] == 4 and snap["engine.retries"] == 2
    assert snap["engine.cap_halvings"] == 2 and not snap.get("engine.cpu_degraded_batches")
    np.testing.assert_array_equal(faulted, clean)


def test_two_fp32_recordings_on_the_card_are_bit_equal(cuda):
    """The MNIST CNN (cuDNN convolutions, cuBLAS products) recorded twice
    from one seed: every delta, weight and final parameter bit-equal."""
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_mnist(scale=0.02), epoch_count=1,
                  minibatch_count=2, gradient_updates_per_pass_count=2,
                  is_early_stopping=False, seed=0, device="cuda")
    sc.instantiate_scenario_partners()
    sc.split_data()
    c = Contributivity(sc)
    a, b = c._reconstructor().recorded, record_updates(c.engine)
    assert torch.equal(a.weights, b.weights)
    for x, y in ((a.deltas, b.deltas), (a.final_params, b.final_params)):
        for g in x:
            for k in x[g]:
                assert torch.equal(x[g][k], y[g][k]), (g, k)


def _titanic_game(device):
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(), epoch_count=2,
                  minibatch_count=2, gradient_updates_per_pass_count=2,
                  is_early_stopping=False, seed=0, device=device)
    sc.instantiate_scenario_partners()
    sc.split_data()
    return Contributivity(sc)


def test_svarm_on_the_card_matches_the_cpu(cuda):
    """SVARM over one Titanic game recorded on the card, reconstructed
    (K1) and evaluated on the card, and the same recording reconstructed
    and evaluated on the CPU: the same draws, scores and std within 1e-6."""
    card = _titanic_game("cuda")
    before = trk.launches
    card.SVARM()
    assert trk.launches > before
    rec = card._reconstructor().recorded
    cpu = _titanic_game("cpu")
    cpu.engine._reconstruction = ReconstructionEvaluator(cpu.engine, recorded_run_from_numpy(
        params_to_numpy(rec.init_params), params_to_numpy(rec.deltas),
        rec.weights.cpu().numpy()))
    cpu.SVARM()
    assert card._reconstructor().reconstructions == cpu._reconstructor().reconstructions
    np.testing.assert_allclose(card.contributivity_scores, cpu.contributivity_scores,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(card.scores_std, cpu.scores_std, rtol=0, atol=1e-6)


def _fit(approach, dataset, device, **game):
    """The grand coalition's fit under `approach`: (the fitted approach
    object, test-set size)."""
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=dataset, seed=0,
                  multi_partner_learning_approach=approach, is_early_stopping=False,
                  device=device, **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    mpl = sc.multi_partner_learning_approach(sc)
    mpl.fit()
    return mpl, len(sc.dataset.x_test)


def test_seqavg_on_the_card_matches_the_cpu(cuda):
    """Titanic seqavg, fit and retraining sweep (on slots), on the card and
    on the CPU: params within 1e-4, v(S) within one test sample."""
    game = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
    (card, n_test), (cpu, _) = (_fit("seqavg", load_titanic(), d, **game)
                                for d in ("cuda", "cpu"))
    for g in cpu.model_params:
        for k in cpu.model_params[g]:
            torch.testing.assert_close(card.model_params[g][k].cpu(), cpu.model_params[g][k],
                                       rtol=0, atol=1e-4)
    values = []
    for device in ("cuda", "cpu"):
        sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(), seed=0,
                      multi_partner_learning_approach="seqavg", is_early_stopping=False,
                      methods=["Shapley values"], device=device, **game)
        sc.run()
        assert sc.slot_bucketing == "merge"
        values.append(np.array([sc._charac_engine.charac_fct_values[s]
                                for s in powerset_order(3)]))
    np.testing.assert_allclose(values[0], values[1], rtol=0, atol=1.0 / n_test + 1e-6)


def test_lflip_on_the_card_matches_the_cpu(cuda):
    """A small MNIST CNN lflip fit of one epoch (2 minibatches of 2 steps)
    on the card and on the CPU from one seed: theta within 1e-5; params
    within 1e-4 but for the few weights Adam moves by whole steps on tiny
    gradient differences (tests/test_torch_lflip.py MAX_STEP_SHARE): at
    most 1e-4 of the weights, each within one learning rate a step."""
    game = dict(epoch_count=1, minibatch_count=2, gradient_updates_per_pass_count=2)
    (card, _), (cpu, _) = (_fit("lflip", load_mnist(scale=0.02), d, **game)
                           for d in ("cuda", "cpu"))
    far = total = 0
    for g in cpu.model_params:
        for k in cpu.model_params[g]:
            diff = (card.model_params[g][k].cpu() - cpu.model_params[g][k]).abs()
            assert diff.max().item() <= 4 * 1e-3, (g, k)
            far += int((diff > 1e-4).sum())
            total += diff.numel()
    assert far <= 1e-4 * total
    np.testing.assert_allclose(np.stack(card.history.theta[0]),
                               np.stack(cpu.history.theta[0]), rtol=0, atol=1e-5)


def test_k1_under_a_fault_plan_matches_the_cpu(cuda, monkeypatch):
    """A Titanic game under `dropout@p1:epoch2,straggler@p0:delay1`, recorded
    on the card (partner 1's epoch-2 rows exact zeros) and reconstructed
    through K1 there, against the same game on the CPU: recordings within
    1e-4, v(S) within one test sample."""
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p1:epoch2,straggler@p0:delay1")
    card, cpu = _titanic_game("cuda"), _titanic_game("cpu")
    before = trk.launches
    card.exact_reconstructed()
    assert trk.launches > before
    cpu.exact_reconstructed()
    a, b = card._reconstructor().recorded, cpu._reconstructor().recorded
    assert (a.weights[2:, 1] == 0).all() and (a.weights[:2, 1] > 0).all()
    for x, y in ((a.deltas, b.deltas), (a.final_params, b.final_params)):
        for g in y:
            for k in y[g]:
                torch.testing.assert_close(x[g][k].cpu(), y[g][k], rtol=0, atol=1e-4)
    n_test = len(card.scenario.dataset.x_test)
    values = [np.array([c._reconstructor().values[s] for s in powerset_order(3)])
              for c in (card, cpu)]
    np.testing.assert_allclose(values[0], values[1], rtol=0, atol=1.0 / n_test + 1e-6)


def test_straggler_and_step_width_on_the_card_match_the_cpu(cuda, monkeypatch):
    """A Titanic recording through the engine under `straggler@p1:delay2`,
    and a fedavg fit under MPLC_TORCH_STEP_WIDTH_MULT=2, on the card and on
    the CPU: within 1e-4."""
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "straggler@p1:delay2")
    card, cpu = (record_updates(_titanic_game(d).engine) for d in ("cuda", "cpu"))
    torch.testing.assert_close(card.weights.cpu(), cpu.weights, rtol=0, atol=1e-4)
    for x, y in ((card.deltas, cpu.deltas), (card.final_params, cpu.final_params)):
        for g in y:
            for k in y[g]:
                torch.testing.assert_close(x[g][k].cpu(), y[g][k], rtol=0, atol=1e-4)
    monkeypatch.setenv(constants.STEP_WIDTH_MULT_ENV, "2")
    game = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=3)
    (fit_card, _), (fit_cpu, _) = (_fit("fedavg", load_titanic(), d, **game)
                                   for d in ("cuda", "cpu"))
    assert fit_card.cfg.step_width_mult == 2
    for g in fit_cpu.model_params:
        for k in fit_cpu.model_params[g]:
            torch.testing.assert_close(fit_card.model_params[g][k].cpu(),
                                       fit_cpu.model_params[g][k], rtol=0, atol=1e-4)


def test_dropout_masks_on_the_card_match_the_cpu(cuda):
    """One seed, the same keep masks on either device: the hash is int64
    arithmetic that never overflows (mplc_tpu_torch/mpl/dropout.py)."""
    g = torch.Generator().manual_seed(3)
    keys = torch.stack([dropout.draw_key(g) for _ in range(4)])
    pids = torch.arange(5)[None, :, None].expand(4, 5, 1)
    for rows in (1, 27):
        cpu = dropout.step_masks(keys, rows, tzoo.CIFAR10_DROPOUT, 1, 3, pids, 7)
        card = dropout.step_masks(keys.to(cuda), rows, tzoo.CIFAR10_DROPOUT, 1, 3,
                                  pids.to(cuda), 7)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))


def test_cifar10_training_forward_on_the_card_matches_the_cpu(cuda):
    """The CIFAR10 CNN's training forward pass under one set of injected
    masks: logits within 1e-5 (fp32, TF32 off)."""
    Scenario(3, [0.2, 0.3, 0.5], dataset=load_titanic(), is_dry_run=True)   # the card's modes
    model = tzoo.CIFAR10_CNN
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((32, 32, 32, 3)).astype(np.float32))
    keys = torch.tensor([[1, 2]])
    masks = [m[0] for m in dropout.step_masks(keys, 32, model.dropout, 0)]
    cpu = model.apply(params, x, dropout=masks)
    card = model.apply({g: {k: t.to(cuda) for k, t in d.items()} for g, d in params.items()},
                       x.to(cuda), dropout=[m.to(cuda) for m in masks]).cpu()
    assert float((cpu - model.apply(params, x)).abs().max()) > 1e-3
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=0, atol=1e-5)


def test_embedding_gradient_on_the_card_is_bit_equal_twice(cuda):
    """The IMDB model's gradient vmapped over 4 stacked models, its tokens
    drawn from 40 values so that every row repeats them: the table's
    gradient accumulates the repeats, twice bit-equal under the card's
    deterministic mode, and within 1e-6 of the CPU's."""
    Scenario(3, [0.2, 0.3, 0.5], dataset=load_titanic(), is_dry_run=True)   # the card's modes
    model = tzoo.IMDB_CONV1D
    p = model.init(torch.Generator().manual_seed(0))
    stacked = {g: {k: torch.stack([t * (1 + 0.1 * i) for i in range(4)]) for k, t in d.items()}
               for g, d in p.items()}
    x = torch.randint(300, 340, (4, 8, tzoo.IMDB_SEQ_LEN),
                      generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    y = torch.randint(0, 2, (4, 8, 1), generator=torch.Generator().manual_seed(2)).float()
    m = torch.ones(4, 8)

    def loss(q, xb, yb, mb):
        from mplc_tpu_torch.ops import metrics
        return metrics.masked_loss_and_metrics("binary", model.apply(q, xb), yb, mb)[0]
    grad = torch.func.vmap(torch.func.grad(loss))
    on = lambda t: t.to(cuda)  # noqa: E731
    card = [grad({g: {k: on(t) for k, t in d.items()} for g, d in stacked.items()},
                 on(x), on(y), on(m)) for _ in range(2)]
    cpu = grad(stacked, x, y, m)
    for g in cpu:
        for k in cpu[g]:
            assert torch.equal(card[0][g][k], card[1][g][k]), (g, k)
            torch.testing.assert_close(card[0][g][k].cpu(), cpu[g][k], rtol=1e-5, atol=1e-6)
    table = card[0]["emb"]["table"]
    assert float(table[:, 300:340].abs().sum()) > 0 and float(table[:, :300].abs().sum()) == 0


def test_esc50_training_forward_on_the_card_matches_the_cpu(cuda):
    """The ESC50 CNN's training forward pass under one set of injected
    masks: logits within 1e-5 (fp32, TF32 off)."""
    Scenario(3, [0.2, 0.3, 0.5], dataset=load_titanic(), is_dry_run=True)   # the card's modes
    model = tzoo.ESC50_CNN
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random((16, 40, 431, 1)).astype(np.float32))
    masks = [m[0] for m in dropout.step_masks(torch.tensor([[3, 4]]), 16, model.dropout, 0)]
    cpu = model.apply(params, x, dropout=masks)
    card = model.apply({g: {k: t.to(cuda) for k, t in d.items()} for g, d in params.items()},
                       x.to(cuda), dropout=[m.to(cuda) for m in masks]).cpu()
    assert float((cpu - model.apply(params, x)).abs().max()) > 1e-4
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=0, atol=1e-5)


TITANIC_GRID = """experiment_name: titanic_grid
n_repeats: 1
scenario_params_list:
  - dataset_name:
      titanic: null
    partners_count: [3]
    amounts_per_partner: [[0.2, 0.3, 0.5]]
    samples_split_option: [['basic', 'random'], ['advanced', [[1, 'specific'], [1, 'shared'], [1, 'shared']]]]
    aggregation_weighting: ['uniform', 'local-score']
    epoch_count: [2]
    minibatch_count: [2]
    gradient_updates_per_pass_count: [2]
    is_early_stopping: [False]
    methods: [['Independent scores', 'GTG-Shapley']]
"""


def _cli_results(folder, device, monkeypatch):
    folder.mkdir()
    (folder / "cfg.yml").write_text(TITANIC_GRID)
    monkeypatch.chdir(folder)
    logger = logging.getLogger("mplc_tpu_torch")
    handlers = list(logger.handlers)
    try:
        assert cli_main(["-f", "cfg.yml", "--device", device]) == 0
    finally:
        # the CLI's console handler writes to the test's captured stdout
        for h in list(logger.handlers):
            if h not in handlers:
                logger.removeHandler(h)
    (exp,) = (folder / "experiments").glob("titanic_grid_*")
    return pd.read_csv(exp / "results.csv")


def test_titanic_cli_grid_on_the_card_matches_the_cpu(cuda, monkeypatch, tmp_path):
    """`python3 -m mplc_tpu_torch.main` on a Titanic grid of four scenarios
    on the card and on the CPU: the same results.csv but for the scenario
    names and the times, the scores within one test sample (90 rows)."""
    monkeypatch.delenv(constants.PRECISION_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    card = _cli_results(tmp_path / "card", "cuda", monkeypatch)
    cpu = _cli_results(tmp_path / "cpu", "cpu", monkeypatch)
    assert list(card.columns) == list(cpu.columns) and len(card) == len(cpu) == 4 * 2 * 3
    for col in card.columns:
        if col in ("scenario_name", "learning_computation_time_sec", "computation_time_sec"):
            continue
        if col in ("mpl_test_score", "contributivity_score", "contributivity_std",
                   "contributivity_scores", "contributivity_stds"):
            for a, b in zip(card[col], cpu[col]):
                a, b = ([float(x) for x in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?",
                                                      re.sub(r"np\.float\d+", "", v))]
                        if isinstance(v, str) else [v] for v in (a, b))
                np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 90 + 1e-6, err_msg=col)
        else:
            pd.testing.assert_series_equal(card[col], cpu[col], obj=col)


def test_titanic_traced_and_profiled_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The retrain-free path traced on the card and on the CPU: the same
    span and event names and memo counts; on the card the report's
    reconstruction batches equal K1's launches, and `profile_trace` sees
    K1's kernel as often as it launched."""
    from mplc_tpu_torch import utils
    from mplc_tpu_torch.obs import analyze_trace, report, trace

    def run(device):
        sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(),
                      epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2,
                      is_early_stopping=False, seed=0, device=device)
        sc.instantiate_scenario_partners()
        sc.split_data()
        with trace.collect() as recs:
            Contributivity(sc).exact_reconstructed()
        return recs

    cpu = report.sweep_report(run("cpu"))
    launches = trk.launches
    with utils.profile_trace(str(tmp_path)) as prof:
        recs = run(cuda)
    launched = trk.launches - launches
    ours = report.sweep_report(recs)
    assert ours["memo"] == cpu["memo"]
    assert ours["reconstruction"]["reconstructions"] == 7
    assert ours["reconstruction"]["recon_batches"] == launched > 0
    k1 = [k for n, k in analyze_trace.summarize(prof.path)["kernels"].items()
          if "recon_matmul_kernel" in n]
    assert sum(k["count"] for k in k1) == launched


# each model's step rows in its `chip_smoke.py` scenario (the multi
# trainer's, obs/width_parity.py), and another row count
WIDTH_ROWS = {"mnist_cnn": 45, "cifar10_cnn": 38, "imdb_conv1d": 113, "esc50_cnn": 8,
              "titanic_logreg": 49}
OTHER_ROWS = 17
WIDTH_SHAPES = {"mnist_cnn": (28, 28, 1), "cifar10_cnn": (32, 32, 3), "imdb_conv1d": (500,),
                "esc50_cnn": (40, 431, 1), "titanic_logreg": (27,)}


@pytest.mark.parametrize("other_rows", [False, True])
@pytest.mark.parametrize("name", sorted(WIDTH_ROWS))
def test_gradients_do_not_depend_on_the_step_width_on_the_card(cuda, name, other_rows):
    """The gradient-call width rule on the card: a step of N = 1..20 or 41
    models (model j from the (j mod 4)-th initial parameter set) gives
    every model the gradient bits it gets in a step of one, under the
    card's deterministic mode, at the model's scenario rows and at
    another row count."""
    from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
    from mplc_tpu_torch.utils import resolve_device
    resolve_device("cuda")
    model = tzoo.MODELS[name]
    tr = MplTrainer(model, TrainConfig(epoch_count=1, minibatch_count=1,
                                       gradient_updates_per_pass=1, fixed_call_width=True))
    rows, L = (OTHER_ROWS if other_rows else WIDTH_ROWS[name]), model.label_dim()
    g = torch.Generator().manual_seed(2)
    inits = [model.init(g) for _ in range(4)]
    if name == "imdb_conv1d":
        x = torch.randint(0, tzoo.IMDB_NUM_WORDS, (rows,) + WIDTH_SHAPES[name], generator=g,
                          dtype=torch.int32)
    else:
        x = torch.rand((rows,) + WIDTH_SHAPES[name], generator=g)
    y = torch.nn.functional.one_hot(torch.randint(0, model.num_outputs, (rows,), generator=g),
                                    model.num_outputs).float().reshape(rows, -1)[:, :L]
    x, y, m = x.to(cuda), y.to(cuda), torch.ones(rows, device=cuda)

    def grads(idx):
        n = len(idx)
        p = {k: {q: torch.stack([inits[i][k][q] for i in idx]).to(cuda) for q in inits[0][k]}
             for k in inits[0]}
        drop = tuple(torch.ones((n, rows) + s, dtype=torch.bool, device=cuda)
                     for _, s in model.dropout)
        return tr._model_grads(p, x.expand((n,) + x.shape), y.expand(n, rows, L),
                               m.expand(n, rows), drop)[0]
    solo = [grads([i]) for i in range(4)]
    for n in list(range(1, 21)) + [41]:
        got = grads([j % 4 for j in range(n)])
        for j in range(n):
            for k in got:
                for q in got[k]:
                    assert torch.equal(got[k][q][j], solo[j % 4][k][q][0]), (n, j, k, q)


# -- the live tier on the card -------------------------------------------------

# K1 on a live game's grown stream, on the live path's own kind of inputs
# (each round's weights renormalized to sum to 1, deltas near 1e-3): K = 400
# (the MNIST CNN's recording doubled, R = 40 rounds of P = 10) and K = 410, a
# multiple of P but not of 32 (zero-weight rounds are left out of a stream).
# Standard-normal inputs at this depth part from the plain version past the
# tolerance through the plain version's own error; the exact-sum check holds
# K1 on them too
@pytest.mark.parametrize("B,R,D", [(64, 40, 40000), (16, 40, 40001), (64, 41, 40000),
                                   (8, 41, 1003)])
def test_kernel_on_a_live_depth_matches_plain_version(cuda, B, R, D):
    P = 10
    rng = np.random.default_rng(B + R)
    w = rng.random((B, R, P))
    w /= w.sum(-1, keepdims=True)
    w[0] = 0.0
    wn2, d2, init = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        w.reshape(B, R * P), rng.normal(0, 1e-3, (R * P, D)), rng.normal(0, 0.05, D)))
    got = trk.fused_contract(wn2, d2, init)
    torch.testing.assert_close(got, trk.fused_contract_reference(wn2, d2, init),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got[0], init)
    wb, db = wn2.to(torch.bfloat16), d2.to(torch.bfloat16)
    torch.testing.assert_close(trk.fused_contract_bf16(wb, db, init),
                               trk.fused_contract_bf16_reference(wb, db, init),
                               rtol=RTOL, atol=ATOL)
    sn2, sd2, sinit = _inputs(B, R * P, D, B + R, cuda)
    got = trk.fused_contract(sn2, sd2, sinit)
    exact = torch.addmm(sinit.double().reshape(1, -1), sn2.double(), sd2.double())
    err, err_plain = ((t.double() - exact).abs().max().item()
                      for t in (got, trk.fused_contract_reference(sn2, sd2, sinit)))
    assert err <= max(err_plain, ATOL)


def _live_titanic(device, partners=3):
    sc = Scenario(partners, [(i + 1) / sum(range(1, partners + 1)) for i in range(partners)],
                  is_dry_run=True, dataset=load_titanic(), epoch_count=2, minibatch_count=2,
                  gradient_updates_per_pass_count=2, is_early_stopping=False, seed=0,
                  device=device)
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def test_live_exact_query_equals_exact_reconstructed_on_the_card(cuda):
    """`LiveGame.from_recording` on the card: its exact query's v(S)
    bit-equal to `Contributivity.exact_reconstructed` on the same scenario,
    through K1; a warm query makes no launch."""
    from mplc_tpu_torch.live import LiveGame
    sc = _live_titanic("cuda", 4)
    c = Contributivity(sc)
    c.exact_reconstructed()
    want = c._reconstructor().values
    game = LiveGame.from_recording(sc)
    before = trk.launches
    r = game.query("exact")
    assert trk.launches > before
    assert game._recon.values == want
    assert r.scores.tobytes() == c.contributivity_scores.tobytes()
    before = trk.launches
    assert game.query("exact") is r and trk.launches == before


def test_live_evict_restore_is_bit_equal_on_the_card(cuda, tmp_path):
    """A journaled Titanic game on the card, evicted and restored, then
    killed and reopened on its WAL: every exact and GTG answer bit-equal
    to the never-evicted game's."""
    from mplc_tpu_torch.live import LiveGame
    wal = tmp_path / "wal.jsonl"
    sc = _live_titanic("cuda")
    game = LiveGame.from_recording(sc, journal_path=wal)
    kw = dict(sv_accuracy=1.0, min_iter=8, perm_batch=4, truncation=0.0)
    want = game.query("exact").scores, game.query("GTG-Shapley", **kw).scores
    assert game.evict() and not game.resident
    got = game.query("exact").scores, game.query("GTG-Shapley", **kw).scores
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    game.close()
    again = LiveGame(_live_titanic("cuda"), journal_path=wal)
    assert again.query("exact").scores.tobytes() == want[0].tobytes()
    again.close()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_live_stream_flattened_on_the_card_equals_the_host_flattening(cuda, precision):
    """A live game's stream, its host rounds copied into K1's layout on
    the card (`flatten_rounds`, the bf16 cast there), equals the plain
    flattening on the host (numpy concatenation of the stacked rounds,
    cast last), bit for bit: 41 rounds of 10 partners (K = 410, no
    multiple of 32)."""
    rng = np.random.default_rng(7)
    P, R = 10, 41
    init = {"a": {"w": rng.normal(size=(5, 7)).astype(np.float32),
                  "b": rng.normal(size=(7,)).astype(np.float32)},
            "b": {"w": rng.normal(size=(7, 3)).astype(np.float32)}}
    rounds = [{g: {k: rng.normal(0, 1e-3, (P,) + a.shape).astype(np.float32)
                   for k, a in d.items()} for g, d in init.items()} for _ in range(R)]
    dtype = trk.stream_dtype(precision)
    got_init, got, _ = trk.flatten_rounds(init, rounds, P, dtype, cuda)
    leaves = [(g, k) for g, d in init.items() for k in d]
    pad = -sum(init[g][k].size for g, k in leaves) % 8
    want = np.concatenate([np.stack([r[g][k] for r in rounds]).reshape(R * P, -1)
                           for g, k in leaves] + [np.zeros((R * P, pad), np.float32)], axis=1)
    want_init = np.concatenate([init[g][k].ravel() for g, k in leaves] + [np.zeros(pad)])
    assert got.is_cuda and got.dtype == dtype
    assert torch.equal(got.cpu(), torch.from_numpy(want).to(dtype))
    assert torch.equal(got_init.cpu(), torch.from_numpy(want_init.astype(np.float32)))


def test_titanic_service_job_on_the_card_is_bit_equal_to_the_solo_engine(cuda, monkeypatch):
    """Two tenants through the sweep service on the card, quanta of 3
    coalitions and two workers sharing the card: each tenant's v(S)
    bit-equal to the port's solo engine on the card."""
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    from mplc_tpu_torch.service import SweepService
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", "2")
    subsets = powerset_order(4)
    solo = {seed: CharacteristicEngine(_live_titanic_seed("cuda", seed)).evaluate(subsets)
            for seed in (0, 1)}
    for workers in (None, 2):
        svc = SweepService(start=workers is not None, workers=workers, slice_coalitions=3)
        jobs = {seed: svc.submit(_live_titanic_seed("cuda", seed), tenant=f"t{seed}")
                for seed in (0, 1)}
        if workers is None:
            svc.run_until_idle()
        for job in jobs.values():
            job.result(timeout=600)
        svc.shutdown()
        for seed, job in jobs.items():
            got = np.array([job.values[s] for s in subsets])
            assert got.tobytes() == solo[seed].tobytes(), (workers, seed)
            assert job.device_seconds > 0


def test_routed_titanic_jobs_fail_over_on_the_card_bit_equal_to_solo(cuda, tmp_path,
                                                                     monkeypatch):
    """Two inline journaled shards on the card behind a FleetRouter: the
    shard holding both tenants' first quanta is killed after one pump, its
    jobs fail over to the survivor seeded from its WAL, and every table is
    bit-equal to the solo engine on the card."""
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    from mplc_tpu_torch.service import FleetRouter, SweepService
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", "2")
    subsets = powerset_order(4)
    solo = {seed: CharacteristicEngine(_live_titanic_seed("cuda", seed)).evaluate(subsets)
            for seed in (0, 1)}
    shards = {sid: SweepService(start=False, slice_coalitions=3,
                                journal_path=str(tmp_path / f"{sid}.wal"))
              for sid in ("s0", "s1")}
    router = FleetRouter(shards=shards, backoff_sec=0.0)
    router._pins.update({"t0": "s0", "t1": "s0"})
    jobs = {seed: router.submit(_live_titanic_seed("cuda", seed), tenant=f"t{seed}")
            for seed in (0, 1)}
    router.pump()
    router.kill_shard("s0")
    router.run_until_idle(timeout=600)
    assert router.stats["failovers"] == 1
    for seed, h in jobs.items():
        assert h.status == "completed" and h.failed_over and h.shard_id == "s1"
        got = np.array([h.values()[s] for s in subsets])
        assert got.tobytes() == solo[seed].tobytes(), seed
    assert jobs[0]._inner.recovered_values == 3
    router.close()
    for svc in shards.values():
        svc.shutdown(drain=False)


def test_live_query_job_launches_k1_and_equals_exact_reconstructed(cuda):
    """A live query job through the service on the card: K1 launches and
    the job's v(S) and scores are `exact_reconstructed`'s bit for bit."""
    from mplc_tpu_torch.service import SweepService
    sc = _live_titanic("cuda", 4)
    c = Contributivity(sc)
    c.exact_reconstructed()
    want = dict(c._reconstructor().values)
    svc = SweepService(start=False)
    game = svc.live_game(_live_titanic("cuda", 4), tenant="t")
    rec = record_updates(game.engine)
    for r in range(rec.rounds):
        svc.append_round("t", {g: {k: v[r] for k, v in d.items()} for g, d in rec.deltas.items()},
                         rec.weights[r])
    before = trk.launches
    job = svc.submit_live("t", method="exact")
    svc.run_until_idle()
    assert job.status == "completed" and trk.launches > before
    assert job.values == want
    assert np.asarray(job.result(1.0)).tobytes() == c.contributivity_scores.tobytes()
    svc.shutdown()


def _live_titanic_seed(device, seed, partners=4):
    sc = Scenario(partners, [(i + 1) / sum(range(1, partners + 1)) for i in range(partners)],
                  is_dry_run=True, dataset=load_titanic(), epoch_count=2, minibatch_count=2,
                  gradient_updates_per_pass_count=2, is_early_stopping=False, seed=seed,
                  device=device)
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def test_fleet_worker_processes_on_the_card_verify_against_one_shard(cuda, tmp_path):
    """The fleet sweep on the card: the Titanic spec's 7 coalitions run as
    one shard in process, then as two worker processes at once, each its
    own CUDA context; the merged ledger verifies against the 1-shard one
    (zero ulp, tau-b 1.0, 7 of 7) and the merged v(S) are bit-equal."""
    from mplc_tpu_torch.parallel import fleet
    spec = fleet.FleetSpec()
    ref = fleet.run_fleet(spec, 1, str(tmp_path / "w1"), inproc=True)
    got = fleet.run_fleet(spec, 2, str(tmp_path / "w2"), verify_against=ref.ledger,
                          timeout=600)
    assert got.diff["ulp"]["max"] == 0 and got.diff["kendall_tau"] == 1.0
    assert got.diff["common"] == len(spec.all_subsets()) == 7
    assert got.values == ref.values
    assert all(r["device"].startswith("cuda") for r in got.shard_reports)
    assert all((tmp_path / "w2" / f".shard{i}.done").exists() for i in range(2))


def test_nccl_world_of_one_2d_pipeline_equals_the_1d_route(cuda, monkeypatch):
    """A real NCCL world of one rank in this process: the 2-D pipeline at
    one partner shard (MPLC_TORCH_PARTNER_SHARDS=1, its aggregations NCCL
    all-gathers over the mesh row) gives the 1-D masked route's v(S) bit
    for bit on the card, under the deterministic reduce (Titanic, 4
    partners)."""
    import socket

    import torch.distributed as dist

    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    from mplc_tpu_torch.parallel import mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    monkeypatch.delenv(constants.PARTNER_SHARDS_ENV, raising=False)
    subsets = powerset_order(4)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        masked = CharacteristicEngine(_live_titanic_seed("cuda", 0)).evaluate(subsets)
        monkeypatch.setenv(constants.PARTNER_SHARDS_ENV, "1")
        before = mesh.collectives()["all_gather"]
        eng = CharacteristicEngine(_live_titanic_seed("cuda", 0))
        two_d = eng.evaluate(subsets)
        gathers = mesh.collectives()["all_gather"] - before
    finally:
        mesh.destroy_world()
    assert eng._pipe2d is not None and eng._ledger_meta()["topology"] == "2d"
    assert gathers > 0
    assert two_d.tobytes() == masked.tobytes()


def test_four_cards_run_the_several_card_selfcheck_on_titanic(cuda):
    """On a host with 4 cards, `launch --selfcheck` on Titanic: the [2 x 2]
    and [4 x 1] NCCL meshes bit-equal to one rank, the default reduce
    within `launch.DEFAULT_REDUCE_BOUND` (on the game's seed and two more),
    an OOM inside one rank's rounds ending every rank on the 2-D ladder,
    the service's 4 workers on 4 cards bit-equal to solo. NCCL refuses two
    ranks on one card, so one card skips."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (NCCL refuses two ranks on one card)")
    from mplc_tpu_torch.parallel import launch
    assert launch.selfcheck(4, "cuda", "titanic", 600) == 0


def test_four_cards_run_a_fleet_of_two_shards_of_two_cards(cuda, tmp_path):
    """On a host with 4 cards, the Titanic fleet spec as 2 shards of 2
    cards each (a NCCL world of 2 ranks a worker, cards 0-1 and 2-3)
    merges bit-equal to 1 shard of 1 card, its ledger naming 2 devices a
    shard; one card skips."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (NCCL refuses two ranks on one card)")
    from mplc_tpu_torch.parallel import fleet
    spec = fleet.FleetSpec()
    ref = fleet.run_fleet(spec, 1, str(tmp_path / "w1"), devices_per_shard=1, timeout=600)
    got = fleet.run_fleet(spec, 2, str(tmp_path / "w2x2"), devices_per_shard=2, timeout=600,
                          verify_against=ref.ledger)
    assert got.values == ref.values and got.diff["ulp"]["max"] == 0
    assert got.ledger["meta"]["n_devices"] == 2
    visible = fleet._visible_cards()
    assert [r["visible_devices"] for r in got.shard_reports] == [
        ",".join(visible[0:2]), ",".join(visible[2:4])]
