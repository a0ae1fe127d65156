"""Each frozen copy in `benchmark/reference/` held to the port at a tiny
size on the CPU: the synthetic data sets, the splits, the random protocol
(coalition streams, row orders, dropout masks), the models, a lone
partner's training, a FedAvg round, and the reconstruction. The tests
import the port; the reference does not."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, game, manifest
from benchmark.reference import dataset, model, split, streams
from benchmark.reference import train as ref

HERE = Path(__file__).resolve().parents[1]


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "mplc_tpu",
                                               "mplc_tpu_torch", "benchmark"), (path, n)


def test_synthetic_mnist_is_the_ports_at_its_seed():
    from mplc_tpu_torch.data.datasets import load_mnist
    port = load_mnist(scale=0.01, noise=0.75)
    mine = dataset("synthetic_mnist")(42, n_train=600, n_test=100, noise=0.75)
    x_tr, y_tr, _, _ = split.train_val_split(mine["x_train"], mine["y_train"])
    assert np.array_equal(x_tr, port.x_train) and np.array_equal(y_tr, port.y_train)
    assert np.array_equal(mine["x_test"], port.x_test)


def test_synthetic_cifar10_is_the_ports_at_its_seed():
    from mplc_tpu_torch.data.datasets import load_cifar10, with_held_out_test
    port = with_held_out_test(load_cifar10(scale=0.01, noise=0.1), 100)
    mine = dataset("synthetic_cifar10")(43, n_train=500, noise=0.1)
    x_tr, y_tr, x_va, y_va, x_te, y_te = split.held_out_test(mine["x_train"],
                                                             mine["y_train"], 100)
    for a, b in ((x_tr, port.x_train), (y_tr, port.y_train), (x_va, port.x_val),
                 (x_te, port.x_test), (y_te, port.y_test)):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def tiny():
    """A 4-partner tiny MNIST game: the program's engine and the
    reference's view of the same arrays."""
    man = manifest.Manifest.load()
    cfg = manifest.merged(man.config("mnist_cnn-p10"), {
        "data": {"n_train": 1200, "n_test": 100}, "partner_weights": [1, 2, 3, 4],
        "minibatch_count": 2, "gradient_updates_per_pass_count": 3})
    raw = game.make_inputs(cfg, 5)
    sc = game.program_scenario(cfg, raw, 5, "cpu", 1)
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    return cfg, CharacteristicEngine(sc), game.reference_game(cfg, raw, 5, "cpu")


def test_partner_split_and_test_rows_are_the_programs(tiny):
    _, eng, g = tiny
    for p, n in enumerate(g.partners.sizes):
        assert int(eng.stacked.sizes[p]) == n
        assert torch.equal(eng.stacked.x[p, :n], g.partners.x[p])
        assert torch.equal(eng.stacked.y[p, :n], g.partners.y[p])
    assert torch.equal(eng.test.x.reshape((-1,) + g.x_test.shape[1:])[:len(g.x_test)],
                       g.x_test)


def test_coalition_streams_row_orders_and_dropout_are_the_programs(tiny):
    _, eng, g = tiny
    from mplc_tpu_torch.mpl import dropout
    from mplc_tpu_torch.mpl.engine import MplTrainer
    for subset in ((0,), (1, 3), (0, 1, 2, 3)):
        a, b = eng.coalition_generator(subset), streams.coalition_generator(5, subset)
        assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    mask = g.partners.host_mask()
    a, b = streams.coalition_generator(5, (2,)), streams.coalition_generator(5, (2,))
    assert torch.equal(MplTrainer.epoch_perms(a, mask), streams.epoch_perms(b, mask))
    key = torch.tensor([[0x12345678, 0x9ABCDEF0]], dtype=torch.int64)
    layers = model("cifar10_cnn").dropout
    port = dropout.step_masks(key, 7, layers, 1, 3, torch.tensor([[2]]), 5)
    mine = streams.step_masks(key[0], 7, layers, 1, 3, 2, 5)
    for p, m in zip(port, mine):
        assert torch.equal(p[0, 0], m)


@pytest.mark.parametrize("name", ["mnist_cnn", "cifar10_cnn"])
def test_model_init_and_forward_are_the_programs(name):
    from mplc_tpu_torch.models.zoo import MODELS
    spec, port = model(name), MODELS[name]
    p = spec.init(torch.Generator().manual_seed(3))
    q = port.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(p[a][b], q[a][b]) for a in p for b in p[a])
    shape = (28, 28, 1) if name == "mnist_cnn" else (32, 32, 3)
    x = torch.rand((5,) + shape, generator=torch.Generator().manual_seed(4))
    masks = None
    if spec.dropout:
        masks = tuple(torch.rand((5,) + s, generator=torch.Generator().manual_seed(5)) < 0.7
                      for _, s in spec.dropout)
    torch.testing.assert_close(spec.forward(p, x, masks), port.apply(q, x, dropout=masks),
                               rtol=1e-5, atol=1e-5)


def _port_train(eng, subset):
    single = len(subset) == 1
    if single:
        pipe, coal = eng.single_pipe, eng._coalition_arrays([subset])
    else:
        w = eng._slot_width(len(subset))
        pipe, coal = eng._slot_pipe(w), eng._coalition_arrays([subset], w)
    tr, gen = pipe.trainer, [eng.coalition_generator(subset)]
    state = tr.init_state(gen, eng.partners_count, "cpu")
    c = torch.from_numpy(coal)
    tr.epoch_chunk(state, eng.stacked, eng.val, c, gen, 1, None, c)
    return {a: {b: t[0] for b, t in d.items()} for a, d in state.params.items()}


@pytest.mark.parametrize("subset", [(2,), (1, 3), (0, 1, 2, 3)])
def test_a_coalitions_first_step_and_training_are_the_programs(tiny, subset):
    """The probe's rows of the coalition are those whose initial weights
    are the reference's; each member's first-step gradient as the
    optimizer gets it within 1e-5 of the reference's, and the change over
    the first pass within 1e-3, by the check's worst-leaf measure; the
    parameters after two rounds of three steps within 2e-2. The last is
    looser: Adam's first steps divide by the gradient's own size, so an
    element whose gradient is within rounding of zero moves by up to the
    learning rate either way, a few 1e-3 of a small bias."""
    cfg, eng, g = tiny
    probe = eng.model.optimizer
    probe.steps.clear()
    probe.arm()
    port = _port_train(eng, subset)
    tr = g.training(cfg, 1)
    view = check.reference_view(g, subset, tr, "cpu")
    rows = [r for r in probe.rows()
            if check._fp_gap(r["fingerprint"], view["fingerprint"]) <= check.FP_MATCH]
    assert rows and all(r["change"] is not None for r in rows)
    for p, grads in view["first"].items():
        assert min(check.leaf_gap(r["grad"], grads) for r in rows) < 1e-5, p
    assert max(check.leaf_gap(r["change"], view["change"]) for r in rows) < 1e-3
    mine = ref.train_coalition(g.spec, 5, subset, g.partners, tr, "cpu")
    for a in mine:
        for b in mine[a]:
            rel = float((port[a][b] - mine[a][b]).norm() / mine[a][b].norm().clamp(min=1e-12))
            assert rel < 2e-2, (subset, a, b, rel)


def test_the_reconstruction_is_the_programs_plain_version(tiny):
    from mplc_tpu_torch.ops.recon_kernel import reconstruct_batch
    gen = torch.Generator().manual_seed(9)
    init = model("mnist_cnn").init(gen)
    R, P = 3, 4
    deltas = {a: {b: torch.randn((R, P) + t.shape, generator=gen) * 1e-2
                  for b, t in d.items()} for a, d in init.items()}
    weights = torch.rand((R, P), generator=gen)
    weights[1, 2] = 0.0
    masks = torch.tensor([[1.0, 0, 1, 0], [0, 0, 1, 0], [1, 1, 1, 1]])
    port = reconstruct_batch(masks, init, deltas, weights)
    flat_d = torch.cat([deltas[a][b].reshape(R, P, -1) for a in init for b in init[a]], -1)
    for i, m in enumerate(masks):
        mine = ref.unflat(ref.reconstruct(ref.flat(init), flat_d, weights, m), init)
        for a in init:
            for b in init[a]:
                torch.testing.assert_close(port[a][b][i], mine[a][b], rtol=1e-5, atol=1e-6)
