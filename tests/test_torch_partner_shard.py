"""The port's partner-sharded trainer (`mplc_tpu_torch/parallel/partner_shard.py`,
`TrainConfig.partner_axis`, the aggregations over a mesh row) on the CPU,
held to itself across rank counts and to the JAX package's
`PartnerShardedTrainer` (tests/test_partner_shard.py's oracles):

(a) the JAX test's 8-partner logistic problem (coalition mask
    [1,1,0,1,1,1,0,1], data-volume weights, 2 epochs of 2 minibatches of 2
    steps) at 1, 2 and 4 partner shards in a world of 4 gloo ranks, under
    the deterministic reduce: params, accuracy, val history and partner
    history bit-equal, on every rank, to the world of 1 (a mesh of one
    rank, no world), which is itself bit-equal to the plain unsharded
    trainer drawing its own streams;
(b) the same at 4 shards from the JAX package's initial params and
    permutations, against the JAX trainer on 4 of the conftest's CPU
    devices: params within 1e-5, the same accuracy;
(c) lflip (the JAX test's cluster MLP problem, in the port) at 2 and 4
    shards: params, accuracy, theta and theta_h bit-equal to the world of 1;
(d) the default reduce at 4 shards within 1e-5 of the world of 1 in every
    parameter and accuracy (the partners' sums associate otherwise); a
    model with dropout (its masks keyed by global partner id) bit-equal
    at 2 and 4 shards;
(e) the refusals: a non-partner-parallel approach, partner faults, slots
    and recording with a partner axis; an indivisible partner count; a
    trainer whose partner axis is not the mesh's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_helpers as h
from mplc_tpu.data.partition import StackedPartners as JStacked
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.models import TITANIC_LOGREG as JLOGREG
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer
from mplc_tpu.mpl.engine import TrainConfig as JConfig
from mplc_tpu.parallel.mesh import make_mesh as jmake_mesh
from mplc_tpu.parallel.partner_shard import PartnerShardedTrainer as JSharded
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.parallel import launch
from mplc_tpu_torch.parallel import mesh as tmesh
from mplc_tpu_torch.parallel.partner_shard import (PartnerShardedTrainer, stacked_specs,
                                                   train_state_specs)
from test_torch_sweep import _np, _stacked_np

torch.set_num_threads(1)


def _jax_sharded(n_devices: int):
    """The JAX test's run: its PartnerShardedTrainer on `n_devices` CPU
    devices under the deterministic reduce, with the initial params and
    permutations it trains from."""
    partners, val, test = h.logistic_arrays()
    jps = []
    for i, (x, y) in enumerate(partners):
        p = JPartner(i)
        p.x_train, p.y_train = x, y
        jps.append(p)
    stacked = JStacked.build(jps, 1)
    cfg = JConfig(approach="fedavg", aggregator="data-volume", epoch_count=2, minibatch_count=2,
                  gradient_updates_per_pass=2, is_early_stopping=False,
                  record_partner_val=False, partner_axis="part", deterministic_reduce=True)
    rng = jax.random.PRNGKey(0)
    tr = JTrainer(JLOGREG, cfg)
    sharded = JSharded(tr, jmake_mesh(jax.devices()[:n_devices], "part"))
    state = sharded.init_state(rng, 8)
    state = sharded.epoch_chunk(state, stacked, JEvalSet(*jstack_eval(*val, 1, 128)),
                                jnp.array(h.COAL_MASK, jnp.float32), rng, 2)
    _, acc = sharded.finalize(state, JEvalSet(*jstack_eval(*test, 1, 128)))
    perms = np.asarray(tr.gen_epoch_streams(rng, stacked.mask, 0, 2)[0])
    return {"params": _np(state.params), "acc": float(acc),
            "init": _stacked_np([_np(JLOGREG.init(rng))]), "perms": perms[None]}


@pytest.fixture(scope="module")
def jax_run():
    return _jax_sharded(4)


@pytest.fixture(scope="module")
def world(jax_run):
    """Every rank's runs in one world of 4 gloo ranks."""
    return launch.spawn("torch_dist_helpers:partner_shard_rank", 4,
                        (jax_run["init"], jax_run["perms"]), timeout=90)


def _one_rank():
    return tmesh.make_mesh([0], "part")


def _assert_same(a: dict, b: dict, keys=("val_loss_h", "partner_h")):
    for g in a["params"]:
        for k in a["params"][g]:
            np.testing.assert_array_equal(a["params"][g][k], b["params"][g][k])
    assert a["acc"] == b["acc"]
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k])


def test_world_of_one_is_the_plain_trainer():
    """The sharded trainer on a mesh of one rank (its streams drawn whole,
    its leaves folded in one buffer) trains the plain trainer's bits."""
    ref = h.run_sharded("logistic", _one_rank(), True)
    model, stacked, val, test, _ = h.problem("logistic")
    cfg = TrainConfig(approach="fedavg", aggregator="data-volume", epoch_count=2,
                      minibatch_count=2, gradient_updates_per_pass=2, is_early_stopping=False,
                      record_partner_val=False, deterministic_reduce=True)
    tr = MplTrainer(model, cfg)
    gens = [torch.Generator().manual_seed(0)]
    state = tr.init_state(gens, 8, "cpu")
    tr.epoch_chunk(state, stacked, val, torch.tensor([h.COAL_MASK], dtype=torch.float32),
                   gens, 2)
    plain = {"params": {g: {k: t[0].numpy() for k, t in d.items()}
                        for g, d in state.params.items()},
             "acc": float(tr.finalize(state, test)[1][0]),
             "val_loss_h": state.val_loss_h[0].numpy(), "partner_h": state.partner_h[0].numpy()}
    _assert_same(ref, plain)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partner_sharded_bit_equal_across_rank_counts(world, shards):
    ref = h.run_sharded("logistic", _one_rank(), True)
    assert 0.6 < ref["acc"] < 1.0
    for res in world:
        _assert_same(res[f"logistic_p{shards}"], ref)


def test_port_at_four_ranks_matches_jax_sharded_trainer(world, jax_run):
    for res in world:
        got = res["jax_p4"]
        for g, d in jax_run["params"].items():
            for k, v in d.items():
                np.testing.assert_allclose(got["params"][g][k], v, rtol=0, atol=1e-5)
        assert got["acc"] == jax_run["acc"]


@pytest.mark.parametrize("shards", [2, 4])
def test_lflip_sharded_bit_equal_with_theta(world, shards):
    ref = h.run_sharded("lflip", _one_rank(), True)
    assert np.isfinite(ref["theta_h"]).all()
    for res in world:
        _assert_same(res[f"lflip_p{shards}"], ref, keys=("val_loss_h", "partner_h",
                                                          "theta", "theta_h"))


@pytest.mark.parametrize("shards", [2, 4])
def test_dropout_masks_keyed_by_global_partner_bit_equal(world, shards):
    """A model with dropout: each partner's keep masks hash its global id,
    so a rank's block draws the masks the unsharded run draws for them."""
    ref = h.run_sharded("dropout", _one_rank(), True)
    for res in world:
        _assert_same(res[f"dropout_p{shards}"], ref)


def test_default_reduce_within_tolerance(world):
    ref = h.run_sharded("logistic", _one_rank(), False)
    for res in world:
        got = res["default_p4"]
        for g in ref["params"]:
            for k in ref["params"][g]:
                np.testing.assert_allclose(got["params"][g][k], ref["params"][g][k],
                                           rtol=0, atol=1e-5)
        assert abs(got["acc"] - ref["acc"]) <= 1e-5


def test_refusals():
    mesh = _one_rank()
    axis = mesh.axis("part")
    with pytest.raises(ValueError, match="partner-parallel"):
        TrainConfig(approach="seq-pure", partner_axis=axis)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TrainConfig(approach="fedavg", partner_axis=axis, partner_drop_epochs=(0, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TrainConfig(approach="fedavg", partner_axis=axis, slot_count=2)
    with pytest.raises(ValueError, match="update recording"):
        TrainConfig(approach="fedavg", partner_axis=axis, record_updates=True)
    with pytest.raises(ValueError, match="must be the mesh axis"):
        PartnerShardedTrainer(MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig()), mesh)
    with pytest.raises(ValueError, match="must be the mesh axis"):
        PartnerShardedTrainer(MplTrainer(tzoo.TITANIC_LOGREG,
                                         TrainConfig(partner_axis=tmesh.make_mesh(
                                             [0], "part").axis("part"))), mesh)
    # 6 partners over 4 shards, checked before any rank trains
    trainer = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(partner_axis=axis))
    sharded = PartnerShardedTrainer(trainer, mesh)
    sharded.n_shards = 4
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        sharded.init_state([torch.Generator().manual_seed(0)], 6, "cpu")
    # the JAX module's specs, as {field: partner dim}
    assert train_state_specs(lflip=False) == {"partner_h": 2}
    assert train_state_specs(lflip=True) == {"theta": 1, "theta_h": 2, "partner_h": 2}
    assert set(stacked_specs()) == {"x", "y", "mask", "sizes", "mask_host"}
