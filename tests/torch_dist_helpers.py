"""Rank-side code of the port's several-rank CPU tests
(tests/test_torch_mesh.py, test_torch_partner_shard.py,
test_torch_sharding.py, test_torch_fleet_world.py): the functions `mplc_tpu_torch.parallel.launch.spawn`
calls in each gloo rank, and the games they share with the tests' own
world of 1. No JAX here: every rank imports this module."""

import os

import numpy as np
import torch

from mplc_tpu_torch import constants, faults
from mplc_tpu_torch.data.datasets import Dataset, load_titanic
from mplc_tpu_torch.data.partition import StackedPartners
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.models import layers
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.models.core import Adam, Model
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import EpochStreams, MplTrainer, TrainConfig
from mplc_tpu_torch.parallel import mesh as par
from mplc_tpu_torch.parallel.partner_shard import PartnerShardedTrainer
from mplc_tpu_torch.scenario import Scenario

COAL_MASK = [1, 1, 0, 1, 1, 1, 0, 1]


# ---------------------------------------------------------------------------
# test_torch_mesh.py
# ---------------------------------------------------------------------------

def mesh_rank() -> dict:
    """A [2 x 2] mesh's lines and collectives, a mesh whose rows list their
    ranks in descending order, and three agreements."""
    me = par.world_rank()
    m = par.make_2d_mesh(2, 2)
    coal, part = m.axis("coal"), m.axis("part")
    flipped = par.Mesh(np.array([[1, 0], [3, 2]]), ("coal", "part")).axis("part")
    x = torch.tensor([float(me), 10.0 + me])
    out = {"coal": (coal.ranks, coal.index), "part": (part.ranks, part.index),
           "flipped": (flipped.ranks, flipped.index),
           "gather_part": part.all_gather(x[None], dim=0).tolist(),
           "gather_flipped": flipped.all_gather(x, dim=0).tolist(),
           "sum_coal": coal.all_reduce(x.clone()).tolist()}

    def fail_on(rank, err):
        def step():
            if me == rank:
                raise err
            return me
        try:
            par.agreed(step)
        except Exception as e:  # noqa: BLE001 - what each rank raised
            return type(e).__name__, faults.is_oom(e), faults.is_transient(e)
        return None
    out["oom"] = fail_on(1, faults.InjectedOom("CUDA out of memory: injected"))
    out["transient"] = fail_on(2, faults.InjectedTransient("UNAVAILABLE: injected"))
    out["other"] = fail_on(3, ValueError("a bug"))
    out["none"] = par.agreed(lambda: me)
    return out


def sleep_rank(seconds: float) -> None:
    """A rank that outlives its spawn's time limit."""
    import time
    time.sleep(seconds)


def fail_on_rank(failing: int, seconds: float) -> None:
    """Rank `failing` raises at once; every other rank sleeps `seconds`, as
    a peer waiting in a collective the failed rank never reaches would
    (test_torch_fleet_world.py)."""
    import time
    if par.world_rank() == failing:
        raise ValueError(f"rank {failing} fails")
    time.sleep(seconds)


# ---------------------------------------------------------------------------
# test_torch_partner_shard.py: the JAX test's problems
# ---------------------------------------------------------------------------

def logistic_arrays() -> tuple:
    """tests/test_partner_shard.py's 8-partner logistic problem: (partner
    (x, y) pairs, val (x, y), test (x, y)), numpy, in its draw order."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=27)

    def make(n):
        x = rng.normal(size=(n, 27)).astype(np.float32)
        return x, (x @ w > 0).astype(np.float32)
    partners = [make(n) for n in [60, 80, 100, 120, 60, 80, 100, 120]]
    return partners, make(100), make(100)


def cluster_mlp_model(num_classes=4, in_features=16, hidden=32, rate=0.0) -> Model:
    """tests/helpers.py's 2-layer categorical MLP, in the port; with
    `rate`, a dropout layer on its hidden units."""
    def init(g):
        return {"d1": layers.dense_init(g, in_features, hidden),
                "d2": layers.dense_init(g, hidden, num_classes)}

    def apply(params, x, compute_dtype=torch.float32, dropout=None):
        h = torch.relu(layers.dense(params["d1"], x.to(compute_dtype)))
        h = layers.dropout(h, None if dropout is None else dropout[0], rate)
        return layers.dense(params["d2"], h).float()
    return Model("cluster_mlp", init, apply, "categorical", num_classes, Adam(2e-2), 1,
                 dropout=((rate, (hidden,)),) if rate else ())


def make_cluster_data(rng, n, centers):
    num_classes, features = centers.shape
    y = rng.integers(0, num_classes, n)
    x = (centers[y] + rng.normal(size=(n, features))).astype(np.float32)
    return x, np.eye(num_classes, dtype=np.float32)[y]


def cluster_arrays() -> tuple:
    """tests/test_partner_shard.py's 8-partner lflip problem, numpy."""
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(4, 16)).astype(np.float32) * 2.0
    partners = [make_cluster_data(rng, n, centers) for n in [40, 60, 40, 60, 40, 60, 40, 60]]
    return partners, make_cluster_data(rng, 80, centers), make_cluster_data(rng, 80, centers)


def stage(arrays, label_dim: int) -> tuple:
    partners, val, test = arrays
    ps = []
    for i, (x, y) in enumerate(partners):
        p = Partner(i)
        p.x_train, p.y_train = x, y
        ps.append(p)
    return (StackedPartners.build(ps, label_dim, "cpu"),
            stage_eval_set(*val, label_dim, "cpu"), stage_eval_set(*test, label_dim, "cpu"))


def problem(kind: str):
    """(model, stacked, val, test, approach) of the 'logistic', 'lflip' or
    'dropout' (fedavg on the cluster problem, dropout in the MLP, its masks
    keyed by global partner id) problem."""
    if kind == "logistic":
        return (tzoo.TITANIC_LOGREG, *stage(logistic_arrays(), 1), "fedavg")
    if kind == "dropout":
        return (cluster_mlp_model(4, rate=0.5), *stage(cluster_arrays(), 4), "fedavg")
    return (cluster_mlp_model(4), *stage(cluster_arrays(), 4), "lflip")


def run_sharded(kind: str, mesh, deterministic: bool, init_params=None, streams=None,
                axis: str = "part") -> dict:
    """One 2-epoch run of the problem through `PartnerShardedTrainer` on
    `mesh`'s `axis` (a mesh of one rank without a world: the unsharded
    reference), from seed 0's generator or from injected params and
    streams ([1, E, P, Nmax] permutations). Its results as numpy."""
    model, stacked, val, test, approach = problem(kind)
    cfg = TrainConfig(approach=approach, aggregator="data-volume", epoch_count=2,
                      minibatch_count=2, gradient_updates_per_pass=2,
                      is_early_stopping=False, record_partner_val=False,
                      deterministic_reduce=deterministic, partner_axis=mesh.axis(axis))
    sharded = PartnerShardedTrainer(MplTrainer(model, cfg), mesh, axis)
    gens = None if init_params is not None else [torch.Generator().manual_seed(0)]
    if init_params is not None:
        init_params = {g: {k: torch.from_numpy(v) for k, v in d.items()}
                       for g, d in init_params.items()}
    state = sharded.init_state(gens, 8, "cpu", init_params)
    if streams is not None:
        streams = EpochStreams(torch.from_numpy(streams))
    state = sharded.epoch_chunk(state, stacked, val, torch.tensor([COAL_MASK], dtype=torch.float32),
                                gens, 2, streams)
    _, acc = sharded.finalize(state, test)
    out = {"params": {g: {k: t[0].numpy().copy() for k, t in d.items()}
                      for g, d in state.params.items()},
           "acc": float(acc[0]), "val_loss_h": state.val_loss_h[0].numpy().copy(),
           "partner_h": state.partner_h[0].numpy().copy()}
    if state.theta is not None:
        out["theta"] = state.theta[0].numpy().copy()
        out["theta_h"] = state.theta_h[0].numpy().copy()
    return out


def partner_shard_rank(jax_init: dict, jax_streams: np.ndarray) -> dict:
    """In a world of 4: the logistic problem at 1, 2 and 4 partner shards
    under the deterministic reduce and at 4 under the default one, lflip at
    2 and 4, and the logistic problem at 4 from the JAX package's initial
    params and streams."""
    meshes = {n: par.make_2d_mesh(4 // n, n) for n in (1, 2, 4)}
    out = {f"logistic_p{n}": run_sharded("logistic", meshes[n], True) for n in (1, 2, 4)}
    out["default_p4"] = run_sharded("logistic", meshes[4], False)
    for n in (2, 4):
        out[f"lflip_p{n}"] = run_sharded("lflip", meshes[n], True)
        out[f"dropout_p{n}"] = run_sharded("dropout", meshes[n], True)
    out["jax_p4"] = run_sharded("logistic", meshes[4], True, jax_init, jax_streams)
    return out


# ---------------------------------------------------------------------------
# test_torch_sharding.py: the engine over a world
# ---------------------------------------------------------------------------

AMOUNTS = [0.1, 0.2, 0.3, 0.4]


def titanic_scenario(prepare: bool = True, **kw) -> Scenario:
    """tests/test_sharding.py's 4-partner Titanic game (prepared: its
    partners made and the data split, as an engine needs it)."""
    game = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2,
                is_early_stopping=False, seed=9)
    game.update(kw)
    dataset = game.pop("dataset", None) or load_titanic()
    sc = Scenario(4, AMOUNTS, dataset=dataset, is_dry_run=True, device="cpu", **game)
    if prepare:
        sc.instantiate_scenario_partners()
        sc.split_data(is_logging_enabled=False)
    return sc


def cluster_dataset(n=700, seed=13, scale=2.5) -> Dataset:
    """tests/helpers.py's `cluster_mlp_dataset`, in the port."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 16)).astype(np.float32) * scale
    x, y = make_cluster_data(rng, n, centers)
    xt, yt = make_cluster_data(rng, n // 3, centers)
    return Dataset("clusters", (16,), 4, x, y, xt, yt, model=cluster_mlp_model(4),
                   provenance="test")


KNOBS = (constants.DETERMINISTIC_REDUCE_ENV, constants.PARTNER_SHARDS_ENV,
         constants.FAULT_PLAN_ENV, constants.MAX_CAP_HALVINGS_ENV,
         constants.RETRY_BACKOFF_ENV, constants.NO_SLOTS_ENV,
         constants.COALITIONS_PER_DEVICE_ENV)


def engine_values(knobs: dict, lflip: bool = False) -> dict:
    """A fresh engine's v(S) over the 4-partner powerset under `knobs`
    (the engine knobs not named are unset), with its layout and ledger
    meta."""
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    from mplc_tpu_torch.contrib.shapley import powerset_order
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(knobs)
    sc = (titanic_scenario(dataset=cluster_dataset(), multi_partner_learning_approach="lflip")
          if lflip else titanic_scenario())
    eng = CharacteristicEngine(sc)
    vals = eng.evaluate(powerset_order(4))
    pipe = eng._pipe2d
    return {"values": vals, "layout": ([pipe.coal_devices, pipe.part_shards] if pipe
                                       else [eng._sharding.num_devices if eng._sharding else 1,
                                             1]),
            "meta": eng._ledger_meta(), "kinds": [b["kind"] for b in eng.batch_log],
            "widths": [b["width"] for b in eng.batch_log],
            "slot_bucketing": sc.slot_bucketing, "partner_shards": sc.partner_shards}


def sharding_rank_4() -> dict:
    """In a world of 4: the [2 x 2] engine under the deterministic reduce
    (fedavg and lflip), and a Scenario asking for 2 partner shards run
    through `run()`."""
    out = {"det2d": engine_values({constants.DETERMINISTIC_REDUCE_ENV: "1",
                                   constants.PARTNER_SHARDS_ENV: "2"}),
           "lflip2d": engine_values({constants.DETERMINISTIC_REDUCE_ENV: "1",
                                     constants.PARTNER_SHARDS_ENV: "2"}, lflip=True)}
    for k in KNOBS:
        os.environ.pop(k, None)
    sc = titanic_scenario(prepare=False, partner_shards=2, methods=["Shapley values"])
    sc.run()
    df = sc.to_dataframe()
    out["scenario"] = {"partner_shards": sorted(set(df["partner_shards"])),
                       "scores": list(sc.contributivity_list[0].contributivity_scores),
                       "part_shards": sc._charac_engine._pipe2d.part_shards}
    return out


def _ladder_end(knobs: dict):
    """The (error, mode, halvings) an engine run under `knobs` ends with,
    or None when it ran through."""
    try:
        engine_values(knobs)
    except Exception as e:  # noqa: BLE001 - what each rank raised
        return type(e).__name__, getattr(e, "mode", None), getattr(e, "halvings", None)
    return None


def sharding_rank_2() -> dict:
    """In a world of 2: the 1-D coalition sharding of the default engine
    (slots), once more with a cap of 2 coalitions on rank 0 and 4 on rank
    1 (each rank's cap its own, as each card's free memory is); then the
    [1 x 2] engine with one cap halving allowed and an OOM on one rank,
    injected at rank 0's dispatch, or raised on rank 1 from inside a
    partner-sharded training's second round, either of which must end
    every rank with LadderExhaustedError(mode="2d")."""
    me = par.world_rank()
    out = {"coal1d": engine_values({}),
           "caps": engine_values({constants.COALITIONS_PER_DEVICE_ENV: "2" if me == 0
                                  else "4"})}
    two_d = {constants.DETERMINISTIC_REDUCE_ENV: "1", constants.PARTNER_SHARDS_ENV: "2",
             constants.MAX_CAP_HALVINGS_ENV: "1"}
    out["oom"] = _ladder_end({**two_d, **({constants.FAULT_PLAN_ENV: "oom@batch1,oom@batch2"}
                                          if me == 0 else {})})
    real = MplTrainer._steps
    rounds = [0]

    def steps(self, *a, **kw):
        # rank 1's partner-sharded rounds fail from the second on
        if self.cfg.partner_axis is not None and me == 1:
            rounds[0] += 1
            if rounds[0] > 1:
                raise faults.InjectedOom("CUDA out of memory: injected inside a round")
        return real(self, *a, **kw)
    MplTrainer._steps = steps
    try:
        out["oom_in_round"] = _ladder_end(two_d)
    finally:
        MplTrainer._steps = real
    out["rounds"] = rounds[0]
    return out


CLI_GRID = ("experiment_name: ranks\n"
            "n_repeats: 1\n"
            "scenario_params_list:\n"
            "  - dataset_name:\n"
            "      titanic: null\n"
            "    partners_count: [4]\n"
            "    amounts_per_partner: [[0.1, 0.2, 0.3, 0.4]]\n"
            "    samples_split_option: [['basic', 'random']]\n"
            "    multi_partner_learning_approach: ['fedavg']\n"
            "    aggregation_weighting: ['data-volume']\n"
            "    partner_shards: [2]\n"
            "    epoch_count: [2]\n"
            "    minibatch_count: [2]\n"
            "    gradient_updates_per_pass_count: [2]\n"
            "    is_early_stopping: [False]\n"
            "    methods: [['Shapley values']]\n")


def cli_rank(work: str) -> int:
    """The CLI (`mplc_tpu_torch.main`) on CLI_GRID in `work`, as a launched
    rank runs it: its exit code."""
    from mplc_tpu_torch.main import main
    for k in KNOBS:
        os.environ.pop(k, None)
    os.chdir(work)
    cfg = os.path.join(work, "grid.yml")
    if par.world_rank() == 0:
        with open(cfg, "w") as f:
            f.write(CLI_GRID)
    par.agreed(lambda: None)   # the file is written before any rank reads it
    return main(["-f", cfg, "--device", "cpu"])
