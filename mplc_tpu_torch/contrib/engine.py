"""The characteristic-function engine (port of `mplc_tpu/contrib/engine.py`:
staging, the coalition helpers, the retraining sweep on slots or masked,
the batch control and the fault ladder, and the checksummed coalition
cache).

It stages the scenario's data once on the scenario's device (stacked
partners, val and test sets), derives the coalition-training configs, and
gives each coalition its mask or slot ids and its own random stream.
`evaluate` is the batched, memoized v(S) = the test accuracy of a model
trained on S alone: single-partner coalitions train through the single
trainer, the others through the scenario's approach, up to the cap
(`_device_batch_cap`: on a card the smaller of
MAX_COALITIONS_PER_DEVICE_BATCH and what half its memory holds beside a
batch's fixed bytes, on the CPU that ceiling) coalitions a batch. FedAvg
and seq-family coalitions train on slots by default, grouped by slot width
(`_slot_buckets`), or masked over all P partners (MPLC_TORCH_NO_SLOTS=1,
lflip, and fedavg under MPLC_TORCH_DETERMINISTIC_REDUCE, as the JAX
package routes them). The memo is saved to a checksummed JSON cache
(`save_cache`, after every trained batch when `autosave_path` is set) and
restored from it (`load_cache`), keyed by everything v(S)
depends on. The retrain-free path (contrib/reconstruct.py) runs on the
same staged data.

The partner fault plan (faults.py) shapes the engine's trainers: its
dropout and straggler entries go into the TrainConfigs (fedavg only).
A partner dropped from epoch 1 never trains, so each coalition is keyed by
its effective membership (without such partners): its random stream, the
single trainer's mask and the route (a coalition left with one survivor
is a single training, one left with none is v = 0 untrained). A seed
ensemble (`seed_ensemble` K > 1) trains K replicas of every coalition as
extra rows of the same batches; replica 0 is the single-seed run and gives
v(S), every replica lands in `charac_fct_samples`.

Observability (the JAX engine's names, `obs/trace.py`): `evaluate` is an
`engine.evaluate` span holding, for each bucket, an `engine.prep` span and
for each batch an `engine.dispatch` span (the batch queued on its device;
only early stopping's flag, where it can fire, reads the device inside it)
and an `engine.harvest` span (the host read of the results, the batch's
one sync), then an `engine.batch` event with the batch's accounting, and
one `engine.hbm` event a call that did device work; the ladder adds
`engine.retry`, `engine.degrade` and `engine.fault` events. The memo,
coalition, epoch, sample, partner-pass and ladder counters go to
`obs/metrics.py`. None of it adds a sync.

Beside those names the port's own (`obs/trace.py` `PORT_SPANS`) cover a
batch's host time with leaf spans: the trainer's (`trainer.init`,
`trainer.draws`, `trainer.minibatch`, `trainer.finalize`) and
`engine.flops` inside the dispatch; `engine.record` from the harvest's
return to the `engine.batch` event (the fence, the program bank, the
stores, the ledger and the audit), again after it (the meter, the memory
sample, the autosave) and at an `evaluate` call's tail; `engine.progress`
around the caller's hook. A trained batch's event carries its host split:
`seconds` (its `dur`), `lead_s` (its start to the end of its first epoch's
draws, while the card has nothing of it queued), `record_s` (the
`engine.record` seconds inside its interval), and its trainer's gradient
calls (`grad_calls`, `grad_call_host_s`, `models_called`,
`models_padded`). `engine.stage` times the staging of an engine that
shares no data.

The fault ladder (faults.py; the JAX engine's, knobs `MPLC_TORCH_*`):
every batch runs under a batch-fault plan's injector; a transient failure
at dispatch or harvest retries it with bounded exponential backoff, an
OOM halves the cap and re-buckets what is left. Past the last halving a
CUDA engine stops with the classified, permanent `LadderExhaustedError`
(`_ladder_exhausted`, with a flight dump): the port never moves a card's
work to the CPU. Only an engine whose device is the CPU has a last CPU
rung (`_run_groups_cpu`), loudly. Recovery never changes v(S): every
retry draws each coalition's streams afresh. A dispatch reads nothing from
the device (early stopping that can fire aside), so the host has queued a
whole batch when its harvest starts; batches run one after another.

Width independence: on the card cuDNN picks a convolution's backward
algorithm by a gradient call's shape, so a coalition's bits would depend
on the width of the batch that trains it. The engine's trainers
(`TrainConfig.fixed_call_width`) split every step into gradient calls of
exactly `Model.grad_call_width` models, the last padded: every call of a
coalition has one shape, so it gets the same v(S) alone, in a request of
two or three, in a full sweep, in a resumed remainder or in a batch the
ladder re-ran at a halved width, on the CPU and on the card. It rests on
one property, that a model's gradient does not depend on its position in
a call or on the other models there (`obs/width_parity.py` checks it).
The grand-coalition fit and the recording train P models at a fixed width
and keep one call a step.

Device cost and numerics (obs/devcost.py, obs/numerics.py): every
`MPLC_TORCH_DEVICE_FENCE_RATE`-th batch is timed between CUDA events
(`engine.device_fence`), every batch carries its FLOPs (the trainer's
calls, counted once a shape by `FlopCounterMode` on meta tensors), and
`device_meter` sums them; `MPLC_TORCH_NUMERICS_LEDGER` records every
harvested v(S) with its float path and saves the ledger after each
`evaluate` that did device work; `MPLC_TORCH_NUMERICS_AUDIT=1` audits the
partner reduction of up to 4 fenced coalitions through separate capture
runs. None of it changes a v(S).

The program bank (contrib/bank.py, `program_bank`; None under
MPLC_TORCH_PROGRAM_BANK=0): every batch off the CPU rung acquires its
(slots, width) program, which records the program's key and the batch's
counted FLOPs and nothing else, so the bank never changes a v(S).

Fleet shards (parallel/fleet.py): `pin_fleet_widths` pins every bucket's
width to a full sweep's plan, so a shard that evaluates a slice runs the
full sweep's shapes.

Several ranks (parallel/mesh.py; a launcher's world, one process a card):
every rank builds the same engine and runs the same sweep. At a world
above 1 each batch's coalitions spread over the ranks (the JAX engine's
1-D coalition sharding, `_sharding`), each rank training an equal block of
rows, and the harvest gathers the blocks, so every rank's memo holds every
value. With `MPLC_TORCH_PARTNER_SHARDS` (or the Scenario's
`partner_shards`) above 1, fedavg and lflip multis train on the 2-D
[coal, part] mesh (`Batched2DTrainerPipeline`: each coalition's partners
split over a mesh row, each round's aggregation reduced over it) and
singletons on partner slices (`SlicedSinglesPipeline`); slots are off
there. Every batch's dispatch and harvest failure is agreed across the
world (`parallel.mesh.agreed`) before any rank goes on, and on the 2-D
pipeline over its mesh row at every round, so an OOM on one rank, at the
dispatch or inside a training, steps every rank's ladder and no rank
waits in a collective its peers left (a failure inside a collective
itself ends in the group's timeout); on the 2-D mesh and over several
ranks the ladder has no CPU rung. The ranks plan every bucket at the
least of their caps, each measured in its own card's memory.

One choice differs from the JAX engine: under the deterministic reduce
that engine routes fedavg and lflip through its 2-D pipeline at one
partner shard; the port keeps its 1-D masked route there (the route its
card gates hold bit-equal), and takes the 2-D pipeline at one shard only
when `MPLC_TORCH_PARTNER_SHARDS=1` asks for it. Both give the same bits
(tests/test_torch_sharding.py), so the choice changes no value. The 2-D
mode's singletons run through the one batch loop (`_run_batch` on
`SlicedSinglesPipeline`), whose OOM rung re-buckets in the loop, where
the JAX engine has a second loop that recovers by recursion.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import hashlib
import json
import logging
import os
import time
import traceback
import warnings

import numpy as np
import torch

from .. import constants, faults
from ..data.partition import StackedPartners
from ..mpl.approaches import stage_eval_set
from ..mpl.engine import SLOT_APPROACHES, CallTotals, MplTrainer, TrainConfig, upload
from ..mpl.engine import call_flops, host_coalitions
from ..parallel import mesh as par
from ..parallel.partner_shard import slice_stacked, slice_streams, whole_streams
from ..obs import devcost
from ..obs import metrics as obs_metrics
from ..obs import numerics as obs_numerics
from ..obs import trace as obs_trace
from .bank import ProgramBank, bank_enabled

logger = logging.getLogger("mplc_tpu_torch")

# one deprecation warning a process for legacy no-checksum caches
_legacy_cache_warned = False

# The random streams the port's coalitions draw (`coalition_generator`),
# named in the cache fingerprint: a cache of the JAX package, whose
# coalitions draw threefry streams, describes another game
RNG_STREAMS = "torch-seedsequence"
JAX_RNG_STREAMS = "jax-threefry"


class CacheIntegrityError(ValueError):
    """A coalition cache file is unreadable as a file: truncated, corrupt,
    failing its checksum or missing payload keys. Distinct from the
    fingerprint ValueError (a valid cache of another game): resume may
    quarantine such a file and start cold, never a mismatched one."""


def _bucket_size(n: int, n_dev: int, cap_per_dev: int) -> int:
    """Smallest power-of-two multiple of n_dev that fits n, capped."""
    cap = n_dev * cap_per_dev
    b = n_dev
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def _memo_counters(hits: int, misses: int) -> "str | None":
    """Global and per-estimator memo accounting, shared by the engine and
    the reconstruction evaluator so their counter keys cannot drift apart.
    The method is that of the enclosing `contributivity` span; returned
    (or None) for the caller's span attrs."""
    obs_metrics.counter("engine.memo_hits").inc(hits)
    obs_metrics.counter("engine.memo_misses").inc(misses)
    method_span = obs_trace.active_span("contributivity")
    method = (method_span.attrs.get("method")
              if method_span is not None else None)
    if method:
        obs_metrics.counter(f"engine.memo_hits[{method}]").inc(hits)
        obs_metrics.counter(f"engine.memo_misses[{method}]").inc(misses)
    return method


class BatchedTrainerPipeline:
    """init -> epoch chunk -> finalize over a batch of coalitions, one
    trainer (the JAX package's vmapped pipeline)."""

    # the mesh row whose collectives the training runs (the 2-D pipeline),
    # whose agreement points a failure inside it reports to; None: none
    row = None

    def __init__(self, trainer: MplTrainer, partners_count: int):
        self.trainer = trainer
        self.partners_count = partners_count

    def dispatch_async(self, coal: torch.Tensor, generators, stacked, val, test,
                       init_params: dict | None = None, streams_all=None,
                       coal_host=None, call_log: list | None = None):
        """Train the coalitions `coal` (masks [B, P], or slot ids [B, K] on
        a slot trainer; its CPU copy `coal_host`, or None), each from its
        generator's stream, or from injected initial params ([B, ...]
        leaves) and streams (`MplTrainer.epoch_chunk`'s `streams_all`), and
        return a zero-argument harvest thunk that reads their test
        accuracies [B] and epochs trained [B] to the host as numpy arrays.
        `call_log` (a list, or None) receives the batch's gradient and
        forward calls (`MplTrainer.call_log`). The thunk holds those two
        tensors only, so the batch's state goes back to the caching
        allocator when this returns. On a CUDA device,
        unless early stopping can fire (`TrainConfig.stops_early`, whose
        flag is read every epoch), the batch is still running when this
        returns, and the thunk's read is its one sync."""
        tr = self.trainer
        tr.call_log = call_log
        try:
            state = tr.init_state(generators, self.partners_count, coal.device,
                                  init_params)
            tr.epoch_chunk(state, stacked, val, coal, generators,
                           tr.cfg.epoch_count, streams_all, coal_host)
            _, accs = tr.finalize(state, test)
        finally:
            tr.call_log = None
        epochs = state.nb_epochs_done
        return lambda: (accs.cpu().numpy(), epochs.cpu().numpy())

    def scores(self, coal: torch.Tensor, generators, stacked, val, test,
               init_params: dict | None = None,
               streams_all=None) -> tuple[np.ndarray, np.ndarray]:
        """`dispatch_async`, its results read to the host."""
        return self.dispatch_async(coal, generators, stacked, val, test,
                                   init_params, streams_all)()


class Batched2DTrainerPipeline(BatchedTrainerPipeline):
    """Coalition-batched training on a 2-D [coal, part] mesh: each rank
    trains its block of a batch's coalitions (the engine hands it its rows)
    over its block of the partners, and each round's aggregation reduces
    over its mesh row (`TrainConfig.partner_axis`, ops/aggregation.py). A
    run's every draw comes from its generator in the unsharded trainer's
    order (its initial params, then every epoch's draws over all partners,
    `MplTrainer.draw_streams`) and is cut to the rank's partners, so the
    values are the 1-D masked route's, bit for bit under the deterministic
    reduce. Masked only: slots rebind partners to slots per coalition.
    `finalize` evaluates the aggregated params, the same on every rank of
    a row; the engine gathers the scores over the `coal` axis. Each round's
    aggregation is preceded by an agreement point over the row
    (`AxisGroup.agree`), so a rank that fails inside a training (an OOM in
    a forward pass) tells its row before any peer waits for it in a
    collective (`parallel.mesh.agreed`)."""

    def __init__(self, trainer: MplTrainer, partners_count: int, mesh):
        super().__init__(trainer, partners_count)
        self.mesh = mesh
        self.coal_devices = mesh.shape["coal"]
        self.part_shards = mesh.shape["part"]
        self.local_partners = partners_count // self.part_shards
        self.coal = mesh.axis("coal")
        self.row = trainer.cfg.partner_axis
        lo = trainer.cfg.partner_axis.index * self.local_partners
        self._block = (lo, lo + self.local_partners)

    def dispatch_async(self, coal, generators, stacked, val, test, init_params=None,
                       streams_all=None, coal_host=None, call_log=None):
        tr = self.trainer
        lo, hi = self._block
        tr.call_log = call_log
        try:
            # drawn whole, in the unsharded trainer's order: params, streams
            state = tr.init_state(generators, self.local_partners, coal.device, init_params)
            streams_all = whole_streams(tr, generators, stacked, coal.shape[0],
                                        tr.cfg.epoch_count, streams_all)
            tr.epoch_chunk(state, slice_stacked(stacked, lo, hi), val, coal[:, lo:hi], None,
                           tr.cfg.epoch_count, slice_streams(streams_all, lo, hi),
                           None if coal_host is None else torch.as_tensor(coal_host)[:, lo:hi])
            _, accs = tr.finalize(state, test)
        finally:
            tr.call_log = None
        epochs = state.nb_epochs_done
        return lambda: (accs.cpu().numpy(), epochs.cpu().numpy())


class SlicedSinglesPipeline(BatchedTrainerPipeline):
    """The 2-D mode's singletons: a one-partner coalition reads only its
    partner's rows, so each batch trains on a slice of just the partners
    its rows need, the mask the identity (row j owns slice row j), instead
    of every partner a rank. The single trainer's draws are a run's own and
    read its partner's validity row only, so the slice trains as the full
    data does. No collective runs inside."""

    def __init__(self, trainer: MplTrainer, mesh):
        super().__init__(trainer, 1)
        self.coal_devices = mesh.shape["coal"]
        self.coal = mesh.axis("coal")

    def dispatch_async(self, coal, generators, stacked, val, test, init_params=None,
                       streams_all=None, coal_host=None, call_log=None):
        ids = torch.argmax(host_coalitions(coal, coal_host), dim=1)
        sliced = StackedPartners(*(None if t is None else t[ids.to(t.device)]
                                   for t in stacked))
        B = coal.shape[0]
        return BatchedTrainerPipeline(self.trainer, B).dispatch_async(
            torch.eye(B, device=coal.device), generators, sliced, val, test, init_params,
            streams_all, torch.eye(B), call_log)


@functools.lru_cache(maxsize=None)
def model_param_bytes(model) -> int:
    """Bytes of one of `model`'s parameter sets, from one CPU init a model
    and process: every engine of a process shares it (a fresh engine a
    request would otherwise pay a CPU init of the model in its planning,
    with the card idle)."""
    params = model.init(torch.Generator().manual_seed(0))
    return sum(t.numel() * t.element_size() for d in params.values() for t in d.values())


def device_memory_bytes(device) -> int:
    """Bytes of device memory the engine may plan with: on a CUDA device
    what is free plus what this process's caching allocator already holds
    (`torch.cuda.mem_get_info`, `memory_reserved`), elsewhere 8 GiB (the
    JAX engine's fallback)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 8 << 30
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device))


def _release(err: BaseException) -> None:
    """Drop the locals of the frames a caught error's tracebacks hold (its
    own and those of the errors it chains): a failed batch's tensors, which
    would otherwise stay allocated while the ladder retries."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        traceback.clear_frames(err.__traceback__)
        err = err.__cause__ or err.__context__


class CharacteristicEngine:
    """Staged data, coalition helpers and the memoized retraining sweep
    shared by a scenario's estimators. `seed_ensemble` (None: the
    MPLC_TORCH_SEED_ENSEMBLE knob) is the number of replicas each
    coalition trains."""

    # the fault-free, single-seed game: what a subclass that values
    # coalitions without a scenario (a table of v(S)) describes
    _forever_dropped: frozenset = frozenset()
    seed_ensemble = 1
    # batches dispatched so far (the recording included), 1-based; such a
    # subclass dispatches none
    _batch_ordinal = 0
    _cap_halvings = 0
    _cpu_degraded = False
    # {(pipe, slot_count): width} of a fleet shard (`pin_fleet_widths`)
    _fleet_widths: dict | None = None
    # nor does it meter, fence, audit or ledger
    device_meter = None
    numerics_ledger = None
    _fence_interval = 0
    _numerics_audit = False
    _ledger_ctx: dict = {}
    # callable(done_in_group, remaining_in_call, slot_count), called after
    # every harvested batch (the sweep service's per-batch hook)
    progress = None
    # one rank, no mesh (`_setup_world`)
    _world = 1
    _pipe2d = None
    _singles2d = None
    _sharding = None
    _coal = None

    def __init__(self, scenario, share_data_from: "CharacteristicEngine | None" = None,
                 seed_ensemble: int | None = None):
        self.scenario = scenario
        self.partners_list = sorted(scenario.partners_list, key=lambda p: p.id)
        self.partners_count = len(self.partners_list)
        self.model = scenario.dataset.model
        self.seed = scenario.seed
        self.device = scenario.device

        # the plan Scenario.data_corruption parsed and applied, so the
        # fingerprint names the plan whose data faults ran; else the env's
        stashed = getattr(scenario, "_partner_fault_plan", None)
        self._partner_faults = (stashed if stashed is not None else
                                faults.clip_partner_plan(faults.partner_fault_plan_from_env(),
                                                         self.partners_count))
        self._forever_dropped = faults.forever_dropped(self._partner_faults)
        drop_epochs, straggler_delays = faults.trainer_fault_arrays(
            self._partner_faults, self.partners_count)
        if faults.data_fault_specs(self._partner_faults) and \
                not getattr(scenario, "_data_faults_applied", False):
            warnings.warn(
                f"{constants.PARTNER_FAULT_PLAN_ENV} carries noisy/glabel entries but "
                "Scenario.data_corruption() was never run: this engine computes the "
                "uncorrupted game", stacklevel=2)
        approach = scenario.multi_partner_learning_approach_key
        if (drop_epochs or straggler_delays) and approach != "fedavg":
            raise ValueError(
                f"{constants.PARTNER_FAULT_PLAN_ENV} dropout/straggler entries need "
                f"the fedavg approach (FedAvg's renormalized aggregation), got '{approach}'")

        if seed_ensemble is None:
            seed_ensemble = constants.seed_ensemble()
        if int(seed_ensemble) < 1:
            raise ValueError(f"seed_ensemble must be >= 1, got {seed_ensemble}")
        self.seed_ensemble = int(seed_ensemble)
        # {subset: [K] values of its replicas, NaN where not yet trained}
        # (empty unless seed_ensemble > 1)
        self.charac_fct_samples: dict[tuple, np.ndarray] = {}

        label_dim = self.model.label_dim()
        ds = scenario.dataset
        if share_data_from is not None:
            # another engine's staged tensors over the same scenario data:
            # no second device copy of the stacked train and eval sets
            self.stacked = share_data_from.stacked
            self.val = share_data_from.val
            self.test = share_data_from.test
        else:
            with obs_trace.span("engine.stage", partners=self.partners_count):
                self.stacked = StackedPartners.build(self.partners_list, label_dim,
                                                     self.device)
                self.val = stage_eval_set(ds.x_val, ds.y_val, label_dim, self.device)
                self.test = stage_eval_set(ds.x_test, ds.y_test, label_dim, self.device)

        self._multi_cfg = TrainConfig(
            approach=scenario.multi_partner_learning_approach_key,
            aggregator=scenario.aggregation_name,
            epoch_count=scenario.epoch_count,
            minibatch_count=scenario.minibatch_count,
            gradient_updates_per_pass=scenario.gradient_updates_per_pass_count,
            # the reference trains coalitions with early stopping on, but
            # with epoch_count <= patience the stop rule can never fire
            is_early_stopping=scenario.epoch_count > constants.PATIENCE,
            compute_dtype=scenario.compute_dtype,
            record_partner_val=False,
            record_val_history=False,
            partner_drop_epochs=drop_epochs,
            partner_straggler_delays=straggler_delays,
            fixed_call_width=True,
        )
        self.trainer = MplTrainer(self.model, self._multi_cfg)
        self.multi_pipe = BatchedTrainerPipeline(self.trainer, self.partners_count)
        self.single_pipe = BatchedTrainerPipeline(
            MplTrainer(self.model, dataclasses.replace(self._multi_cfg, approach="single")),
            self.partners_count)
        # Slot execution: a size-k fedavg or seq coalition trains k partner
        # slots instead of P masked partners (for the seq family, k visits
        # a minibatch instead of P), one lazily built pipeline a slot
        # width. Under the deterministic reduce fedavg sweeps without
        # trainer faults run masked, as in the JAX package (there they take
        # its partner-sharded pipeline, which has no seed ensembles); with
        # faults they stay on slots, as the seq family does; lflip always
        # runs masked.
        det_masked = (self._multi_cfg.deterministic_reduce and not self._multi_cfg.faulted
                      and approach in ("fedavg", "lflip"))
        if det_masked and self.seed_ensemble > 1:
            raise ValueError(
                "seed-ensemble sweeps (seed_ensemble > 1) are not supported for "
                "fedavg or lflip under MPLC_TORCH_DETERMINISTIC_REDUCE without a "
                "partner fault plan, as in the JAX package")
        self._use_slots = (approach in SLOT_APPROACHES and not det_masked
                           and os.environ.get(constants.NO_SLOTS_ENV) != "1")
        self._slot_pow2 = os.environ.get(constants.SLOT_POW2_ENV) == "1"
        self._slot_merge = (not self._slot_pow2 and os.environ.get(
            constants.SLOT_MERGE_ENV) not in ("0", "exact"))
        self._slot_pipes: dict[int, BatchedTrainerPipeline] = {}
        self._setup_world(scenario, det_masked)
        # the bucketing mode that runs, recorded on the scenario
        scenario.slot_bucketing = (
            "masked" if not self._use_slots
            else "pow2" if self._slot_pow2
            else "merge" if self._slot_merge else "exact")

        self.charac_fct_values: dict[tuple, float] = {(): 0.0}
        self.increments_values = [dict() for _ in range(self.partners_count)]
        self.first_charac_fct_calls_count = 0
        # one entry per trained batch: kind, width, slot_count (None for
        # masked and single batches), coalitions (the batch's real rows:
        # coalition replicas under a seed ensemble), seconds
        self.batch_log: list[dict] = []
        # throughput accounting over non-padding rows: epochs trained, and
        # the training samples a partner consumes an epoch, size // MB *
        # MB on the multi and slot trainers (the minibatch window), the
        # whole size on the single trainer (the JAX engine's accounting)
        self.epochs_trained = 0
        self.samples_trained = 0
        sizes = np.array([len(p.x_train) for p in self.partners_list], np.int64)
        mbc = self._multi_cfg.minibatch_count
        self._epoch_samples_multi = sizes // mbc * mbc
        self._epoch_samples_single = sizes
        self._param_bytes: int | None = None
        # the cache is saved here after every trained batch (Scenario.run),
        # so a crash loses at most the batch it interrupts
        self.autosave_path = None
        # Optional callable(done_in_group, remaining_in_call, slot_count),
        # called after every harvested batch, training and reconstruction
        # alike (the JAX engine's hook): the sweep service journals, meters
        # and checks deadlines there. Each batch is harvested before the
        # next is dispatched, so when the hook raises no batch is in
        # flight: the memo, `batch_log` and the meter hold every batch
        # harvested so far and nothing else
        self.progress = None

        # The fault ladder (faults.py), its knobs read here, once an engine.
        # Recovery never changes v(S): a retried or re-bucketed batch (or,
        # on a CPU engine, a CPU-rung batch) trains each coalition from the
        # same stream (equality-tested in tests/test_torch_ladder.py)
        self._max_retries = constants._env_positive_int(constants.MAX_RETRIES_ENV, 3)
        self._retry_backoff = constants._env_nonneg_float(constants.RETRY_BACKOFF_ENV, 0.5)
        self._max_cap_halvings = constants._env_positive_int(
            constants.MAX_CAP_HALVINGS_ENV, 3)
        # rungs taken down the OOM ladder: every later cap is halved that
        # many times, so the remaining subsets re-bucket through the
        # ordinary width rule
        self._cap_halvings = 0
        self._cpu_degraded = False   # the CPU rung taken (a CPU engine only)
        self._hbm_bytes: int | None = None   # device memory, queried lazily
        self._faults = faults.FaultInjector.from_env()
        # a legacy (no-checksum) cache loaded from this path is rewritten
        # with a checksum by the next save to it
        self._cache_needs_upgrade = False
        self._legacy_cache_path: str | None = None
        self._digest: str | None = None

        # Device cost (obs/devcost.py, MPLC_TORCH_DEVICE_FENCE_RATE): every
        # `_fence_interval`-th batch ordinal is timed between CUDA events
        # (`_fence_start`, `_maybe_fence`), each batch carries its counted
        # FLOPs, and the meter sums them. Deterministic in the ordinal, so
        # a replayed run fences the same batches; a fence never changes
        # v(S) (equality-tested in tests/test_torch_devcost.py)
        self._fence_interval = devcost.fence_interval()
        self.device_meter = devcost.DeviceMeter(self._fence_interval)
        # The numerics plane (obs/numerics.py): the value ledger
        # (MPLC_TORCH_NUMERICS_LEDGER names its file) and the fence-sampled
        # reduction audit (MPLC_TORCH_NUMERICS_AUDIT=1, a separate capture
        # run a coalition, so v(S) is bit-equal with it on or off)
        self._numerics_audit = obs_numerics.audit_enabled()
        self._audited_subsets: set = set()
        self.numerics_audits: list = []
        self._ledger_ctx = {}
        path = obs_numerics.ledger_path_from_env()
        self.numerics_ledger = (obs_numerics.ValueLedger(
            self._fingerprint_digest(), meta=self._ledger_meta(), path=path)
            if path else None)
        # The program bank (contrib/bank.py): the key and counted FLOPs of
        # every (slots, width) program a batch runs, bookkeeping only (the
        # JAX engine's exemption of the deterministic reduce guards XLA
        # compiles, which the port has none of)
        self.program_bank = ProgramBank(self) if bank_enabled() else None

    def _setup_world(self, scenario, det_masked: bool) -> None:
        """The engine's layout over the launcher's world (parallel/mesh.py):
        the 2-D [coal, part] pipeline when `MPLC_TORCH_PARTNER_SHARDS` or
        the Scenario's `partner_shards` asks for partner shards above 1
        (or the knob asks for 1 under the deterministic reduce), with the
        JAX engine's checks and messages; else, at a world above 1, the 1-D
        coalition sharding over the world. The shard count that runs is
        written back to the scenario (results.csv records it)."""
        approach = self._multi_cfg.approach
        self._world = par.world_size()
        part, from_env = constants.partner_shards(getattr(scenario, "partner_shards", 1) or 1)
        scenario.partner_shards = part
        self._pipe2d = None
        self._singles2d = None
        if part > 1 or (from_env and det_masked):
            if self.seed_ensemble > 1:
                raise ValueError(
                    "seed-ensemble sweeps (seed_ensemble > 1) are not supported in the 2-D "
                    "partner-sharded mode")
            if approach not in ("fedavg", "lflip"):
                raise ValueError(f"{constants.PARTNER_SHARDS_ENV} requires a partner-parallel "
                                 f"approach (fedavg/lflip), got {approach!r}")
            if self.partners_count % part or self._world % part:
                raise ValueError(
                    f"{constants.PARTNER_SHARDS_ENV}={part} must divide both the partner "
                    f"count ({self.partners_count}) and the device count ({self._world})")
            mesh = par.make_2d_mesh(self._world // part, part)
            cfg2d = dataclasses.replace(self._multi_cfg, partner_axis=mesh.axis("part"))
            self._pipe2d = Batched2DTrainerPipeline(MplTrainer(self.model, cfg2d),
                                                    self.partners_count, mesh)
            self._singles2d = SlicedSinglesPipeline(self.single_pipe.trainer, mesh)
            self._use_slots = False
            self._sharding = None
        else:
            self._sharding = par.coalition_sharding()
        self._coal = (self._sharding.mesh.axis("coal") if self._sharding is not None
                      else None)

    def _coal_axis(self, pipe):
        """The `coal` line a pipe's batches spread over (None: one rank)."""
        return getattr(pipe, "coal", None) or self._coal

    def _fingerprint_digest(self) -> str:
        """The ledger's engine fingerprint: sha256 of the cache fingerprint
        (`_fingerprint`, JSON with sorted keys), 16 hex digits, as the JAX
        engine digests its own."""
        return hashlib.sha256(json.dumps(self._fingerprint(), sort_keys=True)
                              .encode()).hexdigest()[:16]

    def _ledger_meta(self) -> dict:
        """The float path every ledger entry shares (the JAX engine's keys):
        the topology that ran ("2d" on the partner-sharded pipeline), its
        partner shard count and the ranks the engine spreads over."""
        two_d = self._pipe2d is not None
        return {"topology": "2d" if two_d else "1d",
                "part_shards": self._pipe2d.part_shards if two_d else 1,
                "n_devices": self._world,
                "reduction_mode": ("deterministic" if self._multi_cfg.deterministic_reduce
                                   else "default"),
                "precision": self._multi_cfg.precision,
                "slot_bucketing": self.scenario.slot_bucketing}

    # ------------------------------------------------------------------
    # coalition helpers
    # ------------------------------------------------------------------

    def coalition_generator(self, subset: tuple, replica: int = 0) -> torch.Generator:
        """The coalition's own CPU random stream, independent of batch
        composition: seeded from SeedSequence([seed, *words]), the words
        being the membership bitmask's 32-bit words; seed-ensemble replica
        j >= 1 from SeedSequence([seed, *words, 0x5EED0000 + j]). The JAX
        package's threefry streams are not reproduced."""
        bits = 0
        for i in subset:
            bits |= 1 << int(i)
        words = []
        while True:
            words.append(bits & 0xFFFFFFFF)
            bits >>= 32
            if not bits:
                break
        if replica:
            words.append(0x5EED0000 + int(replica))
        ss = np.random.SeedSequence([int(self.seed), *words])
        return torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0]))

    def _coalition_arrays(self, subsets: list[tuple],
                          slot_count: int | None = None) -> np.ndarray:
        """Every subset's [N, slot_count] int32 slot ids, -1 marking an
        unused slot, or [N, P] float32 membership masks (one scatter)."""
        n = len(subsets)
        lens = np.fromiter((len(s) for s in subsets), np.intp, n)
        total = int(lens.sum())
        rows = np.repeat(np.arange(n), lens)
        members = np.fromiter((int(i) for s in subsets for i in sorted(s)),
                              np.int64, total)
        if slot_count is not None:
            coal = np.full((n, slot_count), -1, np.int32)
            cols = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            coal[rows, cols] = members
        else:
            coal = np.zeros((n, self.partners_count), np.float32)
            coal[rows, members] = 1.0
        return coal

    def _effective_subset(self, subset: tuple) -> tuple:
        """The coalition's membership minus forever-dropped partners."""
        return tuple(i for i in subset if i not in self._forever_dropped)

    def _batch_start(self, subsets: list[tuple], single: bool, replicas=None):
        """(generators, initial params, streams) of a batch's rows, each the
        stream of its (effective) subset and seed-ensemble replica (all 0
        when `replicas` is None), from which the trainer draws all of
        them (None, None). The parity tests substitute the JAX package's
        initial params and streams here."""
        replicas = replicas or [0] * len(subsets)
        return ([self.coalition_generator(s, r) for s, r in zip(subsets, replicas)],
                None, None)

    # ------------------------------------------------------------------
    # the memoized sweep
    # ------------------------------------------------------------------

    def _incomplete(self, subset: tuple) -> bool:
        """True when the subset still needs device work: no value yet, or
        (seed ensemble) a replica not yet trained."""
        if subset not in self.charac_fct_values:
            return True
        if self.seed_ensemble == 1:
            return False
        arr = self.charac_fct_samples.get(subset)
        return arr is None or bool(np.isnan(arr).any())

    def _store_sample(self, subset: tuple, replica: int, value: float) -> None:
        arr = self.charac_fct_samples.get(subset)
        if arr is None:
            arr = self.charac_fct_samples[subset] = np.full(self.seed_ensemble, np.nan)
        arr[replica] = value

    def _store(self, subset: tuple, value: float) -> None:
        self.charac_fct_values[subset] = value
        self.first_charac_fct_calls_count += 1
        if self.numerics_ledger is not None:
            # the harvested bits and the float path that made them: the
            # batch's slot width and CPU rung (`_ledger_ctx`, set by
            # `_record_group` for its stores; a store outside a batch, a
            # null coalition, has none) and the cap halvings taken
            ctx = self._ledger_ctx
            self.numerics_ledger.record(
                subset, value, source="exact", slot_width=ctx.get("slot_count"),
                cap_halvings=self._cap_halvings, degraded=bool(ctx.get("degraded")))
        # marginal-increment bookkeeping (reference contributivity.py:116-134)
        sset = set(subset)
        for i in range(self.partners_count):
            if i in sset:
                without = tuple(sorted(sset - {i}))
                if without in self.charac_fct_values:
                    self.increments_values[i][without] = \
                        value - self.charac_fct_values[without]
            else:
                with_i = tuple(sorted(sset | {i}))
                if with_i in self.charac_fct_values:
                    self.increments_values[i][subset] = \
                        self.charac_fct_values[with_i] - value

    def _slot_pipe(self, k: int) -> BatchedTrainerPipeline:
        if k not in self._slot_pipes:
            cfg = dataclasses.replace(self._multi_cfg, slot_count=k)
            self._slot_pipes[k] = BatchedTrainerPipeline(
                MplTrainer(self.model, cfg), self.partners_count)
        return self._slot_pipes[k]

    def _slot_width(self, k: int) -> int:
        """The slot width a size-k coalition trains at: k (`exact`), k
        rounded up to odd (`merge`: even k rides size k + 1's width) or to
        a power of two (`pow2`), capped at the partner count."""
        if self._slot_pow2:
            return min(1 << (k - 1).bit_length(), self.partners_count)
        if self._slot_merge:
            return min(k + (k % 2 == 0), self.partners_count)
        return k

    def _slot_buckets(self, multis: list[tuple]) -> list[tuple[int, list[tuple]]]:
        """The coalitions grouped by slot width, widths ascending. A
        coalition narrower than its width leaves slots unused (-1), which
        train nothing and weigh nothing, so every mode gives the same
        values."""
        by_width: dict[int, list[tuple]] = {}
        for s in multis:
            by_width.setdefault(self._slot_width(len(s)), []).append(s)
        return [(w, by_width[w]) for w in sorted(by_width)]

    # ------------------------------------------------------------------
    # batch control: the device-memory cap and the bucket width
    # ------------------------------------------------------------------

    def _device_batch_cap(self, slot_count: int | None = None) -> int:
        """Coalitions a batch, per device (the port runs on one).

        The cap is the smaller of the ceiling (MAX_COALITIONS_PER_DEVICE_BATCH,
        16; MPLC_TORCH_BATCH_CAP_CEILING lifts it) and the coalitions that
        fit in half the device's memory beside a batch's fixed bytes
        (`_autotuned_cap`). MPLC_TORCH_COALITIONS_PER_DEVICE overrides the
        autotune (a malformed value warns and falls back to it). Every OOM
        rung (`_degrade_cap`) halves the result, the override included: the
        ladder exists because a measured cap stopped holding."""
        env_cap = constants._env_positive_int(constants.COALITIONS_PER_DEVICE_ENV, 0)
        if env_cap:
            return max(1, env_cap >> self._cap_halvings)
        return self._autotuned_cap(slot_count)

    def _model_param_bytes(self) -> int:
        """Bytes of one model's parameters (`model_param_bytes`)."""
        if self._param_bytes is None:
            self._param_bytes = model_param_bytes(self.model)
        return self._param_bytes

    def _per_coalition_bytes(self, k: int) -> int:
        """The modeled device bytes one coalition adds to a batch training
        at k partner slots (k = P masked), from what this trainer holds at
        the peak of a partner pass (`MplTrainer._fedavg_epoch`, `_steps`):
        the global params and the aggregate being built (2 parameter
        copies), and per slot its params, its gradients, the step's new
        params, its update temporary and twice the optimizer's moments (old
        and new coexist inside a step), so (4 + 2m) copies a slot for m
        moments (Adam 2, RMSprop 1)."""
        moments = sum(1 for v in self.model.optimizer.init({}).values()
                      if isinstance(v, dict))
        return self._model_param_bytes() * (2 + k * (4 + 2 * moments))

    def _batch_fixed_bytes(self, k: int) -> int:
        """The modeled device bytes a batch holds whatever its width, from
        the model's largest float32 activation a row (`eval_row_bytes`; the
        input row where the model does not say): an evaluation call holds
        at most `constants.eval_rows_in_flight` models x rows, and a
        layer's input, its output and a convolution's workspace coexist
        (EVAL_ACTIVATIONS_PER_ROW such activations a row); a gradient call
        is counted at the ceiling's coalitions' k models on a step's rows
        (the calls themselves hold `Model.grad_call_width` models each,
        one after another), each row keeping
        its layers' activations for the backward pass and one layer's
        gradients in and out (TRAIN_ACTIVATIONS_PER_ROW). The two calls
        do not overlap; the larger counts."""
        cfg = self._multi_cfg
        row = self.model.eval_row_bytes or self.stacked.x[0, 0].numel() * 4
        evaluation = (constants.EVAL_ACTIVATIONS_PER_ROW * constants.eval_rows_in_flight(row)
                      * row)
        window = max(self.stacked.x.shape[1] // cfg.minibatch_count, 1)
        step_rows = -(-window // cfg.gradient_updates_per_pass) * cfg.step_width_mult
        ceiling = constants._env_positive_int(constants.BATCH_CAP_CEILING_ENV,
                                              constants.MAX_COALITIONS_PER_DEVICE_BATCH)
        grads = constants.TRAIN_ACTIVATIONS_PER_ROW * ceiling * k * step_rows * row
        return max(evaluation, grads)

    def _device_hbm_bytes(self) -> int:
        """The device's memory (`device_memory_bytes`), queried once an
        engine and again after every degrade (`_degrade_cap` drops it): after
        an OOM the autotune reasons from the memory left, not the
        snapshot taken before the fault."""
        if self._hbm_bytes is None:
            self._hbm_bytes = device_memory_bytes(self.device)
        return self._hbm_bytes

    def _autotuned_cap(self, slot_count: int | None) -> int:
        """min(ceiling, the coalitions whose bytes (`_per_coalition_bytes`)
        fit in half the card's memory beside the batch's fixed bytes
        (`_batch_fixed_bytes`)), halved once a rung; the other half holds
        the staged data and the allocator's slack. At least 1. The
        autotune plans a CUDA card's memory; on another device (the CPU,
        whose memory is the host's) the cap is the ceiling, halved once a
        rung."""
        ceiling = constants._env_positive_int(constants.BATCH_CAP_CEILING_ENV,
                                              constants.MAX_COALITIONS_PER_DEVICE_BATCH)
        if torch.device(self.device).type != "cuda":
            return max(1, ceiling >> self._cap_halvings)
        k = slot_count if slot_count is not None else self.partners_count
        room = 0.5 * self._device_hbm_bytes() - self._batch_fixed_bytes(k)
        fit = max(1, int(room // self._per_coalition_bytes(k)))
        return max(1, min(ceiling, fit) >> self._cap_halvings)

    def _hbm_attrs(self, slot_count: int | None = None) -> dict:
        """The `engine.hbm` event's payload, the JAX engine's keys and the
        port's `fixed_bytes` (`_batch_fixed_bytes`): the modeled footprint
        a coalition, the caps and the device's memory and measured peak.
        The port donates no buffers: there is no executable boundary to
        donate across, and the trainer replaces its state's tensors as it
        goes, each old one returned to the caching allocator at once. So
        `donation` is False, the donated saving 0, and the caps before and
        after donation are the one autotuned cap."""
        k = slot_count if slot_count is not None else self.partners_count
        cap = self._autotuned_cap(slot_count)
        return {
            "param_bytes": self._model_param_bytes(),
            "slot_count": k,
            "donation": False,
            "per_coalition_bytes": self._per_coalition_bytes(k),
            "fixed_bytes": self._batch_fixed_bytes(k),
            "donated_bytes_per_coalition": 0,
            "cap_before_donation": cap,
            "cap_after_donation": cap,
            "cap_effective": self._device_batch_cap(slot_count),
            "hbm_bytes_limit": self._device_hbm_bytes(),
            "peak_in_use_bytes": obs_metrics.gauge("engine.device_mem_high_water_bytes").value,
        }

    def _planned_width(self, n_jobs: int, slot_count: int | None, pipe) -> int:
        """The bucket width of a call of `n_jobs` jobs on `pipe`: one width
        for the whole call (the tail pads up to it), recomputed only when
        the OOM ladder moves. The dispatch loop, `sweep_plan` and the
        packer all read it, so planned and executed widths never part.

        Over several ranks the width is a power-of-two multiple of the
        ranks the batch spreads over (the world in 1-D, the mesh's coal axis
        in 2-D, where the cap counts a rank's partners), each rank training
        an equal block of rows, and the cap is the least of the ranks' caps
        (`parallel.mesh.agreed_min`: each rank's autotune reads its own
        card's free memory), so every rank buckets at one width. That is
        a collective: over several ranks every rank calls this together,
        as `evaluate` and `sweep_plan` do.

        A fleet shard (parallel/fleet.py, `pin_fleet_widths`) runs each
        (pipe, slot_count) bucket at the full sweep's planned width even
        when its slice is smaller, so every shard runs the full sweep's
        programs and evaluates at the full sweep's shapes. The pin never
        shrinks a width, and the OOM ladder ignores it: a degraded cap
        re-buckets at the degraded width, not the plan's."""
        if pipe is not None and getattr(pipe, "coal_devices", None):
            # the 2-D mesh: the coalitions spread over its coal axis, each
            # rank holding a batch's models for its block of the partners
            # (the singles: one partner a coalition)
            local = getattr(pipe, "local_partners", 1)
            cap = par.agreed_min(self._device_batch_cap(local))
            return _bucket_size(min(n_jobs, pipe.coal_devices * cap), pipe.coal_devices, cap)
        n_dev = self._sharding.num_devices if self._sharding is not None else 1
        cap = par.agreed_min(self._device_batch_cap(slot_count))
        width = _bucket_size(min(n_jobs, n_dev * cap), n_dev, cap)
        if self._fleet_widths and not self._cap_halvings:
            pinned = self._fleet_widths.get((pipe, slot_count))
            if pinned:
                return max(width, pinned)
        return width

    # ------------------------------------------------------------------
    # the fault ladder
    # ------------------------------------------------------------------

    def _retry_transient(self, op, site: str, ordinal: int | None = None):
        """`op()`, retried with bounded exponential backoff on transient
        failures (`faults.is_transient`), up to MPLC_TORCH_MAX_RETRIES
        retries. A re-dispatched batch draws every coalition's stream
        afresh, so a retry never changes v(S). OOM and other errors
        propagate. `ordinal` rides the `engine.retry` event."""
        attempt = 0
        while True:
            try:
                return op()
            except Exception as e:
                if not faults.is_transient(e) or attempt >= self._max_retries:
                    raise
                attempt += 1
                self._backoff(site, attempt, e, ordinal)

    def _fetch_with_retry(self, fetch, meta):
        """Harvest with transient recovery: a failed fetch re-dispatches
        the same batch (`meta["redispatch"]`, the same streams) and fetches
        again, up to the retry budget. The fault plan's harvest boundary
        sits here. The re-dispatch runs inside the try: a re-dispatch that
        fails transiently consumes a retry instead of escaping. Over
        several ranks the harvest's failure is agreed (`parallel.mesh.agreed`)
        and each rank's block of results is gathered over the batch's coal
        axis (`meta["coal"]`)."""
        attempt = 0
        while True:
            try:
                if fetch is None:
                    fetch = meta["redispatch"]()

                def harvest(fetch=fetch):
                    self._faults.check("harvest", meta.get("ordinal", 0))
                    return fetch()
                coal = meta.get("coal")
                if coal is None:
                    return harvest()
                # every rank's block, in row order: every memo holds the batch
                return tuple(coal.all_gather(torch.from_numpy(a), tag="scores").numpy()
                             for a in par.agreed(harvest))
            except Exception as e:
                if (not faults.is_transient(e) or meta.get("redispatch") is None
                        or attempt >= self._max_retries):
                    raise
                attempt += 1
                self._backoff("harvest", attempt, e, meta.get("ordinal"))
                fetch = None

    def _backoff(self, site: str, attempt: int, err: BaseException,
                 ordinal: int | None = None) -> None:
        delay = min(self._retry_backoff * (2 ** (attempt - 1)),
                    constants.RETRY_BACKOFF_CAP_SEC)
        obs_metrics.counter("engine.retries").inc()
        obs_metrics.counter("engine.backoff_sec").inc(delay)
        obs_trace.event("engine.retry", site=site, attempt=attempt, ordinal=ordinal,
                        backoff_sec=delay, error=str(err)[:200])
        logger.warning("transient %s failure (attempt %d/%d, backing off %.2f s): %s",
                       site, attempt, self._max_retries, delay, err)
        if delay:
            time.sleep(delay)

    def _degrade_cap(self, err: BaseException) -> None:
        """One rung down the OOM ladder: halve the cap (every later
        `_device_batch_cap` sees it). Past MPLC_TORCH_MAX_CAP_HALVINGS
        rungs the ladder ends: a CUDA engine raises `_ladder_exhausted`'s
        error (the port moves no work off the card), and so does an engine
        on the 2-D mesh (mode "2d") or spread over several ranks, which
        have no CPU rung; a CPU engine of one rank routes everything still
        missing through its CPU rung. Values already
        harvested stay in the memo. The caller has released the failed
        batch's tensors (`_release`); what a reference cycle still holds is
        collected, the caching allocator releases its free blocks
        (`torch.cuda.empty_cache`), and the device's memory is queried
        afresh by the next cap."""
        self._cap_halvings += 1
        self._hbm_bytes = None
        on_cpu = torch.device(self.device).type == "cpu"
        if not on_cpu:
            gc.collect()   # tensors a reference cycle still holds
            torch.cuda.empty_cache()
        obs_metrics.counter("engine.cap_halvings").inc()
        if self._cap_halvings <= self._max_cap_halvings:
            obs_trace.event("engine.degrade", action="halve_cap",
                            halvings=self._cap_halvings, error=str(err)[:200])
            logger.warning("device OOM: halving the coalition cap (halving %d of %d) and "
                           "re-bucketing the remaining subsets (%s)",
                           self._cap_halvings, self._max_cap_halvings, err)
        elif self._pipe2d is not None:
            # the partner-sharded programs need the mesh: no CPU rung
            raise self._ladder_exhausted(err, "2d") from err
        elif not on_cpu or self._world > 1:
            raise self._ladder_exhausted(err, "1d") from err
        else:
            self._cpu_degraded = True
            obs_trace.event("engine.degrade", action="cpu_fallback",
                            halvings=self._cap_halvings, error=str(err)[:200])
            logger.warning("OOM after %d cap halvings: the remaining coalition batches "
                           "run on the CPU rung (%s)", self._max_cap_halvings, err)

    def _ladder_exhausted(self, err: BaseException,
                          mode: str = "2d") -> faults.LadderExhaustedError:
        """The classified terminal error of a sweep whose cap halvings ran
        out where no CPU rung exists (`_degrade_cap`): mode "1d" on the
        card or over several ranks, "2d" on the partner-sharded pipeline
        and its singles path. Counts `engine.ladder_exhausted`, emits an
        `engine.degrade` event (action `ladder_exhausted`), writes a
        flight-recorder dump and returns the error, permanent for the
        classifier. Raise it `from err`."""
        obs_metrics.counter("engine.ladder_exhausted").inc()
        obs_trace.event("engine.degrade", action="ladder_exhausted",
                        halvings=self._cap_halvings, error=str(err)[:200])
        from ..obs import flight as obs_flight
        postmortem = obs_flight.dump("ladder_exhausted", extra={
            "halvings": self._cap_halvings, "error": str(err)[:500]})
        return faults.LadderExhaustedError(
            f"device OOM persisted through {self._max_cap_halvings} cap halvings and "
            + ("the 2-D partner-sharded mode has no CPU rung (its programs need the mesh)"
               if mode == "2d" else "the card's work never moves to the CPU")
            + ": the sweep cannot make progress at any cap. Remedies: lower "
            + constants.COALITIONS_PER_DEVICE_ENV
            + (f" or {constants.PARTNER_SHARDS_ENV}" if mode == "2d" else "")
            + f" or MPLC_TORCH_EVAL_CHUNK. Last device error: {str(err)[:200]}"
            + (f" Postmortem flight record: {postmortem}" if postmortem else ""),
            halvings=self._cap_halvings, mode=mode, postmortem_path=postmortem)

    # ------------------------------------------------------------------
    # the batch loop
    # ------------------------------------------------------------------

    def _record_or_recover(self, prev, per_partner, slot_count, pipe) -> None:
        """`_record_group` with the harvest-side OOM rung: when reading a
        batch's results exhausts memory, its coalitions run again through
        `_run_batch` at the degraded cap (or, on a CPU engine, the CPU
        rung). Transient fetch failures were retried inside
        `_record_group`; anything else propagates."""
        try:
            self._record_group(*prev, per_partner, slot_count)
        except Exception as e:
            if not faults.is_oom(e):
                raise
            _release(e)
            self._degrade_cap(e)
            subs = (list(dict.fromkeys(s for s, _ in prev[0])) if prev[2]["ensemble"]
                    else prev[0])
            redo = [s for s in subs if self._incomplete(s)]
            if redo:
                self._run_batch(redo, pipe, slot_count)

    def _run_batch(self, subsets: list[tuple], pipe: BatchedTrainerPipeline,
                   slot_count: int | None = None) -> None:
        """Train and value `subsets` on `pipe` (a slot pipeline when
        `slot_count` is given), in batches of one width for the call
        (`_planned_width`), each harvested before the next is dispatched.
        A batch's rows are jobs: job j is replica j % K of subset j // K
        (K = `seed_ensemble`), so the replicas fill the rows a single-seed
        sweep pads. The tail is padded with copies of its batch's first
        job, whose results are dropped. Each job draws the stream of its
        effective subset; the single trainer also takes its effective mask
        (its lone survivor), the others the full membership, whose dropped
        partners they mask in-trainer.

        The ladder (the JAX engine's loop; ReconstructionEvaluator._run_batch
        keeps the same skeleton, so a change lands in both): a transient
        failure at dispatch or harvest retries the batch; an OOM at dispatch
        steps the cap down and retries the same group at the degraded
        width; an OOM at harvest re-runs the batch's coalitions
        (`_record_or_recover`); past the last rung a CUDA engine raises
        `LadderExhaustedError` and a CPU engine runs the rest on its CPU
        rung (`_run_groups_cpu`)."""
        K = self.seed_ensemble
        single = pipe in (self.single_pipe, self._singles2d)
        per_partner = self._epoch_samples_single if single else self._epoch_samples_multi
        # partner passes a coalition-minibatch runs on this pipe, padded
        # slots included (what the device ran)
        passes_per_mb = 1 if single else slot_count or self.partners_count
        n_jobs = len(subsets) * K
        b = self._planned_width(n_jobs, slot_count, pipe)
        halvings_seen = self._cap_halvings
        with obs_trace.span("engine.prep", coalitions=n_jobs, width=b,
                            slot_count=slot_count):
            eff = [self._effective_subset(s) for s in subsets]
            coal_all = self._coalition_arrays(eff if single else subsets, slot_count)
            jobs = [(s, r) for s in subsets for r in range(K)] if K > 1 else subsets
        ctx = {"eff": eff, "coal_all": coal_all, "jobs": jobs, "single": single,
               "per_partner": per_partner, "passes_per_mb": passes_per_mb}
        i = 0
        while i < n_jobs:
            if self._cpu_degraded:
                self._run_groups_cpu(pipe, slot_count, i, ctx)
                return
            if self._cap_halvings != halvings_seen:
                # the ladder moved (here or in a harvest's recovery): the
                # remaining jobs re-bucket at the degraded cap
                halvings_seen = self._cap_halvings
                b = self._planned_width(n_jobs, slot_count, pipe)
            group, meta, dispatch = self._batch_job(pipe, slot_count, i, b, ctx)
            try:
                fetch = self._retry_transient(dispatch, "dispatch", meta["ordinal"])
            except Exception as e:
                if not faults.is_oom(e):
                    raise
                # an OOM at dispatch: free the failed batch's tensors, step
                # down and retry this group (i unchanged) at the degraded width
                _release(e)
                self._degrade_cap(e)
                continue
            i += len(group)
            meta["remaining"] = n_jobs - i
            self._record_or_recover((group, fetch, meta), per_partner, slot_count, pipe)

    def _batch_job(self, pipe, slot_count, i: int, b: int, ctx: dict,
                   degraded: str | None = None):
        """(group, meta, dispatch) of the batch of width `b` starting at job
        `i`, its ordinal taken. `dispatch` is a closure that draws every
        input afresh on each call (the coalitions' generators are stateful,
        so a retry that reused them would train other streams) and returns
        the batch's harvest thunk. A fence ordinal's dispatch is fenced
        (`_fence_start`); the dispatch logs the trainer's calls, whose
        FLOPs ride `meta["flops"]` (not on the CPU rung). Over several
        ranks the dispatch trains this rank's block of the rows (its
        FLOPs and fence are this rank's) and its failure is agreed."""
        K = self.seed_ensemble
        jobs = ctx["jobs"]
        group = jobs[i:i + b]
        sel = np.full(b, i, np.intp)
        sel[:len(group)] = np.arange(i, i + len(group))
        self._batch_ordinal += 1
        attrs = {"width": b, "slot_count": slot_count, "coalitions": len(group),
                 "padding": b - len(group)}
        if degraded:
            attrs["degraded"] = degraded
        meta = {**attrs, "t0": time.perf_counter(), "ordinal": self._batch_ordinal,
                "kind": "single" if ctx["single"] else "multi", "ensemble": K > 1,
                "passes_per_mb": ctx["passes_per_mb"],
                "mb_count": pipe.trainer.cfg.minibatch_count, "pipe": pipe}
        # the CPU rung's batches are neither fenced nor counted: they run
        # at another rate than the device's
        fence = not degraded and devcost.should_fence(self._batch_ordinal,
                                                      self._fence_interval)

        # over several ranks each trains its block of the rows, and the
        # harvest gathers the blocks over this coal line
        coal = None if degraded else self._coal_axis(pipe)
        meta["coal"] = coal
        rows = sel if coal is None else np.split(sel, coal.size)[coal.index]

        def train():
            keys = [ctx["eff"][j] for j in rows // K]
            generators, init_params, streams = self._batch_start(
                keys, ctx["single"], [int(j) for j in rows % K])
            coal_host = torch.from_numpy(ctx["coal_all"][rows // K])
            calls = None if degraded else []
            meta["totals"] = pipe.trainer.totals = CallTotals()
            if fence:
                self._fence_start(meta)
            fetch = pipe.dispatch_async(upload(coal_host, self.device), generators,
                                        self.stacked, self.val, self.test, init_params,
                                        streams, coal_host, calls)
            if fence:
                self._fence_stop(meta)
            if calls:
                with obs_trace.span("engine.flops"):
                    meta["flops"] = call_flops(self.model, calls, self.stacked.x)
            return fetch

        def dispatch(ordinal=self._batch_ordinal):
            with obs_trace.span("engine.dispatch", **attrs):
                def checked_train():
                    self._faults.check("dispatch", ordinal)
                    return train()
                if coal is None:
                    return checked_train()
                # over several ranks the dispatch's failure is agreed before
                # any rank goes on; on the 2-D pipeline over its row first,
                # at the agreement point where the row's peers wait
                return par.agreed(checked_train, pipe.row)

        meta["redispatch"] = dispatch
        return group, meta, dispatch

    def _run_groups_cpu(self, pipe, slot_count, start: int, ctx: dict) -> None:
        """The last rung of a CPU engine's OOM ladder (a CUDA engine has
        none: `_degrade_cap`): the jobs from `start` on, a batch at a time
        at the last halved cap, instead of abandoning the run. Everything
        harvested before is kept, and each coalition trains from its own
        streams, so the values are the clean run's. Loud: an
        `engine.degrade` event and a warning were emitted by
        `_degrade_cap`, each batch carries `degraded="cpu"` and counts
        `engine.cpu_degraded_batches` and `_coalitions`; an OOM here
        propagates."""
        n_jobs = len(ctx["jobs"])
        cap = self._device_batch_cap(slot_count)
        b = _bucket_size(min(n_jobs - start, cap), 1, cap)
        i = start
        while i < n_jobs:
            group, meta, dispatch = self._batch_job(pipe, slot_count, i, b, ctx,
                                                    degraded="cpu")
            i += len(group)
            meta["remaining"] = n_jobs - i
            fetch = self._retry_transient(dispatch, "dispatch", meta["ordinal"])
            self._record_group(group, fetch, meta, ctx["per_partner"], slot_count)

    # ------------------------------------------------------------------
    # device fences (obs/devcost.py)
    # ------------------------------------------------------------------

    def _fence_start(self, meta: dict) -> None:
        """A fenced batch's start: a CUDA event recorded on the current
        stream before its first work (on the CPU, which runs the work as it
        is dispatched, the host clock)."""
        if torch.device(self.device).type == "cuda":
            meta["fence"] = [torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True)]
            meta["fence"][0].record()
        else:
            meta["fence"] = [time.perf_counter(), None]

    def _fence_stop(self, meta: dict) -> None:
        """A fenced batch's end: a CUDA event recorded after its last
        queued work (the CPU: the host clock after the dispatch ran it)."""
        if isinstance(meta["fence"][1], torch.cuda.Event):
            meta["fence"][1].record()
        else:
            meta["fence"][1] = time.perf_counter()

    def _maybe_fence(self, meta: dict) -> None:
        """After a fenced batch's harvest (which synchronized the stream),
        its device seconds from the two events into `meta["device_sec"]`,
        the `engine.device_step_sec` histogram and an `engine.device_fence`
        event: a point at the harvest (`dur` 0: device seconds are no host
        interval) carrying them as `device_sec`. An unfenced batch is left
        alone."""
        ev = meta.get("fence")
        if ev is None:
            return
        if isinstance(ev[0], torch.cuda.Event):
            dur = ev[0].elapsed_time(ev[1]) / 1e3
        else:
            dur = ev[1] - ev[0]
        meta["device_sec"] = dur
        obs_metrics.histogram("engine.device_step_sec").observe(dur)
        obs_trace.event("engine.device_fence", device_sec=dur, ordinal=meta.get("ordinal"),
                        width=meta["width"], slot_count=meta.get("slot_count"),
                        coalitions=meta["coalitions"], interval=self._fence_interval)

    def _record_group(self, group, fetch, meta, per_partner, slot_count) -> None:
        """A batch's harvest and bookkeeping: fetch its results (with the
        retry ladder), take its fence, store its values (each into the
        value ledger, when it is on), account its epochs, samples and
        partner passes, emit its `engine.batch` event, note it on the
        device meter, audit a fenced batch's first coalition
        (MPLC_TORCH_NUMERICS_AUDIT), autosave, call `progress`."""
        n = meta["coalitions"]
        with obs_trace.span("engine.harvest", width=meta["width"], slot_count=slot_count,
                            coalitions=n):
            accs, epochs = self._fetch_with_retry(fetch, meta)
        with obs_trace.span("engine.record", phase="batch", ordinal=meta["ordinal"]) as record:
            batch_samples = self._record_values(group, accs, epochs, meta, per_partner,
                                                slot_count)
        batch_epochs = int(epochs[:n].sum())
        batch_passes = batch_epochs * meta["mb_count"] * meta["passes_per_mb"]
        seconds = time.perf_counter() - meta["t0"]
        attrs = {k: meta[k] for k in ("width", "slot_count", "coalitions", "padding")}
        entry = {"kind": meta["kind"], **attrs, "seconds": seconds}
        extra = {}
        if meta.get("degraded"):
            entry["degraded"] = extra["degraded"] = meta["degraded"]
            obs_metrics.counter("engine.cpu_degraded_batches").inc()
            obs_metrics.counter("engine.cpu_degraded_coalitions").inc(n)
        if meta.get("device_sec") is not None:
            # a fenced batch: its device seconds feed the report's
            # device_time and roofline rows
            extra["device_sec"] = meta["device_sec"]
            extra["fenced"] = True
        if meta.get("flops"):
            extra["flops"] = meta["flops"]
        totals = meta.get("totals")
        if totals is not None:
            # the batch's host split (module docstring)
            extra.update(seconds=seconds, record_s=record.duration,
                         grad_calls=totals.grad_calls,
                         grad_call_host_s=totals.grad_call_host_s,
                         models_called=totals.models_called,
                         models_padded=totals.models_padded)
            if totals.first_draws_end is not None:
                extra["lead_s"] = totals.first_draws_end - meta["t0"]
        self.batch_log.append(entry)
        self._account_batch(seconds, attrs, batch_epochs, batch_samples, batch_passes,
                            ordinal=meta["ordinal"], **extra)
        with obs_trace.span("engine.record", phase="after", ordinal=meta["ordinal"]):
            self.device_meter.note(n, span_sec=seconds, device_sec=meta.get("device_sec"),
                                   flops=meta.get("flops"),
                                   degraded=bool(meta.get("degraded")))
            obs_metrics.histogram("engine.pad_waste_fraction").observe(
                meta["padding"] / meta["width"])
            obs_metrics.sample_device_memory(device=self.device)
            if self.autosave_path is not None:
                self.save_cache(self.autosave_path)
        if self.progress is not None:
            with obs_trace.span("engine.progress", ordinal=meta["ordinal"]):
                self.progress(len(group), meta.get("remaining", 0), slot_count)

    def _record_values(self, group, accs, epochs, meta, per_partner, slot_count) -> int:
        """A harvested batch's bookkeeping before its event: its fence, its
        program, its values stored (each into the value ledger, when it is
        on) and a fenced batch's audit. Returns its training samples."""
        n = meta["coalitions"]
        self._maybe_fence(meta)
        if self.program_bank is not None and not meta.get("degraded") \
                and self._pipe2d is None:
            self.program_bank.acquire(meta["pipe"], slot_count, meta["width"],
                                      flops=meta.get("flops"))
        # the float path of this batch's ledger entries (cleared after, so
        # a store outside a batch inherits none)
        self._ledger_ctx = {"slot_count": slot_count, "degraded": meta.get("degraded")}
        batch_samples = 0
        for item, acc, ep in zip(group, accs[:n], epochs[:n]):
            if meta["ensemble"]:
                s, rep = item
                self._store_sample(s, rep, float(acc))
            else:
                s, rep = item, 0
            # replica 0 is v(S); a subset re-trained for a missing replica
            # (or re-run by the harvest-side OOM rung) keeps the value and
            # the call count it has
            if rep == 0 and s not in self.charac_fct_values:
                self._store(s, float(acc))
            batch_samples += int(ep) * int(per_partner[list(self._effective_subset(s))].sum())
        self._ledger_ctx = {}
        if (self._numerics_audit and meta.get("device_sec") is not None
                and not meta["ensemble"] and group and len(self.numerics_audits) < 4):
            # the fenced batch's first coalition, through a separate
            # capture run (never this batch), its reduction replayed at the
            # batch's shape, at most 4 an engine: each audit costs one
            # training
            s0 = group[0]
            if s0 not in self._audited_subsets:
                self._audited_subsets.add(s0)
                res = obs_numerics.audit_coalition(self, s0, meta["width"],
                                                   meta["slot_count"])
                if res is not None:
                    self.numerics_audits.append(res)
        return batch_samples

    def _account_batch(self, dur: float, attrs: dict, epochs: int, samples: int,
                       passes: int, ordinal: int | None = None, **extra) -> None:
        """A training batch's counters and its `engine.batch` event (`dur`:
        the batch's start to the end of its bookkeeping); the recording's
        too. `ordinal` is the batch's (None: the last dispatched)."""
        self.epochs_trained += epochs
        self.samples_trained += samples
        obs_metrics.counter("engine.batches").inc()
        obs_trace.event("engine.batch", dur=dur,
                        ordinal=self._batch_ordinal if ordinal is None else ordinal,
                        **attrs, epochs=epochs, samples=samples,
                        partner_passes=passes, **extra)
        obs_metrics.counter("engine.epochs_trained").inc(epochs)
        obs_metrics.counter("engine.samples_trained").inc(samples)
        obs_metrics.counter("engine.partner_passes").inc(passes)

    def evaluate(self, subsets) -> np.ndarray:
        """Batched memoized v(S) for a list of subsets (any iterables of
        partner indices). Returns values in input order."""
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        unique = dict.fromkeys(keys)
        missing = [k for k in unique if self._incomplete(k)]
        n_requested_missing = len(missing)
        if self._forever_dropped:
            # every member dropped from epoch 1: no model is ever trained,
            # v = v(empty) = 0, which makes a dropped partner a null player
            for k in [k for k in missing if not self._effective_subset(k)]:
                if k not in self.charac_fct_values:
                    self._store(k, 0.0)
                if self.seed_ensemble > 1:
                    self.charac_fct_samples[k] = np.zeros(self.seed_ensemble)
            missing = [k for k in missing if self._effective_subset(k)]
            # neither memo hits nor misses: nothing was cached, nothing trains
            obs_metrics.counter("engine.null_coalitions").inc(
                n_requested_missing - len(missing))
        method = _memo_counters(len(unique) - n_requested_missing, len(missing))
        obs_metrics.counter("engine.coalitions_evaluated").inc(len(missing))
        ordinal = self._batch_ordinal
        with obs_trace.span("engine.evaluate", requested=len(unique),
                            missing=len(missing), method=method):
            # routed by effective size (a coalition left with one survivor
            # is a single training), bucketed by the full membership
            lens = {k: len(self._effective_subset(k)) for k in missing}
            singles = [k for k in missing if lens[k] == 1]
            multis = [k for k in missing if lens[k] > 1]
            if singles:
                self._run_batch(singles, self._singles2d or self.single_pipe)
            if multis and self._pipe2d is not None:
                self._run_batch(multis, self._pipe2d)
            elif multis and self._use_slots:
                for width, group in self._slot_buckets(multis):
                    self._run_batch(group, self._slot_pipe(width), slot_count=width)
            elif multis:
                self._run_batch(multis, self.multi_pipe)
            if self._batch_ordinal != ordinal:
                with obs_trace.span("engine.record", phase="evaluate"):
                    # one device-memory snapshot a call that did device
                    # work, after its batches, so the high water includes
                    # them
                    obs_metrics.sample_device_memory(device=self.device)
                    obs_trace.event("engine.hbm", **self._hbm_attrs(
                        max((self._slot_width(lens[k]) for k in multis), default=None)
                        if multis and self._use_slots else None))
                    if self.numerics_ledger is not None:
                        # the ledger saved once a call that did device work
                        self.numerics_ledger.save()
        if self._cache_needs_upgrade and self.autosave_path is not None:
            # a legacy cache is rewritten with a checksum even when every
            # value was memoized and no batch's autosave ran
            self.save_cache(self._legacy_cache_path)
        return np.array([self.charac_fct_values[k] for k in keys])

    def not_twice_characteristic(self, subset) -> float:
        """Reference-API single-subset entry (contributivity.py:92-136)."""
        return float(self.evaluate([np.atleast_1d(np.asarray(subset, int))])[0])

    def _bucket_plan(self, singles: list, multis: list) -> list:
        """[(pipe, slot_count, width)] in dispatch order of an `evaluate`
        call whose missing coalitions are `singles` and `multis` (routed by
        effective size): the singles' batch, then each slot bucket (widths
        ascending) or the masked batch, each at its `_planned_width`. Empty
        once the CPU rung is taken, whose batches are no device program, and
        on the 2-D mesh, which plans no 1-D buckets (the JAX engine's rule)."""
        if self._cpu_degraded or self._pipe2d is not None:
            return []
        K = self.seed_ensemble
        plan = []
        if singles:
            plan.append((self.single_pipe, None,
                         self._planned_width(len(singles) * K, None, self.single_pipe)))
        if multis and self._use_slots:
            for width, group in self._slot_buckets(multis):
                pipe = self._slot_pipe(width)
                plan.append((pipe, width, self._planned_width(len(group) * K, width, pipe)))
        elif multis:
            plan.append((self.multi_pipe, None,
                         self._planned_width(len(multis) * K, None, self.multi_pipe)))
        return plan

    def sweep_plan(self, subsets) -> list:
        """The bucket plan an `evaluate` over `subsets` would run with none
        of them memoized (what the sweep service's packer keys programs
        by). It mirrors `evaluate`'s routing: coalitions whose every member
        is dropped from epoch 1 are stored as 0 and never dispatched, the
        others are classified by their effective size and bucketed by their
        full membership."""
        keys = list(dict.fromkeys(tuple(sorted(int(i) for i in s)) for s in subsets))
        keys = [k for k in keys if self._effective_subset(k)]
        lens = {k: len(self._effective_subset(k)) for k in keys}
        singles = [k for k in keys if lens[k] == 1]
        multis = [k for k in keys if lens[k] > 1]
        return self._bucket_plan(singles, multis)

    def pin_fleet_widths(self, subsets) -> dict:
        """Pin this engine's bucket widths to the plan of a full sweep over
        `subsets` (`sweep_plan`): a fleet shard evaluating only a slice
        then runs each bucket at the full sweep's width (`_planned_width`).
        Returns {slot_count or None: width} for the shard's report; {} (and
        no pin) once the CPU rung is taken, which has no device plan.

        The JAX engine's pin is a no-op where it runs fedavg on its 2-D
        partner-sharded pipeline, its route under the deterministic reduce;
        the port runs those sweeps masked (1-D batches) unless the 2-D mode
        is asked for, so here the pin applies. On the 2-D mesh there is no
        plan and no pin. It changes batch shapes only."""
        plan = self.sweep_plan(subsets)
        self._fleet_widths = {(pipe, slot): width for pipe, slot, width in plan} or None
        return {slot: width for _pipe, slot, width in plan}

    # ------------------------------------------------------------------
    # the coalition cache: a long sweep is resumable because v(S) is
    # fully described by its memo
    # ------------------------------------------------------------------

    def _data_digest(self) -> str:
        """Content hash of the staged training and eval data, the bytes the
        JAX engine hashes (`sizes` as its int32): x strided, labels and
        sizes in full."""
        if self._digest is not None:
            return self._digest
        h = hashlib.sha256()

        def add(t, stride_cap_bytes=1 << 22):
            a = np.ascontiguousarray(t.cpu().numpy())
            h.update(str(a.shape).encode())
            # stride over flat elements, so every partner is sampled
            flat = a.reshape(-1)
            stride = max(1, flat.nbytes // stride_cap_bytes)
            h.update(np.ascontiguousarray(flat[::stride]).tobytes())

        add(self.stacked.x)
        add(self.stacked.y, stride_cap_bytes=1 << 30)
        add(self.stacked.sizes.to(torch.int32), stride_cap_bytes=1 << 30)
        add(self.val.x)
        add(self.val.y, stride_cap_bytes=1 << 30)
        add(self.test.x)
        add(self.test.y, stride_cap_bytes=1 << 30)
        self._digest = h.hexdigest()[:16]
        return self._digest

    def _fingerprint(self, data_digest: bool = True) -> dict:
        """Everything v(S) depends on, with the JAX engine's keys and the
        port's random streams. `data_digest=False` leaves the content hash
        of the staged data out (None): the program bank's key, which must
        not copy the data to the host."""
        cfg = self._multi_cfg
        sc = self.scenario
        return {
            "partners_count": self.partners_count,
            "seed": self.seed,
            "dataset": sc.dataset.name,
            "model": self.model.name,
            "approach": cfg.approach,
            "aggregator": cfg.aggregator,
            "epoch_count": cfg.epoch_count,
            "minibatch_count": cfg.minibatch_count,
            "gradient_updates_per_pass": cfg.gradient_updates_per_pass,
            "step_width_mult": cfg.step_width_mult,
            "deterministic_reduce": bool(cfg.deterministic_reduce),
            "partner_fault_plan": faults.normalized_plan_repr(self._partner_faults),
            "seed_ensemble": self.seed_ensemble,
            "compute_dtype": cfg.compute_dtype,
            "precision": cfg.precision,
            "split": [str(sc.samples_split_type), str(sc.samples_split_description)],
            "corruption": [str(c) for c in sc.corrupted_datasets],
            "partner_sizes": [int(s) for s in self.stacked.sizes.tolist()],
            "data_digest": self._data_digest() if data_digest else None,
            "rng_streams": RNG_STREAMS,
        }

    def save_cache(self, path) -> None:
        """Save the memo, the increments, the call count and the
        seed-ensemble replica rows (NaN where not yet trained) as JSON,
        durably: a sha256 checksum of the payload (`load_cache` verifies
        it), the temporary file fsync'd before the atomic replace, and the
        directory fsync'd after it."""
        payload = {
            "fingerprint": self._fingerprint(),
            "first_charac_fct_calls_count": self.first_charac_fct_calls_count,
            "charac_fct_values": [[list(k), v]
                                  for k, v in self.charac_fct_values.items()],
            "increments_values": [[[list(k), v] for k, v in d.items()]
                                  for d in self.increments_values],
        }
        if self.charac_fct_samples:
            payload["charac_fct_samples"] = [[list(k), [float(v) for v in arr]]
                                             for k, arr in self.charac_fct_samples.items()]
        # the checksum field is spliced into the serialized body, so the
        # payload is serialized once a save; the load re-serializes the
        # parsed payload to the same bytes
        body = json.dumps(payload)
        digest = hashlib.sha256(body.encode()).hexdigest()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write('{"payload_sha256": "%s", %s' % (digest, body[1:]))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            dfd = os.open(os.path.dirname(os.path.abspath(str(path))), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # a filesystem without directory fsync
        if str(path) == (self._legacy_cache_path or str(path)):
            self._cache_needs_upgrade = False

    def load_cache(self, path) -> None:
        """Restore a saved cache. An unreadable file (corrupt or truncated
        JSON, a failed checksum, missing keys) raises CacheIntegrityError;
        a valid cache of another game (any fingerprint key differs, a
        cache of the JAX package's streams included) raises ValueError. A
        cache without a checksum (legacy) loads unverified, with one
        DeprecationWarning a process, and is rewritten with a checksum by
        the next save to its path."""
        global _legacy_cache_warned
        try:
            with open(path) as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                raise ValueError(
                    f"top-level JSON is {type(payload).__name__}, not an object")
        except ValueError as e:
            raise CacheIntegrityError(
                f"coalition cache {path} is corrupt or truncated: {e}") from e
        expected = payload.pop("payload_sha256", None)
        if expected is not None:
            actual = hashlib.sha256(json.dumps(payload).encode()).hexdigest()
            if actual != expected:
                raise CacheIntegrityError(
                    f"coalition cache {path} failed its checksum (stored "
                    f"{expected[:12]}, recomputed {actual[:12]}): the file was "
                    "corrupted after it was written")
        else:
            if not _legacy_cache_warned:
                _legacy_cache_warned = True
                warnings.warn(
                    f"coalition cache {path} predates the checksum format and "
                    "loads unverified; it will be rewritten with a checksum "
                    "on the next autosave", DeprecationWarning, stacklevel=2)
            self._cache_needs_upgrade = True
            self._legacy_cache_path = str(path)
        missing = {"fingerprint", "first_charac_fct_calls_count",
                   "charac_fct_values", "increments_values"} - payload.keys()
        if missing:
            raise CacheIntegrityError(
                f"coalition cache {path} is missing keys {sorted(missing)}")
        theirs = payload["fingerprint"]
        # every cache the port writes names its streams; one without the
        # key was written by the JAX package, whose coalitions draw other
        # streams (its older caches also lack keys it later added, which
        # it reads with defaults; they are refused here all the same)
        theirs.setdefault("rng_streams", JAX_RNG_STREAMS)
        # a cache without these keys describes the per-sub-batch stepping,
        # fault-free, single-seed game (the JAX package's reading)
        theirs.setdefault("step_width_mult", 1)
        theirs.setdefault("partner_fault_plan", "")
        theirs.setdefault("seed_ensemble", 1)
        ours = self._fingerprint()
        mismatched = {k: (theirs.get(k), v) for k, v in ours.items()
                      if theirs.get(k) != v}
        if mismatched:
            raise ValueError(
                "coalition cache was built under a different scenario setup: "
                "characteristic values would not be comparable. Mismatches "
                f"(cache vs scenario): {mismatched}")
        self.charac_fct_values = {tuple(k): v for k, v in payload["charac_fct_values"]}
        self.increments_values = [{tuple(k): v for k, v in entries}
                                  for entries in payload["increments_values"]]
        self.first_charac_fct_calls_count = payload["first_charac_fct_calls_count"]
        self.charac_fct_samples = {tuple(k): np.asarray(v, float)
                                   for k, v in payload.get("charac_fct_samples", [])}
