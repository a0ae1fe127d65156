"""The multi-partner training engine: FedAvg, the sequential family, label
flipping and the single-partner trainer (port of `mplc_tpu/mpl/engine.py`).

Coalitions and partners are batch dimensions. Every tensor of the carried
`TrainState` leads with the coalition axis B (one training run is B = 1),
the port's counterpart of the JAX package's vmap of `init_state`,
`epoch_chunk` and `finalize` over coalitions. Every partner's local pass
of every coalition is one `torch.func.vmap` over `grad_and_value` of the
functional forward, on parameters stacked `[B*P, ...]`. A coalition is a
length-P 0/1 mask row that multiplies every per-sample loss mask (inactive
partners get exactly-zero gradients, hence exactly-zero optimizer updates) and
gates the aggregation weights. Under slot execution (`slot_count`) a
coalition is a row of K partner ids instead, -1 marking an unused slot,
and only its K slots train: the JAX package's `_fedavg_slot_epoch`, here
the same epoch function as the masked one with another binding of slots to
partners. Python loops take the place of the JAX package's `lax.scan`s.

Loop semantics kept from the JAX package:
  - fedavg: a fresh optimizer for every partner pass; per round
    (minibatch): global val eval (column 0), partner passes, aggregation
    weights, the recorded row (recording runs), aggregation; early stopping
    compares val_loss[e, 0] with val_loss[e - patience, 0]; the remainder
    of n_p mod minibatch_count samples is dropped per epoch;
  - seq-pure / seq-with-final-agg / seqavg: per minibatch a random visit
    order of the partners, the coalition's members first; one optimizer state
    carried along the chain, advanced only by member visits; each member
    trains the running params and leaves them in its `partner_stack` row
    (which starts each epoch at the epoch-start params). seqavg aggregates
    the stack after every minibatch, seq-with-final-agg once at the end of
    the epoch, seq-pure never; early stopping reads val column MB-1;
  - lflip: fedavg whose partners first re-estimate their label-flip matrix
    theta by one EM step on the minibatch window (the model's softmax, a
    column-normalised posterior, a row-normalised M-step) and train on
    labels drawn from the second posterior; theta is snapshotted into
    `theta_h` at the end of every epoch;
  - single (`approach="single"`, one active partner a coalition):
    minibatch_count x gradient_updates_per_pass steps of one persistent
    optimizer per epoch over the partner's shuffled rows, then a val eval, with
    Keras-style early stopping (no improvement of the val loss for
    `patience` epochs);
  - a coalition that has stopped is frozen (`torch.where`, the JAX
    package's `tree_where(state.done, ...)`): its parameters stay and its
    later history rows stay NaN while the others train on;
  - fused wide steps (`step_width_mult` k): every multi-partner pass takes
    ceil(gup / k) steps, step g on the base windows g*k .. g*k+k-1 at once;
  - partner faults (`partner_drop_epochs`, `partner_straggler_delays`;
    fedavg and single): a dropped partner trains on zeroed loss masks and
    weighs nothing from its drop epoch on (single: params and optimizer state
    frozen), a straggler's pass starts from the global params of `delay`
    rounds ago (`TrainState.stale`), a round without survivors keeps the
    global params.

Randomness: each epoch's draws of a coalition come from its own
`torch.Generator` (a CPU generator, so a run is the same on every device),
in this order: the permutations of every partner's rows, then the seq
family's visit-order keys [MB, P] or lflip's label-draw uniforms
[MB, P, mb_cap], then, for a model with dropout, one 64-bit dropout key;
or they are injected as `EpochStreams` (the tests feed the JAX
package's). The visit-order keys are drawn for all P partners whatever
the coalition, so slots and masks visit the members in the same order.
A training step's dropout keep masks are a hash (mpl/dropout.py) of the
epoch key and the coordinates the JAX package folds into its step keys:
(1, minibatch, global partner id, step) for fedavg, masked and on slots
alike, with 7 before the step for lflip's pass; (1, minibatch, visit
position + 1, step) for the seq family; (step + 1) for the single
trainer. They are computed on the run's device, or injected
(`EpochStreams.dropout_masks`). A model without dropout draws no key, so
its runs are those of a port without dropout. Evaluation never drops.

Host reads: the trainer never reads the device inside an epoch. Each
epoch's CPU draws come from the host's copy of the validity mask
(`StackedPartners.mask_host`) and of the coalitions (`coal_host`), and go
to the device through pinned memory without blocking (`upload`); a
history or partner-row write is a `torch.where` or a gather, never a
boolean index. So on a CUDA device a whole run of B coalitions is queued
without waiting on the card, and the batch's one sync is the engine's
harvest of its results. The one read
left is early stopping's: with `is_early_stopping` on and patience short
of epoch_count, each epoch reads whether every run has stopped.

Observability (`obs/trace.py`, port-only names): a batch's host work is
covered by leaf spans, `trainer.init` (initial parameters drawn and
uploaded), `trainer.draws` (an epoch's streams), `trainer.minibatch` (one
minibatch enqueued; FedAvg's is an aggregation round) and
`trainer.finalize` (the test evaluation enqueued); a host read of a device
tensor in a dispatch is a `trainer.sync` span. `MplTrainer.totals` sums the
gradient calls, their host seconds and their models (padded copies
apart) without a record per call.

Precision (`TrainConfig.precision`): the model computes in `cfg.dtype`
(bf16 under `mixed` and `bf16`, or under `fp32` with `compute_dtype`
"bfloat16"); parameters, optimizer state, aggregation
weights and the recorded deltas stay float32 in every mode.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import time
from typing import NamedTuple

import torch
from torch.func import grad_and_value, vmap

from .. import constants
from ..models.core import Model
from ..obs import trace as obs_trace
from ..ops.aggregation import AGGREGATOR_NAMES, aggregate, aggregation_weights
from ..ops.metrics import masked_loss_and_metrics
from . import dropout as drop_masks

logger = logging.getLogger("mplc_tpu_torch")

APPROACH_NAMES = ("fedavg", "seq-pure", "seq-with-final-agg", "seqavg", "lflip", "single")
SEQ_APPROACHES = ("seq-pure", "seq-with-final-agg", "seqavg")
# the approaches slot execution supports
SLOT_APPROACHES = ("fedavg",) + SEQ_APPROACHES


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    approach: str = "fedavg"
    aggregator: str = "uniform"
    epoch_count: int = constants.DEFAULT_EPOCH_COUNT
    minibatch_count: int = constants.DEFAULT_BATCH_COUNT
    gradient_updates_per_pass: int = constants.DEFAULT_GRADIENT_UPDATES_PER_PASS_COUNT
    is_early_stopping: bool = True
    patience: int = constants.PATIENCE
    # per-partner val loss/acc after every round's local passes (seq: after
    # every member visit)
    record_partner_val: bool = True
    # global val loss/acc at the start of EVERY minibatch; when off, only
    # the column early stopping reads (0; MB-1 for the seq family) is
    # evaluated, and none when early stopping is off too
    record_val_history: bool = True
    # lflip: the off-diagonal mass of every partner's initial theta
    lflip_epsilon: float = 0.01
    # capture every round's per-partner parameter delta (local params -
    # round-start global params) and the normalized aggregation weights
    # actually applied: `upd_h` [B, R, P, ...] leaves and `w_h` [B, R, P],
    # R = epoch_count x minibatch_count (retrain-free contributivity)
    record_updates: bool = False
    # MPLC_TORCH_PRECISION mode (constants.py): fp32 | mixed | bf16. None
    # resolves it from the environment at construction; the resolved mode
    # is frozen into the config. mixed and bf16 compute the model in bf16;
    # parameters, optimizer state, aggregation and the recorded stream stay
    # float32 in every mode.
    precision: str | None = None
    # the Scenario's `compute_dtype`: "bfloat16" computes the model in bf16
    # under the fp32 precision mode too (the JAX package's rule); "float32"
    # leaves the dtype to the precision mode
    compute_dtype: str = "float32"
    # slot execution (fedavg and seq coalition sweeps): train `slot_count` partner
    # slots a coalition instead of all P partners masked. The coalition
    # argument is then int slot ids [B, slot_count], -1 marking an unused
    # slot, in place of masks [B, P]. Slot s trains partner ids[s] on the
    # rows of the permutation the masked path draws for it, so the two
    # paths train alike (bit for bit under `deterministic_reduce`).
    slot_count: int | None = None
    # MPLC_TORCH_DETERMINISTIC_REDUCE (constants.py): every aggregation
    # folds its normalizer and weighted sum left to right in partner order
    # (ops/aggregation.py `ordered_fold`), and a fedavg pass takes its
    # gradients (and partner val scores) one slot column of the B runs at
    # a time, so masks and slots compute each model alike on the card. None
    # resolves it from the environment at construction; the resolved value
    # is frozen in.
    deterministic_reduce: bool | None = None
    # MPLC_TORCH_STEP_WIDTH_MULT (constants.py): fused step g of a
    # multi-partner pass covers the base sub-batch windows g*k .. g*k+k-1
    # as one window k times as wide, so a pass takes ceil(gup / k) steps;
    # k = 1 is the per-sub-batch stepping. The single trainer keeps its
    # minibatch_count x gup steps. None resolves it from the environment
    # at construction; the resolved value is frozen in.
    step_width_mult: int | None = None
    # The partner fault plan's trainer entries (faults.py
    # `trainer_fault_arrays`), tuples of length P or None:
    #   partner_drop_epochs[p]      1-based epoch from which partner p is
    #       gone for good (0: never): exactly-zero gradients and zero
    #       aggregation weight, so FedAvg renormalizes over the survivors
    #       (the single trainer freezes its params and optimizer state instead);
    #   partner_straggler_delays[p] partner p's local pass starts from the
    #       global params of that many aggregation rounds ago (0: the
    #       current ones), kept in `TrainState.stale`; its result joins the
    #       current round's aggregation.
    # fedavg (masked or on slots) and the single trainer only.
    partner_drop_epochs: tuple | None = None
    partner_straggler_delays: tuple | None = None
    # every gradient call holds exactly `model.grad_call_width` models
    # (`MplTrainer._model_grads`): the coalition engine's trainers, whose
    # step widths vary with the batch; False (the fit, the recording): a
    # step's models in one call
    fixed_call_width: bool = False
    # the partner axis sharded over a mesh row (parallel/mesh.py
    # `AxisGroup`, the JAX package's axis name; None: unsharded): the
    # trainer's partners are this rank's block of the row's, its random
    # draws come in whole (`PartnerShardedTrainer` slices them), and each
    # round's aggregation reduces over the row (ops/aggregation.py).
    # fedavg and lflip, masked, without partner faults or recording
    partner_axis: object = None

    def __post_init__(self):
        if self.deterministic_reduce is None:
            object.__setattr__(self, "deterministic_reduce",
                               constants.deterministic_reduce_enabled())
        if self.step_width_mult is None:
            object.__setattr__(self, "step_width_mult", constants.step_width_mult())
        if self.step_width_mult < 1:
            raise ValueError(f"step_width_mult must be >= 1, got {self.step_width_mult}")
        if self.precision is None:
            object.__setattr__(self, "precision", constants.precision_mode())
        if self.precision not in constants.PRECISION_MODES:
            raise ValueError(f"precision must be one of "
                             f"{constants.PRECISION_MODES}, got {self.precision!r}")
        if self.compute_dtype not in constants.COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {constants.COMPUTE_DTYPES}, "
                             f"got {self.compute_dtype!r}")
        if self.approach not in APPROACH_NAMES:
            raise KeyError(
                f"Multi-partner learning approach '{self.approach}' is not a valid "
                f"approach. List of supported approaches: {', '.join(APPROACH_NAMES)}")
        if self.aggregator not in AGGREGATOR_NAMES:
            raise KeyError(f"aggregation approach '{self.aggregator}' is not a "
                           f"valid approach. Supported: {AGGREGATOR_NAMES}")
        if (self.partner_drop_epochs is not None
                or self.partner_straggler_delays is not None) \
                and self.approach not in ("fedavg", "single"):
            raise ValueError("partner dropout and straggler faults support fedavg "
                             "coalition training and the single-partner trainer "
                             f"only, got '{self.approach}'")
        if self.slot_count is not None and self.approach not in SLOT_APPROACHES:
            raise ValueError("slot execution supports fedavg and the seq family "
                             f"only, got '{self.approach}'")
        if self.record_updates:
            if self.approach != "fedavg":
                raise ValueError("update recording (record_updates) captures FedAvg "
                                 "aggregation-round deltas; it supports the fedavg "
                                 f"approach only, got '{self.approach}'")
            if self.slot_count is not None:
                raise ValueError("update recording runs the masked fedavg path; "
                                 "slot execution is not supported")
        if self.partner_axis is not None:
            if self.approach not in ("fedavg", "lflip"):
                raise ValueError("partner-axis sharding requires a partner-parallel "
                                 f"approach (fedavg/lflip), got '{self.approach}'")
            if self.faulted:
                raise ValueError("partner-level faults and partner-axis sharding are "
                                 "mutually exclusive")
            if self.slot_count is not None:
                raise ValueError("slot execution and partner-axis sharding are "
                                 "mutually exclusive")
            if self.record_updates:
                raise ValueError(
                    "update recording is not supported with partner-axis sharding (the "
                    "2-D coalition x partner mode): the recorded [rounds, partners, ...] "
                    "update stack needs the whole partner axis on one rank")

    @property
    def dtype(self) -> torch.dtype:
        """The model compute dtype: bf16 under `mixed` and `bf16`, and
        under `fp32` when `compute_dtype` is "bfloat16"."""
        if self.precision == "fp32" and self.compute_dtype == "float32":
            return torch.float32
        return torch.bfloat16

    @property
    def pass_steps(self) -> int:
        """Optimizer steps of one multi-partner pass: ceil(gup / k)."""
        return -(-self.gradient_updates_per_pass // self.step_width_mult)

    @property
    def stops_early(self) -> bool:
        """True when early stopping can end a run before epoch_count (on,
        with patience short of epoch_count): then each epoch reads from
        the device whether every run has stopped, the trainer's one host
        read inside a run."""
        return self.is_early_stopping and self.patience < self.epoch_count

    @property
    def faulted(self) -> bool:
        return (self.partner_drop_epochs is not None
                or self.partner_straggler_delays is not None)


@dataclasses.dataclass
class TrainState:
    """B coalition runs' carried state, stacked on a leading axis (mutated
    in place by the epochs). `row(i)` is one run's state alone."""
    params: dict             # global model parameters, leaves [B, ...]
    val_loss_h: torch.Tensor  # [B, E, MB] global val loss history
    val_acc_h: torch.Tensor   # [B, E, MB]
    partner_h: torch.Tensor   # [B, 4, P, E, MB]: loss, acc, val_loss, val_acc
    done: torch.Tensor        # [B] bool: early-stopped or finished
    nb_epochs_done: torch.Tensor  # [B] int64
    best_val_loss: torch.Tensor   # [B] ('single' early stopping)
    es_wait: torch.Tensor         # [B] int64 ('single' early stopping)
    epoch: int = 0           # next epoch index of the runs still training
    opt_state: dict | None = None    # persistent optimizer state ('single' only)
    upd_h: dict | None = None        # [B, R, P, ...] recorded deltas
    w_h: torch.Tensor | None = None  # [B, R, P] recorded weights
    theta: torch.Tensor | None = None    # [B, P, K, K] label-flip matrices (lflip)
    theta_h: torch.Tensor | None = None  # [B, E, P, K, K] end-of-epoch theta, NaN
                                         # for epochs not run (lflip)
    stale: dict | None = None    # [B, D, ...] the last D round-start global
                                 # params, newest first (fedavg stragglers)

    def row(self, i: int) -> "TrainState":
        """Run i's state without the coalition axis: views of its tensors,
        `done` a bool and `nb_epochs_done` an int."""
        take = lambda tree: None if tree is None else _tree_map(lambda t: t[i], tree)  # noqa: E731
        pick = lambda t: None if t is None else t[i]  # noqa: E731
        return TrainState(
            params=take(self.params), val_loss_h=self.val_loss_h[i],
            val_acc_h=self.val_acc_h[i], partner_h=self.partner_h[i],
            done=bool(self.done[i]), nb_epochs_done=int(self.nb_epochs_done[i]),
            best_val_loss=self.best_val_loss[i], es_wait=self.es_wait[i],
            epoch=self.epoch, opt_state=None, upd_h=take(self.upd_h),
            w_h=pick(self.w_h), theta=pick(self.theta), theta_h=pick(self.theta_h))


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on `device`, a new tensor. On a CUDA device it goes
    through pinned memory and the copy is queued without blocking the host
    (the pinned buffer is held by torch's caching host allocator until the
    copy has run), so no dispatch waits on the card; elsewhere `t.to`."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host_read(t: torch.Tensor, what: str) -> torch.Tensor:
    """`t` on the CPU: itself when it lies there, else read from its
    device inside a `trainer.sync` span."""
    if t.device.type == "cpu":
        return t
    with obs_trace.span("trainer.sync", what=what):
        return t.cpu()


def _host_mask(stacked) -> torch.Tensor:
    """The stacked validity mask [P, Nmax] on the CPU."""
    return (_host_read(stacked.mask, "mask") if stacked.mask_host is None
            else stacked.mask_host)


def host_coalitions(coal: torch.Tensor, coal_host) -> torch.Tensor:
    """The host copy of a batch's coalitions: `coal_host` when given, else
    `coal` read to the CPU (a read of the device when `coal` lies there)."""
    return _host_read(coal, "coalitions") if coal_host is None else torch.as_tensor(coal_host)


@dataclasses.dataclass
class CallTotals:
    """A dispatch's host-side totals (`MplTrainer.totals`): its gradient
    calls, their host seconds (two `perf_counter` readings a call), the
    models in them and the padded copies among them (`_model_grads`), and
    the `perf_counter` reading at the end of its first epoch's draws."""
    grad_calls: int = 0
    grad_call_host_s: float = 0.0
    models_called: int = 0
    models_padded: int = 0
    first_draws_end: float | None = None


class EpochStreams(NamedTuple):
    """One epoch's random draws of B runs, injected in place of their
    generators' (or, each field with an epoch axis after B, a chunk's).
    A model with dropout needs `dropout_key` or `dropout_masks`; the masks,
    one bool tensor a dropout layer, lead with [B, MB, P, S] (fedavg and
    lflip: by global partner id and step), [B, MB, V, S] (the seq family:
    by visit position) or [B, S] (single), then the step window's rows and
    the layer's per-sample shape."""
    perms: torch.Tensor                     # [B, P, Nmax] ('single': [B, Nmax])
    order_keys: torch.Tensor | None = None  # [B, MB, P] seq visit-order keys
    flip_u: torch.Tensor | None = None      # [B, MB, P, mb_cap] lflip uniforms
    dropout_key: torch.Tensor | None = None  # [B, 2] int64 dropout keys
    dropout_masks: tuple | None = None       # per layer, see above


def _stream_map(fn, t):
    """fn over a stream field: a tensor, a tuple of tensors or None."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(fn(m) for m in t)
    return fn(t)


def epoch_streams(streams_all, i: int):
    """Epoch i of a chunk's injected streams: a permutation tensor
    [B, E, ...] or an `EpochStreams` of such fields; None stays None."""
    if streams_all is None:
        return None
    if isinstance(streams_all, EpochStreams):
        return EpochStreams(*(_stream_map(lambda t: t[:, i], f) for f in streams_all))
    return streams_all[:, i]


class EvalSet(NamedTuple):
    x: torch.Tensor     # [n_chunks, chunk, ...]
    y: torch.Tensor     # [n_chunks, chunk, L]
    mask: torch.Tensor  # [n_chunks, chunk]


def _tree_map(fn, *trees) -> dict:
    return {g: {k: fn(*(t[g][k] for t in trees)) for k in trees[0][g]}
            for g in trees[0]}


def _rows(flag: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A [B] flag shaped to broadcast against t's leading B axis."""
    return flag.reshape(flag.shape + (1,) * (t.ndim - flag.ndim))


def _keep_frozen(frozen: torch.Tensor, old, new):
    """new, with the rows of the frozen runs taken from old (a tensor or a
    parameter dict, leading axis B)."""
    if isinstance(old, dict):
        return _tree_map(lambda o, n: torch.where(_rows(frozen, n), o, n), old, new)
    return torch.where(_rows(frozen, new), old, new)


def _keep_frozen_opt(frozen: torch.Tensor, old: dict, new: dict) -> dict:
    """An optimizer state `new` with the frozen runs' rows of every tree
    entry taken from `old`; `count` is new's."""
    return {k: v if k == "count" else _keep_frozen(frozen, old[k], v)
            for k, v in new.items()}


def _column(t: torch.Tensor, W: int, w: int) -> torch.Tensor:
    """Column w of a run-major [B*W, ...] stack: its B rows w, W + w, ..."""
    return t.reshape((t.shape[0] // W, W) + t.shape[1:])[:, w].contiguous()


def _write(view: torch.Tensor, value, frozen: torch.Tensor) -> None:
    """Write value (a tensor or a Python number) into a history view,
    except in the rows of frozen runs."""
    if not isinstance(value, torch.Tensor):
        value = torch.full_like(view, value)
    view.copy_(_keep_frozen(frozen, view, value.to(view)))


class MplTrainer:
    """The masked FedAvg or single-partner trainer of one (model, config)
    pair, over a batch of coalitions."""

    def __init__(self, model: Model, cfg: TrainConfig):
        self.model = model
        self.cfg = cfg
        self._grads = vmap(grad_and_value(self._loss_fn, has_aux=True))
        self._model_sums = vmap(self._chunk_sums, in_dims=(0, None, None, None))
        # when a list, every gradient and forward call of the model appends
        # its (kind, models, rows): a batch's FLOP count (`call_flops`)
        self.call_log: list | None = None
        # what the calls cost on the host; the engine sets fresh totals
        # before each batch's dispatch
        self.totals = CallTotals()

    def _log_call(self, kind: str, models: int, rows: int) -> None:
        if self.call_log is not None:
            self.call_log.append((kind, int(models), int(rows)))

    # ------------------------------------------------------------------
    # state init
    # ------------------------------------------------------------------

    def init_state(self, generators, partners_count: int, device,
                   init_params: dict | None = None,
                   init_theta: torch.Tensor | None = None) -> TrainState:
        """The state of B runs: initial parameters drawn from each run's
        generator (a list of B), or injected (`init_params`, leaves
        [B, ...]; `generators` may then be None). lflip runs start from
        theta = eye (1 - eps) + (1 - eye) eps / (K - 1) for every partner,
        or from `init_theta` [B, P, K, K]."""
        with obs_trace.span("trainer.init"):
            return self._init_state(generators, partners_count, device, init_params,
                                    init_theta)

    def _init_state(self, generators, partners_count: int, device, init_params,
                    init_theta) -> TrainState:
        cfg = self.cfg
        if init_params is None:
            drawn = [self.model.init(g) for g in generators]
            init_params = _tree_map(lambda *ts: torch.stack(ts), *drawn)
        device = torch.device(device)

        def fresh(t):
            out = upload(t.detach().float(), device)
            return out.clone() if t.device == device else out
        params = _tree_map(fresh, init_params)
        B = next(iter(next(iter(params.values())).values())).shape[0]
        E, MB = cfg.epoch_count, cfg.minibatch_count
        nan = lambda *shape: torch.full(shape, float("nan"), device=device)  # noqa: E731
        state = TrainState(
            params=params, val_loss_h=nan(B, E, MB), val_acc_h=nan(B, E, MB),
            partner_h=nan(B, 4, partners_count, E, MB),
            done=torch.zeros(B, dtype=torch.bool, device=device),
            nb_epochs_done=torch.zeros(B, dtype=torch.int64, device=device),
            best_val_loss=torch.full((B,), float("inf"), device=device),
            es_wait=torch.zeros(B, dtype=torch.int64, device=device))
        if cfg.approach == "single":
            state.opt_state = self.model.optimizer.init(params)
        if cfg.approach == "lflip":
            k = self.model.num_outputs
            if init_theta is None:
                eye = torch.eye(k, device=device)
                eps = cfg.lflip_epsilon
                init_theta = (eye * (1 - eps) + (1 - eye) * (eps / (k - 1))).expand(
                    B, partners_count, k, k)
            state.theta = fresh(init_theta)
            state.theta_h = nan(B, E, partners_count, k, k)
        if cfg.approach == "fedavg" and cfg.partner_straggler_delays \
                and any(cfg.partner_straggler_delays):
            # a straggler older than the run so far starts from the
            # initial params
            D = max(cfg.partner_straggler_delays)
            state.stale = _tree_map(
                lambda t: t[:, None].expand((B, D) + t.shape[1:]).clone(), params)
        if cfg.record_updates:
            # rounds the run never reaches (early stopping) stay all-zero,
            # which reconstruction skips via its zero-denominator rule
            R = E * MB
            state.upd_h = _tree_map(
                lambda t: torch.zeros((B, R, partners_count) + t.shape[1:],
                                      device=device), params)
            state.w_h = torch.zeros((B, R, partners_count), device=device)
        return state

    # ------------------------------------------------------------------
    # evaluation (chunked: bounded activation memory)
    # ------------------------------------------------------------------

    def _chunk_sums(self, params, x, y, m):
        logits = self.model.apply(params, x, self.cfg.dtype)
        loss, acc, cnt = masked_loss_and_metrics(self.model.loss_kind, logits, y, m)
        return loss * cnt, acc * cnt, cnt

    def evaluate_models(self, params_b: dict, ev: EvalSet) -> tuple[torch.Tensor, torch.Tensor]:
        """([B] mean_loss, [B] accuracy) of B models stacked on a leading
        axis, vmapped over the models. Each eval chunk is cut so that
        models x rows in one forward stay within the model's rows in flight
        (`constants.eval_rows_in_flight`)."""
        B = next(iter(next(iter(params_b.values())).values())).shape[0]
        rows = self._eval_rows(B)
        ls = cs = cnt = 0.0
        for cx, cy, cm in zip(ev.x, ev.y, ev.mask):
            for s in range(0, cx.shape[0], rows):
                self._log_call("eval", B, min(rows, cx.shape[0] - s))
                l, a, c = self._model_sums(params_b, cx[s:s + rows],
                                           cy[s:s + rows], cm[s:s + rows])
                ls, cs, cnt = ls + l, cs + a, cnt + c
        denom = torch.clamp(cnt, min=1.0)
        return ls / denom, cs / denom

    def _eval_rows(self, B: int) -> int:
        """Rows of one evaluation forward call of B models."""
        return max(1, constants.eval_rows_in_flight(self.model.eval_row_bytes) // B)

    def eval_calls(self, B: int, ev: EvalSet) -> list:
        """The (kind, models, rows) calls `evaluate_models` makes for B
        models on `ev`, as it logs them (`call_log`), without running them."""
        rows = self._eval_rows(B)
        n = ev.x.shape[1]
        return [("eval", B, min(rows, n - s)) for _ in range(ev.x.shape[0])
                for s in range(0, n, rows)]

    def _maybe_val_eval(self, params: dict, val: EvalSet, mb_i: int, es_col: int = 0):
        """The global val (loss, acc) at the start of minibatch `mb_i`, or
        NaN where neither the history nor early stopping (which reads
        column `es_col`) needs it."""
        cfg = self.cfg
        if cfg.record_val_history or (cfg.is_early_stopping and mb_i == es_col):
            return self.evaluate_models(params, val)
        return float("nan"), float("nan")

    # ------------------------------------------------------------------
    # data selection (static shapes, all runs and partners at once)
    # ------------------------------------------------------------------

    @staticmethod
    def epoch_perms(generator: torch.Generator, mask: torch.Tensor) -> torch.Tensor:
        """Permutations of the last axis of a (CPU) validity mask, its valid
        rows first, in random order, drawn from `generator`."""
        keys = torch.rand(mask.shape, generator=generator) + (1.0 - mask) * 1e9
        return torch.argsort(keys, dim=-1, stable=True)

    def _draws(self, generators, mask: torch.Tensor, streams, dev=None) -> EpochStreams:
        """This epoch's draws of every run on device `dev` (None: `mask`'s):
        injected (`streams`, an `EpochStreams` or a permutation tensor), or
        drawn from each run's generator: the permutations over its rows of
        the validity mask `mask` ([B, ...], read on the CPU: the trainer
        passes the host copy), then the approach's visit-order keys or
        label-draw uniforms, then the dropout key. Either way they go to
        `dev` through `upload`."""
        with obs_trace.span("trainer.draws"):
            out = self._drawn(generators, mask, streams, dev)
        if self.totals.first_draws_end is None:
            self.totals.first_draws_end = time.perf_counter()
        return out

    def _drawn(self, generators, mask: torch.Tensor, streams, dev) -> EpochStreams:
        cfg = self.cfg
        dev = mask.device if dev is None else dev
        mask = _host_read(mask, "mask")
        extra = None
        if cfg.approach in SEQ_APPROACHES:
            extra = "order_keys", (cfg.minibatch_count, mask.shape[1])
        elif cfg.approach == "lflip":
            extra = "flip_u", (cfg.minibatch_count, mask.shape[1],
                               max(mask.shape[-1] // cfg.minibatch_count, 1))
        dropout = bool(self.model.dropout)
        if streams is None:
            perms, drawn, keys = [], [], []
            for g, m in zip(generators, mask):
                perms.append(self.epoch_perms(g, m))
                if extra is not None:
                    drawn.append(torch.rand(extra[1], generator=g))
                if dropout:
                    keys.append(drop_masks.draw_key(g))
            streams = EpochStreams(torch.stack(perms))
            if extra is not None:
                streams = streams._replace(**{extra[0]: torch.stack(drawn)})
            if dropout:
                streams = streams._replace(dropout_key=torch.stack(keys))
        elif not isinstance(streams, EpochStreams):
            streams = EpochStreams(streams)
        if extra is not None and getattr(streams, extra[0]) is None:
            raise ValueError(f"injected streams of a '{cfg.approach}' run need "
                             f"{extra[0]}")
        if dropout and streams.dropout_key is None and streams.dropout_masks is None:
            raise ValueError(f"injected streams of a run of {self.model.name}, which "
                             "has dropout, need dropout_key or dropout_masks")
        dtypes = (torch.int64, torch.float32, torch.float32, torch.int64, torch.bool)
        return EpochStreams(*(_stream_map(lambda t, d=d: upload(t.to(d), dev), f)
                              for f, d in zip(streams, dtypes)))

    def draw_streams(self, generators, mask: torch.Tensor, n_epochs: int) -> EpochStreams:
        """`n_epochs` epochs of every run's draws, taken from the generators
        in the order the epochs would take them, on the CPU with an epoch
        axis after B (`epoch_chunk`'s `streams_all`): a chunk fed these
        trains as one that draws its own. `mask` is what `_draws` gets."""
        cpu = torch.device("cpu")
        epochs = [self._draws(generators, mask, None, cpu) for _ in range(n_epochs)]
        return EpochStreams(*(None if f[0] is None else
                              tuple(torch.stack(ms, 1) for ms in zip(*f))
                              if isinstance(f[0], tuple) else torch.stack(f, 1)
                              for f in zip(*epochs)))

    def _step_masks(self, draws: EpochStreams, rows: int, coords: tuple, pick):
        """The keep masks of a run's steps, one per dropout layer (() for a
        model without): drawn from the epoch keys at `coords`
        (`dropout.stream_seeds`; the masks lead with its broadcast shape),
        or, where injected, `pick` of each injected mask."""
        layers = self.model.dropout
        if not layers:
            return ()
        if draws.dropout_masks is not None:
            return tuple(pick(m) for m in draws.dropout_masks)
        return drop_masks.step_masks(draws.dropout_key, rows, layers, *coords)

    def _step_rows(self, sizes, g: int, sb_cap: int):
        """(row offsets within the minibatch, samples per minibatch,
        validity) of (fused) gradient step g for every run and partner
        slot (`sizes` [B, W]); offsets and validity [B, W, sb_cap * k].
        Under `step_width_mult` k, step g covers the base sub-batch windows
        g*k .. g*k+k-1 as one contiguous window; k = 1 is the base window."""
        cfg = self.cfg
        mbc, gup = cfg.minibatch_count, cfg.gradient_updates_per_pass
        k = cfg.step_width_mult
        valid_mb = (sizes // mbc)[..., None]           # samples per minibatch
        sb = (valid_mb + gup - 1) // gup               # samples per base step
        ar = torch.arange(sb_cap * k, device=sizes.device)
        local = g * (sb * k) + ar
        return local, valid_mb, (ar < sb * k) & (local < valid_mb)

    def _subbatch(self, perms, sizes, mb_i: int, g: int, sb_cap: int):
        """Indices + validity mask, both [B, W, sb_cap * k], of (fused)
        gradient step g of minibatch mb_i, for every run and partner slot
        (`perms` [B, W, Nmax], `sizes` [B, W])."""
        local, valid_mb, valid = self._step_rows(sizes, g, sb_cap)
        pos = torch.clamp(mb_i * valid_mb + local, 0, perms.shape[-1] - 1)
        return torch.gather(perms, 2, pos), valid.float()

    def _minibatch_window(self, perms, sizes, mb_i: int, mb_cap: int):
        """Indices + validity mask, both [B, W, mb_cap], of the whole
        minibatch mb_i of every run and partner slot."""
        valid_mb = (sizes // self.cfg.minibatch_count)[..., None]
        ar = torch.arange(mb_cap, device=sizes.device)
        pos = torch.clamp(mb_i * valid_mb + ar, 0, perms.shape[-1] - 1)
        return torch.gather(perms, 2, pos), (ar < valid_mb).float()

    @staticmethod
    def _slot_binding(ids: torch.Tensor):
        """(partner rows, activity, used) of slot ids [B, K], -1 marking an
        unused slot: an unused slot is bound to partner 0 with activity 0,
        so it gets zero gradients and zero aggregation weight, and its
        history is dropped."""
        used = ids >= 0
        return torch.clamp(ids.long(), min=0), used.float(), used

    # ------------------------------------------------------------------
    # masked optimizer steps of N models at once
    # ------------------------------------------------------------------

    def _loss_fn(self, params, x, y, m, drop):
        logits = self.model.apply(params, x, self.cfg.dtype, drop or None)
        loss, acc, cnt = masked_loss_and_metrics(self.model.loss_kind, logits, y, m)
        return loss, (acc, cnt)

    def _column_grads(self, params, x, y, m, drop, W: int):
        """`_grads` of N = B*W models (run-major), as W vmapped calls of one
        column's B models each: a model's arithmetic then has the same
        shapes whether its run trains W = P partners masked or W = K slots
        (on the card cuDNN chooses its algorithms by the number of models
        a call, so one call of B*W models parts from one of B*K)."""
        N = x.shape[0]
        outs = [self._model_grads(_tree_map(lambda t: _column(t, W, w), params),
                                  *(_column(t, W, w) for t in (x, y, m)),
                                  tuple(_column(d, W, w) for d in drop)) for w in range(W)]

        def join(*ts):
            return torch.stack(ts, 1).reshape((N,) + ts[0].shape[1:])
        grads = _tree_map(join, *(o[0] for o in outs))
        loss, acc, cnt = (join(*ts) for ts in zip(*((o[1][0],) + o[1][1] for o in outs)))
        return grads, (loss, (acc, cnt))

    def _model_grads(self, params, x, y, m, drop):
        """`_grads` of N models, under `cfg.fixed_call_width` in calls of
        exactly `model.grad_call_width` models (the last padded with
        copies of its first model, whose results are dropped), else in
        one call. On the card cuDNN picks a convolution's backward
        algorithm by a call's shape, so with calls of one width a model's
        gradient does not depend on how many models its batch holds."""
        N = x.shape[0]
        M = self.model.grad_call_width if self.cfg.fixed_call_width else N
        for _ in range(0, N, M):
            self._log_call("grad", M, x.shape[1])
        if M == N:
            return self._grad_call(N, 0, params, x, y, m, drop)

        def take(t, s):
            n = min(M, N - s)
            part = t[s:s + n]
            return part if n == M else torch.cat(
                [part, part[:1].expand((M - n,) + part.shape[1:])])
        outs = [self._grad_call(M, M - min(M, N - s),
                                _tree_map(lambda t: take(t, s), params),
                                *(take(t, s) for t in (x, y, m)),
                                tuple(take(d, s) for d in drop))
                for s in range(0, N, M)]

        def join(*ts):
            return torch.cat(ts)[:N]
        grads = _tree_map(join, *(o[0] for o in outs))
        loss, acc, cnt = (join(*ts) for ts in zip(*((o[1][0],) + o[1][1] for o in outs)))
        return grads, (loss, (acc, cnt))

    def _grad_call(self, models: int, padded: int, *args):
        """One vmapped gradient call of `models` models, `padded` of them
        copies, added to `totals` with its host seconds."""
        t0 = time.perf_counter()
        out = self._grads(*args)
        tot = self.totals
        tot.grad_call_host_s += time.perf_counter() - t0
        tot.grad_calls += 1
        tot.models_called += models
        tot.models_padded += padded
        return out

    @contextlib.contextmanager
    def _minibatch(self, mb_i: int):
        """A `trainer.minibatch` span around minibatch `mb_i`'s enqueue,
        with the gradient calls it made (attr `grad_calls`)."""
        calls = self.totals.grad_calls
        with obs_trace.span("trainer.minibatch", mb=mb_i) as sp:
            yield
            sp.attrs["grad_calls"] = self.totals.grad_calls - calls

    def _steps(self, params: dict, opt_state: dict, batches, columns: int | None = None):
        """One masked optimizer step of N models (params [N, ...]) for each
        (x [N, sb, ...], y, m [N, sb], dropout keep masks: () or one
        [N, sb, ...] a layer) of `batches`. Returns (params, opt_state,
        mean loss [N], mean accuracy [N]) over the steps. Under the
        deterministic reduce, `columns` W computes the gradients a column
        of the run-major [B, W] models at a time (`_column_grads`); either
        way the calls are `_model_grads`'."""
        params, opt_state, sums = self._run_steps(params, opt_state, batches, columns)
        return (params, opt_state) + self._means(sums)

    def _run_steps(self, params: dict, opt_state: dict, batches, columns: int | None = None,
                   sums: tuple | None = None):
        """`_steps` with its (loss, accuracy, count) sums returned rather
        than their means, carried on from `sums` (None: from 0)."""
        opt = self.model.optimizer
        loss_sum, acc_sum, cnt_sum = sums or (0.0, 0.0, 0.0)
        by_column = columns is not None and self.cfg.deterministic_reduce
        for x, y, m, drop in batches:
            if by_column:
                grads, (loss, (acc, cnt)) = self._column_grads(params, x, y, m, drop, columns)
            else:
                grads, (loss, (acc, cnt)) = self._model_grads(params, x, y, m, drop)
            params, opt_state = opt.step(params, grads, opt_state)
            loss_sum = loss_sum + loss * cnt
            acc_sum = acc_sum + acc * cnt
            cnt_sum = cnt_sum + cnt
        return params, opt_state, (loss_sum, acc_sum, cnt_sum)

    @staticmethod
    def _means(sums: tuple):
        """(mean loss, mean accuracy) of `_run_steps`' sums."""
        loss_sum, acc_sum, cnt_sum = sums
        denom = torch.clamp(cnt_sum, min=1.0)
        return loss_sum / denom, acc_sum / denom

    # ------------------------------------------------------------------
    # lflip: one EM step of theta and the label draw, all partners at once
    # ------------------------------------------------------------------

    def lflip_flip(self, preds, y, valid, theta, u):
        """The JAX package's `_lflip_flip` after the model's softmax, for N
        partner windows at once: `preds` and one-hot `y` [N, M, K], `valid`
        [N, M], `theta` [N, K, K], uniforms `u` [N, M]. Returns (new theta
        [N, K, K], drawn one-hot labels [N, M, K])."""
        vm = valid[..., None]

        def posterior(th):
            # row m: preds[m, :] * th[:, label(m)], columns L1-normalised
            t = preds * (y @ th.transpose(-1, -2)) * vm
            return t / torch.clamp(t.abs().sum(-2, keepdim=True), min=1e-12)

        new_theta = posterior(theta).transpose(-1, -2) @ y
        new_theta = new_theta / torch.clamp(new_theta.abs().sum(-1, keepdim=True),
                                            min=1e-12)
        cdf = torch.cumsum(posterior(new_theta), dim=-1)
        # inverse-CDF draw of each row's label: the first class whose
        # cumulative mass reaches u times the row's total
        target = u[..., None] * torch.clamp(cdf[..., -1:], min=1e-12)
        draw = torch.argmax((target <= cdf).to(torch.int32), dim=-1)
        return new_theta, torch.nn.functional.one_hot(draw, y.shape[-1]).float()

    def _lflip_windows(self, params, theta, stacked, pids, perms, sizes, act,
                       mb_i: int, u):
        """Every partner's EM step on its minibatch-`mb_i` window under the
        round's global model: (theta [B, W, K, K], kept where the partner
        is inactive; window row indices [B, W, M]; drawn labels
        [B, W, M, K])."""
        B, W = pids.shape
        mb_cap = max(stacked.x.shape[1] // self.cfg.minibatch_count, 1)
        idx, valid = self._minibatch_window(perms, sizes, mb_i, mb_cap)
        rows = pids[:, :, None]
        x = stacked.x[rows, idx].reshape((B * W, mb_cap) + stacked.x.shape[2:])
        y = stacked.y[rows, idx]
        start = _tree_map(lambda t: t[:, None].expand((B, W) + t.shape[1:])
                          .reshape((B * W,) + t.shape[1:]), params)
        self._log_call("eval", B * W, mb_cap)
        with torch.no_grad():
            logits = vmap(lambda p, xb: self.model.apply(p, xb, self.cfg.dtype))(start, x)
            preds = torch.softmax(logits.float(), dim=-1).reshape(B, W, mb_cap, -1)
            new_theta, y_flip = self.lflip_flip(preds, y, valid, theta, u)
        theta = torch.where(act[:, :, None, None] > 0, new_theta, theta)
        return theta, idx, y_flip

    # ------------------------------------------------------------------
    # epochs + early stopping
    # ------------------------------------------------------------------

    def _fedavg_epoch(self, state: TrainState, stacked, val: EvalSet,
                      coal: torch.Tensor, generators, streams, frozen,
                      coal_host=None) -> dict:
        """One FedAvg epoch of every run; returns the new params. Every
        partner pass of every run is one vmapped step over B*W models.

        Masked (`coal` [B, P] masks): W = P partners, the inactive ones
        trained on zeroed loss masks. Slots (`cfg.slot_count`, `coal`
        [B, K] ids): W = K slots, each bound to its partner's data, size
        and permutation (`_slot_binding`); a size-k coalition costs k
        passes. Either way each run draws the permutations of all P
        partners (or takes them from `streams`, [B, P, Nmax]), so a slot
        sees the rows its partner sees masked.

        lflip (masked only) first takes every partner's EM step on its
        minibatch window (`_lflip_windows`); its steps then read their rows
        and the drawn labels from that window. Updates `state.theta`.

        Partner faults (`cfg.faulted`) are gathered by each slot's partner
        id, so masks and slots share them: a dropped partner's activity is
        0 from its drop epoch on (`_drop_active`), a straggler's pass starts
        from `state.stale` row delay - 1 (the buffer is pushed after every
        aggregation), and a round with no survivor keeps the global params.
        The recorded delta stays local params - round-start global params.

        Partner-sharded (`cfg.partner_axis`): `stacked`, `coal` and the
        injected `streams` hold this rank's block of the row's partners;
        the dropout masks are keyed by global partner id and each round's
        aggregation reduces over the row, after an agreement point over it
        (`AxisGroup.agree`)."""
        cfg = self.cfg
        B, W = coal.shape
        P = stacked.x.shape[0]
        e = state.epoch
        gup = cfg.gradient_updates_per_pass
        dev = coal.device
        if cfg.slot_count is None:
            pids = torch.arange(P, device=dev).expand(B, P)
            act, used = coal, torch.ones_like(pids, dtype=torch.bool)
        else:
            pids, act, used = self._slot_binding(coal)
        if cfg.partner_drop_epochs is not None:
            act = act * self._drop_active(e, dev)[pids]
        # the global partner ids (partner-sharded: this rank's block of the
        # row's), which key the dropout masks
        gpids = pids if cfg.partner_axis is None else pids + cfg.partner_axis.index * P
        if cfg.partner_axis is not None and streams is None:
            raise ValueError("a partner-sharded trainer takes its draws whole, sliced to "
                             "its partners (parallel/partner_shard.py), not from its "
                             "generators")
        runs = torch.arange(B, device=dev)[:, None]
        stale = state.stale
        if stale is not None:
            delays = upload(torch.tensor(cfg.partner_straggler_delays), dev)[pids]
            late, stale_row = delays > 0, torch.clamp(delays - 1, min=0)   # [B, W]
        draws = self._draws(generators, _host_mask(stacked).expand(B, -1, -1), streams,
                            dev)
        perms = draws.perms[runs, pids]                            # [B, W, Nmax]
        sizes = stacked.sizes[pids]                                # [B, W]
        mb_cap = max(stacked.x.shape[1] // cfg.minibatch_count, 1)
        sb_cap = (mb_cap + gup - 1) // gup
        need_pval = cfg.record_partner_val or cfg.aggregator == "local-score"
        flat = lambda t: t.reshape((B * W,) + t.shape[2:])  # noqa: E731
        # dropout: keyed (1, mb, global partner id[, 7 for lflip's pass],
        # step), so a slot draws its partner's masks
        lflip_tag = (7,) if cfg.approach == "lflip" else ()

        def step_drop(mb_i: int, g: int):
            masks = self._step_masks(
                draws, sb_cap * cfg.step_width_mult, (1, mb_i, gpids) + lflip_tag + (g,),
                lambda m: m[:, mb_i][runs, pids][:, :, g])
            return tuple(flat(m) for m in masks)
        rows = pids[:, :, None]
        params = state.params
        theta = state.theta
        for mb_i in range(cfg.minibatch_count):
            with self._minibatch(mb_i):
                vl, va = self._maybe_val_eval(params, val, mb_i)
                _write(state.val_loss_h[:, e, mb_i], vl, frozen)
                _write(state.val_acc_h[:, e, mb_i], va, frozen)
                if cfg.approach == "lflip":
                    theta, w_idx, y_flip = self._lflip_windows(
                        params, theta, stacked, pids, perms, sizes, act, mb_i,
                        draws.flip_u[:, mb_i])

                def batches():
                    for g in range(cfg.pass_steps):
                        if cfg.approach == "lflip":
                            local, _, valid = self._step_rows(sizes, g, sb_cap)
                            local = torch.clamp(local, 0, mb_cap - 1)
                            x = stacked.x[rows, torch.gather(w_idx, 2, local)]
                            y = y_flip[runs[:, :, None], torch.arange(W, device=dev)[:, None],
                                       local]
                            valid = valid.float()
                        else:
                            idx, valid = self._subbatch(perms, sizes, mb_i, g, sb_cap)
                            x, y = stacked.x[rows, idx], stacked.y[rows, idx]
                        yield flat(x), flat(y), flat(valid * act[:, :, None]), step_drop(mb_i, g)
                start = _tree_map(lambda t: t[:, None].expand((B, W) + t.shape[1:]), params)
                if stale is not None:
                    old = _tree_map(lambda st: st[runs, stale_row], stale)
                    start = _tree_map(lambda o, n: torch.where(_rows(late, o), o, n), old, start)
                start = _tree_map(flat, start)
                new_flat, _, losses, accs = self._steps(
                    start, self.model.optimizer.init(start), batches(), columns=W)
                if need_pval and cfg.deterministic_reduce:
                    # a column's B models at a time, as their steps
                    cols = [self.evaluate_models(_tree_map(lambda t: _column(t, W, w), new_flat), val)
                            for w in range(W)]
                    pvl, pva = (torch.stack(ts, 1) for ts in zip(*cols))
                elif need_pval:
                    pvl, pva = (t.reshape(B, W) for t in self.evaluate_models(new_flat, val))
                else:
                    pvl = pva = torch.full((B, W), float("nan"), device=dev)
                # each used slot's metrics into its partner's history row: a
                # gather from the slot holding partner p (a partner sits in one
                # slot at most), kept where no used slot holds it
                view = state.partner_h[:, :, :, e, mb_i]
                vals = torch.stack([losses.reshape(B, W), accs.reshape(B, W), pvl, pva], 1)
                hit = (pids[:, :, None] == torch.arange(P, device=dev)) & used[:, :, None]
                src = torch.gather(vals, 2, hit.to(torch.uint8).argmax(1)[:, None, :]
                                   .expand(B, 4, P))
                _write(view, torch.where(hit.any(1)[:, None, :], src, view), frozen)
                new_params = _tree_map(lambda t: t.reshape((B, W) + t.shape[1:]), new_flat)
                if cfg.partner_axis is not None:
                    # the row's agreement point: a peer's failure in this round
                    # raises here, before its aggregation's collectives
                    cfg.partner_axis.agree()
                w = aggregation_weights(cfg.aggregator, act, sizes, torch.nan_to_num(pva),
                                        deterministic=cfg.deterministic_reduce,
                                        group=cfg.partner_axis)
                if cfg.record_updates:
                    r_idx = e * cfg.minibatch_count + mb_i
                    for g, d in new_params.items():
                        for k, t in d.items():
                            _write(state.upd_h[g][k][:, r_idx], t - params[g][k][:, None],
                                   frozen)
                    _write(state.w_h[:, r_idx], w, frozen)
                agg = aggregate(new_params, w, deterministic=cfg.deterministic_reduce,
                                group=cfg.partner_axis)
                if cfg.faulted:
                    agg = _keep_frozen(act.sum(1) == 0, params, agg)
                if stale is not None:
                    stale = _tree_map(lambda st, t: torch.cat([t[:, None], st[:, :-1]], 1),
                                      stale, params)
                params = agg
        if theta is not None:
            state.theta = _keep_frozen(frozen, state.theta, theta)
        if stale is not None:
            state.stale = _keep_frozen(frozen, state.stale, stale)
        return params

    def _seq_epoch(self, state: TrainState, stacked, val: EvalSet,
                   coal: torch.Tensor, generators, streams, frozen,
                   coal_host=None) -> dict:
        """One epoch of the seq family for every run; returns the new
        params. Per minibatch each run visits its W partner slots (masked:
        W = P, slots: W = K, as in `_fedavg_epoch`) in the order of its
        visit-order keys, gathered per slot from the full-width [P] draw,
        plus 1e3 for inactive partners and unused slots, so the members
        come first and in the same order either way. Visit position `pos`
        of every run is one vmapped pass over B models, each run on its
        own partner; a non-member visit changes nothing (`torch.where`), so
        the positions past the largest coalition are skipped. One optimizer
        state per run and minibatch is carried along the chain: a member
        at position pos follows pos member visits, so its steps count on
        from pos x `cfg.pass_steps`."""
        cfg = self.cfg
        B, W = coal.shape
        e = state.epoch
        gup = cfg.gradient_updates_per_pass
        dev = coal.device
        if cfg.slot_count is None:
            pids = torch.arange(W, device=dev).expand(B, W)
            act = coal
        else:
            pids, act, _ = self._slot_binding(coal)
        runs = torch.arange(B, device=dev)
        draws = self._draws(generators, _host_mask(stacked).expand(B, -1, -1), streams,
                            dev)
        perms = draws.perms[runs[:, None], pids]                   # [B, W, Nmax]
        sizes = stacked.sizes[pids]                                # [B, W]
        mb_cap = max(stacked.x.shape[1] // cfg.minibatch_count, 1)
        sb_cap = (mb_cap + gup - 1) // gup
        need_pval = cfg.record_partner_val or cfg.aggregator == "local-score"
        # the largest coalition, from the host's copy of the batch
        members = host_coalitions(coal, coal_host)
        members = members >= 0 if cfg.slot_count is not None else members > 0
        visits = int(members.sum(1).max())
        opt = self.model.optimizer
        params = state.params
        # each slot's params after its last visit, from the epoch start on
        stack = _tree_map(lambda t: t[:, None].expand((B, W) + t.shape[1:]).clone(),
                          params)
        nan = torch.full((B, W), float("nan"), device=dev)

        def aggregate_stack(pva_slot):
            w = aggregation_weights(cfg.aggregator, act, sizes, torch.nan_to_num(pva_slot),
                                    deterministic=cfg.deterministic_reduce)
            return aggregate(stack, w, deterministic=cfg.deterministic_reduce)

        for mb_i in range(cfg.minibatch_count):
            with self._minibatch(mb_i):
                vl, va = self._maybe_val_eval(params, val, mb_i,
                                              es_col=cfg.minibatch_count - 1)
                _write(state.val_loss_h[:, e, mb_i], vl, frozen)
                _write(state.val_acc_h[:, e, mb_i], va, frozen)
                keys = torch.gather(draws.order_keys[:, mb_i], 1, pids) + (1.0 - act) * 1e3
                order = torch.argsort(keys, dim=1, stable=True)        # [B, W] slots
                opt_state = opt.init(params)
                pva_slot = nan.clone()        # this minibatch's val accuracy a slot
                for pos in range(visits):
                    s = order[:, pos]                                  # [B]
                    pid = pids[runs, s]
                    on = act[runs, s] > 0
                    perm_s, size_s = perms[runs, s][:, None], sizes[runs, s][:, None]

                    def batches():
                        for g in range(cfg.pass_steps):
                            idx, valid = self._subbatch(perm_s, size_s, mb_i, g, sb_cap)
                            yield (stacked.x[pid[:, None], idx[:, 0]],
                                   stacked.y[pid[:, None], idx[:, 0]],
                                   valid[:, 0] * on[:, None],
                                   self._step_masks(draws, sb_cap * cfg.step_width_mult,
                                                    (1, mb_i, pos + 1, g),
                                                    lambda m: m[:, mb_i, pos, g]))
                    new_p, new_opt, loss, acc = self._steps(
                        params, {**opt_state, "count": pos * cfg.pass_steps}, batches())
                    params = _keep_frozen(~on, params, new_p)
                    opt_state = _keep_frozen_opt(~on, opt_state, new_opt)
                    # the visited slot's row of each run, kept where the visit
                    # was no member's
                    for g, d in stack.items():
                        for k, t in d.items():
                            t[runs, s] = _keep_frozen(~on, t[runs, s], params[g][k])
                    if need_pval:
                        pvl, pva = self.evaluate_models(params, val)
                    else:
                        pvl = pva = nan[:, 0]
                    view = state.partner_h[:, :, :, e, mb_i]
                    cells = view.clone()
                    cells[runs, :, pid] = _keep_frozen(~on, cells[runs, :, pid],
                                                       torch.stack([loss, acc, pvl, pva], 1))
                    _write(view, cells, frozen)
                    pva_slot[runs, s] = torch.where(on, pva, pva_slot[runs, s])
                if cfg.approach == "seqavg":
                    params = aggregate_stack(pva_slot)
        if cfg.approach == "seq-with-final-agg":
            # weighted by the last minibatch's val accuracies, as the masked
            # history's column MB-1
            params = aggregate_stack(pva_slot)
        return params

    def _single_epoch(self, state: TrainState, stacked, val: EvalSet,
                      masks: torch.Tensor, generators, streams, frozen,
                      coal_host=None) -> dict:
        """One epoch of single-partner training of every run:
        minibatch_count x gradient_updates_per_pass steps of its persistent
        optimizer over its lone active partner's shuffled rows, then a val
        eval
        (reference SinglePartnerLearning, multi_partner_learning.py:230-275).
        Updates the optimizer state; returns the new params."""
        cfg = self.cfg
        B = masks.shape[0]
        e = state.epoch
        p = torch.argmax(masks, dim=1)                 # the lone active partner
        x_p, y_p = stacked.x[p], stacked.y[p]          # [B, Nmax, ...]
        size_p = stacked.sizes[p]
        n_max = x_p.shape[1]
        p_host = torch.argmax(host_coalitions(masks, coal_host), dim=1)
        draws = self._draws(generators, _host_mask(stacked)[p_host], streams, masks.device)
        perm = draws.perms                             # [B, Nmax]
        steps = cfg.minibatch_count * cfg.gradient_updates_per_pass
        sb_cap = max((n_max + steps - 1) // steps, 1)
        sb = ((size_p + steps - 1) // steps)[:, None]
        ar = torch.arange(sb_cap, device=masks.device)[None, :]
        runs = torch.arange(B, device=masks.device)[:, None]

        gup = cfg.gradient_updates_per_pass

        def batches(mb_i: int):
            for g in range(mb_i * gup, (mb_i + 1) * gup):
                local = g * sb + ar
                valid = (ar < sb) & (local < size_p[:, None])
                idx = torch.gather(perm, 1, torch.clamp(local, 0, n_max - 1))
                # dropout: keyed (step + 1)
                yield (x_p[runs, idx], y_p[runs, idx], valid.float(),
                       self._step_masks(draws, sb_cap, (g + 1,), lambda m: m[:, g]))
        # the steps in minibatches of gup, the sums carried across them
        params, opt_state, sums = state.params, state.opt_state, None
        for mb_i in range(cfg.minibatch_count):
            with self._minibatch(mb_i):
                params, opt_state, sums = self._run_steps(params, opt_state, batches(mb_i),
                                                          sums=sums)
        loss, acc = self._means(sums)
        hold = frozen
        if cfg.partner_drop_epochs is not None:
            # from its drop epoch on the partner's solo training stops:
            # params and optimizer state are frozen (momentum would otherwise
            # coast on zero gradients), and the val eval below scores the
            # model it had. The step count is shared by the B runs; a run
            # held here never trains again, so it never reads it.
            dropped = self._drop_active(e, masks.device)[p] == 0
            params = _keep_frozen(dropped, state.params, params)
            hold = frozen | dropped
        state.opt_state = _keep_frozen_opt(hold, state.opt_state, opt_state)
        if cfg.record_val_history or cfg.is_early_stopping:
            vl, va = self.evaluate_models(params, val)
        else:
            vl = va = torch.full((B,), float("nan"), device=masks.device)
        _write(state.val_loss_h[:, e, 0], vl, frozen)
        _write(state.val_acc_h[:, e, 0], va, frozen)
        _write(state.partner_h[:, :, 0, e, 0], torch.stack([loss, acc, vl, va], 1), frozen)
        # Keras-style early-stopping bookkeeping
        improved = vl < state.best_val_loss
        state.best_val_loss = _keep_frozen(frozen, state.best_val_loss,
                                           torch.where(improved, vl, state.best_val_loss))
        state.es_wait = _keep_frozen(frozen, state.es_wait,
                                     torch.where(improved, 0, state.es_wait + 1))
        return params

    def _drop_active(self, e: int, device) -> torch.Tensor:
        """[P] activity under the dropout plan in (0-based) epoch e: 1.0
        while partner p has no drop epoch (0) or e + 1 is before it, else
        0.0. Exact factors, so a mask they multiply keeps its bits."""
        return upload(torch.tensor([float(d == 0 or e + 1 < d)
                                    for d in self.cfg.partner_drop_epochs]), device)

    def _early_stop_flag(self, state: TrainState) -> torch.Tensor:
        """[B]: the runs whose epoch `state.epoch` triggers early stopping."""
        cfg = self.cfg
        e = state.epoch
        if not cfg.is_early_stopping:
            return torch.zeros_like(state.done)
        if cfg.approach == "single":
            return state.es_wait >= cfg.patience
        if e < cfg.patience:
            return torch.zeros_like(state.done)
        col = cfg.minibatch_count - 1 if cfg.approach in SEQ_APPROACHES else 0
        return state.val_loss_h[:, e, col] > state.val_loss_h[:, e - cfg.patience, col]

    def run_epoch(self, state: TrainState, stacked, val: EvalSet, coal,
                  generators, streams=None, coal_host=None) -> TrainState:
        """One epoch of every run still training (`coal`: masks [B, P], or
        slot ids [B, slot_count] under `cfg.slot_count`); a run that has
        stopped is left unchanged. `streams` (an `EpochStreams`, or a
        permutation tensor [B, P, Nmax], or [B, Nmax] for 'single')
        replaces the generators' draws. `coal_host` is `coal`'s copy on the
        CPU (None: `coal` is read where the seq family and the single
        trainer need it)."""
        cfg = self.cfg
        if state.epoch >= cfg.epoch_count or (
                cfg.stops_early and bool(_host_read(state.done.all(), "stopped"))):
            return state
        frozen = state.done.clone()
        epoch_fn = (self._single_epoch if cfg.approach == "single" else
                    self._seq_epoch if cfg.approach in SEQ_APPROACHES else
                    self._fedavg_epoch)
        params = epoch_fn(state, stacked, val, coal, generators, streams, frozen,
                          coal_host)
        state.params = _keep_frozen(frozen, state.params, params)
        if cfg.approach == "lflip":
            _write(state.theta_h[:, state.epoch], state.theta, frozen)
        stop = self._early_stop_flag(state)
        state.epoch += 1
        state.nb_epochs_done = torch.where(frozen, state.nb_epochs_done,
                                           state.nb_epochs_done + 1)
        state.done = frozen | stop | (state.epoch >= cfg.epoch_count)
        return state

    def epoch_chunk(self, state: TrainState, stacked, val: EvalSet, coal,
                    generators, n_epochs: int, streams_all=None,
                    coal_host=None) -> TrainState:
        """Up to `n_epochs` epochs, ending once every run is done (early
        stopping, or epoch_count reached); `streams_all` (the streams of
        `run_epoch` with an epoch axis after B) replaces the generators'
        draws, `coal_host` is `run_epoch`'s."""
        if coal_host is None and (self.cfg.approach == "single"
                                  or self.cfg.approach in SEQ_APPROACHES):
            coal_host = host_coalitions(coal, None)   # one read for the chunk
        for i in range(n_epochs):
            self.run_epoch(state, stacked, val, coal, generators,
                           epoch_streams(streams_all, i), coal_host)
        return state

    def finalize(self, state: TrainState, test: EvalSet) -> tuple[torch.Tensor, torch.Tensor]:
        """([B] test_loss, [B] test_accuracy) of the final global models."""
        with obs_trace.span("trainer.finalize"):
            return self.evaluate_models(state.params, test)


def call_flops(model: Model, calls: list, x_like: torch.Tensor) -> float | None:
    """The FLOPs of a batch's logged calls (`MplTrainer.call_log`): each
    distinct (kind, models, rows) counted once a process (`_count_call`),
    rows shaped and typed as `x_like` [..., rows, features...]; a "grad"
    call is `_grads` (forward and backward), an "eval" call the model's
    forward. None when a call cannot be counted."""
    feat, dtype = tuple(x_like.shape[2:]), x_like.dtype
    total = 0.0
    for (kind, models, rows), n in collections.Counter(calls).items():
        try:
            one = _count_call(model, kind, rows, feat, dtype)
        except Exception as e:  # noqa: BLE001 - a count is optional
            logger.warning("FLOP count of a %s call of %s failed: %s", kind, model.name, e)
            return None
        if one is None:
            return None
        total += n * models * one
    return total


@functools.lru_cache(maxsize=None)
def _count_call(model: Model, kind: str, rows: int, feat: tuple,
                dtype: torch.dtype) -> float | None:
    """One model's call of `rows` rows, counted by `FlopCounterMode` on meta
    tensors (obs/devcost.py `count_flops`: no device work). A call of N
    models is N times it: every model of a call does the same work, and
    vmap runs the models' convolutions as one grouped convolution, whose
    backward the counter counts as if it were ungrouped (the weight
    gradient's count grows with the groups, the MNIST CNN's 2.5-fold at 6
    models)."""
    from ..obs import devcost
    tr = MplTrainer(model, TrainConfig(epoch_count=1, minibatch_count=1,
                                       gradient_updates_per_pass=1))
    meta = torch.device("meta")
    one = _tree_map(lambda t: t.to(meta)[None], model.init(torch.Generator().manual_seed(0)))
    L = model.label_dim()
    if kind == "grad":
        x = torch.empty((1, rows) + feat, dtype=dtype, device=meta)
        drop = tuple(torch.empty((1, rows) + s, dtype=torch.bool, device=meta)
                     for _, s in model.dropout)
        fn = lambda: tr._grads(one, x, torch.empty((1, rows, L), device=meta),  # noqa: E731
                               torch.empty((1, rows), device=meta), drop)
    else:
        x = torch.empty((rows,) + feat, dtype=dtype, device=meta)
        fn = lambda: tr._model_sums(one, x, torch.empty((rows, L), device=meta),  # noqa: E731
                                    torch.empty((rows,), device=meta))
    return devcost.count_flops(fn)[1]
