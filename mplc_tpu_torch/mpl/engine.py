"""The multi-partner training engine, masked FedAvg (port of
`mplc_tpu/mpl/engine.py`).

Partners are a batch dimension: every partner's local pass is one
`torch.func.vmap` over `torch.func.grad_and_value` of the functional forward, on
parameters stacked `[P, ...]`. A coalition is a length-P 0/1 mask that
multiplies every per-sample loss mask (inactive partners get exactly-zero
gradients, hence exactly-zero Adam updates) and gates the aggregation
weights. Python loops take the place of the JAX package's `lax.scan`s.

Loop semantics kept from the JAX package:
  - a fresh optimizer for every partner pass;
  - per round (minibatch): global val eval (column 0), partner passes,
    aggregation weights, the recorded row (recording runs), aggregation;
  - early stopping compares val_loss[e, 0] with val_loss[e - patience, 0];
  - the remainder of n_p mod minibatch_count samples is dropped per epoch.

Randomness: each epoch's per-partner permutations are drawn from the
caller's `torch.Generator` (a CPU generator, so a run is the same on every
device), or injected through `streams` (the tests feed the JAX package's
permutations). The ported models have no dropout, so the permutations and
the initial parameters are the only randomness.

Precision (`TrainConfig.precision`): the model computes in `cfg.dtype`
(bf16 under `mixed` and `bf16`); parameters, Adam state, aggregation
weights and the recorded deltas stay float32 in every mode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import grad_and_value, vmap

from .. import constants
from ..models.core import Model
from ..ops.aggregation import AGGREGATOR_NAMES, aggregate, aggregation_weights, broadcast
from ..ops.metrics import masked_loss_and_metrics

APPROACH_NAMES = ("fedavg", "seq-pure", "seq-with-final-agg", "seqavg", "lflip", "single")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    approach: str = "fedavg"
    aggregator: str = "uniform"
    epoch_count: int = constants.DEFAULT_EPOCH_COUNT
    minibatch_count: int = constants.DEFAULT_BATCH_COUNT
    gradient_updates_per_pass: int = constants.DEFAULT_GRADIENT_UPDATES_PER_PASS_COUNT
    is_early_stopping: bool = True
    patience: int = constants.PATIENCE
    # per-partner val loss/acc after every round's local passes
    record_partner_val: bool = True
    # global val loss/acc at the start of EVERY minibatch; when off, only
    # the column early stopping reads (0) is evaluated, and none when early
    # stopping is off too
    record_val_history: bool = True
    # capture every round's per-partner parameter delta (local params -
    # round-start global params) and the normalized aggregation weights
    # actually applied: `upd_h` [R, P, ...] leaves and `w_h` [R, P],
    # R = epoch_count x minibatch_count (retrain-free contributivity)
    record_updates: bool = False
    # MPLC_TORCH_PRECISION mode (constants.py): fp32 | mixed | bf16. None
    # resolves it from the environment at construction; the resolved mode
    # is frozen into the config. mixed and bf16 compute the model in bf16;
    # parameters, Adam state, aggregation and the recorded stream stay
    # float32 in every mode.
    precision: str | None = None

    def __post_init__(self):
        if self.precision is None:
            object.__setattr__(self, "precision", constants.precision_mode())
        if self.precision not in constants.PRECISION_MODES:
            raise ValueError(f"precision must be one of "
                             f"{constants.PRECISION_MODES}, got {self.precision!r}")
        if self.approach != "fedavg":
            if self.approach in APPROACH_NAMES:
                raise NotImplementedError(
                    f"the '{self.approach}' approach is not ported yet "
                    "(ROADMAP.md queue 1, trainer variants)")
            raise KeyError(
                f"Multi-partner learning approach '{self.approach}' is not a valid "
                f"approach. List of supported approaches: {', '.join(APPROACH_NAMES)}")
        if self.aggregator not in AGGREGATOR_NAMES:
            raise KeyError(f"aggregation approach '{self.aggregator}' is not a "
                           f"valid approach. Supported: {AGGREGATOR_NAMES}")

    @property
    def dtype(self) -> torch.dtype:
        """The model compute dtype."""
        return torch.float32 if self.precision == "fp32" else torch.bfloat16


@dataclasses.dataclass
class TrainState:
    """One training run's carried state (mutated in place by the epochs)."""
    params: dict             # global model parameters
    val_loss_h: torch.Tensor  # [E, MB] global val loss history
    val_acc_h: torch.Tensor   # [E, MB]
    partner_h: torch.Tensor   # [4, P, E, MB]: loss, acc, val_loss, val_acc
    epoch: int = 0           # next epoch index
    done: bool = False       # early-stopped or finished
    nb_epochs_done: int = 0
    upd_h: dict | None = None        # [R, P, ...] recorded deltas
    w_h: torch.Tensor | None = None  # [R, P] recorded weights


class EvalSet(NamedTuple):
    x: torch.Tensor     # [n_chunks, chunk, ...]
    y: torch.Tensor     # [n_chunks, chunk, L]
    mask: torch.Tensor  # [n_chunks, chunk]


def _tree_map(fn, *trees) -> dict:
    return {g: {k: fn(*(t[g][k] for t in trees)) for k in trees[0][g]}
            for g in trees[0]}


class MplTrainer:
    """Masked FedAvg trainer for one (model, config) pair."""

    def __init__(self, model: Model, cfg: TrainConfig):
        self.model = model
        self.cfg = cfg
        self._partner_grads = vmap(grad_and_value(self._loss_fn, has_aux=True))
        self._model_sums = vmap(self._chunk_sums, in_dims=(0, None, None, None))

    # ------------------------------------------------------------------
    # state init
    # ------------------------------------------------------------------

    def init_state(self, generator: torch.Generator, partners_count: int,
                   device, init_params: dict | None = None) -> TrainState:
        cfg = self.cfg
        params = self.model.init(generator) if init_params is None else init_params
        params = _tree_map(lambda t: t.detach().to(device, torch.float32).clone(),
                           params)
        E, MB = cfg.epoch_count, cfg.minibatch_count
        nan = lambda *shape: torch.full(shape, float("nan"), device=device)  # noqa: E731
        state = TrainState(params=params, val_loss_h=nan(E, MB),
                           val_acc_h=nan(E, MB),
                           partner_h=nan(4, partners_count, E, MB))
        if cfg.record_updates:
            # rounds the run never reaches (early stopping) stay all-zero,
            # which reconstruction skips via its zero-denominator rule
            R = E * MB
            state.upd_h = _tree_map(
                lambda t: torch.zeros((R, partners_count) + t.shape, device=device),
                params)
            state.w_h = torch.zeros((R, partners_count), device=device)
        return state

    # ------------------------------------------------------------------
    # evaluation (chunked: bounded activation memory)
    # ------------------------------------------------------------------

    def _chunk_sums(self, params, x, y, m):
        logits = self.model.apply(params, x, self.cfg.dtype)
        loss, acc, cnt = masked_loss_and_metrics(self.model.loss_kind, logits, y, m)
        return loss * cnt, acc * cnt, cnt

    def evaluate(self, params: dict, ev: EvalSet) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean_loss, accuracy) of one model over a chunked eval set."""
        loss, acc = self.evaluate_models(broadcast(params, 1), ev)
        return loss[0], acc[0]

    def evaluate_models(self, params_b: dict, ev: EvalSet) -> tuple[torch.Tensor, torch.Tensor]:
        """([B] mean_loss, [B] accuracy) of B models stacked on a leading
        axis, vmapped over the models. Each eval chunk is cut so that
        models x rows in one forward stay within EVAL_ROWS_IN_FLIGHT."""
        B = next(iter(next(iter(params_b.values())).values())).shape[0]
        rows = max(1, constants.EVAL_ROWS_IN_FLIGHT // B)
        ls = cs = cnt = 0.0
        for cx, cy, cm in zip(ev.x, ev.y, ev.mask):
            for s in range(0, cx.shape[0], rows):
                l, a, c = self._model_sums(params_b, cx[s:s + rows],
                                           cy[s:s + rows], cm[s:s + rows])
                ls, cs, cnt = ls + l, cs + a, cnt + c
        denom = torch.clamp(cnt, min=1.0)
        return ls / denom, cs / denom

    def _maybe_val_eval(self, params: dict, val: EvalSet, mb_i: int):
        cfg = self.cfg
        if cfg.record_val_history or (cfg.is_early_stopping and mb_i == 0):
            return self.evaluate(params, val)
        return float("nan"), float("nan")

    # ------------------------------------------------------------------
    # data selection (static shapes, all partners at once)
    # ------------------------------------------------------------------

    def epoch_perms(self, generator: torch.Generator, mask_pn: torch.Tensor) -> torch.Tensor:
        """[P, Nmax] per-partner permutations, every partner's valid rows
        first, in random order (drawn on the CPU, moved to mask's device)."""
        mask = mask_pn.cpu()
        keys = torch.rand(mask.shape, generator=generator) + (1.0 - mask) * 1e9
        return torch.argsort(keys, dim=1, stable=True).to(mask_pn.device)

    def _subbatch(self, perms, sizes, mb_i: int, g: int, sb_cap: int):
        """Indices [P, sb_cap] + validity mask of gradient step g of
        minibatch mb_i, for every partner."""
        cfg = self.cfg
        mbc, gup = cfg.minibatch_count, cfg.gradient_updates_per_pass
        valid_mb = (sizes // mbc)[:, None]             # samples per minibatch
        sb = (valid_mb + gup - 1) // gup               # samples per step
        ar = torch.arange(sb_cap, device=perms.device)[None, :]
        local = g * sb + ar
        valid = (ar < sb) & (local < valid_mb)
        pos = torch.clamp(mb_i * valid_mb + local, 0, perms.shape[1] - 1)
        return torch.gather(perms, 1, pos), valid.float()

    # ------------------------------------------------------------------
    # one local pass of every partner over its minibatch (fresh optimizer)
    # ------------------------------------------------------------------

    def _loss_fn(self, params, x, y, m):
        logits = self.model.apply(params, x, self.cfg.dtype)
        loss, acc, cnt = masked_loss_and_metrics(self.model.loss_kind, logits, y, m)
        return loss, (acc, cnt)

    def _partner_pass(self, start_params: dict, stacked, perms, active,
                      mb_i: int):
        """Every partner's `gup` masked Adam steps on minibatch mb_i, from
        stacked start params [P, ...]. Returns (params [P, ...],
        pass_loss [P], pass_acc [P])."""
        cfg = self.cfg
        P, n_max = stacked.x.shape[0], stacked.x.shape[1]
        gup = cfg.gradient_updates_per_pass
        mb_cap = max(n_max // cfg.minibatch_count, 1)
        sb_cap = (mb_cap + gup - 1) // gup
        rows = torch.arange(P, device=perms.device)[:, None]
        opt = self.model.optimizer
        opt_state = opt.init(start_params)
        params = start_params
        loss_sum = acc_sum = cnt_sum = 0.0
        for g in range(gup):
            idx, valid = self._subbatch(perms, stacked.sizes, mb_i, g, sb_cap)
            m = valid * active[:, None]
            grads, (loss, (acc, cnt)) = self._partner_grads(
                params, stacked.x[rows, idx], stacked.y[rows, idx], m)
            params, opt_state = opt.step(params, grads, opt_state)
            loss_sum = loss_sum + loss * cnt
            acc_sum = acc_sum + acc * cnt
            cnt_sum = cnt_sum + cnt
        denom = torch.clamp(cnt_sum, min=1.0)
        return params, loss_sum / denom, acc_sum / denom

    # ------------------------------------------------------------------
    # epochs + early stopping
    # ------------------------------------------------------------------

    def _fedavg_epoch(self, state: TrainState, stacked, val: EvalSet,
                      coal_mask: torch.Tensor, generator: torch.Generator,
                      streams: torch.Tensor | None = None) -> None:
        cfg = self.cfg
        P = stacked.x.shape[0]
        e = state.epoch
        perms = (self.epoch_perms(generator, stacked.mask) if streams is None
                 else streams.to(stacked.mask.device, torch.int64))
        need_pval = cfg.record_partner_val or cfg.aggregator == "local-score"
        params = state.params
        for mb_i in range(cfg.minibatch_count):
            vl, va = self._maybe_val_eval(params, val, mb_i)
            state.val_loss_h[e, mb_i] = vl
            state.val_acc_h[e, mb_i] = va
            new_params, losses, accs = self._partner_pass(
                broadcast(params, P), stacked, perms, coal_mask, mb_i)
            if need_pval:
                pvl, pva = self.evaluate_models(new_params, val)
            else:
                pvl = pva = torch.full((P,), float("nan"), device=coal_mask.device)
            state.partner_h[:, :, e, mb_i] = torch.stack([losses, accs, pvl, pva])
            w = aggregation_weights(cfg.aggregator, coal_mask, stacked.sizes,
                                    torch.nan_to_num(pva))
            if cfg.record_updates:
                r_idx = e * cfg.minibatch_count + mb_i
                for g, d in new_params.items():
                    for k, t in d.items():
                        state.upd_h[g][k][r_idx] = t - params[g][k]
                state.w_h[r_idx] = w
            params = aggregate(new_params, w)
        state.params = params

    def _early_stop_flag(self, state: TrainState) -> bool:
        cfg = self.cfg
        e = state.epoch
        if not cfg.is_early_stopping or e < cfg.patience:
            return False
        return bool(state.val_loss_h[e, 0] > state.val_loss_h[e - cfg.patience, 0])

    def run_epoch(self, state: TrainState, stacked, val: EvalSet, coal_mask,
                  generator, streams=None) -> TrainState:
        """One epoch; an already stopped run is left unchanged."""
        if state.done:
            return state
        self._fedavg_epoch(state, stacked, val, coal_mask, generator, streams)
        stop = self._early_stop_flag(state)
        state.epoch += 1
        state.nb_epochs_done += 1
        state.done = stop or state.epoch >= self.cfg.epoch_count
        return state

    def epoch_chunk(self, state: TrainState, stacked, val: EvalSet, coal_mask,
                    generator, n_epochs: int, streams_all=None) -> TrainState:
        """Up to `n_epochs` epochs, stopping early once the run is done
        (early stopping, or epoch_count reached); `streams_all`
        ([n_epochs, P, Nmax] permutations) replaces the generator's draws."""
        for i in range(n_epochs):
            self.run_epoch(state, stacked, val, coal_mask, generator,
                           None if streams_all is None else streams_all[i])
        return state

    def finalize(self, state: TrainState, test: EvalSet) -> tuple[torch.Tensor, torch.Tensor]:
        """(test_loss, test_accuracy) of the final global model."""
        return self.evaluate(state.params, test)
