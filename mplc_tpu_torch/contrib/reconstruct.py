"""Retrain-free coalition reconstruction (GTG-Shapley, arXiv:2109.02053;
port of `mplc_tpu/contrib/reconstruct.py`).

During ONE grand-coalition FedAvg run, every aggregation round's
per-partner parameter delta and weight are recorded; any coalition S's
model is then rebuilt by replaying the recorded rounds restricted to S,

    M_S^r = M_S^{r-1} + sum_{p in S} w~_p^r delta_p^r,
    w~ = the recorded weights renormalized over S,

which the fused contraction K1 (ops/recon_kernel.py) does for a whole batch
of coalitions in one pass. v(S) then costs an evaluation, not a training
run. Reconstructed values live in the evaluator's own memo.

Observability (the JAX package's names, `obs/trace.py`): the recording is
a `recon.record` span holding one `engine.dispatch` (recording=True) and
followed by its `engine.batch` event; `ReconstructionEvaluator.evaluate` is
an `engine.evaluate` span (mode=reconstruct) holding, for each batch, an
`engine.prep`, an `engine.dispatch` (where K1 launches) and an
`engine.harvest` (the host read of the accuracies, the batch's one sync),
then an eval-only `engine.batch` event. Inside the dispatch the port's
own leaf spans (`obs/trace.py` `PORT_SPANS`) split the host's work into
`recon.reconstruct` (the flatten and K1 enqueued) and `recon.evaluate`
(`evaluate_models` enqueued); the stores after the harvest are an
`engine.record` span, whose seconds the batch event carries as
`record_s` beside `seconds` (its `dur`), and the hook an `engine.progress`
span. `recon.record` feeds `recon.record_seconds_total`. With the
engine's value ledger on
(MPLC_TORCH_NUMERICS_LEDGER), each reconstructed v(S) is recorded with
source "reconstruction" and the ledger saved after each `evaluate` that
reconstructed; each batch is noted eval-only on the engine's device meter.

The fault ladder (the engine's, contrib/engine.py): the recording is batch
ordinal 1 of its engine and retries transient failures (an OOM there
propagates: one grand-coalition run has no narrower width). Each
evaluator batch is a batch of the plan too: a transient failure at
dispatch or harvest retries it, an OOM at dispatch or harvest steps the
engine's cap down and runs the batch again at the halved width. Past
MPLC_TORCH_MAX_CAP_HALVINGS rungs a CUDA engine raises the classified
`LadderExhaustedError` (K1's work never moves to the CPU); a CPU engine
runs the remaining batches as its CPU rung, where an OOM propagates. The
width is the port's: chunks of RECON_BATCH
(64) coalitions, each padded to a power of two, the chunk halved by every
rung (`RECON_BATCH >> cap_halvings`). The JAX evaluator takes the
retraining engine's cap (16) instead; 64 keeps K1's widest coalition tile
(MT = 4) on the main path. A value does not depend on the width.

The live tier (live/game.py) swaps the stream under a resident game:
`reset_recorded` drops the memo and the old flattened stream, then
flattens the new one, so K = R*P varies across a live game's life (every
invalidating append adds P rows, zero-weight rounds are left out) and each
launch takes K from the stream's shape. A live game's rounds live on the
host as a list of rounds (`RecordedRun.host_rounds`); the evaluator
uploads each round's leaves into the flattened stream on the engine's
device, so the host never stacks or joins them. Its `use_bank` flag acquires each (rounds, width) program from the
engine's program bank (contrib/bank.py), bookkeeping only.

Precision: the evaluator answers for the engine's frozen mode. Under fp32
and mixed it reconstructs in fp32 (K1); under bf16 it keeps the flattened
stream in bf16 only and reconstructs through K1-bf16 (fp32 accumulation),
casting the models to bf16. Models are evaluated in the trainer's
`cfg.dtype`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import constants, faults
from ..mpl.engine import MplTrainer
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..ops import recon_kernel
from .engine import _bucket_size, _memo_counters, _release


def _check_not_2d(engine) -> None:
    """Fail fast: update recording and the 2-D coalition x partner mode are
    mutually exclusive (the recorded [rounds, partners, ...] stack needs
    the whole partner axis on one rank): an engine whose scenario runs
    `partner_shards > 1` (the 2-D mode, contrib/engine.py) cannot record."""
    if int(getattr(engine.scenario, "partner_shards", 1) or 1) > 1:
        raise ValueError(
            "update recording (retrain-free GTG-Shapley/SVARM, the live tier) is "
            "not supported in the 2-D partner-sharded mode (partner_shards > 1): "
            "the recorded per-partner update stack needs the whole partner axis "
            "on one device")


@dataclasses.dataclass
class RecordedRun:
    """One grand-coalition training's recorded update stream."""
    init_params: dict        # the run's initial global params
    deltas: dict | None      # leaves [R, P, ...]: per-round deltas (None:
    #                          `host_rounds` holds them)
    weights: torch.Tensor    # [R, P] normalized aggregation weights
    rounds: int              # R = epoch_count x minibatch_count
    partners_count: int
    epochs_done: int | None      # epochs trained (None: foreign recording)
    training_passes: int | None  # partner passes paid (None: likewise)
    memory_bytes: int        # recorded-update memory footprint
    final_params: dict | None = None   # the run's final global params
    # the live tier's form (live/game.py): the R rounds as a list of
    # per-round dicts of [P, ...] host leaves, flattened straight onto the
    # engine's device (`recon_kernel.flatten_rounds`), never stacked
    host_rounds: list | None = None

    def describe(self) -> dict:
        return {"rounds": self.rounds, "partners": self.partners_count,
                "epochs": self.epochs_done,
                "training_passes": self.training_passes,
                "memory_bytes": self.memory_bytes}


def record_updates(engine) -> RecordedRun:
    """Train the grand coalition once with update recording on, through
    the engine's coalition-training config (its partner faults included:
    a dropped partner records exact-zero deltas and weights) and the grand
    coalition's own random stream (that of its effective membership), and
    return the recorded stream. Its P models train at one width, so its
    steps keep one gradient call each (not `fixed_call_width`'s split).
    The recording is a batch of the fault
    plan: a transient failure retries it from a fresh generator (the same
    stream); an OOM propagates."""
    _check_not_2d(engine)
    cfg = dataclasses.replace(engine._multi_cfg, record_updates=True,
                              fixed_call_width=False)
    trainer = MplTrainer(engine.model, cfg)
    P = engine.partners_count
    full = tuple(range(P))
    eff = engine._effective_subset(full)
    if not eff:
        raise ValueError("every partner is dropped from epoch 1: there is no "
                         "grand-coalition run to record")
    mask = torch.from_numpy(engine._coalition_arrays([full])).to(engine.device)
    engine._batch_ordinal += 1
    ordinal = engine._batch_ordinal
    rounds = cfg.epoch_count * cfg.minibatch_count
    span = obs_trace.start_span("recon.record", partners=P, rounds=rounds)
    t0 = time.perf_counter()

    def dispatch():
        with obs_trace.span("engine.dispatch", width=1, slot_count=None,
                            coalitions=1, padding=0, recording=True):
            engine._faults.check("dispatch", ordinal)
            generators = [engine.coalition_generator(eff)]
            state = trainer.init_state(generators, P, engine.device)
            init_params = {g: {k: t[0].clone() for k, t in d.items()}
                           for g, d in state.params.items()}
            trainer.epoch_chunk(state, engine.stacked, engine.val, mask, generators,
                                cfg.epoch_count)
            return init_params, state

    try:
        init_params, state = engine._retry_transient(dispatch, "dispatch", ordinal)
    except BaseException:
        # dropped without emitting, so the caller's nesting stays intact
        span.cancel()
        raise
    run = state.row(0)
    epochs = run.nb_epochs_done
    mem = sum(t.numel() * t.element_size()
              for d in run.upd_h.values() for t in d.values())
    mem += run.w_h.numel() * run.w_h.element_size()
    rec = RecordedRun(init_params=init_params, deltas=run.upd_h,
                      weights=run.w_h, rounds=rounds,
                      partners_count=P, epochs_done=epochs,
                      training_passes=epochs * cfg.minibatch_count * P,
                      memory_bytes=mem, final_params=run.params)
    # the recording is training work: it owns every training counter of
    # the retrain-free path
    samples = epochs * int(engine._epoch_samples_multi[list(eff)].sum())
    seconds = time.perf_counter() - t0
    engine._account_batch(seconds,
                          {"width": 1, "slot_count": None, "coalitions": 1, "padding": 0},
                          epochs, samples, rec.training_passes, recording=True)
    if engine.device_meter is not None:
        engine.device_meter.note(1, span_sec=seconds)
    span.attrs.update(rec.describe())
    span.end()
    return rec


class ReconstructionEvaluator:
    """Memoizing, batching v(S) over reconstructed coalition models.

    The recorded stream is flattened to K1's layout once a stream (init
    [Dp], deltas [K = R*P, Dp], rows zero-padded to a multiple of 8 values,
    in the precision's stream dtype); a live game swaps streams with
    `reset_recorded`, so K varies across its life and every launch takes
    it from the stream's shape. Each batch of up to RECON_BATCH
    coalitions (halved by every rung of the engine's OOM ladder) is one
    kernel launch followed by a vmapped evaluation of the batch's models on
    the test set. Values are row-independent, so the batch width never
    changes them (on the card, up to the rounding of the evaluation's
    convolutions at another batch shape)."""

    # the live tier's flag: acquire each (rounds, width) program from the
    # engine's program bank (bookkeeping only; values do not change)
    use_bank = False

    def __init__(self, engine, recorded: RecordedRun | None = None):
        _check_not_2d(engine)
        self.engine = engine
        # the engine's frozen precision: every memoized value answers for it
        self.precision = engine._multi_cfg.precision
        self.recorded = recorded if recorded is not None else record_updates(engine)
        self.values: dict[tuple, float] = {(): 0.0}
        self.reconstructions = 0
        self._load_stream(self.recorded)

    def _load_stream(self, rec: RecordedRun) -> None:
        """Flatten `rec` to K1's layout on the engine's device, from its
        stacked deltas or a live game's host rounds, uploaded round by
        round into place."""
        R, P = rec.weights.shape
        dtype = recon_kernel.stream_dtype(self.precision)
        dev = self.engine.device
        if rec.deltas is None:
            self._init, self._d2, self._layout = recon_kernel.flatten_rounds(
                rec.init_params, rec.host_rounds, P, dtype, dev)
        else:
            self._init, self._d2, self._layout = recon_kernel.flatten_stream(
                rec.init_params, rec.deltas, R * P, dtype, dev)
        self._weights = rec.weights.float().to(dev)

    def reset_recorded(self, recorded: RecordedRun) -> None:
        """Swap in a new recorded stream (the live tier's round-stamp
        invalidation): the memo derives from the old stream and is dropped
        to {(): 0.0}; the old flattened stream is freed before the new one
        is built, so the device never holds both. The engine's ladder state
        (cap halvings) is kept."""
        self.recorded = None
        self._init = self._d2 = self._weights = None
        self.values = {(): 0.0}
        self.recorded = recorded
        self._load_stream(recorded)

    def reconstruct(self, masks: torch.Tensor) -> torch.Tensor:
        """[B, Dp] flat parameters of the coalitions `masks` [B, P], in the
        evaluator's precision (the tail past the layout's D is zeros)."""
        if self.use_bank and self.engine.program_bank is not None:
            self.engine.program_bank.acquire_recon(self, int(masks.shape[0]))
        return recon_kernel.reconstruct_flat(masks, self._init, self._d2,
                                             self._weights, self.precision)

    def _apply(self, masks: torch.Tensor) -> torch.Tensor:
        """Test accuracy of each reconstructed coalition model ([B]; `masks`
        on the host or on the engine's device)."""
        with obs_trace.span("recon.reconstruct", width=int(masks.shape[0])):
            masks = masks.to(self.engine.device)
            params = recon_kernel.unflatten(self.reconstruct(masks), self._layout)
        with obs_trace.span("recon.evaluate", width=int(masks.shape[0])), torch.no_grad():
            return self.engine.trainer.evaluate_models(params, self.engine.test)[1]

    def _chunk(self) -> int:
        """Coalitions a batch: RECON_BATCH, halved by every OOM rung."""
        return max(1, constants.RECON_BATCH >> self.engine._cap_halvings)

    def evaluate(self, subsets) -> np.ndarray:
        """Batched memoized reconstructed v(S); values in input order. A
        coalition whose every member is dropped from epoch 1 is worth 0,
        as in the engine (the JAX evaluator's rule): its recorded weights
        are all zero, so a replay would score the untrained model."""
        eng = self.engine
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        unique = dict.fromkeys(keys)
        missing = [k for k in unique if k not in self.values]
        n_requested_missing = len(missing)
        if eng._forever_dropped:
            for k in [k for k in missing if not eng._effective_subset(k)]:
                self.values[k] = 0.0
            missing = [k for k in missing if eng._effective_subset(k)]
            obs_metrics.counter("engine.null_coalitions").inc(
                n_requested_missing - len(missing))
        method = _memo_counters(len(unique) - n_requested_missing, len(missing))
        with obs_trace.span("engine.evaluate", requested=len(unique),
                            missing=len(missing), mode="reconstruct",
                            method=method):
            i = 0
            while i < len(missing):
                chunk = self._chunk()
                self._run_batch(missing[i:i + chunk])
                i += chunk
        if missing and eng.numerics_ledger is not None:
            # saved once a call that reconstructed, as the engine saves it
            eng.numerics_ledger.save()
        return np.array([self.values[k] for k in keys])

    def _run_batch(self, subsets: list[tuple]) -> None:
        """A chunk of coalitions, each batch padded to a power-of-two width
        with copies of its first coalition (so kernel shapes repeat), under
        the engine's ladder (the skeleton of `CharacteristicEngine._run_batch`):
        a transient failure retries the batch, an OOM at dispatch or at
        harvest steps the cap down and runs the batch again at the halved
        width (nothing of it was stored); past the last rung a CUDA engine
        raises `LadderExhaustedError` (`_degrade_cap`), and a CPU engine's
        batches run on as its CPU rung, whose own OOM propagates (the rung
        is the last)."""
        eng = self.engine
        n = len(subsets)

        def bucket_width() -> int:
            cap = self._chunk()
            return _bucket_size(min(n, cap), 1, cap)

        b = bucket_width()
        halvings_seen = eng._cap_halvings
        with obs_trace.span("engine.prep", coalitions=n, width=b, slot_count=None):
            masks_all = eng._coalition_arrays(subsets)
        i = 0
        while i < n:
            if eng._cap_halvings != halvings_seen:
                halvings_seen = eng._cap_halvings
                b = bucket_width()
            group = subsets[i:i + b]
            sel = np.full(b, i, np.intp)
            sel[:len(group)] = np.arange(i, i + len(group))
            eng._batch_ordinal += 1
            on_cpu = eng._cpu_degraded
            attrs = {"width": b, "slot_count": None, "coalitions": len(group),
                     "padding": b - len(group)}
            if on_cpu:
                attrs["degraded"] = "cpu"
            meta = {"t0": time.perf_counter(), "ordinal": eng._batch_ordinal}

            def dispatch(sel=sel, attrs=attrs, ordinal=eng._batch_ordinal):
                with obs_trace.span("engine.dispatch", **attrs, eval_only=True):
                    eng._faults.check("dispatch", ordinal)
                    accs = self._apply(torch.from_numpy(masks_all[sel]))
                    return lambda: accs.cpu().numpy()

            meta["redispatch"] = dispatch
            try:
                fetch = eng._retry_transient(dispatch, "dispatch", meta["ordinal"])
            except Exception as e:
                if not faults.is_oom(e) or on_cpu:
                    raise
                _release(e)
                eng._degrade_cap(e)
                continue
            i += len(group)
            try:
                with obs_trace.span("engine.harvest", width=b, slot_count=None,
                                    coalitions=len(group)):
                    accs = eng._fetch_with_retry(fetch, meta)
            except Exception as e:
                if not faults.is_oom(e) or on_cpu:
                    raise
                # nothing of this group was stored: rewind and run it again
                # at the degraded width
                _release(e)
                eng._degrade_cap(e)
                i -= len(group)
                continue
            with obs_trace.span("engine.record", phase="batch",
                                ordinal=meta["ordinal"]) as record:
                for s, acc in zip(group, accs[:len(group)].tolist()):
                    self.values[s] = float(acc)
                    if eng.numerics_ledger is not None:
                        # the engine's ledger, tagged by source, so a diff
                        # never mixes reconstructed values with retrained ones
                        eng.numerics_ledger.record(
                            s, float(acc), source="reconstruction", slot_width=None,
                            cap_halvings=eng._cap_halvings, degraded=on_cpu)
                self.reconstructions += len(group)
                obs_metrics.counter("engine.batches").inc()
                obs_metrics.counter("engine.reconstructions").inc(len(group))
                obs_metrics.histogram("engine.pad_waste_fraction").observe(
                    attrs["padding"] / b)
                if on_cpu:
                    obs_metrics.counter("engine.cpu_degraded_batches").inc()
                    obs_metrics.counter("engine.cpu_degraded_coalitions").inc(len(group))
            # eval-only: no epochs, samples or partner passes
            seconds = time.perf_counter() - meta["t0"]
            obs_trace.event("engine.batch", dur=seconds,
                            ordinal=meta["ordinal"], **attrs, epochs=0, samples=0,
                            partner_passes=0, eval_only=True, seconds=seconds,
                            record_s=record.duration)
            if eng.device_meter is not None:
                # neither fenced nor counted: eval-only batches bill at their
                # own host span, outside the fenced training rate
                with obs_trace.span("engine.record", phase="after", ordinal=meta["ordinal"]):
                    eng.device_meter.note(len(group), span_sec=seconds, eval_only=True)
            if eng.progress is not None:
                # the engine's per-batch hook (the sweep service's heartbeat,
                # journal and deadline): this batch is fully recorded, and
                # nothing else is in flight
                with obs_trace.span("engine.progress", ordinal=meta["ordinal"]):
                    eng.progress(len(group), n - i, None)
