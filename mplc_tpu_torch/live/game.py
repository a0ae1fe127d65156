"""The live contributivity tier: resident incremental games (port of
`mplc_tpu/live/game.py`).

A `LiveGame` keeps a tenant's recorded per-partner update history (the
`upd_h`/`w_h` stream of contrib/reconstruct.py) resident, appends new
aggregation rounds as they happen, and answers `query(method=...)`, "what
is my Shapley value now", by reconstruction through K1 (ops/recon_kernel.py),
with no training ever (the engine's partner-pass counter and its
`engine.batch` events are all eval-only; tests/test_torch_live.py).

The round-stamp invalidation rule:

  - `append_round(deltas, weights)` appends one aggregation round
    (per-partner parameter deltas `{layer: {name: [P, ...]}}` and
    normalized weights `[P]`). A round with any non-zero weight is
    INVALIDATING: it advances the game's `round_stamp`, and every
    reconstruction-derived value (the evaluator's memo, cached query
    results) carries the stamp it was computed at and is recomputed on the
    next query. A round whose weights are all zero passes through the
    reconstruction unchanged (the zero-denominator rule), so it is
    NON-invalidating: journaled and counted resident, while memoized
    values survive it bit for bit.
  - The engine's retrained memo (`charac_fct_values`) is never touched by
    appends: a retrained v(S) does not depend on the recorded stream.

Durability: with a `journal_path` the game rides the checksummed WAL of
service/journal.py: one `live_init` record (the partners and model guard
and the replay-origin params) and one `live_round` record an append. The
encoding is the JAX package's byte for byte: leaves in sorted key order at
every level, each `[shape, "float32", values]`, so a WAL written by either
package restores in the other. A kill -> restart restores the game
bit-identically (floats round-trip exactly through JSON).

Residency: round stacks stay in host memory unless the process-wide
residency manager (live/residency.py, MPLC_TORCH_LIVE_MAX_RESIDENT) evicts
a cold journal-backed game down to a stub; the next touch restores it
through the replay a restart uses, so evict -> restore -> query is
bit-identical to never-evicted.

Execution: queries run through `ReconstructionEvaluator` (its batches,
ladder and span vocabulary), with `use_bank` set: each (rounds, width)
program is acquired from the engine's program bank, bookkeeping only (a
new engine gets a shared-scope bank, as the JAX game's does). The rounds
stay host numpy; when the stamp changes they are stacked once, without the
zero-weight rounds, and the evaluator frees the old device stream before
it uploads the new one, so the card holds one copy (K = 200 rows of the
MNIST CNN's 1.2 M parameters are 0.96 GB). DPVS pruning (live/dpvs.py,
MPLC_TORCH_LIVE_PRUNE_TAU) optionally collapses coalitions that differ
only by low-information partners onto one evaluated representative;
tau = 0 (default) is the exactness-preserving off switch.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from .. import constants
from ..contrib.reconstruct import RecordedRun, _check_not_2d
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..service.journal import SweepJournal
from . import residency
from .dpvs import PrunedReconstruction, _leaves, info_scores, low_information

logger = logging.getLogger("mplc_tpu_torch")

#: Methods `LiveGame.query` answers ("Shapley values" aliases "exact").
LIVE_METHODS = ("exact", "hierarchical", "GTG-Shapley", "SVARM")

# exact queries build the 2^P host table; past this partner count
# "hierarchical" (live/hierarchy.py) reuses the exact path over <= 16
# clusters, and the sampling methods have no bound
MAX_EXACT_PARTNERS = 16


class LiveGameFull(RuntimeError):
    """append_round past the resident-round cap (MPLC_TORCH_LIVE_MAX_ROUNDS):
    the game refuses to grow its reconstruction depth and journal without
    bound. Start a new game (or raise the cap): dropping history would
    change v(S). Carries a `retry_after_sec` backoff hint (0.0 = no
    estimate)."""

    def __init__(self, msg, retry_after_sec: float = 0.0):
        super().__init__(msg)
        self.retry_after_sec = float(retry_after_sec)


class LiveResidencyFull(LiveGameFull):
    """Residency admission refused: the process is at the
    MPLC_TORCH_LIVE_MAX_RESIDENT cap and no resident game is evictable
    (journal-less or busy). The `retry_after_sec` hint is the p50 of
    recent WAL-restore latencies (live/residency.py)."""


class LiveQueryResult:
    """One answered live query: the scores, the round-stamp they were
    computed at (a result whose stamp trails the game's `round_stamp` is
    stale and is never served), and the query's cost."""

    __slots__ = ("method", "scores", "stamp", "rounds", "seconds",
                 "evaluations", "pruned_coalitions", "prune_tau",
                 "low_info", "trust", "plan")

    def __init__(self, method, scores, stamp, rounds, seconds, evaluations,
                 pruned_coalitions, prune_tau, low_info, trust, plan=None):
        self.method = method
        self.scores = np.asarray(scores)
        self.stamp = int(stamp)
        self.rounds = int(rounds)
        self.seconds = float(seconds)
        self.evaluations = int(evaluations)
        self.pruned_coalitions = int(pruned_coalitions)
        self.prune_tau = float(prune_tau)
        self.low_info = tuple(low_info)
        self.trust = trust
        # the planner's QueryPlan of a method="auto" query (None for a
        # direct one): the concrete method and kwargs a replay runs
        self.plan = plan

    def describe(self) -> dict:
        d = {"method": self.method, "stamp": self.stamp,
             "rounds": self.rounds, "seconds": round(self.seconds, 6),
             "evaluations": self.evaluations,
             "pruned_coalitions": self.pruned_coalitions,
             "prune_tau": self.prune_tau,
             "scores": [float(x) for x in self.scores]}
        if self.plan is not None:
            d["plan"] = self.plan.describe()
        return d


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _map(fn, tree):
    """`fn` over a nested dict's leaves, its key order kept."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _structure(tree):
    """The nested key sets of a dict tree (leaves as None)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _encode_tree(tree) -> list:
    """A param dict's leaves as [[shape, dtype, flat values], ...], in
    sorted key order at every level, exactly as the JAX package encodes its
    pytree (floats round-trip exactly through JSON)."""
    out = []
    for leaf in _leaves(tree):
        a = _host(leaf)
        out.append([list(a.shape), str(a.dtype), a.ravel().tolist()])
    return out


def _decode_tree(doc: list, like: dict) -> dict:
    """The inverse of `_encode_tree` onto the structure of `like` (its key
    order kept, its leaves filled in sorted key order)."""
    leaves = iter([np.asarray(vals, dtype=np.dtype(dt)).reshape([int(d) for d in shape])
                   for shape, dt, vals in doc])
    if len(doc) != len(_leaves(like)):
        raise ValueError(f"a journaled tree has {len(doc)} leaves, the model "
                         f"{len(_leaves(like))}")

    def build(node):
        if not isinstance(node, dict):
            return next(leaves)
        out = dict.fromkeys(node)
        for k in sorted(node):
            out[k] = build(node[k])
        return out

    return build(like)


class LiveGame:
    """One tenant's resident incremental contributivity game."""

    def __init__(self, scenario, tenant: str = "tenant0",
                 journal_path=None, max_rounds: "int | None" = None,
                 engine=None):
        if engine is None:
            engine = getattr(scenario, "_charac_engine", None)
        if engine is None:
            from ..contrib.bank import ProgramBank, bank_enabled
            from ..contrib.engine import CharacteristicEngine
            engine = CharacteristicEngine(scenario)
            if bank_enabled():
                # shared-scope keys: a second tenant of the same shape, or
                # this game after a restart, records the same programs
                engine.program_bank = ProgramBank(engine, shared=True)
            scenario._charac_engine = engine
        elif getattr(scenario, "_charac_engine", None) is None:
            scenario._charac_engine = engine
        _check_not_2d(engine)
        self.engine = engine
        self.scenario = scenario
        self.tenant = str(tenant)
        self.max_rounds = (int(max_rounds) if max_rounds is not None
                           else constants._env_positive_int(
                               constants.LIVE_MAX_ROUNDS_ENV, 4096))
        # the replay origin: reconstruction replays rounds from exactly
        # these params. Drawn from the grand coalition's own stream, as
        # record_updates draws its run's initial params, unless a journal
        # restore below supplies the recorded origin
        self._init_params = self._derive_init_params()
        # resident history: [(deltas dict of np [P, ...], weights np [P])]
        self._rounds: list = []
        # advanced by every INVALIDATING append
        self.round_stamp = 0
        self.queries = 0
        self._recon = None
        self._recon_stamp = -1
        self._results: dict = {}
        self._info_cache = None  # ((stamp, rounds resident), scores)
        # residency: an evicted game keeps only (round_stamp, rounds),
        # checked on restore
        self._evicted = False
        self._evicted_state = (0, 0)
        self.last_restore_s = 0.0
        # one game, one serialized surface: the evaluator, the memo and
        # the stamp move together
        self._lock = threading.RLock()

        self._journal = None
        if journal_path is not None:
            records, _torn = SweepJournal.replay(journal_path)
            restored = self._restore(records)
            self._journal = SweepJournal(journal_path)
            if not restored:
                self._journal.append({
                    "type": "live_init", "tenant": self.tenant,
                    "partners_count": int(engine.partners_count),
                    "model": getattr(engine.model, "name", "?"),
                    "params": _encode_tree(self._init_params)})
        # residency admission: past the cap this evicts the coldest
        # journal-backed game, or refuses this one (LiveResidencyFull)
        try:
            residency.admit(self)
        except BaseException:
            self.close()
            raise
        self._set_gauges()

    # -- construction helpers -------------------------------------------

    def _derive_init_params(self) -> dict:
        """The grand coalition's initial params as host float32 arrays: the
        first draw of its generator (that of its effective membership),
        which is what `record_updates` trains from."""
        eng = self.engine
        full = tuple(range(eng.partners_count))
        eff = eng._effective_subset(full)
        params = eng.model.init(eng.coalition_generator(eff if eff else full))
        return _map(lambda t: t.detach().float().cpu().numpy(), params)

    @classmethod
    def from_recording(cls, scenario, **kw) -> "LiveGame":
        """Seed a live game from one grand-coalition recording
        (contrib/reconstruct.record_updates): the recorded rounds become the
        game's resident history, which `append_round` then extends. The
        recording is the only training the game ever pays."""
        game = cls(scenario, **kw)
        if game.rounds_resident:
            # a journal restore already holds the history
            return game
        from ..contrib.reconstruct import record_updates
        rec = record_updates(game.engine)
        deltas = _map(_host, rec.deltas)
        weights = _host(rec.weights)
        with game._lock:
            # one durability point for the whole recording
            game._append_rounds([(_map(lambda a, _r=r: a[_r], deltas), weights[r])
                                 for r in range(rec.rounds)])
        return game

    def _restore(self, records) -> bool:
        """Replay a journal's live records into this game. True when a
        `live_init` record was found (the journal owns the game's
        identity)."""
        inited = False
        rounds = 0
        for rec in records:
            kind = rec.get("type")
            if kind == "live_init":
                jp = rec.get("partners_count")
                if jp is not None and int(jp) != self.engine.partners_count:
                    raise ValueError(
                        f"live journal was recorded for {jp} partners but "
                        f"this game has {self.engine.partners_count} — "
                        "refusing to restore a different game's history")
                jm = rec.get("model")
                ours = getattr(self.engine.model, "name", "?")
                if jm is not None and jm != ours:
                    raise ValueError(
                        f"live journal was recorded for model {jm!r} but "
                        f"this game trains {ours!r} — refusing to restore "
                        "a different game's history")
                self._init_params = _decode_tree(rec["params"], self._init_params)
                inited = True
            elif kind == "live_round":
                deltas = _decode_tree(rec["deltas"], self._init_params)
                weights = np.asarray(rec["weights"], np.float32)
                self._rounds.append((deltas, weights))
                if np.any(weights != 0):
                    self.round_stamp += 1
                rounds += 1
        if rounds:
            obs_metrics.counter("live.games_recovered").inc()
            obs_trace.event("live.recover", tenant=self.tenant,
                            rounds=rounds, stamp=self.round_stamp)
        return inited

    # -- the incremental surface ----------------------------------------

    @property
    def rounds_resident(self) -> int:
        return len(self._rounds)

    def round_history(self) -> list:
        """The resident `(deltas, weights)` rounds in append order (host
        arrays). Restores an evicted game first."""
        with self._lock:
            self._ensure_resident()
            return list(self._rounds)

    def _set_gauges(self) -> None:
        obs_metrics.gauge("live.rounds_resident",
                          tenant=self.tenant).set(len(self._rounds))

    # -- residency (live/residency.py calls in; queries call out) --------

    @property
    def resident(self) -> bool:
        return not self._evicted

    def evict(self) -> bool:
        """Evict this game's round stack (and its evaluator and memo) down to
        a stub. Only journal-backed games are evictable: the next touch
        restores from the WAL bit-identically. False (still resident)
        without a journal."""
        with self._lock:
            return self._evict_locked()

    def _evict_locked(self) -> bool:
        if self._journal is None or self._evicted:
            return False
        rounds = len(self._rounds)
        self._evicted_state = (self.round_stamp, rounds)
        self._rounds = []
        self._recon = None
        self._recon_stamp = -1
        self._results = {}
        self._info_cache = None
        self._evicted = True
        residency.note_evicted(self)
        obs_metrics.counter("live.evictions").inc()
        obs_trace.event("live.evict", tenant=self.tenant, rounds=rounds,
                        stamp=self.round_stamp)
        self._set_gauges()
        return True

    def _ensure_resident(self) -> None:
        """Restore an evicted game's round stack from its WAL (the replay a
        restart uses) before any read or append; LRU-bump otherwise. The
        caller holds the lock."""
        if not self._evicted:
            residency.touch(self)
            return
        # admission first: a refusal leaves the stub intact
        residency.admit(self)
        t0 = time.perf_counter()
        records, _torn = SweepJournal.replay(self._journal.path)
        saved_stamp, saved_rounds = self._evicted_state
        self.round_stamp = 0
        self._restore(records)
        if (self.round_stamp, len(self._rounds)) != (saved_stamp, saved_rounds):
            raise RuntimeError(
                f"live game {self.tenant!r} restored to "
                f"(stamp={self.round_stamp}, rounds={len(self._rounds)}) "
                f"but was evicted at (stamp={saved_stamp}, "
                f"rounds={saved_rounds}) — the WAL and the stub disagree")
        self._evicted = False
        self.last_restore_s = time.perf_counter() - t0
        residency.note_restore(self.last_restore_s)
        obs_metrics.counter("live.restores").inc()
        obs_trace.event("live.restore", tenant=self.tenant,
                        rounds=len(self._rounds), stamp=self.round_stamp,
                        restore_s=round(self.last_restore_s, 6))
        self._set_gauges()

    def append_round(self, deltas, weights) -> int:
        """Append one aggregation round's per-partner deltas (a dict shaped
        as the model's params, leaves `[P, ...]`, numpy or tensors) and
        normalized weights (`[P]`). Returns the round-stamp after the
        append: unchanged for a non-invalidating (all-zero-weight) round.
        The round is journaled (fsync'd) before any in-memory state
        changes."""
        with self._lock:
            return self._append_rounds([(deltas, weights)])

    def _normalize_round(self, deltas, weights):
        """Validate one round's shapes and bring it to host arrays."""
        P = self.engine.partners_count
        w = np.asarray(_host(weights), np.float32).reshape(P)
        if not isinstance(deltas, dict) or _structure(deltas) != _structure(self._init_params):
            raise ValueError("append_round deltas do not match the model's "
                             "parameter structure")
        d = _map(_host, deltas)
        for leaf, ref in zip(_leaves(d), _leaves(self._init_params)):
            if leaf.shape != (P,) + ref.shape:
                raise ValueError(
                    f"append_round delta leaf has shape {leaf.shape}, "
                    f"expected {(P,) + ref.shape} (a [partners, ...] stack "
                    "of per-partner parameter deltas)")
        return d, w

    def _append_rounds(self, rounds) -> int:
        """Append a batch of rounds with ONE journal durability point
        (`append_many`). The caller holds the lock."""
        self._ensure_resident()
        if len(self._rounds) + len(rounds) > self.max_rounds:
            raise LiveGameFull(
                f"live game for tenant {self.tenant!r} holds "
                f"{len(self._rounds)} resident rounds and was asked for "
                f"{len(rounds)} more — the {constants.LIVE_MAX_ROUNDS_ENV} "
                f"cap ({self.max_rounds}); dropping history would change "
                "v(S), so start a new game or raise the cap")
        normalized = [self._normalize_round(d, w) for d, w in rounds]
        if self._journal is not None:
            self._journal.append_many([
                {"type": "live_round", "tenant": self.tenant,
                 "seq": len(self._rounds) + 1 + i,
                 "weights": [float(x) for x in w],
                 "deltas": _encode_tree(d)}
                for i, (d, w) in enumerate(normalized)])
        for d, w in normalized:
            self._rounds.append((d, w))
            invalidating = bool(np.any(w != 0))
            if invalidating:
                self.round_stamp += 1
            obs_metrics.counter("live.rounds_appended").inc()
            obs_trace.event("live.append", tenant=self.tenant,
                            seq=len(self._rounds), stamp=self.round_stamp,
                            invalidating=invalidating)
        self._set_gauges()
        return self.round_stamp

    # -- reconstruction plumbing ----------------------------------------

    def _build_recorded(self) -> RecordedRun:
        """The resident history as a host `RecordedRun` of its rounds
        (`host_rounds`, the resident arrays themselves: the evaluator
        uploads them into its flattened stream, and nothing is stacked
        here). Zero-weight rounds are left out (the replay passes through
        them unchanged), so a restored game and the live game that skipped
        them reconstruct bit-identically."""
        P = self.engine.partners_count
        live = [(d, w) for d, w in self._rounds if np.any(w != 0)]
        weights = torch.from_numpy(np.stack([w for _, w in live]) if live
                                   else np.zeros((0, P), np.float32))
        init = _map(torch.from_numpy, self._init_params)
        mem = (sum(a.nbytes for d, _ in live for a in _leaves(d))
               + weights.numel() * weights.element_size())
        return RecordedRun(init_params=init, deltas=None, weights=weights,
                           rounds=len(live), partners_count=P, epochs_done=0,
                           training_passes=0, memory_bytes=mem,
                           host_rounds=[d for d, _ in live])

    def _evaluator(self):
        """The game's round-stamped reconstruction evaluator. A stale stamp
        swaps the stream in place (`reset_recorded`: the memo derives from
        the old stream and is dropped)."""
        from ..contrib.reconstruct import ReconstructionEvaluator
        if self._recon is None:
            self._recon = ReconstructionEvaluator(self.engine, recorded=self._build_recorded())
            self._recon.use_bank = True
            self._recon_stamp = self.round_stamp
        elif self._recon_stamp != self.round_stamp:
            self._recon.reset_recorded(self._build_recorded())
            self._recon_stamp = self.round_stamp
        return self._recon

    def _info_scores(self) -> np.ndarray:
        key = (self.round_stamp, len(self._rounds))
        if self._info_cache is None or self._info_cache[0] != key:
            self._info_cache = (key, info_scores(self._rounds, self.engine.partners_count))
        return self._info_cache[1]

    # -- queries ---------------------------------------------------------

    def query(self, method: str = "GTG-Shapley", prune: "float | None" = None,
              accuracy_target: "float | None" = None,
              deadline_sec: "float | None" = None,
              **method_kw) -> LiveQueryResult:
        """Answer a contributivity query from the resident game.

        `method`: "exact" (the reconstructed powerset and exact Shapley;
        at most 16 partners), "hierarchical" (grouped Shapley over DPVS
        clusters, live/hierarchy.py; `clusters`/`cluster_tau` kwargs),
        "GTG-Shapley" or "SVARM" (their kwargs pass through), or "auto":
        the planner (contrib/planner.py, its live rungs) resolves (game
        size, `accuracy_target`, `deadline_sec`) to a concrete method and
        pruning tau; the plan rides the result (`result.plan`) and a
        `live.plan` event, and the plan alone determines the query (its
        tau wins over the env default). `prune` is the DPVS tau (None: the
        MPLC_TORCH_LIVE_PRUNE_TAU default, 0 = off). Results are memoized
        per (method, tau, precision, kwargs) and served without any device
        work while the round-stamp is unchanged; a stale result is never
        served. Queries and appends on one game are serialized by its
        lock."""
        with self._lock:
            return self._query_locked(method, prune, method_kw,
                                      accuracy_target, deadline_sec)

    def _query_locked(self, method: str, prune: "float | None", method_kw: dict,
                      accuracy_target: "float | None" = None,
                      deadline_sec: "float | None" = None) -> LiveQueryResult:
        self._ensure_resident()
        if method == "Shapley values":
            method = "exact"
        plan = None
        if method == "auto":
            from ..contrib.planner import estimate_eval_seconds, plan_query
            eval_sec, basis = estimate_eval_seconds(self.engine)
            plan = plan_query(self.engine.partners_count, accuracy_target,
                              deadline_sec, eval_sec=eval_sec,
                              cost_basis=basis, live=True)
            method = plan.method
            # the plan fully determines the query: its tau wins even at 0
            prune = plan.prune_tau
            method_kw = {**plan.method_kw, **method_kw}
            obs_trace.event("live.plan", tenant=self.tenant, **plan.describe())
        if method not in LIVE_METHODS:
            raise ValueError(f"unknown live query method {method!r} (expected one "
                             f"of {LIVE_METHODS})")
        # tau lives in [0, 1]: past 1 even the top partner would prune. An
        # explicit argument fails fast; the env knob warns and turns
        # pruning off
        if prune is None:
            tau = constants._env_nonneg_float(constants.LIVE_PRUNE_TAU_ENV, 0.0)
            if tau > 1.0:
                import warnings
                warnings.warn(f"{constants.LIVE_PRUNE_TAU_ENV}={tau} is outside "
                              "[0, 1]; pruning disabled for this query", stacklevel=3)
                tau = 0.0
        else:
            tau = float(prune)
            if not 0.0 <= tau <= 1.0:
                raise ValueError(f"prune tau must be in [0, 1], got {tau}")
        n = self.engine.partners_count
        # the precision mode keys the memo: a journal-restored game may be
        # reopened under another MPLC_TORCH_PRECISION, and a bf16 answer
        # must never serve an fp32 query
        precision = self.engine._multi_cfg.precision
        key = (method, tau, precision, tuple(sorted(method_kw.items())))
        span = obs_trace.start_span(
            "live.query", tenant=self.tenant, method=method,
            rounds=self.rounds_resident, stamp=self.round_stamp, prune_tau=tau)
        try:
            cached = self._results.get(key)
            if cached is not None and cached.stamp == self.round_stamp:
                if plan is not None and cached.plan is None:
                    # an auto query hitting an earlier direct query of the
                    # same concrete (method, tau, kwargs)
                    cached.plan = plan
                obs_metrics.counter("live.queries").inc()
                obs_metrics.counter("live.query_memo_hits").inc()
                span.attrs.update(memo_hit=True, evaluations=0, pruned=0)
                span.end()
                obs_metrics.histogram("live.query_sec",
                                      tenant=self.tenant).observe(span.duration)
                return cached
            recon = self._evaluator()
            before = recon.reconstructions
            low: frozenset = frozenset()
            ev = recon
            if tau > 0:
                low = low_information(self._info_scores(), tau)
                if low:
                    ev = PrunedReconstruction(recon, low)
            trust = None
            t0 = time.perf_counter()
            if method == "exact":
                if n > MAX_EXACT_PARTNERS:
                    raise ValueError(
                        f"live exact queries are limited to {MAX_EXACT_PARTNERS} "
                        f"partners (the 2^P host table; this game has {n}) — use "
                        "hierarchical, GTG-Shapley or SVARM")
                from ..contrib.shapley import powerset_order, shapley_from_characteristic
                ev.evaluate(powerset_order(n))
                scores = np.asarray(shapley_from_characteristic(n, ev.values))
            elif method == "hierarchical":
                from .hierarchy import hierarchical_shapley
                scores, hdetail = hierarchical_shapley(ev, n, self._info_scores(), **method_kw)
                span.attrs.update(clusters=len(hdetail["clusters"]),
                                  proportional_splits=hdetail["proportional_splits"])
            else:
                from ..contrib.contributivity import Contributivity
                eng = self.engine
                prev = getattr(eng, "_reconstruction", None)
                eng._reconstruction = ev
                try:
                    c = Contributivity(self.scenario)
                    if method == "GTG-Shapley":
                        c.GTG_Shapley(**method_kw)
                    else:
                        c.SVARM(**method_kw)
                finally:
                    eng._reconstruction = prev
                scores = np.asarray(c.contributivity_scores)
                trust = c.trust
            seconds = time.perf_counter() - t0
            evals = recon.reconstructions - before
            pruned = ev.pruned if isinstance(ev, PrunedReconstruction) else 0
            result = LiveQueryResult(
                method=method, scores=scores, stamp=self.round_stamp,
                rounds=self.rounds_resident, seconds=seconds, evaluations=evals,
                pruned_coalitions=pruned, prune_tau=tau, low_info=sorted(low),
                trust=trust, plan=plan)
            self._results[key] = result
            self.queries += 1
            obs_metrics.counter("live.queries").inc()
            obs_metrics.counter("live.coalition_evaluations").inc(evals)
            span.attrs.update(memo_hit=False, evaluations=evals, pruned=pruned,
                              low_info=len(low))
            span.end()
            obs_metrics.histogram("live.query_sec", tenant=self.tenant).observe(span.duration)
            return result
        except BaseException:
            span.cancel()
            raise

    # -- observability / lifecycle --------------------------------------

    def describe(self) -> dict:
        """The game's state (JSON-serializable); never triggers a restore."""
        return {
            "tenant": self.tenant,
            "rounds_resident": self.rounds_resident,
            "round_stamp": self.round_stamp,
            "queries": self.queries,
            "results_cached": len(self._results),
            "max_rounds": self.max_rounds,
            "journal": self._journal.path if self._journal else None,
            "resident": self.resident,
            "last_restore_s": round(self.last_restore_s, 6),
        }

    def close(self) -> None:
        residency.forget(self)
        if self._journal is not None:
            self._journal.close()
