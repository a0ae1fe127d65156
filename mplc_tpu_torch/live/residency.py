"""Bounded residency for the live tier (port of
`mplc_tpu/live/residency.py`).

The process-wide residency manager: at most MPLC_TORCH_LIVE_MAX_RESIDENT
games hold their round stacks (and derived evaluator and memo state) in
memory at once. Past the cap, the least recently used JOURNALED game is
evicted down to a stub; its WAL journals every round exactly, so the next
touch restores it through the `live.recover` replay path. Eviction is a
latency tier, not a correctness change: evict -> restore -> query is
bit-identical to never-evicted (tests/test_torch_live_residency.py).

Admission rules:

  - `admit(game)` makes a game resident (new games at construction,
    evicted games before their WAL replay) and bumps already-resident
    games to most recently used. It is called under the game's own lock.
  - Only journal-backed, idle games are evictable: a victim's lock is
    acquired without blocking, so a game mid-query or mid-append is
    skipped (never stalled) and the next candidate is tried.
  - When the cap cannot be met for a game that is not yet resident (every
    candidate is journal-less or busy), admission refuses with
    `LiveResidencyFull`, carrying a `retry_after_sec` hint (the
    nearest-rank p50 of recent WAL-restore latencies, 0.0 with none). An
    already-resident game is never refused: the cap throttles growth.

The cap is read from the environment at every admission decision (0 or
unset: unbounded), with a `configure(max_resident=...)` override for
scripts and tests. Games are tracked by weak reference, so a dropped game
leaves the books on the next scan.
"""

from __future__ import annotations

import collections
import threading
import weakref

from .. import constants
from ..obs import metrics as obs_metrics

_lock = threading.RLock()
#: LRU of resident games: id(game) -> weakref (leftmost = coldest)
_resident: "collections.OrderedDict[int, weakref.ref]" = \
    collections.OrderedDict()
#: currently-evicted games (stubs awaiting a restore): id -> weakref
_evicted: "dict[int, weakref.ref]" = {}
#: recent WAL-restore wall-clock latencies, the retry_after_sec basis
_restore_window: collections.deque = collections.deque(maxlen=64)
_totals = {"evictions": 0, "restores": 0, "last_restore_s": 0.0}
#: the scripts' and tests' override of the cap (None = read the env knob)
_max_override: "list[int | None]" = [None]


def configure(max_resident: "int | None") -> None:
    """Override the residency cap (scripts and tests); None restores the
    MPLC_TORCH_LIVE_MAX_RESIDENT env read."""
    with _lock:
        _max_override[0] = (None if max_resident is None
                            else int(max_resident))


def reset() -> None:
    """Drop all residency bookkeeping and the cap override (test
    isolation). Games themselves are untouched — still-alive resident
    games re-enter the books on their next touch."""
    with _lock:
        _resident.clear()
        _evicted.clear()
        _restore_window.clear()
        _totals.update(evictions=0, restores=0, last_restore_s=0.0)
        _max_override[0] = None


def max_resident() -> int:
    """The current cap (0 = unbounded)."""
    with _lock:
        if _max_override[0] is not None:
            return _max_override[0]
    return constants._env_nonneg_int(constants.LIVE_MAX_RESIDENT_ENV, 0)


def retry_after_sec() -> float:
    """Backoff hint for residency refusals: the p50 of recent
    WAL-restore latencies (nearest-rank, the JAX admission controller's
    convention), 0.0 with no restore history."""
    with _lock:
        waits = sorted(_restore_window)
    if not waits:
        return 0.0
    idx = max(0, (len(waits) + 1) // 2 - 1)
    return float(waits[idx])


def _prune_dead() -> None:
    """Drop entries whose game was garbage-collected. Caller holds
    `_lock`."""
    for gid in [g for g, ref in _resident.items() if ref() is None]:
        del _resident[gid]
    for gid in [g for g, ref in _evicted.items() if ref() is None]:
        del _evicted[gid]


def _evict_one(exclude_id: int) -> bool:
    """Evict the least-recently-used evictable game (journal-backed and
    idle — its lock must be acquirable without blocking). Caller holds
    `_lock`. Returns False when no candidate qualifies."""
    for gid in list(_resident):
        if gid == exclude_id:
            continue
        game = _resident[gid]()
        if game is None:
            del _resident[gid]
            continue
        if game._journal is None:
            continue
        if not game._lock.acquire(blocking=False):
            continue  # mid-query/append: skip, never stall a live tenant
        try:
            if game._evict_locked():  # books updated via note_evicted
                return True
        finally:
            game._lock.release()
    return False


def note_evicted(game) -> None:
    """Record one eviction (called by `LiveGame._evict_locked`, whether
    manager-driven or operator/test-driven)."""
    with _lock:
        gid = id(game)
        _resident.pop(gid, None)
        _evicted[gid] = weakref.ref(game)
        _totals["evictions"] += 1
        _set_gauges()


def admit(game) -> None:
    """Make `game` resident (or bump it to most-recently-used), evicting
    LRU victims past the cap. Raises `LiveResidencyFull` only when the
    game is not yet resident and no victim can be evicted. Called under
    the game's own lock."""
    cap = max_resident()
    with _lock:
        _prune_dead()
        gid = id(game)
        was_resident = gid in _resident
        _evicted.pop(gid, None)
        _resident[gid] = weakref.ref(game)
        _resident.move_to_end(gid)
        while cap and len(_resident) > cap:
            if _evict_one(gid):
                continue
            if was_resident:
                break  # cap throttles growth, never bricks a live tenant
            del _resident[gid]
            from .game import LiveResidencyFull
            raise LiveResidencyFull(
                f"live residency is at the {constants.LIVE_MAX_RESIDENT_ENV} "
                f"cap ({cap} resident games) and no game is evictable "
                "(journal-less games cannot be evicted without losing "
                "history; busy games are never stalled) — retry, close a "
                "game, or raise the cap",
                retry_after_sec=retry_after_sec())
        _set_gauges()


def touch(game) -> None:
    """LRU-bump a resident game (every append/query). Equivalent to
    `admit` but named for the hot path."""
    admit(game)


def forget(game) -> None:
    """Drop a game from the books (close)."""
    with _lock:
        _resident.pop(id(game), None)
        _evicted.pop(id(game), None)
        _set_gauges()


def note_restore(seconds: float) -> None:
    """Record one WAL-restore latency (the retry_after_sec basis and the
    `last_restore_s` field)."""
    with _lock:
        _restore_window.append(float(seconds))
        _totals["restores"] += 1
        _totals["last_restore_s"] = float(seconds)


def _set_gauges() -> None:
    obs_metrics.gauge("live.games_resident").set(len(_resident))
    obs_metrics.gauge("live.games_evicted").set(len(_evicted))


def stats() -> dict:
    """The residency books (JSON-serializable), the JAX package's
    `live_residency` block."""
    with _lock:
        _prune_dead()
        return {
            "max_resident": max_resident(),
            "resident": len(_resident),
            "evicted": len(_evicted),
            "evictions": _totals["evictions"],
            "restores": _totals["restores"],
            "last_restore_s": round(_totals["last_restore_s"], 6),
        }
