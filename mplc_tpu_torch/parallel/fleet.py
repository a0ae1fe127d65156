"""The fleet's state plane (port of the shard-state part of
`mplc_tpu/parallel/fleet.py`).

Each sweep-service process of a sharded deployment publishes its queue
depth and admission state into a shared folder
(`MPLC_TORCH_FLEET_STATE_DIR`, one `shard_<id>.json` a process, written
atomically) and reads the cluster's aggregate back (`cluster_view`): the
cross-shard queue view that /healthz shows and that an overloaded
service's `ServiceOverloaded` names as its redirect hint (the least-loaded
live shard). The files are the JAX package's, key for key, so a fleet of
either package reads the other's state. Nothing here changes a computed
number. The JAX module's fleet sweeps (`run_fleet_sweep`, ledger merging,
width pinning) are ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time

logger = logging.getLogger("mplc_tpu_torch")


def _atomic_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


_publish_warned = False


def publish_shard_state(state_dir: str, shard_id: str, payload: dict) -> None:
    """Atomically publish one service shard's queue and admission snapshot
    into the shared state folder. Never raises (a full disk must not take
    down the service whose state it mirrors), but every failure counts
    `fleet.state_publish_errors` (on /varz) and the first one a process
    warns: a shard whose publishing silently stopped would look like one
    that went quiet."""
    global _publish_warned
    try:
        os.makedirs(state_dir, exist_ok=True)
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(shard_id))
        _atomic_json(os.path.join(state_dir, f"shard_{safe}.json"),
                     {**payload, "shard": str(shard_id), "ts": time.time()})
    except Exception as e:  # noqa: BLE001 - a mirror, never a crash
        from ..obs import metrics as obs_metrics
        obs_metrics.counter("fleet.state_publish_errors").inc()
        if not _publish_warned:
            _publish_warned = True
            logger.warning(
                "fleet: shard-state publish to %r failed (%s); further failures are "
                "counted in fleet.state_publish_errors without logging", state_dir, e)


def cluster_view(state_dir: str, stale_sec: "float | None" = None,
                 include_metrics: bool = False) -> dict:
    """Every shard's published state: the per-shard rows (a stale one
    flagged, not dropped: a wedged shard's last word is evidence) and the
    cluster's totals. `least_loaded` names the live shard with the
    shallowest queue, the redirect hint an overloaded shard hands back. A
    stale shard (its file older than `stale_sec`, default
    MPLC_TORCH_FLEET_STALE_SEC or 30 s) or one that published `closed`
    is out of the live set and never recommended: a dead shard's last
    queue depth was probably 0. The rows' embedded metrics snapshots stay
    out unless `include_metrics` (the /healthz fleet block is
    unauthenticated, and tenant-labeled series must not ride it)."""
    if stale_sec is None:
        from .. import constants
        stale_sec = constants._env_nonneg_float(constants.FLEET_STALE_SEC_ENV, 30.0)
    shards = {}
    now = time.time()
    try:
        names = sorted(os.listdir(state_dir))
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("shard_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(state_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        # a publisher whose clock runs ahead of ours reads as fresh (age
        # 0), never as a negative age
        age = max(0.0, now - float(doc.get("ts") or 0))
        doc["age_sec"] = age
        doc["stale"] = age > stale_sec
        if not include_metrics:
            doc.pop("metrics", None)
        shards[str(doc.get("shard") or name)] = doc
    live = {k: d for k, d in shards.items() if not d["stale"] and not d.get("closed")}
    depth = sum(int(d.get("queue_depth") or 0) for d in live.values())
    pending = sum(int(d.get("jobs_pending") or 0) for d in live.values())
    least = min(live, key=lambda k: int(live[k].get("queue_depth") or 0), default=None)
    return {"shards": shards, "live_shards": len(live),
            "stale_shards": sum(1 for d in shards.values() if d["stale"]),
            "cluster_queue_depth": depth,
            "cluster_jobs_pending": pending,
            "least_loaded": least}
