"""The fleet's observability plane, its collector half (port of
`mplc_tpu/obs/fleet_view.py:1-380`): one view of a W-shard deployment.

`FleetCollector` merges every shard's metrics into one cluster snapshot.
Its sources, all optional and composable:

  - HTTP peers: each shard's `/varz`, read with the operator's bearer
    token (`MPLC_TORCH_FLEET_PEERS`);
  - the published fleet state folder (`MPLC_TORCH_FLEET_STATE_DIR`):
    `SweepService._publish_fleet_state` embeds the shard's metrics
    snapshot there, so a shard with no HTTP surface still counts;
  - a folder of `result_shardI.json` files, each carrying one worker's
    final snapshot (a fleet sweep's output folder).

Every histogram shares `metrics.LOG_BUCKET_BOUNDS`, so the merge
(`metrics.merge_snapshots`) is exact: the cluster p99 of
`service.queue_wait_sec{tenant=t0}` is the quantile of the pooled samples
at bucket granularity, not an average of per-shard quantiles.
`obs/export.py` serves the result as /fleet/metrics and /fleet/varz, with
the tenant redaction applied to every aggregated row.

`merge_fleet_traces` turns a fleet sweep's output folder
(parallel/fleet.py) into ONE Perfetto timeline: the coordinator's span
stream on pid 1, each shard's stream rebased onto the coordinator's clock
(`_clock_offset`, the midpoint rule) on pid 10 + I, and a flow arrow from
each `fleet.shard` dispatch to that shard's `fleet.shard_run` root span
(`python3 -m mplc_tpu_torch.fleet_trace_merge OUT_DIR` writes it).

Everything here reads: nothing changes a computed number, and a missing
source is an error row, never an exception into the caller.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time

from .. import constants
from . import metrics as obs_metrics
from . import trace as obs_trace

logger = logging.getLogger("mplc_tpu_torch")

FLEET_PEERS_ENV = constants.FLEET_PEERS_ENV

# the SLO histograms the cluster rollup surfaces as quantile rows of their
# own (everything else still merges; these get the shortcut view)
_SLO_HISTOGRAMS = ("service.queue_wait_sec",
                   "service.time_to_first_value_sec",
                   "service.slice_sec", "live.query_sec")

_KEY_RE = re.compile(r"^(?P<name>[^{]+)\{(?P<labels>.*)\}$")


def _parse_key(key: str) -> tuple:
    """(base name, labels dict) of a registry `name{k=v,...}` key."""
    m = _KEY_RE.match(key)
    if m is None:
        return key, {}
    labels = {}
    for part in m.group("labels").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return m.group("name"), labels


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class FleetCollector:
    """Scrape or read every shard's metrics into one cluster snapshot.

    `peers`      `host:port` (or full `http://` URLs): each is GET
                 `<peer>/varz` with the operator's bearer token. The
                 collector is an operator instrument: the per-tenant
                 redaction happens when the aggregate is served, not on
                 the shard hop.
    `state_dir`  the fleet state folder: its rows carry `cluster_view`'s
                 staleness as per-shard freshness, and a shard that
                 embedded a metrics snapshot in its published state
                 joins the merge without any HTTP surface.
    `out_dir`    a folder of `result_shardI.json` snapshots (a fleet
                 sweep's: each worker had its own registry).
    """

    def __init__(self, peers: "list | None" = None,
                 token: "str | None" = None,
                 state_dir: "str | None" = None,
                 out_dir: "str | None" = None,
                 stale_sec: float = 30.0, timeout_s: float = 5.0):
        self.peers = list(peers or [])
        self.token = token
        self.state_dir = state_dir
        self.out_dir = out_dir
        self.stale_sec = float(stale_sec)
        self.timeout_s = float(timeout_s)

    # -- per-source readers -------------------------------------------------

    def _scrape_peer(self, peer: str) -> dict:
        import urllib.request
        url = peer if "://" in peer else f"http://{peer}"
        req = urllib.request.Request(url.rstrip("/") + "/varz")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                doc = json.loads(r.read().decode())
            row = {"source": "http", "peer": peer, "ok": True,
                   "fresh": True, "pid": doc.get("pid"),
                   "metrics": doc.get("metrics")}
            sched = doc.get("scheduler")
            if isinstance(sched, dict):
                for k in ("queue_depth", "jobs_pending", "closed"):
                    if k in sched:
                        row[k] = sched[k]
            return row
        except Exception as e:  # noqa: BLE001 - a dead peer is a row
            return {"source": "http", "peer": peer, "ok": False,
                    "fresh": False, "error": str(e)[:200]}

    def _state_rows(self) -> tuple:
        from ..parallel import fleet
        view = fleet.cluster_view(self.state_dir, stale_sec=self.stale_sec,
                                  include_metrics=True)
        rows = {}
        for sid, doc in (view.get("shards") or {}).items():
            rows[sid] = {"source": "state_dir", "ok": True,
                         "fresh": not doc.get("stale"),
                         "age_sec": doc.get("age_sec"),
                         "queue_depth": doc.get("queue_depth"),
                         "jobs_pending": doc.get("jobs_pending"),
                         "closed": doc.get("closed"),
                         "metrics": doc.get("metrics")}
        return rows, view

    def _result_rows(self) -> dict:
        rows = {}
        try:
            names = sorted(os.listdir(self.out_dir))
        except OSError:
            return rows
        for name in names:
            m = re.fullmatch(r"result_shard(\d+)\.json", name)
            if not m:
                continue
            doc = _read_json(os.path.join(self.out_dir, name))
            if not isinstance(doc, dict):
                continue
            i = int(m.group(1))
            done = os.path.exists(os.path.join(self.out_dir, f".shard{i}.done"))
            sid = (doc.get("fleet") or {}).get("shard_id") or f"shard{i}"
            rows[sid] = {"source": "result", "ok": True, "fresh": done,
                         "shard_index": i,
                         "run_id": (doc.get("fleet") or {}).get("run_id"),
                         "sweep_s": doc.get("sweep_s"),
                         "coalitions": len(doc.get("subsets") or []),
                         "metrics": doc.get("metrics")}
        return rows

    # -- assembly -----------------------------------------------------------

    def collect(self) -> dict:
        """One cluster snapshot: per-shard rows (freshness flagged), the
        exact merged metrics, per-tenant SLO quantile shortcuts, the
        summed device-seconds bill and, with a state folder, its cluster
        totals."""
        with obs_trace.span("fleet.collect",
                            sources=sum(1 for s in (self.peers, self.state_dir,
                                                    self.out_dir) if s)):
            shards: dict = {}
            cluster = None
            if self.out_dir:
                shards.update(self._result_rows())
            if self.state_dir:
                rows, cluster = self._state_rows()
                shards.update(rows)
            for peer in self.peers:
                shards[f"peer:{peer}"] = self._scrape_peer(peer)
            snaps = []
            for sid, row in shards.items():
                obs_trace.event("fleet.scrape", shard=sid,
                                source=row.get("source"), ok=bool(row.get("ok")))
                snap = row.pop("metrics", None)
                if isinstance(snap, dict):
                    row["has_metrics"] = True
                    snaps.append(snap)
            merged = obs_metrics.merge_snapshots(snaps)
            out = {
                "ts": time.time(),
                "shards": shards,
                "shard_count": len(shards),
                "fresh_shards": sum(1 for r in shards.values() if r.get("fresh")),
                "merged_sources": len(snaps),
                "merged": merged,
                "slo": _slo_quantiles(merged),
            }
            out.update(_device_seconds(merged))
            if cluster is not None:
                out["cluster"] = {k: v for k, v in cluster.items() if k != "shards"}
        return out

    def fleet_varz(self) -> dict:
        """The /fleet/varz body."""
        return {"pid": os.getpid(), "collector": {
            "peers": list(self.peers), "state_dir": self.state_dir,
            "out_dir": self.out_dir, "stale_sec": self.stale_sec},
            **self.collect()}


def _slo_quantiles(merged: dict) -> dict:
    """Cluster-true quantile shortcuts of the SLO histograms, keyed by
    their full (tenant-labeled) registry keys."""
    out = {}
    for key, h in (merged.get("histograms") or {}).items():
        base, _labels = _parse_key(key)
        if base in _SLO_HISTOGRAMS and h.get("count"):
            out[key] = {"count": h["count"], "mean": h.get("mean"),
                        "p50": h.get("p50"), "p95": h.get("p95"),
                        "p99": h.get("p99")}
    return out


def _device_seconds(merged: dict) -> dict:
    """The device seconds metered on every shard, summed: the fleet's
    bill, in total and by tenant."""
    per_tenant: dict = {}
    total = 0.0
    for key, v in (merged.get("counters") or {}).items():
        base, labels = _parse_key(key)
        if base == "service.device_seconds":
            total += float(v or 0.0)
            tenant = labels.get("tenant")
            if tenant is not None:
                per_tenant[tenant] = per_tenant.get(tenant, 0.0) + float(v or 0.0)
    out: dict = {"device_seconds_total": total}
    if per_tenant:
        out["tenant_device_seconds"] = per_tenant
    return out


# -- the process's collector (what /fleet/* serves) ---------------------------

_collector: "FleetCollector | None" = None


def set_collector(c: "FleetCollector | None") -> None:
    global _collector
    _collector = c


def active_collector() -> "FleetCollector | None":
    return _collector


def collector_from_env() -> "FleetCollector | None":
    """A collector from the environment, or None when no source is
    configured: `MPLC_TORCH_FLEET_PEERS` (comma-separated /varz peers,
    read with the `MPLC_TORCH_METRICS_TOKEN` operator credential) and
    the fleet state folder."""
    peers = [p.strip() for p in (os.environ.get(FLEET_PEERS_ENV) or "").split(",")
             if p.strip()]
    state_dir = os.environ.get(constants.FLEET_STATE_DIR_ENV)
    if not peers and not state_dir:
        return None
    return FleetCollector(peers=peers, state_dir=state_dir,
                          token=os.environ.get(constants.METRICS_TOKEN_ENV))


def get_or_create_collector() -> "FleetCollector | None":
    """The installed collector, else one built from the environment (not
    installed: the environment may change between requests, and a
    collector is cheap to build)."""
    return _collector if _collector is not None else collector_from_env()


def cluster_snapshot(out_dir: "str | None" = None,
                     state_dir: "str | None" = None) -> dict:
    """One cluster snapshot over whatever sources exist. Never raises."""
    try:
        return FleetCollector(out_dir=out_dir, state_dir=state_dir).collect()
    except Exception as e:  # noqa: BLE001 - a postmortem helper
        return {"error": str(e)[:500]}


def fleet_metrics_text(merged: dict) -> str:
    """The Prometheus text exposition of a merged snapshot. Series are
    prefixed `mplc_fleet_`, so a scraper federating both the per-shard
    /metrics and the aggregate never counts a sample twice."""
    from . import export
    lines = []
    typed: set = set()

    def emit(key, kind, render):
        name, labels = _parse_key(key)
        pname, plabels = export._prom_parts(name, labels)
        pname = "mplc_fleet_" + pname[len("mplc_"):]
        if pname not in typed:
            typed.add(pname)
            lines.append(f"# TYPE {pname} {kind}")
        render(pname, plabels)

    for key, v in sorted((merged.get("counters") or {}).items()):
        emit(key, "counter", lambda n, la, v=v: lines.append(
            f"{n}{export._label_str(la)} {export._fmt(v)}"))
    for key, v in sorted((merged.get("gauges") or {}).items()):
        if v is None:
            continue
        emit(key, "gauge", lambda n, la, v=v: lines.append(
            f"{n}{export._label_str(la)} {export._fmt(v)}"))
    for key, h in sorted((merged.get("histograms") or {}).items()):
        bc = h.get("bucket_counts") or []

        def hist(n, la, h=h, bc=bc):
            cum = 0
            for bound, c in zip(obs_metrics.LOG_BUCKET_BOUNDS, bc):
                cum += c
                lines.append(f"{n}_bucket"
                             f"{export._label_str(dict(la, le=export._fmt(bound)))} {cum}")
            cum += bc[-1] if len(bc) > len(obs_metrics.LOG_BUCKET_BOUNDS) else 0
            lines.append(f'{n}_bucket{export._label_str(dict(la, le="+Inf"))} {cum}')
            lines.append(f"{n}_sum{export._label_str(la)} "
                         f"{export._fmt(h.get('sum') or 0.0)}")
            lines.append(f"{n}_count{export._label_str(la)} {int(h.get('count') or 0)}")
        emit(key, "histogram", hist)
    return "\n".join(lines) + "\n"


# -- the merged Perfetto timeline ----------------------------------------------

def _clock_offset(manifest: dict, result: "dict | None", shard: int) -> float:
    """Seconds to ADD to a shard's timestamps to land them on the
    coordinator's clock: the midpoint rule over the handshake's four
    readings, the coordinator's spawn (s) and done-seen (d) times and the
    worker's start (ws) and end (we):

        offset = ((s - ws) + (d - we)) / 2

    With no skew, the spawn-to-start and end-to-done-seen latencies enter
    with opposite signs and cancel to their asymmetry; a skew appears in
    both terms and survives intact. One-sided (`s - ws`) when the run has
    no done-seen time (a dead shard), 0 with no handshake at all."""
    clock = (result or {}).get("clock") or {}
    spawn = (manifest.get("spawn_ts") or {}).get(str(shard))
    if spawn is None:
        spawn = clock.get("coord_spawn_ts")
    done = (manifest.get("done_seen_ts") or {}).get(str(shard))
    ws = clock.get("worker_start_ts")
    we = clock.get("worker_end_ts")
    if spawn is not None and ws is not None:
        if done is not None and we is not None:
            return ((spawn - ws) + (done - we)) / 2.0
        return float(spawn) - float(ws)
    return 0.0


def merge_fleet_traces(out_dir: str) -> dict:
    """One Chrome trace-event document of a fleet folder: the coordinator's
    stream (trace_coordinator.jsonl) on pid 1, each shard's
    (trace_shardI.jsonl) rebased onto the coordinator's clock on pid
    10 + I, each a process with its `process_name` row, and a flow pair
    from every `fleet.shard` dispatch event to that shard's
    `fleet.shard_run` root span. The coordinator's records stamped with a
    `fleet_shard` are left out (the shard files hold them).

    Returns {trace, shard_tracks, flow_links, offsets, records,
    torn_lines}; `trace` loads in https://ui.perfetto.dev."""
    from . import chrome_trace
    manifest = _read_json(os.path.join(out_dir, "fleet_trace_manifest.json")) or {}
    torn_total = 0
    coord_path = os.path.join(out_dir, "trace_coordinator.jsonl")
    coord_records: list = []
    if os.path.exists(coord_path):
        coord_records, torn = chrome_trace.read_jsonl(coord_path)
        torn_total += torn
        coord_records = [r for r in coord_records if "fleet_shard" not in r]
    shard_streams: dict = {}
    offsets: dict = {}
    try:
        names = sorted(os.listdir(out_dir))
    except OSError:
        names = []
    for name in names:
        m = re.fullmatch(r"trace_shard(\d+)\.jsonl", name)
        if not m:
            continue
        i = int(m.group(1))
        records, torn = chrome_trace.read_jsonl(os.path.join(out_dir, name))
        torn_total += torn
        result = _read_json(os.path.join(out_dir, f"result_shard{i}.json"))
        off = _clock_offset(manifest, result, i)
        offsets[str(i)] = off
        for r in records:
            r["ts"] = float(r.get("ts") or 0.0) + off
        shard_streams[i] = records

    every = coord_records + [r for recs in shard_streams.values() for r in recs]
    t0 = min((float(r.get("ts") or 0.0) for r in every), default=0.0)
    events: list = []
    # (tid, ts_us, dur_us) of each pid's first fleet.shard_run root span,
    # and every coordinator fleet.shard dispatch event, for the flow links
    roots: dict = {}
    dispatches: list = []

    def add_stream(records, pid, label):
        tids = []
        for rec in records:
            tid = int(rec.get("thread") or 0)
            if tid not in tids:
                tids.append(tid)
            ts_us = (float(rec.get("ts") or 0.0) - t0) * 1e6
            dur_us = max(float(rec.get("dur") or 0.0) * 1e6, 1.0)
            name = rec.get("name", "?")
            attrs = rec.get("attrs") or {}
            events.append({
                "name": name, "cat": name.split(".", 1)[0], "ph": "X",
                "ts": ts_us, "dur": dur_us, "pid": pid, "tid": tid,
                "args": {**attrs, "span_id": rec.get("id"),
                         "fleet_run": rec.get("fleet_run"),
                         "fleet_shard": rec.get("fleet_shard")},
            })
            if name == "fleet.shard_run":
                roots.setdefault(pid, (tid, ts_us, dur_us))   # a re-run re-roots
            elif name == "fleet.shard" and pid == 1:
                dispatches.append((attrs.get("shard"), tid, ts_us, dur_us))
        for i, tid in enumerate(tids):
            events.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                           "tid": tid, "args": {"name": f"thread-{tid}"}})
            events.append({"name": "thread_sort_index", "ph": "M", "ts": 0, "pid": pid,
                           "tid": tid, "args": {"sort_index": i}})
        events.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
                       "args": {"name": label}})
        events.append({"name": "process_sort_index", "ph": "M", "ts": 0, "pid": pid,
                       "tid": 0, "args": {"sort_index": pid}})

    add_stream(coord_records, 1, "fleet coordinator")
    for i in sorted(shard_streams):
        add_stream(shard_streams[i], 10 + i, f"shard {i}")

    flow_links = 0
    for shard, tid, ts_us, dur_us in dispatches:
        try:
            pid = 10 + int(shard)
        except (TypeError, ValueError):
            continue
        root = roots.get(pid)
        if root is None:
            continue
        rtid, rts, rdur = root
        flow_links += 1
        events.append({"name": "fleet.dispatch", "cat": "flow", "ph": "s",
                       "id": flow_links, "ts": ts_us + min(0.5, dur_us / 2),
                       "pid": 1, "tid": tid})
        events.append({"name": "fleet.dispatch", "cat": "flow", "ph": "f", "bp": "e",
                       "id": flow_links, "ts": rts + min(0.5, rdur / 2),
                       "pid": pid, "tid": rtid})

    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "mplc_tpu_torch fleet trace merge",
                      "run_id": manifest.get("run_id"),
                      "shards": len(shard_streams),
                      "records": len(every),
                      "clock_offsets_s": offsets,
                      "flows": flow_links,
                      "torn_lines": torn_total},
    }
    return {"trace": trace, "shard_tracks": len(shard_streams), "flow_links": flow_links,
            "offsets": offsets, "records": len(every), "torn_lines": torn_total}
