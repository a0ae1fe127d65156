"""Live telemetry endpoints (port of `mplc_tpu/obs/export.py`): a
zero-dependency stdlib HTTP thread serving the metrics registry and the
service's health while a sweep runs.

The batch-shaped obs layer (collect() + sweep_report after the run) is
useless to an operator of a LIVE multi-tenant service: queue depth,
per-tenant SLO quantiles and a stalled worker must be observable while
the process is running. This module starts — only when
`MPLC_TORCH_METRICS_PORT` is set — one `ThreadingHTTPServer` daemon thread
with these routes:

  /metrics   Prometheus text exposition (version 0.0.4) rendered from
             `metrics.export_view()`: counters, gauges, and real
             histogram series (`_bucket{le=...}` from the shared log2
             bounds, `_sum`, `_count`) with labels (e.g. `tenant`)
             quoted per the format. Names are prefixed `mplc_` and
             sanitized (dots -> underscores); a bracketed suffix
             (`engine.memo_hits[<method>]`) becomes an `item` label.
  /healthz   JSON liveness: 200 when every registered health provider
             reports healthy, 503 otherwise. The sweep service registers
             a provider exposing worker liveness, heartbeat age (flips
             unhealthy when a quantum stalls past
             `service.scheduler.STALL_HEALTHY_SEC` with a job running),
             queue depth and journal status.
  /varz      Full JSON state snapshot: the metrics registry plus every
             registered varz provider (service job table, program-bank
             contents when the bank module is loaded), a numerics block,
             and — when the process participates in a fleet — the
             cross-shard cluster view.
  POST /live/<tenant>/round
             one live round fed to the tenant's resident game (only with
             `MPLC_TORCH_LIVE_INGEST=1`).
  POST /router/submit, GET /router/job
             the routed-submission surface of a fleet router's shard
             (`service/router.py` ShardServer): only with
             `MPLC_TORCH_ROUTER_SERVE=1` and a registered sink, 404
             otherwise.
  /fleet/metrics, /fleet/varz
             the aggregated cluster view (`obs/fleet_view.py`): every
             shard's metrics the collector reaches (HTTP peers, the
             published state folder) merged exactly, served with the same
             credentials as above (the Prometheus text operator-only, the
             JSON view redacted row by row for a tenant); 404 with no
             collector configured, 503 when it fails.

With the env var UNSET nothing happens: no socket, no thread — the
instrumented paths cost exactly what they cost before. A plain port
value binds LOOPBACK only (the endpoints are unauthenticated by
default — tenant names, job tables, error strings); `host:port` opts
into wider exposure explicitly. Setting `MPLC_TORCH_METRICS_TOKEN`
additionally gates /metrics and /varz behind bearer credentials — the
master token for the operator, `tenant_token(master, name)`-derived
credentials for tenants, whose /varz view has every other tenant's rows
redacted (`redact_varz`). Port 0 binds an ephemeral port (tests; the
bound port is on `TelemetryServer.port` and in the start-up log line).
The server is a process singleton: the first `start()` wins, later calls
return it. Credentials, redaction and the Prometheus text are the JAX
package's byte for byte (tests/test_torch_export.py).

Providers are plain callables returning JSON-ready dicts, registered
under a name (`register_health`/`register_varz`); a provider that raises
is reported as an error entry, never a 500 — the telemetry plane must
not be takeable-down by the thing it observes.
"""

from __future__ import annotations

import hashlib
import hmac
import http.server
import json
import logging
import os
import re
import threading
import time
import urllib.parse
import warnings
import weakref

from .. import constants
from . import metrics

logger = logging.getLogger("mplc_tpu_torch")

METRICS_PORT_ENV = constants.METRICS_PORT_ENV
# Optional bearer token: when set, /metrics and /varz require `Authorization: Bearer`
# credentials (401 otherwise; /healthz stays open for liveness probes).
# The master token is the OPERATOR credential (full unredacted view; the
# only credential /metrics accepts — Prometheus text has no redacted
# rendering); `tenant_token(master, name)` derives one per-tenant
# credential which, presented with `?tenant=<name>`, unlocks /varz with
# every OTHER tenant's rows redacted under HMAC-keyed tags — the viewer
# claim is authenticated, never self-declared. Unset = the loopback
# default behavior, unchanged.
METRICS_TOKEN_ENV = constants.METRICS_TOKEN_ENV

# Streaming round ingestion (the live tier's decoupled arrival path):
# when set to "1", the server grows `POST /live/<tenant>/round` — one
# live_round wire document per request, fed to the registered service
# sink (SweepService._ingest_live_round). Off by default: a MUTATING
# HTTP surface is an explicit operator decision, unlike the read-only
# routes above.
LIVE_INGEST_ENV = constants.LIVE_INGEST_ENV

# Routed submission (the fleet router's HTTP peer surface): when set to
# "1", the server grows `POST /router/submit` and `GET /router/job?id=`,
# answered by the registered ShardServer sink. Off by default for the same
# reason as live ingestion: a mutating HTTP surface is the operator's
# decision, never a side effect of registering a sink.
ROUTER_SERVE_ENV = constants.ROUTER_SERVE_ENV

_lock = threading.Lock()
_server: "TelemetryServer | None" = None
_health_providers: dict = {}
_varz_providers: dict = {}
_live_ingest_sinks: dict = {}
_router_sinks: dict = {}


# -- provider registry --------------------------------------------------------

def register_health(name: str, fn) -> None:
    """Register a health provider: `fn()` returns a JSON-ready dict; a
    `healthy: False` entry flips /healthz to 503. Pass a
    `weakref.WeakMethod` to auto-unregister when the owning object is
    collected (how SweepService registers: a dropped, never-shut-down
    service must not haunt /healthz forever)."""
    with _lock:
        _health_providers[name] = fn


def register_varz(name: str, fn) -> None:
    with _lock:
        _varz_providers[name] = fn


def register_live_ingest(name: str, fn) -> None:
    """Register a streaming-ingestion sink: `fn(tenant, doc)` feeds one
    decoded live_round wire document to the tenant's resident game and
    returns a JSON-ready ack. Same WeakMethod auto-unregister contract
    as the health/varz providers. The POST route only exists when
    `MPLC_TORCH_LIVE_INGEST=1`."""
    with _lock:
        _live_ingest_sinks[name] = fn


def register_router(name: str, fn) -> None:
    """Register a routed-submission sink (service/router.py ShardServer):
    `fn(op, payload)` handles `op="submit"` (one routed job wire
    document -> ack) and `op="job"` (`{"job": id}` -> status document).
    Same WeakMethod auto-unregister contract as the other registries;
    the /router/* routes only exist with `MPLC_TORCH_ROUTER_SERVE=1` and
    a sink registered."""
    with _lock:
        _router_sinks[name] = fn


def unregister(name: str) -> None:
    with _lock:
        _health_providers.pop(name, None)
        _varz_providers.pop(name, None)
        _live_ingest_sinks.pop(name, None)
        _router_sinks.pop(name, None)


def _call_providers(providers: dict) -> dict:
    out = {}
    for name, fn in sorted(providers.items()):
        if isinstance(fn, weakref.WeakMethod):
            live = fn()
            if live is None:
                unregister(name)  # the owner was collected
                continue
            fn = live
        try:
            out[name] = fn()
        except Exception as e:  # a broken provider must not 500 the route
            out[name] = {"healthy": False, "error": str(e)[:500]}
    return out


def live_ingest(tenant: str, doc: dict) -> dict:
    """Dispatch one live_round wire document to the registered
    ingestion sinks. A tenant's game lives in exactly one service, so a
    sink that doesn't know the tenant raises KeyError and the next is
    tried. Raises LookupError with no sink registered (503), the last
    KeyError when none knows the tenant (404); the sink's ValueError
    (400) and LiveGameFull-with-retry_after_sec (429) propagate."""
    with _lock:
        sinks = dict(_live_ingest_sinks)
    last: "KeyError | None" = None
    for name, fn in sorted(sinks.items()):
        if isinstance(fn, weakref.WeakMethod):
            live = fn()
            if live is None:
                unregister(name)  # the owner was collected
                continue
            fn = live
        try:
            return fn(tenant, doc)
        except KeyError as e:
            last = e
    if last is not None:
        raise last
    raise LookupError("no live ingestion sink registered (is a "
                      "SweepService running in this process?)")


def router_dispatch(op: str, payload) -> dict:
    """Dispatch one routed-submission operation to the registered
    ShardServer sinks. Same contract shape as `live_ingest`: a sink
    that doesn't know the job raises KeyError and the next is tried;
    LookupError with no sink registered (503), the last KeyError when
    none knows the job (404); everything else propagates for the
    handler to classify (429/403/400)."""
    with _lock:
        sinks = dict(_router_sinks)
    last: "KeyError | None" = None
    for name, fn in sorted(sinks.items()):
        if isinstance(fn, weakref.WeakMethod):
            live = fn()
            if live is None:
                unregister(name)  # the owner was collected
                continue
            fn = live
        try:
            return fn(op, payload)
        except KeyError as e:
            last = e
    if last is not None:
        raise last
    raise LookupError("no routed-submission sink registered (is a "
                      "ShardServer running in this process?)")


def _router_served() -> bool:
    """The /router/* routes exist only when the operator asked for them
    (`MPLC_TORCH_ROUTER_SERVE=1`) and a ShardServer sink is registered to
    answer them; otherwise both answer 404, so probes learn nothing."""
    if os.environ.get(ROUTER_SERVE_ENV) != "1":
        return False
    with _lock:
        return bool(_router_sinks)


def health_view() -> tuple[bool, dict]:
    """(healthy, body) for /healthz: healthy iff every provider is."""
    with _lock:
        providers = dict(_health_providers)
    body = _call_providers(providers)
    healthy = all(p.get("healthy", True) is not False
                  for p in body.values() if isinstance(p, dict))
    return healthy, {"healthy": healthy, "ts": time.time(),
                     "pid": os.getpid(), "providers": body}


def varz_view() -> dict:
    """Full JSON snapshot for /varz: metrics registry + varz providers +
    the program bank's contents when its module is already loaded (the
    endpoint never imports the engine's modules into a lean process), the
    numerics knobs and counters, and the fleet block."""
    with _lock:
        providers = dict(_varz_providers)
    out = {"ts": time.time(), "pid": os.getpid(),
           "metrics": metrics.snapshot()}
    out.update(_call_providers(providers))
    if "program_bank" not in out:
        try:
            import sys
            bank = sys.modules.get("mplc_tpu_torch.contrib.bank")
            if bank is not None:
                out["program_bank"] = bank.bank_stats()
        except Exception as e:
            out["program_bank"] = {"error": str(e)[:200]}
    # the numerics plane (obs/numerics.py): process-level knob states and
    # the ledger/audit/drift counters. No tenant identity or per-tenant
    # value, so the redaction walk has nothing to collapse here
    try:
        snap = out["metrics"].get("counters", {}) if isinstance(
            out.get("metrics"), dict) else {}
        out["numerics"] = {
            "deterministic_reduce":
                os.environ.get(constants.DETERMINISTIC_REDUCE_ENV, "") == "1",
            "audit_enabled":
                os.environ.get(constants.NUMERICS_AUDIT_ENV, "") == "1",
            "ledger_path": os.environ.get(constants.NUMERICS_LEDGER_ENV) or None,
            "ledger_records": snap.get("numerics.ledger_records", 0),
            "audits": snap.get("numerics.audits", 0),
            "drift_events": snap.get("numerics.drift_events", 0),
        }
    except Exception as e:
        out["numerics"] = {"error": str(e)[:200]}
    # the fleet block (as on /healthz): the cross-shard cluster view, this
    # process's shard identity and its publish-failure counter, whenever
    # a fleet state folder is configured. Shard ids are identity-bearing
    # in a consortium: redact_varz hashes them for tenant viewers (queue
    # depths stay scalars)
    try:
        state_dir = os.environ.get(constants.FLEET_STATE_DIR_ENV)
        if state_dir:
            from ..parallel.fleet import cluster_view
            fv = cluster_view(state_dir)
            fv["shard_id"] = os.environ.get(constants.FLEET_SHARD_ID_ENV)
            cnt = out["metrics"].get("counters", {}) if isinstance(
                out.get("metrics"), dict) else {}
            fv["state_publish_errors"] = cnt.get(
                "fleet.state_publish_errors", 0)
            out["fleet"] = fv
    except Exception as e:
        out["fleet"] = {"error": str(e)[:200]}
    return out


# -- tenant credentials + redaction -------------------------------------------

# the per-job table key a redaction walk recognizes, and the row fields a
# non-viewer is still allowed to see (scheduling facts, no identity/work
# detail — enough to reason about queue fairness, nothing about the game)
_REDACTED_ROW_FIELDS = ("status", "priority", "age_sec")
# greedy to the closing brace: a tenant name containing ',' (legal in the
# registry's `name{tenant=...}` keys, which join label pairs with commas)
# must hash in FULL — swallowing a trailing label into the hash
# over-redacts, which is the safe direction; leaking the remainder is not
_TENANT_LABEL_RE = re.compile(r"tenant=([^}]*)")


def tenant_token(master: str, tenant) -> str:
    """The per-tenant bearer credential: HMAC-SHA256(master, tenant).

    A single shared token cannot carry a tenant identity — anyone
    holding it could claim any `?tenant=` and read every other tenant's
    rows. Instead the operator (who holds the master
    `MPLC_TORCH_METRICS_TOKEN`) derives one credential per tenant with
    this function and hands each tenant ITS token only: presenting
    `Bearer <tenant_token>` together with `?tenant=<name>` authenticates
    the viewer claim (a tenant cannot forge another tenant's HMAC
    without the master), while the master itself is the operator
    credential with the full, unredacted view."""
    return hmac.new(master.encode(), str(tenant).encode(),
                    hashlib.sha256).hexdigest()


def _opaque_tag(value, key: "str | None" = None,
                prefix: str = "tenant") -> str:
    """Stable opaque tag for a redacted identifier (same input -> same
    tag within and across snapshots, so a viewer can still correlate
    rows without learning the identity). With `key` (the master token,
    supplied by the HTTP handler) the tag is HMAC-keyed, so a viewer
    cannot dictionary-confirm candidate names offline; the unkeyed
    fallback is for direct redact_varz() callers."""
    if key:
        digest = hmac.new(key.encode(), str(value).encode(),
                          hashlib.sha256).hexdigest()
    else:
        digest = hashlib.sha256(str(value).encode()).hexdigest()
    return f"{prefix}-" + digest[:8]


def _tenant_tag(tenant, key: "str | None" = None) -> str:
    return _opaque_tag(tenant, key, "tenant")


def redact_health(doc, key: "str | None" = None):
    """A copy of a /healthz document with caller-supplied job ids
    hashed. Job ids are arbitrary submitter strings (a tenant may well
    encode what the job IS in its id) and /healthz deliberately stays
    unauthenticated for orchestrator probes — so in token mode the
    liveness body must not leak them. Liveness semantics (healthy,
    stall flags, queue depth) are untouched; the operator correlates
    the hashed id via the authenticated /varz."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "running_job" and isinstance(v, str):
                    out[k] = _opaque_tag(v, key, "job")
                elif k == "running_jobs" and isinstance(v, list):
                    out[k] = [_opaque_tag(j, key, "job")
                              if isinstance(j, str) else j for j in v]
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(x) for x in node]
        return node

    return walk(doc)


def redact_varz(doc, viewer: "str | None" = None,
                key: "str | None" = None):
    """A copy of a /varz document with other tenants' values redacted.

    Applied by the HTTP handler when `MPLC_TORCH_METRICS_TOKEN` is set and
    the caller authenticated with a per-tenant credential
    (`tenant_token`): the bearer token gates ACCESS, this gates
    CROSS-TENANT visibility — a consortium partner scraping its own
    numbers must not read the other partners' job tables off the same
    endpoint. Rules:

      - any `jobs` table (dict of rows carrying a `tenant` field): rows
        whose tenant != `viewer` collapse to
        {tenant: <hashed tag>, status, priority, age_sec, redacted: True};
      - dict keys carrying a `tenant=` metric label (the registry's
        `name{tenant=...}` convention) are rewritten with the hashed tag
        unless the label names the viewer;
      - `tenant_device_seconds`-style per-tenant maps: non-viewer keys
        are hashed (values kept — aggregate billing is not an identity);
      - the live tier's `live_games` block (tenant-keyed game rows):
        non-viewer rows collapse to a hashed-tenant tag plus the
        activity scalars, with the journal PATH dropped — a filesystem
        path is operator detail, not a co-tenant's business;
      - fleet views (`shards` row tables, `least_loaded`, `shard_id`,
        `peer`): shard identities/endpoints are deployment topology and
        hash to opaque `shard-` tags, while queue/freshness SCALARS stay
        readable — a tenant may reason about cluster load, never about
        which host is which.

    `key` (the master token) makes the hashed tags HMAC-keyed — see
    `_tenant_tag`."""
    def _redact_key(k: str) -> str:
        def sub(m):
            t = m.group(1)
            return ("tenant=" + t if viewer is not None and t == viewer
                    else "tenant=" + _tenant_tag(t, key))
        return _TENANT_LABEL_RE.sub(sub, k)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, val in node.items():
                if (k == "jobs" and isinstance(val, dict)
                        and any(isinstance(r, dict) and "tenant" in r
                                for r in val.values())):
                    # the row KEY is the caller-supplied job id — itself
                    # an identity/work leak (a tenant may encode what
                    # the job is in its id), so redacted rows get an
                    # opaque job tag too
                    out[k] = {
                        (jid if row.get("tenant") == viewer
                         else _opaque_tag(jid, key, "job")):
                        (dict(row) if row.get("tenant") == viewer
                         else {"tenant": _tenant_tag(row.get("tenant"),
                                                     key),
                               **{f: row.get(f)
                                  for f in _REDACTED_ROW_FIELDS},
                               "redacted": True})
                        for jid, row in val.items()}
                elif (k == "tenant_device_seconds"
                      and isinstance(val, dict)):
                    out[k] = {(t if t == viewer
                               else _tenant_tag(t, key)): v
                              for t, v in val.items()}
                elif (k == "live_games" and isinstance(val, dict)
                      and any(isinstance(r, dict) and "tenant" in r
                              for r in val.values())):
                    out[k] = {
                        (t if t == viewer else _tenant_tag(t, key)):
                        (dict(row) if t == viewer
                         else {"tenant": _tenant_tag(row.get("tenant"),
                                                     key),
                               "rounds_resident":
                                   row.get("rounds_resident"),
                               "round_stamp": row.get("round_stamp"),
                               "queries": row.get("queries"),
                               # residency state stays readable (load
                               # signals, not identity); the journal
                               # PATH is dropped with the rest
                               "resident": row.get("resident"),
                               "last_restore_s":
                                   row.get("last_restore_s"),
                               "redacted": True})
                        for t, row in val.items()}
                elif (k == "shards" and isinstance(val, dict) and val
                      and all(isinstance(r, dict)
                              for r in val.values())):
                    # fleet views (the /varz fleet block, /fleet/varz):
                    # shard ids are deployment topology — hashed for
                    # tenant viewers, while the rows' queue/freshness
                    # SCALARS stay readable (a tenant may reason about
                    # cluster load, not about which host is which)
                    out[k] = {
                        _opaque_tag(s, key, "shard"):
                        {**walk(row),
                         **({"shard": _opaque_tag(row["shard"], key,
                                                  "shard")}
                            if isinstance(row.get("shard"), str)
                            else {})}
                        for s, row in val.items()}
                elif (k in ("least_loaded", "shard_id", "peer")
                      and isinstance(val, str)):
                    out[k] = _opaque_tag(val, key, "shard")
                elif isinstance(k, str) and "tenant=" in k:
                    out[_redact_key(k)] = walk(val)
                else:
                    out[k] = walk(val)
            return out
        if isinstance(node, list):
            return [walk(x) for x in node]
        return node

    return walk(doc)


# -- Prometheus rendering -----------------------------------------------------

_BRACKET_RE = re.compile(r"^(?P<base>[^\[\]]+)\[(?P<item>.+)\]$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_parts(name: str, labels: dict) -> tuple[str, dict]:
    """(prometheus metric name, labels) for a registry metric name: the
    `name[item]` per-executable convention becomes an `item` label."""
    m = _BRACKET_RE.match(name)
    if m is not None:
        name = m.group("base")
        labels = dict(labels, item=m.group("item"))
    return "mplc_" + _SANITIZE_RE.sub("_", name), labels


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_SANITIZE_RE.sub("_", k)}="{_escape(str(v))}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text() -> str:
    """The whole registry in Prometheus text exposition format 0.0.4."""
    lines = []
    typed: set = set()
    for row in metrics.export_view():
        name, labels = _prom_parts(row["name"], row["labels"])
        kind = row["kind"]
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")
        if kind == "histogram":
            cum = 0
            for bound, c in zip(row["bounds"], row["bucket_counts"]):
                cum += c
                lines.append(
                    f"{name}_bucket"
                    f"{_label_str(dict(labels, le=_fmt(bound)))} {cum}")
            cum += row["bucket_counts"][-1]
            lines.append(
                f'{name}_bucket{_label_str(dict(labels, le="+Inf"))} {cum}')
            lines.append(f"{name}_sum{_label_str(labels)} "
                         f"{_fmt(row['sum'])}")
            lines.append(f"{name}_count{_label_str(labels)} {row['count']}")
        else:
            value = row["value"]
            if value is None:
                continue  # an unset gauge has no sample
            lines.append(f"{name}{_label_str(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# -- the HTTP server ----------------------------------------------------------

_LIVE_ROUND_RE = re.compile(r"^/live/([^/]+)/round$")


class _Handler(http.server.BaseHTTPRequestHandler):
    def _auth_role(self, query: str) -> "tuple[str, str | None]":
        """(role, viewer) for the request's bearer credential:

          ("open", None)       — MPLC_TORCH_METRICS_TOKEN unset (the
                                 loopback default: everything open);
          ("operator", None)   — the master token itself: full,
                                 unredacted access;
          ("tenant", <name>)   — the per-tenant HMAC credential
                                 (`tenant_token(master, name)`) together
                                 with `?tenant=<name>`: the viewer claim
                                 is AUTHENTICATED, not self-declared —
                                 tenant A cannot read tenant B's rows by
                                 editing the query string;
          ("denied", None)     — anything else.

        Comparisons are constant-time over BYTES (a non-ASCII header
        must 401, not TypeError the handler thread)."""
        token = os.environ.get(METRICS_TOKEN_ENV)
        if not token:
            return "open", None
        header = self.headers.get("Authorization", "")
        supplied = header[7:] if header.startswith("Bearer ") else ""
        supplied_b = supplied.encode("utf-8", "surrogateescape")
        if hmac.compare_digest(supplied_b, token.encode()):
            return "operator", None
        viewer = urllib.parse.parse_qs(query).get("tenant", [None])[0]
        if viewer is not None and hmac.compare_digest(
                supplied_b, tenant_token(token, viewer).encode()):
            return "tenant", viewer
        return "denied", None

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            # operator-only when the token is set: the Prometheus text
            # carries every tenant's labeled series and has no redacted
            # rendering — a per-tenant credential does not unlock it
            if self._auth_role(query)[0] not in ("open", "operator"):
                return self._deny()
            body = prometheus_text().encode()
            self._reply(200, body, "text/plain; version=0.0.4")
        elif path == "/healthz":
            # liveness stays unauthenticated: a 401ing health probe
            # reads as "down" to every orchestrator that matters. In
            # token mode, caller-supplied job ids are hashed out of the
            # open body (liveness semantics untouched).
            healthy, view = health_view()
            token = os.environ.get(METRICS_TOKEN_ENV)
            if token:
                view = redact_health(view, token)
            self._reply(200 if healthy else 503,
                        json.dumps(view, default=str).encode(),
                        "application/json")
        elif path == "/varz":
            role, viewer = self._auth_role(query)
            if role == "denied":
                return self._deny()
            doc = varz_view()
            if role == "tenant":
                # authenticated per-tenant view: everyone else's rows
                # redacted under HMAC-keyed tags
                doc = redact_varz(doc, viewer,
                                  key=os.environ.get(METRICS_TOKEN_ENV))
            self._reply(200, json.dumps(doc, default=str).encode(),
                        "application/json")
        elif path in ("/fleet/varz", "/fleet/metrics"):
            # the aggregated cluster view (obs/fleet_view.py): the same
            # credentials as the per-process routes. Prometheus text is
            # operator-only, the JSON view serves tenants with every
            # aggregated row under the redaction walk
            role, viewer = self._auth_role(query)
            if role == "denied" or (path == "/fleet/metrics"
                                    and role not in ("open", "operator")):
                return self._deny()
            from . import fleet_view
            coll = fleet_view.get_or_create_collector()
            if coll is None:
                return self._reply(
                    404, b"no fleet collector configured (set "
                    b"MPLC_TORCH_FLEET_PEERS or MPLC_TORCH_FLEET_STATE_DIR, "
                    b"or install one via fleet_view.set_collector)\n",
                    "text/plain")
            try:
                if path == "/fleet/metrics":
                    merged = coll.collect().get("merged") or {}
                    body = fleet_view.fleet_metrics_text(merged).encode()
                    self._reply(200, body, "text/plain; version=0.0.4")
                else:
                    doc = coll.fleet_varz()
                    if role == "tenant":
                        doc = redact_varz(
                            doc, viewer,
                            key=os.environ.get(METRICS_TOKEN_ENV))
                    self._reply(200,
                                json.dumps(doc, default=str).encode(),
                                "application/json")
            except Exception as e:  # a collector failure is a 503, not a 500
                self._reply(503, json.dumps(
                    {"error": str(e)[:500]}).encode(), "application/json")
        elif path == "/router/job":
            # routed-job polling (the fleet router's result surface);
            # gated like the submit route — the pair only exists
            # together. Tenant-credentialed viewers may only read their
            # OWN jobs: the v(S) table is the tenant's game data.
            if not _router_served():
                return self._reply(404, b"not found\n", "text/plain")
            role, viewer = self._auth_role(query)
            if role == "denied":
                return self._deny()
            job_id = urllib.parse.parse_qs(query).get("id", [None])[0]
            if not job_id:
                return self._reply(400, json.dumps(
                    {"error": "missing ?id=<job_id>"}).encode(),
                    "application/json")
            try:
                doc = router_dispatch("job", {"job": job_id})
            except KeyError as e:
                return self._reply(404, json.dumps(
                    {"error": str(e)[:500]}).encode(), "application/json")
            except LookupError as e:
                return self._reply(503, json.dumps(
                    {"error": str(e)[:500]}).encode(), "application/json")
            if role == "tenant" and doc.get("tenant") != viewer:
                return self._deny()
            self._reply(200, json.dumps(doc, default=str).encode(),
                        "application/json")
        elif path == "/":
            self._reply(200, b"mplc_tpu_torch telemetry: /metrics /healthz "
                        b"/varz\n",
                        "text/plain")
        else:
            self._reply(404, b"not found\n", "text/plain")

    def _router_submit(self) -> None:
        """POST /router/submit — one routed job submission (the fleet
        router's wire path into this shard's ShardServer sink). Error
        mapping mirrors the service's submit contract: 429+Retry-After
        for ServiceOverloaded/JobShed (body carries retry_after_sec,
        the `kind`, and the cluster redirect hint), 403 for a failed
        credential, 503 for a closed service / missing sink, 400 for a
        malformed document."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length).decode())
            if not isinstance(doc, dict):
                raise ValueError("submission must be a JSON object")
        except Exception as e:
            return self._reply(400, json.dumps(
                {"error": f"bad request body: {str(e)[:300]}"}).encode(),
                "application/json")
        from ..service.scheduler import (JobShed, ServiceAuthError,
                                         ServiceClosed, ServiceOverloaded)
        try:
            ack = router_dispatch("submit", doc)
        except (ServiceOverloaded, JobShed) as e:
            cluster = getattr(e, "cluster", None) or {}
            body = json.dumps({
                "error": str(e)[:500],
                "kind": "shed" if isinstance(e, JobShed) else "overloaded",
                "retry_after_sec": float(
                    getattr(e, "retry_after_sec", 0.0) or 0.0),
                # the redirect hint alone rides the wire — never the
                # full view (its rows carry other shards' metrics)
                "cluster": {"least_loaded": cluster.get("least_loaded")},
            })
            self.send_response(429)
            self.send_header("Retry-After", str(max(1, int(float(
                getattr(e, "retry_after_sec", 0.0) or 0.0) + 0.5))))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body.encode())
            return
        except ServiceAuthError as e:
            return self._reply(403, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        except (ServiceClosed, LookupError) as e:
            return self._reply(503, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        except KeyError as e:
            return self._reply(404, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        except ValueError as e:
            return self._reply(400, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        except Exception as e:  # a sink crash is a 500 with evidence
            return self._reply(500, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        self._reply(200, json.dumps(ack, default=str).encode(),
                    "application/json")

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path, _, query = self.path.partition("?")
        if path == "/router/submit":
            if not _router_served():
                # same opt-in rule as live ingestion below: the mutating
                # route doesn't exist unless the operator asked for it
                return self._reply(404, b"not found\n", "text/plain")
            return self._router_submit()
        m = _LIVE_ROUND_RE.match(path)
        if m is None or os.environ.get(LIVE_INGEST_ENV) != "1":
            # the mutating route doesn't EXIST unless the operator
            # opted in — a 404, not a 403, so probes learn nothing
            return self._reply(404, b"not found\n", "text/plain")
        tenant = urllib.parse.unquote(m.group(1))
        role, viewer = self._auth_role(query)
        # per-tenant credentials must match the PATH tenant: tenant A's
        # token cannot append rounds into tenant B's game
        if role == "denied" or (role == "tenant" and viewer != tenant):
            return self._deny()
        try:
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length).decode())
            if not isinstance(doc, dict):
                raise ValueError("round document must be a JSON object")
        except Exception as e:
            return self._reply(400, json.dumps(
                {"error": f"bad request body: {str(e)[:300]}"}).encode(),
                "application/json")
        try:
            ack = live_ingest(tenant, doc)
        except KeyError as e:
            return self._reply(404, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        except ValueError as e:
            return self._reply(400, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        except Exception as e:
            retry = getattr(e, "retry_after_sec", None)
            if retry is not None:
                # LiveGameFull / LiveResidencyFull: the client should
                # back off, not hammer — the hint rides the standard
                # header AND the body (sub-second resolution)
                body = json.dumps({"error": str(e)[:500],
                                   "retry_after_sec": float(retry)})
                self.send_response(429)
                self.send_header("Retry-After",
                                 str(max(1, int(float(retry) + 0.5))))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body.encode())
                return
            return self._reply(503, json.dumps(
                {"error": str(e)[:500]}).encode(), "application/json")
        self._reply(200, json.dumps(ack, default=str).encode(),
                    "application/json")

    def _deny(self) -> None:
        self.send_response(401)
        self.send_header("WWW-Authenticate", "Bearer")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args) -> None:  # silence per-request spam
        pass


class TelemetryServer:
    """One process-wide HTTP thread serving the routes above."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mplc-telemetry")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start(port: int, host: str = "127.0.0.1") -> TelemetryServer:
    """Start (or return) the process-singleton telemetry server. Binds
    loopback by default — the endpoints are unauthenticated (tenant
    names, job tables, error strings), so exposing them beyond the host
    is an explicit operator decision (`MPLC_TORCH_METRICS_PORT=host:port`),
    not a side effect."""
    global _server
    with _lock:
        if _server is None:
            srv = TelemetryServer(port, host)
            logger.info("telemetry server listening on %s:%d "
                        "(/metrics /healthz /varz)", srv.host, srv.port)
            _server = srv
        elif port not in (0, _server.port):
            warnings.warn(
                f"telemetry server already bound to :{_server.port}; "
                f"ignoring request for :{port}", stacklevel=2)
        return _server


def stop() -> None:
    """Shut the singleton down (tests; production lets the daemon die
    with the process)."""
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.close()


def active_server() -> "TelemetryServer | None":
    return _server


def active_port() -> "int | None":
    """The singleton telemetry server's bound port (None with no server
    up) — published in the fleet shard state file so a router can
    discover each shard's HTTP surface through the state dir alone."""
    srv = _server
    return srv.port if srv is not None else None


def maybe_start_from_env() -> "TelemetryServer | None":
    """Start the server iff `MPLC_TORCH_METRICS_PORT` is set. Unset/empty
    -> None with NO socket or thread created; a malformed value warns and
    stays off (telemetry must never kill the workload it watches). A
    plain port binds loopback only; `host:port` (e.g. `0.0.0.0:9090`)
    opts into wider exposure explicitly."""
    raw = os.environ.get(METRICS_PORT_ENV)
    if not raw:
        return None
    host, _, port_s = raw.rpartition(":")
    host = host or "127.0.0.1"
    try:
        port = int(port_s)
        if not 0 <= port <= 65535:
            raise ValueError(raw)
    except ValueError:
        warnings.warn(
            f"{METRICS_PORT_ENV}={raw!r} is not a port number (0-65535) "
            "or host:port; telemetry endpoints disabled", stacklevel=2)
        return None
    try:
        return start(port, host)
    except OSError as e:
        warnings.warn(
            f"telemetry server could not bind {host}:{port} ({e}); "
            "endpoints disabled", stacklevel=2)
        return None
