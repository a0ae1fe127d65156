"""The load and chaos harness of the sweep service (port of
`scripts/load_gen.py`): the benchmark that finds the service's ceiling
instead of assuming it.

`run_load()` submits a stream of mixed-shape contributivity games
(different partner counts and seeds) across priority tiers to one
`SweepService`, optionally while a seeded chaos plan
(`MPLC_TORCH_SERVICE_FAULT_PLAN=chaos@rate0.05:seed7`, faults.py) injects
random crash, stall and transient faults, then measures what the service
did about it:

  - saturation throughput: completed jobs/s and coalitions/s with the
    admission queue held at its bound by the submission loop (the loop
    backs off on `ServiceOverloaded` by the error's own `retry_after_sec`
    hint, so the harness also exercises the backoff contract);
  - per-tier tail latency: p50/p95/p99 of queue wait, time to first value
    and end-to-end seconds per priority tier (each tier submits under its
    own tenant name, so the sweep report's per-tenant slo row and the live
    /metrics histograms line up with the harness's own quantiles);
  - fairness: each tier's share of completed work against its
    stride-scheduling weight (`tier + 1`);
  - shed and quarantine accounting: every outcome that is not completed,
    by class, with the rejected-at-admission and overload-backoff counts.

And the invariant, checked on every run (`report["invariant"]`): every
accepted job reaches a terminal state (completed, shed, cancelled or
quarantined), none lost, none stuck; every shed job carries a classified
`JobShed`; and every completed job's v(S) table is bit-equal to a solo
fault-free engine run of the same game on the same device.

    python3 -m mplc_tpu_torch.load_gen --jobs 200 --chaos 0.05 \\
        --chaos-seed 7 --workers 2 --out load_report.json

The service under test is in-process; /metrics is scraped over real HTTP
when `MPLC_TORCH_METRICS_PORT` is set. `--fleet` attaches the aggregated
fleet snapshot (obs/fleet_view.py) of `MPLC_TORCH_FLEET_PEERS` or
`MPLC_TORCH_FLEET_STATE_DIR` to the report.

Fleet-router chaos mode (`--router`): the harness spawns N shard processes
(`python3 -m mplc_tpu_torch.load_gen --router-shard`: a SweepService and a
ShardServer behind the telemetry server's `/router/*` routes, publishing
heartbeats into a shared fleet state folder), fronts them with a
`FleetRouter` that discovers them through that folder alone, routes a
stream of jobs through it and SIGKILLs a shard as the
`shardkill@<shard>:sec<F>` plan says. The router must find the corpse
(stale heartbeat, then a failed /healthz probe), drain it, replay its
journal and resubmit its incomplete jobs to survivors. The invariant
extends the solo one: every routed job terminal, every completed v(S)
table bit-equal to a solo run, the failed-over ones included, and, when a
kill was planned, at least one job failed over. A kill waits for work in
progress on its shard (a job in flight whose values its WAL holds), so the
failover carries journaled values. Exit 1 when it does not hold:

    python3 -m mplc_tpu_torch.load_gen --router --jobs 8 \\
        --router-shards 2 --fault-plan 'shardkill@shard0:sec3'

Every process runs on the card unless `--device cpu` is given; a shard
process with no card and no `--device cpu` exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

# where `python3 -m mplc_tpu_torch.load_gen` finds this package: the shard
# processes run from here
_PKG_PARENT = str(Path(__file__).resolve().parents[1])
# when this module was imported: a shard process reports its start-up from
# here (its interpreter's own start and the package's import come before)
_IMPORTED_AT = time.monotonic()


def _amounts(n):
    a = [float(i + 1) for i in range(n)]
    return [x / sum(a) for x in a]


def default_scenario_builder(partners: int, seed: int, epochs: int = 1,
                             dataset: str = "titanic", device=None):
    """A builder returning a fresh small prepared Scenario at each call
    (each job gets its own: engines never share mutable scenario state
    across concurrent workers). Titanic: the family whose games train in
    seconds."""
    def build():
        from .scenario import Scenario
        sc = Scenario(partners_count=partners, amounts_per_partner=_amounts(partners),
                      dataset_name=dataset, multi_partner_learning_approach="fedavg",
                      aggregation_weighting="data-volume", epoch_count=epochs,
                      minibatch_count=2, gradient_updates_per_pass_count=2,
                      is_early_stopping=False, is_dry_run=True, seed=seed,
                      device=device)
        sc.instantiate_scenario_partners()
        sc.split_data(is_logging_enabled=False)
        sc.compute_batch_sizes()
        sc.data_corruption()
        return sc
    return build


def _quantiles(samples) -> dict:
    from .service.admission import nearest_rank
    return {"p50": nearest_rank(samples, 0.50),
            "p95": nearest_rank(samples, 0.95),
            "p99": nearest_rank(samples, 0.99),
            "max": max(samples) if samples else None,
            "count": len(samples)}


def _scrape_metrics() -> "dict | None":
    """GET /metrics off the live telemetry server (when one is up) and keep
    the service-level samples: proof the Prometheus plane survives a load
    run, and a second account to check the harness's own counts against."""
    from .obs import export as obs_export
    srv = obs_export.active_server()
    if srv is None:
        return None
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/metrics")
    token = os.environ.get(obs_export.METRICS_TOKEN_ENV)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read().decode()
    except Exception as e:
        return {"error": str(e)[:200]}
    out = {}
    for line in text.splitlines():
        if line.startswith("mplc_service_") and " " in line and "_bucket" not in line:
            name, _, val = line.rpartition(" ")
            try:
                out[name] = float(val)
            except ValueError:
                continue
    return out


def _scrape_fleet() -> "dict | None":
    """The cluster's view for `--fleet`: the aggregated fleet snapshot of
    whatever sources the environment names (HTTP peers in
    `MPLC_TORCH_FLEET_PEERS`, a fleet state folder in
    `MPLC_TORCH_FLEET_STATE_DIR`), so a load run against one shard of a
    fleet still reports the cluster-true SLO quantiles (merged histograms,
    exact at log2-bucket granularity), not only its own shard's."""
    from .obs import fleet_view
    coll = fleet_view.collector_from_env()
    if coll is None:
        return {"error": "no fleet sources configured (set MPLC_TORCH_FLEET_PEERS "
                         "or MPLC_TORCH_FLEET_STATE_DIR)"}
    try:
        snap = coll.collect()
    except Exception as e:
        return {"error": str(e)[:200]}
    return {"shard_count": snap.get("shard_count"),
            "fresh_shards": snap.get("fresh_shards"),
            "merged_sources": snap.get("merged_sources"),
            "slo": snap.get("slo"),
            "device_seconds_total": snap.get("device_seconds_total"),
            "shards": snap.get("shards")}


def solo_reference(builder) -> dict:
    """The fault-free solo-engine v(S) table of one game: the
    bit-equality oracle, run outside the service on a private engine."""
    from .contrib.engine import CharacteristicEngine
    from .contrib.shapley import powerset_order
    eng = CharacteristicEngine(builder())
    subsets = powerset_order(eng.partners_count)
    eng.evaluate(subsets)
    return {s: eng.charac_fct_values[s] for s in subsets}


def run_load(jobs: int = 1000,
             partner_shapes=(2, 3),
             game_seeds=(0, 1, 2),
             tiers=(0, 1, 2),
             epochs: int = 1,
             dataset: str = "titanic",
             chaos_plan: "str | None" = None,
             workers: "int | None" = None,
             max_pending: "int | None" = None,
             slice_coalitions: "int | None" = None,
             shed_p99_sec: "float | None" = None,
             threaded: bool = True,
             journal_path=None,
             timeout_sec: float = 24 * 3600,
             beat=None,
             scenario_builder=default_scenario_builder,
             device=None) -> dict:
    """Drive one load run and return its report (module docstring).

    `chaos_plan` is a whole `MPLC_TORCH_SERVICE_FAULT_PLAN` string (chaos
    and/or explicit entries), installed for the service's construction and
    restored afterwards. `threaded=False` runs the deterministic inline
    harness (`start=False` and `step()`): the submission loop interleaves
    stepping with submitting, so overload, shedding and chaos fire on a
    fixed, replayable schedule. `beat` is an optional liveness callback.
    `scenario_builder(partners, seed, epochs=, dataset=, device=)` returns
    a builder of fresh prepared scenarios; `device` is where they run
    (None: the card)."""
    import numpy as np

    from . import constants
    from .contrib.shapley import powerset_order
    from .obs import trace as obs_trace
    from .obs.report import sweep_report
    from .service import JobShed, ServiceOverloaded, ServiceRejected, SweepService

    beat = beat or (lambda: None)
    games = [(p, s, scenario_builder(p, s, epochs=epochs, dataset=dataset, device=device))
             for p in partner_shapes for s in game_seeds]

    env_key = constants.SERVICE_FAULT_PLAN_ENV
    saved_plan = os.environ.get(env_key)
    if chaos_plan is not None:
        os.environ[env_key] = chaos_plan
    try:
        svc = SweepService(start=threaded, workers=workers, max_pending=max_pending,
                           slice_coalitions=slice_coalitions, shed_p99_sec=shed_p99_sec,
                           journal_path=journal_path)
    finally:
        if chaos_plan is not None:
            if saved_plan is None:
                os.environ.pop(env_key, None)
            else:
                os.environ[env_key] = saved_plan

    accepted = []          # (job handle, game index, tier)
    rejected_plan = 0
    overload_backoffs = 0
    retry_after_hints = []
    t0 = time.monotonic()
    deadline = t0 + timeout_sec

    with obs_trace.collect() as recs:
        for i in range(jobs):
            gi = i % len(games)
            tier = tiers[i % len(tiers)]
            sc = games[gi][2]()
            while True:
                beat()
                try:
                    job = svc.submit(sc, tenant=f"tier{tier}", priority=tier)
                    accepted.append((job, gi, tier))
                    break
                except ServiceOverloaded as e:
                    # the backpressure contract under test: back off by the
                    # error's own hint instead of hammering submit
                    overload_backoffs += 1
                    retry_after_hints.append(e.retry_after_sec)
                    if threaded:
                        time.sleep(min(max(e.retry_after_sec, 0.005), 1.0))
                    elif not svc.step():
                        time.sleep(0.005)
                    if time.monotonic() > deadline:
                        raise TimeoutError("load run could not drain the admission "
                                           "queue within timeout_sec")
                except ServiceRejected:
                    rejected_plan += 1
                    break
        # drain every accepted job to a terminal state
        if threaded:
            stuck = []
            for job, _, _ in accepted:
                if not job._done.wait(max(deadline - time.monotonic(), 0.0)):
                    stuck.append(job.job_id)
                beat()
            svc.shutdown(drain=True, timeout=max(deadline - time.monotonic(), 1.0))
        else:
            svc.run_until_idle()
            svc.shutdown(drain=False)
            stuck = [job.job_id for job, _, _ in accepted if not job.done]
    elapsed = time.monotonic() - t0

    # -- outcome accounting and the invariant -----------------------------
    refs: dict = {}
    outcomes: dict = {}
    mismatched = []
    unclassified_sheds = []
    completed_coalitions = 0
    for job, gi, tier in accepted:
        outcomes[job.status] = outcomes.get(job.status, 0) + 1
        if job.status == "completed":
            partners, seed, builder = games[gi]
            if gi not in refs:
                refs[gi] = solo_reference(builder)
                beat()
            subsets = powerset_order(partners)
            got = np.array([job.values[s] for s in subsets])
            want = np.array([refs[gi][s] for s in subsets])
            completed_coalitions += len(subsets)
            if not np.array_equal(got, want):
                mismatched.append(job.job_id)
        elif job.status == "shed":
            if not isinstance(job.error, JobShed) or job.error.retry_after_sec < 0.0:
                unclassified_sheds.append(job.job_id)

    terminal = {"completed", "shed", "cancelled", "quarantined"}
    invariant = {
        "accepted": len(accepted),
        "terminal": sum(v for k, v in outcomes.items() if k in terminal),
        "stuck": len(stuck),
        "stuck_jobs": stuck[:20],
        "nonterminal_statuses": sorted(k for k in outcomes if k not in terminal),
        "completed_games_checked": len(refs),
        "values_bit_identical_to_solo": not mismatched,
        "mismatched_jobs": mismatched[:20],
        "sheds_classified": not unclassified_sheds,
        "holds": (not stuck and not mismatched and not unclassified_sheds
                  and all(k in terminal for k in outcomes)),
    }

    # -- per-tier latency and fairness from the collected trace ------------
    per_tier: dict = {}
    job_events = [r for r in recs if r.get("name") == "service.job"]
    for tier in sorted(set(tiers)):
        tn = f"tier{tier}"
        evs = [r["attrs"] for r in job_events if r.get("attrs", {}).get("tenant") == tn]
        done = [a for a in evs if a.get("status") == "completed"]
        per_tier[str(tier)] = {
            "weight": tier + 1,
            "jobs": len(evs),
            "completed": len(done),
            "shed": sum(1 for a in evs if a.get("status") == "shed"),
            "queue_wait_s": _quantiles([a["queue_wait_sec"] for a in evs
                                        if a.get("queue_wait_sec") is not None]),
            "ttfv_s": _quantiles([a["ttfv_sec"] for a in evs
                                  if a.get("ttfv_sec") is not None]),
            "e2e_s": _quantiles([a["seconds"] for a in done
                                 if a.get("seconds") is not None]),
        }
    total_weight = sum(t + 1 for t in tiers) or 1
    total_completed = sum(t["completed"] for t in per_tier.values()) or 1
    for tier in per_tier.values():
        tier["completed_share"] = tier["completed"] / total_completed
        tier["weight_share"] = tier["weight"] / total_weight

    rep = sweep_report(recs)
    return {
        "params": {
            "jobs": jobs, "partner_shapes": list(partner_shapes),
            "game_seeds": list(game_seeds), "tiers": list(tiers),
            "epochs": epochs, "dataset": dataset, "chaos_plan": chaos_plan,
            "workers": svc._n_workers, "max_pending": svc._max_pending,
            "slice_coalitions": svc._slice,
            "shed_p99_sec": svc._admission.shed_p99_sec, "threaded": threaded,
            "device": str(device) if device is not None else "cuda",
        },
        "wallclock_s": elapsed,
        "saturation": {
            "accepted": len(accepted),
            "completed_jobs_per_s": (outcomes.get("completed", 0) / elapsed
                                     if elapsed else None),
            "completed_coalitions_per_s": (completed_coalitions / elapsed
                                           if elapsed else None),
            "completed_coalitions": completed_coalitions,
            "overload_backoffs": overload_backoffs,
            "retry_after_hint_s": _quantiles(retry_after_hints),
            "rejected_by_fault_plan": rejected_plan,
        },
        "outcomes": outcomes,
        "per_tier": per_tier,
        "invariant": invariant,
        "admission": svc._admission.view(),
        "metrics_scrape": _scrape_metrics(),
        "service_report": {k: rep[k] for k in ("service", "slo", "resilience") if k in rep},
    }


def scenario_from_spec(spec: dict, device=None):
    """A Scenario rebuilt from a wire spec (`FleetRouter.submit(spec=)`):
    the `scenario_builder` a `--router-shard` process gives its
    `ShardServer`. The shard and the harness's solo oracle build from the
    same spec, so bit-equality is a statement about the game, not about
    pickling."""
    return default_scenario_builder(
        partners=int(spec.get("partners", 3)), seed=int(spec.get("seed", 0)),
        epochs=int(spec.get("epochs", 1)), dataset=spec.get("dataset", "titanic"),
        device=device)()


def run_router_shard(shard_id: str, workers: "int | None" = None,
                     slice_coalitions: "int | None" = None, device=None) -> int:
    """One shard process: a threaded `SweepService` journaling into the
    fleet state folder, wrapped in a `ShardServer` and served on an
    ephemeral telemetry port, publishing its state (its port, its journal,
    its metrics and device-memory peak) twice a second. Its device is
    initialised before it publishes, so the first routed job does not pay
    for the CUDA context. Runs until SIGTERM
    (a clean stop) or SIGKILL (the chaos case: the WAL is all it leaves,
    which is what failover replays). Without a card and without
    `device="cpu"` it returns 2 before serving anything."""
    import signal

    from . import constants
    from .obs import export as obs_export
    from .obs import metrics as obs_metrics
    from .service import SweepService
    from .service.router import ShardServer
    from .utils import resolve_device

    state_dir = os.environ.get(constants.FLEET_STATE_DIR_ENV)
    if not state_dir:
        print(f"[router-shard] {constants.FLEET_STATE_DIR_ENV} must be set", file=sys.stderr)
        return 2
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"[router-shard] {shard_id}: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        import torch
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    os.environ.setdefault(constants.FLEET_SHARD_ID_ENV, shard_id)
    os.environ.setdefault(constants.ROUTER_SERVE_ENV, "1")
    os.environ.setdefault(constants.METRICS_PORT_ENV, "0")
    obs_export.maybe_start_from_env()

    svc = SweepService(start=True, workers=workers or 1, slice_coalitions=slice_coalitions,
                       journal_path=os.path.join(state_dir, f"{shard_id}.wal"))
    server = ShardServer(svc, lambda spec: scenario_from_spec(spec, device))
    stop = {"flag": False}

    def _term(signum, frame):
        stop["flag"] = True
    signal.signal(signal.SIGTERM, _term)
    print(f"[router-shard] {shard_id} up on port {obs_export.active_port()} ({device}) "
          f"{time.monotonic() - _IMPORTED_AT:.2f} s after its import", file=sys.stderr)
    try:
        while not stop["flag"]:
            # the heartbeat (rate-limited inside): an idle shard stays fresh
            # in the state folder, and its first state names its port at once
            obs_metrics.sample_device_memory(device=device)
            svc._publish_fleet_state()
            time.sleep(0.1)
    finally:
        server.close()
        svc.shutdown(drain=False)
    return 0


def _shard_env(state_dir: str, shard_id: str, stale_sec: float) -> dict:
    """A shard process's environment: this process's, less JAX's and XLA's
    variables and every `MPLC_` knob that is not the port's, with the
    fleet's `MPLC_TORCH_` settings."""
    from . import constants
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))
           and (not k.startswith("MPLC_") or k.startswith("MPLC_TORCH_"))}
    env.update({constants.FLEET_STATE_DIR_ENV: state_dir,
                constants.FLEET_SHARD_ID_ENV: shard_id,
                constants.FLEET_STALE_SEC_ENV: str(stale_sec),
                constants.ROUTER_SERVE_ENV: "1",
                constants.METRICS_PORT_ENV: "0"})
    return env


def run_router(jobs: int = 8,
               shards: int = 2,
               partner_shapes=(2, 3),
               game_seeds=(0, 1),
               epochs: int = 1,
               dataset: str = "titanic",
               fault_plan: "str | None" = None,
               slice_coalitions: "int | None" = 2,
               stale_sec: float = 2.0,
               timeout_sec: float = 600.0,
               out_dir: "str | None" = None,
               device=None,
               threads: "int | None" = None,
               on_routed=None) -> dict:
    """The multi-process router chaos run (module docstring): spawn the
    shard processes, route `jobs` jobs through a `FleetRouter` that finds
    them in the state folder, SIGKILL shards as `fault_plan` says, and
    check the router invariant. A kill fires at its second or, if the
    shard then holds no work in progress, as soon as it does: a routed job
    not yet ended whose values the shard's WAL already holds. The run
    lasts until every job has ended (or `timeout_sec`), so a kill that
    never found work in progress never fires and the invariant fails.
    `device="cpu"` runs every shard and the
    solo oracle on the CPU (`threads` torch threads a shard); by default
    all run on the card. `on_routed(router, state_dir)`, when given, is
    called after every job has ended and before the shards stop. Returns
    the report."""
    import shutil
    import signal
    import subprocess
    import tempfile

    from . import constants, faults
    from .contrib.shapley import powerset_order
    from .parallel import fleet
    from .service import FleetRouter, RoutedJobFailed

    own_dir = out_dir is None
    state_dir = out_dir or tempfile.mkdtemp(prefix="mplc_router_")
    plan = faults.parse_router_fault_plan(fault_plan or "")
    # the corpse-detection clock: a killed shard's heartbeat must go stale
    # (then fail its /healthz probe) within seconds, not the 30 s default
    saved = {k: os.environ.get(k) for k in (constants.FLEET_STALE_SEC_ENV,
                                            constants.FLEET_STATE_DIR_ENV)}
    os.environ[constants.FLEET_STALE_SEC_ENV] = str(stale_sec)
    os.environ[constants.FLEET_STATE_DIR_ENV] = state_dir
    credential = os.environ.get(constants.METRICS_TOKEN_ENV) or None

    shard_ids = [f"s{i}" for i in range(shards)]
    procs: dict = {}
    for sid in shard_ids:
        cmd = [sys.executable, "-m", "mplc_tpu_torch.load_gen", "--router-shard",
               "--shard-id", sid]
        if slice_coalitions:
            cmd += ["--slice", str(slice_coalitions)]
        if device is not None:
            cmd += ["--device", str(device)]
        if threads:
            cmd += ["--threads", str(threads)]
        procs[sid] = subprocess.Popen(cmd, env=_shard_env(state_dir, sid, stale_sec),
                                      cwd=_PKG_PARENT)

    def _in_flight(sid: str) -> bool:
        # work in progress: a routed job on the shard, not yet ended, whose
        # values the shard's WAL already holds (what failover seeds from).
        # The WAL is read, never replayed: replay truncates a torn tail, and
        # the live shard may be mid-append
        live = {h.job_id for h, _, _ in handles if h.shard_id == sid and not h.done}
        if not live:
            return False
        try:
            with open(os.path.join(state_dir, f"{sid}.wal"), "rb") as f:
                lines = f.read().split(b"\n")[:-1]    # whole lines only
        except FileNotFoundError:
            return False
        for line in lines:
            try:
                rec = json.loads(line)["rec"]
            except (ValueError, KeyError, TypeError):
                continue
            if rec.get("type") == "value" and rec.get("job") in live:
                return True
        return False

    def _fire_due(t0: float) -> None:
        # the harness owns the processes, so the harness kills: SIGKILL (no
        # drain, no journal close); the router is not told and must find
        # the corpse through the state folder and a probe
        for entry in plan:
            if entry.get("_fired") or time.monotonic() - t0 < entry["at_sec"]:
                continue
            name = entry["shard"]
            sid = name if name in procs else (
                shard_ids[int(name[5:])]
                if name.startswith("shard") and name[5:].isdigit()
                and int(name[5:]) < len(shard_ids) else None)
            if sid is None or procs[sid].poll() is not None:
                entry["_fired"] = True
                continue
            if not _in_flight(sid):
                continue
            entry["_fired"] = True
            entry["fired_sec"] = time.monotonic() - t0
            print(f"[router] SIGKILL shard {sid} at t+{entry['fired_sec']:.2f}s "
                  f"(planned t+{entry['at_sec']}s)", file=sys.stderr)
            procs[sid].send_signal(signal.SIGKILL)

    report: dict = {"params": {
        "jobs": jobs, "shards": shards, "fault_plan": fault_plan,
        "slice_coalitions": slice_coalitions, "stale_sec": stale_sec,
        "partner_shapes": list(partner_shapes), "game_seeds": list(game_seeds),
        "device": str(device) if device is not None else "cuda"}}
    router = None
    handles: list = []
    try:
        # readiness: every shard must publish a port before routing
        t_spawn = time.monotonic()
        deadline = t_spawn + 120.0
        while True:
            view = fleet.cluster_view(state_dir)
            up = [sid for sid, row in view["shards"].items() if row.get("port")]
            if len(up) >= shards:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"only {up} of {shard_ids} shards published a port")
            dead = {sid: p.returncode for sid, p in procs.items() if p.poll() is not None}
            if dead:
                raise RuntimeError(f"shard processes exited during start-up: {dead}")
            time.sleep(0.1)
        report["startup_s"] = time.monotonic() - t_spawn

        router = FleetRouter(state_dir=state_dir, credential=credential)
        games = [(p, s) for p in partner_shapes for s in game_seeds]
        failed_routes = []
        t0 = time.monotonic()
        run_deadline = t0 + timeout_sec
        for i in range(jobs):
            _fire_due(t0)
            p, s = games[i % len(games)]
            spec = {"partners": p, "seed": s, "epochs": epochs, "dataset": dataset}
            try:
                h = router.submit(spec=spec, tenant=f"tier{i % 3}")
                handles.append((h, p, s))
            except RoutedJobFailed as e:
                failed_routes.append(str(e))
        while True:
            _fire_due(t0)
            pending = [h for h, _, _ in handles if not h.done]
            if not pending or time.monotonic() > run_deadline:
                break
            router.pump()
            for h in pending:
                h.values()      # polls the remote status, latches the final one
            time.sleep(0.05)
        wallclock = time.monotonic() - t0
        if on_routed is not None:
            report["on_routed"] = on_routed(router, state_dir)

        # -- the invariant ----------------------------------------------------
        refs: dict = {}
        outcomes: dict = {}
        mismatched, stuck, unclassified = [], [], []
        for h, p, s in handles:
            outcomes[h.status] = outcomes.get(h.status, 0) + 1
            if not h.done:
                stuck.append(h.job_id)
                continue
            if h.status == "failed" and not isinstance(h._error, RoutedJobFailed):
                unclassified.append(h.job_id)
            if h.status == "completed":
                if (p, s) not in refs:
                    refs[(p, s)] = solo_reference(
                        lambda p=p, s=s: scenario_from_spec(
                            {"partners": p, "seed": s, "epochs": epochs,
                             "dataset": dataset}, device))
                vals = h.values() or {}
                want = refs[(p, s)]
                subsets = powerset_order(p)
                if [vals.get(sub) for sub in subsets] != [want[sub] for sub in subsets]:
                    mismatched.append(h.job_id)
        planned_kills = len(plan)
        # a failover counts when it resubmitted a job: draining an idle
        # corpse exercises nothing
        failed_over = [h for h, _, _ in handles if h.failed_over]
        failover_ok = (router.stats["failovers"] >= 1 and bool(failed_over)
                       if planned_kills else True)
        report.update({
            "wallclock_s": wallclock,
            "outcomes": outcomes,
            "jobs": [{"job": h.job_id, "shard": h.shard_id, "status": h.status,
                      "attempts": h.attempts, "failed_over": h.failed_over,
                      "recovered_values": h.recovered_values}
                     for h, _, _ in handles],
            "router": dict(router.stats),
            "routing_table": router.varz_view()["table"],
            "invariant": {
                "accepted": len(handles),
                "failed_routes": failed_routes[:10],
                "stuck": len(stuck), "stuck_jobs": stuck[:20],
                "completed_games_checked": len(refs),
                "values_bit_identical_to_solo": not mismatched,
                "mismatched_jobs": mismatched[:20],
                "failures_classified": not unclassified,
                "planned_kills": planned_kills,
                "failovers": router.stats["failovers"],
                "kills_fired_sec": [e.get("fired_sec") for e in plan],
                "jobs_failed_over": len(failed_over),
                "values_recovered_from_wal": sum(h.recovered_values for h in failed_over),
                "failover_exercised": failover_ok,
                "holds": not stuck and not mismatched and not unclassified and failover_ok,
            },
        })
    finally:
        if router is not None:
            router.close()
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        report["exit_codes"] = {sid: p.returncode for sid, p in procs.items()}
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if own_dir:
            shutil.rmtree(state_dir, ignore_errors=True)
    return report


def _write(report: dict, out: "str | None") -> None:
    text = json.dumps(report, indent=2, default=str)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
        print(f"[load_gen] report: {out}", file=sys.stderr)
    else:
        print(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("--chaos", type=float, default=0.0,
                    help="chaos fault rate (0 disables)")
    ap.add_argument("--chaos-seed", type=int, default=7)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--max-pending", type=int, default=None)
    ap.add_argument("--slice", type=int, default=None)
    ap.add_argument("--shed-p99-sec", type=float, default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--timeout-sec", type=float, default=24 * 3600)
    ap.add_argument("--device", default=None,
                    help="where the games run: the card unless 'cpu' is given")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads of this process (and of each shard process)")
    ap.add_argument("--fleet", action="store_true",
                    help="attach the aggregated fleet snapshot (cluster-true SLO "
                         "quantiles) of MPLC_TORCH_FLEET_PEERS / "
                         "MPLC_TORCH_FLEET_STATE_DIR to the report")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--router", action="store_true",
                    help="multi-process fleet-router chaos mode: spawn --router-shards "
                         "shard processes, route --jobs jobs through a FleetRouter, "
                         "SIGKILL shards as --fault-plan says, check the router "
                         "invariant (exit 1 when it fails)")
    ap.add_argument("--router-shards", type=int, default=2)
    ap.add_argument("--fault-plan", default=None,
                    help="the router's fault plan, e.g. 'shardkill@shard0:sec3' "
                         "(default: MPLC_TORCH_ROUTER_FAULT_PLAN)")
    ap.add_argument("--stale-sec", type=float, default=2.0,
                    help="the fleet heartbeat's staleness window in --router mode")
    ap.add_argument("--router-shard", action="store_true",
                    help=argparse.SUPPRESS)   # a shard process of --router
    ap.add_argument("--shard-id", default="s0", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    if args.router_shard:
        return run_router_shard(args.shard_id, workers=args.workers,
                                slice_coalitions=args.slice, device=args.device)
    if args.router:
        from . import constants
        fault_plan = (args.fault_plan if args.fault_plan is not None
                      else os.environ.get(constants.ROUTER_FAULT_PLAN_ENV))
        report = run_router(jobs=args.jobs, shards=args.router_shards, epochs=args.epochs,
                            fault_plan=fault_plan, slice_coalitions=args.slice or 2,
                            stale_sec=args.stale_sec,
                            timeout_sec=min(args.timeout_sec, 600.0),
                            device=args.device, threads=args.threads)
        _write(report, args.out)
        inv = report["invariant"]
        print(f"[load_gen] router invariant holds: {inv['holds']} "
              f"(accepted={inv['accepted']} stuck={inv['stuck']} "
              f"bit_identical={inv['values_bit_identical_to_solo']} "
              f"failovers={inv['failovers']})", file=sys.stderr)
        return 0 if inv["holds"] else 1

    chaos_plan = (f"chaos@rate{args.chaos}:seed{args.chaos_seed}"
                  if args.chaos > 0 else None)
    report = run_load(jobs=args.jobs, chaos_plan=chaos_plan, workers=args.workers,
                      max_pending=args.max_pending, slice_coalitions=args.slice,
                      shed_p99_sec=args.shed_p99_sec, epochs=args.epochs,
                      timeout_sec=args.timeout_sec, device=args.device)
    if args.fleet:
        report["fleet"] = _scrape_fleet()
    _write(report, args.out)
    inv = report["invariant"]
    print(f"[load_gen] invariant holds: {inv['holds']} (accepted={inv['accepted']} "
          f"stuck={inv['stuck']} bit_identical={inv['values_bit_identical_to_solo']})",
          file=sys.stderr)
    return 0 if inv["holds"] else 1


if __name__ == "__main__":
    sys.exit(main())
