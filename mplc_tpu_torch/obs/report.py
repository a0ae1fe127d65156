"""Sweep reports: aggregate trace records + metrics into a per-run JSON
sidecar and a human-readable summary (port of `mplc_tpu/obs/report.py`,
whole).

The schema, the key names and the formatting are the JAX package's, so one
reader takes either package's report, and `sweep_report` gives equal dicts
on equal records (tests/test_torch_report.py). The resilience row reads the
port's fault-ladder events (`engine.retry`, `engine.degrade`,
`engine.fault`, the `degraded="cpu"` batches) as it reads the JAX
engine's (tests/test_torch_ladder.py holds the two rows equal on one game
and plan). The program bank, device fence, service, live, router and
numerics rows read the events the port's modules emit under the JAX
names (PRs 16-19); a row whose events a run did not emit stays absent or
zero, as it does on a JAX stream without them. The port's own names
(`obs/trace.py` `PORT_SPANS`: the batch path's leaf spans, set-up's) fall
through every row, so a port stream reports as a JAX one; the device
fence row reads only the fence's `interval` (its device seconds ride the
`engine.batch` event as well). Paths below name the JAX package's
modules.

`sweep_report(records)` consumes the span/event records collected during a
run (`obs.trace.collect()`, or a parsed JSONL trace file) and derives the
quantities every perf PR needs as a measured before/after:

  - wall-clock split: compile vs prep vs dispatch vs harvest inside the
    engine's evaluate() time (compile happens *inside* the first
    dispatch/harvest of each program, so the components are reported raw,
    not disjoint); `prep` is the whole-call host-side batch construction —
    coalition arrays, rng fold words, batch-invariant device placements —
    done once per bucket before its dispatch loop;
  - memo hit/miss counts and hit rate (from engine.evaluate span attrs);
  - padding waste: padded slots / total batch slots over the whole run;
  - per-(slot_count, width) bucket throughput: coalitions and epochs per
    span-second (span-sum, which under the JAX package's batch pipelining counts
    overlapped batches twice — a utilization view, not a wall-clock one);
  - per-executable compile counts/seconds and per-estimator durations;
  - a compute/intensity row: training samples and partner passes summed
    from the engine.batch events, and — when the caller supplies the
    model's forward FLOPs per sample (models/zoo.fwd_flops_per_sample or
    the XLA cost model) — a model-FLOPs rate over the evaluate wall-clock
    plus an MFU proxy against a supplied peak-FLOPs figure (a HOST-side
    proxy: dispatch is async, so the denominator is host wall-clock);
    when the stream carries XLA cost truth the row additionally gains
    `mfu_xla` — Compiled.cost_analysis() flops over measured device time
    where fenced samples exist;
  - a device_time row (the device-fence rate knob, obs/devcost.py):
    measured device-step-seconds from the sampled fences, the
    per-coalition extrapolated device-seconds figure, and the
    enqueue/device/harvest host-overhead split;
  - a roofline row: per-program achieved FLOP/s vs peak and bytes/s vs
    HBM bandwidth with arithmetic intensity, from the program bank's
    per-bundle cost analysis;
  - a resilience row: transient retries and backoff seconds
    (engine.retry events), OOM cap halvings and the CPU-path flip
    (engine.degrade), batches/coalitions that ran on the degraded CPU
    rung, and injected-fault counts (engine.fault) — so every recorded
    number says whether it was earned on a clean or a degraded run;
  - a trust row (seed-ensemble sweeps only): per-partner Shapley
    confidence intervals and the Kendall-tau rank-stability score from
    the `contrib.trust` event — so a reported ranking says how much the
    seeds agree on it;
  - a service row (multi-tenant sweep-service runs): job outcomes
    (completed/quarantined/cancelled/recovered), the cross-tenant
    packed-batch count, and per-tenant fair-share cost attribution from
    the `service.slice` spans' batch accounting;
  - a live row (live-contributivity-tier runs): query counts and memo
    hits, reconstruction evaluations and DPVS-pruned coalitions, rounds
    appended/resident and journal-restored games, fresh-query latency
    quantiles and per-method counts from the `live.query` events —
    mirroring the `live.query_sec` histogram and per-tenant
    rounds-resident gauge the /metrics endpoint exports;
  - an slo row (service runs): per-tenant latency quantiles — queue wait
    (submit -> first quantum) and time-to-first-value from the terminal
    `service.job` events, slice-duration p50/p95/p99 from the
    `service.slice` spans — plus deadline misses and re-queued attempts
    (`service.job_fault`), mirroring the live per-tenant histograms the
    /metrics endpoint exports (obs/export.py);
  - a router row (fleet-router runs): jobs routed through the front,
    redirect resubmits, sticky-pin breaks, shard failovers with the
    journal-seeded jobs they resubmitted, budget exhaustions, and
    end-to-end routing-latency quantiles from the `router.submit`
    spans — mirroring the live `router.*` counters and the
    `router.route_sec` histogram.

The report is derived from SPANS of the collected region only, so callers
get a clean per-run view without resetting the process-global metrics
registry; the registry snapshot can be attached for cumulative context.
"""

from __future__ import annotations

import json
import os


def _attrs(rec: dict) -> dict:
    return rec.get("attrs") or {}


def _pctl(values: list, q: float) -> float | None:
    """Nearest-rank percentile of a small sample (exact, no buckets —
    the report works from the collected region's full duration lists,
    unlike the live /metrics histograms)."""
    if not values:
        return None
    vals = sorted(values)
    rank = max(1, -(-int(q * 100) * len(vals) // 100))  # ceil without math
    return vals[min(rank, len(vals)) - 1]


def sweep_report(records: list, metrics_snapshot: dict | None = None,
                 flops_per_sample: float | None = None,
                 peak_flops: float | None = None,
                 hbm_bytes_per_s: float | None = None) -> dict:
    """Aggregate a list of trace records (dicts) into the sweep report.

    `flops_per_sample` (the model's analytic/XLA-measured forward FLOPs for
    ONE training sample) turns the summed trained-sample count into a
    model-FLOPs rate (fwd+bwd ~ 3x fwd, padded rows and val/test evals
    excluded — a conservative lower bound on the device rate);
    `peak_flops` (the attached fleet's aggregate peak) additionally yields
    `mfu_proxy` = achieved / peak — a HOST-side proxy. When the record
    stream carries XLA cost truth (per-batch `flops`/`bytes_accessed`
    attrs from program-bank bundles) and/or sampled device fences
    (`device_sec` attrs, the device-fence rate knob), the report
    additionally derives `mfu_xla`, a `device_time` row (true
    device-step seconds, host-overhead split, the fenced-extrapolation
    device-seconds figure) and a per-program `roofline` row (achieved
    FLOP/s vs `peak_flops`, bytes/s vs `hbm_bytes_per_s`, arithmetic
    intensity). Record streams without those attrs — every pre-devcost
    sidecar — produce exactly the old schema."""
    evaluate_s = prep_s = dispatch_s = harvest_s = compile_s = 0.0
    compile_overlapped_s = bank_wait_s = 0.0
    bank_compiles = bank_compiles_overlapped = 0
    hbm = None
    requested = missing = 0
    compiles: dict = {}
    buckets: dict = {}
    batches = coalitions = padding = epochs = 0
    samples = partner_passes = 0
    estimators = []
    fits = []
    retries = 0
    backoff_s = 0.0
    cap_halvings = cpu_fallbacks = ladder_exhausted = 0
    cpu_batches = cpu_coalitions = 0
    faults_injected = 0
    svc_tenants: dict = {}
    svc_jobs: dict = {}
    svc_slice_durs: dict = {}   # tenant -> [slice seconds]
    svc_job_faults: dict = {}   # tenant -> failed-attempt count
    trust = None
    per_method: dict = {}
    live_queries: list = []         # (dur, attrs) of live.query events
    live_appends = live_recovers = 0
    live_evictions = live_ingested = 0
    live_restores: list = []        # restore_s of live.restore events
    # adaptive query planner (contrib/planner.py): every contrib.plan /
    # live.plan event is one method="auto" resolution
    plans: list = []
    # numeric-truth plane (obs/numerics.py): audit/drift events and the
    # last ledger-persist event
    num_audits = num_drift = 0
    num_max_ulp = 0
    num_mode = None
    num_ledger = None
    recon_batches = recon_coalitions = 0
    recon_s = 0.0
    recorded = None
    # device-time truth (obs/devcost.py): fenced device-step samples and
    # XLA-modeled per-batch cost, when the stream carries them
    fence_samples: list = []        # measured device_sec per fenced batch
    fenced_coalitions = 0
    fence_interval = None
    flops_total = bytes_total = 0.0
    costed_batches = 0
    costed_span_s = 0.0
    fenced_flops = fenced_flops_sec = 0.0
    roof: dict = {}                 # (slot_count, width) -> cost buckets
    # fleet-router events (service/router.py): counts mirror the live
    # router.* counters; route_durs mirrors the router.route_sec histogram
    rtr = {"routed": 0, "resubmits": 0, "repins": 0, "failovers": 0,
           "failover_jobs": 0, "budget_exhausted": 0}
    rtr_route_durs: list = []

    for rec in records:
        name = rec.get("name")
        dur = float(rec.get("dur") or 0.0)
        a = _attrs(rec)
        if name == "engine.evaluate":
            evaluate_s += dur
            requested += int(a.get("requested", 0))
            missing += int(a.get("missing", 0))
            m = a.get("method")
            if m:
                # per-estimator memo attribution (mixed-method runs):
                # hits = requested - misses within THIS method's calls
                d = per_method.setdefault(m, {"requested": 0, "misses": 0})
                d["requested"] += int(a.get("requested", 0))
                d["misses"] += int(a.get("missing", 0))
        elif name == "engine.prep":
            prep_s += dur
        elif name == "engine.dispatch":
            dispatch_s += dur
        elif name == "engine.harvest":
            harvest_s += dur
        elif name == "trainer.compile":
            compile_s += dur
            fn = a.get("fn", "?")
            c = compiles.setdefault(fn, {"count": 0, "seconds": 0.0})
            c["count"] += 1
            c["seconds"] += dur
        elif name == "bank.compile":
            # AOT program-bank compiles: background (overlapped=True) ones
            # ran CONCURRENTLY with execution and are reported separately
            # — they never extended the sweep's wall-clock; foreground
            # ones (the first bucket) are serial compile time like any
            # jit-inline compile
            bank_compiles += 1
            if a.get("overlapped"):
                bank_compiles_overlapped += 1
                compile_overlapped_s += dur
            else:
                compile_s += dur
            fn = f"bank[slots={a.get('slot_count')},w={a.get('width')}]"
            c = compiles.setdefault(fn, {"count": 0, "seconds": 0.0})
            c["count"] += 1
            c["seconds"] += dur
        elif name == "bank.wait":
            # serial stall behind the background compile worker: wall-
            # clock that DID block the sweep even though the compile
            # itself is booked as overlapped (wall vs CPU views of the
            # same work — kept separate so the compile row stays honest)
            bank_wait_s += dur
            compile_s += dur
        elif name == "engine.hbm":
            # one snapshot per evaluate() call; the last one wins (like
            # the trust row) — the per-coalition footprint model and the
            # donation cap uplift don't change mid-run except down the
            # OOM ladder, where the latest view is exactly the right one
            hbm = dict(a)
        elif name == "engine.batch":
            k = (a.get("slot_count"), int(a.get("width", 0)))
            b = buckets.setdefault(k, {"batches": 0, "coalitions": 0,
                                       "padding": 0, "epochs": 0,
                                       "seconds": 0.0})
            b["batches"] += 1
            b["coalitions"] += int(a.get("coalitions", 0))
            b["padding"] += int(a.get("padding", 0))
            b["epochs"] += int(a.get("epochs", 0))
            b["seconds"] += dur
            batches += 1
            coalitions += int(a.get("coalitions", 0))
            padding += int(a.get("padding", 0))
            epochs += int(a.get("epochs", 0))
            samples += int(a.get("samples", 0))
            partner_passes += int(a.get("partner_passes", 0))
            if a.get("degraded") == "cpu":
                cpu_batches += 1
                cpu_coalitions += int(a.get("coalitions", 0))
            if a.get("eval_only"):
                # reconstructed-coalition eval batch (retrain-free
                # estimators): rides the same buckets but trains nothing
                recon_batches += 1
                recon_coalitions += int(a.get("coalitions", 0))
                recon_s += dur
            dsec = a.get("device_sec")
            fl = a.get("flops")
            if dsec is not None:
                fence_samples.append(float(dsec))
                fenced_coalitions += int(a.get("coalitions", 0))
            if fl:
                flops_total += float(fl)
                bytes_total += float(a.get("bytes_accessed") or 0.0)
                costed_batches += 1
                costed_span_s += dur
                rb = roof.setdefault(k, {
                    "batches": 0, "flops": 0.0, "bytes": 0.0,
                    "span_s": 0.0, "fenced_s": 0.0, "fenced_flops": 0.0,
                    "fenced_bytes": 0.0})
                rb["batches"] += 1
                rb["flops"] += float(fl)
                rb["bytes"] += float(a.get("bytes_accessed") or 0.0)
                rb["span_s"] += dur
                if dsec is not None:
                    rb["fenced_s"] += float(dsec)
                    rb["fenced_flops"] += float(fl)
                    rb["fenced_bytes"] += float(a.get("bytes_accessed")
                                                or 0.0)
                    fenced_flops += float(fl)
                    fenced_flops_sec += float(dsec)
        elif name == "engine.device_fence":
            # the fence's own event carries the sampling config; the
            # per-batch samples are aggregated off engine.batch above
            if a.get("interval"):
                fence_interval = int(a["interval"])
        elif name == "recon.record":
            # the grand-coalition recording run (one per engine); the last
            # event wins, like the trust row
            recorded = {**a, "seconds": dur}
        elif name == "engine.retry":
            retries += 1
            backoff_s += float(a.get("backoff_sec", 0.0))
        elif name == "engine.degrade":
            # every halve/fallback event is one rung down the ladder (the
            # last rung flips the engine onto the per-batch CPU path);
            # `ladder_exhausted` is the 2-D dead end — the classified
            # terminal error where no CPU rung exists — and is NOT a rung
            if a.get("action") == "ladder_exhausted":
                ladder_exhausted += 1
            else:
                cap_halvings += 1
                if a.get("action") == "cpu_fallback":
                    cpu_fallbacks += 1
        elif name == "engine.fault":
            faults_injected += 1
        elif name == "service.slice":
            # one scheduling quantum of the sweep service: per-tenant
            # batch/sample accounting for fair-share cost attribution
            t = svc_tenants.setdefault(a.get("tenant", "?"), {
                "slices": 0, "failed_slices": 0, "batches": 0,
                "coalitions": 0, "epochs": 0, "samples": 0,
                "packed_batches": 0, "seconds": 0.0,
                "device_seconds": 0.0})
            # metered device-seconds billed to this quantum
            # (scheduler._meter_quantum; absent on pre-devcost streams)
            t["device_seconds"] += float(a.get("device_sec") or 0.0)
            if a.get("outcome"):
                # the replacement event for a cancelled/faulted quantum
                # (its real span was cancelled, never emitted): its
                # device billing counts above, but slice counts,
                # span-seconds and the slo quantiles must keep mirroring
                # the live service.slice_sec histogram — which observes
                # only SUCCESSFUL quanta
                t["failed_slices"] += 1
                continue
            t["slices"] += 1
            t["batches"] += int(a.get("batches", 0))
            t["coalitions"] += int(a.get("coalitions", 0))
            t["epochs"] += int(a.get("epochs", 0))
            t["samples"] += int(a.get("samples", 0))
            t["packed_batches"] += int(a.get("packed_batches", 0))
            t["seconds"] += dur
            svc_slice_durs.setdefault(a.get("tenant", "?"), []).append(dur)
        elif name == "service.job":
            # terminal job event (completed / quarantined / cancelled)
            svc_jobs[a.get("job", "?")] = a
        elif name == "service.job_fault" and a.get("requeued"):
            # only RE-QUEUED attempts count as retries (the quarantining
            # final attempt does not) — same rule as the live
            # service.job_retries counter this row mirrors
            tn = a.get("tenant", "?")
            svc_job_faults[tn] = svc_job_faults.get(tn, 0) + 1
        elif name == "router.submit":
            rtr["routed"] += 1
            # a zero-duration event whose route_s attr carries the
            # measured submit->accept latency (redirects + backoff
            # included), mirroring the router.route_sec histogram
            rtr_route_durs.append(float(a.get("route_s") or dur))
        elif name == "router.redirect":
            rtr["resubmits"] += 1
        elif name == "router.repin":
            rtr["repins"] += 1
        elif name == "router.failover":
            rtr["failovers"] += 1
            rtr["failover_jobs"] += int(a.get("resubmitted", 0))
        elif name == "router.exhausted":
            rtr["budget_exhausted"] += 1
        elif name == "numerics.audit":
            num_audits += 1
            num_max_ulp = max(num_max_ulp, int(a.get("max_ulp") or 0))
            num_mode = a.get("reduction_mode") or num_mode
        elif name == "numerics.drift":
            num_drift += 1
        elif name == "numerics.ledger":
            # one persist per evaluate(); the last event carries the
            # final entry count
            num_ledger = dict(a)
        elif name in ("contrib.plan", "live.plan"):
            plans.append(dict(a))
        elif name == "live.query":
            live_queries.append((dur, a))
        elif name == "live.append":
            live_appends += 1
        elif name == "live.recover":
            live_recovers += 1
        elif name == "live.evict":
            live_evictions += 1
        elif name == "live.restore":
            live_restores.append(float(a.get("restore_s") or 0.0))
        elif name == "live.ingest":
            live_ingested += 1
        elif name == "contrib.trust":
            # one trust row per sweep; the last event wins (a re-run of
            # the estimator within one collected region supersedes)
            trust = dict(a)
        elif name == "contributivity":
            estimators.append({"method": a.get("method", "?"), "seconds": dur})
        elif name == "mpl.fit":
            fits.append({"approach": a.get("approach", "?"), "seconds": dur})

    slots_total = coalitions + padding
    hits = requested_unique_hits = max(requested - missing, 0)
    per_width = []
    for (slot_count, width), b in sorted(
            buckets.items(), key=lambda kv: (kv[0][0] is None,
                                             kv[0][0] or 0, kv[0][1])):
        s = b["seconds"]
        per_width.append({
            "slot_count": slot_count, "width": width, **b,
            "coalitions_per_s": b["coalitions"] / s if s else None,
            "epochs_per_s": b["epochs"] / s if s else None,
        })

    # compute/intensity: model-FLOPs rate over the engine's evaluate
    # wall-clock (falling back to the bucket span-sum for record sets
    # collected without an evaluate span). Training compute only — padded
    # rows and val/test evals are excluded, so the true device rate is
    # strictly higher; the point is a comparable, attributable proxy.
    basis_s = evaluate_s or sum(b["seconds"] for b in buckets.values())
    compute = {
        "train_samples": samples,
        "partner_passes": partner_passes,
        "samples_per_s": samples / basis_s if basis_s else None,
        "flops_per_sample_fwd": flops_per_sample,
        "model_flops": None,
        "model_flops_per_s": None,
        "peak_flops": peak_flops,
        "mfu_proxy": None,
    }
    if flops_per_sample and samples:
        compute["model_flops"] = 3.0 * flops_per_sample * samples
        if basis_s:
            compute["model_flops_per_s"] = compute["model_flops"] / basis_s
            if peak_flops:
                compute["mfu_proxy"] = \
                    compute["model_flops_per_s"] / peak_flops
    # XLA-derived utilization (obs/devcost.py): modeled flops come from
    # Compiled.cost_analysis() instead of the hand-derived analytic
    # estimate, and — when fenced samples exist — the denominator is
    # measured DEVICE time instead of host span. Supersedes mfu_proxy
    # when present; the analytic proxy stays rendered as the fallback.
    if flops_total:
        compute["model_flops_xla"] = flops_total
        if fenced_flops_sec:
            compute["xla_flops_per_s"] = fenced_flops / fenced_flops_sec
            compute["mfu_xla_basis"] = "device_fenced"
        elif costed_span_s:
            compute["xla_flops_per_s"] = flops_total / costed_span_s
            compute["mfu_xla_basis"] = "host_span"
        else:
            compute["xla_flops_per_s"] = None
            compute["mfu_xla_basis"] = None
        compute["mfu_xla"] = (compute["xla_flops_per_s"] / peak_flops
                              if compute["xla_flops_per_s"] and peak_flops
                              else None)

    report = {
        "wallclock": {
            "evaluate_s": evaluate_s,
            "compile_s": compile_s,
            # program-bank compiles that ran on the background thread
            # while earlier buckets executed — spent CPU, not wall-clock
            "compile_overlapped_s": compile_overlapped_s,
            "prep_s": prep_s,
            "dispatch_s": dispatch_s,
            "harvest_s": harvest_s,
        },
        "compute": compute,
        "memo": {
            "requested": requested,
            "hits": hits,
            "misses": missing,
            "hit_rate": requested_unique_hits / requested if requested else None,
            # per-estimator memo attribution lands below, only when at
            # least one engine.evaluate span carried a method — old
            # (method-less) record streams keep the exact old schema
        },
        "batches": {
            "count": batches,
            "coalitions": coalitions,
            "padding": padding,
            "pad_waste_fraction": padding / slots_total if slots_total else None,
            "epochs_trained": epochs,
        },
        "resilience": {
            "retries": retries,
            "backoff_s": backoff_s,
            "cap_halvings": cap_halvings,
            "cpu_degraded": cpu_fallbacks > 0,
            "cpu_batches": cpu_batches,
            "cpu_coalitions": cpu_coalitions,
            # 2-D ladder dead ends (LadderExhaustedError raised): the
            # sweep could not make progress at any cap and had no CPU
            # rung — under the service this quarantines one tenant's job
            "ladder_exhausted": ladder_exhausted,
            "faults_injected": faults_injected,
        },
        "per_width": per_width,
        "compiles": compiles,
        "estimators": estimators,
    }
    if bank_compiles or bank_wait_s:
        report["program_bank"] = {
            "compiles": bank_compiles,
            "compiles_overlapped": bank_compiles_overlapped,
            "overlapped_s": compile_overlapped_s,
            # wall-clock the sweep spent BLOCKED on the background
            # worker (already included in wallclock.compile_s)
            "waited_s": bank_wait_s,
        }
    if hbm is not None:
        # the donation/HBM view: modeled per-coalition footprint, the
        # buffer-donation saving, and the coalition-cap autotune before
        # vs after donation (the knob headroom donation buys)
        report["hbm"] = {
            "param_bytes": hbm.get("param_bytes"),
            "slot_count": hbm.get("slot_count"),
            "donation": hbm.get("donation"),
            "per_coalition_bytes": hbm.get("per_coalition_bytes"),
            "donated_bytes_per_coalition":
                hbm.get("donated_bytes_per_coalition"),
            "cap_before_donation": hbm.get("cap_before_donation"),
            "cap_after_donation": hbm.get("cap_after_donation"),
            "cap_effective": hbm.get("cap_effective"),
            "hbm_bytes_limit": hbm.get("hbm_bytes_limit"),
            "peak_in_use_bytes": hbm.get("peak_in_use_bytes"),
        }
    if per_method:
        report["memo"]["per_method"] = {
            m: {"requested": d["requested"],
                "hits": max(d["requested"] - d["misses"], 0),
                "misses": d["misses"],
                "hit_rate": (max(d["requested"] - d["misses"], 0)
                             / d["requested"]
                             if d["requested"] else None)}
            for m, d in sorted(per_method.items())}
    if recon_batches or recorded is not None:
        # retrain-free runs only: recorded-update memory, reconstruction
        # throughput, and the eval-vs-train pass split that PROVES the
        # asymptotic claim (training passes only from the recording run)
        report["reconstruction"] = {
            "recorded_rounds": (recorded or {}).get("rounds"),
            "recorded_partners": (recorded or {}).get("partners"),
            "recorded_update_bytes": (recorded or {}).get("memory_bytes"),
            "recording_seconds": (recorded or {}).get("seconds"),
            "recording_partner_passes":
                (recorded or {}).get("training_passes"),
            "reconstructions": recon_coalitions,
            "recon_batches": recon_batches,
            "reconstructions_per_s":
                recon_coalitions / recon_s if recon_s else None,
            "train_partner_passes": partner_passes,
            "train_batches": batches - recon_batches,
        }
    if fence_samples or flops_total:
        # device-time truth: fenced device-step samples (the measured
        # side) and the host-overhead split. The extrapolation rule is
        # per-COALITION (batch widths vary): device_s ≈ fenced seconds ×
        # TRAINING coalitions / fenced coalitions — eval-only
        # reconstruction coalitions cost orders of magnitude less and
        # are excluded from the training-rate extrapolation (their count
        # is reported separately). With fences off but XLA cost known, a
        # peak figure yields the cost-model estimate instead (an
        # optimistic lower bound — assumes peak-rate execution).
        fs = sorted(fence_samples)
        # eval-only reconstruction AND CPU-degraded-rung coalitions are
        # excluded: both run at rates wildly different from a fenced
        # device training batch (the CPU rung no longer fences at all)
        train_coalitions = coalitions - recon_coalitions - cpu_coalitions
        if fenced_coalitions and train_coalitions > 0:
            device_s = (sum(fence_samples) * train_coalitions
                        / fenced_coalitions)
            basis = "fenced"
        elif flops_total and peak_flops:
            device_s = flops_total / peak_flops
            basis = "cost_model"
        else:
            device_s, basis = None, None
        report["device_time"] = {
            "fence_interval": fence_interval,
            "fenced_batches": len(fence_samples),
            "fenced_coalitions": fenced_coalitions,
            "device_step_s": {
                "count": len(fs),
                "sum": sum(fs),
                "mean": sum(fs) / len(fs) if fs else None,
                "p50": _pctl(fs, 0.50),
                "p95": _pctl(fs, 0.95),
                "max": fs[-1] if fs else None,
            },
            "device_s": device_s,
            "basis": basis,
            # eval-only reconstruction / CPU-degraded coalitions
            # excluded from the training-rate extrapolation above
            # (billed at host span by the meter)
            "eval_coalitions_excluded": recon_coalitions,
            "degraded_coalitions_excluded": cpu_coalitions,
            # the host-overhead split the fences make meaningful:
            # enqueue (dispatch spans) vs device (above) vs harvest
            "enqueue_s": dispatch_s,
            "harvest_s": harvest_s,
            "prep_s": prep_s,
        }
    if roof:
        # per-program roofline: XLA-modeled flops/bytes per bundle
        # execution against the fleet's peak FLOP/s and HBM bandwidth.
        # Achieved rates use measured fenced device time when the
        # program has samples, the (pipelining-inflated) host span
        # otherwise — the basis says which.
        rows = []
        for (slot_count, width), rb in sorted(
                roof.items(), key=lambda kv: (kv[0][0] is None,
                                              kv[0][0] or 0, kv[0][1])):
            if rb["fenced_s"]:
                ach_f = rb["fenced_flops"] / rb["fenced_s"]
                ach_b = rb["fenced_bytes"] / rb["fenced_s"]
                basis = "device_fenced"
            elif rb["span_s"]:
                ach_f = rb["flops"] / rb["span_s"]
                ach_b = rb["bytes"] / rb["span_s"]
                basis = "host_span"
            else:
                ach_f = ach_b = basis = None
            rows.append({
                "slot_count": slot_count, "width": width,
                "batches": rb["batches"],
                "flops_per_batch": rb["flops"] / rb["batches"],
                "bytes_per_batch": rb["bytes"] / rb["batches"],
                "arithmetic_intensity": (rb["flops"] / rb["bytes"]
                                         if rb["bytes"] else None),
                "achieved_flops_per_s": ach_f,
                "achieved_bytes_per_s": ach_b,
                "basis": basis,
                "mfu": (ach_f / peak_flops
                        if ach_f and peak_flops else None),
                "hbm_fraction": (ach_b / hbm_bytes_per_s
                                 if ach_b and hbm_bytes_per_s else None),
            })
        report["roofline"] = {"peak_flops": peak_flops,
                              "hbm_peak_bytes_per_s": hbm_bytes_per_s,
                              "programs": rows}
    if (live_queries or live_appends or live_recovers or live_evictions
            or live_restores or live_ingested):
        # the live contributivity tier's view: fresh-query latency (memo
        # hits kept separate — they answer in microseconds and would
        # flatter the quantiles), evaluation/pruning totals, and the
        # resident-round level the latest query saw
        fresh = sorted(d for d, a in live_queries if not a.get("memo_hit"))
        per_m: dict = {}
        for _d, a in live_queries:
            m = a.get("method", "?")
            per_m[m] = per_m.get(m, 0) + 1
        report["live"] = {
            "queries": len(live_queries),
            "memo_hits": sum(1 for _d, a in live_queries
                             if a.get("memo_hit")),
            "evaluations": sum(int(a.get("evaluations") or 0)
                               for _d, a in live_queries),
            "pruned_coalitions": sum(int(a.get("pruned") or 0)
                                     for _d, a in live_queries),
            "rounds_appended": live_appends,
            "recovered_games": live_recovers,
            # the residency tier (live/residency.py): evictions seen in
            # the collected region, restores + their WAL-replay latency
            # quantiles (ingested counts the POST /live/<t>/round path)
            "evictions": live_evictions,
            "restores": len(live_restores),
            "restore_s": {
                "count": len(live_restores),
                "p50": _pctl(sorted(live_restores), 0.50),
                "p95": _pctl(sorted(live_restores), 0.95),
                "max": max(live_restores) if live_restores else None,
            },
            "rounds_ingested": live_ingested,
            "rounds_resident": (int(live_queries[-1][1].get("rounds", 0))
                                if live_queries else None),
            "per_method": per_m,
            "query_s": {
                "count": len(fresh),
                "p50": _pctl(fresh, 0.50),
                "p95": _pctl(fresh, 0.95),
                "max": fresh[-1] if fresh else None,
            },
        }
    if plans:
        # the adaptive-planner row: how many method="auto" requests
        # resolved, to which concrete estimators, and the last resolved
        # plan in full (its reason is the routing-table row that fired)
        routed: dict = {}
        for p in plans:
            m = p.get("method", "?")
            routed[m] = routed.get(m, 0) + 1
        report["planner"] = {
            "auto_queries": len(plans),
            "routed": routed,
            "last": plans[-1],
        }
    if svc_tenants or svc_jobs:
        # the multi-tenant service view: job outcomes, the cross-tenant
        # program-packing win, and fair-share cost attribution — each
        # tenant's share of the service's metered DEVICE-seconds
        # (obs/devcost.py; span-seconds kept as host_share, and the
        # cost_share falls back to it for pre-devcost record streams)
        total_s = sum(t["seconds"] for t in svc_tenants.values())
        total_dev = sum(t.get("device_seconds", 0.0)
                        for t in svc_tenants.values())
        by_status: dict = {}
        for a in svc_jobs.values():
            s = a.get("status", "?")
            by_status[s] = by_status.get(s, 0) + 1
        report["service"] = {
            "jobs": len(svc_jobs),
            "completed": by_status.get("completed", 0),
            "quarantined": by_status.get("quarantined", 0),
            "cancelled": by_status.get("cancelled", 0),
            # overload-governor sheds: a classified outcome of its own,
            # never folded into cancelled/quarantined
            "shed": by_status.get("shed", 0),
            "recovered": sum(1 for a in svc_jobs.values()
                             if a.get("recovered")),
            "cross_tenant_packed_batches": sum(
                t["packed_batches"] for t in svc_tenants.values()),
            # cost_share bills by metered DEVICE-seconds when the stream
            # carries them (what the accelerator actually did for each
            # tenant), falling back to the old span-seconds share for
            # pre-devcost streams; host_share is always the span view
            "cost_basis": ("device_seconds"
                           if any(t.get("device_seconds")
                                  for t in svc_tenants.values())
                           else "host_span"),
            "per_tenant": {
                name: {**t,
                       "host_share": (t["seconds"] / total_s
                                      if total_s else None),
                       "cost_share": (
                           t.get("device_seconds", 0.0) / total_dev
                           if total_dev else
                           (t["seconds"] / total_s if total_s else None))}
                for name, t in sorted(svc_tenants.items())},
        }
        # the per-tenant SLO view: exact quantiles over the collected
        # region (the live /metrics endpoint serves the same series as
        # log-bucket histograms). Old record streams (pre-SLO
        # service.job events) simply have empty latency lists.
        slo: dict = {}
        tenants = (set(svc_slice_durs) | set(svc_job_faults)
                   | {a.get("tenant", "?") for a in svc_jobs.values()})
        for tn in sorted(tenants):
            jobs = [a for a in svc_jobs.values()
                    if a.get("tenant", "?") == tn]
            qw = [a["queue_wait_sec"] for a in jobs
                  if a.get("queue_wait_sec") is not None]
            ttfv = [a["ttfv_sec"] for a in jobs
                    if a.get("ttfv_sec") is not None]
            sl = svc_slice_durs.get(tn, [])
            slo[tn] = {
                "jobs": len(jobs),
                "queue_wait_s": {"p50": _pctl(qw, 0.50),
                                 "p95": _pctl(qw, 0.95),
                                 "max": max(qw) if qw else None},
                "ttfv_s": {"p50": _pctl(ttfv, 0.50),
                           "p95": _pctl(ttfv, 0.95),
                           "max": max(ttfv) if ttfv else None},
                "slice_s": {"count": len(sl),
                            "p50": _pctl(sl, 0.50),
                            "p95": _pctl(sl, 0.95),
                            "p99": _pctl(sl, 0.99)},
                "deadline_misses": sum(
                    1 for a in jobs if a.get("deadline_missed")),
                "retries": svc_job_faults.get(tn, 0),
            }
        report["slo"] = slo
    if rtr["routed"] or rtr["resubmits"] or rtr["failovers"]:
        # the fleet-router row: how the front spread work over shards and
        # what it cost to keep jobs alive through redirects and deaths —
        # runs without a router produce no row at all
        report["router"] = {
            **rtr,
            "route_s": {"p50": _pctl(rtr_route_durs, 0.50),
                        "p95": _pctl(rtr_route_durs, 0.95),
                        "p99": _pctl(rtr_route_durs, 0.99)},
        }
    if num_audits or num_drift or num_ledger is not None:
        # the numeric-truth row: reduction audits run, order divergences
        # localized (with the worst ulp distance), and the ledger's
        # persisted size — old record streams produce no row at all
        report["numerics"] = {
            "audits": num_audits,
            "drift_events": num_drift,
            "max_ulp": num_max_ulp,
            "reduction_mode": (num_mode
                               or (num_ledger or {}).get("reduction_mode")),
            "ledger_entries": (num_ledger or {}).get("entries"),
            "ledger_path": (num_ledger or {}).get("path"),
        }
    if trust is not None:
        report["trust"] = trust
    if fits:
        report["fits"] = fits
    if metrics_snapshot is not None:
        report["metrics"] = metrics_snapshot
    return report


def format_report(report: dict) -> str:
    """Human-readable summary table of a sweep_report() dict."""
    w = report["wallclock"]
    m = report["memo"]
    b = report["batches"]
    lines = ["sweep report:"]
    line = (
        f"  wall-clock  evaluate={w['evaluate_s']:.2f}s  "
        f"compile={w['compile_s']:.2f}s  prep={w.get('prep_s', 0.0):.2f}s  "
        f"dispatch={w['dispatch_s']:.2f}s  "
        f"harvest={w['harvest_s']:.2f}s")
    if w.get("compile_overlapped_s"):
        line += f"  compile_overlapped={w['compile_overlapped_s']:.2f}s"
    lines.append(line)
    pb = report.get("program_bank")
    if pb is not None:
        line = (f"  bank        compiles={pb['compiles']}  "
                f"overlapped={pb['compiles_overlapped']} "
                f"({pb['overlapped_s']:.2f}s off the serial path)")
        if pb.get("waited_s"):
            line += f"  waited={pb['waited_s']:.2f}s"
        lines.append(line)
    hr = m["hit_rate"]
    lines.append(
        f"  memo        requested={m['requested']}  hits={m['hits']}  "
        f"misses={m['misses']}  hit_rate="
        + (f"{hr:.1%}" if hr is not None else "n/a"))
    for meth, d in (m.get("per_method") or {}).items():
        mhr = d.get("hit_rate")
        lines.append(
            f"    memo[{meth}]  requested={d['requested']}  "
            f"hits={d['hits']}  misses={d['misses']}  hit_rate="
            + (f"{mhr:.1%}" if mhr is not None else "n/a"))
    pw = b["pad_waste_fraction"]
    lines.append(
        f"  batches     n={b['count']}  coalitions={b['coalitions']}  "
        f"padding={b['padding']}  pad_waste="
        + (f"{pw:.1%}" if pw is not None else "n/a")
        + f"  epochs={b['epochs_trained']}")
    h = report.get("hbm")
    if h is not None:
        # the donation story in one line: what one coalition costs, what
        # donation saved, and the cap headroom it bought
        per = h.get("per_coalition_bytes")
        saved = h.get("donated_bytes_per_coalition")
        peak = h.get("peak_in_use_bytes")
        lines.append(
            "  hbm         per_coalition="
            + (f"{per / 1e6:.1f}MB" if per is not None else "n/a")
            + "  donated_saving="
            + (f"{saved / 1e6:.1f}MB" if saved else "0")
            + f"  cap {h.get('cap_before_donation', '?')}"
              f"->{h.get('cap_after_donation', '?')}"
              f" (effective {h.get('cap_effective', '?')})"
            + "  peak_in_use="
            + (f"{peak / 1e6:.1f}MB" if peak is not None else "n/a"))
    r = report.get("resilience")
    if r is not None:
        # rendered even when all-zero: a clean run should SAY it was clean
        line = (f"  resilience  retries={r['retries']}  "
                f"backoff={r['backoff_s']:.2f}s  "
                f"cap_halvings={r['cap_halvings']}  "
                f"cpu_batches={r['cpu_batches']}")
        if r.get("cpu_coalitions"):
            line += f"  cpu_coalitions={r['cpu_coalitions']}"
        if r.get("ladder_exhausted"):
            line += f"  ladder_exhausted={r['ladder_exhausted']}"
        if r.get("faults_injected"):
            line += f"  faults_injected={r['faults_injected']}"
        lines.append(line)
    nm = report.get("numerics")
    if nm is not None:
        # the numeric-truth row: reduction mode, audits run, localized
        # order divergences (worst ulp distance), ledger size
        line = (f"  numerics    mode={nm.get('reduction_mode') or '?'}  "
                f"audits={nm['audits']}  drift_events={nm['drift_events']}"
                f"  max_ulp={nm['max_ulp']}")
        if nm.get("ledger_entries") is not None:
            line += f"  ledger_entries={nm['ledger_entries']}"
        lines.append(line)
    svc = report.get("service")
    if svc is not None:
        # the multi-tenant service view: outcomes + the packing win, then
        # one fair-share line per tenant
        line = (
            f"  service     jobs={svc['jobs']}  "
            f"completed={svc['completed']}  "
            f"quarantined={svc['quarantined']}  "
            f"cancelled={svc['cancelled']}  "
            f"recovered={svc['recovered']}  "
            f"packed_batches={svc['cross_tenant_packed_batches']}")
        if svc.get("shed"):
            line += f"  shed={svc['shed']}"
        lines.append(line)
        for name, t in (svc.get("per_tenant") or {}).items():
            share = t.get("cost_share")
            host = t.get("host_share")
            line = (
                f"    tenant[{name}]  slices={t['slices']}  "
                f"batches={t['batches']}  coalitions={t['coalitions']}  "
                f"samples={t['samples']}  span={t['seconds']:.2f}s")
            if t.get("device_seconds"):
                line += f"  device={t['device_seconds']:.2f}s"
            line += ("  share="
                     + (f"{share:.1%}" if share is not None else "n/a"))
            if (host is not None and share is not None
                    and svc.get("cost_basis") == "device_seconds"):
                line += f" (host={host:.1%})"
            lines.append(line)
    slo = report.get("slo")
    if slo:
        def _q(d, k):
            v = d.get(k)
            return f"{v:.3f}" if v is not None else "n/a"
        for name, s in sorted(slo.items()):
            qw, tf, sl = s["queue_wait_s"], s["ttfv_s"], s["slice_s"]
            lines.append(
                f"  slo[{name}]  jobs={s['jobs']}  "
                f"queue_wait p50/p95={_q(qw, 'p50')}/{_q(qw, 'p95')}s  "
                f"ttfv p50={_q(tf, 'p50')}s  "
                f"slice p50/p95/p99={_q(sl, 'p50')}/{_q(sl, 'p95')}/"
                f"{_q(sl, 'p99')}s  "
                f"deadline_misses={s['deadline_misses']}  "
                f"retries={s['retries']}")
    rt = report.get("router")
    if rt is not None:
        rq = rt.get("route_s") or {}

        def _rq(k):
            v = rq.get(k)
            return f"{v:.3f}" if v is not None else "n/a"
        lines.append(
            f"  router      routed={rt['routed']}  "
            f"resubmits={rt['resubmits']}  repins={rt['repins']}  "
            f"failovers={rt['failovers']}"
            + (f" (jobs={rt['failover_jobs']})"
               if rt.get("failover_jobs") else "")
            + f"  exhausted={rt['budget_exhausted']}  "
            f"route p50/p95/p99={_rq('p50')}/{_rq('p95')}/{_rq('p99')}s")
    lv = report.get("live")
    if lv is not None:
        q = lv.get("query_s") or {}

        def _s(v):
            return f"{v:.3f}s" if v is not None else "n/a"
        lines.append(
            f"  live        queries={lv['queries']}  "
            f"memo_hits={lv['memo_hits']}  "
            f"evaluations={lv['evaluations']}  "
            f"pruned={lv['pruned_coalitions']}  "
            f"rounds={lv.get('rounds_resident') if lv.get('rounds_resident') is not None else '?'}"
            + (f"  recovered={lv['recovered_games']}"
               if lv.get("recovered_games") else "")
            + (f"  evicted/restored={lv['evictions']}/{lv['restores']}"
               if lv.get("evictions") or lv.get("restores") else "")
            + (f"  ingested={lv['rounds_ingested']}"
               if lv.get("rounds_ingested") else "")
            + f"  query p50/p95={_s(q.get('p50'))}/{_s(q.get('p95'))}")
    pl = report.get("planner")
    if pl is not None:
        last = pl.get("last") or {}
        routed = ", ".join(f"{m}x{c}"
                           for m, c in sorted(pl["routed"].items()))
        lines.append(
            f"  planner     auto={pl['auto_queries']}  routed=[{routed}]"
            f"  last={last.get('method', '?')}"
            f" (est {last.get('est_evals', '?')} evals"
            f" ~{last.get('est_cost_sec', 0.0):.2f}s,"
            f" basis {last.get('cost_basis', '?')})")
    rc = report.get("reconstruction")
    if rc is not None:
        mem = rc.get("recorded_update_bytes")
        rps = rc.get("reconstructions_per_s")
        lines.append(
            f"  reconstruct rounds={rc.get('recorded_rounds') or '?'}  "
            "update_mem="
            + (f"{mem / 1e6:.1f}MB" if mem is not None else "n/a")
            + f"  reconstructions={rc.get('reconstructions', 0)}  recons/s="
            + (f"{rps:.1f}" if rps is not None else "n/a")
            + f"  passes train/eval={rc.get('train_partner_passes', 0)}/0"
            + f"  batches train/eval={rc.get('train_batches', 0)}"
              f"/{rc.get('recon_batches', 0)}")
    t = report.get("trust")
    if t is not None:
        # the answer-trust view — how wide the per-partner CIs are and how
        # stable the ranking is. `source` tells seed volatility
        # (seed_ensemble) from one run's sampling noise (mc_blocks, the
        # retrain-free estimators); pre-source rows render without it.
        line = (f"  trust       ensemble={t.get('ensemble', '?')}  "
                + (f"source={t['source']}  " if t.get("source") else "")
                + f"kendall_tau="
                + (f"{t['kendall_tau']:.3f}"
                   if t.get("kendall_tau") is not None else "n/a"))
        mean = t.get("mean") or []
        lo = t.get("ci_low") or []
        hi = t.get("ci_high") or []
        if mean and len(lo) == len(mean) and len(hi) == len(mean):
            pct = int(round(100 * t.get("alpha", 0.95)))
            cells = [f"p{i}: {m:.3f}±{(h - l) / 2:.3f}"
                     for i, (m, l, h) in enumerate(zip(mean, lo, hi))]
            line += f"  ci{pct}=[" + ", ".join(cells) + "]"
        lines.append(line)
    c = report.get("compute") or {}
    if c.get("train_samples"):
        sps = c.get("samples_per_s")
        line = (f"  compute     samples={c['train_samples']}  "
                f"partner_passes={c['partner_passes']}  samples/s="
                + (f"{sps:.0f}" if sps is not None else "n/a"))
        fps = c.get("model_flops_per_s")
        if fps is not None:
            line += ("  model_flops/s=" +
                     (f"{fps / 1e12:.2f}T" if fps >= 1e12 else
                      f"{fps / 1e9:.2f}G" if fps >= 1e9 else
                      f"{fps / 1e6:.2f}M"))
            mfu = c.get("mfu_proxy")
            line += ("  mfu_proxy=" + (f"{mfu:.2%}" if mfu is not None
                                       else "n/a"))
        mx = c.get("mfu_xla")
        if mx is not None:
            # the XLA-derived figure supersedes the analytic proxy (both
            # stay rendered; the basis says whether the denominator was
            # measured device time or host span)
            line += (f"  mfu_xla={mx:.2%}"
                     + (f" [{c['mfu_xla_basis']}]"
                        if c.get("mfu_xla_basis") else ""))
        lines.append(line)
    dt = report.get("device_time")
    if dt is not None:
        st = dt.get("device_step_s") or {}
        line = (f"  device      fenced={dt.get('fenced_batches', 0)} "
                f"batches ({dt.get('fenced_coalitions', 0)} coalitions"
                + (f", 1/{dt['fence_interval']}"
                   if dt.get("fence_interval") else "") + ")")
        if st.get("count"):
            mean = st.get("mean")
            p95 = st.get("p95")
            line += ("  step mean="
                     + (f"{mean:.3f}s" if mean is not None else "n/a")
                     + "  p95="
                     + (f"{p95:.3f}s" if p95 is not None else "n/a"))
        ds = dt.get("device_s")
        if ds is not None:
            line += (f"  device_s~{ds:.2f}"
                     + (f" [{dt['basis']}]" if dt.get("basis") else ""))
        line += (f"  enqueue={dt.get('enqueue_s', 0.0):.2f}s  "
                 f"harvest={dt.get('harvest_s', 0.0):.2f}s")
        lines.append(line)
    rl = report.get("roofline")
    if rl and rl.get("programs"):
        def _rate(v, unit):
            if v is None:
                return "n/a"
            return (f"{v / 1e12:.2f}T{unit}" if v >= 1e12 else
                    f"{v / 1e9:.2f}G{unit}" if v >= 1e9 else
                    f"{v / 1e6:.2f}M{unit}")
        for r in rl["programs"]:
            ai = r.get("arithmetic_intensity")
            line = (f"  roofline    ({str(r['slot_count']):>4}, "
                    f"{r['width']:4d})  "
                    f"flops/batch={_rate(r.get('flops_per_batch'), 'F')}  "
                    "AI="
                    + (f"{ai:.1f}F/B" if ai is not None else "n/a")
                    + "  achieved="
                    + _rate(r.get("achieved_flops_per_s"), "F/s"))
            if r.get("mfu") is not None:
                line += f" ({r['mfu']:.1%} peak)"
            if r.get("hbm_fraction") is not None:
                line += (f"  bytes="
                         + _rate(r.get("achieved_bytes_per_s"), "B/s")
                         + f" ({r['hbm_fraction']:.1%} HBM)")
            if r.get("basis"):
                line += f" [{r['basis']}]"
            lines.append(line)
    if report["per_width"]:
        lines.append("  throughput per bucket (slots, width): "
                     "batches  coal  epochs  span-s  coal/s")
        for r in report["per_width"]:
            cps = r["coalitions_per_s"]
            lines.append(
                f"    ({str(r['slot_count']):>4}, {r['width']:4d})      "
                f"{r['batches']:4d}  {r['coalitions']:5d}  {r['epochs']:5d}  "
                f"{r['seconds']:7.2f}  "
                + (f"{cps:6.2f}" if cps is not None else "   n/a"))
    for fn, c in sorted(report["compiles"].items()):
        lines.append(f"  compile     {fn}: {c['count']}x  {c['seconds']:.2f}s")
    for e in report["estimators"]:
        lines.append(f"  estimator   {e['method']}: {e['seconds']:.2f}s")
    return "\n".join(lines)


def write_report(path: str, report: dict) -> None:
    """Atomic JSON sidecar write (temp + rename, like the engine's
    cache autosave)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, default=str)
    os.replace(tmp, path)
