"""The fleet sweep and the fleet's state plane (port of
`mplc_tpu/parallel/fleet.py`).

The fleet sweep cuts ONE sweep into W disjoint coalition slices, runs each
slice in its own process (`run_shard`, in this process or as a worker
subprocess), and merges the W results into one sweep with a checked
equality proof (`run_fleet`). Three rules make it trustworthy:

1. **Slice at bucket granularity, never mid-width.** `plan_slices` cuts the
   sweep at the engine's buckets (the classification `sweep_plan` and
   `evaluate` use: the all-dropped null coalitions, the singles, then the
   slot-width groups or the masked multis), each bucket split contiguously
   across the shards. With `CharacteristicEngine.pin_fleet_widths`, every
   shard runs each bucket at the FULL sweep's planned width, so every shard
   runs the full sweep's programs at the full sweep's shapes.
2. **Each shard is self-verifying.** A shard runs under
   MPLC_TORCH_DETERMINISTIC_REDUCE=1 when the spec asks for equality
   proofs, with its own value ledger (`obs/numerics.ValueLedger`) and its
   own crash journal (the engine's checksummed autosave cache). Its LAST
   act is touching `.shardI.done`, the completion marker of
   `merge_shards.py`: a result without its marker is never merged.
3. **The merge is verified, not assumed.** The coordinator refuses a
   partial merge (a missing marker), ledgers of different games (an
   engine fingerprint mismatch) and slices that overlap or do not cover
   the sweep; handed a reference ledger (`verify_against`, e.g. the
   1-shard run's), it requires zero ulp drift and Kendall tau-b 1.0 over
   every coalition through `obs/numerics.diff_ledgers`, and refuses to
   pass when there is no merged ledger to compare.

The files on disk are the JAX package's, key for key (`fleet_spec.json`,
`result_shardI.json`, `cache_shardI.json`, `ledger_shardI.json`,
`.shardI.done`, `ledger_merged.json`, `cache_merged.json`,
`trace_coordinator.jsonl`, `trace_shardI.jsonl`, `flight_shardI/`,
`worker_shardI.log`, `fleet_trace_manifest.json`, `incident_*/`), so the
JAX package's `merge_shard_results` and `obs.fleet_view.merge_fleet_traces`
read a port's fleet folder. `result_shardI.json` adds the keys `device`,
`visible_devices` (the worker's CUDA_VISIBLE_DEVICES) and `card` (its name).
A failed run (`FleetError`) leaves one incident bundle (`_write_incident`).

Where the port differs from the JAX module:

- **Device.** `run_fleet`, `run_shard`, `run_worker_subprocess` and the CLI
  take `device` (the CLI: `--device cpu`, as `load_gen`'s shard processes
  do). Workers run on the card by default, each its own CUDA context; a
  worker with no card and no `--device cpu` exits non-zero (`Scenario`
  raises through `utils.resolve_device`): no worker ever drops to the CPU.
  `threads` (`--threads N`) sets a worker's torch threads.
- **Cards of a shard.** `devices_per_shard` (the CLI: `--devices-per-shard
  N`) gives each shard its own cards, where the JAX package forces the
  size of a worker's host mesh: on the card, shard i's worker sees the
  coordinator's cards [i*N, (i+1)*N) through CUDA_VISIBLE_DEVICES, which
  replaces any inherited value (`_shard_devices`); at N = 1 the shards wrap
  onto the cards there are (shard i on card i % cards), and at N > 1 a
  fleet of W*N cards more than the host has raises ValueError before any
  worker starts (NCCL refuses two ranks on one card). None keeps every
  worker on the default card. At N > 1 a worker runs its slice as a world
  of N ranks (`parallel/launch.py` `spawn`: NCCL on its cards, gloo on the
  CPU, a MASTER_PORT of its own a worker), its engine spreading the slice's
  coalitions over the world (the 1-D coalition sharding, or the 2-D mode
  under MPLC_TORCH_PARTNER_SHARDS); every rank's value table is agreed
  before rank 0 alone writes the shard's files, its trace included (`run_shard`),
  and the ledger's meta names `n_devices` N. One process holds one device,
  so `inproc` with N > 1 raises ValueError. `_local_device_count` reports
  the ranks a shard ran on, without touching CUDA.
- **Worker environment.** `worker_env` passes the port's knobs only (no
  `JAX_*`, `XLA_*` or other packages' `MPLC_*` variables), strips the
  parent's telemetry outputs (its trace file, metrics port, Chrome trace,
  profile folder and value ledger: a worker appending to the parent's
  would corrupt them) and sets `CUBLAS_WORKSPACE_CONFIG` before the
  worker's first cuBLAS call (`utils.resolve_device`). Workers start by
  module name from the checkout's root.
- **Routes.** Under the deterministic reduce the JAX engine trains fedavg
  on its 2-D partner-sharded pipeline, which has no 1-D bucket plan, so its
  width pin is a no-op there; the port trains those sweeps on masked 1-D
  batches, so its pin applies. The two packages cut the same slices and
  merge to the same kind of ledger, but their `programs_planned`, `widths`
  and `manifest_hits` differ by route. The port's program bank compiles
  nothing (contrib/bank.py): `counters["bank.compiles"]` counts the
  programs it recorded anew and `counters["trainer.compiles"]` the nvcc
  builds.

The state plane (`MPLC_TORCH_FLEET_STATE_DIR`): each sweep-service process
of a sharded deployment publishes its queue depth and admission state into
a shared folder (one `shard_<id>.json` a process, written atomically) and
reads the cluster's aggregate back (`cluster_view`): the cross-shard queue
view that /healthz shows and that an overloaded service's
`ServiceOverloaded` names as its redirect hint (the least-loaded live
shard). Nothing here changes a computed number.

CLI:
  python3 -m mplc_tpu_torch.parallel.fleet --worker SPEC.json --shard I/W \\
      --out DIR [--no-ledger] [--device cpu] [--threads N] \\
      [--devices-per-shard N --master-port P --timeout S]
  python3 -m mplc_tpu_torch.parallel.fleet --selfcheck [--shards W] \\
      [--devices-per-shard N] [--obs-dir DIR] [--device cpu] [--threads N]
The selfcheck runs a small deterministic-reduce Titanic sweep at 1 shard
and at W shards (worker subprocesses) and exits non-zero unless
`diff_ledgers` reports zero drift and tau-b 1.0; with `--devices-per-shard
N` the 1 shard runs on 1 device and the W shards on N each, and it prints
each worker's line naming the cards it saw; with `--obs-dir` it also
writes the merged timeline and the aggregated snapshot there and requires
one entry a shard in each.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import constants
from ..obs import flight
from ..obs import trace as obs_trace

logger = logging.getLogger("mplc_tpu_torch")

FLEET_STATE_DIR_ENV = constants.FLEET_STATE_DIR_ENV
FLEET_SHARD_ID_ENV = constants.FLEET_SHARD_ID_ENV
# the trace context the coordinator sets in every shard's environment
# (sidecars: neither changes a number)
FLEET_RUN_ID_ENV = constants.FLEET_RUN_ID_ENV
FLEET_COORD_TS_ENV = constants.FLEET_COORD_TS_ENV

# the parent's telemetry outputs, never inherited by a worker
_TELEMETRY_OUTPUTS = (obs_trace.TRACE_FILE_ENV, constants.METRICS_PORT_ENV,
                      obs_trace.CHROME_TRACE_FILE_ENV, constants.PROFILE_DIR_ENV,
                      constants.NUMERICS_LEDGER_ENV)


class FleetError(RuntimeError):
    """Base class of the fleet sweep's failures."""


class FleetMergeError(FleetError):
    """The shards' results cannot be merged into one sweep: a missing
    completion marker (a shard still running or dead), slices that overlap
    or do not cover the sweep, or ledgers of different games."""


def _check_devices_per_shard(devices: "int | None") -> None:
    if devices is not None and (isinstance(devices, bool) or not isinstance(devices, int)
                                or devices < 1):
        raise ValueError(f"devices_per_shard={devices!r}: a shard runs on a whole number "
                         "of devices, at least 1 (None: the default card)")


def _on_card(device) -> bool:
    return device is None or str(device).startswith("cuda")


def _visible_cards(base: "dict | None" = None, cards: "int | None" = None) -> list:
    """The ids of the cards the coordinator sees, in order: its
    CUDA_VISIBLE_DEVICES (of `base`, default this process's environment)
    where set, else 0..cards-1; `cards` (None: torch's count) bounds the
    list."""
    if cards is None:
        import torch
        cards = torch.cuda.device_count()
    src = os.environ if base is None else base
    ids = [x.strip() for x in (src.get("CUDA_VISIBLE_DEVICES") or "").split(",") if x.strip()]
    return (ids or [str(i) for i in range(cards)])[:cards]


def _shard_devices(shard: int, shards: int, devices: int, visible: list) -> list:
    """The card ids shard `shard` of `shards` runs on at `devices` cards a
    shard, out of `visible`: the block [shard*N, (shard+1)*N); at N = 1
    card shard % len(visible) (the shards wrap onto the cards there are).
    At N > 1 a fleet needing more cards than there are raises ValueError
    (NCCL refuses two ranks on one card)."""
    _check_devices_per_shard(devices)
    if not 0 <= shard < shards:
        raise ValueError(f"shard index {shard} outside 0..{shards - 1}")
    if devices == 1:
        return [visible[shard % len(visible)]] if visible else []
    if shards * devices > len(visible):
        raise ValueError(
            f"{shards} shards x {devices} devices need {shards * devices} cards, "
            f"{len(visible)} visible: a world of ranks needs a card a rank")
    return visible[shard * devices:(shard + 1) * devices]


# ---------------------------------------------------------------------------
# the sweep spec: what a worker needs to rebuild the same game
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetSpec:
    """A sweep, JSON round-trippable, so that a worker rebuilds the game
    the coordinator described (the engine's data digest, in the ledger's
    fingerprint, catches any divergence). The JSON is the JAX spec's."""
    dataset: str = "titanic"
    partners: int = 3
    epochs: int = 2
    dtype: str = "float32"
    minibatch_count: int = 2
    gradient_updates_per_pass: int = 3
    seed: int = 0
    # None: the whole powerset (contrib.shapley.powerset_order)
    subsets: "list | None" = None
    # equality mode: the shards run under MPLC_TORCH_DETERMINISTIC_REDUCE=1,
    # so the merged ledger is bit-comparable across shard counts
    deterministic: bool = True
    # pin every shard's bucket widths to the full sweep's plan
    pin_widths: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        doc = json.loads(text)
        doc.pop("amounts", None)  # a legacy field
        return cls(**doc)

    def all_subsets(self) -> list:
        if self.subsets is not None:
            return [tuple(sorted(int(i) for i in s)) for s in self.subsets]
        from ..contrib.shapley import powerset_order
        return list(powerset_order(self.partners))

    def build_scenario(self, device=None):
        """The bench-shaped scenario (3 partners [0.4, 0.3, 0.3], else
        partner i holding (i+1)/sum), prepared the same way in the
        coordinator and in every worker, on `device` (None: the card)."""
        from ..scenario import Scenario
        n = self.partners
        if n == 3:
            amounts = [0.4, 0.3, 0.3]
        else:
            raw = [float(i + 1) for i in range(n)]
            amounts = [x / sum(raw) for x in raw]
        sc = Scenario(partners_count=n, amounts_per_partner=amounts,
                      dataset_name=self.dataset,
                      multi_partner_learning_approach="fedavg",
                      aggregation_weighting="data-volume",
                      epoch_count=self.epochs,
                      minibatch_count=self.minibatch_count,
                      gradient_updates_per_pass_count=self.gradient_updates_per_pass,
                      is_early_stopping=False, compute_dtype=self.dtype,
                      experiment_path=tempfile.gettempdir(),
                      is_dry_run=True, seed=self.seed, device=device)
        sc.instantiate_scenario_partners()
        sc.split_data(is_logging_enabled=False)
        sc.compute_batch_sizes()
        sc.data_corruption()
        return sc


# ---------------------------------------------------------------------------
# slice planning: bucket-granular, deterministic, a disjoint cover
# ---------------------------------------------------------------------------

def plan_slices(engine, subsets, n_shards: int) -> list:
    """`subsets` cut into `n_shards` disjoint slices at the engine's buckets
    (the classification `sweep_plan` and `evaluate` use), so no bucket is
    split mid-width: every shard gets a contiguous run of EACH bucket and,
    with `pin_fleet_widths`, runs it at the full sweep's width.
    Deterministic in (the subsets' order, the bucketing mode, n_shards);
    the slices' union is the stable-unique subset list."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    keys = list(dict.fromkeys(tuple(sorted(int(i) for i in s)) for s in subsets))
    dropped = getattr(engine, "_forever_dropped", frozenset())
    if dropped:
        lens = {k: len(engine._effective_subset(k)) for k in keys}
    else:
        lens = {k: len(k) for k in keys}
    nulls = [k for k in keys if lens[k] == 0]    # stored as v = 0, never run
    singles = [k for k in keys if lens[k] == 1]
    multis = [k for k in keys if lens[k] > 1]
    buckets = []
    if nulls:
        buckets.append(nulls)
    if singles:
        buckets.append(singles)
    if multis:
        if getattr(engine, "_use_slots", False):
            buckets.extend(group for _w, group in engine._slot_buckets(multis))
        else:
            buckets.append(multis)
    slices = [[] for _ in range(n_shards)]
    for bucket in buckets:
        n = len(bucket)
        for i in range(n_shards):
            slices[i].extend(bucket[i * n // n_shards:(i + 1) * n // n_shards])
    return slices


# ---------------------------------------------------------------------------
# one shard (the in-process path and the CLI worker share it)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _env_overlay(overrides: dict):
    """Environment keys set (None: unset) inside the block and restored
    after. The engine reads its knobs when it is built, so the in-process
    shard path needs exactly this window; a worker subprocess gets a real
    environment instead."""
    saved = {k: os.environ.get(k) for k in overrides}
    try:
        for k, v in overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _shard_paths(out_dir: str, shard: int) -> dict:
    return {
        "result": os.path.join(out_dir, f"result_shard{shard}.json"),
        "cache": os.path.join(out_dir, f"cache_shard{shard}.json"),
        "ledger": os.path.join(out_dir, f"ledger_shard{shard}.json"),
        "done": os.path.join(out_dir, f".shard{shard}.done"),
    }


def _bank_counters() -> dict:
    """The JAX result's counter keys, read from the port's counters: the
    port's bank records a program where the JAX bank compiles one, and its
    only compiles are the kernels' nvcc builds."""
    from ..obs import metrics as obs_metrics
    snap = obs_metrics.snapshot().get("counters", {})
    return {"bank.hits": snap.get("bank.hits", 0),
            "bank.compiles": snap.get("bank.programs", 0),
            "trainer.compiles": snap.get("trainer.compiles_total", 0),
            "engine.batches": snap.get("engine.batches", 0)}


def _card_name(device) -> str:
    import torch
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _agree_values(shard: int, values: list) -> None:
    """Every rank of a shard's world holds the same v(S) bits for the slice:
    one all-gather of each rank's table digest; a difference raises
    FleetError on every rank (run under `mesh.agreed`)."""
    import hashlib

    import numpy as np
    import torch

    from . import mesh
    digest = hashlib.sha256(np.asarray(values, np.float64).tobytes()).digest()[:8]
    mine = torch.tensor([int.from_bytes(digest, "little", signed=True)], dtype=torch.int64)
    got = mesh.make_mesh().axis("coal").all_gather(mine, tag="agree").tolist()
    if len(set(got)) != 1:
        raise FleetError(f"shard {shard}: the ranks' value tables differ (digests {got})")


def run_shard(spec: FleetSpec, shard: int, shards: int, out_dir: str,
              ledger: bool = True, device=None) -> dict:
    """One shard's slice run to completion on `device` (None: the card):
    build the game, pin the full sweep's bucket widths, acquire the bank's
    planned programs, evaluate the slice under the spec's reduction mode
    with a per-shard value ledger and crash journal, and write
    `result_shardI.json`, `cache_shardI.json` and `ledger_shardI.json`.
    Touches `.shardI.done` LAST: the merge refuses a shard without it.

    Called on every rank of a shard's world (`_shard_rank`), the engine
    spreads the slice over the ranks; every rank's value table is agreed,
    then rank 0 alone keeps the ledger and the crash journal and writes
    the files. The other ranks return {shard, shards, rank, device,
    card}."""
    from . import mesh
    if not 0 <= shard < shards:
        raise ValueError(f"shard index {shard} outside 0..{shards - 1}")
    writer = mesh.world_rank() == 0
    os.makedirs(out_dir, exist_ok=True)
    paths = _shard_paths(out_dir, shard)
    if writer:
        # a previous run's files in the same folder must not survive: a
        # leftover marker could bless a half-written result, and a leftover
        # ledger would be merged as if this run wrote it
        for key in ("done", "result", "ledger"):
            with contextlib.suppress(OSError):
                os.remove(paths[key])
    # the clock handshake: the coordinator's clock at spawn, echoed beside
    # this worker's start and end readings (obs/fleet_view._clock_offset)
    worker_start_ts = time.time()
    coord_ts = None
    with contextlib.suppress(TypeError, ValueError):
        raw = os.environ.get(FLEET_COORD_TS_ENV)
        coord_ts = float(raw) if raw else None
    run_id = os.environ.get(FLEET_RUN_ID_ENV)
    from ..obs import metrics as obs_metrics
    from ..utils import compile_cache_entries
    shard_span = obs_trace.start_span("fleet.shard_run", shard=shard, shards=shards,
                                      run=run_id or "")
    t0 = time.perf_counter()
    env = {constants.DETERMINISTIC_REDUCE_ENV: "1" if spec.deterministic else None,
           constants.NUMERICS_LEDGER_ENV: paths["ledger"] if ledger and writer else None}
    before = _bank_counters()
    cache_dir = os.environ.get(constants.COMPILE_CACHE_DIR_ENV)
    cache_before = compile_cache_entries(cache_dir) if cache_dir else None
    with _env_overlay(env):
        sc = spec.build_scenario(device)
        from ..contrib.engine import CharacteristicEngine
        engine = CharacteristicEngine(sc)
    all_subsets = spec.all_subsets()
    if spec.pin_widths:
        engine.pin_fleet_widths(all_subsets)
    # how many of the full sweep's programs the shared bank manifest
    # (MPLC_TORCH_COMPILE_CACHE_DIR) already held when this shard started
    plan = engine.sweep_plan(all_subsets)
    manifest_hits = 0
    if engine.program_bank is not None and plan:
        held = engine.program_bank.persistent_keys()
        manifest_hits = sum(1 for pipe, slot, width in plan
                            if engine.program_bank.program_key(pipe, slot, width) in held)
    my_slice = plan_slices(engine, all_subsets, shards)[shard]
    if writer:
        engine.autosave_path = paths["cache"]   # the shard's crash journal
    # every planned program acquired outside the timed sweep (the port's
    # bank records keys only, so this costs little; the seconds are
    # reported, never hidden)
    t_warm = time.perf_counter()
    if engine.program_bank is not None:
        for pipe, slot, width in plan:
            engine.program_bank.acquire(pipe, slot, width)
    warmup_s = time.perf_counter() - t_warm
    # the sweep timed apart from the shard's start-up (scenario, data,
    # engine), which a resident worker pays once
    t_sweep = time.perf_counter()
    engine.evaluate(my_slice)
    sweep_s = time.perf_counter() - t_sweep
    values = [float(engine.charac_fct_values[s]) for s in my_slice]
    if mesh.world_size() > 1:
        mesh.agreed(lambda: _agree_values(shard, values))
    if not writer:
        shard_span.end()
        return {"shard": shard, "shards": shards, "rank": mesh.world_rank(),
                "device": str(engine.device), "card": _card_name(engine.device),
                "subsets": [list(s) for s in my_slice]}
    if engine.numerics_ledger is not None:
        engine.numerics_ledger.save()
    engine.save_cache(paths["cache"])
    after = _bank_counters()
    wall = time.perf_counter() - t0
    shard_span.end()   # the root span: the flow-link target in the timeline
    worker_end_ts = time.time()
    result = {
        "shard": shard,
        "shards": shards,
        "spec": dataclasses.asdict(spec),
        # the game's engine fingerprint, so the coordinator stamps the
        # merged cache without building the game itself
        "fingerprint": engine._fingerprint(),
        "subsets": [list(s) for s in my_slice],
        "values": [[list(s), v] for s, v in zip(my_slice, values)],
        "wallclock_s": wall,
        "sweep_s": sweep_s,
        "warmup_s": warmup_s,
        "setup_s": wall - sweep_s - warmup_s,
        "devices": _local_device_count(),
        "device": str(engine.device),
        # the cards the shard's worker was given, and the card's name
        "visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "card": _card_name(engine.device),
        "deterministic": bool(spec.deterministic),
        "counters": {k: after[k] - before[k] for k in after},
        "programs_planned": len(plan),
        "manifest_hits": manifest_hits,
        "compile_cache_new_entries": (
            (compile_cache_entries(cache_dir) or 0) - (cache_before or 0)
            if cache_dir and cache_before is not None else None),
        "widths": (sorted({w for (_p, _s), w in engine._fleet_widths.items()})
                   if engine._fleet_widths else []),
        # the trace context and the clock echo (the coordinator's spawn
        # reading beside this worker's start and end): with the
        # coordinator's done-seen time, the midpoint rule's four readings
        "fleet": {"run_id": run_id, "shard_id": os.environ.get(FLEET_SHARD_ID_ENV)},
        "clock": {"coord_spawn_ts": coord_ts,
                  "worker_start_ts": worker_start_ts,
                  "worker_end_ts": worker_end_ts},
        # this process's metrics snapshot (the fleet collector merges it);
        # per shard in a subprocess fleet, cumulative in process
        "metrics": obs_metrics.snapshot(),
    }
    _atomic_json(paths["result"], result)
    # the LAST act: the completion marker (a crash before it: no merge)
    with open(paths["done"], "w") as f:
        f.write(str(int(time.time())))
    return result


def _local_device_count() -> int:
    """The devices a shard ran on: the ranks of its world (one device a
    rank), 1 without one. Read without initializing CUDA."""
    from . import mesh
    return mesh.world_size()


def _atomic_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the merge: the disjoint cover, the ledgers' union, the increments
# ---------------------------------------------------------------------------

def merge_ledgers(docs: list) -> dict:
    """W shard ledgers (`to_doc()` dicts) united into one ledger doc.
    Refuses ledgers of different games (a fingerprint mismatch) and a
    subset in two ledgers (a slicing fault: two shards trained it)."""
    if not docs:
        raise FleetMergeError("no shard ledgers to merge")
    fps = {d.get("engine_fingerprint") for d in docs}
    if len(fps) != 1:
        raise FleetMergeError(
            f"shard ledgers carry {len(fps)} distinct engine fingerprints "
            f"({sorted(str(f)[:16] for f in fps)}) — these are different "
            "games and must not be merged")
    entries: dict = {}
    for i, d in enumerate(docs):
        for k, e in (d.get("entries") or {}).items():
            if k in entries:
                raise FleetMergeError(
                    f"subset {k} appears in more than one shard ledger "
                    f"(shard {i} overlaps an earlier slice)")
            entries[k] = e
    meta = dict(docs[0].get("meta") or {})
    meta.update(fleet_shards=len(docs), merged=True)
    return {"schema": docs[0].get("schema", 1),
            "engine_fingerprint": docs[0].get("engine_fingerprint"),
            "meta": meta, "entries": entries}


def _rebuild_increments(values: dict, partners_count: int) -> list:
    """The engine's marginal increments, recomputed over the MERGED memo
    (a shard's own are incomplete: a pair split across two shards counts
    in neither)."""
    inc = [dict() for _ in range(partners_count)]
    for subset, v in values.items():
        sset = set(subset)
        for i in range(partners_count):
            if i in sset:
                without = tuple(sorted(sset - {i}))
                if without in values:
                    inc[i][without] = v - values[without]
    return inc


def write_cache_doc(path: str, fingerprint: dict, values: dict,
                    partners_count: int) -> None:
    """A merged memo in the engine's checksummed cache format
    (`CharacteristicEngine.load_cache` accepts it), its increments rebuilt
    over the merged values."""
    import hashlib
    payload = {
        "fingerprint": fingerprint,
        "first_charac_fct_calls_count": len(values),
        "charac_fct_values": [[list(k), v] for k, v in values.items()],
        "increments_values": [[[list(k), v] for k, v in d.items()]
                              for d in _rebuild_increments(values, partners_count)],
    }
    body = json.dumps(payload)
    digest = hashlib.sha256(body.encode()).hexdigest()
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write('{"payload_sha256": "%s", %s' % (digest, body[1:]))
    os.replace(tmp, path)


@dataclasses.dataclass
class FleetResult:
    values: dict                 # {subset: v(S)} over the whole sweep
    ledger: "dict | None"        # the merged ledger doc (None: ledgers off)
    shard_reports: list          # the shards' result_shardI.json docs
    wallclock_s: float           # the coordinator's: start to merge done
    per_shard_wall_s: list       # each shard's own wall-clock
    out_dir: str
    diff: "dict | None" = None   # diff_ledgers against the reference
    # each shard's sweep-only seconds (its start-up is `setup_s` in its
    # report); the max is the fleet's critical path
    per_shard_sweep_s: "list | None" = None


def merge_shard_results(spec: FleetSpec, shards: int, out_dir: str,
                        force: bool = False) -> tuple:
    """(values, merged ledger doc or None, shard reports) of the W shards'
    files. Refuses a missing `.shardI.done` (unless `force`), slices that
    overlap or do not cover the sweep, and ledgers of different games."""
    missing = [i for i in range(shards)
               if not os.path.exists(_shard_paths(out_dir, i)["done"])]
    if missing and not force:
        raise FleetMergeError(
            f"{out_dir} has no done markers for shards {missing} — those "
            "workers are still running or crashed (result presence is not "
            "completion); force=True to merge anyway")
    reports = []
    values: dict = {}
    ledger_docs = []
    for i in range(shards):
        paths = _shard_paths(out_dir, i)
        if not os.path.exists(paths["result"]):
            if force:
                continue
            raise FleetMergeError(f"shard {i} left no result file ({paths['result']})")
        with open(paths["result"]) as f:
            rep = json.load(f)
        reports.append(rep)
        for s, v in rep["values"]:
            key = tuple(int(x) for x in s)
            if key in values:
                raise FleetMergeError(
                    f"subset {key} evaluated by more than one shard "
                    f"(shard {i} overlaps an earlier slice)")
            values[key] = float(v)
        if os.path.exists(paths["ledger"]):
            with open(paths["ledger"]) as f:
                ledger_docs.append(json.load(f))
    expected = set(spec.all_subsets())
    if not force and set(values) != expected:
        short = sorted(expected - set(values))[:8]
        raise FleetMergeError(
            f"merged shard values do not cover the sweep: "
            f"{len(values)}/{len(expected)} subsets (first missing: {short})")
    merged = merge_ledgers(ledger_docs) if ledger_docs else None
    return values, merged, reports


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------

def run_fleet(spec: FleetSpec, shards: int, out_dir: str,
              inproc: bool = False, devices_per_shard: "int | None" = None,
              env: "dict | None" = None,
              per_shard_env: "dict | None" = None,
              ledger: bool = True, timeout: float = 3600.0,
              concurrent: bool = True,
              verify_against: "dict | str | None" = None,
              device=None, threads: "int | None" = None) -> FleetResult:
    """Run a W-shard fleet sweep and merge it.

    `inproc=True` runs the shards one after another in this process (the
    slicing, merge and equality machinery are the same; only the process
    boundary is skipped). Otherwise each shard is a worker subprocess of
    this interpreter (`python3 -m mplc_tpu_torch.parallel.fleet --worker`),
    started together (`concurrent=False`: one at a time). Every shard runs
    on `device` (None: the card; the workers each open their own CUDA
    context), a worker with `threads` torch threads. `env` is the workers'
    base environment (`worker_env` filters it) and `per_shard_env`
    ({shard: {KEY: value}}) sets knobs of one shard (a fault plan). A
    worker that fails fails the run with `FleetError`, after one incident
    bundle. `verify_against` (a ledger doc or its path) requires the merged
    ledger to equal the reference, zero ulp drift and tau-b 1.0 over every
    coalition, and raises FleetMergeError otherwise, also when there is no
    merged ledger. `devices_per_shard` N gives each worker its own cards
    (`_shard_devices`) and, at N > 1, a world of N ranks (see the module
    docstring); N > 1 with `inproc`, or more cards than the host has,
    raises ValueError before any shard starts."""
    _check_devices_per_shard(devices_per_shard)
    if devices_per_shard is not None and devices_per_shard > 1:
        if inproc:
            raise ValueError(f"devices_per_shard={devices_per_shard} needs worker "
                             "processes: one process holds one device (inproc=False)")
        if _on_card(device):
            _shard_devices(0, shards, devices_per_shard, _visible_cards(env))
    os.makedirs(out_dir, exist_ok=True)
    run_id = _mint_run_id()
    manifest = {"run_id": run_id, "shards": shards, "coordinator_pid": os.getpid(),
                "inproc": bool(inproc), "spawn_ts": {}, "done_seen_ts": {}}
    coord_records: list = []
    t0 = time.perf_counter()
    try:
        with obs_trace.collect() as coord_records, \
                _env_overlay({FLEET_RUN_ID_ENV: run_id}):
            result = _run_fleet_traced(
                spec, shards, out_dir, inproc, devices_per_shard, env, per_shard_env,
                ledger, timeout, concurrent, verify_against, run_id, manifest, t0,
                obs_trace, device, threads)
    except FleetError as e:
        # one postmortem a failed run: the trace and the manifest first (the
        # bundle's tails read the shard files; a later fleet_trace_merge
        # over the folder needs both)
        _write_coordinator_trace(out_dir, coord_records)
        _atomic_json(os.path.join(out_dir, "fleet_trace_manifest.json"), manifest)
        _write_incident(out_dir, run_id, shards,
                        reason=("merge_refused" if isinstance(e, FleetMergeError)
                                else "shard_failure"),
                        error=e, failed=getattr(e, "failed_shards", None))
        raise
    _write_coordinator_trace(out_dir, coord_records)
    _atomic_json(os.path.join(out_dir, "fleet_trace_manifest.json"), manifest)
    return result


def _run_fleet_traced(spec, shards, out_dir, inproc, devices_per_shard, env,
                      per_shard_env, ledger, timeout, concurrent, verify_against,
                      run_id, manifest, t0, obs_trace, device, threads) -> FleetResult:
    """`run_fleet`'s traced body (apart, so that the wrapper writes the
    coordinator's trace, the clock manifest and the incident bundle on
    both exits)."""
    with obs_trace.span("fleet.sweep", shards=shards, inproc=bool(inproc),
                        devices_per_shard=devices_per_shard, run=run_id):
        if inproc:
            for i in range(shards):
                spawn_ts = time.time()
                manifest["spawn_ts"][str(i)] = spawn_ts
                overlay = _shard_obs_env(out_dir, run_id, i, spawn_ts)
                overlay.update((per_shard_env or {}).get(i) or {})
                with _env_overlay(overlay):
                    rep = run_shard(spec, i, shards, out_dir, ledger=ledger, device=device)
                manifest["done_seen_ts"][str(i)] = time.time()
                obs_trace.event("fleet.shard", dur=rep["wallclock_s"], shard=i,
                                shards=shards, wallclock_s=rep["wallclock_s"],
                                coalitions=len(rep["subsets"]))
        else:
            _run_fleet_subprocess(spec, shards, out_dir, devices_per_shard, env,
                                  per_shard_env, ledger, timeout, concurrent,
                                  run_id=run_id, manifest=manifest, device=device,
                                  threads=threads)
        values, merged, reports = merge_shard_results(spec, shards, out_dir)
        if merged is not None:
            _atomic_json(os.path.join(out_dir, "ledger_merged.json"), merged)
        if reports:
            # the shards computed the fingerprint: stamping the merged
            # cache must not build the game again in the coordinator
            fp = reports[0].get("fingerprint")
            if fp is None:
                with _env_overlay({constants.DETERMINISTIC_REDUCE_ENV:
                                   "1" if spec.deterministic else None}):
                    fp = _spec_fingerprint(spec, device)
            if fp is not None:
                write_cache_doc(os.path.join(out_dir, "cache_merged.json"), fp, values,
                                spec.partners)
        diff = None
        if verify_against is not None:
            if merged is None:
                # an equality proof was asked for and there are no bits to
                # compare: a refusal, never a silent pass
                raise FleetMergeError(
                    "verify_against given but the fleet run produced no merged "
                    "ledger (ledger=False, or no shard wrote one) — nothing was "
                    "verified")
            if isinstance(verify_against, str):
                with open(verify_against) as f:
                    verify_against = json.load(f)
            from ..obs.numerics import diff_ledgers
            diff = diff_ledgers(verify_against, merged)
            diff.pop("per_subset", None)
            expected_n = len(spec.all_subsets())
            if diff["drift"] or not diff["comparable"] or diff["common"] != expected_n:
                raise FleetMergeError(
                    f"fleet merge FAILED verification vs the reference ledger: "
                    f"comparable={diff['comparable']} drift={diff['drift']} "
                    f"covered={diff['common']}/{expected_n} subsets "
                    f"ulp={diff['ulp']} tau={diff['kendall_tau']}")
        wall = time.perf_counter() - t0
        obs_trace.event("fleet.merge", shards=shards, coalitions=len(values),
                        verified=verify_against is not None, wallclock_s=wall)
    return FleetResult(values=values, ledger=merged, shard_reports=reports,
                       wallclock_s=wall,
                       per_shard_wall_s=[r["wallclock_s"] for r in reports],
                       out_dir=out_dir, diff=diff,
                       per_shard_sweep_s=[r.get("sweep_s", r["wallclock_s"])
                                          for r in reports])


def _spec_fingerprint(spec: FleetSpec, device=None) -> "dict | None":
    """The engine fingerprint of the spec's game (for the merged cache),
    from a game built here; None on any failure: the merged cache is a
    convenience, never worth failing a merge that verified."""
    try:
        from ..contrib.engine import CharacteristicEngine
        return CharacteristicEngine(spec.build_scenario(device))._fingerprint()
    except Exception as e:  # noqa: BLE001 - a convenience artifact only
        logger.warning("fleet: merged-cache fingerprint unavailable (%s)", e)
        return None


def worker_env(base: "dict | None" = None, devices: "int | None" = None,
               extra: "dict | None" = None, threads: "int | None" = None,
               shard: int = 0, shards: int = 1, cards: "int | None" = None,
               device=None) -> dict:
    """A worker's environment: `base` (default this process's) with the
    port's knobs only (no `JAX_*`, `XLA_*` or other packages' `MPLC_*`
    variables), the parent's telemetry outputs stripped, cuBLAS's fixed
    workspace set before the worker's first cuBLAS call, `threads` as
    OMP_NUM_THREADS, then `extra` applied (None: unset). With `devices`
    (devices a shard) and `device` on the card, CUDA_VISIBLE_DEVICES is
    shard `shard` of `shards`'s cards (`_shard_devices` over the `cards`
    visible, None: torch's count), replacing any inherited value; with no
    card visible it is left as it is (the worker then fails: no fallback to
    the CPU)."""
    _check_devices_per_shard(devices)
    src = os.environ if base is None else base
    env = {k: v for k, v in src.items()
           if not k.startswith(("JAX_", "XLA_"))
           and (not k.startswith("MPLC_") or k.startswith("MPLC_TORCH_"))}
    for knob in _TELEMETRY_OUTPUTS:
        env.pop(knob, None)
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if threads:
        env["OMP_NUM_THREADS"] = str(int(threads))
    if devices is not None and _on_card(device):
        ids = _shard_devices(shard, shards, devices, _visible_cards(src, cards))
        if ids:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(ids)
    for k, v in (extra or {}).items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = str(v)
    return env


def _repo_root() -> str:
    """The folder that holds the `mplc_tpu_torch` package."""
    return str(Path(__file__).resolve().parents[2])


def worker_argv(spec_path: str, shard: int, shards: int, out_dir: str,
                ledger: bool = True, device=None, threads: "int | None" = None,
                devices: "int | None" = None, port: "int | None" = None,
                timeout: "float | None" = None) -> list:
    """The worker's command line: the one place the subprocess protocol
    (module path and flags) lives. `devices` above 1 makes the worker a
    world of that many ranks, on MASTER_PORT `port`, under `timeout`."""
    world = devices is not None and devices > 1
    return ([sys.executable, "-m", "mplc_tpu_torch.parallel.fleet",
             "--worker", spec_path, "--shard", f"{shard}/{shards}", "--out", out_dir]
            + ([] if ledger else ["--no-ledger"])
            + ([] if device is None else ["--device", str(device)])
            + ([] if not threads else ["--threads", str(int(threads))])
            + ([] if not world else ["--devices-per-shard", str(int(devices))])
            + ([] if not (world and port) else ["--master-port", str(int(port))])
            + ([] if not (world and timeout) else ["--timeout", repr(float(timeout))]))


def _free_ports(n: int) -> list:
    """`n` distinct free ports of the loopback (each worker world's
    MASTER_PORT: the worlds start at once), all held until all are read."""
    import socket
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _worker_tail(log_path: str) -> str:
    with contextlib.suppress(OSError):
        with open(log_path) as f:
            return f.read()[-2000:]
    return ""


def run_worker_subprocess(spec: FleetSpec, shard: int, shards: int, out_dir: str,
                          devices: "int | None" = None,
                          env: "dict | None" = None,
                          ledger: bool = True,
                          timeout: float = 3600.0,
                          device=None, threads: "int | None" = None) -> None:
    """Run ONE shard worker as a subprocess on `device` (None: the card),
    on its own cards at `devices` a shard (`worker_env`), and wait for it.
    Raises FleetError on a non-zero exit, with the tail of the worker's
    log."""
    _check_devices_per_shard(devices)
    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, "fleet_spec.json")
    with open(spec_path, "w") as f:
        f.write(spec.to_json())
    wenv = worker_env(env, devices, threads=threads, shard=shard, shards=shards,
                      device=device)
    wenv.setdefault("PYTHONPATH", _repo_root())
    log_path = os.path.join(out_dir, f"worker_shard{shard}.log")
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run(
                worker_argv(spec_path, shard, shards, out_dir, ledger, device, threads,
                            devices, timeout=timeout),
                env=wenv, stdout=log, stderr=subprocess.STDOUT, cwd=_repo_root(),
                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = -9
    if rc != 0:
        raise FleetError(f"fleet worker shard {shard}/{shards} failed rc={rc}: "
                         f"...{_worker_tail(log_path)[-400:]}")


def _run_fleet_subprocess(spec, shards, out_dir, devices_per_shard, env, per_shard_env,
                          ledger, timeout, concurrent=True, run_id=None, manifest=None,
                          device=None, threads=None) -> None:
    spec_path = os.path.join(out_dir, "fleet_spec.json")
    with open(spec_path, "w") as f:
        f.write(spec.to_json())
    repo_root = _repo_root()
    deadline = time.monotonic() + timeout
    world = devices_per_shard is not None and devices_per_shard > 1
    ports = _free_ports(shards) if world else [None] * shards
    cards = (len(_visible_cards(env))
             if devices_per_shard is not None and _on_card(device) else None)

    def _spawn(i):
        spawn_ts = time.time()
        if manifest is not None:
            manifest["spawn_ts"][str(i)] = spawn_ts
        # the trace context first, the caller's per-shard knobs last: an
        # explicit override beats the coordinator's defaults
        extra = _shard_obs_env(out_dir, run_id, i, spawn_ts)
        extra.update((per_shard_env or {}).get(i) or {})
        wenv = worker_env(env, devices_per_shard, extra, threads=threads, shard=i,
                          shards=shards, cards=cards, device=device)
        wenv.setdefault("PYTHONPATH", repo_root)
        log_path = os.path.join(out_dir, f"worker_shard{i}.log")
        log = open(log_path, "w")
        return (i, spawn_ts, subprocess.Popen(
            worker_argv(spec_path, i, shards, out_dir, ledger, device, threads,
                        devices_per_shard, ports[i], max(1.0, deadline - time.monotonic())),
            env=wenv, stdout=log, stderr=subprocess.STDOUT, cwd=repo_root),
            log, log_path)

    def _wait(i, spawn_ts, p, log, log_path):
        left = max(1.0, deadline - time.monotonic())
        try:
            rc = p.wait(left)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = -9
        log.close()
        done_ts = time.time()
        if manifest is not None:
            manifest["done_seen_ts"][str(i)] = done_ts
        # the dispatch anchor of the merged timeline, backdated to the spawn,
        # where the coordinator handed the work off
        obs_trace.event("fleet.shard", dur=done_ts - spawn_ts, shard=i, shards=shards,
                        wallclock_s=done_ts - spawn_ts, rc=rc)
        if rc == 0:
            return None
        return (i, rc, _worker_tail(log_path))

    failed = []
    if concurrent:
        procs = [_spawn(i) for i in range(shards)]
        try:
            failed = [f for f in (_wait(*p) for p in procs) if f is not None]
        finally:
            # no worker outlives its coordinator
            for _i, _ts, p, log, _path in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    else:
        for i in range(shards):
            f = _wait(*_spawn(i))
            if f is not None:
                failed.append(f)
    if failed:
        detail = "; ".join(f"shard {i} rc={rc}: ...{tail[-400:]}" for i, rc, tail in failed)
        err = FleetError(f"{len(failed)} fleet worker(s) failed: {detail}")
        err.failed_shards = [i for i, _rc, _tail in failed]
        raise err


def _mint_run_id() -> str:
    """A collision-resistant fleet run id (hex, not tied to the clock): the
    correlation key on every coordinator and worker trace record of one
    `run_fleet` call."""
    import secrets
    return f"fleet-{secrets.token_hex(6)}"


def _shard_obs_env(out_dir: str, run_id: str, shard: int, spawn_ts: float) -> dict:
    """The observability overlay of one shard: the trace context (the run
    and shard ids, stamped on every record by obs/trace._emit), the
    coordinator's spawn-time clock (echoed in the result for the clock
    handshake), a trace file and a flight-recorder folder of the shard's
    own inside the fleet folder, where the timeline merge and the incident
    bundle look. No Chrome conversion a shard: the coordinator's side
    makes one merged timeline."""
    return {
        FLEET_RUN_ID_ENV: run_id,
        FLEET_SHARD_ID_ENV: f"shard{shard}",
        FLEET_COORD_TS_ENV: repr(spawn_ts),
        obs_trace.TRACE_FILE_ENV: os.path.join(out_dir, f"trace_shard{shard}.jsonl"),
        flight.FLIGHT_DIR_ENV: os.path.join(out_dir, f"flight_shard{shard}"),
        obs_trace.CHROME_TRACE_FILE_ENV: None,
    }


def _write_coordinator_trace(out_dir: str, records: list) -> None:
    """The coordinator's own span stream (`fleet.sweep`, the `fleet.shard`
    dispatch events, `fleet.merge`) as trace_coordinator.jsonl. Records
    stamped with a `fleet_shard` are dropped: on the in-process path the
    collector saw the shards' records too, which the shard files hold."""
    try:
        path = os.path.join(out_dir, "trace_coordinator.jsonl")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            for r in records:
                if "fleet_shard" not in r:
                    f.write(json.dumps(r) + "\n")
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError) as e:
        logger.warning("fleet: coordinator trace write failed: %s", e)


def _tail_lines(path: str, n: int = 200) -> list:
    try:
        with open(path) as f:
            return f.readlines()[-n:]
    except OSError:
        return []


def _ledger_digest(path: str) -> "dict | None":
    """A small digest of one shard's value ledger: enough for a postmortem
    to pin which game and values the shard claimed, without the ledger."""
    try:
        import hashlib
        with open(path, "rb") as f:
            body = f.read()
        doc = json.loads(body)
        return {"path": path, "sha256": hashlib.sha256(body).hexdigest(),
                "entries": len(doc.get("entries") or {}),
                "engine_fingerprint": doc.get("engine_fingerprint"),
                "reduction_mode": (doc.get("meta") or {}).get("reduction_mode")}
    except (OSError, ValueError):
        return None


def _write_incident(out_dir: str, run_id: str, shards: int, reason: str,
                    error: BaseException, failed: "list | None") -> "str | None":
    """ONE timestamped postmortem folder of a failed fleet run: for each
    failed shard its flight dumps, trace tail, worker-log tail and ledger
    digest, and the cluster snapshot. Counts `fleet.incidents` and emits a
    `fleet.incident` event. Never raises; returns the folder (or None)."""
    try:
        import shutil

        from ..obs import fleet_view
        from ..obs import metrics as obs_metrics
        if not failed:
            # a merge refusal need not name a shard: blame the shards
            # without a marker, else keep every shard's story
            failed = [i for i in range(shards)
                      if not os.path.exists(_shard_paths(out_dir, i)["done"])] \
                or list(range(shards))
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        inc_dir = os.path.join(out_dir, f"incident_{stamp}_{run_id.split('-')[-1]}")
        os.makedirs(inc_dir, exist_ok=True)
        bundle = {"run_id": run_id, "reason": reason, "error": str(error)[:4000],
                  "ts": time.time(), "shards": shards, "failed_shards": sorted(failed),
                  "shard_artifacts": {}}
        for i in sorted(failed):
            art: dict = {}
            fdir = os.path.join(out_dir, f"flight_shard{i}")
            dumps = []
            if os.path.isdir(fdir):
                for name in sorted(os.listdir(fdir)):
                    if name.startswith("mplc_flight_"):
                        with contextlib.suppress(OSError):
                            shutil.copy2(os.path.join(fdir, name),
                                         os.path.join(inc_dir, name))
                            dumps.append(name)
            art["flight_dumps"] = dumps
            tail = _tail_lines(os.path.join(out_dir, f"trace_shard{i}.jsonl"))
            if tail:
                tail_name = f"trace_tail_shard{i}.jsonl"
                with open(os.path.join(inc_dir, tail_name), "w") as f:
                    f.writelines(tail)
                art["trace_tail"] = tail_name
                art["trace_tail_records"] = len(tail)
            log_tail = _tail_lines(os.path.join(out_dir, f"worker_shard{i}.log"), 40)
            if log_tail:
                art["log_tail"] = "".join(log_tail)[-2000:]
            art["ledger_digest"] = _ledger_digest(_shard_paths(out_dir, i)["ledger"])
            bundle["shard_artifacts"][str(i)] = art
        bundle["cluster"] = fleet_view.cluster_snapshot(
            out_dir=out_dir, state_dir=os.environ.get(FLEET_STATE_DIR_ENV))
        _atomic_json(os.path.join(inc_dir, "incident.json"), bundle)
        obs_metrics.counter("fleet.incidents").inc()
        obs_trace.event("fleet.incident", run=run_id, reason=reason,
                        failed_shards=len(failed), path=inc_dir)
        logger.warning("fleet: incident bundle written to %s", inc_dir)
        return inc_dir
    except Exception as e:  # noqa: BLE001 - a postmortem must not mask the failure
        logger.error("fleet: incident bundle failed: %s", e)
        return None


# ---------------------------------------------------------------------------
# the state plane: cross-shard service state
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the CLI: the worker and the selfcheck
# ---------------------------------------------------------------------------

def _worker_line(rep: dict, rank: int, ranks: int) -> str:
    """The line a worker (a rank of its world) prints: the cards it saw."""
    return (f"[fleet worker] shard {rep['shard']}/{rep['shards']} rank {rank}/{ranks}: "
            f"{rep['device']} ({rep['card']}), CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')}, {len(rep['subsets'])} coalitions")


def _shard_rank(spec_json: str, shard: int, shards: int, out_dir: str, ledger: bool,
                device) -> dict:
    """One rank of a shard's world (`launch.spawn`'s target): `run_shard`,
    the trace file kept by rank 0 alone (the fleet's timeline holds one
    track a shard; the flight dumps are named by process)."""
    from . import mesh
    rank = mesh.world_rank()
    if rank:
        os.environ.pop(obs_trace.TRACE_FILE_ENV, None)
    rep = run_shard(FleetSpec.from_json(spec_json), shard, shards, out_dir,
                    ledger=ledger, device=device)
    print(_worker_line(rep, rank, mesh.world_size()), flush=True)
    return rep


def _cli_worker(args) -> int:
    m = re.fullmatch(r"(\d+)/(\d+)", args.shard)
    if not m:
        print(f"--shard must be I/W, got {args.shard!r}", file=sys.stderr)
        return 2
    shard, shards = int(m.group(1)), int(m.group(2))
    ranks = args.devices_per_shard or 1
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    with open(args.spec) as f:
        spec_json = f.read()
    try:
        if ranks > 1:
            # the shard's world: a rank a card of this worker's block (cuda:r
            # of CUDA_VISIBLE_DEVICES), or a gloo rank on the CPU
            from . import launch
            device = args.device or "cuda"
            threads = args.threads or (1 if device == "cpu"
                                       else max(1, (os.cpu_count() or 1) // ranks))
            rep = launch.spawn(f"{__name__}:_shard_rank", ranks,
                               (spec_json, shard, shards, args.out, not args.no_ledger,
                                args.device), device=device, timeout=args.timeout,
                               threads=threads, port=args.master_port)[0]
        else:
            rep = run_shard(FleetSpec.from_json(spec_json), shard, shards, args.out,
                            ledger=not args.no_ledger, device=args.device)
            print(_worker_line(rep, 0, 1), flush=True)
    except BaseException as e:  # noqa: BLE001 - InjectedCrash included
        # a dying worker's last act: a flight dump into the shard's flight
        # folder the coordinator set, so the incident bundle holds this
        # shard's last records even after a simulated kill
        flight.dump("fleet_worker_crash",
                    extra={"shard": shard, "shards": shards, "error": repr(e)[:500]})
        raise
    print(json.dumps({"shard": shard, "coalitions": len(rep["subsets"]),
                      "wallclock_s": rep["wallclock_s"], "device": rep["device"],
                      "devices": rep["devices"]}))
    return 0


def _cli_selfcheck(args) -> int:
    """The fleet smoke: a small deterministic Titanic sweep at 1 shard, then
    at `--shards` shards (worker subprocesses on `--device`), the merged
    ledgers diffed: exit 0 only on zero ulp drift and tau-b 1.0 over every
    coalition."""
    from ..obs.numerics import diff_ledgers
    spec = FleetSpec()  # Titanic, 3 partners, 2 epochs, deterministic
    dps = args.devices_per_shard
    with tempfile.TemporaryDirectory(prefix="mplc_fleet_smoke_") as tmp:
        env = worker_env(extra={constants.SYNTH_SCALE_ENV:
                                os.environ.get(constants.SYNTH_SCALE_ENV, "0.02")})
        t0 = time.perf_counter()
        kw = dict(env=env, timeout=args.timeout, device=args.device, threads=args.threads)
        ref = run_fleet(spec, 1, os.path.join(tmp, "w1"),
                        devices_per_shard=None if dps is None else 1, **kw)
        got = run_fleet(spec, args.shards, os.path.join(tmp, "w"), devices_per_shard=dps,
                        **kw)
        workers = {}
        for i in range(args.shards):
            # each worker's (each rank's) line naming the cards it saw
            lines = [ln.rstrip() for ln in _tail_lines(
                os.path.join(got.out_dir, f"worker_shard{i}.log"), 400)
                if ln.startswith("[fleet worker]")]
            workers[i] = lines
            for ln in lines:
                print(ln, flush=True)
        diff = diff_ledgers(ref.ledger, got.ledger)
        ok = (diff["comparable"] and not diff["drift"] and diff["kendall_tau"] == 1.0
              and diff["common"] == len(spec.all_subsets()))
        obs = None
        if args.obs_dir:
            # one merged Perfetto timeline and one aggregated snapshot of
            # the W-shard run, each required to hold one entry a shard
            from ..obs import fleet_view
            os.makedirs(args.obs_dir, exist_ok=True)
            merged = fleet_view.merge_fleet_traces(got.out_dir)
            trace_path = os.path.join(args.obs_dir, "fleet_trace.json")
            _atomic_json(trace_path, merged["trace"])
            snap = fleet_view.cluster_snapshot(out_dir=got.out_dir)
            varz_path = os.path.join(args.obs_dir, "fleet_varz.json")
            _atomic_json(varz_path, snap)
            obs = {"trace": trace_path, "varz": varz_path,
                   "shard_tracks": merged["shard_tracks"],
                   "flow_links": merged["flow_links"],
                   "snapshot_shards": len(snap.get("shards") or {})}
            ok = (ok and merged["shard_tracks"] == args.shards
                  and merged["flow_links"] == args.shards
                  and obs["snapshot_shards"] == args.shards)
        ok = ok and all(len(workers[i]) == (dps or 1) for i in workers)
        print(json.dumps({
            "shards": args.shards, "devices_per_shard": dps, "subsets": diff["common"],
            "comparable": diff["comparable"], "drift": diff["drift"],
            "max_ulp": diff["ulp"]["max"], "kendall_tau": diff["kendall_tau"],
            "devices": sorted({r["device"] for r in ref.shard_reports + got.shard_reports}),
            "shard_cards": [{"devices": r["devices"], "visible": r.get("visible_devices"),
                             "card": r.get("card")} for r in got.shard_reports],
            "wallclock_s": round(time.perf_counter() - t0, 1),
            "obs": obs, "ok": ok}))
        if not ok:
            print(f"[fleet] selfcheck FAILED: {args.shards}-shard merged ledger is not "
                  "bit-identical to the 1-shard run", file=sys.stderr)
            return 1
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the fleet sweep: a shard worker or the "
                                             "1-vs-W-shard equality selfcheck")
    ap.add_argument("--worker", dest="spec", default=None,
                    help="run as a shard worker over this FleetSpec JSON")
    ap.add_argument("--shard", default=None, help="I/W (worker mode)")
    ap.add_argument("--out", default=None, help="the shared output folder")
    ap.add_argument("--no-ledger", action="store_true")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the 1-vs-W-shard equality smoke and exit non-zero on "
                         "any drift")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("--obs-dir", default=None,
                    help="selfcheck: also write the merged Perfetto trace and the "
                         "aggregated fleet snapshot here and fail unless both hold "
                         "one entry a shard")
    ap.add_argument("--device", default=None,
                    help="the device every shard runs on (default: the card; 'cpu' "
                         "to run on the CPU)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads of a worker")
    ap.add_argument("--devices-per-shard", type=int, default=None,
                    help="devices a shard (a worker's own cards; above 1 a world of "
                         "ranks); the selfcheck's 1-shard run then takes 1")
    ap.add_argument("--master-port", type=int, default=None,
                    help="worker mode: its world's MASTER_PORT (default: a free port)")
    args = ap.parse_args(argv)
    if args.devices_per_shard is not None and args.devices_per_shard < 1:
        ap.error("--devices-per-shard must be at least 1")
    if args.spec:
        if not (args.shard and args.out):
            ap.error("--worker requires --shard I/W and --out DIR")
        return _cli_worker(args)
    if args.selfcheck:
        return _cli_selfcheck(args)
    ap.error("one of --worker/--selfcheck is required")


if __name__ == "__main__":
    sys.exit(main())
