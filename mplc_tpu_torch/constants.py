"""Framework-wide constants of the PyTorch port.

The names and defaults follow `mplc_tpu/constants.py`, so a configuration
written for the JAX package keeps its meaning here. The port's environment
knobs carry their own `MPLC_TORCH_` prefix.
"""

from __future__ import annotations

import os
import warnings

# ML defaults (reference: mplc/constants.py:7-12)
DEFAULT_BATCH_SIZE = 256
MAX_BATCH_SIZE = 2 ** 20
DEFAULT_GRADIENT_UPDATES_PER_PASS_COUNT = 8
PATIENCE = 10  # early-stopping patience, in epochs
DEFAULT_BATCH_COUNT = 20
DEFAULT_EPOCH_COUNT = 40

# Logging file names of an experiment folder (utils.set_log_file)
INFO_LOGGING_FILE_NAME = "info.log"
DEBUG_LOGGING_FILE_NAME = "debug.log"

# The CLI's experiment folders live under this folder of the working
# directory
EXPERIMENTS_FOLDER_NAME = "experiments"

# Quick-demo shrink sizes (`Scenario(is_quick_demo=True)`)
TRAIN_SET_MAX_SIZE_QUICK_DEMO = 1000
VAL_SET_MAX_SIZE_QUICK_DEMO = 500
TEST_SET_MAX_SIZE_QUICK_DEMO = 500

# A folder of cached or raw datasets (`mnist.npz`, `cifar10.npz`,
# `titanic.npz`, `titanic.csv`, `imdb.npz`, `esc50.npz`, `esc50/`), looked
# at before `~/.keras/datasets`; where neither holds a dataset, its loader
# synthesizes it. Read when a loader runs.
DATA_DIR_ENV = "MPLC_TORCH_DATA_DIR"

# Contributivity method registry names: every method the JAX package
# knows, all of them computed by the port.
CONTRIBUTIVITY_METHODS = [
    "Shapley values",
    "Independent scores",
    "TMCS",
    "ITMCS",
    "IS_lin_S",
    "IS_reg_S",
    "AIS_Kriging_S",
    "SMCS",
    "WR_SMC",
    "Federated SBS linear",
    "Federated SBS quadratic",
    "Federated SBS constant",
    "LFlip",
    "PVRL",
    "GTG-Shapley",
    "SVARM",
    "auto",
]

# Dataset tags (reference: mplc/constants.py:46-52)
MNIST = "mnist"
CIFAR10 = "cifar10"
TITANIC = "titanic"
ESC50 = "esc50"
IMDB = "imdb"
SUPPORTED_DATASETS_NAMES = [MNIST, CIFAR10, TITANIC, ESC50, IMDB]


def _env_nonneg_float(name: str, default: float) -> float:
    """A non-negative float knob (0 is meaningful, e.g. a retry backoff of
    0 s); a malformed or NaN value warns and falls back."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = float(raw)
        if not value >= 0:
            raise ValueError(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a non-negative number; "
                      f"falling back to {default}", stacklevel=2)
        return default
    return value


def _env_nonneg_int(name: str, default: int) -> int:
    """A non-negative integer knob (0 is a documented value, e.g. "auto");
    a malformed value warns and falls back."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
        if value < 0:
            raise ValueError(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a non-negative integer; "
                      f"falling back to {default}", stacklevel=2)
        return default
    return value


def _env_positive_int(name: str, default: int) -> int:
    """A positive integer knob; a malformed value warns and falls back."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
        if value <= 0:
            raise ValueError(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a positive integer; "
                      f"falling back to {default}", stacklevel=2)
        return default
    return value


# Scale of the synthetic datasets (fraction of the published sample
# counts). The loaders take `scale=` explicitly; this is their default.
SYNTH_SCALE_ENV = "MPLC_TORCH_SYNTH_SCALE"


def synth_scale() -> float:
    return _env_nonneg_float(SYNTH_SCALE_ENV, 1.0)


# Noise of the synthetic image datasets (MNIST, CIFAR10), the JAX package's
# synthetic-noise knob: read by `load_mnist` and `load_cifar10` when no
# `noise` argument is given; unset, each loader keeps its default.
SYNTH_NOISE_ENV = "MPLC_TORCH_SYNTH_NOISE"


def synth_noise(default: float) -> float:
    return _env_nonneg_float(SYNTH_NOISE_ENV, default)


# Samples per evaluation chunk (MPLC_TORCH_EVAL_CHUNK, default 2048 as in
# the JAX package). Read once at import: eval sets are chunked when they
# are staged. A malformed value warns and gives 2048.
EVAL_CHUNK_SIZE = _env_positive_int("MPLC_TORCH_EVAL_CHUNK", 2048)

# Models x rows evaluated in one forward call when a batch of models scores
# one eval set: bounds the activation memory of a reconstruction batch
# (the MNIST CNN's second conv alone holds 147 KB per sample).
EVAL_ROWS_IN_FLIGHT = 16384
# ... and those rows' largest activation, in bytes: EVAL_ROWS_IN_FLIGHT rows
# of the MNIST CNN's 147,456 (2.25 GiB). A model whose rows are wider (the
# ESC50 CNN's first conv: 1,073,280 bytes a row) evaluates fewer rows at
# once; the MNIST CNN, the CIFAR10 CNN and Titanic stay at the row bound.
EVAL_BYTES_IN_FLIGHT = EVAL_ROWS_IN_FLIGHT * 24 * 24 * 64 * 4


def eval_rows_in_flight(row_bytes: int) -> int:
    """Models x rows of one evaluation forward call, for models whose
    largest activation is `row_bytes` a row (0: unknown, the row bound)."""
    if row_bytes <= 0:
        return EVAL_ROWS_IN_FLIGHT
    return max(1, min(EVAL_ROWS_IN_FLIGHT, EVAL_BYTES_IN_FLIGHT // row_bytes))

# Coalitions trained per batch by the retraining sweep
# (contrib/engine.py): the JAX package's default ceiling per device. The
# engine's cap is the smaller of this ceiling and what half the device's
# memory holds (`CharacteristicEngine._device_batch_cap`), halved again by
# every OOM rung. Read when a cap is computed:
#   MPLC_TORCH_COALITIONS_PER_DEVICE  a fixed cap in place of the autotune
#                                     (still halved by the OOM ladder);
#   MPLC_TORCH_BATCH_CAP_CEILING      the ceiling in place of 16.
MAX_COALITIONS_PER_DEVICE_BATCH = 16
# A training step's activations a row, in units of the model's largest
# activation (`Model.eval_row_bytes`): every layer's output kept for the
# backward pass and one layer's gradients in and out. Sizes a gradient
# call in the cap's footprint model (`CharacteristicEngine._batch_fixed_bytes`)
TRAIN_ACTIVATIONS_PER_ROW = 6
# ... and an evaluation's: a layer's input, its output and a convolution's
# workspace (cuDNN's FFT algorithms take about an activation's size)
EVAL_ACTIVATIONS_PER_ROW = 3
COALITIONS_PER_DEVICE_ENV = "MPLC_TORCH_COALITIONS_PER_DEVICE"
BATCH_CAP_CEILING_ENV = "MPLC_TORCH_BATCH_CAP_CEILING"

# The fault ladder (contrib/engine.py, faults.py), read when a
# CharacteristicEngine is built; a malformed value warns and falls back:
#   MPLC_TORCH_FAULT_PLAN         the deterministic batch-fault plan
#                                 (grammar in faults.py);
#   MPLC_TORCH_MAX_RETRIES        retries of a transient failure a batch (3);
#   MPLC_TORCH_RETRY_BACKOFF_SEC  the first retry's backoff (0.5 s),
#                                 doubling each attempt up to
#                                 RETRY_BACKOFF_CAP_SEC;
#   MPLC_TORCH_MAX_CAP_HALVINGS   OOM cap halvings before the ladder ends:
#                                 a CUDA engine raises LadderExhaustedError,
#                                 a CPU engine runs the rest on its CPU
#                                 rung (3);
#   MPLC_TORCH_FAULT_RANK         in a world of ranks (parallel/mesh.py),
#                                 the one rank whose batch plan is armed
#                                 (unset: every rank's), so that one rank
#                                 of a world fails where its peers do not.
FAULT_PLAN_ENV = "MPLC_TORCH_FAULT_PLAN"
FAULT_RANK_ENV = "MPLC_TORCH_FAULT_RANK"
MAX_RETRIES_ENV = "MPLC_TORCH_MAX_RETRIES"
RETRY_BACKOFF_ENV = "MPLC_TORCH_RETRY_BACKOFF_SEC"
MAX_CAP_HALVINGS_ENV = "MPLC_TORCH_MAX_CAP_HALVINGS"
RETRY_BACKOFF_CAP_SEC = 30.0  # the bound on one backoff sleep

# Coalitions reconstructed and evaluated per batch by the retrain-free
# evaluator (contrib/reconstruct.py).
RECON_BATCH = _env_positive_int("MPLC_TORCH_RECON_BATCH", 64)

# GTG-Shapley's within-round truncation threshold (default 0.05, as in
# the JAX package).
GTG_TRUNCATION_ENV = "MPLC_TORCH_GTG_TRUNCATION"


def gtg_truncation() -> float:
    return _env_nonneg_float(GTG_TRUNCATION_ENV, 0.05)


# SVARM's sampled-coalition budget after the exact anchors and the stratum
# warm-up; 0 or unset means max(4 n^2, 128). Read when SVARM runs.
SVARM_SAMPLES_ENV = "MPLC_TORCH_SVARM_SAMPLES"


def svarm_samples() -> int:
    return _env_nonneg_int(SVARM_SAMPLES_ENV, 0)


# The planner's defaults for `compute_contributivity("auto")`
# (contrib/planner.py), read when a query is planned:
#   MPLC_TORCH_PLANNER_ACCURACY      accuracy target, the trust-row CI
#                                    half-width on normalized scores
#                                    (0 or unset: 0.02);
#   MPLC_TORCH_PLANNER_DEADLINE_SEC  deadline in seconds (0 or unset: none).
PLANNER_ACCURACY_ENV = "MPLC_TORCH_PLANNER_ACCURACY"
PLANNER_DEADLINE_ENV = "MPLC_TORCH_PLANNER_DEADLINE_SEC"


# Precision modes, with the JAX package's semantics (its precision knob,
# `mplc_tpu/constants.py`):
#   fp32   (default) everything in float32.
#   mixed  model compute (forward, backward, evaluation) in bf16; master
#          parameters, Adam state, FedAvg aggregation, the recorded update
#          stream and the reconstruction stay float32.
#   bf16   `mixed`, plus reconstruction from bf16 round weights and bf16
#          recorded deltas (fp32 accumulation in the kernel), its models
#          cast to bf16 and evaluated in bf16.
# Read when a TrainConfig is built and frozen into it.
PRECISION_ENV = "MPLC_TORCH_PRECISION"
PRECISION_MODES = ("fp32", "mixed", "bf16")
# The Scenario's `compute_dtype`: "bfloat16" computes the model in bf16
# under the fp32 mode too
COMPUTE_DTYPES = ("float32", "bfloat16")


def precision_mode() -> str:
    """MPLC_TORCH_PRECISION: fp32 | mixed | bf16, case-insensitive; unset
    gives fp32, any other value warns and gives fp32."""
    raw = os.environ.get(PRECISION_ENV, "").strip().lower()
    if not raw:
        return "fp32"
    if raw not in PRECISION_MODES:
        warnings.warn(f"{PRECISION_ENV}={raw!r} is not one of {PRECISION_MODES}; "
                      f"falling back to fp32", stacklevel=2)
        return "fp32"
    return raw


# Deterministic reduction (the JAX package's knob of the same name):
# =1 folds every aggregation's normalizer and weighted sum strictly left to
# right (ops/aggregation.py `ordered_fold`), so slot and masked training of
# one coalition aggregate to the same bits. Default off: `torch.sum`. Read
# when a TrainConfig is built and frozen into it, so a trainer's reduction
# is the one its coalition cache fingerprint names.
DETERMINISTIC_REDUCE_ENV = "MPLC_TORCH_DETERMINISTIC_REDUCE"


def deterministic_reduce_enabled() -> bool:
    return os.environ.get(DETERMINISTIC_REDUCE_ENV, "") == "1"


# Slot execution of the retraining sweep (contrib/engine.py), read when a
# CharacteristicEngine is built:
#   MPLC_TORCH_NO_SLOTS=1    every fedavg coalition trains masked over all P
#                            partners (slot_bucketing "masked");
#   MPLC_TORCH_SLOT_MERGE=0  one slot width per coalition size ("exact");
#   MPLC_TORCH_SLOT_POW2=1   sizes rounded up to a power of two ("pow2").
# The default ("merge") runs sizes k and k + 1 (k even) at width k + 1.
NO_SLOTS_ENV = "MPLC_TORCH_NO_SLOTS"
SLOT_MERGE_ENV = "MPLC_TORCH_SLOT_MERGE"
SLOT_POW2_ENV = "MPLC_TORCH_SLOT_POW2"

# Fused wide steps (the JAX package's step-width knob): k folds k
# consecutive gradient_updates_per_pass sub-batches of every multi-partner
# pass into one k-times-wider optimizer step, ceil(gup / k) steps a pass.
# 1 (the default) is the per-sub-batch stepping; k > 1 is a documented
# deviation from the reference trajectory. Read when a TrainConfig is built
# and frozen into it; a malformed value warns and gives 1.
STEP_WIDTH_MULT_ENV = "MPLC_TORCH_STEP_WIDTH_MULT"


def step_width_mult() -> int:
    return _env_positive_int(STEP_WIDTH_MULT_ENV, 1)


# The partner fault plan (grammar in faults.py): dropout and straggler
# entries shape the engine's trainers, noisy and glabel entries the data
# (Scenario.data_corruption). It changes v(S), so it is part of the
# coalition cache's fingerprint. Read by Scenario.data_corruption, or by
# the CharacteristicEngine when the scenario never ran it.
PARTNER_FAULT_PLAN_ENV = "MPLC_TORCH_PARTNER_FAULT_PLAN"

# Seed ensembles: K > 1 trains K replicas of every coalition, each from its
# own random stream, as extra rows of the same batches; replica 0 is the
# single-seed run, the others feed the exact Shapley sweep's trust row.
# Read when a CharacteristicEngine is built (its `seed_ensemble=` argument
# overrides it); a malformed value warns and gives 1.
SEED_ENSEMBLE_ENV = "MPLC_TORCH_SEED_ENSEMBLE"


def seed_ensemble() -> int:
    return _env_positive_int(SEED_ENSEMBLE_ENV, 1)


# The 2-D [coal, part] mode (contrib/engine.py, parallel/): p splits every
# fedavg or lflip coalition's partners over p ranks of a row of the
# launcher's world, the coalitions over its world_size / p rows. Read when
# a CharacteristicEngine is built; it wins over the Scenario's
# `partner_shards`, and a value below 1 (or not an integer) raises. Set to
# 1 under the deterministic reduce it runs the 2-D pipeline with whole
# partner rows (the JAX package's route there; unset, the port keeps its
# 1-D masked route, which gives the same bits).
PARTNER_SHARDS_ENV = "MPLC_TORCH_PARTNER_SHARDS"


def partner_shards(default: int) -> tuple[int, bool]:
    """(the shard count, whether the environment set it): the knob when
    set, else `default` (the Scenario's value)."""
    raw = os.environ.get(PARTNER_SHARDS_ENV, "").strip()
    if not raw:
        return int(default), False
    try:
        value = int(raw)
    except ValueError:
        value = 0
    if value < 1:
        raise ValueError(f"{PARTNER_SHARDS_ENV} must be an integer >= 1, got {raw!r}")
    return value, True


# Every process group of the launcher's world (parallel/mesh.py) waits at
# most this long in one collective: a rank that died or diverged fails its
# peers instead of hanging them. Not a knob.
PROCESS_GROUP_TIMEOUT_SEC = 300


# Device cost (obs/devcost.py), read when a CharacteristicEngine is built:
#   MPLC_TORCH_DEVICE_FENCE_RATE  fraction of the engine's batches that run
#                                 fenced: CUDA events around the batch's
#                                 dispatch and harvest time its device
#                                 seconds. Every round(1/rate)-th batch
#                                 ordinal, ordinal 1 included, so a run
#                                 replays its fences. Default 1/16; 0 is
#                                 off. A fence never changes v(S).
DEVICE_FENCE_RATE_ENV = "MPLC_TORCH_DEVICE_FENCE_RATE"

# The numerics plane (obs/numerics.py), read when an engine is built:
#   MPLC_TORCH_NUMERICS_AUDIT   =1 audits the first coalition of up to 4
#                               fenced batches an engine: a separate
#                               recording run captures its per-round,
#                               per-partner aggregation terms, and the host
#                               replays the partner reduction in the order
#                               the engine executes (`torch.sum`, or
#                               `ordered_fold` under the deterministic
#                               reduce) against the left-to-right fold,
#                               localizing the first divergence. The
#                               engine's own batches are untouched, so
#                               v(S) is bit-equal with the audit on or off.
#   MPLC_TORCH_NUMERICS_LEDGER  path of the value ledger (JSON, the JAX
#                               package's schema): every harvested v(S)
#                               with its exact bits and float path (slot
#                               width, cap halvings, reduction mode),
#                               keyed by (subset bitmask, engine
#                               fingerprint); saved after each evaluate()
#                               call that did device work.
NUMERICS_AUDIT_ENV = "MPLC_TORCH_NUMERICS_AUDIT"
NUMERICS_LEDGER_ENV = "MPLC_TORCH_NUMERICS_LEDGER"


# The program bank and the kernel build folder (contrib/bank.py,
# ops/cuda_build.py, utils.enable_compile_cache_from_env):
#   MPLC_TORCH_PROGRAM_BANK        "0" disables the program bank (read when
#                                  an engine is built and at each acquire).
#                                  The port's bank records program keys and
#                                  their counted FLOPs only: eager torch
#                                  compiles nothing, so a bank on or off
#                                  never changes a value. Off, nothing is
#                                  written to a shared folder's manifest and
#                                  the planner's meterless estimate falls
#                                  from "bank_cost_model" to "default". The
#                                  JAX package's bank knob, so one
#                                  environment sets both packages alike.
#   MPLC_TORCH_COMPILE_CACHE_DIR   the kernel build folder, shared between
#                                  checkouts and processes (libraries are
#                                  named by a digest of their source and
#                                  nvcc flags), and the folder of the
#                                  bank's manifest. Unset: `build/kernels`
#                                  of a writable checkout, else a user
#                                  cache folder; no manifest.
PROGRAM_BANK_ENV = "MPLC_TORCH_PROGRAM_BANK"
COMPILE_CACHE_DIR_ENV = "MPLC_TORCH_COMPILE_CACHE_DIR"

# The live contributivity tier (live/), the JAX package's knobs and
# defaults; a malformed value warns and falls back:
#   MPLC_TORCH_LIVE_PRUNE_TAU    DPVS pruning threshold tau in [0, 1], read
#                                at query time; 0 (default) is off, and
#                                an out-of-range value warns and turns
#                                pruning off for the query.
#   MPLC_TORCH_LIVE_MAX_ROUNDS   resident rounds a game holds (4096), read
#                                when a game is built: an append past it
#                                raises LiveGameFull.
#   MPLC_TORCH_LIVE_MAX_RESIDENT games holding their rounds in memory at
#                                once (process-wide, live/residency.py,
#                                read at every admission); past it the
#                                least recently used journaled game is
#                                evicted to its WAL. 0/unset: unbounded.
#   MPLC_TORCH_LIVE_CLUSTERS     cluster count of hierarchical queries
#                                (live/hierarchy.py; 0/unset: about
#                                sqrt(P), clamped to 16).
#   MPLC_TORCH_LIVE_CLUSTER_TAU  partners scoring below tau x the largest
#                                DPVS score share one tail cluster (0,
#                                default: no tail cluster).
LIVE_PRUNE_TAU_ENV = "MPLC_TORCH_LIVE_PRUNE_TAU"
LIVE_MAX_ROUNDS_ENV = "MPLC_TORCH_LIVE_MAX_ROUNDS"
LIVE_MAX_RESIDENT_ENV = "MPLC_TORCH_LIVE_MAX_RESIDENT"
LIVE_CLUSTERS_ENV = "MPLC_TORCH_LIVE_CLUSTERS"
LIVE_CLUSTER_TAU_ENV = "MPLC_TORCH_LIVE_CLUSTER_TAU"
#   MPLC_TORCH_LIVE_QUERY_DEADLINE_SEC
#                                the default deadline of a live query job
#                                submitted through the sweep service
#                                (`SweepService.submit_live`); 0/unset:
#                                none. An explicit deadline_sec wins.
#   MPLC_TORCH_LIVE_INGEST       "1" gives the telemetry server its
#                                streaming-ingestion route (POST
#                                /live/<tenant>/round, obs/export.py): a
#                                wire round fed to the tenant's game
#                                without an in-process call. Off by
#                                default: a mutating HTTP surface is the
#                                operator's decision.
LIVE_QUERY_DEADLINE_ENV = "MPLC_TORCH_LIVE_QUERY_DEADLINE_SEC"
LIVE_INGEST_ENV = "MPLC_TORCH_LIVE_INGEST"

# The sweep service (service/), the JAX package's knobs and defaults, all
# read when a SweepService is built, a malformed value warning and falling
# back:
#   MPLC_TORCH_SERVICE_MAX_PENDING  jobs not yet terminal the queue admits
#                                   (32); past it submit() raises
#                                   ServiceOverloaded
#   MPLC_TORCH_SERVICE_SLICE        coalitions a scheduling quantum of an
#                                   exact sweep (16)
#   MPLC_TORCH_SERVICE_FAULT_PLAN   the service fault plan, addressed by
#                                   submission ordinal (faults.py):
#                                   crash@job2:batch3, reject@job4,
#                                   stall@job1:sec2, chaos@rate0.05:seed7
#   MPLC_TORCH_SERVICE_WORKERS      worker threads (1), worker i on the
#                                   card i % torch.cuda.device_count()
#   MPLC_TORCH_SERVICE_PRIORITY_DEFAULT
#                                   the tier of a submit() that names none
#                                   (0); higher is more important
#   MPLC_TORCH_SERVICE_SHED_P99_SEC the overload governor's queue-wait p99
#                                   threshold: past it the lowest tier is
#                                   deferred, then shed (JobShed). 0/unset:
#                                   off
#   MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC
#                                   floor under the retry_after_sec hint of
#                                   ServiceOverloaded and JobShed (0.05)
#   MPLC_TORCH_PROFILE_DIR          where `submit(..., profile=True)` writes
#                                   a job's torch.profiler trace
#                                   (<dir>/<job_id>); unset: no trace
SERVICE_MAX_PENDING_ENV = "MPLC_TORCH_SERVICE_MAX_PENDING"
SERVICE_SLICE_ENV = "MPLC_TORCH_SERVICE_SLICE"
SERVICE_FAULT_PLAN_ENV = "MPLC_TORCH_SERVICE_FAULT_PLAN"
SERVICE_WORKERS_ENV = "MPLC_TORCH_SERVICE_WORKERS"
SERVICE_PRIORITY_DEFAULT_ENV = "MPLC_TORCH_SERVICE_PRIORITY_DEFAULT"
SERVICE_SHED_P99_ENV = "MPLC_TORCH_SERVICE_SHED_P99_SEC"
SERVICE_RETRY_FLOOR_ENV = "MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC"
PROFILE_DIR_ENV = "MPLC_TORCH_PROFILE_DIR"

# The telemetry plane (obs/export.py), read when a service is built:
#   MPLC_TORCH_METRICS_PORT   serve /metrics, /healthz and /varz on this
#                             loopback port (host:port to bind wider; 0:
#                             an ephemeral port). Unset: no thread, no
#                             socket
#   MPLC_TORCH_METRICS_TOKEN  the operator's bearer token: /metrics and
#                             /varz need it (or, for /varz, a tenant's
#                             HMAC credential, which sees only its own
#                             rows); /healthz stays open
METRICS_PORT_ENV = "MPLC_TORCH_METRICS_PORT"
METRICS_TOKEN_ENV = "MPLC_TORCH_METRICS_TOKEN"

# The fleet's state plane (parallel/fleet.py), read when a service is
# built; none of it changes a computed number:
#   MPLC_TORCH_FLEET_STATE_DIR  a folder each service process publishes its
#                               queue depth and admission state into, and
#                               reads the cluster's view back from (the
#                               redirect hint of ServiceOverloaded, the
#                               /healthz and /varz fleet blocks). Unset:
#                               the single-process behavior
#   MPLC_TORCH_FLEET_SHARD_ID   this process's name there (pid<pid>); also
#                               stamped as `fleet_shard` on every trace
#                               record while a fleet run id is set
#   MPLC_TORCH_FLEET_STALE_SEC  a shard whose state file is older than this
#                               (30 s) is stale: out of the live set and
#                               never the least-loaded redirect
FLEET_STATE_DIR_ENV = "MPLC_TORCH_FLEET_STATE_DIR"
FLEET_SHARD_ID_ENV = "MPLC_TORCH_FLEET_SHARD_ID"
FLEET_STALE_SEC_ENV = "MPLC_TORCH_FLEET_STALE_SEC"
# The fleet sweep's trace context (parallel/fleet.py sets both in every
# shard's environment; obs/trace.py reads them a record), sidecars that
# change no number:
#   MPLC_TORCH_FLEET_RUN_ID     the run id the coordinator mints, stamped
#                               as `fleet_run` on every span and event
#                               record, so W per-shard trace streams
#                               correlate by construction
#                               (obs/fleet_view.merge_fleet_traces)
#   MPLC_TORCH_FLEET_COORD_TS   the coordinator's clock when it started a
#                               shard; the worker echoes it in its result
#                               beside its own start and end readings, the
#                               handshake that rebases its trace onto the
#                               coordinator's clock (the midpoint rule)
FLEET_RUN_ID_ENV = "MPLC_TORCH_FLEET_RUN_ID"
FLEET_COORD_TS_ENV = "MPLC_TORCH_FLEET_COORD_TS"
#   MPLC_TORCH_FLEET_PEERS      comma-separated host:port /varz endpoints
#                               the fleet collector (obs/fleet_view.py)
#                               scrapes with the operator's token
FLEET_PEERS_ENV = "MPLC_TORCH_FLEET_PEERS"

# The fleet router (service/router.py), the redirect-acting front over N
# service shards, the JAX package's knobs and defaults, read when a
# FleetRouter is built (MPLC_TORCH_ROUTER_SERVE when a request arrives):
#   MPLC_TORCH_ROUTER_BUDGET           submit attempts a job gets (8), the
#                                      first and every resubmission after a
#                                      ServiceOverloaded or JobShed; past
#                                      it the job fails classified
#                                      (RoutedJobFailed)
#   MPLC_TORCH_ROUTER_BACKOFF_SEC      base of the capped exponential
#                                      backoff between resubmissions
#                                      (0.05): attempt k waits
#                                      max(retry_after hint,
#                                      min(base * 2^(k-1), 32 * base))
#   MPLC_TORCH_ROUTER_REPIN_OVERLOADS  overloads in a row from a tenant's
#                                      pinned shard before the router
#                                      re-pins it elsewhere (3), a
#                                      journaled event
#   MPLC_TORCH_ROUTER_FAULT_PLAN       the router's fault plan
#                                      (faults.py): shardkill@shard1:sec5
#   MPLC_TORCH_ROUTER_SERVE            "1" gives the telemetry server the
#                                      routed-submission routes a
#                                      ShardServer answers (POST
#                                      /router/submit, GET /router/job).
#                                      Off by default: a mutating HTTP
#                                      surface is the operator's decision
ROUTER_BUDGET_ENV = "MPLC_TORCH_ROUTER_BUDGET"
ROUTER_BACKOFF_ENV = "MPLC_TORCH_ROUTER_BACKOFF_SEC"
ROUTER_REPIN_OVERLOADS_ENV = "MPLC_TORCH_ROUTER_REPIN_OVERLOADS"
ROUTER_FAULT_PLAN_ENV = "MPLC_TORCH_ROUTER_FAULT_PLAN"
ROUTER_SERVE_ENV = "MPLC_TORCH_ROUTER_SERVE"
