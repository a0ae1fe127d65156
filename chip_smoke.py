#!/usr/bin/env python3
"""Drive the PyTorch port (`mplc_tpu_torch`) once on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. device: torch/CUDA versions and the card's name and power limit;
2. build: every CUDA kernel of the port, one nvcc process per source;
3. slice: the main path through the user entry points, at the MNIST CNN's
   full width: `Scenario(...).run()` with GTG-Shapley (train the grand
   coalition, record it, reconstruct coalitions through K1, evaluate),
   then `Contributivity(sc).exact_reconstructed()` over all 1023
   coalitions of 10 partners. Kernel launch counts are reset just before
   and read just after; every kernel of the path must have launched;
4. reference: the same recording on a small input (Titanic, 3 partners)
   on the card and on the CPU, which must agree;
5. stages: the slice's fit (warm) / record / reconstruct / evaluate
   seconds, each stage synchronized on its own;
6. kernels: each kernel on the main path's own inputs against its plain
   PyTorch version (K1 at the batch widths B = 64, 32 and 16, one for
   each of its coalition tiles), plus odd shapes, and K1 on
   standard-normal inputs against the exact sum; times from CUDA events;
7. precision: the main path again under MPLC_TORCH_PRECISION=bf16 (bf16
   model compute, reconstruction through K1-bf16; its launch counts reset
   just before and read just after), its values held against the fp32
   phase's (ulp distances, Kendall tau-b, |dv|); Titanic under `mixed` on
   the card against the CPU, and the MNIST CNN's bf16 logits on the card
   against the CPU, each with an fp32 control that must fail its limit;
   the bf16 stages; K1-bf16 against its plain version on the bf16 path's
   own inputs at the batch widths B = 64, 32 and 16 and on odd shapes, and
   on standard-normal inputs against its plain version (the distance from
   the exact sum printed beside the plain version's);
8. sweep: the retraining exact-Shapley sweep through the user entry point,
   `Scenario(methods=["Shapley values", "Independent scores"]).run()`, on
   the MNIST CNN at full width and 5 partners (31 coalitions retrained, the
   multi-partner ones on merged slot buckets), with its seconds per batch
   and peak memory; then the Titanic sweep on the card twice, which must
   be bit-equal, and on the CPU, which the card's must match within one
   test sample;
9. slots: the MNIST CNN at bench config 1's 10 partners, the 45 pairs and
   the 10 nine-partner coalitions on slots, the first 16 pairs again
   masked (`MPLC_TORCH_NO_SLOTS=1`), which must agree within one test
   sample and rank alike; then, under MPLC_TORCH_DETERMINISTIC_REDUCE=1, a
   Titanic batch of coalitions through the slot trainer and the masked
   trainer, whose parameters must agree within 1e-6;
10. cache: the sweep's coalition cache saved, a fresh scenario resumed
   from it (no batch trained, the same Shapley values bit for bit), and
   the file with one byte flipped quarantined on the next resume, which
   starts cold;
11. svarm: the retrain-free path's sampling estimator on the slice's own
   recording (10 partners, the MNIST CNN at full width), through a fresh
   reconstruction evaluator so its K1 launches are its own (counts reset
   just before and read just after; K1 must have launched): SVARM at its
   default budget of 400 coalitions, every value finite, within 0.05 of
   the slice's exact reconstructed values, with its trust row. Then
   `compute_contributivity("auto")` on the slice's evaluator: with no
   deadline it must plan `exact` and return the slice's exact values bit
   for bit; with a 20 s deadline it plans on the engine's metered
   seconds a reconstructed coalition (the "meter" basis; the plan
   printed), and on the default constant, with no evaluation metered, it
   must plan SVARM at budget 300;
12. estimators: the retraining estimators through the user entry point,
   `Scenario(methods=["TMCS", "ITMCS", "IS_lin_S", "IS_reg_S",
   "AIS_Kriging_S", "SMCS", "WR_SMC", "Shapley values"]).run()` on the
   sweep's configuration (5 partners): every value finite, every estimator
   within 0.05 of the exact Shapley values of the same run, no coalition
   trained twice (31 at most), and each method's call count the same when
   the estimators are run again over the run's v(S) table (the CPU tests
   hold that replay's counts equal to the JAX package's); every v(S)
   bit-equal to [sweep]'s, whatever the width of the request that trained
   it (the gradient-call width rule);
13. variants: the seq family and lflip through the user entry points at
   the MNIST CNN's full width: the 10-partner fedavg `Scenario` with
   Federated SBS x3 (equal to a numpy recomputation from its history),
   PVRL (values in (0, 1)) and LFlip (theta rows summing to 1, or 0 where
   the EM step zeroed them); the
   5-partner seqavg retraining sweep (1 epoch) on merged slot buckets (v(S) in
   [0, 1], Shapley values summing to v(N)), its first multi-partner batch
   again masked (printed), and that batch on slots and masked under the
   deterministic reduce (bit-equal); the seq-pure and
   seq-with-final-agg fits at 10 partners (accuracy above 0.3); Titanic
   seqavg (params within 1e-4) and a small MNIST lflip fit (theta within
   1e-5, weights within Adam's step bound, beside fedavg's as a control)
   on the card against the CPU. No reconstruction kernel launches in this
   phase;
14. faults: the partner fault plan, seed ensembles and fused wide steps.
   (a) The main path's configuration under
   MPLC_TORCH_PARTNER_FAULT_PLAN=dropout@p3:epoch2,straggler@p7:delay1:
   `Scenario.run()` with GTG-Shapley, then the exact reconstruction over
   all 1023 coalitions, K1's launches counted from 0 (it must launch), K1
   held against its plain version on this stream; partner 3's epoch-2
   deltas and weights exact zeros, the reconstructed grand coalition
   within 1e-4 of the recorded final params, every value finite, the
   recording made again bit-equal. (b) Titanic, 5 partners, under the
   deterministic reduce: the `dropout@p4:epoch1` sweep (on slots) against
   the fault-free one (masked), every v(S) within 1e-6 of v(S - {4}) and
   partner 4's Shapley value within 1e-6 of 0. (c) The sweep's 5-partner
   configuration at `MPLC_TORCH_SEED_ENSEMBLE=2`: replica 0 within one
   test sample of the sweep's values, fewer than twice its batches, a
   finite trust row. (d) Titanic on the card against the CPU, within 1e-4:
   a 3-partner recording under `straggler@p1:delay2` and a fedavg fit
   under MPLC_TORCH_STEP_WIDTH_MULT=2;
15. cifar10: the CIFAR10 CNN at full width (dropout, RMSprop) on bench
   config 2's training (5 partners split (i+1)/15, fedavg, data-volume,
   minibatch 10, gup 8, 2 epochs cut from 8), on synthetic CIFAR10 at
   scale 0.2 whose test set is 2,000 of the loader's training rows (the
   loader's own test set is drawn from other class prototypes, so no
   model scores above chance on it). (a) `Scenario(methods=["TMCS"]).run()`
   on merged slot buckets: every value finite, v(S) in [0, 1], v(N) above
   CIFAR_V_MIN. (b) GTG-Shapley over the grand coalition's recording (K =
   100 rows of D = 1,250,858), K1's launches counted from 0 (it must
   launch): the reconstructed grand coalition within 1e-4 of the recorded
   final params, K1 against its plain version on this stream, timed at
   B = 16. (c) A 3-partner fit on the card and on the CPU from one seed:
   every dropout mask drawn bit-equal, final params within 1e-4. (d) The
   recording made again, bit-equal. (e) One batch of coalitions on slots
   and masked under the deterministic reduce: bit-equal v(S);
16. imdb: bench config 4's scenario (bench.py:1870-1872: SMCS on IMDB, 4
   partners split (i+1)/10) with bench's training (`_make_scenario`:
   fedavg, data-volume, minibatch 10, gup 8, no early stopping, seed 0)
   cut to 2 epochs of its 8, on synthetic IMDB at scale 1.0 (22,500
   train, 2,500 val, 25,000 test rows of 500 int32 tokens), the IMDB
   model at its published width (2,227,873 parameters). (a)
   `Scenario(dataset_name="imdb", methods=["SMCS", "Shapley values"]).run()`:
   SMCS within 0.05 of exact, no coalition trained twice (15 at most),
   every v(S) in [0, 1], efficiency within 1e-6, v(N) above IMDB_V_MIN.
   (b) GTG-Shapley over the grand coalition's recording (K = 80 rows of
   D = 2,227,873), K1's launches counted from 0 (it must launch), the
   grand coalition within 1e-4 of the recording, K1 against its plain
   version on this stream, timed at B = 16. (c) A 3-partner fit card vs
   CPU: dropout masks bit-equal, params within 1e-4. (d) The recording
   again, bit-equal (the embedding's backward accumulates repeated
   tokens). (e) The bf16 logits card vs CPU on tokens above 256, with a
   control whose tokens went through bf16 that must fail;
17. esc50: synthetic ESC50 at scale 1.0 (2,000 clips of 50 classes:
   1,620 train, 180 val, 200 test rows), 3 partners [0.4, 0.3, 0.3]
   (bench.py `_amounts(3)`), bench's training cut to 2 epochs, the ESC50
   CNN at its published width (49,762 parameters). (a) The exact Shapley
   sweep through `Scenario(dataset_name="esc50").run()`: 7 coalitions,
   the multis on merged slots, seconds a batch and peak memory. (b)
   GTG-Shapley through K1 on the ESC50 stream (K = 60 rows of D =
   49,762), as [imdb] (b), with the recording again bit-equal. (c) A fit
   card vs CPU. (d) The evaluation's peak memory under the bytes bound
   on its rows in flight, beside the bound's row count;
18. cli: the user's entry point, `python3 -m mplc_tpu_torch.main -f
   <config>`, called in-process from a temporary folder outside the
   checkout (`mplc_tpu_torch.main.main`, so K1's launch counts, reset just
   before and read just after, are the CLI's). (a) A YAML grid with the
   `dataset_name` dict sub-syntax (`mnist: ~`) on synthetic MNIST at the
   slice's scale and noise, the MNIST CNN at full width, 4 partners [0.1,
   0.2, 0.3, 0.4], the splits ['basic', 'stratified'] and ['advanced',
   [[3, 'specific'], [3, 'specific'], [4, 'shared'], [2, 'shared']]],
   fedavg, data-volume, 2 epochs of minibatch 10 and gup 8, GTG-Shapley
   and Shapley values: exit 0; results.csv 2 x 2 x 4 = 16 rows in the
   JAX package's columns and order (`RESULTS_COLUMNS`, held to the JAX
   `to_dataframe()` by tests/test_torch_cli.py); the test score above 0.3
   (basic split) and 0.15 (advanced: 1.5 times chance, `CLI_V_MIN`) and
   every score finite; K1 launched, K1-bf16 not; two scenario
   folders (the dry runs made none), each with its final weights,
   `coalition_cache.json` and `history_data.p`, and the experiment's
   `info.log` and `debug.log`; K1 against its plain version on the
   first scenario's stream. (b) A warm start, `mnist: [<(a)'s first final
   weights>]`, 1 epoch, no method: the weights loaded on the card equal
   the file bit for bit, and its test score is no lower than (a)'s first
   scenario's minus 0.05. (c) Seconds a scenario (dry runs apart), the
   peak memory above the phase's start, K1's launches by batch width and
   whether the graphs were drawn (the card's machine has no matplotlib).
19. obs: the observability base. (a) The slice's main path again, with
   MPLC_TORCH_TRACE_FILE set to a temporary file, inside `trace.collect()`
   and with K1's launch counts reset just before: every value bit-equal to
   the slice's (tracing changes no number), K1 launched, the report's
   `reconstruction.recon_batches` equal to K1's launches, its eval-only
   `engine.batch` events counted by width equal to K1's launches by width,
   `reconstruction.reconstructions` the evaluator's count, memo hits plus
   misses the requests, every batch's dispatch and harvest inside an
   `engine.evaluate` span (the recording's dispatch inside `recon.record`),
   every record's name registered, each `contributivity` span's duration
   its method's `computation_time_sec`; the report printed with the traced
   seconds beside the slice's. (b) The JSONL converted to Chrome
   trace-event JSON: no torn line, the output loads, an event for every
   record. (c) `utils.profile_trace` around a fresh reconstruction
   evaluator on the slice's recording valuing 128 coalitions (two K1
   launches at B = 64): the profiler's CUDA kernel events hold K1's kernel
   exactly as many times as its launch count rose; K1's mean profiled time
   printed beside its CUDA-event time, with the window's device busy share
   and its top kernels. (d) The sweep phase's run, collected: the report's
   batch count equal to the engine's batch log, 31 coalitions, the
   device-memory high water above 0 and at most
   `torch.cuda.max_memory_allocated()`. (e) `obs.flight.dump` into a
   temporary folder: one file that parses, a ring no larger than its size,
   a metrics snapshot.
20. ladder: the fault ladder and the engine's batch control (backoff 0;
   each run a fresh Scenario, whose engine reads the knobs once). (a) The
   main path under MPLC_TORCH_FAULT_PLAN=transient@batch1,
   transient@harvest3,oom@batch5, K1's counts reset just before: 3 faults
   injected, 2 retries, 1 cap halving, K1 launched at B = 32 (and no more
   at 64), no CPU-degraded batch, the recording and every value bit-equal
   to the slice's (the GTG scores too), any value the halved width parts
   printed and held within one test sample. (b) The ladder's end: the
   slice's configuration under MPLC_TORCH_MAX_CAP_HALVINGS=1 and
   oom@batch2,oom@batch3, valuing 8 coalitions: the recording (batch 1)
   bit-equal, then a `LadderExhaustedError` (mode 1d, 2 halvings,
   permanent for the classifier, from the injected
   `torch.cuda.OutOfMemoryError`), the events halve_cap then
   ladder_exhausted, one flight dump, no CPU rung, no kernel launch, no
   value stored. (c) The sweep phase's run under
   transient@batch2,oom@harvest3: the counters as planned, 31 coalitions
   stored once, the batches (width 16, then the 4 coalitions of the
   failed harvest again at width 4), values within one test sample of the
   sweep phase's (bit-equal: a re-run pads its gradient calls to its
   call's first width). (d) The sweep phase's dispatch/harvest split; one
   slot batch of 16 coalitions dispatched under
   `torch.cuda.set_sync_debug_mode("error")` (no synchronizing call), its
   values bit-equal to the sweep's. (e) A real OOM, in a process of its
   own (`--real-oom`, expandable segments): the evaluator's peak memory
   at B = 64 and 32 measured, the allocator capped halfway
   (`set_per_process_memory_fraction`), a full-width evaluator meets the
   card's `torch.cuda.OutOfMemoryError`, takes one rung and finishes at
   B = 32 with the B = 64 values. (f) The footprint model (bytes a
   coalition, a batch's fixed bytes) beside the peaks of (d)'s batch and
   of a batch of 8, within 2x of each, and the autotuned cap. No phase
   takes a CPU rung: every phase is gated on the CPU-degraded batch
   counter not moving.
21. width: the gradient-call width rule (models/zoo.py `grad_call_width`).
   On the MNIST CNN ([sweep]'s game) and the CIFAR10 CNN ([cifar10]'s
   training at 5 partners, cut to 1 epoch, whose 31 coalitions are swept
   here first), 8
   coalitions of the 5-partner sweep, every bucket's, requested on fresh
   engines 1, 2 and 3 at a time (batch widths 1, 2 and 4), then every
   coalition after a resume from a cache of the first 20 (the remaining
   11 train at their own widths): every v(S) bit-equal to the full
   sweep's;
22. devcost: device cost, fences, the value ledger and the audit. (a) The
   main path with MPLC_TORCH_NUMERICS_LEDGER set and fences at 1/16, K1's
   counts reset just before: the ledger holds the 1023 reconstructed
   values, bit-equal to [slice]'s, K1's launches and widths are [slice]'s,
   the device meter saw 1023 eval-only coalitions. (b) The 5-partner
   sweep's 31 coalitions on fresh engines at fence rate 1 and rate 0:
   v(S) bit-equal to each other and to [sweep]'s, every batch fenced (CUDA
   events) and FLOP-counted at rate 1, none fenced at 0, the meter billing
   on the "fenced" basis; each batch's fenced seconds beside its host
   span, `estimate_device_seconds`, and the sweep report's device_time,
   compute (mfu_xla on the counted FLOPs over the card's fp32 peak) and
   roofline rows printed. (c) The two sweeps' ledgers diffed: no drift,
   Kendall tau-b 1.0; the main path's fp32 ledger against [slice bf16]'s
   (written there): |dv(N)| and the median |dv| within BF16_VALUE_BOUND,
   as [precision]'s value pair, tau-b, the max |dv|, the coalitions past
   the bound and the worst eight printed (the JAX package's own bf16
   reconstruction parts from its fp32 past the bound too:
   tests/bf16_recon_witness.py). (d)
   Under MPLC_TORCH_NUMERICS_AUDIT=1 at fence rate 1, the grand coalition
   requested (a batch of one on 5 slots): its v(S) bit-equal to the
   audit-off request, one audit, replayed at that batch's [1, 5] shape,
   whose `torch.sum` parts from the left-to-right fold (first divergence
   and max ulp printed); under MPLC_TORCH_DETERMINISTIC_REDUCE=1 the
   audit finds no divergence (`ordered_fold`);
23. live: the live contributivity tier (mplc_tpu_torch/live/), with
   MPLC_TORCH_COMPILE_CACHE_DIR set to a temporary folder for the whole
   phase. (a) `LiveGame.from_recording` on the slice's scenario (bench
   config 8's shape, no journal), K1's counts reset after the recording:
   `query("exact")` launches K1 (K1-bf16 not) and its 1023 v(S) and
   scores are bit-equal to [slice]'s. (b) On a twin of that game (its own
   evaluator): GTG-Shapley (sv_accuracy 1.0, min_iter 16, perm_batch 8,
   truncation 0) fresh, then warm (no K1 launch, no engine batch, one memo
   hit, the same scores); an all-zero-weight round appended (the stamp
   and the memo kept); the 20 rounds cycled to 40 (K = 400) and a fresh
   query that launches K1 and sums to v(N) within 1e-6; rounds, fresh
   seconds, warm milliseconds, evaluations and K1's launches by width
   printed for both points; the doubled fresh query's time broken down
   into the host half of the stream swap, its upload and flatten onto the
   card, K1, the evaluation and the rest. (c) K1 on that K = 400 stream against its
   plain version, timed (the kernels line's `recon_matmul[live K=400]`,
   whose launches are (a)'s and (b)'s, the live main path's).
   (d) DPVS, each query on a fresh twin: tau 0 reconstructs the powerset
   and is bit-equal to [slice]'s exact v(S) and scores; a tau from the
   game's own info scores that prunes its lowest partner: fewer
   evaluations than 1023 and the pruned partners' scores exactly 0.
   (e) Bench config 10's shape on Titanic (5 partners, 6 rounds): 32
   journal-backed games under `residency.configure(8)`, 8 of them evicted,
   restored and queried exact, each bit-equal to a never-evicted game's
   answer (scores and every v(S)); a kill -> restart on one WAL and a WAL
   with a torn tail (quarantined to `.torn`) bit-equal too; restore
   p50/p99, evictions and restores printed; one WAL reopened on an engine
   built under MPLC_TORCH_PRECISION=bf16: K1-bf16 launches, K1 not, every
   coalition evaluated anew, |dv(N)| and the median |dv| within 0.05. (f)
   A 20-partner Titanic game: after a metered GTG query, `query("auto")`
   with a deadline of twice the grouped sweep's metered cost plans
   "hierarchical" on the "meter" basis, its scores summing to v(N) within
   1e-6. (g) The kernels built into the temporary folder under their
   digest names (a second build builds nothing); the bank's manifest lists
   (a)-(b)'s reconstruction programs with FLOPs; a meterless engine
   plans on "bank_cost_model"; with MPLC_TORCH_PROGRAM_BANK=0 a twin of
   (a)'s game gives (a)'s values bit for bit and records no program.

fp32 runs on the card are deterministic (`utils.resolve_device`): the
stages phase's recording of the grand coalition must be bit-equal to the
slice phase's, in every delta, weight and final parameter.

The line before the last two is `{"kernels": [...]}`; then the card's
`nvidia-smi` name and power limit; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import torch  # noqa: E402

from mplc_tpu_torch.contrib import bank  # noqa: E402
from mplc_tpu_torch.contrib.contributivity import Contributivity  # noqa: E402
from mplc_tpu_torch.contrib.engine import CharacteristicEngine  # noqa: E402
from mplc_tpu_torch.contrib.planner import estimate_eval_seconds, plan_query  # noqa: E402
from mplc_tpu_torch.contrib.reconstruct import (ReconstructionEvaluator,  # noqa: E402
                                                record_updates)
from mplc_tpu_torch.contrib.shapley import powerset_order  # noqa: E402
from mplc_tpu_torch import constants, faults  # noqa: E402
from mplc_tpu_torch.live import LiveGame, hierarchy, residency  # noqa: E402
from mplc_tpu_torch.data.datasets import (Dataset, load_cifar10, load_mnist,  # noqa: E402
                                          load_titanic, with_held_out_test)
from mplc_tpu_torch.obs import (analyze_trace, chrome_trace, devcost, flight,  # noqa: E402
                                metrics, numerics, report, trace)
from mplc_tpu_torch.mpl import dropout  # noqa: E402
from mplc_tpu_torch.mpl import approaches  # noqa: E402
from mplc_tpu_torch.mpl.engine import MplTrainer, upload  # noqa: E402
from mplc_tpu_torch.ops import cuda_build, recon_kernel  # noqa: E402
from mplc_tpu_torch.scenario import Scenario  # noqa: E402
from mplc_tpu_torch import utils  # noqa: E402
from mplc_tpu_torch.utils import profile_trace  # noqa: E402
from mplc_tpu_torch.main import main as cli_main  # noqa: E402

# Published peaks per card (NVIDIA data sheets, dense): fp32 outside the
# tensor cores, bf16 and TF32 on the tensor cores (FLOP/s), device-memory
# bandwidth (bytes/s).
PEAKS = {"H100 PCIe": {"fp32": 51e12, "bf16": 756e12, "tf32": 378e12, "bytes": 2.0e12},
         "H100 NVL": {"fp32": 60e12, "bf16": 835e12, "tf32": 417.5e12, "bytes": 3.9e12},
         "H100": {"fp32": 67e12, "bf16": 989e12, "tf32": 494.7e12, "bytes": 3.35e12}}

# Tolerance of each kernel against its plain version: the same fp32 sum in
# another association (the JAX package's kernel contract,
# tests/test_recon_kernel.py); bf16 x bf16 products are exact in fp32, so
# K1-bf16 is held to the same
RTOL, ATOL = 1e-4, 1e-5

# The JAX package's bf16 value bound (tests/test_precision.py): a bf16 v(S)
# stays within 0.05 of the fp32 one
BF16_VALUE_BOUND = 0.05

PARTNERS = 10
SCALE = 0.2     # synthetic MNIST: 12,000 train and 2,000 test samples
NOISE = 0.75    # bench.py's synthetic noise: accuracy must not saturate
DEVICE = "cuda"


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 5, calls: int = 10, warmup: int = 3) -> float:
    """Milliseconds per call of `fn`: the median over `runs` runs of `calls`
    back-to-back calls, CUDA events around each run (the host enqueues
    ahead of the card, so its per-call overhead hides as it does on the
    main path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def peaks_for(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise PhaseFailed(f"no published peaks for card {name!r}")


@contextlib.contextmanager
def knob(name: str, value: str):
    """Environment knob `name` set to `value` inside the block, restored
    after (the port reads its knobs when a config or an engine is built)."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def precision_env(mode: str):
    """MPLC_TORCH_PRECISION set to `mode` inside the block (the mode is
    frozen into each TrainConfig built inside)."""
    return knob(constants.PRECISION_ENV, mode)


def mnist_scenario(methods, partners: int = PARTNERS, approach: str = "fedavg",
                   **kw) -> Scenario:
    """bench.py config 1's settings (its approach fedavg unless `approach`
    says otherwise; 2 epochs unless `kw` says otherwise), partner i holding
    (i+1)/sum of the data (10 partners: (i+1)/55); a dry run, which writes
    no files."""
    total = sum(range(1, partners + 1))
    game = dict(aggregation_weighting="data-volume", epoch_count=2, minibatch_count=10,
                gradient_updates_per_pass_count=8, is_early_stopping=False, seed=0)
    game.update(kw)
    return Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                    dataset=load_mnist(scale=SCALE, noise=NOISE),
                    multi_partner_learning_approach=approach, methods=methods,
                    device=DEVICE, **game)


def main_path(precision: str = "fp32") -> tuple:
    """(scenario, GTG-Shapley, exact) of the main path under `precision`:
    `Scenario.run()` with GTG-Shapley, then the exact reconstruction over
    every coalition, synchronized."""
    with precision_env(precision):
        sc = mnist_scenario(["GTG-Shapley"])
        sc.run()
    exact = Contributivity(sc)
    exact.exact_reconstructed()
    torch.cuda.synchronize()
    return sc, sc.contributivity_list[0], exact


def phase_slice(precision: str = "fp32") -> dict:
    """The main path under `precision`, through the user entry points."""
    tag = "slice" if precision == "fp32" else f"slice {precision}"
    kernel = recon_kernel.KERNEL_BF16 if precision == "bf16" else recon_kernel.KERNEL
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    recon_kernel.launch_widths_bf16 = {}
    t0 = time.perf_counter()
    sc, gtg, exact = main_path(precision)
    wall = time.perf_counter() - t0
    launches = {recon_kernel.KERNEL: recon_kernel.launches,
                recon_kernel.KERNEL_BF16: recon_kernel.launches_bf16}
    widths = dict(sorted((recon_kernel.launch_widths_bf16 if precision == "bf16"
                          else recon_kernel.launch_widths).items()))

    recon = exact._reconstructor()
    values = np.array([recon.values[s] for s in powerset_order(PARTNERS)])
    v_all = recon.values[tuple(range(PARTNERS))]
    sv = exact.contributivity_scores
    print(f"[{tag}] mpl fit score {sc.mpl.history.score:.4f} in "
          f"{sc.mpl.learning_computation_time:.2f} s; v(N) {v_all:.4f}")
    print(f"[{tag}] GTG-Shapley {np.round(gtg.contributivity_scores, 4).tolist()} "
          f"({gtg.computation_time_sec:.2f} s, recording included)")
    print(f"[{tag}] exact (reconstructed) {np.round(sv, 4).tolist()} "
          f"({exact.computation_time_sec:.2f} s)")
    print(f"[{tag}] main path {wall:.2f} s; launches {json.dumps(launches)}; "
          f"{kernel} launches by batch width {json.dumps(widths)}; "
          f"{recon.reconstructions} coalitions reconstructed; recording "
          f"{json.dumps(recon.recorded.describe())}")
    check(recon.precision == precision,
          f"the evaluator runs {recon.precision}, not {precision}")
    check(launches[kernel] > 0, f"the main path never launched {kernel}")
    check(sum(launches.values()) == launches[kernel],
          f"the {precision} main path launched another kernel than {kernel}")
    check(bool(np.isfinite(values).all() and np.isfinite(sv).all()
               and np.isfinite(gtg.contributivity_scores).all()),
          "non-finite values or scores")
    check(len(values) == 2 ** PARTNERS - 1, "not every coalition was valued")
    check(v_all > 0.3, f"v(N) = {v_all} is not above three times chance")
    check(sv[PARTNERS - 1] > sv[0],
          f"partner {PARTNERS - 1} (largest) does not outscore partner 0")
    rec = recon.recorded
    check(all(t.dtype == torch.float32 for d in rec.deltas.values()
              for t in d.values()) and rec.weights.dtype == torch.float32,
          "the recorded stream is not float32")
    grand = recon_kernel.reconstruct_batch(
        torch.ones(1, PARTNERS, device=DEVICE), rec.init_params, rec.deltas,
        rec.weights, precision)
    err = max((grand[g][k][0].float() - rec.final_params[g][k]).abs().max().item()
              for g in grand for k in grand[g])
    scale = max(rec.final_params[g][k].abs().max().item()
                for g in grand for k in grand[g])
    # fp32: the same sum reassociated. bf16: the round weights and deltas
    # are rounded to bf16 (2^-9 relative each) and the leaves cast to bf16
    # (2^-9 relative), so allow 2^-7 of the largest parameter
    bound = 1e-4 if precision != "bf16" else 2.0 ** -7 * scale
    print(f"[{tag}] reconstructed grand coalition vs recorded final params: "
          f"max abs err {err:.3g} (bound {bound:.3g})")
    check(err <= bound, "reconstructed grand coalition differs from the "
                        "recording run's final params")
    return {"launches": launches[kernel], "widths": widths, "recon": recon,
            "values": values, "sv": sv, "gtg": gtg.contributivity_scores,
            "score": sc.mpl.history.score, "seconds": wall}


def titanic_recording(device: str, epochs: int, precision: str) -> tuple:
    """(evaluator, test-set size) of a Titanic 3-partner game recorded and
    valued on `device` under `precision`."""
    with precision_env(precision):
        sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(),
                      epoch_count=epochs, minibatch_count=2,
                      gradient_updates_per_pass_count=2,
                      is_early_stopping=False, seed=0, device=device)
        sc.instantiate_scenario_partners()
        sc.split_data()
        c = Contributivity(sc)
        c.exact_reconstructed()
    recon = c._reconstructor()
    check(recon.precision == precision,
          f"the Titanic evaluator runs {recon.precision}, not {precision}")
    return recon, len(sc.dataset.x_test)


def recording_diff(a, b) -> tuple[float, float]:
    """(final params max abs err, v(S) max diff) of two Titanic evaluators."""
    fa, fb = a.recorded.final_params, b.recorded.final_params
    err = max((fa[g][k].cpu() - fb[g][k].cpu()).abs().max().item()
              for g in fb for k in fb[g])
    dv = max(abs(a.values[s] - b.values[s]) for s in b.values)
    return err, dv


def phase_reference() -> None:
    """Titanic recording + reconstruction on the card and on the CPU."""
    (card, n_test), (cpu, _) = (titanic_recording(d, 2, "fp32") for d in (DEVICE, "cpu"))
    err, dv = recording_diff(card, cpu)
    print(f"[reference] titanic card vs cpu: final params max abs err {err:.3g}, "
          f"v(S) max diff {dv:.4f} (1/n_test {1 / n_test:.4f})")
    # float reassociation moves params by ~1e-6; one test sample at a
    # decision boundary may flip
    check(err <= 1e-4, "card and CPU recordings differ")
    check(dv <= 1.0 / n_test + 1e-6, "card and CPU v(S) differ by more than one sample")


# `mixed` on the card against `mixed` on the CPU: final params within this
# limit (measured 5.96e-08 on an H100 80GB HBM3 at 700 W), v(S) within one
# test sample. bf16 model compute moves the recorded deltas from fp32 by
# more than 1e-3 (tests/test_torch_precision.py), so a card run that
# computed in fp32 falls outside it: the phase checks that it does
MIXED_PARAM_LIMIT = 1e-5


def phase_reference_mixed() -> None:
    """The reference phase under `mixed`, at 4 epochs (at 2, bf16 leaves
    test samples on the decision boundary), with its control: the card
    forced to fp32 must fail the same comparison."""
    (card, n_test), (cpu, _), (card32, _) = (
        titanic_recording(d, 4, mode)
        for d, mode in ((DEVICE, "mixed"), ("cpu", "mixed"), (DEVICE, "fp32")))
    err, dv = recording_diff(card, cpu)
    err32, dv32 = recording_diff(card32, cpu)
    print(f"[precision] titanic mixed, card vs cpu: final params max abs err "
          f"{err:.3g}, v(S) max diff {dv:.4f} (1/n_test {1 / n_test:.4f}); "
          f"control, card fp32 vs cpu mixed: {err32:.3g}, {dv32:.4f}")
    check(err <= MIXED_PARAM_LIMIT, "mixed card and CPU recordings differ")
    check(dv <= 1.0 / n_test + 1e-6,
          "mixed card and CPU v(S) differ by more than one sample")
    check(err32 > MIXED_PARAM_LIMIT, "an fp32 card recording passes the mixed "
                                     "limit: it cannot tell bf16 compute from fp32")


# The MNIST CNN's bf16 logits on the card against the CPU's: at least this
# share bit-equal (both sides round the same values to bf16 at the same
# points; an fp32 logit is a bf16 value only by chance, about 2^-16;
# measured 0.558 on an H100 80GB HBM3 at 700 W, the fp32 control 0), and
# none farther apart than two bf16 ulps of the largest logit (a rounding
# that lands the other way in the last layer, plus one carried from the
# layers before; measured one)
MODEL_EQUAL_SHARE = 0.25
MODEL_ULPS = 2


def phase_model_bf16(recon, rows: int = 256) -> None:
    """The MNIST CNN's bf16 forward pass (cuDNN convolutions, cuBLAS
    matmuls) on the card against the same pass on the CPU, at the bf16
    main path's trained parameters, with its control: the card's fp32 pass
    must fall outside the limits."""
    engine = recon.engine
    params = recon.recorded.final_params
    x = torch.from_numpy(engine.scenario.dataset.x_test[:rows])
    cpu_params = {g: {k: t.cpu() for k, t in d.items()} for g, d in params.items()}
    with torch.no_grad():
        ref = engine.model.apply(cpu_params, x, torch.bfloat16)
        got = engine.model.apply(params, x.to(DEVICE), torch.bfloat16).cpu()
        got32 = engine.model.apply(params, x.to(DEVICE), torch.float32).cpu()
    top = ref.abs().max().item()
    limit = MODEL_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    err, err32 = ((g - ref).abs().max().item() for g in (got, got32))
    equal, equal32 = ((g == ref).double().mean().item() for g in (got, got32))
    print(f"[precision] {engine.model.name} bf16 logits, card vs cpu ({rows} rows, "
          f"max |logit| {top:.4g}): bit-equal share {equal:.4f} (at least "
          f"{MODEL_EQUAL_SHARE}), max abs err {err:.3g} (limit {limit:.3g}); "
          f"control, card fp32 vs cpu bf16: bit-equal share {equal32:.4f}, max "
          f"abs err {err32:.3g}")
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          "the card's bf16 logits are not finite float32")
    check(equal >= MODEL_EQUAL_SHARE and err <= limit,
          "the card's bf16 MNIST CNN logits differ from the CPU's")
    check(equal32 < MODEL_EQUAL_SHARE, "the card's fp32 logits pass the bf16 "
                                       "limit: it cannot tell bf16 compute from fp32")


def phase_stages(recon, tag: str = "stages") -> dict:
    """Fit, record, reconstruct and evaluate once more, each synchronized."""
    engine = recon.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.scenario.mpl.fit()          # warm: the first fit paid CUDA start-up
    fit_s = time.perf_counter() - t0   # fit() ends in a host read of the score
    t0 = time.perf_counter()
    again = record_updates(engine)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    check_same_recording(recon.recorded, again, tag)
    subsets = powerset_order(PARTNERS)
    width = 64
    masks_all = engine._coalition_arrays(subsets)
    rec_s = eval_s = 0.0
    for i in range(0, len(subsets), width):
        masks = torch.from_numpy(masks_all[i:i + width]).to(DEVICE)
        t0 = time.perf_counter()
        flat = recon.reconstruct(masks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            engine.trainer.evaluate_models(
                recon_kernel.unflatten(flat, recon._layout), engine.test)
        torch.cuda.synchronize()
        rec_s += t1 - t0
        eval_s += time.perf_counter() - t1
    stages = {"precision": recon.precision, "fit_s": fit_s, "record_s": record_s,
              "reconstruct_s": rec_s, "evaluate_s": eval_s,
              "coalitions": len(subsets), "width": width}
    print(f"[{tag}] " + json.dumps(stages))
    return stages


def check_same_recording(a, b, tag: str) -> None:
    """Two recordings of one seed on the card must be bit-equal: every
    delta, every weight and the final params (deterministic mode)."""
    pairs = [(a.weights, b.weights)] + [
        (x[g][k], y[g][k]) for x, y in ((a.deltas, b.deltas), (a.final_params, b.final_params))
        for g in x for k in x[g]]
    differ = sum(not torch.equal(x, y) for x, y in pairs)
    print(f"[{tag}] recording again, against the first: {len(pairs) - differ} of "
          f"{len(pairs)} tensors bit-equal (weights, deltas, final params)")
    check(differ == 0, "two recordings of one seed on the card differ")


def phase_value_pair(fp32_values: np.ndarray, bf16_values: np.ndarray) -> dict:
    """The bf16 main path's v(S) against the fp32 main path's, over the
    same 1023 coalitions."""
    diff = numerics.diff_values(fp32_values, bf16_values)
    dv = np.abs(bf16_values - fp32_values)
    grand = powerset_order(PARTNERS).index(tuple(range(PARTNERS)))
    pair = {"common": diff["common"], "kendall_tau_b": diff["kendall_tau"],
            "ulp": diff["ulp"], "histogram": diff["histogram"],
            "max_abs_dv": float(dv.max()), "median_abs_dv": float(np.median(dv)),
            "abs_dv_grand": float(dv[grand])}
    print("[precision] value pair bf16 vs fp32: " + json.dumps(pair))
    check(diff["common"] == 2 ** PARTNERS - 1, "the value pair does not cover every coalition")
    check(pair["abs_dv_grand"] <= BF16_VALUE_BOUND,
          f"|v_bf16(N) - v_fp32(N)| = {pair['abs_dv_grand']} exceeds the bf16 bound")
    check(pair["median_abs_dv"] <= BF16_VALUE_BOUND,
          f"median |dv| = {pair['median_abs_dv']} exceeds the bf16 bound")
    return pair


# per kernel: wrapper, plain version, source, how the card can at best do
# its operations (peak in PEAKS, operations per FLOP of the product), and
# the yardstick: one PyTorch call computing the same function (timed here
# only; the port never calls it). K1's fp32-accurate product at its least
# cost is 3xTF32 on the tensor cores: three TF32 products per product
KERNEL_TABLE = {
    recon_kernel.KERNEL: (
        recon_kernel.fused_contract, recon_kernel.fused_contract_reference,
        "mplc_tpu_torch/csrc/recon_matmul.cu", ("tf32", 3), "torch.addmm",
        lambda wn2, d2, init: torch.addmm(init.reshape(1, -1), wn2, d2)),
    recon_kernel.KERNEL_BF16: (
        recon_kernel.fused_contract_bf16, recon_kernel.fused_contract_bf16_reference,
        "mplc_tpu_torch/csrc/recon_matmul_bf16.cu", ("bf16", 1),
        "torch.addmm(out_dtype=float32)",
        lambda wn2, d2, init: torch.addmm(init.reshape(1, -1), wn2, d2,
                                          out_dtype=torch.float32)),
}


def kernel_entry(name: str, wn2, d2, init, launches, card, timed: bool = True) -> dict:
    """`name`'s kernel on these inputs against its plain version (rtol/atol,
    zero-weight rows bit-exact); with `timed`, its time, the plain
    version's, the library call's and the bound."""
    fn, plain, source, (peak, passes), label, library = KERNEL_TABLE[name]
    peaks = peaks_for(card)
    B, K = wn2.shape
    D = d2.shape[1]
    got = fn(wn2, d2, init)
    torch.cuda.synchronize()
    ref = plain(wn2, d2, init)
    err = (got - ref).abs().max().item()
    check(torch.allclose(got, ref, rtol=RTOL, atol=ATOL),
          f"{name} {(B, K, D)} disagrees with its plain version (max abs err {err})")
    zero = (wn2 == 0).all(dim=1)
    check(bool(zero.any()), "no zero-weight row in the kernel's inputs")
    check(torch.equal(got[zero], init.reshape(1, -1).expand(int(zero.sum()), -1)),
          "a zero-weight coalition does not return init bit-exactly")
    entry = {"name": name, "max_abs_err": err, "shape": {"B": B, "K": K, "D": D}}
    if not timed:
        return entry
    flops = 2 * B * K * D
    nbytes = (wn2.element_size() * B * K + d2.element_size() * K * D
              + init.element_size() * D + got.element_size() * B * D)
    t_ops = passes * flops / peaks[peak] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    ms = cuda_ms(lambda: fn(wn2, d2, init))
    return {
        **entry, "route": "cuda", "source": source,
        "replaces": "mplc_tpu/ops/recon_kernel.py:130",
        "launches": launches, "ms": ms, "kernel_ms": ms,
        "plain_ms": cuda_ms(lambda: plain(wn2, d2, init)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: library(wn2, d2, init)), "library": label,
        "flops": flops, "bytes": nbytes,
    }


def odd_inputs(name: str, D: int = 22):
    """B=5, K=12 and D (ragged on every axis), row 0 of weight zero."""
    g = np.random.default_rng(D)
    odd_wn = g.random((5, 12)).astype(np.float32)
    odd_wn[0] = 0.0
    wn2, d2, init = (torch.from_numpy(a).to(DEVICE) for a in (
        odd_wn, g.standard_normal((12, D)).astype(np.float32),
        g.standard_normal(D).astype(np.float32)))
    if name == recon_kernel.KERNEL_BF16:
        wn2, d2 = wn2.to(torch.bfloat16), d2.to(torch.bfloat16)
    return wn2, d2, init


def normal_check(name: str, B: int, K: int, D: int) -> None:
    """`name`'s kernel on standard-normal inputs at the main path's depth
    and width, beside the exact (float64) sum and the plain version.

    K1 (uniform weights) is held against the exact sum: no farther from it
    than the plain fp32 product is (or ATOL, where that one is nearly
    exact). The main path's own inputs (round weights summing to 1, deltas
    near 1e-3) would pass one TF32 product, or MMAs chained over all of K,
    within the tolerance; these inputs do not (tests/test_torch_recon_kernel.py
    emulates both). Against the plain version at rtol/atol these inputs
    sit at the tolerance's edge, through the plain version's own error, so
    that reading is printed, not gated.

    K1-bf16 (standard-normal weights and deltas in bf16; its products are
    exact in fp32) is held against the plain version at rtol/atol; its
    distance from the exact sum is printed beside the plain version's."""
    bf16 = name == recon_kernel.KERNEL_BF16
    fn, plain = KERNEL_TABLE[name][:2]
    gen = torch.Generator(device=DEVICE).manual_seed(B)
    wn2 = (torch.randn if bf16 else torch.rand)(B, K, device=DEVICE, generator=gen)
    wn2[0] = 0.0
    d2 = torch.randn(K, D, device=DEVICE, generator=gen)
    init = torch.randn(D, device=DEVICE, generator=gen)
    if bf16:
        wn2, d2 = wn2.to(torch.bfloat16), d2.to(torch.bfloat16)
    got = fn(wn2, d2, init)
    ref = plain(wn2, d2, init)
    exact = torch.addmm(init.double().reshape(1, -1), wn2.double(), d2.double())
    err, err_plain = ((t.double() - exact).abs().max().item() for t in (got, ref))
    worst = ((got - ref).abs() / (ATOL + RTOL * ref.abs())).max().item()
    print(f"[kernels] {name} standard normal {(B, K, D)}: max abs err "
          f"from the exact sum {err:.3g} (plain version {err_plain:.3g}); against "
          f"the plain version {worst:.3f} of the tolerance")
    if bf16:
        check(torch.allclose(got, ref, rtol=RTOL, atol=ATOL),
              f"{name} {(B, K, D)} disagrees with its plain version")
    else:
        check(err <= max(err_plain, ATOL),
              f"{name} {(B, K, D)} is farther from the exact sum than the plain "
              f"version")
    check(torch.equal(got[0], init), "a zero-weight coalition does not return init "
                                     "bit-exactly")


def phase_kernels(sl, card) -> list:
    """The kernel of the slice's precision on the main path's own inputs:
    the recorded stream and batches of 64, 32 and 16 coalitions (the first
    63, 31 or 15 of the powerset and the empty coalition, whose weights are
    all zero), one for each coalition tile (16 is the width of GTG's
    wavefront). Then odd shapes (B=5, K=12, D=22 and 23: the kernels'
    narrow routes), and each width on standard-normal inputs."""
    recon = sl["recon"]
    name = (recon_kernel.KERNEL_BF16 if recon.precision == "bf16"
            else recon_kernel.KERNEL)
    widths = (64, 32, 16)
    entries = []
    for B in widths:
        subsets = powerset_order(PARTNERS)[:B - 1] + [()]
        masks = torch.from_numpy(recon.engine._coalition_arrays(subsets)).to(DEVICE)
        wn = recon_kernel.normalized_round_weights(masks, recon._weights)
        sums = wn.sum(-1)
        denom = (recon._weights[None] * masks[:, None]).sum(-1)
        check(bool((wn[denom == 0] == 0).all()),
              "WN rows with zero denominator are not exact zeros")
        check(torch.allclose(sums[denom > 0], torch.ones_like(sums[denom > 0]), rtol=1e-6),
              "WN rows do not sum to 1")
        wn2 = wn.reshape(B, -1).to(recon._d2.dtype).contiguous()
        # the 64-wide entry carries all the kernel's launches, a narrower
        # one those of batches up to its width
        launches = (sl["launches"] if B == 64 else
                    sum(n for w, n in sl["widths"].items() if w <= B))
        entry = kernel_entry(name, wn2, recon._d2, recon._init, launches, card)
        if B != 64:
            entry["name"] = f"{name}[B={B}]"
        entry["launch_widths"] = sl["widths"]
        entries.append(entry)
    for D in (22, 23):
        odd = kernel_entry(name, *odd_inputs(name, D), 0, card, timed=False)
        print(f"[kernels] {name} odd shape {odd['shape']}: max abs err "
              f"{odd['max_abs_err']:.3g}")
    for e in entries:
        print(f"[kernels] {e['name']} {e['shape']}: {e['ms']:.4f} ms "
              f"(plain {e['plain_ms']:.4f}, {e['library']} {e['library_ms']:.4f}, "
              f"bound {e['bound_ms']:.4f} by {e['bound_by']}), "
              f"{e['launches']} launches")
    for B in widths:
        normal_check(name, B, *recon._d2.shape)
    return entries


def phase_precision(fp32_values: np.ndarray, card, ledger: str) -> list:
    """The bf16 main path (its engine writing the value ledger `ledger`,
    which [devcost] (c) diffs against the fp32 one), its value pair against
    fp32, Titanic under mixed and the MNIST CNN's bf16 forward pass on the
    card against the CPU, the bf16 stages and K1-bf16's entry."""
    with knob(constants.NUMERICS_LEDGER_ENV, ledger):
        sl = phase_slice("bf16")
    phase_value_pair(fp32_values, sl["values"])
    phase_reference_mixed()
    phase_model_bf16(sl["recon"])
    phase_stages(sl["recon"], tag="stages bf16")
    return phase_kernels(sl, card)


# The sweep phase: bench config 1's training at 5 partners, cut from its
# 10 (see phase_sweep)
SWEEP_PARTNERS = 5
SWEEP_METHODS = ["Shapley values", "Independent scores"]


def batch_lines(tag: str, eng) -> None:
    for b in eng.batch_log:
        slots = "masked" if b["slot_count"] is None else f"{b['slot_count']} slots"
        if b["kind"] == "single":
            slots = "single"
        print(f"[{tag}] batch {slots}, width {b['width']}: {b['coalitions']} "
              f"coalitions in {b['seconds']:.3f} s "
              f"({b['seconds'] / b['coalitions']:.3f} s a coalition)")


def phase_sweep() -> dict:
    """The retraining exact-Shapley sweep through the user entry point:
    the MNIST CNN at full width on the slice's data, bench config 1's
    training, 5 partners split (i+1)/15. 31 coalitions are retrained: the
    5 singles in one batch (width 8), then the others on merged slot
    buckets: sizes 2 and 3 at 3 slots (20 coalitions, batches of 16 and
    4 in a width of 16), sizes 4 and 5 at 5 slots (6 coalitions, width 8).
    "Independent scores" then reads the singles' memoized values.

    Cut from bench config 1's 10 partners for the script's time; the
    slots phase runs part of the 10-partner sweep."""
    P = SWEEP_PARTNERS
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # collected for the obs phase (d); the registry starts empty, so its
    # memory high water is this run's
    metrics.reset()
    t0 = time.perf_counter()
    with trace.collect() as records:
        sc = mnist_scenario(SWEEP_METHODS, P)
        sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    snapshot = metrics.snapshot()
    sv_c, ind_c = sc.contributivity_list
    eng = sc._charac_engine
    subsets = powerset_order(P)
    values = np.array([eng.charac_fct_values[s] for s in subsets])
    v_all = eng.charac_fct_values[tuple(range(P))]
    sv, ind = sv_c.contributivity_scores, ind_c.contributivity_scores
    batches = [(b["kind"], b["width"], b["slot_count"], b["coalitions"])
               for b in eng.batch_log]
    sweep_s = sum(b["seconds"] for b in eng.batch_log)
    print(f"[sweep] MNIST CNN, {P} partners, {len(subsets)} coalitions retrained "
          f"({sc.slot_bucketing} slot buckets): {wall:.2f} s for Scenario.run() "
          f"(fit {sc.mpl.learning_computation_time:.2f} s, Shapley "
          f"{sv_c.computation_time_sec:.2f} s, independent "
          f"{ind_c.computation_time_sec:.4f} s; batches {sweep_s:.2f} s, against 9.86-10.01 s "
          f"masked on an H100 80GB HBM3 at 700 W); peak memory {peak / 2 ** 30:.2f} GiB "
          f"({(peak - base) / 2 ** 30:.2f} GiB above the phase's start)")
    batch_lines("sweep", eng)
    print("[sweep] v(S) " + json.dumps(
        {",".join(map(str, s)): round(float(v), 4) for s, v in zip(subsets, values)}))
    print(f"[sweep] Shapley values {np.round(sv, 4).tolist()} (sum {sv.sum():.6f}, "
          f"v(N) {v_all:.4f}); independent scores {np.round(ind, 4).tolist()}; "
          f"launches {recon_kernel.launches} / {recon_kernel.launches_bf16}")
    check(bool(np.isfinite(values).all() and (values >= 0).all() and (values <= 1).all()),
          "a v(S) of the sweep is not finite in [0, 1]")
    check(v_all > 0.3, f"v(N) = {v_all} is not above three times chance")
    check(sv[P - 1] > sv[0], f"partner {P - 1} (largest) does not outscore partner 0")
    check(abs(sv.sum() - v_all) <= 1e-6, "the Shapley values do not sum to v(N)")
    check(list(ind) == [eng.charac_fct_values[(i,)] for i in range(P)],
          "the independent scores are not the singles' values")
    check(sc.slot_bucketing == "merge", f"the sweep ran {sc.slot_bucketing}, not merge")
    check(batches == [("single", 8, None, 5), ("multi", 16, 3, 16), ("multi", 16, 3, 4),
                      ("multi", 8, 5, 6)],
          f"the sweep trained other batches than its 31 coalitions need: {batches}")
    check(recon_kernel.launches == recon_kernel.launches_bf16 == 0,
          "the retraining sweep launched a reconstruction kernel")
    return {"scenario": sc, "sv": sv, "records": records, "metrics": snapshot,
            "peak": peak, "seconds": wall}


# The slots phase: bench config 1's 10 partners; the masked reference
# trains the first MASKED_PAIRS pairs, one batch
MASKED_PAIRS = 16


def width_seconds(eng) -> dict:
    """{slot count or "masked": seconds a coalition} over the engine's
    multi-partner batches."""
    out = {}
    for b in eng.batch_log:
        key = "masked" if b["slot_count"] is None else str(b["slot_count"])
        s, n = out.get(key, (0.0, 0))
        out[key] = (s + b["seconds"], n + b["coalitions"])
    return {k: s / n for k, (s, n) in out.items()}


def phase_slots() -> None:
    """The MNIST CNN at full width on the slice's data, bench config 1's
    10 partners split (i+1)/55 and its training, no fit: the 45 pairs
    (3 slots, merged with nothing at this width: three batches of 16) and
    the 10 nine-partner coalitions (9 slots, one batch) on slots, then the
    first 16 pairs masked over all 10 partners. Each pair must agree
    within one test sample and rank alike (Kendall tau-b 1.0)."""
    sc = mnist_scenario([], PARTNERS)
    sc.instantiate_scenario_partners()
    sc.split_data()
    eng = CharacteristicEngine(sc)
    pairs = [s for s in powerset_order(PARTNERS) if len(s) == 2]
    nines = [s for s in powerset_order(PARTNERS) if len(s) == PARTNERS - 1]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    values = eng.evaluate(pairs + nines)
    slot_s = time.perf_counter() - t0
    slot_peak = torch.cuda.max_memory_allocated()
    with knob(constants.NO_SLOTS_ENV, "1"):
        masked_eng = CharacteristicEngine(sc)
    torch.cuda.reset_peak_memory_stats()
    ref = masked_eng.evaluate(pairs[:MASKED_PAIRS])
    masked_peak = torch.cuda.max_memory_allocated()
    got = values[:MASKED_PAIRS]
    n_test = len(sc.dataset.x_test)
    same = sum(numerics.float_bits(a) == numerics.float_bits(b) for a, b in zip(got, ref))
    tau = numerics.diff_values(got, ref)["kendall_tau"]
    dv = float(np.abs(got - ref).max())
    print(f"[slots] MNIST CNN, {PARTNERS} partners: {len(pairs)} pairs and {len(nines)} "
          f"nine-partner coalitions on slots in {slot_s:.2f} s; seconds a coalition "
          f"{json.dumps(width_seconds(eng))} on slots, "
          f"{json.dumps(width_seconds(masked_eng))} masked; peak memory above the "
          f"phase's start {(slot_peak - base) / 2 ** 30:.2f} GiB on slots, "
          f"{(masked_peak - base) / 2 ** 30:.2f} GiB masked")
    batch_lines("slots", eng)
    batch_lines("slots", masked_eng)
    print(f"[slots] first {MASKED_PAIRS} pairs, slots vs masked: {same} of "
          f"{MASKED_PAIRS} v(S) bit-equal, max diff {dv:.4f} (1/n_test "
          f"{1 / n_test:.4f}), Kendall tau-b {tau}; v(S) on slots "
          f"{np.round(got, 4).tolist()}; nine-partner v(S) "
          f"{np.round(values[len(pairs):], 4).tolist()}")
    check(bool(np.isfinite(values).all() and (values >= 0).all() and (values <= 1).all()),
          "a v(S) on slots is not finite in [0, 1]")
    check([(b["slot_count"], b["coalitions"]) for b in eng.batch_log]
          == [(3, 16), (3, 16), (3, 13), (9, 10)],
          f"the slot run trained other batches than planned: {eng.batch_log}")
    check(dv <= 1.0 / n_test + 1e-6, "slot and masked v(S) differ by more than one sample")
    check(tau == 1.0, f"slot and masked v(S) rank differently (tau-b {tau})")


def phase_deterministic_reduce() -> None:
    """Under MPLC_TORCH_DETERMINISTIC_REDUCE=1 (which routes the engine's
    sweeps masked) the four multi-partner coalitions of a Titanic 3-partner
    game, one batch, through the slot trainer (3 slots) and the masked
    trainer on the card: parameters within 1e-6, v(S) within one test
    sample. Bit-equality is gated on the CPU only (tests/test_torch_slots.py):
    cuDNN and cuBLAS may choose other algorithms at other vmap widths."""
    with knob(constants.DETERMINISTIC_REDUCE_ENV, "1"):
        sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(),
                      epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2,
                      is_early_stopping=False, seed=0, device=DEVICE)
        sc.instantiate_scenario_partners()
        sc.split_data()
        eng = CharacteristicEngine(sc)
    check(eng._multi_cfg.deterministic_reduce and sc.slot_bucketing == "masked",
          "the deterministic reduce did not route the engine masked")
    subsets = [s for s in powerset_order(3) if len(s) > 1]
    results = []
    for slots in (None, 3):
        tr = MplTrainer(eng.model, dataclasses.replace(eng._multi_cfg, slot_count=slots))
        gens = [eng.coalition_generator(s) for s in subsets]
        state = tr.init_state(gens, 3, DEVICE)
        coal = torch.from_numpy(eng._coalition_arrays(subsets, slots)).to(DEVICE)
        tr.epoch_chunk(state, eng.stacked, eng.val, coal, gens, tr.cfg.epoch_count)
        results.append((state.params, tr.finalize(state, eng.test)[1].cpu().numpy()))
    (pm, vm), (ps, vs) = results
    pairs = [(pm[g][k], ps[g][k]) for g in pm for k in pm[g]]
    err = max((a - b).abs().max().item() for a, b in pairs)
    same = sum(torch.equal(a, b) for a, b in pairs)
    dv = float(np.abs(vm - vs).max())
    n_test = len(sc.dataset.x_test)
    print(f"[slots] titanic, deterministic reduce, slots vs masked on the card: "
          f"{same} of {len(pairs)} parameter tensors bit-equal, max abs err {err:.3g}; "
          f"v(S) max diff {dv:.4f} (1/n_test {1 / n_test:.4f})")
    check(err <= 1e-6, "slot and masked parameters differ by more than 1e-6")
    check(dv <= 1.0 / n_test + 1e-6, "slot and masked v(S) differ by more than one sample")


def phase_cache(sweep: dict) -> None:
    """The sweep's cache saved; a fresh 5-partner scenario resumed from it
    must train no batch, restore the call count and give the same Shapley
    values bit for bit; the file with one byte flipped must be quarantined
    by the next resume, which starts cold (its independent scores train
    the singles again)."""
    eng = sweep["scenario"]._charac_engine
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "coalition_cache.json"
        t0 = time.perf_counter()
        eng.save_cache(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc = mnist_scenario(SWEEP_METHODS, SWEEP_PARTNERS, contributivity_cache_from=path)
        sc.run()
        resume_s = time.perf_counter() - t0
        again = sc._charac_engine
        sv = sc.contributivity_list[0].contributivity_scores
        same = [numerics.float_bits(a) == numerics.float_bits(b)
                for a, b in zip(sv, sweep["sv"])]
        print(f"[cache] saved {len(eng.charac_fct_values)} values ({path.stat().st_size} "
              f"bytes) in {save_s:.4f} s; resumed Scenario.run() {resume_s:.2f} s, "
              f"{len(again.batch_log)} batches trained, call count "
              f"{again.first_charac_fct_calls_count}, {sum(same)} of {len(same)} "
              f"Shapley values bit-equal")
        check(again.batch_log == [], "the resumed sweep trained coalitions")
        check(again.first_charac_fct_calls_count == eng.first_charac_fct_calls_count,
              "the resumed call count differs")
        check(all(same), "the resumed Shapley values differ from the sweep's")

        raw = bytearray(path.read_bytes())
        i = raw.index(b".", raw.index(b'"charac_fct_values"')) + 1
        raw[i] = ord("7") if raw[i] != ord("7") else ord("3")
        path.write_bytes(bytes(raw))
        cold = mnist_scenario(["Independent scores"], SWEEP_PARTNERS,
                              contributivity_cache_from=path)
        cold.run()
        quarantined = path.with_name(path.name + ".corrupt")
        log = [(b["kind"], b["coalitions"]) for b in cold._charac_engine.batch_log]
        print(f"[cache] one byte flipped: quarantined {quarantined.exists()}, original "
              f"left {path.exists()}; the cold resume trained {log}")
        check(quarantined.exists() and not path.exists(), "the corrupt cache was not "
                                                           "quarantined")
        check(log == [("single", SWEEP_PARTNERS)], "the resume did not start cold")


# The JAX package's value bound (tests/test_precision.py), which the
# sampled estimators are held to against exact Shapley values
ESTIMATE_BOUND = 0.05


def phase_svarm(sl) -> dict:
    """SVARM over the slice's fp32 recording (10 partners, the MNIST CNN at
    full width) through a fresh ReconstructionEvaluator, its K1 launches
    counted from 0; then "auto" twice on the slice's own evaluator."""
    recon = sl["recon"]
    eng = recon.engine
    sc = eng.scenario
    t0 = time.perf_counter()
    eng._reconstruction = ReconstructionEvaluator(eng, recon.recorded)
    torch.cuda.synchronize()
    flatten_s = time.perf_counter() - t0
    try:
        recon_kernel.launches = recon_kernel.launches_bf16 = 0
        recon_kernel.launch_widths = {}
        t0 = time.perf_counter()
        c = Contributivity(sc)
        c.compute_contributivity("SVARM")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {recon_kernel.KERNEL: recon_kernel.launches,
                    recon_kernel.KERNEL_BF16: recon_kernel.launches_bf16}
        widths = dict(sorted(recon_kernel.launch_widths.items()))
        fresh = eng._reconstruction
    finally:
        eng._reconstruction = recon
    sv, std, exact = c.contributivity_scores, c.scores_std, sl["sv"]
    err = float(np.abs(sv - exact).max())
    budget = max(4 * PARTNERS ** 2, 128)
    print(f"[svarm] MNIST CNN, {PARTNERS} partners, default budget {budget}: "
          f"{wall:.2f} s ({c.computation_time_sec:.2f} s in SVARM; the fresh evaluator "
          f"flattened the stream before it in {flatten_s:.2f} s); {fresh.reconstructions} "
          f"coalitions reconstructed; "
          f"launches {json.dumps(launches)}; {recon_kernel.KERNEL} launches by batch width "
          f"{json.dumps(widths)}")
    print(f"[svarm] values {np.round(sv, 4).tolist()}; std {np.round(std, 4).tolist()}; "
          f"max abs err against the slice's exact reconstructed values {err:.4f} (bound "
          f"{ESTIMATE_BOUND})")
    print("[svarm] trust " + json.dumps(c.trust))
    check(launches[recon_kernel.KERNEL] > 0, "SVARM never launched K1")
    check(launches[recon_kernel.KERNEL_BF16] == 0, "the fp32 SVARM launched K1-bf16")
    check(bool(np.isfinite(sv).all() and np.isfinite(std).all()), "non-finite SVARM values")
    check(err <= ESTIMATE_BOUND, f"SVARM is {err} from the exact values")
    check(c.trust is not None and c.trust["source"] == "mc_blocks"
          and c.trust["method"] == "SVARM" and len(c.trust["mean"]) == PARTNERS,
          "SVARM left no trust row")
    check(fresh.reconstructions <= 2 ** PARTNERS - 1, "SVARM reconstructed a coalition twice")

    loose = Contributivity(sc)
    loose.compute_contributivity("auto")
    print("[svarm] auto, no deadline: " + json.dumps(loose.plan.describe()))
    same = [numerics.float_bits(a) == numerics.float_bits(b)
            for a, b in zip(loose.contributivity_scores, exact)]
    print(f"[svarm] auto, no deadline: {sum(same)} of {len(same)} values bit-equal to the "
          f"slice's exact values")
    check(loose.plan.method == "exact", f"auto planned {loose.plan.method}, not exact")
    check(all(same), "auto's exact values differ from the slice's")
    # the planner's "meter" basis: the slice's evaluations metered on its
    # engine (eval-only seconds a coalition); "auto" under a 20 s deadline
    # plans on it
    eng = sc._charac_engine
    eval_sec, basis = estimate_eval_seconds(eng)
    metered = Contributivity(sc)
    metered.compute_contributivity("auto", deadline_sec=20)
    print(f"[svarm] auto, deadline 20 s, on the meter's {eval_sec:.6f} s a coalition "
          f"[{basis}]: " + json.dumps(metered.plan.describe()))
    check(basis == "meter" and metered.plan.cost_basis == "meter"
          and metered.plan.est_eval_sec == eval_sec
          and metered.plan.describe() == plan_query(PARTNERS, None, 20, eval_sec=eval_sec,
                                                    cost_basis="meter").describe(),
          f"auto on the meter planned {metered.plan.describe()}")
    # with no evaluation metered the planner takes its default constant
    meter, eng.device_meter = eng.device_meter, devcost.DeviceMeter(eng._fence_interval)
    try:
        tight = Contributivity(sc)
        tight.compute_contributivity("auto", deadline_sec=20)
    finally:
        eng.device_meter = meter
    terr = float(np.abs(tight.contributivity_scores - exact).max())
    print("[svarm] auto, deadline 20 s: " + json.dumps(tight.plan.describe()))
    print(f"[svarm] auto, deadline 20 s: values "
          f"{np.round(tight.contributivity_scores, 4).tolist()}, max abs err against exact "
          f"{terr:.4f}")
    check(tight.plan.method == "SVARM" and tight.plan.method_kw == {"budget": 300}
          and tight.plan.est_eval_sec == 0.05,
          f"auto with a 20 s deadline planned {tight.plan.describe()}")
    check(tight.name == "SVARM" and bool(np.isfinite(tight.contributivity_scores).all()),
          "auto with a 20 s deadline did not run SVARM")
    return {"launches": launches[recon_kernel.KERNEL], "widths": widths}


# The estimators phase, in this order: TMCS starts cold, the exact sweep
# comes last as the reference
ESTIMATOR_METHODS = ["TMCS", "ITMCS", "IS_lin_S", "IS_reg_S", "AIS_Kriging_S", "SMCS",
                     "WR_SMC", "Shapley values"]


class TableEngine(CharacteristicEngine):
    """The engine's own `evaluate` (memo, deduplication, singles and then
    merged slot buckets, in that order) over a v(S) table instead of
    training: the estimators run again over a finished run's values."""

    def __init__(self, table: dict, partners: int):
        self.partners_count = partners
        self.table = table
        self.charac_fct_values = {(): 0.0}
        self.increments_values = [dict() for _ in range(partners)]
        self.first_charac_fct_calls_count = 0
        self.batch_log = []
        self.single_pipe = self.multi_pipe = None
        self._use_slots, self._slot_merge, self._slot_pow2 = True, True, False
        self._cache_needs_upgrade = False
        self.autosave_path = None

    def _slot_pipe(self, k):
        return None

    def _run_batch(self, subsets, pipe, slot_count=None):
        for s in subsets:
            self._store(s, self.table[s])
        self.batch_log.append({"coalitions": len(subsets)})


def replay_estimators(sc) -> list:
    """[(scores, std, call count after the method)] of the scenario's
    methods run again, in order, over its engine's v(S) table."""
    eng = sc._charac_engine
    again = TableEngine(dict(eng.charac_fct_values), eng.partners_count)
    shadow = types.SimpleNamespace(partners_list=sc.partners_list, seed=sc.seed,
                                   _charac_engine=again)
    out = []
    for method in sc.methods:
        c = Contributivity(shadow)
        c.compute_contributivity(method)
        out.append((c.contributivity_scores, c.scores_std, again.first_charac_fct_calls_count))
    return out


def phase_estimators(sweep: dict) -> None:
    """The retraining estimators through `Scenario.run()`: the sweep's data,
    model (full width) and training at its 5 partners, cut from bench
    config 3's 10 for the script's time."""
    P = SWEEP_PARTNERS
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    t0 = time.perf_counter()
    sc = mnist_scenario(ESTIMATOR_METHODS, P)
    sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = sc._charac_engine
    exact = sc.contributivity_list[-1].contributivity_scores
    print(f"[estimators] MNIST CNN, {P} partners, {len(ESTIMATOR_METHODS)} methods: "
          f"{wall:.2f} s for Scenario.run() (fit {sc.mpl.learning_computation_time:.2f} s); "
          f"{len(eng.batch_log)} batches, {eng.first_charac_fct_calls_count} coalitions "
          f"trained in {sum(b['seconds'] for b in eng.batch_log):.2f} s")
    counts = []
    calls = 0
    for method, c in zip(ESTIMATOR_METHODS, sc.contributivity_list):
        trained = c.batches_trained
        calls += sum(b["coalitions"] for b in trained)
        counts.append(calls)
        err = float(np.abs(c.contributivity_scores - exact).max())
        shapes = [(b["kind"], b["slot_count"], b["width"], b["coalitions"],
                   round(b["seconds"], 3)) for b in trained]
        print(f"[estimators] {method} ({c.name}): {c.computation_time_sec:.2f} s; "
              f"{len(trained)} batches trained (kind, slots, width, coalitions, s) "
              f"{shapes}; call count {calls}; values "
              f"{np.round(c.contributivity_scores, 4).tolist()}; std "
              f"{np.round(c.scores_std, 4).tolist()}; max abs err against exact {err:.4f}")
        check(bool(np.isfinite(c.contributivity_scores).all()), f"{method}: non-finite values")
        check(err <= ESTIMATE_BOUND, f"{method} is {err} from the exact Shapley values")
    check(calls == eng.first_charac_fct_calls_count <= 2 ** P - 1
          and len(eng.charac_fct_values) == 2 ** P,
          f"a coalition was trained twice: {calls} calls for {2 ** P - 1} coalitions")
    replay = replay_estimators(sc)
    print(f"[estimators] call counts by method {counts}; run again over the v(S) table "
          f"{[r[2] for r in replay]}")
    check([r[2] for r in replay] == counts, "the call counts differ when the estimators "
                                            "run again over the same v(S)")
    check(all(numerics.float_bits(a) == numerics.float_bits(b)
              for r, c in zip(replay, sc.contributivity_list)
              for a, b in zip(r[0], c.contributivity_scores)),
          "the scores differ when the estimators run again over the same v(S)")
    check(recon_kernel.launches == recon_kernel.launches_bf16 == 0,
          "the retraining estimators launched a reconstruction kernel")
    ref = sweep["scenario"]._charac_engine.charac_fct_values
    subsets = powerset_order(P)
    pairs = {",".join(map(str, s)): [round(eng.charac_fct_values[s], 4), round(ref[s], 4)]
             for s in subsets}
    dv = max(abs(eng.charac_fct_values[s] - ref[s]) for s in subsets)
    same = sum(numerics.float_bits(eng.charac_fct_values[s]) == numerics.float_bits(ref[s])
               for s in subsets)
    print(f"[estimators] v(S) here (the estimators' request widths), [sweep]'s: {same} of "
          f"{len(subsets)} bit-equal, max diff {dv:.4f}; " + json.dumps(pairs))
    check(same == len(subsets), "the estimators' v(S) part from [sweep]'s: a value depends "
                                "on the width of the request that trained it")


def titanic_sweep(device: str) -> tuple:
    """(v(S) over the powerset, the scenario, test-set size) of the
    Titanic 3-partner retraining sweep (fp32) on `device`."""
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=load_titanic(), epoch_count=2,
                  minibatch_count=2, gradient_updates_per_pass_count=2,
                  is_early_stopping=False, methods=["Shapley values"], seed=0,
                  device=device)
    sc.run()
    values = np.array([sc._charac_engine.charac_fct_values[s] for s in powerset_order(3)])
    return values, sc, len(sc.dataset.x_test)


def phase_sweep_reference() -> None:
    """The Titanic sweep twice on the card, which must be bit-equal (and
    so must the two grand-coalition fits), and on the CPU, which the
    card's must match within one test sample."""
    (a, sca, n_test), (b, scb, _), (c, _, _) = (
        titanic_sweep(d) for d in (DEVICE, DEVICE, "cpu"))
    same = [numerics.float_bits(x) == numerics.float_bits(y) for x, y in zip(a, b)]
    fa, fb = sca.mpl.model_params, scb.mpl.model_params
    same_fit = all(torch.equal(fa[g][k], fb[g][k]) for g in fa for k in fa[g])
    dv = float(np.abs(a - c).max())
    print(f"[sweep] titanic card twice: {sum(same)} of {len(same)} v(S) bit-equal, "
          f"fit params bit-equal {same_fit}; card vs cpu: v(S) max diff {dv:.4f} "
          f"(1/n_test {1 / n_test:.4f}); v(S) {np.round(a, 4).tolist()}")
    check(all(same) and same_fit, "two Titanic sweeps of one seed on the card differ")
    check(dv <= 1.0 / n_test + 1e-6, "card and CPU sweeps differ by more than one sample")


# The variants phase: the methods that read the grand coalition's training
VARIANT_METHODS = ["Federated SBS linear", "Federated SBS quadratic",
                   "Federated SBS constant", "PVRL", "LFlip"]


def sbs_numpy(history) -> dict:
    """The three step-by-step scores recomputed from a History's val
    accuracies: each partner's over the collective model's per round, 10%
    of the rounds skipped at each end, weighted 1, r or r^2."""
    coll = history["mpl_model"]["val_accuracy"].reshape(-1)
    rel = np.stack([history[k]["val_accuracy"].reshape(-1) / coll
                    for k in history if k != "mpl_model"], axis=1)
    rounds = len(coll)
    rel = rel[int(np.round(rounds * 0.1)):int(np.round(rounds * 0.9))]
    r = np.arange(len(rel), dtype=float)
    return {"Federated step by step linear scores": r @ np.nan_to_num(rel),
            "Federated step by step quadratic scores": (r * r) @ np.nan_to_num(rel),
            "Federated step by step constant scores": np.nanmean(rel, axis=0)}


def params_against(a: dict, b: dict, steps: int) -> tuple[float, float]:
    """(max abs difference, share of the weights farther apart than 1e-4)
    of two parameter dicts of runs whose gradients differ by rounding.
    Adam normalises each weight's step by its own gradient, so a weight
    whose gradient is near zero moves by up to one learning rate (1e-3) a
    step on such a difference: gated on that bound; how many weights move
    so depends on the data (the share is printed)."""
    diffs = [(a[g][k].cpu() - b[g][k].cpu()).abs() for g in b for k in b[g]]
    err = max(d.max().item() for d in diffs)
    share = sum(int((d > 1e-4).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    check(err <= steps * 1e-3, f"parameters differ by {err}, more than {steps} Adam steps")
    return err, share


def fit_on(device: str, approach: str, dataset, partners: int = 3, **game):
    """The grand coalition's fit under `approach` on `device` (the approach
    object), partner i holding (i+1)/sum of the data."""
    total = sum(range(1, partners + 1))
    sc = Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                  dataset=dataset, multi_partner_learning_approach=approach,
                  is_early_stopping=False, seed=0, device=device, **game)
    sc.instantiate_scenario_partners()
    sc.split_data()
    mpl = sc.multi_partner_learning_approach(sc)
    mpl.fit()
    return mpl


def phase_variants() -> None:
    """The seq family and lflip through the user entry points, at the MNIST
    CNN's full width with bench config 1's training (none of them records
    updates, so no reconstruction kernel may launch):
    (a) the 10-partner fedavg Scenario with Federated SBS x3, PVRL and
        LFlip; (b) the 5-partner seqavg retraining sweep on merged slot
        buckets, then its first multi-partner batch again masked; (c) the
        seq-pure and seq-with-final-agg fits at 10 partners; (d) Titanic
        seqavg and a small MNIST lflip fit on the card against the CPU."""
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    t0 = time.perf_counter()
    sc = mnist_scenario(VARIANT_METHODS)
    sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = sc.mpl.history.history
    expected = sbs_numpy(hist)
    print(f"[variants] MNIST CNN, {PARTNERS} partners, fedavg: {wall:.2f} s for "
          f"Scenario.run() (fit {sc.mpl.learning_computation_time:.2f} s, score "
          f"{sc.mpl.history.score:.4f})")
    for c in sc.contributivity_list:
        print(f"[variants] {c.name}: {c.computation_time_sec:.2f} s; values "
              f"{np.round(c.contributivity_scores, 4).tolist()}")
        check(bool(np.isfinite(c.contributivity_scores).all()), f"{c.name}: non-finite values")
        if c.name in expected:
            check(np.array_equal(c.contributivity_scores, expected[c.name]),
                  f"{c.name} differs from its numpy recomputation")
    pvrl, lflip = sc.contributivity_list[3:]
    check(pvrl.name == "PVRL" and bool(((pvrl.contributivity_scores > 0)
                                        & (pvrl.contributivity_scores < 1)).all()),
          "PVRL values are not in (0, 1)")
    # the EM step L1-normalises theta's rows, but a row whose posterior
    # mass is exactly 0 (the model's softmax underflowing to 0 for that
    # class on a whole window) divides 0 by the 1e-12 clamp and stays 0
    # for good, as in the JAX package (tests/test_torch_lflip.py)
    thetas = lflip.thetas_history
    rows = np.stack([t.sum(1) for epoch in thetas for t in epoch])
    dead = rows == 0
    last = np.stack(thetas[-1])
    print(f"[variants] LFlip: {len(thetas)} epochs of thetas, {int((~dead).sum())} rows "
          f"within {np.abs(rows[~dead] - 1).max(initial=0.0):.3g} of summing to 1, "
          f"{int(dead.sum())} of {dead.size} rows zero ({int((last.sum(2) == 0).sum())} "
          f"of {last.shape[0] * last.shape[1]} in the last epoch); label-flip fit "
          f"score {lflip.score:.4f}")
    check(len(thetas) == sc.epoch_count and np.abs(rows[~dead] - 1).max(initial=0.0) <= 1e-5,
          "a LFlip theta row sums neither to 1 nor to 0")
    check(np.array_equal(lflip.contributivity_scores, np.exp(-np.array(
        [np.linalg.norm(t - np.identity(t.shape[0])) for t in last]))),
          "the LFlip scores are not exp(-||theta - I||) of the last thetas")

    P = SWEEP_PARTNERS
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # one epoch, cut from the sweep's two for the script's time
    seq = mnist_scenario(["Shapley values"], P, approach="seqavg", epoch_count=1)
    seq.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = seq._charac_engine
    subsets = powerset_order(P)
    values = np.array([eng.charac_fct_values[s] for s in subsets])
    sv = seq.contributivity_list[0].contributivity_scores
    v_all = eng.charac_fct_values[tuple(range(P))]
    print(f"[variants] MNIST CNN, {P} partners, seqavg sweep ({seq.slot_bucketing} slot "
          f"buckets): {wall:.2f} s for Scenario.run() (fit "
          f"{seq.mpl.learning_computation_time:.2f} s, batches "
          f"{sum(b['seconds'] for b in eng.batch_log):.2f} s); peak memory "
          f"{(peak - base) / 2 ** 30:.2f} GiB above the phase's start")
    batch_lines("variants", eng)
    print(f"[variants] seqavg Shapley values {np.round(sv, 4).tolist()} (sum "
          f"{sv.sum():.6f}, v(N) {v_all:.4f}); v(S) {np.round(values, 4).tolist()}")
    check(seq.slot_bucketing == "merge", f"the seqavg sweep ran {seq.slot_bucketing}")
    check(bool(np.isfinite(values).all() and (values >= 0).all() and (values <= 1).all()),
          "a seqavg v(S) is not finite in [0, 1]")
    check(abs(sv.sum() - v_all) <= 1e-6, "the seqavg Shapley values do not sum to v(N)")
    first = next(b for b in eng.batch_log if b["kind"] == "multi")
    group = [s for s in subsets if len(s) > 1 and eng._slot_width(len(s)) == first["slot_count"]]
    group = group[:first["coalitions"]]
    got = np.array([eng.charac_fct_values[s] for s in group])
    n_test = len(seq.dataset.x_test)
    with knob(constants.NO_SLOTS_ENV, "1"):
        masked = CharacteristicEngine(seq)
    t0 = time.perf_counter()
    ref = masked.evaluate(group)
    masked_s = time.perf_counter() - t0
    differ = [s for s, a, b in zip(group, got, ref)
              if numerics.float_bits(a) != numerics.float_bits(b)]
    # the default reduce sums the aggregation's partner axis with
    # torch.sum, whose association on the card depends on the axis length
    # (5 masked, 3 slots), so the last bits differ where three members
    # fall differently, and training carries them on; shown on three
    # terms directly
    terms = torch.randn(3, 1 << 20, device=DEVICE)
    padded = torch.zeros(5, 1 << 20, device=DEVICE)
    padded[[0, 2, 4]] = terms
    assoc = int((terms.sum(0) != padded.sum(0)).sum())
    print(f"[variants] seqavg batch of {len(group)} coalitions masked in {masked_s:.2f} s "
          f"(on {first['slot_count']} slots {first['seconds']:.2f} s), default reduce: "
          f"{len(group) - len(differ)} of {len(group)} v(S) bit-equal, max diff "
          f"{float(np.abs(got - ref).max()):.4f} (1/n_test {1 / n_test:.4f}), differing "
          f"{differ}; torch.sum of 3 terms over an axis of 3 against 5 (two zeros): "
          f"{assoc} of {1 << 20} sums differ (not gated)")
    # the deterministic reduce folds left to right, so slots and masks must
    # agree bit for bit; the seq family stays on slots under it
    with knob(constants.DETERMINISTIC_REDUCE_ENV, "1"):
        det_slots = CharacteristicEngine(seq)
        with knob(constants.NO_SLOTS_ENV, "1"):
            det_masked = CharacteristicEngine(seq)
    check(det_slots._use_slots and not det_masked._use_slots,
          "the deterministic reduce did not keep the seq sweep on slots")
    t0 = time.perf_counter()
    a = det_slots.evaluate(group)
    det_s = time.perf_counter() - t0
    b = det_masked.evaluate(group)
    same = sum(numerics.float_bits(x) == numerics.float_bits(y) for x, y in zip(a, b))
    print(f"[variants] seqavg batch under the deterministic reduce, on slots "
          f"({det_s:.2f} s) and masked: {same} of {len(group)} v(S) bit-equal, max diff "
          f"{float(np.abs(a - b).max()):.4f}; against the default reduce's slots, max "
          f"diff {float(np.abs(a - got).max()):.4f}")
    check(same == len(group), "under the deterministic reduce seqavg slot and masked "
                              "v(S) differ")

    for approach in ("seq-pure", "seq-with-final-agg"):
        s = mnist_scenario([], approach=approach)
        s.instantiate_scenario_partners()
        s.split_data()
        mpl = s.multi_partner_learning_approach(s)
        t0 = time.perf_counter()
        score = mpl.fit()
        torch.cuda.synchronize()
        print(f"[variants] MNIST CNN, {PARTNERS} partners, {approach} fit: "
              f"{time.perf_counter() - t0:.2f} s, test accuracy {score:.4f}")
        check(score > 0.3, f"the {approach} fit's accuracy {score} is not above 0.3")

    titanic = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
    card, cpu = (fit_on(d, "seqavg", load_titanic(), **titanic) for d in (DEVICE, "cpu"))
    err = max((card.model_params[g][k].cpu() - cpu.model_params[g][k]).abs().max().item()
              for g in cpu.model_params for k in cpu.model_params[g])
    print(f"[variants] titanic seqavg fit, card vs cpu: params max abs err {err:.3g}")
    check(err <= 1e-4, "the card's and the CPU's seqavg fits differ")
    # lflip's own state, theta, is held to 1e-5: its EM steps read the
    # whole window's predictions, and a label drawn differently moves it
    # far more; the weights to Adam's bound, beside fedavg's as a control
    small = dict(epoch_count=1, minibatch_count=2, gradient_updates_per_pass_count=2)
    fits = {approach: [fit_on(d, approach, load_mnist(scale=0.02, noise=NOISE), **small)
                       for d in (DEVICE, "cpu")] for approach in ("lflip", "fedavg")}
    (card, cpu), control = fits["lflip"], fits["fedavg"]
    err, share = params_against(card.model_params, cpu.model_params, steps=4)
    cerr, cshare = params_against(control[0].model_params, control[1].model_params, steps=4)
    terr = float(np.abs(np.stack(card.history.theta[0]) - np.stack(cpu.history.theta[0])).max())
    print(f"[variants] small MNIST lflip fit, card vs cpu: params max abs err {err:.3g}, "
          f"share above 1e-4 {share:.3g} (fedavg's: {cerr:.3g}, {cshare:.3g}); theta max "
          f"abs err {terr:.3g}; test accuracy {card.history.score:.4f} / "
          f"{cpu.history.score:.4f}")
    check(terr <= 1e-5, "the card's and the CPU's lflip thetas differ")
    check(recon_kernel.launches == recon_kernel.launches_bf16 == 0,
          "the variants launched a reconstruction kernel")


# The faults phase: the main path under this plan (partner 3 drops at
# epoch 2 of 2, partner 7 trains from the params one round stale)
FAULT_PLAN = "dropout@p3:epoch2,straggler@p7:delay1"
# a forever-dropped partner's v(S) against the partner-excluded run's: the
# card's bound where the two train at other vmap widths (slots and masked)
NULL_BOUND = 1e-6


def titanic_game(device: str, partners: int = 3, **kw) -> Scenario:
    """A Titanic game of `partners` partners split (i+1)/sum, 2 epochs of 2
    minibatches of 2 steps, a dry run."""
    total = sum(range(1, partners + 1))
    return Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                    dataset=load_titanic(), epoch_count=2, minibatch_count=2,
                    gradient_updates_per_pass_count=2, is_early_stopping=False, seed=0,
                    device=device, **kw)


def faults_main_path(card) -> dict:
    """(a): the main path under FAULT_PLAN, K1's launches counted from 0."""
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with knob(constants.PARTNER_FAULT_PLAN_ENV, FAULT_PLAN):
        sc = mnist_scenario(["GTG-Shapley"])
        sc.run()
        exact = Contributivity(sc)
        exact.exact_reconstructed()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, bf16 = recon_kernel.launches, recon_kernel.launches_bf16
    widths = dict(sorted(recon_kernel.launch_widths.items()))
    recon = exact._reconstructor()
    eng, rec = recon.engine, recon.recorded
    values = np.array([recon.values[s] for s in powerset_order(PARTNERS)])
    gtg, sv = sc.contributivity_list[0].contributivity_scores, exact.contributivity_scores
    MB = sc.minibatch_count
    dropped = [rec.weights[MB:, 3]] + [t[MB:, 3] for d in rec.deltas.values() for t in d.values()]
    zero = sum(int((t == 0).all()) for t in dropped)
    grand = recon_kernel.reconstruct_batch(
        torch.ones(1, PARTNERS, device=DEVICE), rec.init_params, rec.deltas, rec.weights, "fp32")
    err = max((grand[g][k][0] - rec.final_params[g][k]).abs().max().item()
              for g in grand for k in grand[g])
    print(f"[faults] MNIST CNN, {PARTNERS} partners, plan {FAULT_PLAN} "
          f"(fingerprint {eng._fingerprint()['partner_fault_plan']}): {wall:.2f} s for "
          f"Scenario.run() with GTG-Shapley and the exact reconstruction (fit score "
          f"{sc.mpl.history.score:.4f}), peak memory {(peak - base) / 2 ** 30:.2f} GiB above "
          f"the phase's start; v(N) {recon.values[tuple(range(PARTNERS))]:.4f}; "
          f"GTG-Shapley {np.round(gtg, 4).tolist()}; exact {np.round(sv, 4).tolist()}")
    print(f"[faults] launches {recon_kernel.KERNEL} {launches}, {recon_kernel.KERNEL_BF16} "
          f"{bf16}; {recon_kernel.KERNEL} launches by batch width {json.dumps(widths)}; "
          f"{recon.reconstructions} coalitions reconstructed; partner 3's epoch-2 rows: "
          f"{zero} of {len(dropped)} tensors all zero; reconstructed grand coalition vs "
          f"recorded final params: max abs err {err:.3g} (bound 1e-4)")
    check(eng._multi_cfg.partner_drop_epochs == (0, 0, 0, 2) + (0,) * (PARTNERS - 4)
          and eng._multi_cfg.partner_straggler_delays[7] == 1,
          "the engine's trainers do not carry the plan")
    check(launches > 0, "the fault-plan path never launched K1")
    check(bf16 == 0, "the fp32 fault-plan path launched K1-bf16")
    check(zero == len(dropped), "partner 3's epoch-2 deltas or weights are not exact zeros")
    check(bool((rec.weights[:MB, 3] > 0).all()), "partner 3 weighs nothing in epoch 1")
    check(err <= 1e-4, "the reconstructed grand coalition differs from the recording's "
                       "final params")
    check(bool(np.isfinite(values).all() and np.isfinite(sv).all() and np.isfinite(gtg).all()),
          "non-finite values or scores under the plan")
    check_same_recording(rec, record_updates(eng), "faults")
    subsets = powerset_order(PARTNERS)[:63] + [()]
    masks = torch.from_numpy(eng._coalition_arrays(subsets)).to(DEVICE)
    wn2 = recon_kernel.normalized_round_weights(masks, recon._weights).reshape(len(subsets), -1)
    entry = kernel_entry(recon_kernel.KERNEL, wn2.contiguous(), recon._d2, recon._init,
                         launches, card, timed=False)
    print(f"[faults] {recon_kernel.KERNEL} on the fault-plan stream {entry['shape']}: max abs "
          f"err against its plain version {entry['max_abs_err']:.3g}")
    return {"launches": launches, "widths": widths, "seconds": wall}


def faults_null_player() -> float:
    """(b): dropout@p4:epoch1 on a 5-partner Titanic sweep under the
    deterministic reduce against the fault-free sweep."""
    P = 5
    t0 = time.perf_counter()
    tables = {}
    with knob(constants.DETERMINISTIC_REDUCE_ENV, "1"):
        for plan in ("", "dropout@p4:epoch1"):
            with knob(constants.PARTNER_FAULT_PLAN_ENV, plan):
                sc = titanic_game(DEVICE, P, methods=["Shapley values"])
                sc.run()
            tables[plan] = (sc, sc._charac_engine.charac_fct_values)
    (clean_sc, clean), (sc, faulty) = tables.values()
    diffs = []
    for s in powerset_order(P):
        eff = tuple(i for i in s if i != 4)
        diffs.append(abs(faulty[s] - (clean[eff] if eff else 0.0)))
    sv = sc.contributivity_list[0].contributivity_scores
    wall = time.perf_counter() - t0
    print(f"[faults] titanic, {P} partners, deterministic reduce, dropout@p4:epoch1 "
          f"({sc.slot_bucketing}) against the fault-free sweep ({clean_sc.slot_bucketing}): "
          f"{sum(d == 0 for d in diffs)} of {len(diffs)} v(S) bit-equal to v(S - {{4}}), max "
          f"diff {max(diffs):.3g}; Shapley values {np.round(sv, 6).tolist()}; {wall:.2f} s")
    check(sc.slot_bucketing == "merge" and clean_sc.slot_bucketing == "masked",
          "the deterministic reduce did not route the faulty sweep on slots and the "
          "clean one masked")
    check(max(diffs) <= NULL_BOUND, "a forever-dropped partner's v(S) is not v(S - {4})")
    check(abs(sv[4]) <= NULL_BOUND, f"partner 4's Shapley value {sv[4]} is not 0")
    return wall


def faults_ensemble(sweep: dict) -> float:
    """(c): the sweep's configuration at seed_ensemble = 2."""
    P = SWEEP_PARTNERS
    ref_eng = sweep["scenario"]._charac_engine
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with knob(constants.SEED_ENSEMBLE_ENV, "2"):
        sc = mnist_scenario(["Shapley values"], P)
        sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = sc._charac_engine
    c = sc.contributivity_list[0]
    subsets = powerset_order(P)
    got = np.array([eng.charac_fct_values[s] for s in subsets])
    ref = np.array([ref_eng.charac_fct_values[s] for s in subsets])
    same = sum(numerics.float_bits(a) == numerics.float_bits(b) for a, b in zip(got, ref))
    n_test = len(sc.dataset.x_test)
    dv = float(np.abs(got - ref).max())
    batches = (len(eng.batch_log), len(ref_eng.batch_log))
    print(f"[faults] MNIST CNN, {P} partners, seed ensemble of {eng.seed_ensemble}: "
          f"{wall:.2f} s for Scenario.run() (fit {sc.mpl.learning_computation_time:.2f} s, "
          f"batches {sum(b['seconds'] for b in eng.batch_log):.2f} s); {batches[0]} batches "
          f"against [sweep]'s {batches[1]}; peak memory {(peak - base) / 2 ** 30:.2f} GiB above "
          f"the phase's start")
    batch_lines("faults", eng)
    print(f"[faults] replica 0 against [sweep]: {same} of {len(subsets)} v(S) bit-equal, max "
          f"diff {dv:.4f} (1/n_test {1 / n_test:.4f}); replica 1 "
          f"{np.round([eng.charac_fct_samples[s][1] for s in subsets], 4).tolist()}")
    print("[faults] trust " + json.dumps(c.trust))
    check(eng.seed_ensemble == 2 and len(eng.charac_fct_samples) == len(subsets),
          "the ensemble did not train every coalition's replicas")
    check(dv <= 1.0 / n_test + 1e-6, "replica 0 differs from [sweep] by more than one sample")
    check(batches[0] < 2 * batches[1], f"the ensemble took {batches[0]} batches, not fewer "
                                       f"than twice [sweep]'s {batches[1]}")
    trust = c.trust or {}
    check(trust.get("source") == "seed_ensemble"
          and bool(np.isfinite(trust["mean"] + trust["std"] + trust["ci_low"]
                               + trust["ci_high"]).all())
          and -1.0 <= trust["kendall_tau"] <= 1.0, "the trust row is missing or not finite")
    return wall


def faults_reference() -> float:
    """(d): Titanic on the card against the CPU."""
    t0 = time.perf_counter()
    recs = []
    with knob(constants.PARTNER_FAULT_PLAN_ENV, "straggler@p1:delay2"):
        for device in (DEVICE, "cpu"):
            sc = titanic_game(device)
            sc.instantiate_scenario_partners()
            sc.split_data()
            sc.data_corruption()
            recs.append(record_updates(CharacteristicEngine(sc)))
    card, cpu = recs
    err = max((a.cpu() - b).abs().max().item() for x, y in (
        (card.final_params, cpu.final_params), (card.deltas, cpu.deltas))
        for g in y for a, b in zip(x[g].values(), y[g].values()))
    werr = (card.weights.cpu() - cpu.weights).abs().max().item()
    with knob(constants.STEP_WIDTH_MULT_ENV, "2"):
        fits = [fit_on(d, "fedavg", load_titanic(), epoch_count=2, minibatch_count=2,
                       gradient_updates_per_pass_count=3) for d in (DEVICE, "cpu")]
    ferr = max((fits[0].model_params[g][k].cpu() - fits[1].model_params[g][k]).abs().max().item()
               for g in fits[1].model_params for k in fits[1].model_params[g])
    wall = time.perf_counter() - t0
    print(f"[faults] titanic, card vs cpu: straggler@p1:delay2 recording, params and deltas "
          f"max abs err {err:.3g}, weights {werr:.3g}; fedavg fit at step_width_mult "
          f"{fits[0].cfg.step_width_mult} ({fits[0].cfg.pass_steps} steps a pass), params max "
          f"abs err {ferr:.3g}; {wall:.2f} s")
    check(fits[0].cfg.step_width_mult == 2, "the fit did not take the step-width knob")
    check(max(err, werr, ferr) <= 1e-4, "the card and the CPU differ by more than 1e-4")
    return wall


def phase_faults(card, sweep: dict, smi: str) -> dict:
    """The partner fault plan on the main path, a forever-dropped partner as
    a null player, a seed ensemble and the card against the CPU."""
    out = faults_main_path(card)
    seconds = {"main path": out["seconds"], "null player": faults_null_player(),
               "ensemble": faults_ensemble(sweep), "card vs cpu": faults_reference()}
    print(f"[faults] seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"on {smi}")
    return out


# The cifar10 phase: bench config 2's training (bench.py:508-526) at its 5
# partners, 2 epochs cut from its 8 for the script's time; synthetic
# CIFAR10 at scale 0.2 (10,000 rows drawn from the training prototypes, of
# which the loader's split keeps 9,000 as training rows), 2,000 of those
# rows the phase's test set. The noise is lowered from bench.py's 0.75:
# within 2 epochs RMSprop at 1e-4 leaves the CNN on its plateau at noise
# 0.45 and 0.75 (test accuracy 0.13-0.16; at 0.45 it leaves it from epoch
# 4), at 0.1 it learns (0.80): `python3 -m mplc_tpu_torch.obs.learning_curve
# --device cpu --scale 0.05 --test-rows 500 --noise <noise>`
CIFAR_PARTNERS = 5
CIFAR_SCALE = 0.2
CIFAR_TEST_ROWS = 2000
CIFAR_EPOCHS = 2
CIFAR_NOISE = 0.1
# v(N) of the TMCS sweep must pass this: half of that curve's 0.80
CIFAR_V_MIN = 0.4


def cifar_dataset(scale: float = CIFAR_SCALE, test_rows: int = CIFAR_TEST_ROWS) -> Dataset:
    """The loader's training rows, the first `test_rows` of them held out
    as the test set."""
    return with_held_out_test(load_cifar10(scale=scale, noise=CIFAR_NOISE), test_rows)


def cifar_scenario(dataset, methods, partners: int = CIFAR_PARTNERS, device: str = DEVICE,
                   **game) -> Scenario:
    """Bench config 2's training at CIFAR_EPOCHS epochs, partner i holding
    (i+1)/sum of the data, a dry run."""
    total = sum(range(1, partners + 1))
    cfg = dict(multi_partner_learning_approach="fedavg", aggregation_weighting="data-volume",
               epoch_count=CIFAR_EPOCHS, minibatch_count=10, gradient_updates_per_pass_count=8,
               is_early_stopping=False, seed=0)
    cfg.update(game)
    return Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                    dataset=dataset, methods=methods, device=device, **cfg)


def cifar_sweep(dataset) -> dict:
    """(a): the TMCS sweep through `Scenario.run()`."""
    P = CIFAR_PARTNERS
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = cifar_scenario(dataset, ["TMCS"])
    sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = sc._charac_engine
    c = sc.contributivity_list[0]
    table = {s: v for s, v in eng.charac_fct_values.items() if s}
    values = np.array(list(table.values()))
    v_all = eng.charac_fct_values.get(tuple(range(P)))
    widths = {}
    for b in eng.batch_log:
        key = "single" if b["kind"] == "single" else (
            "masked" if b["slot_count"] is None else f"{b['slot_count']} slots")
        widths.setdefault(key, []).append([b["width"], b["coalitions"], round(b["seconds"], 3)])
    print(f"[cifar10] CIFAR10 CNN, {P} partners, TMCS: {wall:.2f} s for Scenario.run() (fit "
          f"{sc.mpl.learning_computation_time:.2f} s, score {sc.mpl.history.score:.4f}; TMCS "
          f"{c.computation_time_sec:.2f} s, {len(table)} coalitions trained in "
          f"{sum(b['seconds'] for b in eng.batch_log):.2f} s, {sc.slot_bucketing} slot buckets); "
          f"peak memory {peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above the "
          f"phase's start)")
    print(f"[cifar10] batches by slot width [width, coalitions, s]: {json.dumps(widths)}")
    print(f"[cifar10] TMCS values {np.round(c.contributivity_scores, 4).tolist()}; v(N) "
          f"{v_all}; v(S) " + json.dumps({",".join(map(str, s)): round(float(v), 4)
                                          for s, v in table.items()}))
    check(sc.slot_bucketing == "merge", f"the CIFAR10 sweep ran {sc.slot_bucketing}")
    check(bool(np.isfinite(c.contributivity_scores).all()), "non-finite TMCS values")
    check(bool(np.isfinite(values).all() and (values >= 0).all() and (values <= 1).all()),
          "a CIFAR10 v(S) is not finite in [0, 1]")
    check(v_all is not None and v_all > CIFAR_V_MIN,
          f"v(N) = {v_all} is not above {CIFAR_V_MIN}")
    check(recon_kernel.launches == recon_kernel.launches_bf16 == 0,
          "the TMCS sweep launched a reconstruction kernel")
    return {"scenario": sc, "seconds": wall, "peak_gib": peak / 2 ** 30}


def recording_query(tag: str, sc, D_want: int, card) -> dict:
    """GTG-Shapley over the grand coalition's recording of `sc`, K1's
    launches counted from 0 (it must launch, K1-bf16 must not); the stream
    must be K = epochs x minibatches x partners rows of `D_want`
    parameters; the reconstructed grand coalition within 1e-4 of the
    recorded final params; the recording made again bit-equal; K1 against
    its plain version on this stream at B = 16, timed (`K1[<tag> B=16]`)."""
    P = sc.partners_count
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    t0 = time.perf_counter()
    c = Contributivity(sc)
    c.compute_contributivity("GTG-Shapley")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bf16 = recon_kernel.launches, recon_kernel.launches_bf16
    widths = dict(sorted(recon_kernel.launch_widths.items()))
    recon = c._reconstructor()
    eng, rec = recon.engine, recon.recorded
    K, Dp = recon._d2.shape
    D = sum(t[0].numel() for d in rec.deltas.values() for t in d.values()) // P
    grand = recon_kernel.reconstruct_batch(torch.ones(1, P, device=DEVICE), rec.init_params,
                                           rec.deltas, rec.weights, "fp32")
    err = max((grand[g][k][0] - rec.final_params[g][k]).abs().max().item()
              for g in grand for k in grand[g])
    gtg = c.contributivity_scores
    K_want = sc.epoch_count * sc.minibatch_count * P
    print(f"[{tag}] GTG-Shapley over the recording: {wall:.2f} s (recording included), "
          f"{recon.reconstructions} coalitions reconstructed; values "
          f"{np.round(gtg, 4).tolist()}; launches {recon_kernel.KERNEL} {launches}, "
          f"{recon_kernel.KERNEL_BF16} {bf16}; by batch width {json.dumps(widths)}; stream K = "
          f"{K}, D = {D} (Dp {Dp}), {recon._d2.numel() * recon._d2.element_size() / 1e9:.3f} "
          f"GB; reconstructed grand coalition vs recorded final params: max abs err "
          f"{err:.3g} (bound 1e-4)")
    check(launches > 0, f"the {tag} GTG query never launched K1")
    check(bf16 == 0, f"the fp32 {tag} query launched K1-bf16")
    check(K == K_want and D == D_want, f"the {tag} stream is {K} x {D}, not {K_want} x {D_want}")
    check(err <= 1e-4, "the reconstructed grand coalition differs from the recording's "
                       "final params")
    check(bool(np.isfinite(gtg).all()), "non-finite GTG-Shapley values")
    check_same_recording(rec, record_updates(eng), tag)
    # 15 coalitions (the powerset repeated where it has fewer) and the
    # empty one, whose weights are all zero
    subsets = (powerset_order(P) * 15)[:15] + [()]
    masks = torch.from_numpy(eng._coalition_arrays(subsets)).to(DEVICE)
    wn2 = recon_kernel.normalized_round_weights(masks, recon._weights).reshape(len(subsets), -1)
    entry = kernel_entry(recon_kernel.KERNEL, wn2.contiguous(), recon._d2, recon._init,
                         sum(n for w, n in widths.items() if w <= 16), card)
    entry["name"] = f"{recon_kernel.KERNEL}[{tag} B=16]"
    entry["launch_widths"] = widths
    entry["launches_by_path"] = {tag: entry["launches"]}
    print(f"[kernels] {entry['name']} {entry['shape']}: {entry['ms']:.4f} ms (plain "
          f"{entry['plain_ms']:.4f}, {entry['library']} {entry['library_ms']:.4f}, bound "
          f"{entry['bound_ms']:.4f} by {entry['bound_by']}), max abs err "
          f"{entry['max_abs_err']:.3g}, {entry['launches']} launches")
    return {"launches": launches, "widths": widths, "entry": entry, "seconds": wall,
            "recon": recon}


def card_vs_cpu_fit(tag: str, dataset, train_rows: int, test_rows: int) -> float:
    """A 3-partner fit of `train_rows` of the dataset's training rows for
    one epoch (2 minibatches of 2 steps) on the card and on the CPU from one
    seed: the dropout masks every step drew bit-equal, the final params
    within 1e-4."""
    small = Dataset(dataset.name, dataset.input_shape, dataset.num_classes,
                    dataset.x_train[:train_rows], dataset.y_train[:train_rows],
                    dataset.x_test[:test_rows], dataset.y_test[:test_rows], model=dataset.model)
    drawn = {}
    step_masks = dropout.step_masks
    t0 = time.perf_counter()
    fits = []
    for device in (DEVICE, "cpu"):
        drawn[device] = []

        def record(*args, _log=drawn[device]):
            masks = step_masks(*args)
            _log.append([m.cpu() for m in masks])
            return masks
        dropout.step_masks = record
        try:
            fits.append(fit_on(device, "fedavg", small, epoch_count=1, minibatch_count=2,
                               gradient_updates_per_pass_count=2))
        finally:
            dropout.step_masks = step_masks
    card, cpu = drawn[DEVICE], drawn["cpu"]
    same = sum(torch.equal(a, b) for x, y in zip(card, cpu) for a, b in zip(x, y))
    total = sum(len(x) for x in cpu)
    elements = sum(m.numel() for x in cpu for m in x)
    err = max((fits[0].model_params[g][k].cpu() - fits[1].model_params[g][k]).abs().max().item()
              for g in fits[1].model_params for k in fits[1].model_params[g])
    wall = time.perf_counter() - t0
    print(f"[{tag}] 3-partner fit, card vs cpu: {same} of {total} step masks bit-equal "
          f"({len(cpu)} steps, {elements} mask elements, keep share "
          f"{sum(int(m.sum()) for x in cpu for m in x) / max(elements, 1):.4f}); final params "
          f"max abs err {err:.3g} (bound 1e-4); {wall:.2f} s")
    check(total > 0 and len(card) == len(cpu) and same == total,
          "the card and the CPU drew other dropout masks")
    check(err <= 1e-4, f"the card's and the CPU's {tag} fits differ by more than 1e-4")
    return wall


def cifar_slots_vs_masks(sweep: dict) -> float:
    """(e): the first 16 multi-partner coalitions in one batch, on slots
    (3 wide) and masked, under the deterministic reduce: bit-equal v(S)."""
    eng = sweep["scenario"]._charac_engine
    P = CIFAR_PARTNERS
    subsets = [s for s in powerset_order(P) if 1 < len(s) <= 3][:16]
    t0 = time.perf_counter()
    values = []
    for slots in (None, 3):
        cfg = dataclasses.replace(eng._multi_cfg, deterministic_reduce=True, slot_count=slots)
        tr = MplTrainer(eng.model, cfg)
        gens = [eng.coalition_generator(s) for s in subsets]
        state = tr.init_state(gens, P, DEVICE)
        coal = torch.from_numpy(eng._coalition_arrays(subsets, slots)).to(DEVICE)
        tr.epoch_chunk(state, eng.stacked, eng.val, coal, gens, cfg.epoch_count)
        values.append(tr.finalize(state, eng.test)[1].cpu().numpy())
    wall = time.perf_counter() - t0
    masked, slotted = values
    same = sum(numerics.float_bits(a) == numerics.float_bits(b) for a, b in zip(masked, slotted))
    print(f"[cifar10] deterministic reduce, {len(subsets)} coalitions on 3 slots and masked: "
          f"{same} of {len(subsets)} v(S) bit-equal, max diff "
          f"{float(np.abs(masked - slotted).max()):.4f}; v(S) {np.round(slotted, 4).tolist()}; "
          f"{wall:.2f} s")
    check(same == len(subsets), "under the deterministic reduce CIFAR10 slot and masked v(S) "
                                "differ")
    return wall


def phase_cifar10(card, smi: str) -> dict:
    """The CIFAR10 CNN on bench config 2's training: the TMCS sweep, a
    GTG-Shapley query through K1, the card against the CPU, the recording
    twice and slots against masks."""
    t0 = time.perf_counter()
    dataset = cifar_dataset()
    data_s = time.perf_counter() - t0
    sweep = cifar_sweep(dataset)
    # (b) and (d): GTG through K1, the recording again; (c) a small fit
    out = recording_query("cifar10", sweep["scenario"], 1_250_858, card)
    del out["recon"]
    seconds = {"data": data_s, "TMCS sweep": sweep["seconds"], "GTG": out["seconds"],
               "card vs cpu": card_vs_cpu_fit("cifar10", dataset, 400, 100),
               "slots vs masks": cifar_slots_vs_masks(sweep)}
    print(f"[cifar10] seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}, "
          f"peak memory {sweep['peak_gib']:.2f} GiB in the sweep, on {smi}")
    return out


# bench.py's `_make_scenario` training (bench.py:506-526: fedavg,
# data-volume, minibatch 10, gup 8, no early stopping, seed 0), cut to 2
# epochs of bench's 8 for the script's time; the phases below run it
BENCH_GAME = dict(multi_partner_learning_approach="fedavg",
                  aggregation_weighting="data-volume", epoch_count=2, minibatch_count=10,
                  gradient_updates_per_pass_count=8, is_early_stopping=False, seed=0)

# The imdb phase: bench config 4's scenario (bench.py:1870-1872: SMCS on
# IMDB, 4 partners split (i+1)/10) on synthetic IMDB at scale 1.0 (22,500
# train, 2,500 val, 25,000 test rows), at the IMDB model's published width
# (2,227,873 parameters). v(N) must pass IMDB_V_MIN, set from the CPU
# learning curve of this fit (`python3 -m mplc_tpu_torch.obs.learning_curve
# --dataset imdb --device cpu --scale 1.0 --partners 4`: test accuracy 1.0
# after 2 epochs, val 0.9996 after 1; at scale 0.1 it stays at chance, 0.51)
IMDB_PARTNERS = 4
IMDB_SCALE = 1.0
IMDB_METHODS = ["SMCS", "Shapley values"]
IMDB_V_MIN = 0.9
# (e): rows of the test set whose bf16 logits are held card against CPU
IMDB_BF16_ROWS = 256


def imdb_scenario(methods, partners: int = IMDB_PARTNERS, device: str = DEVICE) -> Scenario:
    """Bench config 4's scenario through the user entry point:
    `Scenario(dataset_name="imdb")` loads synthetic IMDB at IMDB_SCALE."""
    total = sum(range(1, partners + 1))
    with knob(constants.SYNTH_SCALE_ENV, str(IMDB_SCALE)):
        return Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                        dataset_name="imdb", methods=methods, device=device, **BENCH_GAME)


def imdb_sweep() -> dict:
    """(a): SMCS and the exact Shapley values through `Scenario.run()`."""
    P = IMDB_PARTNERS
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = imdb_scenario(IMDB_METHODS)
    load_s = time.perf_counter() - t0
    sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = sc._charac_engine
    smcs, exact = (c.contributivity_scores for c in sc.contributivity_list)
    subsets = powerset_order(P)
    values = np.array([eng.charac_fct_values[s] for s in subsets])
    v_all = eng.charac_fct_values[tuple(range(P))]
    err = float(np.abs(smcs - exact).max())
    ds = sc.dataset
    print(f"[imdb] IMDB Conv1D, {P} partners, {len(ds.x_train)} train / {len(ds.x_val)} val / "
          f"{len(ds.x_test)} test rows ({ds.x_train.dtype} tokens, stacked "
          f"{eng.stacked.x.dtype}): {wall:.2f} s for Scenario.run() (loading {load_s:.2f} s, fit "
          f"{sc.mpl.learning_computation_time:.2f} s, score {sc.mpl.history.score:.4f}; "
          f"{eng.first_charac_fct_calls_count} coalitions trained in "
          f"{sum(b['seconds'] for b in eng.batch_log):.2f} s, {sc.slot_bucketing} slot "
          f"buckets); peak memory {peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB "
          f"above the phase's start)")
    batch_lines("imdb", eng)
    print(f"[imdb] SMCS {np.round(smcs, 4).tolist()}; exact {np.round(exact, 4).tolist()} "
          f"(sum {exact.sum():.6f}, v(N) {v_all:.4f}); SMCS max abs err against exact "
          f"{err:.4f} (bound {ESTIMATE_BOUND}); v(S) " + json.dumps(
              {",".join(map(str, s)): round(float(v), 4) for s, v in zip(subsets, values)}))
    check(eng.stacked.x.dtype == torch.int32 and eng.test.x.dtype == torch.int32,
          "the IMDB tokens were not staged as int32")
    check(bool(np.isfinite(values).all() and (values >= 0).all() and (values <= 1).all()),
          "an IMDB v(S) is not finite in [0, 1]")
    check(bool(np.isfinite(smcs).all() and np.isfinite(exact).all()), "non-finite values")
    check(err <= ESTIMATE_BOUND, f"SMCS is {err} from the exact Shapley values")
    check(eng.first_charac_fct_calls_count <= 2 ** P - 1
          and len(eng.charac_fct_values) == 2 ** P, "a coalition was trained twice")
    check(abs(exact.sum() - v_all) <= 1e-6, "the Shapley values do not sum to v(N)")
    check(v_all > IMDB_V_MIN, f"v(N) = {v_all} is not above {IMDB_V_MIN}")
    check(recon_kernel.launches == recon_kernel.launches_bf16 == 0,
          "the IMDB sweep launched a reconstruction kernel")
    return {"scenario": sc, "seconds": wall, "peak_gib": peak / 2 ** 30}


def imdb_bf16_logits(recon) -> float:
    """(e): the IMDB model's bf16 logits on the card against the CPU's, at
    the recording's final params, on test rows whose tokens reach above
    256 (bf16 holds integers exactly up to 256 only), with its control: the
    card's logits of the same tokens rounded through bf16 must fail the
    limits, as a model that cast its tokens would."""
    t0 = time.perf_counter()
    engine = recon.engine
    params = recon.recorded.final_params
    x = torch.from_numpy(engine.scenario.dataset.x_test[:IMDB_BF16_ROWS])
    rounded = x.to(torch.bfloat16).to(torch.int64)
    high = int((x > 256).sum())
    cpu_params = {g: {k: t.cpu() for k, t in d.items()} for g, d in params.items()}
    with torch.no_grad():
        ref = engine.model.apply(cpu_params, x, torch.bfloat16)
        got = engine.model.apply(params, x.to(DEVICE), torch.bfloat16).cpu()
        ctrl = engine.model.apply(params, rounded.to(DEVICE), torch.bfloat16).cpu()
    top = ref.abs().max().item()
    limit = MODEL_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    err, err_c = ((g - ref).abs().max().item() for g in (got, ctrl))
    equal, equal_c = ((g == ref).double().mean().item() for g in (got, ctrl))
    print(f"[imdb] bf16 logits, card vs cpu ({IMDB_BF16_ROWS} test rows, {high} tokens above "
          f"256, {int((rounded != x).sum())} of them moved by a bf16 rounding; max |logit| "
          f"{top:.4g}): bit-equal share {equal:.4f} (at least {MODEL_EQUAL_SHARE}), max abs "
          f"err {err:.3g} (limit {limit:.3g}); control, tokens through bf16: bit-equal share "
          f"{equal_c:.4f}, max abs err {err_c:.3g}")
    check(high > 0 and bool((rounded != x).any()), "no test token is above bf16's exact range")
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          "the card's bf16 IMDB logits are not finite float32")
    check(equal >= MODEL_EQUAL_SHARE and err <= limit,
          "the card's bf16 IMDB logits differ from the CPU's")
    check(equal_c < MODEL_EQUAL_SHARE or err_c > limit,
          "tokens rounded through bf16 pass the limit: it cannot tell a cast token")
    return time.perf_counter() - t0


def phase_imdb(card, smi: str) -> dict:
    """Bench config 4's scenario on IMDB: SMCS and exact Shapley through
    `Scenario.run()`, a GTG-Shapley query through K1 on the IMDB stream,
    the recording twice, a small fit card vs CPU, bf16 logits card vs CPU."""
    sweep = imdb_sweep()
    out = recording_query("imdb", sweep["scenario"], 2_227_873, card)
    seconds = {"SMCS + exact sweep": sweep["seconds"], "GTG + recording twice": out["seconds"],
               "card vs cpu": card_vs_cpu_fit("imdb", sweep["scenario"].dataset, 600, 200),
               "bf16 logits": imdb_bf16_logits(out.pop("recon"))}
    print(f"[imdb] seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}, "
          f"peak memory {sweep['peak_gib']:.2f} GiB in the sweep, on {smi}")
    return out


# The esc50 phase: synthetic ESC50 at scale 1.0 (2,000 clips of 50 classes:
# 1,620 train, 180 val, 200 test rows), 3 partners [0.4, 0.3, 0.3]
# (bench.py `_amounts(3)`, config_quick_debug's split), bench's training;
# the ESC50 CNN at its published width (49,762 parameters). The CPU
# learning curve of this fit (`python3 -m mplc_tpu_torch.obs.learning_curve
# --dataset esc50 --device cpu --scale 1.0 --amounts 0.4,0.3,0.3 --epochs 8`)
# stays at chance (1/50): test accuracy 0.015 after 2 epochs and after 8,
# the training loss flat at ln 50. The loader's prototypes are independent
# uniform pixels of one distribution for every class, which the CNN's
# global average pool averages away (the JAX package's loader and model
# alike). So v(N) is gated as an accuracy in [0, 1] only
ESC50_AMOUNTS = [0.4, 0.3, 0.3]
ESC50_SCALE = 1.0


def esc50_scenario(methods, device: str = DEVICE) -> Scenario:
    """`Scenario(dataset_name="esc50")`, synthetic ESC50 at ESC50_SCALE."""
    with knob(constants.SYNTH_SCALE_ENV, str(ESC50_SCALE)):
        return Scenario(len(ESC50_AMOUNTS), ESC50_AMOUNTS, is_dry_run=True,
                        dataset_name="esc50", methods=methods, device=device, **BENCH_GAME)


def esc50_sweep() -> dict:
    """(a): the exact Shapley sweep, 7 coalitions, the multis on merged
    slots."""
    P = len(ESC50_AMOUNTS)
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = esc50_scenario(["Shapley values"])
    load_s = time.perf_counter() - t0
    sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = sc._charac_engine
    sv = sc.contributivity_list[0].contributivity_scores
    subsets = powerset_order(P)
    values = np.array([eng.charac_fct_values[s] for s in subsets])
    v_all = eng.charac_fct_values[tuple(range(P))]
    batches = [(b["kind"], b["width"], b["slot_count"], b["coalitions"]) for b in eng.batch_log]
    ds = sc.dataset
    print(f"[esc50] ESC50 CNN, {P} partners, {len(ds.x_train)} train / {len(ds.x_val)} val / "
          f"{len(ds.x_test)} test rows: {wall:.2f} s for Scenario.run() (loading {load_s:.2f} s, "
          f"fit {sc.mpl.learning_computation_time:.2f} s, score {sc.mpl.history.score:.4f}; "
          f"batches {sum(b['seconds'] for b in eng.batch_log):.2f} s, {sc.slot_bucketing} slot "
          f"buckets); peak memory {peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB "
          f"above the phase's start)")
    batch_lines("esc50", eng)
    print(f"[esc50] Shapley values {np.round(sv, 4).tolist()} (sum {sv.sum():.6f}, v(N) "
          f"{v_all:.4f}, chance 0.02; the CPU curve's fit scores 0.015); v(S) "
          f"{np.round(values, 4).tolist()}")
    check(bool(np.isfinite(values).all() and (values >= 0).all() and (values <= 1).all()),
          "an ESC50 v(S) is not finite in [0, 1]")
    check(abs(sv.sum() - v_all) <= 1e-6, "the Shapley values do not sum to v(N)")
    check(sc.slot_bucketing == "merge" and batches == [("single", 4, None, 3),
                                                       ("multi", 4, 3, 4)],
          f"the ESC50 sweep trained other batches than its 7 coalitions need: {batches}")
    check(recon_kernel.launches == recon_kernel.launches_bf16 == 0,
          "the ESC50 sweep launched a reconstruction kernel")
    return {"scenario": sc, "seconds": wall, "peak_gib": peak / 2 ** 30}


def esc50_eval_memory(recon, B: int = 16) -> float:
    """(d): B reconstructed ESC50 models evaluated on the test set, with
    the peak memory above the start, beside the rows in flight the model's
    bound allows (`constants.eval_rows_in_flight`) and the bytes of their
    largest activation."""
    eng = recon.engine
    model = eng.model
    subsets = powerset_order(eng.partners_count)
    subsets = (subsets * B)[:B]
    masks = torch.from_numpy(eng._coalition_arrays(subsets)).to(DEVICE)
    params = recon_kernel.unflatten(recon.reconstruct(masks), recon._layout)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        eng.trainer.evaluate_models(params, eng.test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    rows = constants.eval_rows_in_flight(model.eval_row_bytes)
    per_call = max(1, rows // B)
    act = per_call * B * model.eval_row_bytes
    print(f"[esc50] evaluation of {B} models on {len(eng.scenario.dataset.x_test)} test rows "
          f"(chunks of {eng.test.x.shape[1]}): {wall:.3f} s, peak memory {peak / 2 ** 30:.3f} GiB "
          f"above the start; rows in flight {rows} (row bound {constants.EVAL_ROWS_IN_FLIGHT}, "
          f"{model.eval_row_bytes} bytes a row), {per_call} rows a model a call, largest "
          f"activation {act / 2 ** 30:.3f} GiB (bound {constants.EVAL_BYTES_IN_FLIGHT / 2 ** 30:.3f})")
    check(rows < constants.EVAL_ROWS_IN_FLIGHT and act <= constants.EVAL_BYTES_IN_FLIGHT,
          "the ESC50 CNN's rows in flight are not bounded by its bytes")
    # a convolution's input, output and ReLU live at once: about three
    # largest activations (6.11 GiB measured on an H100 80GB HBM3 at 700 W);
    # at the row bound alone, 16,384 rows, the first conv would hold 16 GiB
    check(peak <= 4 * constants.EVAL_BYTES_IN_FLIGHT,
          f"the evaluation's peak {peak / 2 ** 30:.2f} GiB exceeds four times its bound")
    return wall


def phase_esc50(card, smi: str) -> dict:
    """ESC50 on bench's training: the exact Shapley sweep, GTG-Shapley
    through K1 on the ESC50 stream and the recording twice, a fit card vs
    CPU, the evaluation's memory under its bytes bound."""
    sweep = esc50_sweep()
    out = recording_query("esc50", sweep["scenario"], 49_762, card)
    seconds = {"exact sweep": sweep["seconds"], "GTG + recording twice": out["seconds"],
               "card vs cpu": card_vs_cpu_fit("esc50", sweep["scenario"].dataset, 400, 100),
               "evaluation": esc50_eval_memory(out.pop("recon"))}
    print(f"[esc50] seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}, "
          f"peak memory {sweep['peak_gib']:.2f} GiB in the sweep, on {smi}")
    return out


# The cli phase: the user's entry point, `python3 -m mplc_tpu_torch.main -f
# <config>` (called in-process, so that K1's launch counts are the CLI's),
# on synthetic MNIST at the slice's scale and noise and the MNIST CNN at its
# full width: 4 partners [0.1, 0.2, 0.3, 0.4], a basic stratified split and
# an advanced one (3 + 3 specific label clusters and 4 shared, of 10
# labels), fedavg, data-volume, 2 epochs of bench's minibatch 10 and gup 8,
# GTG-Shapley (through K1) and the exact sweep. The `dataset_name` dict
# sub-syntax maps mnist to random weights, then, for the warm start, to the
# first scenario's final weights.
CLI_GRID = """experiment_name: {name}
n_repeats: 1
scenario_params_list:
  - dataset_name:
      mnist: {init}
    partners_count: [4]
    amounts_per_partner: [[0.1, 0.2, 0.3, 0.4]]
    samples_split_option:
      - ['basic', 'stratified']
{advanced}    multi_partner_learning_approach: ['fedavg']
    aggregation_weighting: ['data-volume']
    epoch_count: [{epochs}]
    minibatch_count: [10]
    gradient_updates_per_pass_count: [8]
    is_early_stopping: [false]
{methods}"""
CLI_ADVANCED = ("      - ['advanced', [[3, 'specific'], [3, 'specific'], [4, 'shared'], "
                "[2, 'shared']]]\n")
CLI_METHODS = "    methods: [['GTG-Shapley', 'Shapley values']]\n"
# The test score each scenario of the grid must beat: 0.3 for the basic
# split; for the advanced split 1.5 times chance (0.15). That split leaves
# the partners 300 to 1,213 rows (3 to 15 rows a step) of 2 to 4 labels
# each, and two epochs of FedAvg on it scored 0.216 on an H100 80GB HBM3 at
# 700 W (the first run of this phase); the split is byte-equal to the JAX
# package's (tests/test_torch_split.py)
CLI_V_MIN = {"basic": 0.3, "advanced": 0.15}
CLI_WARM_DROP = 0.05

# The JAX package's results.csv columns (`Scenario.to_dataframe()` of a
# scenario with a method, then `random_state` and `scenario_id`); the card's
# machine has no JAX, so tests/test_torch_cli.py holds this list to it
RESULTS_COLUMNS = [
    "scenario_name", "short_scenario_name", "dataset_name", "train_data_samples_count",
    "test_data_samples_count", "partners_count", "dataset_fraction_per_partner",
    "samples_split_description", "nb_samples_used", "final_relative_nb_samples",
    "multi_partner_learning_approach", "aggregation", "partner_shards", "slot_bucketing",
    "epoch_count", "minibatch_count", "gradient_updates_per_pass_count", "is_early_stopping",
    "mpl_test_score", "mpl_nb_epochs_done", "learning_computation_time_sec",
    "contributivity_method", "contributivity_scores", "contributivity_stds",
    "computation_time_sec", "first_characteristic_calls_count", "partner_id",
    "dataset_fraction_of_partner", "contributivity_score", "contributivity_std",
    "random_state", "scenario_id"]


@contextlib.contextmanager
def watched_cli(folder: Path):
    """Inside the block: the working directory is `folder`, the CLI's
    console log goes to `folder/console.log`, every `Scenario.run()` is
    timed (its scenario kept) and every weights file loaded is kept. The
    logger's handlers are closed and removed after."""
    runs, loads = [], []
    run, load = Scenario.run, approaches.load_params_npz

    def timed_run(sc):
        t0 = time.perf_counter()
        out = run(sc)
        torch.cuda.synchronize()
        runs.append((sc, time.perf_counter() - t0))
        return out

    def kept_load(path, like, device):
        params = load(path, like, device)
        loads.append((Path(path), params))
        return params

    cwd = os.getcwd()
    Scenario.run, approaches.load_params_npz = timed_run, kept_load
    try:
        with open(folder / "console.log", "w") as console, contextlib.redirect_stdout(console):
            os.chdir(folder)
            yield runs, loads
    finally:
        os.chdir(cwd)
        Scenario.run, approaches.load_params_npz = run, load
        logger = logging.getLogger("mplc_tpu_torch")
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def cli_experiment(folder: Path, name: str, **fields) -> tuple[int, Path]:
    """The CLI on the config CLI_GRID.format(name=name, **fields) in
    `folder`: its exit code and its experiment folder."""
    (folder / f"{name}.yml").write_text(CLI_GRID.format(name=name, **fields))
    rc = cli_main(["-f", f"{name}.yml", "--device", DEVICE])
    if rc != 0:
        # the CLI logged its traceback to the console log: show its end
        sys.stdout.flush()
        sys.__stdout__.write((folder / "console.log").read_text()[-4000:])
    found = sorted((folder / constants.EXPERIMENTS_FOLDER_NAME).glob(f"{name}_*"))
    check(rc == 0 and len(found) == 1, f"the CLI on {name}.yml exited {rc}")
    return rc, found[0]


def phase_cli(card, smi: str) -> dict:
    """(a) The grid through the CLI; (b) a warm start from (a)'s first final
    weights; (c) seconds a scenario, peak memory, K1's launches by batch
    width and whether the graphs were drawn."""
    with tempfile.TemporaryDirectory() as tmp, \
            knob(constants.SYNTH_SCALE_ENV, str(SCALE)), knob(constants.SYNTH_NOISE_ENV, str(NOISE)):
        folder = Path(tmp)
        recon_kernel.launches = recon_kernel.launches_bf16 = 0
        recon_kernel.launch_widths = {}
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with watched_cli(folder) as (runs, _):
            _, exp = cli_experiment(folder, "cli_grid", init="~", advanced=CLI_ADVANCED,
                                    epochs=2, methods=CLI_METHODS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches, bf16 = recon_kernel.launches, recon_kernel.launches_bf16
        widths = dict(sorted(recon_kernel.launch_widths.items()))
        df = pd.read_csv(exp / "results.csv")
        scores = df[["mpl_test_score", "contributivity_score", "contributivity_std"]].to_numpy()
        folders = sorted(exp.glob("scenario_*"))
        parts = ("model/mnist_final_weights.npz", "coalition_cache.json", "history_data.p")
        graphs = all((f / "graphs" / "data_distribution.png").exists() for f in folders)
        print(f"[cli] `python3 -m mplc_tpu_torch.main` on a grid of {len(runs)} scenarios "
              f"(MNIST CNN, 4 partners, basic stratified and advanced splits, GTG-Shapley and "
              f"Shapley values): {wall:.2f} s, dry runs included; seconds a scenario "
              f"{[round(s, 2) for _, s in runs]}; peak memory {(peak - base) / 2 ** 30:.2f} GiB "
              f"above the phase's start; results.csv {df.shape[0]} rows x {df.shape[1]} columns; "
              f"test scores {df.groupby('scenario_id')['mpl_test_score'].first().round(4).tolist()}; "
              f"partners' training rows {[[len(p.x_train) for p in sc.partners_list] for sc, _ in runs]}; "
              f"graphs {'drawn' if graphs else 'skipped (no matplotlib)'}")
        for method, group in df.groupby("contributivity_method", sort=False):
            print(f"[cli] {method}: {np.round(group['contributivity_score'].to_numpy(), 4).tolist()}")
        print(f"[cli] launches {recon_kernel.KERNEL} {launches}, {recon_kernel.KERNEL_BF16} {bf16};"
              f" {recon_kernel.KERNEL} launches by batch width {json.dumps(widths)}")
        check(list(df.columns) == RESULTS_COLUMNS, f"results.csv columns {list(df.columns)}")
        check(len(df) == 2 * 2 * 4 and len(runs) == 2,
              f"results.csv has {len(df)} rows from {len(runs)} scenarios, not 16 from 2")
        check(bool(np.isfinite(scores).all()), "a score in results.csv is not finite")
        firsts = df.groupby("scenario_id").first()
        bounds = [CLI_V_MIN["advanced" if d.startswith("[") else "basic"]
                  for d in firsts["samples_split_description"]]
        check(bool((firsts["mpl_test_score"].to_numpy() > bounds).all()),
              f"a scenario's test score is not above its bound {CLI_V_MIN}")
        check(launches > 0, "the CLI never launched K1")
        check(bf16 == 0, "the fp32 CLI launched K1-bf16")
        check(len(folders) == 2, f"{len(folders)} scenario folders, not 2: a dry run wrote one")
        check(all((f / part).exists() for f in folders for part in parts),
              "a scenario folder lacks its final weights, coalition cache or history")
        check((exp / "info.log").exists() and (exp / "debug.log").exists(),
              "the experiment folder lacks info.log or debug.log")

        # K1 on the CLI's stream (the first scenario's recording), against its
        # plain version: the 15 coalitions of 4 partners and the empty one
        recon = runs[0][0].contributivity_list[0]._reconstructor()
        subsets = powerset_order(4) + [()]
        masks = torch.from_numpy(recon.engine._coalition_arrays(subsets)).to(DEVICE)
        wn2 = recon_kernel.normalized_round_weights(masks, recon._weights).reshape(len(subsets), -1)
        entry = kernel_entry(recon_kernel.KERNEL, wn2.contiguous(), recon._d2, recon._init,
                             launches, card, timed=False)
        print(f"[cli] {recon_kernel.KERNEL} on the CLI's stream {entry['shape']}: max abs err "
              f"against its plain version {entry['max_abs_err']:.3g}")

        # (b) the warm start
        first = folders[0] / parts[0]
        cold = float(df.loc[df["scenario_id"] == 0, "mpl_test_score"].iloc[0])
        with watched_cli(folder) as (warm_runs, loads):
            _, warm = cli_experiment(folder, "cli_warm", init=f"['{first}']", advanced="",
                                     epochs=1, methods="")
        wdf = pd.read_csv(warm / "results.csv")
        with np.load(first) as f:
            stored = [f[f"leaf_{i}"] for i in range(len(f.files) - 1)]
        (path, params), = loads
        leaves = approaches._flatten(params)
        same = (path == first and len(leaves) == len(stored)
                and all(t.device.type == torch.device(DEVICE).type
                        and torch.equal(t.cpu(), torch.from_numpy(a)) for t, a in zip(leaves, stored)))
        score = float(wdf["mpl_test_score"].iloc[0])
        print(f"[cli] warm start from {first.relative_to(folder)}: {len(leaves)} tensors loaded "
              f"on {leaves[0].device}, bit-equal to the file: {same}; 1 epoch in "
              f"{warm_runs[0][1]:.2f} s, test score {score:.4f} (the cold scenario's "
              f"{cold:.4f}); on {smi}")
        check(same, "the warm start's weights on the card differ from the file")
        check(len(wdf) == 1 and list(wdf.columns) == RESULTS_COLUMNS[:21] + RESULTS_COLUMNS[-2:],
              "the warm start's results.csv is not one row of the method-less columns")
        check(score >= cold - CLI_WARM_DROP,
              f"the warm start scores {score:.4f}, below {cold:.4f} - {CLI_WARM_DROP}")
    return {"launches": launches, "widths": widths, "seconds": wall}


# The obs phase: the main path traced, its JSONL converted, a profiled
# reconstruction window, the sweep's collected report, a flight dump
OBS_PROFILE_COALITIONS = 128    # two K1 launches at B = 64
OBS_TOP_KERNELS = 10


def obs_main_path(sl) -> tuple[dict, list, Path]:
    """(a): the main path again, traced to a JSONL file and collected, with
    K1's launch counts reset just before; gated against the slice phase's
    values and against K1's launch counts. Returns its path entry, the
    records and the JSONL file (inside a folder the caller removes)."""
    jsonl = Path(tempfile.mkdtemp(prefix="mplc_obs_")) / "main_path.jsonl"
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    t0 = time.perf_counter()
    with knob(trace.TRACE_FILE_ENV, str(jsonl)), trace.collect() as records:
        sc, gtg, exact = main_path()
    wall = time.perf_counter() - t0
    trace._sink_file()  # the env is restored: closes the sink, the file is whole
    launches, widths = recon_kernel.launches, dict(sorted(recon_kernel.launch_widths.items()))
    recon = exact._reconstructor()
    values = np.array([recon.values[s] for s in powerset_order(PARTNERS)])
    rep = report.sweep_report(records)
    print(report.format_report(rep))
    print(f"[obs] main path traced: {wall:.2f} s (the slice's untraced {sl['seconds']:.2f} s), "
          f"{len(records)} records; launches {recon_kernel.KERNEL} {launches}, by width "
          f"{json.dumps(widths)}")
    check(bool(np.array_equal(values, sl["values"]) and np.array_equal(exact.contributivity_scores, sl["sv"])
               and np.array_equal(gtg.contributivity_scores, sl["gtg"])
               and sc.mpl.history.score == sl["score"]),
          "the traced main path's values differ from the slice's")
    check(launches > 0 and recon_kernel.launches_bf16 == 0,
          "the traced main path did not launch K1 alone")
    r = rep["reconstruction"]
    check(r["recon_batches"] == launches,
          f"the report counts {r['recon_batches']} reconstruction batches, K1 launched {launches}")
    by_width: dict = {}
    for rec in records:
        if rec["name"] == "engine.batch" and rec["attrs"].get("eval_only"):
            w = rec["attrs"]["width"]
            by_width[w] = by_width.get(w, 0) + 1
    check(by_width == widths, f"eval-only batches by width {by_width}, K1's launches {widths}")
    check(r["reconstructions"] == recon.reconstructions,
          f"the report counts {r['reconstructions']} reconstructions, the evaluator "
          f"{recon.reconstructions}")
    m = rep["memo"]
    check(m["hits"] + m["misses"] == m["requested"], f"memo {m}")
    by_id = {rec["id"]: rec for rec in records}
    for rec in records:
        check(rec["name"] in trace.SPAN_REGISTRY, f"unregistered record {rec['name']}")
        if rec["name"] in ("engine.dispatch", "engine.harvest"):
            want = "recon.record" if rec["attrs"].get("recording") else "engine.evaluate"
            parent = by_id.get(rec["parent"], {}).get("name")
            check(parent == want, f"a {rec['name']} record's parent is {parent}, not {want}")
    spans = [rec for rec in records if rec["name"] == "contributivity"]
    check([(rec["attrs"]["method"], rec["dur"]) for rec in spans]
          == [(c.name, c.computation_time_sec) for c in (gtg, exact)],
          "the contributivity spans are not the methods' timers")
    return {"launches": launches, "widths": widths, "seconds": wall}, records, jsonl


def obs_chrome(records: list, jsonl: Path) -> None:
    """(b): the JSONL converted to Chrome trace-event JSON."""
    summary = chrome_trace.convert(str(jsonl))
    with open(summary["out"]) as f:
        doc = json.load(f)
    slices = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
    print(f"[obs] chrome trace {Path(summary['out']).name}: {summary['events']} events from "
          f"{summary['records']} records, {summary['torn_lines']} torn lines")
    check(summary["torn_lines"] == 0, "the JSONL has a torn line")
    check(summary["records"] == len(records) and slices == len(records)
          and summary["events"] >= len(records),
          "the Chrome trace does not hold an event for every record")


def obs_profile(sl, kernels: list) -> None:
    """(c): a profiled reconstruction window, K1's kernel events counted."""
    subsets = powerset_order(PARTNERS)[:OBS_PROFILE_COALITIONS]
    recon = ReconstructionEvaluator(sl["recon"].engine, sl["recon"].recorded)
    launches = recon_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as prof:
            recon.evaluate(subsets)
            torch.cuda.synchronize()
        launched = recon_kernel.launches - launches
        summary = analyze_trace.summarize(prof.path)
    k1 = {n: k for n, k in summary["kernels"].items() if "recon_matmul_kernel" in n}
    profiled = sum(k["count"] for k in k1.values())
    k1_ms = sum(k["us"] for k in k1.values()) / max(profiled, 1) / 1e3
    event_ms = next(e["ms"] for e in kernels if e["name"] == recon_kernel.KERNEL)
    d = summary["device"]
    print(f"[obs] profiled window: {len(subsets)} coalitions, {launched} K1 launches, "
          f"{profiled} K1 kernel events ({', '.join(k1)}); K1 {k1_ms:.4f} ms profiled "
          f"against {event_ms:.4f} ms from CUDA events at B = 64 ([kernels]); device busy "
          f"{d['busy_us'] / 1e3:.3f} ms of a {summary['window_us'] / 1e3:.3f} ms window "
          f"({d['busy_share']:.4f}), {d['events']} device events on "
          f"{len(summary['streams'])} streams")
    for name, k in list(summary["kernels"].items())[:OBS_TOP_KERNELS]:
        print(f"[obs]   {k['us'] / 1e3:9.3f} ms x{k['count']:<4d} {name[:100]}")
    check(summary["kind"] == "cuda", "the profile holds no CUDA activity")
    check(launched == 2, f"the profiled window launched K1 {launched} times, not 2")
    check(profiled == launched,
          f"the profiler saw K1's kernel {profiled} times, its counter rose {launched}")


def obs_sweep(sweep: dict) -> None:
    """(d): the sweep phase's run, collected."""
    rep = report.sweep_report(sweep["records"])
    eng = sweep["scenario"]._charac_engine
    hw = sweep["metrics"]["gauges"].get("engine.device_mem_high_water_bytes")
    print(report.format_report(rep))
    print(f"[obs] sweep: {rep['batches']['count']} batches, {len(eng.batch_log)} in the "
          f"batch log; memory high water {hw} bytes, peak {sweep['peak']} bytes")
    check(rep["batches"]["count"] == len(eng.batch_log),
          "the sweep report's batches differ from the engine's batch log")
    check(rep["batches"]["coalitions"] == 31, f"{rep['batches']['coalitions']} coalitions, not 31")
    check(hw is not None and 0 < hw <= sweep["peak"],
          f"the memory high water {hw} is not in (0, {sweep['peak']}]")


def obs_flight() -> None:
    """(e): one flight-recorder dump."""
    with tempfile.TemporaryDirectory() as tmp, knob(flight.FLIGHT_DIR_ENV, tmp):
        path = flight.dump("chip_smoke")
        files = list(Path(tmp).iterdir())
        with open(path) as f:
            doc = json.load(f)
    print(f"[obs] flight dump: {len(doc['ring_records'])} ring records (ring of "
          f"{trace._flight_ring.maxlen}), {len(doc['metrics']['counters'])} counters")
    check(files == [Path(path)], f"the flight dump wrote {files}")
    check(0 < len(doc["ring_records"]) <= trace._flight_ring.maxlen,
          "the flight dump's ring is empty or larger than the ring")
    check(set(doc["metrics"]) == {"counters", "gauges", "histograms"},
          "the flight dump lacks a metrics snapshot")


def phase_obs(sl, sweep: dict, kernels: list) -> dict:
    path, records, jsonl = obs_main_path(sl)
    try:
        obs_chrome(records, jsonl)
    finally:
        for f in jsonl.parent.iterdir():
            f.unlink()
        jsonl.parent.rmdir()
    obs_profile(sl, kernels)
    obs_sweep(sweep)
    obs_flight()
    return path


# The ladder phase: each run builds a fresh Scenario (its engine reads the
# knobs once). Backoff 0 throughout
LADDER_PLAN = "transient@batch1,transient@harvest3,oom@batch5"
LADDER_END_PLAN = "oom@batch2,oom@batch3"
LADDER_END_COALITIONS = 8
LADDER_SWEEP_PLAN = "transient@batch2,oom@harvest3"
LADDER_OOM_COALITIONS = 64     # one K1 batch at full width, two halved


@contextlib.contextmanager
def ladder_knobs(plan: str | None, **extra):
    """The fault plan (None: no plan) and backoff 0, plus `extra` knobs
    (constants' env names to values), inside the block."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(knob(constants.RETRY_BACKOFF_ENV, "0"))
        if plan is None:
            old = os.environ.pop(constants.FAULT_PLAN_ENV, None)
            stack.callback(lambda: old is not None and os.environ.__setitem__(
                constants.FAULT_PLAN_ENV, old))
        else:
            stack.enter_context(knob(constants.FAULT_PLAN_ENV, plan))
        for name, value in extra.items():
            stack.enter_context(knob(name, value))
        yield


def ladder_counters() -> dict:
    snap = metrics.snapshot()["counters"]
    return {k: int(snap.get(f"engine.{k}", 0)) for k in (
        "faults_injected", "retries", "cap_halvings", "cpu_degraded_batches",
        "cpu_degraded_coalitions", "ladder_exhausted")}


def value_gap(tag: str, got: np.ndarray, want: np.ndarray, n_test: int, what: str) -> int:
    """How many values part and the largest gap, printed; gated within one
    test sample. Returns the count."""
    parted = int((got != want).sum())
    gap = float(np.abs(got - want).max()) if len(got) else 0.0
    print(f"[{tag}] {what}: {len(got) - parted} of {len(got)} bit-equal, {parted} part, "
          f"largest gap {gap:.6g} (one test sample {1 / n_test:.6g})")
    check(gap <= 1.0 / n_test + 1e-7, f"{what}: a value parts by more than one test sample")
    return parted


def prepared(sc: Scenario) -> Scenario:
    """`sc`'s partners made and split, as `Scenario.run` makes them before
    its fit (the ladder's runs need the engine, not the fit)."""
    sc.instantiate_scenario_partners()
    sc.split_data()
    sc.compute_batch_sizes()
    sc.data_corruption()
    return sc


def ladder_main_path(sl) -> dict:
    """(a) The main path under LADDER_PLAN, K1's counts reset just before:
    the recording retried (batch 1), a GTG batch re-dispatched at harvest
    (batch 3), an OOM at batch 5's dispatch halving the evaluator's width
    to 32. Values against the slice's."""
    metrics.reset()
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    t0 = time.perf_counter()
    with ladder_knobs(LADDER_PLAN), trace.collect() as records:
        sc, gtg, exact = main_path()
    wall = time.perf_counter() - t0
    launches = recon_kernel.launches
    widths = dict(sorted(recon_kernel.launch_widths.items()))
    got = ladder_counters()
    recon = exact._reconstructor()
    values = np.array([recon.values[s] for s in powerset_order(PARTNERS)])
    n_test = len(sc.dataset.x_test)
    print(f"[ladder] (a) main path under {LADDER_PLAN}: {wall:.2f} s (the slice's "
          f"{sl['seconds']:.2f} s); counters {json.dumps(got)}; launches {recon_kernel.KERNEL} "
          f"{launches}, by batch width {json.dumps(widths)} (the slice's "
          f"{json.dumps(sl['widths'])})")
    check(got["faults_injected"] == 3 and got["retries"] == 2 and got["cap_halvings"] == 1,
          f"the plan's faults were not recovered as planned: {got}")
    check(got["cpu_degraded_batches"] == 0, "the main path under a plan took the CPU rung")
    check(recon.engine._cap_halvings == 1 and recon._chunk() == 32,
          "the evaluator's width was not halved")
    check(launches > 0 and recon_kernel.launches_bf16 == 0, "K1 did not launch alone")
    check(widths.get(32, 0) > 0 and 64 not in widths, f"K1 never launched at B = 32: {widths}")
    check_same_recording(recon.recorded, sl["recon"].recorded, "ladder")
    check(sc.mpl.history.score == sl["score"], "the fit's score differs from the slice's")
    parted = value_gap("ladder", values, sl["values"], n_test,
                       "(a) v(S) against the slice's")
    check(bool(np.array_equal(gtg.contributivity_scores, sl["gtg"])),
          "GTG-Shapley (its batches all narrower than 32) differs from the slice's")
    events = [r["attrs"] for r in records if r["name"] in ("engine.retry", "engine.degrade")]
    print(f"[ladder] (a) ladder events {json.dumps(events)}")
    return {"launches": launches, "widths": widths, "seconds": wall, "parted": parted}


def ladder_end(sl) -> dict:
    """(b) The ladder's end on the card: the slice's configuration under
    LADDER_END_PLAN and one cap halving at most. Batch 1 is the recording
    (bit-equal to the slice's); batch 2 OOMs at dispatch (B = 8) and halves
    the cap, batch 3 (B = 8 at the halved cap of 32) OOMs again, and the
    ladder ends in the classified LadderExhaustedError with its flight
    dump: no CPU rung, no K1 launch."""
    metrics.reset()
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    subsets = powerset_order(PARTNERS)[:LADDER_END_COALITIONS]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            ladder_knobs(LADDER_END_PLAN, **{constants.MAX_CAP_HALVINGS_ENV: "1",
                                             flight.FLIGHT_DIR_ENV: tmp}), \
            trace.collect() as records:
        sc = prepared(mnist_scenario([]))
        recon = Contributivity(sc)._reconstructor()
        try:
            recon.evaluate(subsets)
            err = None
        except faults.LadderExhaustedError as e:
            err = e
        dumps = [p.name for p in Path(tmp).iterdir()]
    wall = time.perf_counter() - t0
    got = ladder_counters()
    degrades = [r["attrs"]["action"] for r in records if r["name"] == "engine.degrade"]
    print(f"[ladder] (b) the ladder's end under {LADDER_END_PLAN}, at most 1 halving: "
          f"{wall:.2f} s; {type(err).__name__}: {str(err)[:160]}; counters {json.dumps(got)}; "
          f"degrade events {degrades}; flight dumps {dumps}; launches "
          f"{recon_kernel.launches} / {recon_kernel.launches_bf16}")
    check_same_recording(recon.recorded, sl["recon"].recorded, "ladder")
    check(err is not None and err.mode == "1d" and err.halvings == 2
          and not faults.is_transient(err) and not faults.is_oom(err)
          and isinstance(err.__cause__, torch.cuda.OutOfMemoryError),
          f"the ladder did not end in a classified, permanent error: {err!r}")
    check(degrades == ["halve_cap", "ladder_exhausted"] and not recon.engine._cpu_degraded,
          f"the ladder's rungs: {degrades}")
    check(got["ladder_exhausted"] == 1 and got["cpu_degraded_batches"] == 0
          and got["cpu_degraded_coalitions"] == 0, f"the ladder's counters: {got}")
    check(len(dumps) == 1 and err.postmortem_path is not None
          and Path(err.postmortem_path).name == dumps[0], f"the flight dump: {dumps}")
    check(recon_kernel.launches == 0 and recon_kernel.launches_bf16 == 0
          and len(recon.values) == 1, "a batch past the ladder's end launched or stored")
    return {"seconds": wall}


def ladder_sweep(sweep: dict) -> dict:
    """(c) The sweep phase's run under LADDER_SWEEP_PLAN: the first
    width-3 batch retried at dispatch, the second OOM at its harvest and
    its 4 coalitions trained again at width 4 (cap 8)."""
    metrics.reset()
    t0 = time.perf_counter()
    with ladder_knobs(LADDER_SWEEP_PLAN), trace.collect() as records:
        sc = mnist_scenario(SWEEP_METHODS, SWEEP_PARTNERS)
        sc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = sc._charac_engine
    got = ladder_counters()
    subsets = powerset_order(SWEEP_PARTNERS)
    values = np.array([eng.charac_fct_values[s] for s in subsets])
    ref_eng = sweep["scenario"]._charac_engine
    ref = np.array([ref_eng.charac_fct_values[s] for s in subsets])
    batches = [(b["kind"], b["width"], b["slot_count"], b["coalitions"]) for b in eng.batch_log]
    rep = report.sweep_report(records)
    print(f"[ladder] (c) sweep under {LADDER_SWEEP_PLAN}: {wall:.2f} s; counters "
          f"{json.dumps(got)}; batches {batches}; resilience {json.dumps(rep['resilience'])}")
    check(got["faults_injected"] == 2 and got["retries"] == 1 and got["cap_halvings"] == 1
          and got["cpu_degraded_batches"] == 0, f"the sweep's plan ran otherwise: {got}")
    check(eng.first_charac_fct_calls_count == 31, "a coalition was stored twice")
    check(batches == [("single", 8, None, 5), ("multi", 16, 3, 16), ("multi", 4, 3, 4),
                      ("multi", 8, 5, 6)], f"the sweep's batches under the plan: {batches}")
    parted = value_gap("ladder", values, ref, len(sc.dataset.x_test),
                       "(c) v(S) against the sweep phase's")
    return {"seconds": wall, "parted": parted}


def slot_batch(eng, group: list, sync_errors: bool = False) -> tuple:
    """One slot batch of the width-3 bucket (`group`) dispatched on `eng`'s
    pipeline, under `torch.cuda.set_sync_debug_mode("error")` when
    `sync_errors`: (accuracies, dispatch seconds, harvest seconds, peak
    bytes allocated above the batch's start)."""
    pipe = eng._slot_pipe(3)
    coal_host = torch.from_numpy(eng._coalition_arrays(group, 3))
    generators = [eng.coalition_generator(s) for s in group]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error" if sync_errors else 0)
    try:
        fetch = pipe.dispatch_async(upload(coal_host, DEVICE), generators, eng.stacked,
                                    eng.val, eng.test, coal_host=coal_host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dispatch_s = time.perf_counter() - t0
    accs, _ = fetch()
    harvest_s = time.perf_counter() - t0 - dispatch_s
    return accs, dispatch_s, harvest_s, torch.cuda.max_memory_allocated() - base


def ladder_dispatch(sweep: dict, card_mem: int) -> dict:
    """(d) The sweep phase's dispatch/harvest split (`obs.sweep_report`),
    then one slot batch (16 coalitions at 3 slots) dispatched under
    `torch.cuda.set_sync_debug_mode("error")`: no synchronizing call
    between dispatch and harvest, its values bit-equal to the sweep's.
    (f) rides on it: that batch's peak memory and a batch of 8's give the
    measured bytes a coalition (their slope) and a batch's fixed bytes
    (the intercept), printed beside the footprint model and the cap."""
    eng = sweep["scenario"]._charac_engine
    w = report.sweep_report(sweep["records"])["wallclock"]
    print(f"[ladder] (d) the sweep phase's run: {sweep['seconds']:.2f} s; evaluate "
          f"{w['evaluate_s']:.2f} s = prep {w['prep_s']:.3f} + dispatch "
          f"{w['dispatch_s']:.2f} + harvest {w['harvest_s']:.2f}")
    multis = [s for s in powerset_order(SWEEP_PARTNERS) if len(s) > 1]
    group = [s for s in multis if eng._slot_width(len(s)) == 3][:16]
    accs, dispatch_s, harvest_s, peak16 = slot_batch(eng, group, sync_errors=True)
    want = np.array([eng.charac_fct_values[s] for s in group])
    print(f"[ladder] (d) one slot batch (16 coalitions, 3 slots) under sync debug mode "
          f"'error': dispatch {dispatch_s:.3f} s with no synchronizing call, then harvest "
          f"waited {harvest_s:.3f} s; {int((accs == want).sum())} of 16 values bit-equal "
          f"to the sweep's")
    check(bool(np.array_equal(accs, want)), "the batch dispatched under sync errors differs")
    accs8, _, _, peak8 = slot_batch(eng, group[:8])
    check(bool(np.array_equal(accs8, want[:8])), "the batch of 8 differs from the sweep")
    # (f) footprint and cap
    slope = (peak16 - peak8) / 8
    fixed = peak16 - 16 * slope
    per, fix = eng._per_coalition_bytes(3), eng._batch_fixed_bytes(3)
    ratios = {b: (fix + b * per) / peak for b, peak in ((8, peak8), (16, peak16))}
    caps = {k: eng._autotuned_cap(k) for k in (3, 5)}
    print(f"[ladder] (f) 3 slots: modeled {per} bytes a coalition and {fix} fixed; measured "
          f"peaks {peak8} (8 coalitions) and {peak16} (16) above the batch's start: "
          f"{slope:.0f} a coalition and {fixed:.0f} fixed; modeled / measured peak "
          f"{json.dumps({b: round(r, 4) for b, r in ratios.items()})}; device memory "
          f"planned with {eng._device_hbm_bytes()} bytes of {card_mem}; autotuned cap by "
          f"slot width {json.dumps(caps)}")
    check(all(0.5 <= r <= 2.0 for r in ratios.values()),
          f"the footprint model is off the measured peaks by more than 2x: {ratios}")
    check(all(1 <= c <= constants.MAX_COALITIONS_PER_DEVICE_BATCH for c in caps.values()),
          f"autotuned caps {caps}")
    return {"split": w, "peaks": (peak8, peak16), "modeled": (per, fix), "caps": caps}


def allocated_peak(recon, subsets) -> tuple[int, np.ndarray]:
    """(the peak bytes allocated, values) of `recon` valuing `subsets` from
    an emptied cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    values = recon.evaluate(subsets)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), values


def real_oom_child() -> dict:
    """(e)'s work, in a process of its own (`--real-oom`), whose allocator
    holds nothing but this part's tensors and runs with expandable segments
    (PYTORCH_CUDA_ALLOC_CONF), so that under a cap it needs the bytes a run
    allocates and no free block as large as its next tensor. The slice's
    configuration is recorded afresh; its evaluator's peak allocated memory
    is measured at B = 64 (after a first run that warms the libraries'
    workspaces) and at B = 32; the allocator is capped halfway between
    (`set_per_process_memory_fraction`); a fresh evaluator at full width
    then values the same coalitions."""
    subsets = powerset_order(PARTNERS)[:LADDER_OOM_COALITIONS]
    total = torch.cuda.get_device_properties(0).total_memory
    with ladder_knobs(None):
        c = Contributivity(prepared(mnist_scenario([])))
        eng, rec = c.engine, c._reconstructor().recorded
        allocated_peak(ReconstructionEvaluator(eng, rec), subsets)
        full, ref = allocated_peak(ReconstructionEvaluator(eng, rec), subsets)
        eng._cap_halvings = 1
        half, _ = allocated_peak(ReconstructionEvaluator(eng, rec), subsets)
        eng._cap_halvings = 0
        limit = (full + half) / 2
        metrics.reset()
        recon_kernel.launch_widths = {}
        recon = ReconstructionEvaluator(eng, rec)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(limit / total)
        try:
            with trace.collect() as records:
                values = recon.evaluate(subsets)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            torch.cuda.empty_cache()
    return {"full": full, "half": half, "limit": limit, "total": total,
            "counters": ladder_counters(), "halvings": eng._cap_halvings,
            "degrades": [r["attrs"] for r in records if r["name"] == "engine.degrade"],
            "widths": dict(sorted(recon_kernel.launch_widths.items())),
            "values": values.tolist(), "ref": ref.tolist(),
            "n_test": len(eng.scenario.dataset.x_test)}


def ladder_real_oom() -> dict:
    """(e) A real OOM (`real_oom_child`, in a process this one starts and
    waits for): the evaluator at full width must meet the card's own
    `torch.cuda.OutOfMemoryError` in its first batch, take one rung, finish
    at B = 32 and give the values of the run at B = 64. The cap is the
    child's alone and ends with it."""
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--real-oom"],
                         capture_output=True, text=True, env=env, timeout=600)
    check(out.returncode == 0, f"(e)'s process failed ({out.returncode}): "
                               f"{out.stderr[-2000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    got, widths = r["counters"], {int(k): v for k, v in r["widths"].items()}
    print(f"[ladder] (e) real OOM, in its own process ({time.perf_counter() - t0:.2f} s): "
          f"peak allocated {r['full']} bytes at B = 64, {r['half']} at B = 32; limit "
          f"{r['limit']:.0f} bytes ({r['limit'] / r['total']:.6f} of {r['total']}); counters "
          f"{json.dumps(got)}; K1 by batch width {json.dumps(widths)}; degrade "
          f"{json.dumps(r['degrades'])}")
    check(r["full"] - r["half"] >= 32 * 2 ** 20,
          f"the evaluator's peaks at B = 64 ({r['full']}) and 32 ({r['half']}) do not separate")
    check(got["faults_injected"] == 0 and got["cap_halvings"] == 1
          and got["cpu_degraded_batches"] == 0 and r["halvings"] == 1,
          f"the real OOM was not recovered by one rung: {got}")
    check(len(r["degrades"]) == 1 and "CUDA out of memory" in r["degrades"][0]["error"],
          "the rung was not taken on the card's own OutOfMemoryError")
    # the OOM may meet the evaluation after K1's full-width launch
    check(widths.get(32) == 2 and set(widths) <= {32, 64} and widths.get(64, 0) <= 1,
          f"the recovered batches ran at {widths}, not twice at B = 32")
    parted = value_gap("ladder", np.array(r["values"]), np.array(r["ref"]), r["n_test"],
                       "(e) v(S) after the real OOM against B = 64")
    return {**{k: r[k] for k in ("full", "half", "limit")}, "parted": parted}


def phase_ladder(sl, sweep: dict) -> dict:
    """The fault ladder and the engine's batch control on the card: (a)
    the main path under a plan, (b) the ladder's end, (c) the sweep under a
    plan, (d) a dispatch with no sync, (e) a real OOM, (f) footprint and
    cap (printed with (d))."""
    t0 = time.perf_counter()
    card_mem = torch.cuda.get_device_properties(0).total_memory
    path = rung_free("ladder (a)", ladder_main_path, sl)
    rung_free("ladder (b)", ladder_end, sl)
    rung_free("ladder (c)", ladder_sweep, sweep)
    rung_free("ladder (d)", ladder_dispatch, sweep, card_mem)
    rung_free("ladder (e)", ladder_real_oom)
    print(f"[ladder] all parts passed in {time.perf_counter() - t0:.2f} s")
    return path


def rung_free(tag: str, fn, *args):
    """`fn(*args)`, gated on the CPU-degraded batch counter not moving: a
    CUDA engine has no CPU rung."""
    before = metrics.counter("engine.cpu_degraded_batches").value
    out = fn(*args)
    after = metrics.counter("engine.cpu_degraded_batches").value
    check(after == before, f"[{tag}] took the CPU rung ({before} -> {after} batches)")
    return out


# The width phase: the gradient-call width rule (models/zoo.py
# `grad_call_width`, mpl/engine.py `MplTrainer._model_grads`) on the card. A
# sample of the 5-partner sweep's coalitions, every bucket's (singles, the
# 3-slot and the 5-slot buckets), requested in calls of WIDTH_REQUESTS
# coalitions, then the sweep resumed from a cache of its first
# WIDTH_RESUMED coalitions (the remainder trains at its own widths)
WIDTH_SAMPLE = [(0,), (4,), (0, 1), (1, 3), (0, 2, 4), (2, 3, 4), (0, 1, 2, 3),
                (0, 1, 2, 3, 4)]
WIDTH_REQUESTS = (1, 2, 3)
WIDTH_RESUMED = 20


def width_requests(tag: str, sc, full: dict) -> dict:
    """Each sample coalition of the game `sc` (a prepared scenario),
    requested on a fresh engine in requests of 1, 2 and 3 coalitions of
    one bucket, and every coalition after a resume from a cache of the
    first WIDTH_RESUMED: each must be bit-equal to `full` (the full
    sweep's values). Returns {request: seconds}."""
    out = {}
    subsets = powerset_order(SWEEP_PARTNERS)
    for n in WIDTH_REQUESTS:
        eng = CharacteristicEngine(sc)
        buckets: dict = {}
        for s in WIDTH_SAMPLE:
            buckets.setdefault(0 if len(s) == 1 else eng._slot_width(len(s)), []).append(s)
        t0 = time.perf_counter()
        for group in buckets.values():
            for i in range(0, len(group), n):
                eng.evaluate(group[i:i + n])
        out[f"requests of {n}"] = time.perf_counter() - t0
        same = [numerics.float_bits(eng.charac_fct_values[s]) == numerics.float_bits(full[s])
                for s in WIDTH_SAMPLE]
        widths = [(b["slot_count"] if b["kind"] == "multi" else "single", b["width"],
                   b["coalitions"]) for b in eng.batch_log]
        print(f"[width] {tag}: {len(WIDTH_SAMPLE)} coalitions in requests of {n}: "
              f"{sum(same)} of {len(same)} v(S) bit-equal to the full sweep's; batches "
              f"(slots, width, coalitions) {widths} in {out[f'requests of {n}']:.2f} s")
        check(all(same), f"[width] {tag}: a coalition requested {n} at a time parts from "
                         f"the full sweep: {[s for s, ok in zip(WIDTH_SAMPLE, same) if not ok]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "coalition_cache.json"
        part = CharacteristicEngine(sc)
        part.charac_fct_values = {(): 0.0, **{s: full[s] for s in subsets[:WIDTH_RESUMED]}}
        part.first_charac_fct_calls_count = WIDTH_RESUMED
        part.save_cache(path)
        eng = CharacteristicEngine(sc)
        eng.load_cache(path)
        t0 = time.perf_counter()
        eng.evaluate(subsets)
        out["resumed"] = time.perf_counter() - t0
    rest = subsets[WIDTH_RESUMED:]
    same = [numerics.float_bits(eng.charac_fct_values[s]) == numerics.float_bits(full[s])
            for s in subsets]
    widths = [(b["slot_count"], b["width"], b["coalitions"]) for b in eng.batch_log]
    print(f"[width] {tag}: resumed from a cache of {WIDTH_RESUMED}: {len(rest)} trained in "
          f"batches {widths} ({out['resumed']:.2f} s); {sum(same)} of {len(same)} v(S) "
          f"bit-equal to the full sweep's")
    check(sum(b["coalitions"] for b in eng.batch_log) == len(rest),
          f"[width] {tag}: the resumed sweep trained {eng.batch_log}")
    check(all(same), f"[width] {tag}: a resumed coalition parts from the full sweep: "
                     f"{[s for s, ok in zip(subsets, same) if not ok]}")
    return out


def phase_width(sweep: dict) -> None:
    """The MNIST CNN on [sweep]'s game, against [sweep]'s values, and the
    CIFAR10 CNN on [cifar10]'s training at 5 partners and 1 epoch, against
    a full sweep of its 31 coalitions made here."""
    t0 = time.perf_counter()
    seconds = {"mnist": width_requests("MNIST CNN", sweep["scenario"],
                                       sweep["scenario"]._charac_engine.charac_fct_values)}
    # one epoch, cut from [cifar10]'s two for the script's time (the
    # calls' shapes follow the step rows, which the epochs leave alone)
    sc = cifar_scenario(cifar_dataset(), [], epoch_count=1)
    sc.instantiate_scenario_partners()
    sc.split_data()
    full_eng = CharacteristicEngine(sc)
    t1 = time.perf_counter()
    full_eng.evaluate(powerset_order(SWEEP_PARTNERS))
    full_s = time.perf_counter() - t1
    batch_lines("width cifar10 sweep", full_eng)
    seconds["cifar10"] = {"full sweep": full_s, **width_requests(
        "CIFAR10 CNN", sc, full_eng.charac_fct_values)}
    print(f"[width] passed in {time.perf_counter() - t0:.2f} s; seconds "
          + json.dumps({k: {q: round(v, 2) for q, v in d.items()} for k, d in seconds.items()}))


# The devcost phase: device cost, fences, the value ledger and the audit
# the grand coalition trains on the 5-slot bucket, whose `torch.sum` over
# 5 slots the card does not fold left to right ([variants]); a 3-slot
# coalition's sum of 3 is the left-to-right fold
AUDIT_COALITION = (0, 1, 2, 3, 4)


def devcost_main_path(sl, ledger: Path) -> dict:
    """(a): the main path with the value ledger on and fences at 1/16, K1's
    counts reset just before: the ledger holds every reconstructed value,
    bit-equal to [slice]'s, K1's launches and widths are [slice]'s, the
    meter saw every coalition as eval-only."""
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    t0 = time.perf_counter()
    with knob(constants.NUMERICS_LEDGER_ENV, str(ledger)), \
            knob(constants.DEVICE_FENCE_RATE_ENV, str(1 / 16)):
        sc, gtg, exact = main_path()
    wall = time.perf_counter() - t0
    launches, widths = recon_kernel.launches, dict(sorted(recon_kernel.launch_widths.items()))
    recon = exact._reconstructor()
    values = np.array([recon.values[s] for s in powerset_order(PARTNERS)])
    led = numerics.ValueLedger.load(str(ledger))
    recon_entries = {k: e for k, e in led.entries.items() if e["source"] == "reconstruction"}
    ledger_same = sum(numerics.bits_to_float(recon_entries[numerics.ValueLedger.subset_key(s)]
                                             ["value_bits"]) == v
                      for s, v in zip(powerset_order(PARTNERS), sl["values"])
                      if numerics.ValueLedger.subset_key(s) in recon_entries)
    snap = sc._charac_engine.device_meter.snapshot()
    print(f"[devcost] (a) main path with the ledger and fences at 1/16: {wall:.2f} s (the "
          f"slice's {sl['seconds']:.2f} s); ledger {len(led.entries)} entries "
          f"({len(recon_entries)} reconstruction, {ledger_same} bit-equal to [slice]'s), "
          f"fingerprint {led.engine_fingerprint}, meta {json.dumps(led.meta)}; K1 launches "
          f"{launches} by width {json.dumps(widths)}; meter {json.dumps(snap)}; "
          f"device seconds {sc._charac_engine.device_meter.device_seconds()}")
    check(np.array_equal(values, sl["values"]), "(a) the values differ from [slice]'s")
    check(len(recon_entries) == 2 ** PARTNERS - 1 and ledger_same == 2 ** PARTNERS - 1,
          f"(a) the ledger holds {len(recon_entries)} reconstructed values, {ledger_same} "
          "of them [slice]'s")
    check(launches == sl["launches"] and widths == sl["widths"]
          and recon_kernel.launches_bf16 == 0,
          f"(a) K1 launched {launches} times by width {widths}, [slice] {sl['launches']} "
          f"by {sl['widths']}")
    check(snap["eval_coalitions"] == 2 ** PARTNERS - 1,
          f"(a) the meter saw {snap['eval_coalitions']} eval-only coalitions")
    return {"launches": launches, "widths": widths, "ledger": led}


def devcost_sweep(rate: float, ledger: Path) -> tuple:
    """(engine, records, seconds) of the 5-partner MNIST sweep's 31
    coalitions on a fresh engine of [sweep]'s game, fences at `rate`, the
    ledger written to `ledger`, collected."""
    with knob(constants.DEVICE_FENCE_RATE_ENV, str(rate)), \
            knob(constants.NUMERICS_LEDGER_ENV, str(ledger)):
        sc = mnist_scenario([], SWEEP_PARTNERS)
        sc.instantiate_scenario_partners()
        sc.split_data()
        eng = CharacteristicEngine(sc)
    t0 = time.perf_counter()
    with trace.collect() as records:
        eng.evaluate(powerset_order(SWEEP_PARTNERS))
    return eng, records, time.perf_counter() - t0


def devcost_fences(sweep: dict, card: str, ledgers: Path) -> dict:
    """(b) and (c): the sweep at fence rate 1 and at rate 0, each with its
    ledger: bit-equal values, the meter billing on fences, the report's
    device_time and compute rows; the two ledgers diffed (no drift, tau-b
    1.0)."""
    P = SWEEP_PARTNERS
    fenced, records, fenced_s = devcost_sweep(1.0, ledgers / "sweep_fenced.json")
    plain, _, plain_s = devcost_sweep(0.0, ledgers / "sweep_plain.json")
    subsets = powerset_order(P)
    a = np.array([fenced.charac_fct_values[s] for s in subsets])
    b = np.array([plain.charac_fct_values[s] for s in subsets])
    ref = np.array([sweep["scenario"]._charac_engine.charac_fct_values[s] for s in subsets])
    snap = fenced.device_meter.snapshot()
    peak = devcost.peak_flops_per_chip(card, "fp32")
    dev_s, basis = devcost.estimate_device_seconds(snap, peak)
    rep = report.sweep_report(records, peak_flops=peak,
                              hbm_bytes_per_s=devcost.hbm_bytes_per_s_per_chip(card))
    batches = [(r["attrs"]["slot_count"], r["attrs"]["width"], r["attrs"].get("device_sec"),
                r["dur"], r["attrs"].get("flops")) for r in records if r["name"] == "engine.batch"]
    for slots, width, dsec, span, fl in batches:
        print(f"[devcost] (b) batch (slots {slots}, width {width}): fenced device "
              f"{dsec:.4f} s against its host span {span:.4f} s; {fl:.4g} FLOPs counted")
    print(f"[devcost] (b) sweep at fence rate 1: {fenced_s:.2f} s, at rate 0: {plain_s:.2f} s; "
          f"meter {json.dumps(snap)}; estimate_device_seconds {dev_s:.4f} s [{basis}] "
          f"(fp32 peak {peak})")
    print("[devcost] (b) report rows: device_time " + json.dumps(rep.get("device_time"))
          + "; compute " + json.dumps(rep.get("compute")) + "; roofline "
          + json.dumps(rep.get("roofline")))
    print(report.format_report(rep))
    check(np.array_equal(a, b) and np.array_equal(a, ref),
          "(b) v(S) with fences at rate 1 differ from rate 0's or [sweep]'s")
    check(basis == "fenced" and snap["fenced_batches"] == len(fenced.batch_log),
          f"(b) the meter bills on {basis}, {snap['fenced_batches']} fenced batches")
    check(all(dsec is not None and dsec > 0 and fl for _, _, dsec, _, fl in batches),
          "(b) a batch was not fenced or not counted on the card")
    check(rep.get("device_time", {}).get("basis") == "fenced"
          and rep["compute"].get("mfu_xla") is not None,
          "(b) the report has no fenced device_time row or no mfu_xla")
    check(plain.device_meter.snapshot()["fenced_batches"] == 0, "(b) rate 0 fenced a batch")
    d = numerics.diff_ledgers(numerics.ValueLedger.load(str(ledgers / "sweep_fenced.json")),
                              numerics.ValueLedger.load(str(ledgers / "sweep_plain.json")))
    print(f"[devcost] (c) sweep ledgers, rate 1 against rate 0: comparable {d['comparable']}, "
          f"common {d['common']}, drift {d['drift']}, ulp {json.dumps(d['ulp'])}, Kendall "
          f"tau-b {d['kendall_tau']}")
    check(d["comparable"] and d["common"] == 2 ** P - 1 and not d["drift"]
          and d["kendall_tau"] == 1.0, "(c) the two sweeps' ledgers drift")
    return {"fenced_s": fenced_s, "plain_s": plain_s}


def devcost_precision_ledgers(fp32: "numerics.ValueLedger", bf16_path: Path) -> None:
    """(c): the main path's fp32 ledger against [slice bf16]'s, held to
    [precision]'s value-pair gate (JAX's bf16 bound on v(N) and on the
    median |dv|). The coalitions past the bound are counted and the worst
    named: the per-coalition bound is the JAX package's for a retrained
    game, and its own bf16 reconstruction parts from fp32 past it too
    (PERF.md, section 6)."""
    bf16 = numerics.ValueLedger.load(str(bf16_path))
    d = numerics.diff_ledgers(fp32, bf16)
    keys = list(fp32.entries)
    dv = np.array([abs(fp32.entries[k]["value"] - bf16.entries[k]["value"]) for k in keys])
    grand = numerics.ValueLedger.subset_key(range(PARTNERS))
    dv_grand = abs(fp32.entries[grand]["value"] - bf16.entries[grand]["value"])
    worst = [(sorted(i for i in range(PARTNERS) if int(keys[j], 16) >> i & 1),
              round(fp32.entries[keys[j]]["value"], 4), round(bf16.entries[keys[j]]["value"], 4))
             for j in np.argsort(-dv)[:8]]
    print(f"[devcost] (c) main path fp32 against bf16 ledgers: common {d['common']}, same "
          f"fingerprint {d['same_fingerprint']} (precision is in the fingerprint), ulp "
          f"{json.dumps(d['ulp'])}, Kendall tau-b {d['kendall_tau']}, |dv(N)| {dv_grand:.4f}, "
          f"median |dv| {float(np.median(dv)):.4f}, max |dv| {float(dv.max()):.4f}; "
          f"{int((dv > BF16_VALUE_BOUND).sum())} of {len(dv)} coalitions past "
          f"{BF16_VALUE_BOUND}, the worst (members, fp32, bf16): {worst}")
    check(d["common"] == 2 ** PARTNERS - 1 and dv_grand <= BF16_VALUE_BOUND
          and float(np.median(dv)) <= BF16_VALUE_BOUND,
          f"(c) bf16 ledger: {d['common']} common values, |dv(N)| {dv_grand}, median |dv| "
          f"{float(np.median(dv))}")


def devcost_audit(sweep: dict) -> None:
    """(d): the audit of one fenced coalition under the default reduce (a
    result, bit-equal v(S) with the audit off, torch.sum's first
    divergence printed and required) and under the deterministic reduce
    (no divergence)."""
    with knob(constants.DEVICE_FENCE_RATE_ENV, "1"):
        sc = sweep["scenario"]
        off = CharacteristicEngine(sc)
        v_off = float(off.evaluate([AUDIT_COALITION])[0])
        with knob(constants.NUMERICS_AUDIT_ENV, "1"):
            on = CharacteristicEngine(sc)
            t0 = time.perf_counter()
            v_on = float(on.evaluate([AUDIT_COALITION])[0])
            seconds = time.perf_counter() - t0
            with knob(constants.DETERMINISTIC_REDUCE_ENV, "1"):
                det_sc = mnist_scenario([], SWEEP_PARTNERS)
                det_sc.instantiate_scenario_partners()
                det_sc.split_data()
                det = CharacteristicEngine(det_sc)
                det.evaluate([AUDIT_COALITION])
    for tag, eng in (("default", on), ("deterministic", det)):
        for a in eng.numerics_audits:
            print(f"[devcost] (d) audit under the {tag} reduce: subset {a.subset}, executed "
                  f"{a.executed} at {list(a.executed_shape)}, {a.rounds} rounds, first "
                  f"divergence {a.first_divergence}, "
                  f"max ulp {a.max_ulp} over {a.divergent_elements} elements, grouped folds "
                  f"{json.dumps({str(k): v for k, v in a.ulp_by_shards.items()})}, "
                  f"{a.seconds:.2f} s")
    print(f"[devcost] (d) v{AUDIT_COALITION} audit off {v_off!r}, on {v_on!r} "
          f"({seconds:.2f} s with the audit)")
    check(numerics.float_bits(v_on) == numerics.float_bits(v_off),
          "(d) the audit changed a v(S)")
    check(len(on.numerics_audits) == 1 and on.numerics_audits[0].first_divergence is not None
          and on.numerics_audits[0].executed == "torch.sum",
          "(d) the default reduce's audit returned nothing or localized no divergence")
    check(len(det.numerics_audits) == 1 and det.numerics_audits[0].first_divergence is None
          and det.numerics_audits[0].executed == "ordered_fold",
          "(d) the deterministic reduce's audit is missing or diverged")


def phase_devcost(sl, sweep: dict, ledgers: Path, card: str) -> dict:
    """Device cost, fences, the value ledger and the audit: (a) the main
    path ledgered and fenced, (b) the sweep fenced at rate 1 against rate
    0, (c) ledger diffs, (d) the audit on both reductions."""
    t0 = time.perf_counter()
    path = devcost_main_path(sl, ledgers / "main_fp32.json")
    devcost_fences(sweep, card, ledgers)
    devcost_precision_ledgers(path.pop("ledger"), ledgers / "main_bf16.json")
    devcost_audit(sweep)
    print(f"[devcost] all parts passed in {time.perf_counter() - t0:.2f} s")
    return path



# The live phase: the live contributivity tier (live/) on the card. (a)-(d)
# on bench config 8's shape (the slice's MNIST CNN game, 10 partners, no
# journal), (e) on bench config 10's (Titanic, 5 partners, 6 rounds a
# game, journal-backed games under a residency cap), (f) a 20-partner
# Titanic game past the exact wall, (g) the program bank and the kernel
# build folder
LIVE_GTG = dict(sv_accuracy=1.0, min_iter=16, perm_batch=8, truncation=0.0)
LIVE_GAMES = 32
LIVE_RESIDENT = 8
LIVE_SAMPLE = 8
LIVE_HIER_PARTNERS = 20
LIVE_EFFICIENCY = 1e-6


def k1_counts() -> tuple:
    """(K1 launches, K1-bf16 launches, K1's launches by width) since the
    last `k1_reset`."""
    return (recon_kernel.launches, recon_kernel.launches_bf16,
            dict(sorted(recon_kernel.launch_widths.items())))


def k1_reset() -> None:
    recon_kernel.launches = recon_kernel.launches_bf16 = 0
    recon_kernel.launch_widths = {}
    recon_kernel.launch_widths_bf16 = {}


def add_widths(a: dict, b: dict) -> dict:
    """Launches by width, summed."""
    return {w: a.get(w, 0) + b.get(w, 0) for w in sorted({*a, *b})}


def live_exact(sl) -> dict:
    """(a) `LiveGame.from_recording` on the slice's scenario (its engine,
    no journal), K1's counts reset after the recording and read after
    `query("exact")`: the 1023 v(S) bit-equal to [slice]'s, K1 launched,
    K1-bf16 not."""
    eng = sl["recon"].engine
    check(eng._cap_halvings == 0, "(a) the slice's engine has a halved cap")
    game = LiveGame.from_recording(eng.scenario, tenant="mnist")
    k1_reset()
    t0 = time.perf_counter()
    r = game.query("exact")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bf16, widths = k1_counts()
    values = np.array([game._recon.values[s] for s in powerset_order(PARTNERS)])
    equal = values.tobytes() == sl["values"].tobytes()
    print(f"[live] (a) exact over {game.rounds_resident} resident rounds (K = "
          f"{game._recon._d2.shape[0]}): {wall:.2f} s, {r.evaluations} evaluations, "
          f"K1 launches {launches} by width {json.dumps(widths)}; {len(values)} v(S) "
          f"bit-equal to [slice]: {equal}")
    check(launches > 0, "(a) the live exact query never launched K1")
    check(bf16 == 0, "(a) the fp32 live query launched K1-bf16")
    check(r.evaluations == 2 ** PARTNERS - 1, "(a) not every coalition was evaluated")
    check(equal, "(a) the live game's v(S) differ from [slice]'s exact_reconstructed")
    check(r.scores.tobytes() == np.asarray(sl["sv"]).tobytes(),
          "(a) the live exact scores differ from [slice]'s")
    return {"game": game, "launches": launches, "widths": widths}


def live_point(game, tag: str) -> dict:
    """One point of (b): a fresh GTG query (K1's counts reset just before),
    then a warm one, which must make no K1 launch and no engine batch,
    count one memo hit and return the same scores."""
    k1_reset()
    t0 = time.perf_counter()
    fresh = game.query("GTG-Shapley", **LIVE_GTG)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    launches, bf16, widths = k1_counts()
    k1_reset()
    batches = metrics.counter("engine.batches").value
    hits = metrics.counter("live.query_memo_hits").value
    t0 = time.perf_counter()
    warm = game.query("GTG-Shapley", **LIVE_GTG)
    warm_s = time.perf_counter() - t0
    print(f"[live] (b) {tag}: {game.rounds_resident} rounds (K = "
          f"{game._recon._d2.shape[0]}), fresh {fresh_s:.3f} s, warm "
          f"{warm_s * 1e3:.3f} ms, {fresh.evaluations} evaluations, K1 launches "
          f"{launches} by width {json.dumps(widths)}")
    check(launches > 0 and bf16 == 0, f"(b) the fresh query at {tag} did not launch K1 alone")
    check(recon_kernel.launches == 0 and recon_kernel.launches_bf16 == 0,
          "(b) the warm query launched a kernel")
    check(metrics.counter("engine.batches").value == batches, "(b) the warm query ran a batch")
    check(metrics.counter("live.query_memo_hits").value == hits + 1,
          "(b) the warm query was not a memo hit")
    check(warm.scores.tobytes() == fresh.scores.tobytes(), "(b) warm scores differ")
    return {"rounds": game.rounds_resident, "fresh_s": fresh_s, "warm_ms": warm_s * 1e3,
            "evaluations": fresh.evaluations, "launches": launches, "widths": widths,
            "result": fresh}


def twin_game(game, tenant: str, rounds=None) -> "LiveGame":
    """A journal-less game on `game`'s engine holding `rounds` (default
    all) of `game`'s history (the same host arrays) and its own evaluator."""
    twin = LiveGame(game.scenario, tenant=tenant, engine=game.engine)
    hist = game.round_history()
    for d, w in hist if rounds is None else hist[:rounds]:
        twin.append_round(d, w)
    return twin


def live_growth(game) -> dict:
    """(b) On a twin of (a)'s game (a fresh evaluator): fresh and warm GTG
    queries at 20 rounds; one all-zero-weight round appended, which keeps
    the stamp and the memo; the history doubled by cycling it (40 rounds,
    K = 400) and a fresh query, K1 launched again, its scores summing to
    v(N) within LIVE_EFFICIENCY."""
    twin = twin_game(game, "mnist-grow")
    base = twin.round_history()
    first = live_point(twin, "recording")
    stamp = twin.round_stamp
    P = PARTNERS
    zero = ({g: {k: np.zeros_like(a) for k, a in d.items()} for g, d in base[0][0].items()},
            np.zeros(P, np.float32))
    hits = metrics.counter("live.query_memo_hits").value
    check(twin.append_round(*zero) == stamp, "(b) an all-zero round moved the stamp")
    k1_reset()
    again = twin.query("GTG-Shapley", **LIVE_GTG)
    check(again is first["result"] and recon_kernel.launches == 0
          and metrics.counter("live.query_memo_hits").value == hits + 1,
          "(b) the all-zero round did not keep the memo")
    for d, w in base:
        twin.append_round(d, w)
    grown = live_point(twin, "doubled")
    v_all = twin._recon.values[tuple(range(P))]
    gap = abs(float(grown["result"].scores.sum()) - v_all)
    print(f"[live] (b) doubled: sum of scores - v(N) = {gap:.3g} (bound {LIVE_EFFICIENCY})")
    check(twin._recon._d2.shape[0] == 2 * len(base) * P, "(b) the doubled stream is not K = 400")
    check(gap <= LIVE_EFFICIENCY, "(b) the doubled query breaks efficiency")
    return {"twin": twin, "points": [first, grown],
            "launches": first["launches"] + grown["launches"],
            "widths": add_widths(first["widths"], grown["widths"]),
            "breakdown": live_breakdown(twin, grown)}


def live_breakdown(twin, point: dict) -> dict:
    """(b) Where the doubled fresh query's time goes, each part timed on
    its own after the query: the host half of the stream swap
    (`_build_recorded`), the upload and flatten onto the card
    (`reset_recorded`, synced), then K1 and the evaluation of the
    reconstructed models at each width the query launched (CUDA events,
    `cuda_ms`, times its launches there). The rest of the fresh time is
    the query's host work between launches and its syncs."""
    recon = twin._recon
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = twin._build_recorded()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recon.reset_recorded(rec)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng, subsets = recon.engine, powerset_order(PARTNERS)
    k1_ms = eval_ms = 0.0
    for w, n in point["widths"].items():
        masks = torch.from_numpy(eng._coalition_arrays(subsets[:w])).to(DEVICE)
        flat = recon_kernel.reconstruct_flat(masks, recon._init, recon._d2, recon._weights)
        params = recon_kernel.unflatten(flat, recon._layout)
        k1_ms += n * cuda_ms(lambda: recon_kernel.reconstruct_flat(
            masks, recon._init, recon._d2, recon._weights), runs=3, calls=3)
        with torch.no_grad():
            eval_ms += n * cuda_ms(lambda: eng.trainer.evaluate_models(params, eng.test),
                                   runs=3, calls=3)
    rest_s = point["fresh_s"] - host_s - load_s - (k1_ms + eval_ms) / 1e3
    out = {"fresh_s": point["fresh_s"], "build_host_s": host_s, "upload_flatten_s": load_s,
           "k1_s": k1_ms / 1e3, "evaluate_s": eval_ms / 1e3, "rest_s": rest_s,
           "stream_bytes": recon._d2.numel() * recon._d2.element_size()}
    print(f"[live] (b) doubled fresh query {point['fresh_s']:.4f} s: host build "
          f"{host_s:.4f} s, upload and flatten of {out['stream_bytes'] / 2**30:.3f} GiB "
          f"{load_s:.4f} s, K1 {out['k1_s']:.4f} s, evaluation {out['evaluate_s']:.4f} s, "
          f"rest {rest_s:.4f} s")
    check(recon._d2.shape[0] == rec.rounds * PARTNERS,
          "(b) the rebuilt stream's K is not its rounds' x P")
    return out


def live_kernel(twin, launches: int, widths: dict, card) -> dict:
    """(c) K1 on the grown game's own K = 400 stream against its plain
    version, timed: the 64-wide batch of the powerset's first 63 coalitions
    and the empty one."""
    recon = twin._recon
    subsets = powerset_order(PARTNERS)[:63] + [()]
    masks = torch.from_numpy(recon.engine._coalition_arrays(subsets)).to(DEVICE)
    wn2 = recon_kernel.normalized_round_weights(masks, recon._weights).reshape(len(subsets), -1)
    entry = kernel_entry(recon_kernel.KERNEL, wn2.contiguous(), recon._d2, recon._init,
                         launches, card)
    entry["name"] = f"{recon_kernel.KERNEL}[live K={recon._d2.shape[0]}]"
    entry["launches_by_path"] = {"live": launches}
    entry["launch_widths_live"] = widths
    print(f"[kernels] {entry['name']} {entry['shape']}: {entry['ms']:.4f} ms (plain "
          f"{entry['plain_ms']:.4f}, {entry['library']} {entry['library_ms']:.4f}, bound "
          f"{entry['bound_ms']:.4f} by {entry['bound_by']}), max abs err "
          f"{entry['max_abs_err']:.3g}, {launches} launches on the live path")
    check(entry["shape"]["K"] == 400, "(c) the live stream is not K = 400")
    return entry


def live_prune(sl, game) -> None:
    """(d) DPVS, each query on a fresh twin of (a)'s game (its own
    evaluator and memo, so the query runs): tau = 0 launches K1 over the
    whole powerset and is bit-equal to [slice]'s exact v(S) and scores; a
    tau from the game's own info scores that prunes its lowest partner:
    fewer evaluations than (a), the pruned partners' scores exactly 0."""
    zero = twin_game(game, "mnist-prune0")
    k1_reset()
    off = zero.query("exact", prune=0.0)
    launches, _, _ = k1_counts()
    values = np.array([zero._recon.values[s] for s in powerset_order(PARTNERS)])
    print(f"[live] (d) tau 0 on a fresh twin: {off.evaluations} evaluations, K1 launches "
          f"{launches}, v(S) bit-equal to [slice]: {values.tobytes() == sl['values'].tobytes()}")
    check(launches > 0 and off.evaluations == 2 ** PARTNERS - 1,
          "(d) the prune=0 query did not reconstruct the powerset")
    check(off.scores.tobytes() == np.asarray(sl["sv"]).tobytes() and off.pruned_coalitions == 0
          and values.tobytes() == sl["values"].tobytes(),
          "(d) prune=0 differs from the unpruned exact query")
    zero.close()
    scores = np.sort(game._info_scores())
    tau = float((scores[0] + scores[1]) / 2 / scores[-1])
    twin = twin_game(game, "mnist-prune")
    k1_reset()
    pruned = twin.query("exact", prune=tau)
    launches, _, _ = k1_counts()
    print(f"[live] (d) info scores {np.round(game._info_scores(), 6).tolist()}; tau "
          f"{tau:.4f} prunes {list(pruned.low_info)}: {pruned.evaluations} evaluations "
          f"(unpruned 1023), {pruned.pruned_coalitions} coalitions served from a "
          f"projection, K1 launches {launches}")
    check(len(pruned.low_info) >= 1, "(d) the tau pruned no partner")
    check(0 < pruned.evaluations < 2 ** PARTNERS - 1, "(d) pruning did not cut evaluations")
    check(all(pruned.scores[p] == 0.0 for p in pruned.low_info),
          "(d) a pruned partner's score is not exactly 0")
    twin.close()


def live_titanic(device: str = DEVICE, partners: int = 5, **kw) -> Scenario:
    """A Titanic game of `partners` partners split (i+1)/sum, fedavg,
    data-volume, 3 epochs of 2 minibatches of 2 steps (6 rounds), prepared
    for an engine."""
    total = sum(range(1, partners + 1))
    return prepared(Scenario(partners, [(i + 1) / total for i in range(partners)],
                             is_dry_run=True, dataset=load_titanic(), epoch_count=3,
                             minibatch_count=2, gradient_updates_per_pass_count=2,
                             is_early_stopping=False, seed=0, device=device, **kw))


def pctl(xs, q: float) -> float:
    """The nearest-rank q-quantile."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(np.ceil(q * len(s))) - 1))]


def live_residency(work: Path) -> dict:
    """(e) Bench config 10's shape: a journal-backed seed game recorded on
    Titanic (5 partners, 6 rounds), whose exact answer is the reference;
    LIVE_GAMES games on its engine appending its rounds, under a residency
    cap of LIVE_RESIDENT; LIVE_SAMPLE of them, spread, evicted, restored
    and queried, each bit-equal to the reference; a kill -> restart on one
    WAL; a torn tail quarantined; one WAL reopened under bf16."""
    residency.reset()
    sc = live_titanic()
    seed = LiveGame.from_recording(sc, tenant="seed", journal_path=work / "seed.wal")
    want = seed.query("exact")
    want_values = dict(seed._recon.values)
    base = seed.round_history()
    engine = seed.engine
    seed.close()
    residency.configure(LIVE_RESIDENT)
    games = []
    try:
        for i in range(LIVE_GAMES):
            g = LiveGame(sc, tenant=f"t{i:02d}", engine=engine, journal_path=work / f"t{i}.wal")
            for d, w in base:
                g.append_round(d, w)
            games.append(g)
        st = residency.stats()
        check(st["resident"] <= LIVE_RESIDENT and st["evicted"] >= LIVE_GAMES - LIVE_RESIDENT,
              f"(e) the residency books {st} do not hold the cap")
        restores = []
        for gi in sorted({round(j * (LIVE_GAMES - 1) / (LIVE_SAMPLE - 1))
                          for j in range(LIVE_SAMPLE)}):
            g = games[gi]
            g.evict()
            r = g.query("exact")
            restores.append(g.last_restore_s)
            check(r.scores.tobytes() == want.scores.tobytes() and g._recon.values == want_values,
                  f"(e) game {gi}: evict -> restore -> query differs from never-evicted")
        # kill -> restart: the process's game is gone, a new one opens its WAL
        victim = games[-1]
        victim.close()
        games[-1] = LiveGame(sc, tenant=victim.tenant, engine=engine, journal_path=victim._journal.path)
        check(games[-1].query("exact").scores.tobytes() == want.scores.tobytes(),
              "(e) kill -> restart differs")
        # a torn tail: a record cut mid-append
        torn = work / "torn.wal"
        torn.write_bytes((work / "t0.wal").read_bytes() + b'{"sha256": "00", "rec": {"ty')
        tg = LiveGame(sc, tenant="torn", engine=engine, journal_path=torn)
        check((work / "torn.wal.torn").exists() and tg.rounds_resident == len(base),
              "(e) the torn tail was not quarantined")
        check(tg.query("exact").scores.tobytes() == want.scores.tobytes(),
              "(e) the game restored past a torn tail differs")
        tg.close()
        st = residency.stats()
        print(f"[live] (e) {LIVE_GAMES} journaled Titanic games under a cap of "
              f"{LIVE_RESIDENT}: {st['evictions']} evictions, {st['restores']} restores; "
              f"restore p50 {pctl(restores, 0.5) * 1e3:.3f} ms, p99 "
              f"{pctl(restores, 0.99) * 1e3:.3f} ms over {len(restores)} sampled games; "
              f"kill -> restart and the torn tail bit-equal")
        bf16 = live_bf16(work / "t0.wal", want_values)
    finally:
        for g in games:
            g.close()
        residency.reset()
    return {"restore_p50_ms": pctl(restores, 0.5) * 1e3,
            "restore_p99_ms": pctl(restores, 0.99) * 1e3,
            "evictions": st["evictions"], "restores": st["restores"], **bf16}


def live_bf16(wal: Path, fp32: dict) -> dict:
    """One WAL reopened on an engine built under MPLC_TORCH_PRECISION=bf16:
    K1-bf16 launches (K1 not), no fp32 result is served, and |dv(N)| and
    the median |dv| stay within BF16_VALUE_BOUND of fp32."""
    with precision_env("bf16"):
        sc = live_titanic()
        g = LiveGame(sc, tenant="bf16", journal_path=wal)
    try:
        k1_reset()
        r = g.query("exact")
        launches, bf16, _ = k1_counts()
        P = g.engine.partners_count
        dv = np.array([g._recon.values[s] - fp32[s] for s in powerset_order(P)])
        dv_all = abs(g._recon.values[tuple(range(P))] - fp32[tuple(range(P))])
        med = float(np.median(np.abs(dv)))
        print(f"[live] (e) bf16 reopen: K1-bf16 launches {bf16}, K1 {launches}; "
              f"{r.evaluations} evaluations; |dv(N)| {dv_all:.4g}, median |dv| {med:.4g} "
              f"(bound {BF16_VALUE_BOUND})")
        check(g.engine._multi_cfg.precision == "bf16", "(e) the reopened engine is not bf16")
        check(bf16 > 0 and launches == 0, "(e) the bf16 reopen did not launch K1-bf16 alone")
        check(r.evaluations == 2 ** P - 1, "(e) the bf16 reopen served a memoized answer")
        check(dv_all <= BF16_VALUE_BOUND and med <= BF16_VALUE_BOUND,
              "(e) bf16 values part from fp32 past the bound")
    finally:
        g.close()
    return {"launches_bf16": bf16, "bf16_dv_all": dv_all, "bf16_median_dv": med}


def live_hierarchical() -> dict:
    """(f) A LIVE_HIER_PARTNERS-partner Titanic game (equal shares, no
    journal): a GTG query meters its evaluations, then `query("auto")` with
    a deadline the meter prices below GTG's budget and above the grouped
    sweep's must plan "hierarchical" on the "meter" basis; its scores sum
    to v(N) within LIVE_EFFICIENCY."""
    n = LIVE_HIER_PARTNERS
    sc = prepared(Scenario(n, [1.0 / n] * n, is_dry_run=True, dataset=load_titanic(),
                           epoch_count=2, minibatch_count=2,
                           gradient_updates_per_pass_count=2, is_early_stopping=False,
                           seed=0, device=DEVICE))
    game = LiveGame.from_recording(sc, tenant="wide")
    game.query("GTG-Shapley", **LIVE_GTG)
    eval_sec, basis = estimate_eval_seconds(game.engine)
    k = hierarchy.resolve_clusters(n)
    deadline = 2 * hierarchy.estimate_evaluations(n, k) * eval_sec
    k1_reset()
    t0 = time.perf_counter()
    r = game.query("auto", deadline_sec=deadline)
    wall = time.perf_counter() - t0
    launches, _, widths = k1_counts()
    v_all = game._recon.values[tuple(range(n))]
    gap = abs(float(r.scores.sum()) - v_all)
    print(f"[live] (f) {n} partners, deadline {deadline:.4f} s on the {basis} basis "
          f"({eval_sec * 1e3:.4f} ms a coalition): plan {r.plan.method} "
          f"{json.dumps(r.plan.method_kw)}, {r.evaluations} evaluations in {wall:.3f} s, "
          f"K1 launches {launches}; sum of scores - v(N) = {gap:.3g}")
    check(basis == "meter", f"(f) the planner priced on {basis}, not the meter")
    check(r.plan.method == "hierarchical", f"(f) auto planned {r.plan.method}")
    check(gap <= LIVE_EFFICIENCY, "(f) the hierarchical scores break efficiency")
    game.close()
    return {"launches": launches, "widths": widths}


def live_bank(sl, game, programs: dict, cache: Path) -> None:
    """(g) The program bank and the kernel build folder (all under the
    phase's temporary MPLC_TORCH_COMPILE_CACHE_DIR): the kernels build
    there under digest names and a second build builds nothing; the
    manifest lists (a)-(b)'s reconstruction programs (`programs`, key ->
    width) with their FLOPs; a
    meterless engine plans on "bank_cost_model"; with the bank off
    (MPLC_TORCH_PROGRAM_BANK=0) a twin of (a)'s `game` gives (a)'s values
    bit for bit and records no program."""
    libs = [cache / cuda_build.library_name(n) for n in recon_kernel.KERNELS]
    # a kernel this phase loaded first (K1-bf16 in (e), when no earlier
    # phase did) was built here already
    missing = sum(not p.exists() for p in libs)
    builds = metrics.counter("trainer.compiles_total").value
    t0 = time.perf_counter()
    cuda_build.build(recon_kernel.KERNELS)
    built = time.perf_counter() - t0
    first = int(metrics.counter("trainer.compiles_total").value - builds)
    cuda_build.build(recon_kernel.KERNELS)
    second = int(metrics.counter("trainer.compiles_total").value - builds) - first
    entries = utils.compile_cache_entries(str(cache))
    print(f"[live] (g) kernel build folder {cache} ({entries} files): "
          f"{', '.join(p.name for p in libs)}; {first} nvcc runs for the {missing} "
          f"missing in {built:.2f} s, then {second}")
    check(all(p.exists() for p in libs) and first == missing and second == 0,
          "(g) the kernels did not build once under their digest names")
    doc = json.loads((cache / bank.MANIFEST_NAME).read_text())
    missing = [k for k in programs if k not in doc["programs"]
               or not doc["costs"].get(k, {}).get("flops")]
    print(f"[live] (g) manifest: {len(doc['programs'])} programs, {len(doc['costs'])} with "
          f"FLOPs; (a)-(b)'s {len(programs)} reconstruction programs (widths "
          f"{sorted(set(programs.values()))}) listed: {not missing}")
    check(not missing, f"(g) the manifest lacks programs {missing}")
    fresh = CharacteristicEngine(live_titanic())
    eval_sec, basis = estimate_eval_seconds(fresh)
    print(f"[live] (g) a meterless engine prices {eval_sec * 1e3:.4f} ms a coalition on "
          f"the {basis} basis")
    check(basis == "bank_cost_model", f"(g) the meterless engine planned on {basis}")
    recorded = bank.bank_stats()["programs"]
    with knob(constants.PROGRAM_BANK_ENV, "0"):
        off = twin_game(game, "mnist-nobank")
        off.query("exact")
    values = np.array([off._recon.values[s] for s in powerset_order(PARTNERS)])
    check(values.tobytes() == sl["values"].tobytes(), "(g) the bank off changes v(S)")
    check(bank.bank_stats()["programs"] == recorded, "(g) the disabled bank recorded a program")
    off.close()


def phase_live(sl, card) -> dict:
    """The live tier, (a)-(g), under a temporary kernel build folder and
    bank manifest (MPLC_TORCH_COMPILE_CACHE_DIR)."""
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mplc_live_"))
    with knob(constants.COMPILE_CACHE_DIR_ENV, str(work / "kernels")):
        a = live_exact(sl)
        b = live_growth(a["game"])
        # the live main path's launches: (a) and (b), the MNIST CNN game's
        launches = a["launches"] + b["launches"]
        widths = add_widths(a["widths"], b["widths"])
        entry = live_kernel(b["twin"], launches, widths, card)
        live_prune(sl, a["game"])
        e = live_residency(work)
        f = live_hierarchical()
        # (a)-(b)'s programs: (a)'s and the first point's at K = 200 (one
        # engine digest, one depth), the doubled point's at K = 400
        keys = a["game"].engine.program_bank.recon_key
        first, grown = b["points"]
        programs = {keys(a["game"]._recon, w): w
                    for w in add_widths(a["widths"], first["widths"])}
        programs.update({keys(b["twin"]._recon, w): w for w in grown["widths"]})
        live_bank(sl, a["game"], programs, work / "kernels")
    for g in (a["game"], b["twin"]):
        g.close()
    print(f"[live] points " + json.dumps([{k: v for k, v in p.items() if k != "result"}
                                          for p in b["points"]]))
    print(f"[live] doubled fresh query breakdown " + json.dumps(b["breakdown"]))
    print(f"[live] all parts passed in {time.perf_counter() - t0:.2f} s")
    return {"launches": launches, "widths": widths, "launches_bf16": e["launches_bf16"],
            "entry": entry, "residency": e, "hierarchical": f}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if "--real-oom" in sys.argv[1:]:
        # [ladder] (e)'s own process: one JSON line
        cuda_build.build(recon_kernel.KERNELS)
        print(json.dumps(real_oom_child()))
        return 0
    start = time.perf_counter()
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    cuda_build.build(recon_kernel.KERNELS)
    print(f"[build] {', '.join(recon_kernel.KERNELS)} built in "
          f"{time.perf_counter() - t0:.2f} s")

    sl = rung_free("slice", phase_slice)
    rung_free("reference", phase_reference)
    rung_free("stages", phase_stages, sl["recon"])
    kernels = phase_kernels(sl, card)
    svarm = rung_free("svarm", phase_svarm, sl)
    for e in kernels:
        # each K1 entry's launches by path: the main path's and SVARM's,
        # each counted from 0 (the 64-wide entry all, a narrower one those
        # of batches up to its width)
        B = e["shape"]["B"]
        e["launches_by_path"] = {"slice": e["launches"], "svarm": (
            svarm["launches"] if B == 64 else
            sum(n for w, n in svarm["widths"].items() if w <= B))}
        e["launch_widths_svarm"] = svarm["widths"]
    ledger_dir = Path(tempfile.mkdtemp(prefix="mplc_ledgers_"))
    kernels += rung_free("precision", phase_precision, sl["values"], card,
                         str(ledger_dir / "main_bf16.json"))
    sweep = rung_free("sweep", phase_sweep)
    for tag, phase in (("sweep reference", phase_sweep_reference), ("slots", phase_slots),
                       ("deterministic reduce", phase_deterministic_reduce)):
        rung_free(tag, phase)
    rung_free("cache", phase_cache, sweep)
    rung_free("estimators", phase_estimators, sweep)
    rung_free("variants", phase_variants)
    paths = {"faults": rung_free("faults", phase_faults, card, sweep, smi),
             "cifar10": rung_free("cifar10", phase_cifar10, card, smi),
             "imdb": rung_free("imdb", phase_imdb, card, smi),
             "esc50": rung_free("esc50", phase_esc50, card, smi),
             "cli": rung_free("cli", phase_cli, card, smi),
             "obs": rung_free("obs", phase_obs, sl, sweep, kernels),
             "ladder": phase_ladder(sl, sweep)}
    rung_free("width", phase_width, sweep)
    paths["devcost"] = rung_free("devcost", phase_devcost, sl, sweep, ledger_dir, card)
    paths["live"] = rung_free("live", phase_live, sl, card)
    for e in kernels:
        B = e["shape"]["B"]
        if not e["name"].startswith(recon_kernel.KERNEL_BF16):
            # K1's entries on the main stream: each fp32 path's launches by
            # the entry's width (the 64-wide entry all of them)
            for tag, path in paths.items():
                e["launches_by_path"][tag] = (
                    path["launches"] if B == 64 else
                    sum(n for w, n in path["widths"].items() if w <= B))
                e[f"launch_widths_{tag}"] = path["widths"]
        else:
            # K1-bf16 launches on the bf16 main path and on [live]'s bf16
            # reopen (every fp32 path gates its K1-bf16 launches at 0)
            e["launches_by_path"] = {"slice bf16": e["launches"], "svarm": 0,
                                     **{tag: path.get("launches_bf16", 0)
                                        for tag, path in paths.items()}}
    kernels += [path["entry"] for path in paths.values() if "entry" in path]

    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
