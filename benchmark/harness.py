"""One run of one cell: set-up, the measured window, the check, the
result.

Everything a cell is made of is found by name (`manifest.py`): its
configuration file, its traffic mix, its limits and a reader for each of
its metrics. The run:

1. makes the inputs from the seed and prepares the program's scenario
   (`game.py`), builds the mix's entry (`entries.py`) and warms one request
   of each shape the window will use; set-up ends on a synchronized card
   (`setup_s`: from the start of the process's harness to the first timed
   request, imports and CUDA context included);
2. sends the mix's requests back to back, one client, closed loop; the
   window opens at the first timed request and closes at the first batch
   completion (the engine's `progress` hook, after each batch's harvest)
   at or after `--seconds`; the rate is the coalitions of every batch
   completed in the window over the window's length. A traced run
   (`--trace 1`) profiles the mix's steady sub-window of whole requests
   (`devtrace.py`) and holds the window open until that sub-window is done;
3. reads the memory peak, checks that no JAX module was loaded, frees
   the program's state and runs the check (`check.py`) against the plain
   reference, outside `setup_s` and the window;
4. returns the result: the cell's end-to-end metrics (`--trace 0`) or its
   per-layer metrics and the device's busy and window seconds with the
   breakdown (`--trace 1`), each metric from its reader
   (`metrics/<name>.py`), and the numbers compared beside their limits;
   its last step checks again that no JAX module was loaded, by the check
   or a reader.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

from . import check, entries, game, manifest, traffic
from .devtrace import DeviceTrace, name_gaps

# loaded by the port or the harness, one of these would put JAX (or the
# JAX package, whose top-level name is a prefix of the port's) in the run
FORBIDDEN = ("jax", "jaxlib", "flax", "mplc_tpu")


class WindowClosed(BaseException):
    """Raised from the engine's progress hook to end the request in flight
    once the window has closed; a BaseException, so that no handler of the
    program's fault ladder takes it for a failure of its own."""


class RunError(Exception):
    """A run that cannot give a result (exit code `code`)."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """No result from a process that holds a forbidden module."""
    bad = forbidden_modules()
    if bad:
        raise RunError(f"forbidden modules loaded in the run: {', '.join(bad)}", 6)


def prepare_environment(root, cfg: dict) -> None:
    """The program's knobs as the configuration states them, and nothing
    inherited: every `MPLC_TORCH_*` / `MPLC_TPU_*` variable of the caller is
    dropped, the precision is the configuration's, and the kernel build
    folder (and Triton's and torch's extension folders, should a kernel
    ever use them) sit at fixed paths inside the checkout, so only the
    first run of a checkout builds."""
    for k in [k for k in os.environ if k.startswith(("MPLC_TORCH_", "MPLC_TPU_"))]:
        del os.environ[k]
    os.environ["MPLC_TORCH_PRECISION"] = cfg["precision"]
    build = root / "build"
    os.environ["MPLC_TORCH_COMPILE_CACHE_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def card_description() -> str:
    """`name, power limit` of each card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _log(*a) -> None:
    print("[bench]", *a, file=sys.stderr, flush=True)


class Window:
    """The measured window's clock and counts, fed by the progress hook.
    It closes at the first batch completion at or after `seconds`, or,
    for a mix that says `"close": "request"`, at the first request
    completion at or after it (a mix whose requests hold batches of very
    different cost, where a window cut between them would count a cheap
    or a dear batch by the luck of the clock). `requests`, where given,
    closes it after that many whole requests instead (the readings of
    `readings.py`)."""

    def __init__(self, seconds: float, by_request: bool = False, requests: int | None = None):
        self.seconds = seconds
        self.by_request = by_request or requests is not None
        self.requests = requests
        self.probe = None      # armed at the window's start and after each batch
        self.t0 = None
        self.t_close = None
        self.coalitions = 0
        self.served = 0
        self.hold = False      # the traced sub-window is not done yet

    def progress(self, done: int) -> None:
        if self.t0 is None or self.t_close is not None:
            return
        if self.probe is not None:
            self.probe.arm()
        self.coalitions += done
        now = time.perf_counter()
        if now - self.t0 >= self.seconds and not self.hold and not self.by_request:
            self.t_close = now
            raise WindowClosed()

    def request_done(self) -> bool:
        """After a whole request: True when the window closes here."""
        self.served += 1
        now = time.perf_counter()
        if self.requests is not None:
            due = self.served >= self.requests
        else:
            due = now - self.t0 >= self.seconds and not self.hold
        if due:
            self.t_close = now
        return due

    @property
    def length(self) -> float:
        return self.t_close - self.t0


def load_cell(workload: str, rehearse: dict | None = None):
    """(manifest, cell, configuration, mix) of `workload`, with the
    rehearsal's overrides of the configuration and the mix."""
    man = manifest.Manifest.load()
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    if rehearse:
        cfg = manifest.merged(cfg, rehearse.get("config", {}))
        mix = manifest.merged(mix, rehearse.get("traffic", {}))
    return man, cell, cfg, mix


def epochs_of(cfg: dict, mix: dict) -> int:
    """The epochs the mix's entry trains: the recording's for the
    reconstruction entry, the retraining's otherwise."""
    return cfg["recording_epoch_count" if mix["entry"] == "reconstruction_fresh"
               else "epoch_count"]


def build_entry(cfg: dict, mix: dict, raw: dict, seed: int, device, progress):
    """(entry, requests): the program's scenario over `raw` and the mix's
    entry on it (the recording, for the reconstruction entry, is made
    here)."""
    sc = game.program_scenario(cfg, raw, seed, device, epochs_of(cfg, mix))
    reqs = traffic.requests(mix, len(cfg["partner_weights"]))
    return entries.ENTRIES[mix["entry"]](sc, progress), reqs


def readings_of(cfg: dict, mix: dict, answers: list, recorded, ref_game, device,
                cache: dict | None = None, steps: list | None = None,
                full: bool = True) -> dict:
    """The check's readings of a run's answers, first steps and recording
    (`cache` keeps the reference's work between runs on one game; `full`
    False: the retraining entries' start alone)."""
    cache = {} if cache is None else cache
    if mix["entry"] == "reconstruction_fresh":
        return check.recon_readings(cfg, mix, answers, ref_game,
                                    check.flat_stream(recorded, device), device, cache)
    return check.retrain_readings(cfg, mix, answers, ref_game, epochs_of(cfg, mix),
                                  device, cache, steps, full)


def serve(entry, reqs: list, window: Window, dev_trace=None, trace_at: tuple = (1, 1)):
    """The mix's requests back to back, one client, closed loop, until
    `window` closes: (the requests' spans, K1's launches by width in the
    traced sub-window). A traced run profiles requests `trace_at` =
    (first, count) and holds the window open until they are done."""
    skip, n_traced = trace_at
    spans, launch_widths = [], {}
    window.hold = dev_trace is not None
    window.probe.arm()
    window.t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        if dev_trace is not None and i == skip:
            dev_trace.start()
            launches_before = _launch_widths()
        t_req = time.time()
        try:
            entry.serve(req)
        except WindowClosed:
            spans.append(("bench.request", t_req, time.time()))
            break
        spans.append(("bench.request", t_req, time.time()))
        if dev_trace is not None and i == skip + n_traced - 1:
            dev_trace.stop()
            launch_widths = _launch_widths(since=launches_before)
            window.hold = False
        if window.request_done():
            break
    else:
        raise RunError("the mix ran out of requests before the window closed", 5)
    window.probe.disarm()
    return spans, launch_widths


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             rehearse: dict | None = None, t_start: float | None = None) -> dict:
    """One run of `workload`: its result dict. `rehearse` (the CPU tests
    only) runs on the CPU with those overrides of the configuration and
    the mix, and reports no device metric."""
    t_start = time.perf_counter() if t_start is None else t_start
    man, cell, cfg, mix = load_cell(workload, rehearse)
    prepare_environment(man.root, cfg)

    import torch
    if rehearse:
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card only", 3)
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"{workload} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present", 3)
        device = "cuda"
        _log("card:", card_description())
    try:
        import mplc_tpu_torch  # noqa: F401  the system under test
        from mplc_tpu_torch.obs import trace as obs_trace
    except ImportError as e:
        raise RunError(f"the program is not in this checkout: {e}", 4) from e

    t_phase = time.perf_counter()
    raw = game.make_inputs(cfg, seed)
    t_inputs = time.perf_counter() - t_phase
    window = Window(seconds, mix.get("close") == "request")
    entry, reqs = build_entry(cfg, mix, raw, seed, device, window.progress)
    sc = entry.scenario
    window.probe = sc.dataset.model.optimizer
    t_warm = time.perf_counter()
    t_entry = t_warm - t_phase - t_inputs
    entry.warm(traffic.warmup_requests(mix, reqs))
    if device == "cuda":
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s: to the inputs {t_phase - t_start:.3f} s (imports, the "
         f"card), inputs {t_inputs:.3f} s, scenario and entry {t_entry:.3f} s, "
         f"warm-up {warmup_s:.3f} s")

    tr_cfg = mix.get("trace", {})
    trace_at = (int(tr_cfg.get("skip", 1)), int(tr_cfg.get("requests", 1)))
    dev_trace = DeviceTrace() if trace and not rehearse else None
    with obs_trace.collect() as records:
        spans, launch_widths = serve(entry, reqs, window, dev_trace, trace_at)
    batches = [r["attrs"] for r in records if r["name"] == "engine.batch"]
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    refuse_forbidden()

    answers = entry.answers()
    steps = window.probe.rows()
    recorded = getattr(entry, "recorded", None)
    partner_sizes = [len(p.x_train) for p in sorted(sc.partners_list, key=lambda p: p.id)]
    test_rows = len(sc.dataset.x_test)
    recon = _recon_shape(recorded) if recorded is not None else None
    del entry, sc
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref_game = game.reference_game(cfg, raw, seed, device)
    readings = readings_of(cfg, mix, answers, recorded, ref_game, device, steps=steps)
    correct, checks = check.judge(readings, man.limits(workload))
    _log(f"check {time.perf_counter() - t_check:.3f} s; readings {readings}")

    ctx = {"workload": workload, "cfg": cfg, "mix": mix, "seconds": seconds,
           "window_s": window.length, "coalitions": window.coalitions,
           "batches": batches, "setup_s": setup_s, "warmup_s": warmup_s,
           "answers": answers, "epochs": epochs_of(cfg, mix),
           "partner_sizes": partner_sizes, "test_rows": test_rows,
           "forward_flops": ref_game.spec.forward_flops,
           "recon": recon, "launch_widths": launch_widths,
           "peaks": None, "trace": None, "device_name": None}
    result = {"correct": bool(correct), "attempted": len(answers), "failed": 0}
    if device == "cuda":
        from .peaks import peaks
        ctx["device_name"] = torch.cuda.get_device_name(0)
        ctx["peaks"] = peaks(ctx["device_name"])
        ctx["trace"] = dev_trace.summary if dev_trace is not None else None
    names = man.per_layer_names(workload) if trace else man.end_to_end_names(workload)
    metrics = {}
    for name in names:
        value = man.reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": man.metric(name)["unit"]}
    result["metrics"] = metrics
    if device == "cuda":
        result["device"] = {"platform": "gpu", "kind": ctx["device_name"],
                            "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
        s = ctx["trace"]
        if s is not None:
            result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
            result["breakdown"] = {
                "device_ops": [[n[:160], sec] for n, sec, _ in s["ops"][:10]],
                "idle_gaps": name_gaps(s["gaps"], spans + _program_spans(records)),
            }
    else:
        result["device"] = {"platform": "cpu", "rehearsal": True}
    result["checks"] = checks
    # last: nothing the check or a metric's reader loaded may be JAX
    refuse_forbidden()
    return result


def _launch_widths(since: dict | None = None) -> dict:
    """K1's launches by batch width in this process (the program's
    counter), or those since a snapshot."""
    from mplc_tpu_torch.ops import recon_kernel
    now = dict(recon_kernel.launch_widths)
    if since is None:
        return now
    return {b: n - since.get(b, 0) for b, n in now.items() if n - since.get(b, 0)}


def _recon_shape(rec) -> dict:
    """K (recorded rows) and Dp (parameters padded to 8) of a recording."""
    D = sum(t.numel() for d in rec.init_params.values() for t in d.values())
    R, P = rec.weights.shape
    return {"K": int(R * P), "Dp": int(-(-D // 8) * 8), "D": int(D)}


def _program_spans(records: list) -> list:
    return [(r["name"], r["ts"], r["ts"] + r["dur"]) for r in records if r.get("dur")]
