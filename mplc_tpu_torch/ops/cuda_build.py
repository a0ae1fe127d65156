"""Build the port's CUDA sources into shared libraries at first use.

Each `mplc_tpu_torch/csrc/<name>.cu` exposes a plain C entry point and is
compiled by `nvcc` for `sm_90a` into `build/kernels/lib<name>.so` at the
root of the checkout (listed in `.gitignore`), then loaded with `ctypes`.
A library newer than its source is reused. Nothing is built at import.

Each source nvcc builds emits a `trainer.compile` trace event (`fn` the
source's name, `dur` nvcc's seconds) and adds to the `trainer.compiles_total`
and `trainer.compile_seconds_total` counters: the port's counterpart of the
JAX package's jit-miss event (`mplc_tpu/mpl/engine.py`). A library loaded
from the build folder emits nothing. These builds are the port's only
compiles: its trainers run eagerly, with nothing traced or compiled.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..obs import metrics, trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc was not found (PATH, CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names) -> None:
    """Compile every stale source of `names`, one nvcc process each, all
    started together; raises with the compiler's output if one fails."""
    stale = [n for n in names if _stale(n)]
    if not stale:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for n in stale:
        # unique temp name, renamed into place: concurrent builds never
        # load a half-written library
        tmp = BUILD_DIR / f".lib{n}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        jobs.append((n, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def finish(job):
        # each process waited on by its own thread, so each build's
        # seconds end when that nvcc ends
        n, tmp, t0, proc = job
        log, _ = proc.communicate()
        return n, tmp, proc.returncode, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(finish, jobs))
    failures = []
    for n, tmp, rc, log, seconds in done:
        if rc != 0:
            failures.append(f"{n}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(n))
        trace.event("trainer.compile", dur=seconds, fn=n)
        metrics.counter("trainer.compiles_total").inc()
        metrics.counter("trainer.compile_seconds_total").inc(seconds)
        metrics.counter(f"trainer.compiles[{n}]").inc()
        metrics.counter(f"trainer.compile_seconds[{n}]").inc(seconds)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
