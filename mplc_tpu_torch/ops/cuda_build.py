"""Build the port's CUDA sources into shared libraries at first use.

Each `mplc_tpu_torch/csrc/<name>.cu` exposes a plain C entry point and is
compiled by `nvcc` for `sm_90a` into `lib<name>-<digest>.so` in the kernel
build folder (`build_dir`), then loaded with `ctypes`. The digest covers
the source's bytes and `NVCC_FLAGS`, so a library is reused exactly when
it was built from the same source with the same flags: a folder shared by
checkouts at different revisions never serves one the other's kernel.
The folder is `MPLC_TORCH_COMPILE_CACHE_DIR` when set
(`utils.enable_compile_cache_from_env`), else `build/kernels` of the
checkout (listed in `.gitignore`) when the package sits in a writable
checkout, else a user cache folder. A build writes to a temporary name and
renames it into place, so concurrent builds never load a half-written
library; a failed build raises. Nothing is built at import.

Each source nvcc builds emits a `trainer.compile` trace event (`fn` the
source's name, `dur` nvcc's seconds) and adds to the `trainer.compiles_total`
and `trainer.compile_seconds_total` counters: the port's counterpart of the
JAX package's jit-miss event (`mplc_tpu/mpl/engine.py`). A library loaded
from the build folder emits nothing. These builds are the port's only
compiles: its trainers run eagerly, with nothing traced or compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import utils
from ..obs import metrics, trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# the checkout holding the package (when it is one: an installed wheel's
# parent is site-packages)
CHECKOUT = Path(__file__).resolve().parents[2]
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


def build_dir() -> Path:
    """The kernel build folder: MPLC_TORCH_COMPILE_CACHE_DIR, else the
    checkout's `build/kernels` when the checkout is writable, else
    `$XDG_CACHE_HOME/mplc_tpu_torch/kernels` (`~/.cache` by default)."""
    configured = utils.enable_compile_cache_from_env()
    if configured:
        return Path(configured)
    if (CHECKOUT / "pyproject.toml").is_file() and os.access(CHECKOUT, os.W_OK):
        return CHECKOUT / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "mplc_tpu_torch" / "kernels"


def source_digest(name: str) -> str:
    """16 hex digits of sha256 over `csrc/<name>.cu`'s bytes and NVCC_FLAGS."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_name(name: str) -> str:
    return f"lib{name}-{source_digest(name)}.so"


def library_path(name: str) -> Path:
    return build_dir() / library_name(name)


def build(names) -> None:
    """Compile every source of `names` whose library (by digest) is not in
    the build folder, one nvcc process each, all started together; raises
    with the compiler's output if one fails."""
    folder = build_dir()
    libs = {n: folder / library_name(n) for n in names}
    stale = [n for n in names if not libs[n].exists()]
    if not stale:
        return
    folder.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for n in stale:
        # unique temp name, renamed into place: concurrent builds never
        # load a half-written library
        tmp = folder / f".lib{n}.{os.getpid()}.so"
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
        os.replace(tmp, libs[n])
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
