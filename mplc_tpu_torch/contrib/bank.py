"""The program bank, kept thin (port of `mplc_tpu/contrib/bank.py`).

The JAX bank AOT-compiles every (slot_count, width) program of a sweep and
every (rounds, width) reconstruction program of the live tier, holds the
executables in a process-global store shared by engines and tenants, and
writes a manifest of compiled program keys (with XLA's cost analysis)
beside the persistent compile cache, so a later process can prove it holds
a sweep's programs and the planner can cost a query from them.

The port's trainers run eagerly: torch compiles nothing but the CUDA
kernels' nvcc builds, which the kernel build folder already caches by
source digest (ops/cuda_build.py). So here "acquire" does bookkeeping
only. It records the program's key, the same identity as the JAX bank's
(the engine digest, the program's shape, the device), with the FLOPs the
port counts for the call (mpl/engine.py `call_flops`, the reconstruction's
contraction added for a reconstruction program) as its `cost`, and
returns. The engine then runs its ordinary eager path: there is no
compile, no background thread and no `prefetch` work, and a bank on or off
(MPLC_TORCH_PROGRAM_BANK=0) never changes a bit of v(S).

What is kept of the JAX bank: the key (`program_key`, `recon_key`, the
engine digest in its per-game and its shared, shape-only scope), the
process-global FIFO store bounded at 256 programs, `bank_stats()` with the
JAX key set, the manifest `mplc_program_bank.json` (`programs` and
`costs`, replaced atomically) in `manifest_dir()`
(MPLC_TORCH_COMPILE_CACHE_DIR; unset: none), `persistent_keys`,
`persistent_costs` and `holds_persistent(plan)`. The key drops XLA's
donation signature: the port donates no buffer. The planner's
"bank_cost_model" basis (contrib/planner.py) reads the manifest's FLOPs.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading

import torch

from .. import constants
from ..obs import metrics as obs_metrics

logger = logging.getLogger("mplc_tpu_torch")

MANIFEST_NAME = "mplc_program_bank.json"

# Process-global store: key -> entry ({"kind", "slot_count", "width",
# "cost"}), FIFO-bounded (dicts keep insertion order): a long-lived
# multi-tenant process records a key a (game x shape x width)
_PROGRAMS: dict = {}
_MAX_PROGRAMS = 256
_LOCK = threading.Lock()
_MANIFEST_LOCK = threading.Lock()


def bank_enabled() -> bool:
    return os.environ.get(constants.PROGRAM_BANK_ENV, "1") != "0"


def reset_bank() -> None:
    """Drop every recorded program (tests)."""
    with _LOCK:
        _PROGRAMS.clear()


def bank_stats() -> dict:
    """The process-global bank's state, under the JAX package's keys. The
    port never compiles, so `failed_compiles` and `inflight` are 0."""
    with _LOCK:
        keys = list(_PROGRAMS)
        costed = sum(1 for v in _PROGRAMS.values() if v.get("cost"))
    return {
        "enabled": bank_enabled(),
        "programs": len(keys),
        "failed_compiles": 0,
        "costed_programs": costed,
        "inflight": 0,
        "max_programs": _MAX_PROGRAMS,
        "manifest_dir": manifest_dir(),
        "keys": keys[:50],
    }


def manifest_dir() -> "str | None":
    """The manifest's folder: MPLC_TORCH_COMPILE_CACHE_DIR, or None (the
    bank is then process-local)."""
    return os.environ.get(constants.COMPILE_CACHE_DIR_ENV) or None


def _device_kind(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


class ProgramBank:
    """An engine's view onto the process-global program store.

    `shared=True` (the live tier's mode) keys programs by the game's shape
    (the model and the shapes and dtypes of the staged data) instead of
    its identity, so two tenants of one shape, or one game after a
    restart, share keys; the default per-game scope keys by the engine's
    cache fingerprint, less the content hash of its staged data (the JAX
    key's `data_digest`): an eager program is the same for any data of
    one shape, and hashing the data would copy all of it to the host on
    a new engine's first batch."""

    def __init__(self, engine, shared: bool = False):
        self.engine = engine
        self.shared = shared
        self._digest_cache = None

    # -- program identity ------------------------------------------------

    def _shape_signature(self) -> list:
        eng = self.engine

        def sig(tensors):
            return [[list(t.shape), str(t.dtype).replace("torch.", "")] for t in tensors]

        return [eng.model.name, sig([eng.stacked.x, eng.stacked.y, eng.stacked.mask]),
                sig([eng.val.x, eng.val.y]), sig([eng.test.x, eng.test.y])]

    def _engine_digest(self) -> str:
        if self._digest_cache is None:
            if self.shared:
                fp = json.dumps(self._shape_signature(), default=str)
            else:
                fp = json.dumps([self._shape_signature(),
                                 self.engine._fingerprint(data_digest=False)],
                                sort_keys=True, default=str)
            self._digest_cache = hashlib.sha256(fp.encode()).hexdigest()[:16]
        return self._digest_cache

    def program_key(self, pipe, slot_count, width) -> str:
        """A training program's identity: the engine digest x the
        trainer's config (its epochs among it) x the partner count x the
        slot count x the batch width x the device."""
        cfg = pipe.trainer.cfg
        raw = json.dumps([self._engine_digest(), repr(cfg), pipe.partners_count,
                          slot_count, int(width), int(cfg.epoch_count),
                          _device_kind(self.engine.device)])
        return hashlib.sha256(raw.encode()).hexdigest()[:24]

    def recon_key(self, evaluator, width: int) -> str:
        """A reconstruction program's identity: the engine digest, the
        recorded rounds (the stream's depth), the partner count, the mask
        width, the device and the precision (a bf16 program never serves
        an fp32 query)."""
        rec = evaluator.recorded
        raw = json.dumps([self._engine_digest(), "recon", int(rec.weights.shape[0]),
                          self.engine.partners_count, int(width),
                          _device_kind(self.engine.device), evaluator.precision])
        return hashlib.sha256(raw.encode()).hexdigest()[:24]

    # -- the engine-facing operations ------------------------------------

    def _acquire(self, key: str, entry: dict, cost_fn) -> dict:
        """The entry under `key`, recorded (with `cost_fn()`'s FLOPs, and
        into the manifest) when the key is new; a `bank.hits` count when
        it is not."""
        with _LOCK:
            found = _PROGRAMS.get(key)
        if found is not None:
            obs_metrics.counter("bank.hits").inc()
            return found
        flops = cost_fn()
        entry = {**entry, "cost": {"flops": float(flops)} if flops else None}
        with _LOCK:
            found = _PROGRAMS.setdefault(key, entry)
            while len(_PROGRAMS) > _MAX_PROGRAMS:
                _PROGRAMS.pop(next(iter(_PROGRAMS)))
        if found is entry:
            obs_metrics.counter("bank.programs").inc()
            self._record_manifest(key, entry["cost"])
        return found

    def acquire(self, pipe, slot_count, width, flops: "float | None" = None):
        """Record one training batch's program (its counted FLOPs as the
        cost) and return its entry; None when the bank is disabled. The
        caller runs its eager path either way."""
        if not bank_enabled():
            return None
        key = self.program_key(pipe, slot_count, width)
        return self._acquire(key, {"kind": "train", "slot_count": slot_count,
                                   "width": int(width)}, lambda: flops)

    def acquire_recon(self, evaluator, width: int):
        """Record one reconstruction batch's program (`recon_flops`) and
        return its entry; None when the bank is disabled."""
        if not bank_enabled():
            return None
        key = self.recon_key(evaluator, width)
        return self._acquire(key, {"kind": "recon", "slot_count": None, "width": int(width)},
                             lambda: recon_flops(evaluator, width))

    # -- persistence -----------------------------------------------------

    def _manifest_doc(self) -> dict:
        d = manifest_dir()
        if not d:
            return {}
        try:
            with open(os.path.join(d, MANIFEST_NAME)) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def persistent_keys(self) -> set:
        return set(self._manifest_doc().get("programs", []))

    def persistent_costs(self) -> dict:
        """key -> {"flops"} for every manifest program with a count."""
        return dict(self._manifest_doc().get("costs", {}))

    def _record_manifest(self, key: str, cost: "dict | None" = None) -> None:
        """Add a program's key (and its cost) to the manifest, replaced
        atomically; a failed write warns and costs nothing but the record."""
        d = manifest_dir()
        if not d:
            return
        with _MANIFEST_LOCK:
            doc = self._manifest_doc()
            keys = set(doc.get("programs", []))
            costs = dict(doc.get("costs", {}))
            if key in keys and (cost is None or key in costs):
                return
            keys.add(key)
            if cost is not None:
                costs[key] = cost
            path = os.path.join(d, MANIFEST_NAME)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                os.makedirs(d, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump({"programs": sorted(keys), "costs": costs}, f)
                os.replace(tmp, path)
            except OSError as e:
                logger.warning("program-bank manifest write failed: %s", e)

    def holds_persistent(self, plan) -> bool:
        """True when the manifest holds every program of `plan`, a list of
        (pipe, slot_count, width): an earlier run recorded them all."""
        if not bank_enabled() or not plan:
            return False
        keys = self.persistent_keys()
        return bool(keys) and all(self.program_key(pipe, slot_count, width) in keys
                                  for pipe, slot_count, width in plan)


def recon_flops(evaluator, width: int) -> "float | None":
    """The FLOPs of one reconstruction batch of `width` coalitions: K1's
    contraction (2 x width x K x Dp) and the evaluation of `width` models
    on the test set (the calls `MplTrainer.eval_calls` lists, counted by
    `call_flops`). None when the evaluation cannot be counted."""
    from ..mpl.engine import call_flops
    eng = evaluator.engine
    K, Dp = evaluator._d2.shape
    evals = call_flops(eng.model, eng.trainer.eval_calls(int(width), eng.test), eng.stacked.x)
    return None if evals is None else 2.0 * width * K * Dp + evals
