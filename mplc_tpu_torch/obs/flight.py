"""Crash flight recorder: postmortem dumps of the always-on span ring (port
of `mplc_tpu/obs/flight.py`).

The spans an operator needs after a failure are those of the run nobody
was tracing on purpose, so `obs/trace.py` keeps a bounded ring of the most
recent records (`MPLC_TORCH_FLIGHT_RECORDER_SIZE`, default 512) whatever
the sinks, and `dump()` writes it with a full metrics snapshot to one JSON
file. Three terminal failures call it, as in the JAX package: a
quarantined service job (service/scheduler.py), an exhausted
out-of-memory ladder (contrib/engine.py `_ladder_exhausted`, the 2-D
mode's included) and a corrupt service journal (service/journal.py).

File format (one JSON object):

    {"reason": str, "ts": epoch-s, "pid": int, "extra": {...},
     "ring_records": [trace records, oldest first],
     "metrics": metrics.snapshot()}

Files land in `MPLC_TORCH_FLIGHT_RECORDER_DIR` (default: the working
directory) as `mplc_flight_<reason>_<pid>_<seq>.json`, written to a
temporary file and renamed into place. `dump()` never raises: a
postmortem writer that can itself kill the process (a full disk during an
out-of-memory spiral) is worse than no postmortem.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time

logger = logging.getLogger("mplc_tpu_torch")

FLIGHT_DIR_ENV = "MPLC_TORCH_FLIGHT_RECORDER_DIR"

_seq = itertools.count(1)


def dump(reason: str, extra: dict | None = None) -> str | None:
    """Write a postmortem file for `reason`; its path, or None when the
    dump failed (logged, never raised)."""
    try:
        from . import metrics, trace

        records = trace.flight_records()
        payload = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "extra": dict(extra or {}),
            "ring_records": records,
            "metrics": metrics.snapshot(),
        }
        out_dir = os.environ.get(FLIGHT_DIR_ENV) or "."
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"mplc_flight_{reason}_{os.getpid()}_{next(_seq)}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        metrics.counter("obs.flight_dumps").inc()
        trace.event("flight.dump", reason=reason, path=path,
                    records=len(records))
        return path
    except Exception as e:  # noqa: BLE001 — the no-raise contract
        logger.error("flight recorder: postmortem dump for %r failed: %s",
                     reason, e)
        return None
