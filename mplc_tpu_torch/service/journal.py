"""Write-ahead journal: crash recovery as replay (port of
`mplc_tpu/service/journal.py`, the same file format, so a journal written
by either package replays in the other).

Format: JSONL, one record per line:

    {"sha256": "<hex>", "rec": {...}}

where the checksum covers the canonical serialization of `rec`
(`json.dumps(rec, sort_keys=True)`). Appends are flushed and fsync'd
before `append` returns: a record the caller acted on is durable by the
time anyone can observe the action.

Replay distinguishes two failure shapes:

  - a TORN TAIL: the final line fails to parse or checksum, the signature
    of a kill mid-append. The bad bytes are quarantined to `<path>.torn`,
    the journal is truncated back to the last good record, and replay
    succeeds with everything before the tear;
  - MID-FILE corruption: a bad line with good records after it cannot be
    a torn append; something rewrote history. That raises
    `JournalCorruptError` (after a flight-recorder dump): recovery must
    never silently skip interior records.

Float values round-trip exactly through `json` (repr-based float
serialization), so replayed records are bit-identical to the appended
ones: the property the live tier's kill -> restart equality rests on.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings


class JournalCorruptError(ValueError):
    """A journal record BEFORE the tail failed to parse or checksum: not a
    torn append but rewritten history. Distinct from the torn-tail case,
    which replay quarantines and survives."""


def _checksum(rec: dict) -> str:
    return hashlib.sha256(json.dumps(rec, sort_keys=True).encode()).hexdigest()


class SweepJournal:
    """Append-only, checksummed, fsync'd journal. Appends are serialized
    by an internal lock: two interleaved writes to one append handle would
    tear both records."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = None
        self._lock = threading.Lock()

    def _handle(self):
        if self._fh is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._fh = open(self.path, "ab")
        return self._fh

    def append(self, rec: dict) -> None:
        """Durably append one record: the line is flushed and fsync'd
        before this returns."""
        self.append_many([rec])

    def append_many(self, recs) -> None:
        """One durability point for a batch of records: every line is
        written, then one flush and fsync. A kill mid-batch leaves a torn
        tail that replay quarantines, as a kill mid-append would."""
        if not recs:
            return
        with self._lock:
            fh = self._handle()
            for rec in recs:
                fh.write(json.dumps({"sha256": _checksum(rec), "rec": rec}).encode() + b"\n")
            fh.flush()
            os.fsync(fh.fileno())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- recovery --------------------------------------------------------

    @classmethod
    def replay(cls, path) -> tuple[list, bool]:
        """`(records, tail_torn)` for an existing journal file.

        Every good record's `rec` dict is returned in append order. A bad
        FINAL line (parse failure or checksum mismatch) is quarantined to
        `<path>.torn`, the journal is truncated back to the last good
        record, `tail_torn` is True and a warning names the quarantine
        file. A bad line with good records after it raises
        `JournalCorruptError`. A missing file replays as an empty
        journal."""
        path = str(path)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return [], False

        records = []
        good_end = 0  # byte offset just past the last good line
        offset = 0
        bad_at = None  # (byte offset, reason) of the first bad line
        for line in raw.split(b"\n"):
            line_end = offset + len(line) + 1  # +1 for the split "\n"
            if line.strip():
                reason = None
                try:
                    doc = json.loads(line)
                    rec = doc["rec"]
                    if _checksum(rec) != doc.get("sha256"):
                        reason = "checksum mismatch"
                except (ValueError, KeyError, TypeError) as e:
                    reason = f"unparseable record ({e})"
                if reason is not None:
                    if bad_at is None:
                        bad_at = (offset, reason)
                else:
                    if bad_at is not None:
                        # a good record after a bad one: history itself is
                        # corrupt. The flight recorder dumps first, so the
                        # postmortem shows what the process was doing
                        from ..obs import flight as obs_flight
                        postmortem = obs_flight.dump(
                            "journal_corrupt",
                            extra={"journal": path, "offset": bad_at[0],
                                   "reason": bad_at[1]})
                        raise JournalCorruptError(
                            f"journal {path} has a corrupt record at byte "
                            f"{bad_at[0]} ({bad_at[1]}) followed by valid "
                            "records — this is not a torn tail; refusing "
                            "to replay selectively"
                            + (f" (postmortem flight record: {postmortem})"
                               if postmortem else ""))
                    records.append(rec)
                    good_end = min(line_end, len(raw))
            offset = line_end

        if bad_at is None:
            return records, False

        # torn tail: quarantine the bad bytes, truncate back to the last
        # good record, and carry on
        torn = raw[bad_at[0]:]
        torn_path = path + ".torn"
        with open(torn_path, "wb") as f:
            f.write(torn)
            f.flush()
            os.fsync(f.fileno())
        with open(path, "r+b") as f:
            f.truncate(good_end)
            f.flush()
            os.fsync(f.fileno())
        from ..obs import metrics as obs_metrics
        obs_metrics.counter("service.journal_torn_records").inc()
        warnings.warn(
            f"sweep journal {path} ended in a torn record "
            f"({bad_at[1]}; the kill landed mid-append) — {len(torn)} "
            f"bytes quarantined to {torn_path}, journal truncated to the "
            f"last good record ({len(records)} records replayed)",
            stacklevel=2)
        return records, True
