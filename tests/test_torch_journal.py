"""The port's write-ahead journal (`mplc_tpu_torch/service/journal.py`)
against the JAX package's (`mplc_tpu/service/journal.py`), on the CPU: a
journal written by either replays in the other with the same records and
the same bytes on disk; a torn tail is quarantined and truncated alike;
mid-file corruption raises in both."""

import json
import shutil

import pytest
import torch

from mplc_tpu.service import journal as jjournal
from mplc_tpu_torch.obs import flight
from mplc_tpu_torch.service import JournalCorruptError, SweepJournal
from mplc_tpu_torch.service import journal as tjournal

torch.set_num_threads(1)

RECORDS = [
    {"type": "live_init", "tenant": "t", "partners_count": 3, "model": "titanic_logreg",
     "params": [[[2, 1], "float32", [0.1, -2.5]], [[1], "float32", [1e-38]]]},
    {"type": "live_round", "tenant": "t", "seq": 1, "weights": [0.2, 0.3, 0.5],
     "deltas": [[[3, 2, 1], "float32", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]]]},
    {"type": "done", "job": 7, "values": {"(0, 1)": 0.6666666865348816}, "nested": [1, [2, 3]]},
    {"unicode": "é", "float": 3.141592653589793, "neg": -0.0},
]

PACKAGES = {"port": tjournal.SweepJournal, "jax": jjournal.SweepJournal}


@pytest.fixture(autouse=True)
def _flight_to_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path / "flight_port"))


def _write(cls, path, batched: bool):
    j = cls(path)
    if batched:
        j.append_many(RECORDS[:2])
        for rec in RECORDS[2:]:
            j.append(rec)
    else:
        for rec in RECORDS:
            j.append(rec)
    j.close()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_a_journal_replays_in_the_other_package(tmp_path, writer, reader, batched):
    path = tmp_path / "wal.jsonl"
    _write(PACKAGES[writer], path, batched)
    records, torn = PACKAGES[reader].replay(path)
    assert records == RECORDS and torn is False
    # records survive a JSON round trip bit for bit
    assert json.dumps(records) == json.dumps(RECORDS)


def test_both_packages_write_the_same_bytes(tmp_path):
    _write(PACKAGES["port"], tmp_path / "a.jsonl", True)
    _write(PACKAGES["jax"], tmp_path / "b.jsonl", True)
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()
    assert tjournal._checksum(RECORDS[0]) == jjournal._checksum(RECORDS[0])


@pytest.mark.parametrize("tail", [b'{"sha256": "ab", "rec": {"ty', b"garbage\n",
                                  b'{"sha256": "00", "rec": {"a": 1}}\n'])
def test_torn_tail_is_quarantined_alike(tmp_path, tail):
    """A bad final line (cut mid-append, unparseable, or failing its
    checksum): both packages return the good records, quarantine the same
    bytes to `.torn` and truncate the journal to the same bytes."""
    src = tmp_path / "src.jsonl"
    _write(PACKAGES["jax"], src, False)
    good = src.read_bytes()
    src.write_bytes(good + tail)
    out = {}
    for name, cls in PACKAGES.items():
        path = tmp_path / f"{name}.jsonl"
        shutil.copy(src, path)
        with pytest.warns(UserWarning, match="torn record"):
            records, torn = cls.replay(path)
        out[name] = (records, torn, path.read_bytes(),
                     (tmp_path / f"{name}.jsonl.torn").read_bytes())
    assert out["port"] == out["jax"]
    records, torn, kept, quarantined = out["port"]
    assert records == RECORDS and torn is True
    assert kept == good and quarantined == tail
    # the truncated journal replays clean, and appends continue after it
    j = SweepJournal(tmp_path / "port.jsonl")
    j.append({"after": 1})
    j.close()
    assert jjournal.SweepJournal.replay(tmp_path / "port.jsonl") == (RECORDS + [{"after": 1}],
                                                                     False)


@pytest.mark.parametrize("where", [0, 1, 2])
def test_mid_file_corruption_raises_in_both(tmp_path, where, monkeypatch):
    monkeypatch.setenv("MPLC_TPU_FLIGHT_RECORDER_DIR", str(tmp_path / "flight_jax"))
    src = tmp_path / "src.jsonl"
    _write(PACKAGES["port"], src, False)
    lines = src.read_bytes().split(b"\n")
    # a record rewritten in place: its checksum no longer matches
    lines[where] = lines[where].replace(b'"type"', b'"Type"', 1)
    src.write_bytes(b"\n".join(lines))
    with pytest.raises(JournalCorruptError, match="not a torn tail"):
        SweepJournal.replay(src)
    with pytest.raises(jjournal.JournalCorruptError, match="not a torn tail"):
        jjournal.SweepJournal.replay(src)
    # the port dumped its flight recorder before raising
    assert list((tmp_path / "flight_port").iterdir())


def test_missing_journal_replays_empty(tmp_path):
    for cls in PACKAGES.values():
        assert cls.replay(tmp_path / "none.jsonl") == ([], False)


def test_append_makes_its_folder(tmp_path):
    path = tmp_path / "a" / "b" / "wal.jsonl"
    j = SweepJournal(path)
    j.append_many([])
    assert not path.exists()
    j.append(RECORDS[0])
    j.close()
    assert SweepJournal.replay(path) == ([RECORDS[0]], False)
