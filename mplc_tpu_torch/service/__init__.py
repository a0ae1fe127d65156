"""The sweep service's ported part: the checksummed write-ahead journal
(journal.py) that the live tier's games ride. The scheduler, admission,
packer and router are ROADMAP.md queue 1 item 9."""

from .journal import JournalCorruptError, SweepJournal

__all__ = ["JournalCorruptError", "SweepJournal"]
