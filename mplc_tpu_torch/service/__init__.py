"""Sweep-as-a-service in one process (port of `mplc_tpu/service/`):
fault-isolated multi-tenant sweep scheduling with a device-pinned worker
pool and journaled crash recovery (scheduler.py), SLO-driven admission
control, priority tiers and load shedding (admission.py), cross-tenant
program packing bookkeeping (packer.py) and the checksummed write-ahead
journal (journal.py) that the service and the live tier's games ride.

Not yet ported (ROADMAP.md queue 1 item 9b): the fleet router of
`mplc_tpu/service/router.py` — `FleetRouter`, `RoutedJobFailed`,
`ShardUnavailable`, `InProcShard`, `HttpShard` and `ShardServer` — and
the router fault plan."""

from .admission import AdmissionController, TierQueue
from .journal import JournalCorruptError, SweepJournal
from .packer import CrossTenantPacker
from .scheduler import (JobCancelled, JobQuarantined, JobShed,
                        ServiceAuthError, ServiceClosed, ServiceError,
                        ServiceOverloaded, ServiceRejected, SweepJob,
                        SweepService)

__all__ = [
    "AdmissionController",
    "CrossTenantPacker",
    "JobCancelled",
    "JobQuarantined",
    "JobShed",
    "JournalCorruptError",
    "ServiceAuthError",
    "ServiceClosed",
    "ServiceError",
    "ServiceOverloaded",
    "ServiceRejected",
    "SweepJob",
    "SweepJournal",
    "SweepService",
    "TierQueue",
]
