"""Sweep-as-a-service in one process (port of `mplc_tpu/service/`):
fault-isolated multi-tenant sweep scheduling with a device-pinned worker
pool and journaled crash recovery (scheduler.py), SLO-driven admission
control, priority tiers and load shedding (admission.py), cross-tenant
program packing bookkeeping (packer.py) and the checksummed write-ahead
journal (journal.py) that the service and the live tier's games ride,
and the fleet router (router.py): the redirect-acting, tenant-sticky
front over N service shards, with failover by journal replay."""

from .admission import AdmissionController, TierQueue
from .journal import JournalCorruptError, SweepJournal
from .packer import CrossTenantPacker
from .router import FleetRouter, RoutedJobFailed
from .scheduler import (JobCancelled, JobQuarantined, JobShed,
                        ServiceAuthError, ServiceClosed, ServiceError,
                        ServiceOverloaded, ServiceRejected, SweepJob,
                        SweepService)

__all__ = [
    "AdmissionController",
    "CrossTenantPacker",
    "FleetRouter",
    "JobCancelled",
    "JobQuarantined",
    "JobShed",
    "JournalCorruptError",
    "RoutedJobFailed",
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
