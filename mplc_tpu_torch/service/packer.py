"""Cross-tenant batch packing bookkeeping (port of
`mplc_tpu/service/packer.py`).

The engine buckets a sweep's coalitions into merged slot buckets
(`_slot_buckets` / `_bucket_plan`), and the program bank
(contrib/bank.py) keys each bucket's program process-wide. With the bank
in its SHARED (shape-scoped) key mode, the same `(slots, width)` bucket
maps to the same program key *regardless of which tenant's game a subset
came from* — so a second tenant of the same shape records no new program:
its batches ride programs the first tenant already recorded (the port's
programs are eager torch and CUDA kernels built once a process, so the
key is bookkeeping, as in the bank).

This module is the observation side of that sharing. Device batches
themselves stay single-tenant (one batch closes over ONE game's stacked
data tensor — rows of different tenants can't share a dispatch), so
"packing" means program-level packing: tenant B's bucket lands in tenant
A's slot bucket program. `CrossTenantPacker` tracks which tenants each
program key has served and tells the scheduler, per upcoming bucket,
whether its batches are cross-tenant packed — the scheduler counts every
such batch into `service.cross_tenant_packed_batches` (the acceptance
signal that the sharing is real, paired with the bank-hit assertion that
the second tenant recorded no new program).
"""

from __future__ import annotations

import threading

from ..contrib.bank import ProgramBank


class CrossTenantPacker:
    """Tracks program-key -> tenants served, across every job the service
    has scheduled. The ownership map is lock-guarded: the scheduler's
    worker POOL observes plans from several threads at once."""

    def __init__(self):
        # program key -> set of tenant names whose buckets rode it.
        # Bounded by program diversity (one short hash + tenant names per
        # distinct (shape, slots, width) program — the same space the
        # global bank FIFO-bounds), never by job count.
        self._owners: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _keyer(engine) -> ProgramBank:
        """A transient shared-scope keyer: the packer must hold NO
        reference to any engine (a retained engine pins the tenant's
        device arrays for the service lifetime — the scheduler's
        engine-drop on cancel/quarantine relies on this). The one
        expensive piece, the shape digest, is cached ON the engine."""
        # always key in SHARED scope, even when the engine's own bank is
        # disabled or game-scoped: the packing question is "would these
        # buckets share a program", which is a shape question
        k = ProgramBank(engine, shared=True)
        cached = getattr(engine, "_packer_shape_digest", None)
        if cached is not None:
            k._digest_cache = cached
        else:
            engine._packer_shape_digest = k._engine_digest()
        return k

    def observe_plan(self, tenant: str, engine, plan) -> dict:
        """Register a slice's bucket plan (`[(pipe, slot_count, width)]`,
        the engine's `_bucket_plan` order) for `tenant` and return
        `{slot_count: packed}` — packed=True when that bucket's program
        key has already served a DIFFERENT tenant, i.e. every batch the
        engine dispatches for it is cross-tenant packed."""
        keyer = self._keyer(engine)
        packed: dict = {}
        with self._lock:
            for pipe, slot_count, width in plan:
                key = keyer.program_key(pipe, slot_count, width)
                owners = self._owners.setdefault(key, set())
                shared = bool(owners - {tenant})
                # a slice can hold several None-slot buckets (singles +
                # the masked multi path); flag the slot_count packed if
                # ANY of its buckets is shared
                packed[slot_count] = packed.get(slot_count, False) or shared
                owners.add(tenant)
        return packed

    def tenants_for(self, engine, pipe, slot_count, width) -> set:
        """The tenants whose buckets have ridden this program (tests)."""
        key = self._keyer(engine).program_key(pipe, slot_count, width)
        with self._lock:
            return set(self._owners.get(key, ()))
