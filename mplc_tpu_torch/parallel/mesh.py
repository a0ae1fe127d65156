"""Meshes of ranks for coalition and partner parallelism (port of
`mplc_tpu/parallel/mesh.py`), over `torch.distributed`.

The JAX package drives every device from one process: `shard_map` runs
the per-shard code and its collectives move data between shards. The port
runs SPMD, one process ("rank") a device, as PyTorch does: every rank runs
the same code on its own shard, and where the JAX trainer calls a
collective on a mesh axis, the port's calls it on that axis's process
group. The JAX package's devices are the ranks of the default group, and
`len(jax.devices())` is the world size.

  - `coal`: the primary axis. Independent coalition trainings spread over
    it and share nothing until their scores are gathered.
  - `part` (a 2-D mesh): the partner axis of one coalition's training split
    over the ranks of a mesh row; each round's aggregation is then the
    framework's only cross-rank weight traffic (ops/aggregation.py).

The world comes from the launcher (`torchrun`, or `parallel/launch.py`),
which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
`init_world` forms it (NCCL on the card, gloo on the CPU), and the entry
points call it, never an import. A process without that environment is a
world of 1, as before this module; one that finds WORLD_SIZE > 1 and
cannot form the group raises and never carries on alone.

`Mesh.axis(name)` gives this rank's line along an axis as an `AxisGroup`
(its ranks in mesh order, its index there, the torch group). Making the
groups is collective: every rank makes the group of every line of the
axis, in one order, those it is not in included, so the first `axis` call
of a mesh must come on every rank. Groups are made once a process and line
and wait at most `constants.PROCESS_GROUP_TIMEOUT_SEC` in a collective. A
mesh of one rank with no world formed has lines without a group, whose
collectives return their input: the unsharded reference of the same code.

`agreed(fn)` runs a step whose failure every rank must share before the
next collective (the engine's batches: an OOM on one rank steps every
rank's ladder, or the healthy ranks would wait in a collective the failed
one never reaches). A step that runs a line's collectives itself (the 2-D
pipeline's training, over its mesh row) calls `AxisGroup.agree()` before
each of them, and `agreed(fn, row)` takes a failure there: the failed
rank reports to the row's next agreement point, where its peers are
waiting, so a rank that fails inside a training leaves no peer in a
collective. A line agrees over a gloo group of its own, on the host, so an
agreement point never waits for the card. What stays uncovered is a
failure inside a collective itself, which ends in the group's timeout.
`agreed_min` gives every rank the least of a value (the engine's batch
cap, which each card measures in its own memory).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import constants, faults
from ..obs import metrics as obs_metrics

# The kinds of collective this module issues, each counted in the metrics
# registry as `mesh.<kind>`: the aggregations' "all_gather" and
# "all_reduce" (a caller divides them by the rounds it ran for collectives
# a round), the engine's "scores" gathers and its "agree" all-reduces (one
# each a batch's dispatch and harvest and a bucket's cap, and on the 2-D
# pipeline one over the row a round and one at the end of a training).
COLLECTIVE_KINDS = ("all_gather", "all_reduce", "scores", "agree")


def collectives() -> dict:
    """{kind: collectives issued so far} (`COLLECTIVE_KINDS`)."""
    return {k: int(obs_metrics.counter(f"mesh.{k}").value) for k in COLLECTIVE_KINDS}


def world_size() -> int:
    """Ranks of the default group; 1 where none is formed."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_rank() -> int:
    """This rank's index on its host (the launcher's LOCAL_RANK; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0) if world_size() > 1 else 0


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=constants.PROCESS_GROUP_TIMEOUT_SEC)


def init_world(device=None) -> int:
    """Form the default group from the launcher's environment and return
    the world size: NCCL when `device` (None: CUDA) is a CUDA device, each
    rank on card LOCAL_RANK, gloo otherwise. Without WORLD_SIZE, or at 1,
    nothing is formed and the world is 1; a group already formed is kept.
    A failure to form it raises: a rank never runs alone in a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    n = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if n <= 1:
        return 1
    if not dist.is_available():
        raise RuntimeError(f"WORLD_SIZE={n} but this torch has no torch.distributed")
    device = torch.device("cuda" if device is None else device)
    kw = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"WORLD_SIZE={n} on CUDA, but no CUDA device is available")
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0") or 0))
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=_timeout(), **kw)
    return dist.get_world_size()


def destroy_world() -> None:
    """Destroy the default group and forget the groups made over it."""
    _GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _backend_device(group) -> torch.device:
    """Where a collective's tensors must lie for `group`'s backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """A rank as the mesh builders see it: its global rank and its host (the
    JAX device's `id` and `process_index`)."""
    rank: int
    host: int = 0


def world_ranks() -> list:
    """The world's ranks, each on host rank // LOCAL_WORLD_SIZE (the
    launcher gives every host the same count)."""
    n = world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n) or n) if n > 1 else 1
    return [RankInfo(r, r // per_host) for r in range(n)]


def _rank_id(r) -> int:
    return int(getattr(r, "rank", r))


class AxisGroup:
    """This rank's line along one mesh axis: `ranks` in mesh order, this
    rank's `index` among them, the torch `group` (None: a line of this rank
    alone with no world formed, whose collectives return their input) and
    the gloo `host_group` its agreements run over (the group itself on a
    gloo world)."""

    def __init__(self, ranks: tuple, index: int, group=None, host_group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.index = int(index)
        self.group = group
        self.host_group = host_group if host_group is not None else group
        self.size = len(self.ranks)
        # the torch group's rank of each mesh position (torch orders a
        # group's ranks itself), so a gather comes back in mesh order
        self._order = (tuple(dist.get_group_rank(group, r) for r in self.ranks)
                       if group is not None else (0,))

    def __repr__(self) -> str:
        return f"AxisGroup(ranks={self.ranks}, index={self.index})"

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   tag: str = "all_gather") -> torch.Tensor:
        """The line's tensors concatenated along `dim` in mesh order. Moves
        bytes and does no arithmetic. `tag` is the kind it counts as."""
        if self.group is None:
            return t
        dev = _backend_device(self.group)
        src = t.to(dev).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        obs_metrics.counter(f"mesh.{tag}").inc()
        return torch.cat([parts[i] for i in self._order], dim).to(t.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the line's tensors: `t` itself, summed in place, where
        it lies on the backend's device, else a new tensor on `t`'s."""
        if self.group is None:
            return t
        dev = _backend_device(self.group)
        buf = t.to(dev)
        dist.all_reduce(buf, group=self.group)
        obs_metrics.counter("mesh.all_reduce").inc()
        return buf.to(t.device)

    def agree(self) -> None:
        """An agreement point before this line's next collective: returns
        when no rank of the line reported a failure, else raises a mirror
        of the worst (`agreed`). A line of one rank has no one to tell."""
        if self.size > 1:
            _agree(None, self)


# (torch group, gloo host group) a line of ranks, made once a process
# (sorted ranks)
_GROUPS: dict = {}


def _group(ranks: tuple) -> tuple:
    key = tuple(sorted(ranks))
    if key not in _GROUPS:
        group = dist.new_group(list(key), timeout=_timeout())
        # the host group for agreements: made on every rank, in this order
        host = (dist.new_group(list(key), timeout=_timeout(), backend="gloo")
                if dist.get_backend() != "gloo" else group)
        _GROUPS[key] = group, host
    return _GROUPS[key]


class Mesh:
    """An integer array of ranks with one name an axis (the JAX Mesh's
    `devices` and `axis_names`)."""

    def __init__(self, ranks, axis_names):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.ranks.shape} needs "
                             f"{self.ranks.ndim} axis names, got {self.axis_names}")
        self._axes: dict = {}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return f"Mesh({self.ranks.tolist()}, {self.axis_names})"

    def axis(self, name: str) -> AxisGroup:
        """This rank's line along axis `name`. The first call of an axis
        makes the group of every line of it, on every rank (see the module
        docstring)."""
        if name in self._axes:
            return self._axes[name]
        ax = self.axis_names.index(name)
        lines = np.moveaxis(self.ranks, ax, -1).reshape(-1, self.ranks.shape[ax])
        me = world_rank()
        if not (dist.is_available() and dist.is_initialized()):
            if self.size != 1:
                raise RuntimeError(f"{self!r} needs a world of {self.size} ranks; "
                                   "none is formed (init_world)")
            group = AxisGroup((me,), 0)
        else:
            group = None
            for line in lines:
                g, host = _group(tuple(int(r) for r in line))
                if me in line:
                    group = AxisGroup(tuple(line), int(np.where(line == me)[0][0]), g, host)
            if group is None:
                raise ValueError(f"rank {me} is not in {self!r}")
        self._axes[name] = group
        return group


@dataclasses.dataclass
class CoalitionSharding:
    """A batch of coalition trainings spread over the `coal` axis of
    `mesh` (the engine's 1-D mode over the world)."""
    mesh: Mesh

    @property
    def num_devices(self) -> int:
        return self.mesh.size


def make_mesh(ranks=None, axis_name: str = "coal") -> Mesh:
    ranks = world_ranks() if ranks is None else ranks
    return Mesh([_rank_id(r) for r in ranks], (axis_name,))


def coalition_sharding(ranks=None) -> CoalitionSharding | None:
    """The coalition batch's sharding over `ranks` (None: the world);
    None for a single rank, as the JAX package returns on one device."""
    ranks = world_ranks() if ranks is None else ranks
    if len(ranks) <= 1:
        return None
    return CoalitionSharding(mesh=make_mesh(ranks))


def make_2d_mesh(coal: int, part: int, ranks=None) -> Mesh:
    """[coal, part] mesh: the coalition batch x the partner axis.

    Raises ValueError when the grid does not tile the rank list exactly
    (a mis-shaped mesh would train the wrong partition)."""
    ranks = list(world_ranks() if ranks is None else ranks)
    if coal * part != len(ranks):
        raise ValueError(f"mesh {coal}x{part} needs {coal * part} devices, have "
                         f"{len(ranks)}")
    return Mesh(np.asarray([_rank_id(r) for r in ranks]).reshape(coal, part),
                ("coal", "part"))


def make_multihost_mesh(part: int = 1, ranks=None) -> Mesh:
    """N-host x local [coal, part] mesh: `coal` spans hosts (coalition
    batches share nothing, so the axis crosses the slow fabric for free)
    while `part` stays inside a host, so each round's partner collective
    never leaves one. Ranks are grouped by host (`RankInfo.host`; a plain
    int is on host 0) and ordered by rank within a host, so every process
    builds the same layout. ValueErrors: uneven per-host rank counts, or
    `part` not dividing the per-host count."""
    ranks = list(world_ranks() if ranks is None else ranks)
    by_host: dict = {}
    for r in ranks:
        by_host.setdefault(getattr(r, "host", 0), []).append(_rank_id(r))
    counts = {h: len(rs) for h, rs in by_host.items()}
    if len(set(counts.values())) != 1:
        raise ValueError(f"multi-host mesh needs the same device count on every host, "
                         f"got {counts}")
    local = next(iter(counts.values()))
    if part < 1 or local % part:
        raise ValueError(f"part={part} must be >= 1 and divide the per-host device "
                         f"count ({local}); hosts={sorted(by_host)}")
    rows = [np.asarray(sorted(by_host[h])).reshape(local // part, part)
            for h in sorted(by_host)]
    return Mesh(np.concatenate(rows, axis=0), ("coal", "part"))


class PeerFailure(RuntimeError):
    """A peer rank's failure, mirrored on a rank whose own step went through
    (`agreed`). Its message leads with `UNAVAILABLE` when the peer's was
    transient, so the classifier retries it alike."""


class PeerOom(torch.cuda.OutOfMemoryError):
    """A peer rank's OOM, mirrored: it drives this rank's cap halving."""


def _failure_code(err) -> int:
    """0 none, 1 transient, 2 OOM, 3 any other exception, 4 a kill (a
    BaseException): the worse failure wins an agreement."""
    if err is None:
        return 0
    if not isinstance(err, Exception):
        return 4
    if faults.is_transient(err):
        return 1
    return 2 if faults.is_oom(err) else 3


def _agree(err, line=None) -> None:
    """One agreement: an all-reduce (max) of every rank's failure class
    (`_failure_code` of `err`, None: none) over `line`'s host group (None:
    the world's default group). Returns when no rank failed; else raises
    `err` where it is of the agreed class, or a mirror of it (`PeerFailure`,
    `PeerOom`), marked as agreed over `line`."""
    group = None if line is None else line.host_group
    flag = torch.tensor([_failure_code(err)], dtype=torch.int32,
                        device=torch.device("cpu") if line is not None
                        else _backend_device(None))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    obs_metrics.counter("mesh.agree").inc()
    code = int(flag.item())
    if code == 0:
        return
    if err is not None and _failure_code(err) == code:
        raised = err
    elif code == 1:
        raised = PeerFailure("UNAVAILABLE: a peer rank failed transiently")
    elif code == 2:
        raised = PeerOom("out of memory on a peer rank")
    else:
        raised = PeerFailure("a peer rank failed; this rank stops with it")
    raised._agreed_over = line
    if raised is err:
        raise raised
    raise raised from err


def agreed(fn, row: AxisGroup | None = None):
    """`fn()` with its failure agreed across the world: one all-reduce (max)
    of every rank's failure class. When any rank failed, every rank raises:
    its own error where it is of the agreed class, else a mirror of it
    (`PeerFailure`, `PeerOom`), so every rank takes the same rung of the
    fault ladder. At a world of 1, `fn()`.

    `row`: the line whose collectives `fn` runs, calling `row.agree()`
    before each. A failure is first agreed over the row, unless an
    agreement point inside `fn` already did, and a step that went through
    ends with one more row agreement (a peer may have failed after the
    last point), so every rank of the row leaves `fn` together."""
    if world_size() == 1:
        return fn()
    err = out = None
    try:
        out = fn()
        if row is not None and row.size > 1:
            _agree(None, row)
    except BaseException as e:  # noqa: BLE001 - agreed first, raised below
        err = e
        if row is not None and row.size > 1 and getattr(e, "_agreed_over", None) is not row:
            try:
                _agree(e, row)
            except BaseException as agreed_err:  # noqa: BLE001 - the row's verdict
                err = agreed_err
    _agree(err, None)
    return out


def agreed_min(value: int) -> int:
    """The least of `value` over the world's ranks (one all-reduce); the
    value itself at a world of 1."""
    if world_size() == 1:
        return value
    t = torch.tensor([int(value)], dtype=torch.int64, device=_backend_device(None))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    obs_metrics.counter("mesh.agree").inc()
    return int(t.item())
