"""Partner-axis sharding: federated training with partners spread over
ranks (port of `mplc_tpu/parallel/partner_shard.py`).

The stacked `[P, ...]` partner axis is split over a mesh axis (`part`):
each rank of a row trains its block of P / n partners with the same
trainer, and each round's aggregation reduces over the row
(ops/aggregation.py, `TrainConfig.partner_axis`), the framework's
cross-rank weight traffic.

The same trajectory as the unsharded run: every random draw of a run
comes from its generator in the unsharded trainer's order, over every
partner (`MplTrainer.draw_streams`), and each rank keeps its partners'
rows; dropout masks are keyed by global partner id. Under the
deterministic reduce the sharded run is bit-equal to the unsharded one.

`PartnerShardedTrainer` takes GLOBAL tensors, as the JAX class does, and
returns states whose partner-indexed fields are gathered back to global,
so a caller compares them with an unsharded run's directly.
`TRAIN_STATE_PARTNER_DIMS` and `STACKED_PARTNER_DIMS` are the JAX
module's `train_state_specs` and `stacked_specs`: which fields shard with
the partners, and along which dimension (after the coalition axis B).
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.partition import StackedPartners
from ..mpl.engine import EpochStreams, EvalSet, MplTrainer, TrainState

# TrainState fields split with the partners -> their partner dimension
# (theta and theta_h carry one under lflip only; every other field is
# replicated over the row)
TRAIN_STATE_PARTNER_DIMS = {"theta": 1, "theta_h": 2, "partner_h": 2}
# StackedPartners fields -> their partner dimension
STACKED_PARTNER_DIMS = {"x": 0, "y": 0, "mask": 0, "sizes": 0, "mask_host": 0}
# EpochStreams fields (with the epoch axis, [B, E, ...]) of fedavg and
# lflip -> their partner dimension; the dropout key is a run's, replicated
STREAM_PARTNER_DIMS = {"perms": 2, "flip_u": 3, "dropout_masks": 3}


def train_state_specs(lflip: bool = False) -> dict:
    """{field: partner dim} of a TrainState's sharded fields (theta and
    theta_h only under lflip)."""
    return {k: v for k, v in TRAIN_STATE_PARTNER_DIMS.items()
            if lflip or k == "partner_h"}


def stacked_specs() -> dict:
    return dict(STACKED_PARTNER_DIMS)


def _block(t, dim: int, lo: int, hi: int):
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(_block(m, dim, lo, hi) for m in t)
    return t.narrow(dim, lo, hi - lo)


def slice_stacked(stacked: StackedPartners, lo: int, hi: int) -> StackedPartners:
    """Partners lo..hi-1 of `stacked` (views; the padded row length stays
    the global one, so every shard's windows are the unsharded run's)."""
    return StackedPartners(*(_block(getattr(stacked, f), d, lo, hi)
                             for f, d in STACKED_PARTNER_DIMS.items()))


def slice_streams(streams: EpochStreams, lo: int, hi: int) -> EpochStreams:
    """Partners lo..hi-1 of a chunk's streams ([B, E, ...] fields)."""
    return streams._replace(**{f: _block(getattr(streams, f), d, lo, hi)
                               for f, d in STREAM_PARTNER_DIMS.items()})


def whole_streams(trainer: MplTrainer, generators, stacked: StackedPartners, runs: int,
                  n_epochs: int, streams_all=None) -> EpochStreams:
    """A chunk's streams over every partner: `streams_all` as given (an
    `EpochStreams`, or permutations alone), or `n_epochs` epochs drawn from
    the `runs` generators in the unsharded trainer's order, over every
    partner's validity row."""
    if streams_all is None:
        mask = stacked.mask.cpu() if stacked.mask_host is None else stacked.mask_host
        return trainer.draw_streams(generators, mask.expand(runs, -1, -1), n_epochs)
    return streams_all if isinstance(streams_all, EpochStreams) else EpochStreams(streams_all)


class PartnerShardedTrainer:
    """Runs an `MplTrainer` (fedavg or lflip, its `cfg.partner_axis` this
    rank's line along `mesh`'s `axis`) with the partner axis sharded over
    that axis. `init_state`, `epoch_chunk` and `finalize` mirror
    MplTrainer's on GLOBAL tensors. The global partner count must divide
    by the shard count (pad with empty partners: mask 0, size 0, which
    weigh nothing anywhere)."""

    def __init__(self, trainer: MplTrainer, mesh, axis: str = "part"):
        group = mesh.axis(axis)
        if trainer.cfg.partner_axis is not group:
            raise ValueError(
                f"trainer.cfg.partner_axis={trainer.cfg.partner_axis!r} must be the "
                f"mesh axis {axis!r}'s group {group!r} (build the TrainConfig with "
                "partner_axis=mesh.axis(axis))")
        self.trainer = trainer
        self.mesh = mesh
        self.axis = axis
        self.group = group
        self.n_shards = group.size
        self._specs = train_state_specs(trainer.cfg.approach == "lflip")

    def _bounds(self, partners_count: int) -> tuple[int, int]:
        if partners_count % self.n_shards:
            raise ValueError(f"global partner count {partners_count} not divisible by "
                             f"{self.n_shards} shards — pad with empty partners")
        local = partners_count // self.n_shards
        return self.group.index * local, (self.group.index + 1) * local

    def _local(self, state: TrainState, lo: int, hi: int) -> TrainState:
        return dataclasses.replace(state, **{f: _block(getattr(state, f), d, lo, hi)
                                             for f, d in self._specs.items()})

    def _global(self, state: TrainState) -> TrainState:
        for f, d in self._specs.items():
            setattr(state, f, self.group.all_gather(getattr(state, f), d))
        return state

    def init_state(self, generators, partners_count: int, device,
                   init_params: dict | None = None,
                   init_theta: torch.Tensor | None = None) -> TrainState:
        """`MplTrainer.init_state` of the global run (every partner), the
        initial params drawn from `generators` first, as the unsharded
        trainer draws them."""
        self._bounds(partners_count)
        return self.trainer.init_state(generators, partners_count, device,
                                       init_params, init_theta)

    def epoch_chunk(self, state: TrainState, stacked: StackedPartners, val: EvalSet,
                    coal: torch.Tensor, generators, n_epochs: int, streams_all=None,
                    coal_host=None) -> TrainState:
        """Up to `n_epochs` epochs of the global runs: this rank trains its
        partner block, on the streams the unsharded trainer would draw
        (`streams_all`, global, or drawn whole from `generators`), and the
        returned state's partner fields are the row's, gathered."""
        lo, hi = self._bounds(stacked.partners_count)
        streams_all = whole_streams(self.trainer, generators, stacked, coal.shape[0],
                                    n_epochs, streams_all)
        local = self._local(state, lo, hi)
        self.trainer.epoch_chunk(
            local, slice_stacked(stacked, lo, hi), val, coal[:, lo:hi], None, n_epochs,
            slice_streams(streams_all, lo, hi),
            None if coal_host is None else coal_host[:, lo:hi])
        return self._global(local)

    def finalize(self, state: TrainState, test: EvalSet):
        """The global params are the same on every rank of the row after
        each aggregation: evaluate them locally."""
        return self.trainer.finalize(state, test)
