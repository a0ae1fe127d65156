"""The port's meshes of ranks (`mplc_tpu_torch/parallel/mesh.py`) against
the JAX package's meshes of devices (`mplc_tpu/parallel/mesh.py`), and the
mesh's groups and collectives in a world of 4 gloo ranks on the CPU:

(a) `make_mesh`, `make_2d_mesh` and `make_multihost_mesh` lay the same 8
    ids out as the JAX builders do on the conftest's 8 CPU devices, and
    raise the JAX builders' ValueErrors, message for message, on the same
    inputs; the two-host grouping on rank descriptors (`RankInfo`) is JAX's
    on devices of two `process_index`es;
(b) `coalition_sharding` is None at one rank, as JAX's is on one device;
    a mesh of one rank without a world has lines whose collectives return
    their input, and a mesh of 8 without a world refuses to make groups;
(c) in a world of 4: each rank's `coal` and `part` lines, gathers in mesh
    order (a mesh whose rows list their ranks descending included), sums,
    and `agreed`: an OOM, a transient error or a bug on one rank raised on
    every rank, each of its class (`PeerOom`, `PeerFailure`);
(d) `launch.spawn` surfaces every rank's error, and kills the ranks that
    outlive its time limit.
"""

import time

import numpy as np
import pytest
import torch

import jax

from mplc_tpu.parallel import mesh as jmesh
from mplc_tpu_torch.parallel import launch
from mplc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


class _Device:
    """A JAX device stand-in: an id on a host (`process_index`)."""

    def __init__(self, i, host):
        self.id, self.process_index = i, host


def _ids(m) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(m.devices)


def _same(jax_mesh, port_mesh):
    np.testing.assert_array_equal(_ids(jax_mesh), port_mesh.ranks)
    assert tuple(jax_mesh.axis_names) == port_mesh.axis_names
    assert dict(jax_mesh.shape) == port_mesh.shape


def test_layouts_match_jax_on_eight_ids():
    devs = jax.devices()
    assert len(devs) == 8
    ids = [d.id for d in devs]
    _same(jmesh.make_mesh(devs), tmesh.make_mesh(ids))
    _same(jmesh.make_mesh(devs, "part"), tmesh.make_mesh(ids, "part"))
    for coal, part in ((8, 1), (4, 2), (2, 4), (1, 8)):
        _same(jmesh.make_2d_mesh(coal, part, devs), tmesh.make_2d_mesh(coal, part, ids))
    for part in (1, 2, 4, 8):
        _same(jmesh.make_multihost_mesh(part, devs), tmesh.make_multihost_mesh(part, ids))
    sh = tmesh.coalition_sharding(ids)
    assert sh.num_devices == jmesh.coalition_sharding(devs).num_devices == 8
    assert sh.mesh.axis_names == ("coal",)


@pytest.mark.parametrize("build", [
    lambda m, ids: m.make_2d_mesh(3, 2, ids),
    lambda m, ids: m.make_2d_mesh(4, 4, ids),
    lambda m, ids: m.make_multihost_mesh(3, ids),
    lambda m, ids: m.make_multihost_mesh(0, ids),
], ids=["2d_3x2", "2d_4x4", "multihost_part3", "multihost_part0"])
def test_value_errors_match_jax(build):
    with pytest.raises(ValueError) as jerr:
        build(jmesh, jax.devices())
    with pytest.raises(ValueError) as terr:
        build(tmesh, list(range(8)))
    assert str(terr.value) == str(jerr.value)


def test_two_host_grouping_matches_jax():
    """Ranks of two hosts, listed out of order: `coal` spans the hosts,
    every `part` row stays inside one, ranks ascending within a host."""
    order = (5, 1, 7, 3, 0, 4, 2, 6)
    jax_devs = [_Device(i, i // 4) for i in order]
    ranks = [tmesh.RankInfo(i, i // 4) for i in order]
    for part in (1, 2, 4):
        _same(jmesh.make_multihost_mesh(part, jax_devs),
              tmesh.make_multihost_mesh(part, ranks))
        m = tmesh.make_multihost_mesh(part, ranks)
        assert all(len({r // 4 for r in row}) == 1 for row in m.ranks)
    uneven = [tmesh.RankInfo(0, 0), tmesh.RankInfo(1, 0), tmesh.RankInfo(2, 1)]
    with pytest.raises(ValueError) as jerr:
        jmesh.make_multihost_mesh(1, [_Device(0, 0), _Device(1, 0), _Device(2, 1)])
    with pytest.raises(ValueError) as terr:
        tmesh.make_multihost_mesh(1, uneven)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="divide") as jerr:
        jmesh.make_multihost_mesh(3, jax_devs)
    with pytest.raises(ValueError, match="divide") as terr:
        tmesh.make_multihost_mesh(3, ranks)
    assert str(terr.value) == str(jerr.value)


def test_one_rank_has_no_sharding_and_identity_lines():
    assert tmesh.world_size() == 1
    assert tmesh.coalition_sharding() is None
    assert jmesh.coalition_sharding(jax.devices()[:1]) is None
    m = tmesh.make_2d_mesh(1, 1)
    assert m.shape == {"coal": 1, "part": 1} and m.ranks.tolist() == [[0]]
    line = m.axis("part")
    assert (line.ranks, line.index, line.group, line.size) == ((0,), 0, None, 1)
    t = torch.arange(6.0).reshape(2, 3)
    assert line.all_gather(t, dim=1) is t and line.all_reduce(t) is t
    with pytest.raises(RuntimeError, match="needs a world of 8 ranks"):
        tmesh.make_2d_mesh(4, 2, list(range(8))).axis("part")
    assert tmesh.agreed(lambda: 7) == 7
    assert tmesh.init_world("cpu") == 1   # no launcher in the environment


def test_world_of_four_lines_gathers_and_agreement():
    out = launch.spawn("torch_dist_helpers:mesh_rank", 4, timeout=90)
    for r, res in enumerate(out):
        c, p = divmod(r, 2)
        assert res["coal"] == ((p, 2 + p), c)
        assert res["part"] == ((2 * c, 2 * c + 1), p)
        # the row's tensors in mesh order, each rank's [r, 10 + r]
        assert res["gather_part"] == [[2 * c, 10 + 2 * c], [2 * c + 1, 11 + 2 * c]]
        # a row listing its ranks descending gathers descending
        assert res["flipped"] == ((2 * c + 1, 2 * c), 1 - p)
        assert res["gather_flipped"] == [2 * c + 1, 11 + 2 * c, 2 * c, 10 + 2 * c]
        assert res["sum_coal"] == [2 * p + 2, 22 + 2 * p]
        assert res["none"] == r
        # the failing rank raises its own error, every other one its mirror
        assert res["oom"] == (("InjectedOom" if r == 1 else "PeerOom"), True, False)
        assert res["transient"] == (("InjectedTransient" if r == 2 else "PeerFailure"),
                                    False, True)
        assert res["other"] == (("ValueError" if r == 3 else "PeerFailure"), False, False)


def test_spawn_surfaces_a_rank_error():
    with pytest.raises(launch.RankFailed) as err:
        launch.spawn("torch_dist_helpers:no_such_function", 2, timeout=60)
    assert set(err.value.errors) == {0, 1}
    assert "no_such_function" in err.value.errors[0]


def test_spawn_kills_ranks_past_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed) as err:
        launch.spawn("torch_dist_helpers:sleep_rank", 2, (60,), timeout=8)
    assert time.monotonic() - t0 < 30
    assert err.value.errors == {r: "still running after 8 s, killed" for r in (0, 1)}
