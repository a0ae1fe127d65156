"""The port's reconstruction contraction (K1's module) against the JAX
package's `reconstruct_batch` run through the Pallas kernel in interpret
mode (as tests/test_recon_kernel.py runs it), and against a numpy replay.
On the CPU the wrapper takes the plain version; it must never do so for a
tensor that asks for the kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mplc_tpu.ops import recon_kernel as jrk
from mplc_tpu_torch.ops import recon_kernel as trk
from test_recon_kernel import _fixture_game, _np_reference

torch.set_num_threads(1)

# (B, R, P): the JAX suite's odd fixture (K=12, D=22), the smallest game
# the fixture builds, and a wider odd one
SHAPES = [(5, 3, 4), (2, 2, 2), (9, 7, 3)]


def _t(tree):
    return {"p": {k: torch.from_numpy(v) for k, v in tree.items()}}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("B,R,P", SHAPES)
def test_normalized_round_weights_match_and_contract(B, R, P):
    masks, _, _, weights = _fixture_game(B=B, R=R, P=P, seed=B)
    got = trk.normalized_round_weights(torch.from_numpy(masks),
                                       torch.from_numpy(weights)).numpy()
    ref = np.asarray(jrk.normalized_round_weights(jnp.asarray(masks),
                                                  jnp.asarray(weights)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    denom = (weights[None] * masks[:, None]).sum(-1)
    np.testing.assert_array_equal(got[denom == 0], 0.0)   # exact zeros
    np.testing.assert_allclose(got.sum(-1)[denom > 0], 1.0, rtol=1e-6)


@pytest.mark.parametrize("B,R,P", SHAPES)
def test_reconstruct_batch_matches_interpret_kernel_and_replay(B, R, P):
    masks, init, deltas, weights = _fixture_game(B=B, R=R, P=P, seed=B)
    launches = trk.launches
    got = trk.reconstruct_batch(torch.from_numpy(masks), _t(init), _t(deltas),
                                torch.from_numpy(weights))["p"]
    assert trk.launches == launches          # the CPU never launches K1
    ref = jrk.reconstruct_batch(jnp.asarray(masks), _j(init), _j(deltas),
                                jnp.asarray(weights), interpret=True)
    replay = _np_reference(masks, init, deltas, weights)
    for k in init:
        g = got[k].numpy()
        assert g.shape == (B,) + init[k].shape and g.dtype == np.float32
        # the same fp32 sum in another association
        np.testing.assert_allclose(g, np.asarray(ref[k]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, replay[k], rtol=1e-5, atol=1e-5)
        # the zero-weight coalition passes init through bit-exactly
        np.testing.assert_array_equal(g[0], init[k])


def test_flatten_unflatten_round_trip():
    _, init, deltas, weights = _fixture_game()
    R, P = weights.shape
    flat_init, d2, layout = trk.flatten_stream(_t(init), _t(deltas), R * P)
    assert d2.shape == (R * P, sum(v.size for v in init.values()))
    back = trk.unflatten(flat_init.reshape(1, -1), layout)["p"]
    for k, v in init.items():
        np.testing.assert_array_equal(back[k][0].numpy(), v)


def test_cpu_wrapper_is_the_plain_version():
    rng = np.random.default_rng(1)
    wn2, d2, init = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.random((3, 4)), rng.standard_normal((4, 7)), rng.standard_normal(7)))
    assert torch.equal(trk.fused_contract(wn2, d2, init),
                       trk.fused_contract_reference(wn2, d2, init))


def test_kernel_route_raises_without_the_card():
    """A tensor that is not on the CPU asks for the kernel; with no card the
    wrapper raises and never runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    launches = trk.launches
    meta = [torch.empty(s, device="meta") for s in ((3, 4), (4, 7), (7,))]
    with pytest.raises(ValueError, match="CUDA"):
        trk.fused_contract(*meta)
    cpu = [torch.zeros(s) for s in ((3, 4), (4, 7), (7,))]
    with pytest.raises(ValueError, match="CUDA"):
        trk._launch(*cpu)
    assert trk.launches == launches
