"""The port's reconstruction contraction (K1's module) against the JAX
package's `reconstruct_batch` run through the Pallas kernel in interpret
mode (as tests/test_recon_kernel.py runs it), and against a numpy replay;
likewise its bf16 variant (K1-bf16) against the same Pallas kernel on bf16
operands. On the CPU the wrappers take their plain versions; they must
never do so for a tensor that asks for a kernel."""

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


# ---------------------------------------------------------------------------
# K1-bf16: bf16 operands, fp32 init, fp32 accumulation and result
# ---------------------------------------------------------------------------

def _bf16_operands(B, R, P):
    """(masks, init, deltas, weights, wn2 bf16, d2 bf16, init_flat) of the
    fixture game, flattened by the port."""
    masks, init, deltas, weights = _fixture_game(B=B, R=R, P=P, seed=B)
    flat_init, d2, _ = trk.flatten_stream(_t(init), _t(deltas), R * P, torch.bfloat16)
    wn2 = trk.normalized_round_weights(torch.from_numpy(masks), torch.from_numpy(weights))
    return (masks, init, deltas, weights,
            wn2.reshape(B, -1).to(torch.bfloat16).contiguous(), d2, flat_init)


def _pad_to(a, rows, cols):
    return jnp.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


@pytest.mark.parametrize("B,R,P", SHAPES)
def test_bf16_plain_version_matches_interpret_kernel(B, R, P):
    """The fp32 result of K1-bf16's plain version against the JAX package's
    `_fused_contract` on the same bf16 operands (padded to its tiles),
    through the Pallas interpreter."""
    *_, wn2, d2, init = _bf16_operands(B, R, P)
    launches = trk.launches_bf16
    got = trk.fused_contract_bf16(wn2, d2, init)
    assert trk.launches_bf16 == launches        # the CPU never launches it
    assert got.dtype == torch.float32
    K, D = d2.shape
    Bp, Kp, Dp = -(-B // 8) * 8, -(-K // 128) * 128, -(-D // 128) * 128
    as_bf16 = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    ref = jrk._fused_contract(_pad_to(as_bf16(wn2), Bp, Kp), _pad_to(as_bf16(d2), Kp, Dp),
                              _pad_to(jnp.asarray(init.numpy())[None], 1, Dp),
                              interpret=True)
    # bf16 x bf16 products are exact in fp32: the same fp32 sum, in
    # another association
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:B, :D], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0], init)              # the zero-weight row


@pytest.mark.parametrize("B,R,P", SHAPES)
def test_bf16_reconstruct_batch_matches_interpret_kernel(B, R, P):
    masks, init, deltas, weights, *_ = _bf16_operands(B, R, P)
    launches = trk.launches_bf16
    got = trk.reconstruct_batch(torch.from_numpy(masks), _t(init), _t(deltas),
                                torch.from_numpy(weights), precision="bf16")["p"]
    assert trk.launches_bf16 == launches
    ref = jrk.reconstruct_batch(jnp.asarray(masks), _j(init), _j(deltas),
                                jnp.asarray(weights), precision="bf16", interpret=True)
    replay = _np_reference(masks, init, deltas, weights)
    for k in init:
        g = got[k]
        assert g.dtype == torch.bfloat16 and g.shape == (B,) + init[k].shape
        g = g.float().numpy()
        # the fp32 sums agree to 1e-5, so after the cast to bf16 the
        # leaves are within one bf16 ulp (2^-7 relative, at most)
        np.testing.assert_allclose(g, np.asarray(ref[k], np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)
        # bf16 operands against the fp32 replay: the JAX package's bound
        np.testing.assert_allclose(g, replay[k], rtol=0.05, atol=0.05)
        # the zero-weight coalition: init, cast to bf16
        assert torch.equal(got[k][0], torch.from_numpy(init[k]).to(torch.bfloat16))


def test_bf16_kernel_route_raises_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    launches = trk.launches_bf16
    shapes = ((3, 4), (4, 7), (7,))
    dtypes = (torch.bfloat16, torch.bfloat16, torch.float32)
    meta = [torch.empty(s, device="meta", dtype=d) for s, d in zip(shapes, dtypes)]
    with pytest.raises(ValueError, match="CUDA"):
        trk.fused_contract_bf16(*meta)
    cpu = [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]
    with pytest.raises(ValueError, match="CUDA"):
        trk._launch_bf16(*cpu)
    assert trk.launches_bf16 == launches


def test_flatten_stream_in_the_stream_dtype():
    _, init, deltas, weights = _fixture_game()
    R, P = weights.shape
    flat_init, d2, _ = trk.flatten_stream(_t(init), _t(deltas), R * P, torch.bfloat16)
    assert flat_init.dtype == torch.float32 and d2.dtype == torch.bfloat16
    _, d32, _ = trk.flatten_stream(_t(init), _t(deltas), R * P)
    assert torch.equal(d2, d32.to(torch.bfloat16))
