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


def _round_up(n, m):
    return -(-n // m) * m


def test_flatten_unflatten_round_trip():
    _, init, deltas, weights = _fixture_game()
    R, P = weights.shape
    flat_init, d2, layout = trk.flatten_stream(_t(init), _t(deltas), R * P)
    D = sum(v.size for v in init.values())
    assert d2.shape == (R * P, _round_up(D, 8))
    back = trk.unflatten(flat_init.reshape(1, -1), layout)["p"]
    for k, v in init.items():
        np.testing.assert_array_equal(back[k][0].numpy(), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,R,P", SHAPES)
def test_flatten_stream_pads_rows_with_exact_zeros(B, R, P, dtype):
    """Every row of the flattened stream is padded to a multiple of 8
    values (16 bytes in bf16, 32 in fp32), with exact zeros, in d2 and in
    init; the columns before the padding are the leaves, in order."""
    _, init, deltas, weights = _fixture_game(B=B, R=R, P=P, seed=B)
    K = R * P
    flat_init, d2, layout = trk.flatten_stream(_t(init), _t(deltas), K, dtype)
    D = sum(v.size for v in init.values())
    Dp = _round_up(D, 8)
    assert Dp > D                        # the fixture's D = 22 is padded
    assert d2.shape == (K, Dp) and d2.dtype == dtype and d2.is_contiguous()
    assert flat_init.shape == (Dp,) and flat_init.dtype == torch.float32
    assert torch.equal(d2[:, D:], torch.zeros(K, Dp - D, dtype=dtype))
    assert torch.equal(flat_init[D:], torch.zeros(Dp - D))
    ref = np.concatenate([deltas[k].reshape(K, -1) for k in init], axis=1)
    assert torch.equal(d2[:, :D], torch.from_numpy(ref).to(dtype))
    assert [(g, k) for g, k, _ in layout] == [("p", k) for k in init]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("B,R,P", SHAPES)
def test_reconstruct_flat_tail_is_exact_zeros(B, R, P, precision):
    """The padded columns reconstruct to exact zeros (init's tail plus WN
    times zero deltas) and unflatten never reads them: the leaves equal
    those of a reconstruction from the unpadded columns alone."""
    masks, init, deltas, weights = _fixture_game(B=B, R=R, P=P, seed=B)
    K = R * P
    flat_init, d2, layout = trk.flatten_stream(_t(init), _t(deltas), K,
                                               trk.stream_dtype(precision))
    D = sum(v.size for v in init.values())
    m, w = torch.from_numpy(masks), torch.from_numpy(weights)
    out = trk.reconstruct_flat(m, flat_init, d2, w, precision)
    assert out.shape == (B, _round_up(D, 8))
    assert torch.equal(out[:, D:], torch.zeros(B, out.shape[1] - D, dtype=out.dtype))
    unpadded = trk.reconstruct_flat(m, flat_init[:D].contiguous(),
                                    d2[:, :D].contiguous(), w, precision)
    got, ref = trk.unflatten(out, layout)["p"], trk.unflatten(unpadded, layout)["p"]
    for k in init:
        assert torch.equal(got[k], ref[k])


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
    launches, widths = trk.launches, dict(trk.launch_widths)
    meta = [torch.empty(s, device="meta") for s in ((3, 4), (4, 7), (7,))]
    with pytest.raises(ValueError, match="CUDA"):
        trk.fused_contract(*meta)
    cpu = [torch.zeros(s) for s in ((3, 4), (4, 7), (7,))]
    with pytest.raises(ValueError, match="CUDA"):
        trk._launch(*cpu)
    assert trk.launches == launches and trk.launch_widths == widths


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
    launches, widths = trk.launches_bf16, dict(trk.launch_widths_bf16)
    shapes = ((3, 4), (4, 7), (7,))
    dtypes = (torch.bfloat16, torch.bfloat16, torch.float32)
    meta = [torch.empty(s, device="meta", dtype=d) for s, d in zip(shapes, dtypes)]
    with pytest.raises(ValueError, match="CUDA"):
        trk.fused_contract_bf16(*meta)
    cpu = [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]
    with pytest.raises(ValueError, match="CUDA"):
        trk._launch_bf16(*cpu)
    assert trk.launches_bf16 == launches and trk.launch_widths_bf16 == widths


def test_flatten_stream_in_the_stream_dtype():
    _, init, deltas, weights = _fixture_game()
    R, P = weights.shape
    flat_init, d2, _ = trk.flatten_stream(_t(init), _t(deltas), R * P, torch.bfloat16)
    assert flat_init.dtype == torch.float32 and d2.dtype == torch.bfloat16
    _, d32, _ = trk.flatten_stream(_t(init), _t(deltas), R * P)
    assert torch.equal(d2, d32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# K1's numerical design (3xTF32 on the tensor cores), emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32(x, nearest=True):
    """fp32 rounded to TF32 (10 mantissa bits): to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` does; else toward zero, as the tensor cores
    read an fp32 operand."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """K1's split: hi the nearest TF32 value, lo = x - hi as the tensor
    cores read it."""
    hi = _tf32(x)
    return hi, _tf32(x - hi, nearest=False)


def _rz(v):
    """float64 to float32, rounded toward zero: how the tensor cores round
    the sum of an MMA's exact products and its accumulator input."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tf32_contract(wn2, d2, init, passes, fresh=True):
    """init + wn2 @ d2 as K1 forms it on the tensor cores: per k8 step,
    `passes` TF32 products (3: a_lo*b_hi, a_hi*b_lo, a_hi*b_hi, in that
    order; 1: a_hi*b_hi alone), each MMA rounding its sum toward zero.
    `fresh` (K1): every step's MMAs start from the error carried by a
    compensated (Kahan) sum, not from the accumulator, and the step's sum
    joins the fp32 accumulator in a compensated add; else the MMAs chain
    through one accumulator over all of K."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(wn2), _split(d2)
    terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if passes == 3 else ((a_hi, b_hi),)
    acc = np.zeros((wn2.shape[0], d2.shape[1]), np.float32)
    err = np.zeros_like(acc)
    for k0 in range(0, wn2.shape[1], 8):
        k = slice(k0, k0 + 8)
        part = err if fresh else acc
        for a, b in terms:
            part = _rz(part.astype(np.float64)
                       + a[:, k].astype(np.float64) @ b[k].astype(np.float64))
        if fresh:
            s = acc + part
            err, acc = part - (s - acc), s
        else:
            acc = part
    return init[None, :] + (acc + err)


def _normal_inputs(B, K, D, seed):
    """tests/test_torch_cuda.py's inputs: uniform weights with a zero row,
    standard-normal deltas and init."""
    rng = np.random.default_rng(seed)
    wn2 = rng.random((B, K)).astype(np.float32)
    wn2[0] = 0.0
    return (wn2, rng.standard_normal((K, D)).astype(np.float32),
            rng.standard_normal(D).astype(np.float32))


def _stream_inputs(B, R, P, D, seed):
    """Inputs like the recorded stream: round weights renormalized over
    random coalitions (each round's row sums to 1; coalition 0 is empty,
    so its row is zero), deltas around 1e-3, init around N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    masks = (rng.random((B, P)) < 0.5).astype(np.float32)
    masks[0] = 0.0
    weights = rng.random((R, P)).astype(np.float32)
    wn2 = trk.normalized_round_weights(torch.from_numpy(masks),
                                       torch.from_numpy(weights)).reshape(B, -1).numpy()
    return (wn2, (1e-3 * rng.standard_normal((R * P, D))).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32))


# (inputs, shape, one TF32 product fails, MMAs chained over all of K fail)
@pytest.mark.parametrize("inputs,shape,one_fails,chained_fails", [
    ("normal", (64, 200, 4000), True, True), ("normal", (32, 200, 4000), True, True),
    ("normal", (5, 12, 22), True, False),
    ("stream", (64, 20, 10, 4000), False, False), ("stream", (5, 4, 3, 22), False, False)])
def test_3xtf32_design_holds_the_kernel_tolerance(inputs, shape, one_fails, chained_fails):
    """K1 forms its products on the tensor cores in 3xTF32; each k8 step's
    MMAs start from the error carried by a compensated (Kahan) sum, and the
    step's sum joins the accumulator in a compensated add. Emulated here,
    that design stays within the kernel's tolerance against the plain fp32
    version (rtol 1e-4 / atol 1e-5, the same fp32 sum reassociated) on
    both input sets, the zero-weight row returns init bit-exactly, and on
    the standard-normal set it lands nearer the exact (float64) sum than
    the plain version does. Two designs it rejects break the tolerance on
    the standard-normal set: one TF32 product alone (about 3 decimal
    digits), and, at the main path's depth K = 200, MMAs that chain their
    round-toward-zero sums through one accumulator (the error then grows
    with the accumulator, not with the terms); both land farther from the
    exact sum than the plain version there. On the main path's own kind of
    inputs (weights summing to 1 per round, deltas near 1e-3) both pass,
    so those inputs alone cannot tell them apart. This test checks the
    design, not the kernel: only the `cuda`-marked tests
    (tests/test_torch_cuda.py) and chip_smoke.py check the kernel's own
    arithmetic, on standard-normal inputs."""
    make = _normal_inputs if inputs == "normal" else _stream_inputs
    wn2, d2, init = make(*shape, seed=sum(shape))
    ref = trk.fused_contract_reference(*(torch.from_numpy(a) for a in (wn2, d2, init)))
    ref = ref.numpy()

    def within(got):
        return bool(np.all(np.abs(got - ref) <= 1e-5 + 1e-4 * np.abs(ref)))

    got = _tf32_contract(wn2, d2, init, passes=3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[0], init)
    one = _tf32_contract(wn2, d2, init, passes=1)
    chained = _tf32_contract(wn2, d2, init, passes=3, fresh=False)
    assert within(one) != one_fails
    assert within(chained) != chained_fails
    if inputs == "normal":
        # the card's check: no farther from the exact sum than the plain
        # version, or atol where that one is nearly exact
        exact = init.astype(np.float64)[None] + wn2.astype(np.float64) @ d2.astype(np.float64)
        limit = max(np.abs(ref - exact).max(), 1e-5)
        assert np.abs(got - exact).max() <= limit
        assert np.abs(one - exact).max() > limit
        assert (np.abs(chained - exact).max() > limit) == chained_fails
