"""The port's subset samplers (`mplc_tpu_torch/contrib/sampling.py`) against
the JAX package's (`mplc_tpu/contrib/sampling.py`), both pure numpy, from
the same `np.random.default_rng` seeds: every table, draw, weight and rank
must be bit-equal, and each function must leave its generator in the same
state (the estimators share one stream, so a function that consumed it
differently would shift every later draw)."""

from math import comb

import numpy as np
import pytest

from mplc_tpu.contrib import sampling as jsampling
from mplc_tpu_torch.contrib import sampling as tsampling

NS = (3, 5, 8)


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same_state(a, b):
    assert a.bit_generator.state == b.bit_generator.state


def _bits(x):
    return np.asarray(x, np.float64).tobytes()


def test_max_exact_bits_is_the_jax_packages():
    assert tsampling.MAX_EXACT_BITS == jsampling.MAX_EXACT_BITS == 16


@pytest.mark.parametrize("n", NS)
def test_shapley_size_prob(n):
    for size in range(n):
        assert _bits(tsampling.shapley_size_prob(size, n)) == \
            _bits(jsampling.shapley_size_prob(size, n))


@pytest.mark.parametrize("m", [0, 1, 2, 4, 7])
def test_combination_mask_table(m):
    tm, ts = tsampling.combination_mask_table(m)
    jm, js = jsampling.combination_mask_table(m)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    assert tm.dtype == jm.dtype and ts.dtype == js.dtype


@pytest.mark.parametrize("m", [3, 5, 8, 40])
def test_unrank_combination(m):
    for length in range(m + 1):
        total = comb(m, length)
        ranks = sorted({0, total - 1, total // 2, total // 3})
        for r in ranks:
            assert tsampling.unrank_combination(m, length, r) == \
                jsampling.unrank_combination(m, length, r)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 10 ** 30 + 7, 2 ** 70])
def test_randbelow_reads_the_byte_stream_alike(n):
    tr, jr = _rngs(n % 1000)
    got = [tsampling.randbelow(tr, n) for _ in range(50)]
    want = [jsampling.randbelow(jr, n) for _ in range(50)]
    assert got == want
    assert all(0 <= x < n for x in got)
    _same_state(tr, jr)
    with pytest.raises(ValueError):
        tsampling.randbelow(tr, 0)


@pytest.mark.parametrize("total", [1, 7, comb(8, 4), comb(40, 20)])
def test_without_replacement_ranks(total):
    tr, jr = _rngs(total % 97)
    tp, jp = tsampling.WithoutReplacementRanks(total), jsampling.WithoutReplacementRanks(total)
    draws = min(total, 60)
    got = [tp.pop_random(tr) for _ in range(draws)]
    want = [jp.pop_random(jr) for _ in range(draws)]
    assert got == want
    assert len(set(got)) == draws                 # without replacement
    assert len(tp) == len(jp) == total - draws
    assert tp._moved == jp._moved
    _same_state(tr, jr)
    if total == draws:
        with pytest.raises(IndexError):
            tp.pop_random(tr)


def _increment_model(n, k):
    """A deterministic |increment| model over [B, n-1] masks of N\\{k},
    with zeros at some rows (the samplers' max(f, 1e-300) guard)."""
    w = np.linspace(0.3, 1.7, n - 1) * (1 + k)

    def batch(masks):
        return np.sin(masks @ w) * (masks.sum(1) % 3 != 1)
    return batch


@pytest.mark.parametrize("n", NS)
def test_exact_subset_sampler(n):
    for k in range(n):
        ts = tsampling.ExactSubsetSampler(n, k, _increment_model(n, k))
        js = jsampling.ExactSubsetSampler(n, k, _increment_model(n, k))
        assert _bits(ts._cdf) == _bits(js._cdf)
        assert _bits(ts.f) == _bits(js.f)
        assert _bits(ts.renorm) == _bits(js.renorm)
        tr, jr = _rngs(100 * n + k)
        for _ in range(64):
            u = tr.uniform()
            assert u == jr.uniform()
            (tS, tw), (jS, jw) = ts.draw(u, tr), js.draw(u, jr)
            np.testing.assert_array_equal(tS, jS)
            assert _bits(tw) == _bits(jw)


def test_exact_subset_sampler_degenerate_model_falls_back_alike():
    ts = tsampling.ExactSubsetSampler(5, 2, lambda m: np.zeros(len(m)))
    js = jsampling.ExactSubsetSampler(5, 2, lambda m: np.zeros(len(m)))
    assert _bits(ts._cdf) == _bits(js._cdf)
    assert ts.renorm == js.renorm > 0


@pytest.mark.parametrize("n", list(NS) + [20])
def test_size_stratified_subset_sampler(n):
    k = n // 2
    tr, jr = _rngs(n)
    ts = tsampling.SizeStratifiedSubsetSampler(n, k, _increment_model(n, k), tr)
    js = jsampling.SizeStratifiedSubsetSampler(n, k, _increment_model(n, k), jr)
    _same_state(tr, jr)
    assert _bits(ts._cdf) == _bits(js._cdf)
    assert _bits(ts._weight_per_size) == _bits(js._weight_per_size)
    for _ in range(64):
        u = tr.uniform()
        assert u == jr.uniform()
        (tS, tw), (jS, jw) = ts.draw(u, tr), js.draw(u, jr)
        np.testing.assert_array_equal(tS, jS)
        assert _bits(tw) == _bits(jw)
    _same_state(tr, jr)


@pytest.mark.parametrize("n", list(NS) + [20])
def test_make_importance_sampler_picks_alike(n):
    tr, jr = _rngs(n + 1)
    ts = tsampling.make_importance_sampler(n, 0, _increment_model(n, 0), tr)
    js = jsampling.make_importance_sampler(n, 0, _increment_model(n, 0), jr)
    assert type(ts).__name__ == type(js).__name__ == (
        "ExactSubsetSampler" if n - 1 <= 16 else "SizeStratifiedSubsetSampler")
    assert _bits(ts._cdf) == _bits(js._cdf)
    _same_state(tr, jr)


@pytest.mark.parametrize("n", [2] + list(NS))
def test_svarm_draws(n):
    tr, jr = _rngs(n + 17)
    assert tsampling.svarm_warmup_draws(n, tr) == jsampling.svarm_warmup_draws(n, jr)
    _same_state(tr, jr)
    for block in (1, 7, 64):
        assert tsampling.svarm_batch_draws(n, block, tr) == \
            jsampling.svarm_batch_draws(n, block, jr)
        _same_state(tr, jr)
    if n < 3:
        assert tsampling.svarm_batch_draws(n, 4, tr) == []
