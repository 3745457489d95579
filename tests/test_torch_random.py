"""The PyTorch port's samplers (`mxtpu_torch/ops/random_ops.py`,
`mxtpu_torch/random.py`) against the JAX package's, on the CPU.

The two packages draw different numbers from the same seed, so each
sampler is held to the JAX package's own draws by distribution: 20,000
draws of each (`tests/test_torch_op_cases.py`'s `MOMENTS` rows), a
two-sample Kolmogorov-Smirnov test for the continuous ones and a
chi-squared test of the two histograms for the discrete ones, each
failing below a p-value of 1e-4.  Then the contracts: shapes and
dtypes (`*_like`, `_sample_*`, `randint`), `randint` never drawing
`high`, `_sample_multinomial`'s flat output and `get_prob`,
`_sample_unique_zipfian` at `large_word_lm`'s `range_max` (unique in
every row; each class's inclusion frequency within 5 binomial standard
errors of the JAX package's) and its `ValueError`, `_shuffle` a
permutation of axis 0; `mx.random`'s samplers, `mx.nd.random` the same
module; and `get_state`/`set_state` replaying draws bit for bit.
"""
import numpy as np
import pytest
from scipy import stats

import mxtpu as jmx
import mxtpu_torch as tmx
from test_torch_op_cases import MOMENTS, draw
import torch

torch.set_num_threads(1)

N = 20000
P_MIN = 1e-4
DISCRETE = ("poisson", "negative_binomial", "randint")


def _draws(mx, name, seed=5):
    mx.random.seed(seed)
    x, dtype = draw(mx, name, N, mx.cpu())
    assert x.dtype == dtype, (name, x.dtype)
    return x.astype(np.float64)


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_sampler_matches_the_reference_in_distribution(name):
    t, j = _draws(tmx, name), _draws(jmx, name)
    assert np.isfinite(t).all()
    if any(k in name for k in DISCRETE):
        assert np.array_equal(t, np.round(t))
        lo, hi = int(min(t.min(), j.min())), int(max(t.max(), j.max()))
        ht = np.bincount((t - lo).astype(int), minlength=hi - lo + 1)
        hj = np.bincount((j - lo).astype(int), minlength=hi - lo + 1)
        keep = (ht + hj) >= 10   # pool the sparse tail into one cell
        table = np.stack([np.append(ht[keep], ht[~keep].sum()),
                          np.append(hj[keep], hj[~keep].sum())])
        table = table[:, table.sum(0) > 0]
        p = stats.chi2_contingency(table)[1]
    else:
        p = stats.ks_2samp(t, j).pvalue
    assert p > P_MIN, (name, p)


def test_like_ops_take_the_input_shape_and_dtype():
    x = tmx.nd.zeros((3, 4), ctx=tmx.cpu(), dtype="float16")
    for name in sorted(n for n in MOMENTS if n.endswith("_like")):
        out = getattr(tmx.nd, name)(x, **MOMENTS[name][0])
        assert out.shape == (3, 4) and out.dtype == np.float16, name


def test_sample_ops_shape_is_the_parameters_then_shape():
    rng = np.random.RandomState(0)
    for name in sorted(n for n in MOMENTS if n.startswith("_sample_")):
        params = [tmx.nd.array(np.full((2, 3), p[0], np.float32) *
                               rng.uniform(0.9, 1.1, (2, 3)).astype(
                                   np.float32), ctx=tmx.cpu())
                  for p in MOMENTS[name][3]]
        out = getattr(tmx.nd, name)(*params, shape=(4, 5))
        assert out.shape == (2, 3, 4, 5), name
        assert out.dtype == np.float32, name


def test_sample_normal_draws_each_row_from_its_own_parameters():
    mu = tmx.nd.array([-5.0, 0.0, 5.0], ctx=tmx.cpu())
    sigma = tmx.nd.array([0.1, 1.0, 2.0], ctx=tmx.cpu())
    x = tmx.nd._sample_normal(mu, sigma, shape=(N,)).asnumpy()
    assert np.allclose(x.mean(1), [-5, 0, 5], atol=0.05)
    assert np.allclose(x.std(1), [0.1, 1.0, 2.0], rtol=0.03)


def test_randint_excludes_high_and_defaults_to_int32():
    tmx.random.seed(2)
    x = tmx.random.randint(-2, 3, shape=(N,), ctx=tmx.cpu()).asnumpy()
    assert x.dtype == np.int32 and set(np.unique(x)) == {-2, -1, 0, 1, 2}
    y = tmx.nd._random_randint(low=0, high=4, shape=(10,), dtype="int64",
                               ctx=tmx.cpu())
    assert y.dtype == np.int64


def test_multinomial_shapes_and_log_probabilities():
    p = np.array([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]], np.float32)
    for mx in (tmx, jmx):
        d = mx.nd._sample_multinomial(mx.nd.array(p, ctx=mx.cpu()), shape=6)
        assert d.shape == (2, 6) and d.dtype == np.int32
        flat = mx.nd._sample_multinomial(mx.nd.array(p[0], ctx=mx.cpu()))
        assert flat.shape == (1,)
    d, lp = tmx.random.multinomial(tmx.nd.array(p, ctx=tmx.cpu()), shape=4,
                                   get_prob=True)
    d = d.asnumpy()
    assert not (d[0] == 1).any() and not (d[1] == 2).any()
    np.testing.assert_allclose(lp.asnumpy(),
                               np.log(np.take_along_axis(p, d, 1)),
                               atol=1e-6)


def test_unique_zipfian_rows_and_inclusion_frequencies():
    """large_word_lm's draw: 256 unique classes of 10,000 in each of 64
    rows; each class's share of rows that include it against the JAX
    package's, within 5 binomial standard errors (plus one row)."""
    rows, n, vmax = 64, 256, 10000
    inc = {}
    for mx in (tmx, jmx):
        mx.random.seed(9)
        z = mx.nd._sample_unique_zipfian(range_max=vmax, shape=(rows, n),
                                         ctx=mx.cpu()).asnumpy()
        assert z.shape == (rows, n) and z.dtype == np.int32
        assert all(len(np.unique(r)) == n for r in z)
        assert 0 <= z.min() and z.max() < vmax
        inc[mx] = np.bincount(z.reshape(-1), minlength=vmax) / rows
    a, b = inc[tmx], inc[jmx]
    pbar = (a + b) / 2
    se = np.sqrt(2 * pbar * (1 - pbar) / rows)
    assert np.all(np.abs(a - b) <= 5 * se + 1.0 / rows)
    assert a[:10].min() > 0.9   # the most frequent classes, nearly always
    with pytest.raises(ValueError):
        tmx.nd._sample_unique_zipfian(range_max=5, shape=(2, 6),
                                      ctx=tmx.cpu())


def test_shuffle_permutes_axis_zero():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    tmx.random.seed(1)
    a = tmx.nd.array(x, ctx=tmx.cpu())
    s1 = tmx.random.shuffle(a).asnumpy()
    s2 = tmx.nd.shuffle(a).asnumpy()
    for s in (s1, s2):
        assert sorted(map(tuple, s)) == sorted(map(tuple, x))
    assert not np.array_equal(s1, s2)


def test_random_namespaces_lack_no_public_name():
    for ref, port in ((jmx.random, tmx.random),
                      (jmx.nd.random, tmx.nd.random)):
        missing = [n for n in dir(ref) if not n.startswith("_")
                   and callable(getattr(ref, n)) and not hasattr(port, n)]
        assert not missing, missing


SAMPLERS = {
    "uniform": lambda: tmx.random.uniform(-1, 2, shape=(7,), ctx=tmx.cpu()),
    "normal": lambda: tmx.random.normal(1, 2, shape=(7,), ctx=tmx.cpu()),
    "randn": lambda: tmx.random.randn(3, 2, ctx=tmx.cpu()),
    "randint": lambda: tmx.random.randint(0, 100, shape=(7,),
                                          ctx=tmx.cpu()),
    "exponential": lambda: tmx.random.exponential(2.0, shape=(7,),
                                                  ctx=tmx.cpu()),
    "gamma": lambda: tmx.random.gamma(2.0, 0.5, shape=(7,), ctx=tmx.cpu()),
    "poisson": lambda: tmx.random.poisson(4.0, shape=(7,), ctx=tmx.cpu()),
    "negative_binomial": lambda: tmx.random.negative_binomial(
        3, 0.3, shape=(7,), ctx=tmx.cpu()),
    "generalized_negative_binomial": lambda:
        tmx.random.generalized_negative_binomial(2.0, 0.5, shape=(7,),
                                                 ctx=tmx.cpu()),
    "multinomial": lambda: tmx.random.multinomial(tmx.nd.array(
        [[0.2, 0.3, 0.5]], ctx=tmx.cpu()), shape=7),
    "shuffle": lambda: tmx.random.shuffle(tmx.nd.array(
        np.arange(7, dtype=np.float32), ctx=tmx.cpu())),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_set_state_of_get_state_replays_the_draws(name):
    tmx.random.seed(21)
    SAMPLERS[name]()
    state = tmx.random.get_state()
    first = [SAMPLERS[name]().asnumpy() for _ in range(2)]
    tmx.random.set_state(state)
    again = [SAMPLERS[name]().asnumpy() for _ in range(2)]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[0], first[1]) or name == "multinomial"


def test_set_state_none_starts_over_from_the_seed():
    tmx.random.seed(4)
    a = tmx.random.normal(shape=(5,), ctx=tmx.cpu()).asnumpy()
    tmx.random.normal(shape=(5,), ctx=tmx.cpu())
    tmx.random.set_state(None)
    np.testing.assert_array_equal(
        tmx.random.normal(shape=(5,), ctx=tmx.cpu()).asnumpy(), a)
