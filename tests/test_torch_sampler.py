"""Port parity, sampler: the filter math of ``repro_torch.serving.sampler``
against ``repro.serving.sampler`` (the draws themselves come from
different generators and are compared as distributions only), and the
draw on non-finite rows: a row of NaN or one holding ``+inf`` gives the
id ``jax.random.categorical`` gives (Gumbel-max: the first NaN, else the
first ``+inf``), without raising."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as jsamp
from repro_torch.serving import sampler as tsamp

from _torch_threads import one_torch_thread  # noqa: F401


def _logits(seed=0, shape=(3, 50)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k", [0, 1, 5, 50])
def test_top_k_matches(k):
    x = _logits(k)
    want = np.asarray(jsamp.apply_top_k(jnp.asarray(x), k))
    got = tsamp.apply_top_k(torch.from_numpy(x), k).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 1.0])
def test_top_p_matches(p):
    x = _logits(int(p * 10) + 1)
    want = np.asarray(jsamp.apply_top_p(jnp.asarray(x), p))
    got = tsamp.apply_top_p(torch.from_numpy(x), p).numpy()
    assert np.array_equal(got, want)


def test_greedy_is_exact():
    x = _logits(2)
    want = np.asarray(jsamp.sample(jax.random.PRNGKey(0), jnp.asarray(x)))
    got = tsamp.sample(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_temperature_sampling_distribution():
    """With top-k 3 the draws stay in the top 3 and follow the softmax
    of the temperature-scaled logits (TV < 0.05 over 20k draws)."""
    x = np.array([2.0, 1.5, 1.0, 0.5, -1.0], np.float32)
    g = torch.Generator().manual_seed(0)
    draws = tsamp.sample(torch.from_numpy(np.tile(x, (20000, 1))),
                         method="temp", temperature=0.7, top_k=3,
                         generator=g).numpy()
    assert set(np.unique(draws)) <= {0, 1, 2}
    e = np.exp(x[:3] / 0.7)
    want = e / e.sum()
    got = np.bincount(draws, minlength=3)[:3] / len(draws)
    assert 0.5 * np.abs(got - want).sum() < 0.05
    with pytest.raises(ValueError):
        tsamp.sample(torch.from_numpy(x), method="beam")


NON_FINITE_ROWS = {
    "all_nan": [np.nan] * 8,
    "one_nan": [0.5, 1.0, np.nan, 2.0, -1.0, 0.0, 3.0, 1.0],
    "plus_inf": [0.0, 1.0, 2.0, np.inf, 0.0, 0.0, 0.0, 0.0],
    "two_plus_inf": [0.0, np.inf, 2.0, np.inf, 0.0, 0.0, 0.0, 0.0],
    "inf_and_nan": [np.inf, 1.0, np.nan, 2.0, 0.0, 0.0, 0.0, 0.0],
    "all_minus_inf": [-np.inf] * 8,
}


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("name", sorted(NON_FINITE_ROWS))
def test_temp_sampling_on_non_finite_rows_matches_reference(name,
                                                            temperature):
    row = np.asarray([NON_FINITE_ROWS[name]] * 3, np.float32)
    want = np.asarray(jsamp.sample(jax.random.PRNGKey(0), jnp.asarray(row),
                                   method="temp", temperature=temperature))
    got = tsamp.sample(torch.from_numpy(row), method="temp",
                       temperature=temperature,
                       generator=torch.Generator().manual_seed(0)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert ((0 <= got) & (got < row.shape[-1])).all()
