"""Port parity, gradient compression: ``repro_torch.dist.compression``
against the live ``repro.dist.compression`` on the CPU.

* ``quantize_int8`` / ``dequantize_int8``: ``q``, ``scale`` and the
  dequantized values bitwise equal to the reference's under
  ``jax.jit``, as its train step runs them (XLA computes the scale as
  max|x| times fp32(1/127); called eagerly the reference divides, one
  ulp away at times), for lengths 1 - 2000 (one block, its tail, several
  blocks), on normal draws, all zeros, zeros mixed in, wide magnitudes,
  and inf / NaN;
* the elementwise bound |x - xhat| <= scale / 2;
* error feedback: 50 steps of the residual carry bitwise equal to the
  reference's loop, and the accumulated transmitted signal within one
  quantization step of the true sum;
* ``compressed_all_reduce`` over no group and over a world-of-one gloo
  group against ``compressed_psum`` on a one-device mesh: the sum over one
  member bitwise, the residual within two ulps of the quantizer's input
  (XLA fuses ``flat - q * scale`` into one fused multiply-add, torch
  rounds the product first), non-finite gradients zeroed before
  quantizing; the tree version against ``compressed_psum_tree``;
* ``make_error_state``, and the launcher's ``_grad_wire_bytes`` on smoke
  Qwen3-1.7B equal to the reference's formula.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.dist import compression as J
from repro_torch.dist import compression as T

from _torch_threads import one_torch_thread  # noqa: F401

LENGTHS = (1, 2, 7, 255, 256, 257, 511, 512, 513, 1000, 1999, 2000)


def _draw(kind: str, n: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    x = rs.randn(n).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "some_zeros":
        x[rs.rand(n) < 0.5] = 0.0
    elif kind == "wide":
        x *= np.float32(10.0) ** rs.randint(-30, 30, n).astype(np.float32)
    elif kind == "nonfinite":
        x[rs.randint(0, n, max(n // 50, 1))] = np.inf
        x[rs.randint(0, n, max(n // 70, 1))] = -np.inf
        x[rs.randint(0, n, max(n // 90, 1))] = np.nan
    return x


@functools.lru_cache(maxsize=None)
def _jit_quantize():
    return jax.jit(J.quantize_int8)


def _ref_quantize(x: np.ndarray):
    q, s = _jit_quantize()(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("kind", ["normal", "zeros", "some_zeros", "wide",
                                  "nonfinite"])
@pytest.mark.parametrize("n", LENGTHS)
def test_quantize_bitwise_equals_reference(n, kind):
    x = _draw(kind, n, seed=n)
    q_ref, s_ref = _ref_quantize(x)
    q, s = T.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == q_ref.shape == (-(-n // T.BLOCK), T.BLOCK)
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy().view(np.uint32)
                                  [np.isfinite(s_ref)],
                                  s_ref.view(np.uint32)[np.isfinite(s_ref)])
    np.testing.assert_array_equal(s.numpy(), s_ref)      # inf/nan alike
    got = T.dequantize_int8(q, s, n).numpy()
    want = np.asarray(J.dequantize_int8(jnp.asarray(q_ref),
                                        jnp.asarray(s_ref), n))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_quantize_error_within_half_a_step(seed):
    n = 1 + 331 * seed
    x = torch.from_numpy(_draw("normal", n, seed))
    q, s = T.quantize_int8(x)
    xhat = T.dequantize_int8(q, s, n)
    bound = s[:, 0].repeat_interleave(T.BLOCK)[:n] * 0.5 + 1e-7
    assert bool((torch.abs(x - xhat) <= bound).all())


def test_quantize_exact_on_grid():
    x = torch.arange(-127, 128, dtype=torch.float32) * 0.5
    q, s = T.quantize_int8(x)
    torch.testing.assert_close(T.dequantize_int8(q, s, x.numel()), x,
                               atol=1e-6, rtol=0)


def test_error_feedback_matches_reference_and_converges():
    rng = np.random.RandomState(0)
    n, steps = 512, 50
    err_t = torch.zeros(n)
    err_j = jnp.zeros((n,), jnp.float32)
    true_sum = np.zeros(n, np.float32)
    sent_sum = np.zeros(n, np.float32)
    for _ in range(steps):
        g = rng.randn(n).astype(np.float32)
        flat_t = torch.from_numpy(g) + err_t
        ghat_t = T.dequantize_int8(*T.quantize_int8(flat_t), n)
        err_t = flat_t - ghat_t
        flat_j = jnp.asarray(g) + err_j
        ghat_j = J.dequantize_int8(*_jit_quantize()(flat_j), n)
        err_j = flat_j - ghat_j
        np.testing.assert_array_equal(err_t.numpy(), np.asarray(err_j))
        true_sum += g
        sent_sum += ghat_t.numpy()
    # the accumulated transmitted signal is off by the last residual only
    # (<= half a quantization step), not by O(steps)
    assert np.abs(true_sum - sent_sum).max() < 0.1


def _residual_close(got: np.ndarray, want: np.ndarray, flat: np.ndarray):
    """Residuals ``flat - q * scale`` rounded with and without a fused
    multiply-add: two ulps of the largest input apart at most."""
    atol = 2 * np.spacing(np.abs(flat).max().astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _ref_psum(g: np.ndarray, e: np.ndarray):
    mesh = jax.make_mesh((1,), ("data",))
    f = shard_map(functools.partial(J.compressed_psum, axis_name="data"),
                  mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    ghat, new_e = jax.jit(f)(jnp.asarray(g), jnp.asarray(e))
    return np.asarray(ghat), np.asarray(new_e)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("with_group", [False, True])
def test_compressed_all_reduce_world_of_one(with_group, request):
    group = request.getfixturevalue("world_of_one") if with_group else None
    rs = np.random.RandomState(1)
    g = rs.randn(3, 300).astype(np.float32)
    g[0, 5], g[1, 7], g[2, 9] = np.inf, -np.inf, np.nan
    e = (0.01 * rs.randn(3, 300)).astype(np.float32)
    want_g, want_e = _ref_psum(g, e)
    got_g, got_e = T.compressed_all_reduce(torch.from_numpy(g),
                                           torch.from_numpy(e), group)
    assert tuple(got_g.shape) == g.shape and tuple(got_e.shape) == g.shape
    finite = np.isfinite(g)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    _residual_close(got_e.numpy(), want_e, np.where(finite, g + e, 0))
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose((got_g + got_e).numpy()[finite],
                               (g + e)[finite], atol=1e-5)
    _, s = T.quantize_int8(torch.from_numpy(np.where(finite, g + e, 0)))
    assert float(got_e.abs().max()) <= float(s.max()) / 2 + 1e-6


def test_compressed_tree_matches_reference():
    rs = np.random.RandomState(2)
    grads = {"a": {"w": rs.randn(4, 70).astype(np.float32)},
             "b": rs.randn(513).astype(np.float32)}
    errs = {"a": {"w": (0.1 * rs.randn(4, 70)).astype(np.float32)},
            "b": (0.1 * rs.randn(513)).astype(np.float32)}
    mesh = jax.make_mesh((1,), ("data",))
    f = shard_map(functools.partial(J.compressed_psum_tree,
                                    axis_name="data"), mesh=mesh,
                  in_specs=(P(), P()), out_specs=(P(), P()))
    want_g, want_e = jax.jit(f)(jax.tree.map(jnp.asarray, grads),
                                jax.tree.map(jnp.asarray, errs))
    to_t = functools.partial(jax.tree.map, torch.from_numpy)
    got_g, got_e = T.compressed_all_reduce_tree(to_t(grads), to_t(errs))
    for key in ("a", "b"):
        pick = (lambda t: t["a"]["w"]) if key == "a" else (lambda t: t["b"])
        np.testing.assert_array_equal(pick(got_g).numpy(),
                                      np.asarray(pick(want_g)))
        _residual_close(pick(got_e).numpy(), np.asarray(pick(want_e)),
                        pick(grads) + pick(errs))


def test_make_error_state_structure():
    params = {"a": torch.zeros((3, 4), dtype=torch.bfloat16),
              "b": {"c": torch.zeros(5)}}
    es = T.make_error_state(params)
    assert es["a"].shape == (3, 4) and es["a"].dtype == torch.float32
    assert es["b"]["c"].shape == (5,) and not es["b"]["c"].any()


def test_grad_wire_bytes_matches_reference():
    from repro.configs import registry as jreg
    from repro.launch import train as jtrain
    from repro.models import get_model as jget
    from repro_torch.configs import registry as treg
    from repro_torch.launch import train as ttrain
    from repro_torch.models import get_model as tget

    jcfg = jreg.with_sell(jreg.get_smoke_config("qwen3_1_7b"), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), "acdc",
                          method="pallas")
    jparams = jax.eval_shape(functools.partial(jget(jcfg).init, cfg=jcfg),
                             jax.random.PRNGKey(0))
    tparams = tget(tcfg).init(torch.Generator().manual_seed(0), tcfg,
                              "meta")
    want = jtrain._grad_wire_bytes(jparams)
    assert ttrain._grad_wire_bytes(tparams) == want
    wire, raw = want
    assert wire < raw / 3        # int8 + a scale a block: ~0.255 x fp32
