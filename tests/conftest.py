"""Shared fixtures.  NOTE: no XLA_FLAGS here by design — tests must see the
real single CPU device; only launch/dryrun.py forces 512 placeholders."""

import jax
import pytest

# jax < 0.5 constructs AbstractMesh from shape_tuple=((name, size), ...);
# newer releases take (axis_sizes, axis_names).  The sharding tests use the
# newer calling convention — adapt on old installs so one suite serves both.
try:
    jax.sharding.AbstractMesh((1,), ("_probe",))
except TypeError:
    _ABSTRACT_MESH = jax.sharding.AbstractMesh

    def _abstract_mesh_compat(axis_sizes, axis_names=None, *args, **kwargs):
        if axis_names is None:
            return _ABSTRACT_MESH(axis_sizes, *args, **kwargs)
        return _ABSTRACT_MESH(tuple(zip(axis_names, axis_sizes)),
                              *args, **kwargs)

    jax.sharding.AbstractMesh = _abstract_mesh_compat
except AttributeError:
    pass  # jax predates AbstractMesh: let the tests that need it fail alone


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
