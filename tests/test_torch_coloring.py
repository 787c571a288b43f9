"""The port's colorings are bit-exact with the JAX package's stream.

``repro_torch.graph.coloring`` reimplements threefry2x32 ``PRNGKey`` /
``fold_in`` / ``randint`` in torch int64 arithmetic; every estimator sample
of the port can then be held against the reference sample by sample.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph import coloring as ref  # noqa: E402
from repro_torch.graph import coloring  # noqa: E402


@pytest.fixture(autouse=True)
def partitionable():
    """The port follows jax's partitionable threefry (the default of jax
    0.9); pinned jax versions default otherwise, so set it here."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 7, 128, 300])
@pytest.mark.parametrize("k", [3, 5, 7, 12])
def test_batch_colorings_bit_exact(seed, n, k):
    ids = [0, 1, 5, 1000, 2**31 - 1]
    want = np.asarray(ref.batch_colorings(
        jnp.int32(seed), jnp.asarray(ids, jnp.int32), n, k))
    got = coloring.batch_colorings(seed, ids, n, k, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,it", [(0, 0), (3, 17), (99, 123456)])
def test_iteration_key_and_single_coloring(seed, it):
    want_key = np.asarray(ref.iteration_key(seed, it))   # legacy uint32
    key = coloring.iteration_key(seed, it, device="cpu")
    np.testing.assert_array_equal(key.numpy(), want_key.astype(np.int64))
    np.testing.assert_array_equal(
        coloring.random_coloring(key, 257, 12).numpy(),
        ref.coloring_numpy(seed, it, 257, 12))
