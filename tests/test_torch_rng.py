"""The PyTorch port's random streams against the JAX package: the lowbias32
counter hash and the threefry2x32 key chain must agree bit for bit."""

import jax
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.ops import rng as jrng
from fovpathtracing_optixcodelatest_tpu_torch.ops import rng as prng

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.prng_key(seed))


@pytest.mark.parametrize(
    "seed,chain", [(0, [0, 0]), (0, [3, 1, 2, 0]), (7, [1, 0, 3]),
                   (123, [99, 1, 0]), (0, [2**31 - 1, 65536])]
)
def test_fold_in_chain_matches_jax(seed, chain):
    # the renderer's chain: PRNGKey(seed) -> subframe -> jitter/path -> depth
    jk, pk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for c in chain:
        jk = jax.random.fold_in(jk, c)
        pk = prng.fold_in(pk, c)
        assert np.array_equal(np.asarray(jax.random.key_data(jk)), pk)
        assert prng.key_words(pk) == tuple(
            int(x) for x in np.asarray(jrng._key_seeds(jk))
        )


@pytest.mark.parametrize("num", [2, 8])
def test_ray_uniform_cols_bit_exact(num):
    rng = np.random.default_rng(3)
    ids = np.concatenate([
        np.arange(64), rng.integers(0, 2**31 - 1, 4000),
        [2**31 - 1, 2**31 - 2],
    ]).astype(np.int32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 5), 1)
    want = np.stack(
        [np.asarray(c) for c in jrng.ray_uniform_cols(key, ids, num)], axis=1
    )
    got = prng.ray_uniforms(np.asarray(key), torch.from_numpy(ids), num)
    assert got.dtype == torch.float32
    # tolerance: none, the hash is integer arithmetic
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert (want >= 0).all() and (want < 1).all()
