"""The port's n-gram hashes (ops/ngram.py) against the JAX package's:
the numpy hash copied into the port equal to JAX's, and the device hash
bit-equal to JAX's ``ngram_hashes`` for every window, valid or not (the
``-1`` packing sentinel included), and to the host hash on the valid ones,
for n = 1..4, token ids up to 50256 and sequences shorter than n;
``lookup_sorted`` hits, misses and an empty table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops import ngram as jax_ngram
from image_captioning_ml_project_tpu_torch.ops.ngram import (
    HASH_MULT, lookup_sorted, ngram_hashes, ngram_hashes_np)


def test_hash_multiplier_is_jax_s():
    assert HASH_MULT == jax_ngram.HASH_MULT
    assert HASH_MULT.dtype == np.uint32


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [1, 3, 20])
def test_host_hash_equals_jax_s(n, length):
    rs = np.random.RandomState(n * 100 + length)
    toks = rs.randint(0, 50257, length)
    toks[0] = 50256
    want = jax_ngram.ngram_hashes_np(toks, n)
    got = ngram_hashes_np(toks, n)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert len(got) == max(length - n + 1, 0)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [2, 14])
def test_device_hash_bit_equal_to_jax_s(n, length):
    """[3, 5, L] tokens in [-1, 50256] with random validity: every window's
    hash bit-equal to JAX's (as uint32), the window masks equal, and the
    valid windows of each row equal to the host hash of that row."""
    rs = np.random.RandomState(n * 10 + length)
    toks = rs.randint(-1, 50257, (3, 5, length)).astype(np.int32)
    toks[0, 0] = 50256
    toks[0, 1] = -1
    toks[1, 0] = np.arange(length) % 7        # repeated n-grams, token 0
    valid = (rs.rand(3, 5, length) > 0.2) & (toks >= 0)
    valid[1, 0] = True
    jh, jv = jax_ngram.ngram_hashes(jnp.asarray(toks), n, jnp.asarray(valid))
    ph, pv = ngram_hashes(torch.from_numpy(toks), n, torch.from_numpy(valid))
    assert ph.dtype == torch.int64
    assert int(ph.min()) >= 0 and int(ph.max()) < 2 ** 32
    np.testing.assert_array_equal(ph.numpy().astype(np.uint32),
                                  np.asarray(jh))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    host = ngram_hashes_np(toks[1, 0], n)
    np.testing.assert_array_equal(ph[1, 0].numpy()[pv[1, 0].numpy()], host)
    if length < n:
        assert not pv.any()


def test_lookup_sorted_hits_and_misses():
    """Hits return the payload, misses (below, between and above the table,
    and the largest uint32) the default; as JAX's."""
    keys = np.array([3, 7, 11, 2 ** 32 - 5], dtype=np.uint32)
    payload = np.array([0.3, 0.7, 1.1, 4.0], dtype=np.float32)
    vals = np.array([[7, 5, 11, 99], [0, 2 ** 32 - 5, 2 ** 32 - 1, 3]],
                    dtype=np.uint32)
    want = np.asarray(jax_ngram.lookup_sorted(
        jnp.asarray(keys), jnp.asarray(vals), jnp.float32(-1.0),
        jnp.asarray(payload)))
    got = lookup_sorted(torch.from_numpy(keys.astype(np.int64)),
                        torch.from_numpy(vals.astype(np.int64)), -1.0,
                        torch.from_numpy(payload))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), [[0.7, -1.0, 1.1, -1.0],
                                             [-1.0, 4.0, -1.0, 0.3]])


def test_lookup_sorted_empty_table():
    vals = torch.tensor([[1, 2], [3, 4]], dtype=torch.int64)
    got = lookup_sorted(torch.zeros(0, dtype=torch.int64), vals, 2.5,
                        torch.zeros(0, dtype=torch.float32))
    want = np.asarray(jax_ngram.lookup_sorted(
        jnp.zeros((0,), jnp.uint32), jnp.asarray(vals.numpy(), jnp.uint32),
        jnp.float32(2.5), jnp.zeros((0,), jnp.float32)))
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
