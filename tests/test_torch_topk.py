"""Exact top-k with lax.top_k's tie order (port: ops/topk.py) against the
JAX package's ``fused_beam_top_k`` and ``lax.top_k``: indices identical,
including constructed exact ties and min-length EOS suppression."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.topk import (
    fused_beam_top_k as jax_fused_beam_top_k)
from image_captioning_ml_project_tpu_torch.ops.lse import lse_and_block_max
from image_captioning_ml_project_tpu_torch.ops.topk import (fused_beam_top_k,
                                                            top_k)

torch.set_num_threads(1)

B, K = 3, 5


def test_top_k_ties_resolve_to_lowest_index():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 4, (6, 40)).astype(np.float32)  # many exact ties
    x[0] = 1.0                                         # all equal
    x[1, [3, 17, 30]] = -np.inf
    vals, idx = top_k(torch.from_numpy(x), 12)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), 12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def _case(V, seed, dtype, ties):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(B * K, V) * 2).astype(np.float32)
    bias = rs.randn(B * K).astype(np.float32)
    if ties:
        # exact ties inside a row, across rows of one image (equal bias),
        # and across blocks, at the top of the candidate order
        logits[0, [5, 600, V - 1]] = 9.0
        logits[1, [5, 7]] = 9.0
        bias[1] = bias[0]
        logits[K, :] = logits[K + 1, :]
        bias[K] = bias[K + 1]
    logits = np.array(jnp.asarray(logits).astype(dtype).astype(jnp.float32))
    return logits, bias


@pytest.mark.parametrize("block_max", [False, True],
                         ids=["blockmax_here", "blockmax_given"])
@pytest.mark.parametrize("suppress", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("V,dtype", [(1300, "float32"), (1024, "float32"),
                                     (1300, "bfloat16")])
def test_fused_beam_top_k_matches_jax(V, dtype, ties, suppress, block_max):
    logits, bias = _case(V, V + ties, dtype, ties)
    eos = 600 if ties else 2
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    bm = lse_and_block_max(tl)[1] if block_max else None
    vals, idx = fused_beam_top_k(tl, torch.from_numpy(bias), K, 2 * K,
                                 suppress_token=eos, suppress=suppress,
                                 block_max=bm)
    jbm = None if bm is None else jnp.asarray(bm.numpy())
    want_vals, want_idx = jax_fused_beam_top_k(
        jnp.asarray(logits).astype(dtype), jnp.asarray(bias), K, 2 * K,
        suppress_token=eos, suppress=jnp.asarray(suppress), block_max=jbm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    if suppress:
        assert not (idx.numpy() % V == eos).any()


def test_fused_beam_top_k_equals_materialized_top_k():
    """Against the definition: top-k of bias + logits over each image's
    K rows, flattened."""
    logits, bias = _case(1300, 7, "float32", True)
    vals, idx = fused_beam_top_k(torch.from_numpy(logits),
                                 torch.from_numpy(bias), K, 2 * K)
    full = (torch.from_numpy(logits) + torch.from_numpy(bias)[:, None])
    want_vals, want_idx = top_k(full.reshape(B, -1), 2 * K)
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    np.testing.assert_array_equal(vals.numpy(), want_vals.numpy())


def test_fused_beam_top_k_does_not_modify_given_block_max():
    logits, bias = _case(1300, 3, "float32", False)
    tl = torch.from_numpy(logits)
    bm = lse_and_block_max(tl)[1]
    before = bm.clone()
    fused_beam_top_k(tl, torch.from_numpy(bias), K, 2 * K,
                     suppress_token=5, suppress=True, block_max=bm)
    assert torch.equal(bm, before)


@pytest.mark.parametrize("V,k", [(300, 2), (1024, 11)])
def test_fused_beam_top_k_rejects_what_jax_rejects(V, k):
    x = torch.zeros(K, V)
    with pytest.raises(ValueError):
        fused_beam_top_k(x, torch.zeros(K), K, k)
