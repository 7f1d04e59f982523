"""One-pass logsumexp + block maxima (port: ops/lse.py) against the JAX
package's Pallas kernel in interpret mode. The Triton kernel is held
against this plain version on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.pallas_lse import (
    lse_and_block_max as jax_lse_and_block_max)
from image_captioning_ml_project_tpu_torch.ops import lse as port_lse

torch.set_num_threads(1)


def _logits(R, V, seed, dtype):
    x = np.random.RandomState(seed).randn(R, V).astype(np.float32) * 3
    return np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [1000, 4097])
def test_plain_matches_pallas_kernel(V, dtype):
    """lse to rtol 1e-6; block maxima (ragged last block included) exact."""
    x = _logits(6, V, V, dtype)
    want_lse, want_bm = jax_lse_and_block_max(
        jnp.asarray(x).astype(dtype), interpret=True)
    lse, bm = port_lse.lse_and_block_max(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert lse.dtype == bm.dtype == torch.float32
    assert bm.shape == (6, -(-V // 512))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6)
    np.testing.assert_array_equal(bm.numpy(), np.asarray(want_bm))


def test_block_argument_and_no_count_on_cpu():
    x = torch.from_numpy(_logits(3, 700, 0, "float32"))
    before = port_lse.lse_and_block_max.launches
    lse, bm = port_lse.lse_and_block_max(x, block=128)
    assert bm.shape == (3, 6)
    np.testing.assert_array_equal(bm[:, -1].numpy(), x[:, 640:].amax(-1))
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(x, -1).numpy(), rtol=1e-6)
    assert port_lse.lse_and_block_max.launches == before
