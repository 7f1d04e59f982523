"""One-pass logsumexp + block maxima (port: ops/lse.py) against the JAX
package's Pallas kernel in interpret mode. The CUDA kernel is held
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


@pytest.mark.parametrize("make,error,match", [
    (lambda: torch.zeros(3, 600, dtype=torch.float64), TypeError, "takes"),
    (lambda: torch.zeros(3, 600, dtype=torch.int32), TypeError, "takes"),
    (lambda: torch.zeros(600), ValueError, r"expected \[R, V\]"),
    (lambda: torch.zeros(2, 3, 600), ValueError, r"expected \[R, V\]"),
    (lambda: torch.zeros(600, 3).t(), ValueError, "unit column stride"),
    (lambda: torch.zeros(0, 600), ValueError, "empty logits"),
    (lambda: torch.zeros(3, 0), ValueError, "empty logits"),
], ids=["float64", "int32", "1-d", "3-d", "column-strided", "no rows",
        "no columns"])
def test_wrapper_raises_before_any_launch(make, error, match):
    """What the kernel does not take raises on any device, before the
    dispatch."""
    before = port_lse.lse_and_block_max.launches
    with pytest.raises(error, match=match):
        port_lse.lse_and_block_max(make())
    assert port_lse.lse_and_block_max.launches == before


@pytest.mark.parametrize("block", [8, 100, 0, 1024])
def test_wrapper_raises_on_a_block_that_is_not_a_power_of_two(block):
    """Also above 512, which the kernel cannot read in one pass: refused
    on every device alike."""
    with pytest.raises(ValueError, match="power of two from 16 to 512"):
        port_lse.lse_and_block_max(torch.zeros(3, 600), block=block)


def test_wrapper_has_no_kernel_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_lse.lse_and_block_max(torch.zeros(3, 600, device="meta"))


def test_plain_reads_a_misaligned_row_strided_view():
    """A bf16 view whose rows start off 16-byte boundaries (odd row
    stride), as the kernel meets it on the card: the wrapper takes it
    whole, and the result is the plain version's of a contiguous copy."""
    x = torch.from_numpy(_logits(5, 1301, 3, "float32")).bfloat16()
    view = x[:, 1:]
    assert view.stride() == (1301, 1)
    lse, bm = port_lse.lse_and_block_max(view)
    want_lse, want_bm = port_lse.lse_and_block_max_plain(view.contiguous())
    assert torch.equal(lse, want_lse) and torch.equal(bm, want_bm)
