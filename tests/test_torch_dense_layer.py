"""One Dense layer with its epilogue (port: ops/dense_layer.py): the plain
version against flax ``nn.Dense`` and the JAX package's activations, what
the tensor-core GEMM's wrappers refuse (checked on CPU tensors: the checks
run before any launch), and the scratch kept per shape and stream. The GEMM
itself is held against this plain version on the card in
test_torch_cuda.py."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.ops import _checks
from image_captioning_ml_project_tpu_torch.ops import dense_layer as dl

torch.set_num_threads(1)

M, N, K = 7, 24, 40


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(M, K).astype(np.float32),
            (rs.randn(N, K) * 0.1).astype(np.float32),
            (rs.randn(N) * 0.1).astype(np.float32),
            rs.randn(M, N).astype(np.float32))


def _jax_layer(x, w, b, r, epilogue, dtype):
    """flax ``nn.Dense`` in ``dtype`` and the epilogue as the JAX package
    spells it (gpt2.py's ``gelu_new``; the Pallas encoder's quick_gelu with
    its sigmoid in f32)."""
    dense = nn.Dense(N, dtype=dtype, param_dtype=dtype)
    params = {"params": {"kernel": jnp.asarray(w.T, dtype),
                         "bias": jnp.asarray(b, dtype)}}
    y = dense.apply(params, jnp.asarray(x, dtype))
    if epilogue == "gelu_new":
        y = jax.nn.gelu(y, approximate=True)
    elif epilogue == "quick_gelu":
        yf = y.astype(jnp.float32)
        y = (yf * jax.nn.sigmoid(1.702 * yf)).astype(dtype)
    elif epilogue == "residual":
        y = jnp.asarray(r, dtype) + y
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("epilogue", list(dl.EPILOGUES))
def test_plain_matches_flax_dense_float32(epilogue):
    x, w, b, r = _inputs(len(epilogue))
    res = torch.from_numpy(r) if epilogue == "residual" else None
    got = dl.dense_layer(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), res, epilogue)
    want = _jax_layer(x, w, b, r, epilogue, jnp.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("epilogue", list(dl.EPILOGUES))
def test_plain_matches_flax_dense_bfloat16(epilogue):
    """bf16: the dot rounded, the bias added in bf16, the epilogue rounded
    once. Within one bf16 ulp of the largest output: XLA on the CPU may
    keep the f32 dot through the bias add where the port rounds first."""
    x, w, b, r = _inputs(len(epilogue) + 1)
    t = [torch.from_numpy(a).bfloat16() for a in (x, w, b, r)]
    res = t[3] if epilogue == "residual" else None
    got = dl.dense_layer(t[0], t[1], t[2], res, epilogue)
    assert got.dtype == torch.bfloat16
    want = _jax_layer(x, w, b, r, epilogue, jnp.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _off_by_one(*shape, dtype=torch.bfloat16):
    """A contiguous tensor that starts one element after a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("case,error,match", [
    ("float16", TypeError, "float32 or bfloat16"),
    ("N", ValueError, "multiples of 8"),
    ("K", ValueError, "multiples of 8"),
    ("x_misaligned", ValueError, "16-byte"),
    ("weight_misaligned", ValueError, "16-byte"),
    ("bias_misaligned", ValueError, "16-byte"),
    ("residual_misaligned", ValueError, "16-byte"),
    ("weight_strided", ValueError, "contiguous"),
    ("bias_shape", ValueError, "shape"),
    ("residual_without_epilogue", ValueError, "residual"),
    ("epilogue_without_residual", ValueError, "residual"),
    ("epilogue", ValueError, "epilogue must be"),
])
def test_gemm_wrapper_refuses(case, error, match):
    x, w, b, r, epilogue = _bf16(8, 16), _bf16(24, 16), _bf16(24), None, "bias"
    if case == "float16":
        x, w, b = x.half(), w.half(), b.half()
    elif case == "N":
        w, b = _bf16(20, 16), _bf16(20)
    elif case == "K":
        x, w = _bf16(8, 12), _bf16(24, 12)
    elif case == "x_misaligned":
        x = _off_by_one(8, 16)
    elif case == "weight_misaligned":
        w = _off_by_one(24, 16)
    elif case == "bias_misaligned":
        b = _off_by_one(24)
    elif case == "residual_misaligned":
        r, epilogue = _off_by_one(8, 24), "residual"
    elif case == "weight_strided":
        w = _bf16(24, 32)[:, :16]
    elif case == "bias_shape":
        b = _bf16(16)
    elif case == "residual_without_epilogue":
        r = _bf16(8, 24)
    elif case == "epilogue_without_residual":
        epilogue = "residual"
    elif case == "epilogue":
        epilogue = "relu"
    with pytest.raises(error, match=match):
        dl.check_dense_layer(x, w, b, r, epilogue)


def test_gemm_wrapper_takes_aligned_operands():
    dl.check_dense_layer(_bf16(8, 16), _bf16(24, 16), _bf16(24),
                         _bf16(8, 24), "residual")


@pytest.mark.parametrize("name", _checks.STACK_KEYS)
def test_stack_check_refuses_a_misaligned_tensor(name):
    """The GEMM reads the weights through TMA and the biases as 16-byte
    vectors, the LayerNorm its scales and biases: every one of them starts
    on a 16-byte boundary."""
    L, H, F = 2, 16, 32
    cpu = torch.device("cpu")
    stack = {k: torch.zeros(s, dtype=torch.float32 if k in _checks.LN_KEYS
                            else torch.bfloat16)
             for k, s in _checks.stack_shapes(L, H, F).items()}
    _checks.check_stack(stack, L, H, F, torch.bfloat16, cpu)
    stack[name] = _off_by_one(*stack[name].shape, dtype=stack[name].dtype)
    with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
        _checks.check_stack(stack, L, H, F, torch.bfloat16, cpu)


def test_scratch_is_kept_per_kernel_shape_and_stream():
    cpu = torch.device("cpu")
    a = _checks.scratch_buffer("t", (4, 8), torch.bfloat16, cpu, 0)
    assert a.shape == (4, 8) and a.dtype == torch.bfloat16
    again = _checks.scratch_buffer("t", (4, 8), torch.bfloat16, cpu, 0)
    assert again.data_ptr() == a.data_ptr()
    for other in (_checks.scratch_buffer("t", (4, 8), torch.bfloat16, cpu, 7),
                  _checks.scratch_buffer("t", (5, 8), torch.bfloat16, cpu, 0),
                  _checks.scratch_buffer("u", (4, 8), torch.bfloat16, cpu, 0),
                  _checks.scratch_buffer("t", (4, 8), torch.float32, cpu, 0)):
        assert other.data_ptr() != a.data_ptr()
