"""The LayerNorm op (port: ops/layer_norm.py) on the CPU: its plain forward
and plain backward, written out as the kernels compute them, against
autograd of ``ops/numerics.layer_norm`` (flax's ``_normalize``) at float32
over the widths the port builds and one that takes the kernels' scalar
path, and by ``gradcheck`` at float64 through the op's autograd function
(run here over the plain versions in place of the kernels); the clamped
variance of a constant row; a non-contiguous input;
``torch.utils.checkpoint`` and a ``torch.func.functional_call`` training
step through the function; the
module's route to the op in every mode; and which rows the kernels may
move in 16-byte chunks. The kernels themselves are held against this plain
version on the card in test_torch_cuda.py."""

import pytest
import torch
from torch import nn

from image_captioning_ml_project_tpu_torch.models import layers
from image_captioning_ml_project_tpu_torch.models.layers import LayerNorm
from image_captioning_ml_project_tpu_torch.ops import layer_norm as ln
from image_captioning_ml_project_tpu_torch.ops.numerics import layer_norm

torch.set_num_threads(1)

# the port's widths (CLIP, GPT-2, ViT and the decoders 768; Swin-B 128 to
# 1024 and 4096 in its patch merging) and one (129) that is no whole
# number of 16-byte chunks in either dtype
WIDTHS = (128, 768, 1024, 4096, 129)
ROWS = (1, 7, 8, 513)


def _inputs(rows, H, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, H, generator=g) * 2 + 0.5).to(dtype)
    w = 1 + 0.3 * torch.randn(H, generator=g, dtype=dtype)
    b = 0.3 * torch.randn(H, generator=g, dtype=dtype)
    dy = torch.randn(rows, H, generator=g).to(dtype)
    return x, w, b, dy


def _autograd(x, w, b, dy, eps):
    """y and the gradients of numerics.layer_norm by autograd."""
    x, w, b = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y = layer_norm(x, w, b, eps)
    y.backward(dy)
    return y.detach(), x.grad, w.grad, b.grad


@pytest.fixture
def plain_kernels(monkeypatch):
    """The op's kernels replaced by their plain versions, so that its
    autograd function runs on CPU tensors."""

    def forward(x, weight, bias, eps, stats):
        y, st = ln.layer_norm_plain(x, weight, bias, eps)
        return y, st if stats else None

    monkeypatch.setattr(ln, "_forward", forward)
    monkeypatch.setattr(ln, "layer_norm_backward",
                        ln.layer_norm_backward_plain)


def _op(x, weight, bias, eps):
    """The op's autograd function, as :func:`ln.layer_norm` runs it on the
    card (here over the plain versions: :func:`plain_kernels`)."""
    return ln._LayerNorm.apply(x.contiguous(), weight, bias, eps)[0]


def _close(got, want, rel=2e-5):
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("H", WIDTHS)
def test_plain_forward_and_backward_match_autograd(H, rows, eps):
    x, w, b, dy = _inputs(rows, H, seed=H + rows)
    y, stats = ln.layer_norm_plain(x, w, b, eps)
    dx, dw, db = ln.layer_norm_backward_plain(dy, x, stats, w)
    want = _autograd(x, w, b, dy, eps)
    assert torch.equal(y, want[0])  # the same ops as numerics.layer_norm
    assert stats.shape == (rows, 2) and (stats[:, 1] > 0).all()
    _close(dx, want[1])
    _close(dw, want[2])
    _close(db, want[3])


@pytest.mark.usefixtures("plain_kernels")
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_op_gradients_match_autograd_bfloat16(eps):
    """bf16 activations with f32 scale and bias, as the bf16 model runs
    them: the op's gradients are numerics' within one bf16 rounding of
    dx, and dgamma and dbeta at f32's."""
    x, w, b, dy = _inputs(33, 768, seed=3)
    x, dy = x.bfloat16(), dy.bfloat16()
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    y = _op(xr, wr, br, eps)
    y.backward(dy)
    want = _autograd(x, w, b, dy, eps)
    assert y.dtype == torch.bfloat16 and torch.equal(y.detach(), want[0])
    assert xr.grad.dtype == torch.bfloat16
    _close(xr.grad.float(), want[1].float(), rel=2 ** -7)
    _close(wr.grad, want[2], rel=1e-4)
    _close(br.grad, want[3])


@pytest.mark.usefixtures("plain_kernels")
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("shape", [(3, 8), (2, 3, 12), (1, 5)])
def test_gradcheck_float64(shape, eps):
    g = torch.Generator().manual_seed(len(shape) + shape[-1])
    x = torch.randn(shape, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=g,
                               dtype=torch.float64)).requires_grad_()
    b = (0.3 * torch.randn(shape[-1], generator=g,
                           dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w, b: _op(x, w, b, eps), (x, w, b))
    y, stats = ln.layer_norm_plain(x.detach(), w.detach(), b.detach(), eps)
    assert y.dtype == stats.dtype == torch.float64


def _clamped_row(H):
    """A constant row whose f32 E[x^2] - mu^2 comes out below 0."""
    for c in torch.linspace(0.1, 3.0, 300):
        x = torch.full((1, H), float(c))
        _, stats = ln.layer_norm_plain(x, torch.ones(H), torch.zeros(H),
                                       1e-5)
        if stats[0, 1] < 0:
            return x
    raise AssertionError("no constant row clamps")


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_constant_row_clamps_the_variance(eps):
    """A constant row beside ordinary ones: its variance is clamped at 0,
    rstd carries the clamp in its sign, and the backward drops the
    variance's term there, as the clamp's zero gradient does."""
    H = 768
    x, w, b, dy = _inputs(4, H, seed=9)
    x[2] = _clamped_row(H)[0]
    y, stats = ln.layer_norm_plain(x, w, b, eps)
    assert stats[2, 1] < 0 and (stats[[0, 1, 3], 1] > 0).all()
    assert float(stats[2, 1].abs()) == pytest.approx(eps ** -0.5, rel=1e-6)
    dx, dw, db = ln.layer_norm_backward_plain(dy, x, stats, w)
    want = _autograd(x, w, b, dy, eps)
    assert torch.equal(y, want[0])
    for row in range(4):
        _close(dx[row], want[1][row])
    _close(dw, want[2], rel=1e-4)
    _close(db, want[3])
    if eps == 1e-12:
        # at rstd 1e6 the row's rounding residue x - mu is no longer small
        # in xhat: kept, the variance's term would move its gradient
        r = stats[2, 1].abs()
        xhat = (x[2] - stats[2, 0]) * r
        kept = dx[2] - r * xhat * (w * dy[2] * xhat).mean()
        assert not torch.allclose(kept, want[1][2], rtol=1e-3, atol=0)


@pytest.mark.usefixtures("plain_kernels")
def test_non_contiguous_input():
    """``post_layernorm(x[:, 0])``: a strided view is made contiguous and
    its gradient lands on the view's base."""
    g = torch.Generator().manual_seed(4)
    base = torch.randn(5, 3, 64, generator=g, requires_grad=True)
    w, b = torch.ones(64, requires_grad=True), torch.zeros(64,
                                                           requires_grad=True)
    view = base[:, 0]
    assert not view.is_contiguous()
    dy = torch.randn(5, 64, generator=g)
    _op(view, w, b, 1e-5).backward(dy)
    want_base = base.detach().clone().requires_grad_()
    layer_norm(want_base[:, 0], w.detach(), b.detach(), 1e-5).backward(dy)
    _close(base.grad, want_base.grad)
    assert not base.grad[:, 1:].any()


def test_no_gradient_path_is_numerics_bit_for_bit():
    x, w, b, _ = _inputs(6, 768, seed=5)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        with torch.no_grad():
            got = ln.layer_norm(xd, w, b, 1e-5)
        assert torch.equal(got, layer_norm(xd, w, b, 1e-5))
        with torch.inference_mode():
            assert torch.equal(ln.layer_norm(xd, w, b, 1e-12),
                               layer_norm(xd, w, b, 1e-12))


def test_module_runs_the_op_in_every_mode(monkeypatch):
    """Training, eval and :func:`layers.plain_routes` alike: the module
    calls the op (which has a backward), and gets numerics' gradients."""
    calls = []

    def counted(*a):
        calls.append(a[0].shape)
        return ln.layer_norm(*a)

    monkeypatch.setattr(layers, "layer_norm", counted)
    m = LayerNorm(768, eps=1e-12)
    x, _, _, dy = _inputs(3, 768, seed=6)
    for training, plain in ((True, False), (False, False), (False, True)):
        m.train(training)
        xr = x.clone().requires_grad_()
        with layers.plain_routes() if plain else torch.enable_grad():
            m(xr).backward(dy)
        want = _autograd(x, m.weight.detach(), m.bias.detach(), dy, 1e-12)
        _close(xr.grad, want[1])
        _close(m.weight.grad, want[2])
        m.zero_grad()
    assert len(calls) == 3


class _Tiny(nn.Module):
    """Dense -> LayerNorm -> Dense: the norm through the op's autograd
    function, or autograd of the plain numerics."""

    def __init__(self, plain=False):
        super().__init__()
        self.inp = nn.Linear(16, 32)
        self.norm = LayerNorm(32)
        self.out = nn.Linear(32, 4)
        self.plain = plain

    def forward(self, x):
        h = self.inp(x)
        if self.plain:
            h = layer_norm(h, self.norm.weight, self.norm.bias,
                           self.norm.eps)
        else:
            h = _op(h, self.norm.weight, self.norm.bias, self.norm.eps)
        return self.out(torch.tanh(h))


@pytest.mark.usefixtures("plain_kernels")
@pytest.mark.parametrize("remat", [False, True])
def test_functional_call_training_step(remat):
    """A trainer-style step (``torch.func.functional_call`` with bf16
    casts of the f32 masters, the norm kept f32, optionally under
    ``torch.utils.checkpoint``): the gradients reach the masters and
    match autograd of the plain numerics."""
    torch.manual_seed(0)
    model = _Tiny()
    ref = _Tiny(plain=True)
    ref.load_state_dict(model.state_dict())
    x = torch.randn(9, 16)
    grads = []
    for m in (model, ref):
        params = dict(m.named_parameters())
        cast = {k: (v if k.startswith("norm.") else v.to(torch.bfloat16))
                for k, v in params.items()}

        def run(inp, m=m, cast=cast):
            return torch.func.functional_call(m, cast, (inp,))

        xb = x.to(torch.bfloat16)
        out = (torch.utils.checkpoint.checkpoint(run, xb, use_reentrant=False)
               if remat else run(xb))
        loss = out.float().square().mean()
        grads.append(torch.autograd.grad(loss, list(params.values())))
    for name, got, want in zip(dict(model.named_parameters()), *grads):
        assert got.dtype == torch.float32, name
        _close(got, want, rel=2e-2)
    norm_grads = [g for g, n in zip(grads[0], dict(model.named_parameters()))
                  if n.startswith("norm.")]
    assert all(g.abs().sum() > 0 for g in norm_grads)


@pytest.mark.parametrize("dtype,H,want", [
    (torch.bfloat16, 768, True), (torch.float32, 768, True),
    (torch.bfloat16, 132, False), (torch.float32, 132, True),
    (torch.float32, 129, False), (torch.bfloat16, 4096, True)])
def test_chunked_rows(dtype, H, want):
    """16-byte chunks where the width is a whole number of them and every
    operand starts on a 16-byte boundary; else the scalar path."""
    x = torch.zeros(4, H, dtype=dtype)
    w = torch.ones(H)
    assert ln._chunked(x, w, w) is want
    if want:
        shifted = torch.zeros(4 * H + 1, dtype=dtype)[1:].view(4, H)
        assert not ln._chunked(shifted, w, w)


def test_no_kernel_for_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ln.layer_norm(x, torch.ones(8, device="meta"),
                      torch.zeros(8, device="meta"), 1e-5)
