"""The port's optimizer (train/optim.py) against optax on the CPU: the
three learning-rate schedules at every step of a 50-step horizon (within
1e-7 absolute), and AdamW over 5 steps on a random tree with a leaf the
decay mask excludes, a leaf whose gradient is zero (it must still decay)
and global-norm clipping, with the first moment in float32 and in
bfloat16 (parameters and moments within 1e-6 relative + 1e-7 absolute;
the bfloat16 moment within one bfloat16 ulp), optax's update jitted as the
JAX trainer runs it; and the global norm of a list holding GPT-2's
embedding-sized gradient within 1e-6 relative of a float64 sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import TrainingConfig
from image_captioning_ml_project_tpu.train import optim as jax_optim
from image_captioning_ml_project_tpu_torch.train import optim

HORIZON = 50


@pytest.mark.parametrize("scheduler", ["linear", "cosine", "step"])
@pytest.mark.parametrize("warmup", [0, 1, 7])
def test_schedules_match_optax(scheduler, warmup):
    cfg = TrainingConfig(lr_scheduler=scheduler, warmup_steps=warmup,
                         learning_rate=3e-4)
    want = jax_optim.create_learning_rate_schedule(cfg, HORIZON)
    got = optim.create_learning_rate_schedule(cfg, HORIZON)
    for step in range(HORIZON + 3):
        w = float(want(jnp.asarray(step, jnp.int32)))
        g = float(got(step))
        assert abs(g - w) <= 1e-7, (step, g, w)
    if scheduler != "step":
        assert float(got(0)) == 0.0 or warmup == 0


def _tree(rs):
    return {"w": rs.standard_normal((6, 5)).astype(np.float32),
            "b": rs.standard_normal((5,)).astype(np.float32),
            "frozen": rs.standard_normal((4, 3)).astype(np.float32)}


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_adamw_matches_optax(mu_dtype, clip):
    rs = np.random.RandomState(0)
    cfg = TrainingConfig(lr_scheduler="cosine", warmup_steps=2,
                         learning_rate=1e-2, weight_decay=0.1,
                         grad_clip_norm=clip, adam_mu_dtype=mu_dtype)
    params = _tree(rs)
    tx, _ = jax_optim.create_optimizer(cfg, 20, params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    # jitted, as the JAX trainer runs it: XLA keeps a bf16 moment's product
    # in f32 (the port does the same); op by op, jax rounds it to bf16
    update = jax.jit(tx.update)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    opt, _ = optim.create_optimizer(cfg, 20, tparams)
    assert opt.mask == {"w": True, "b": False, "frozen": True}
    for step in range(5):
        grads = {k: rs.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        grads["frozen"][:] = 0.0  # a frozen leaf: zero, not missing
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        updates, jstate = update(jg, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        norm = opt.step({k: torch.tensor(v) for k, v in grads.items()})
        want_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                for g in grads.values()))
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} {k}")
    # the zero-gradient leaf moved by the decay alone
    assert not np.allclose(tparams["frozen"].numpy(), params["frozen"])
    adam = jstate[-1][0] if clip else jstate[0]
    for k in params:
        mu = opt.mu[k]
        assert mu.dtype == (torch.bfloat16 if mu_dtype == "bfloat16"
                            else torch.float32)
        want_mu = np.asarray(adam.mu[k]).astype(np.float32)
        ulp = 2.0 ** -7 * np.abs(want_mu).max() if mu_dtype == "bfloat16" \
            else 0.0
        np.testing.assert_allclose(mu.float().numpy(), want_mu, rtol=1e-6,
                                   atol=1e-7 + ulp)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=1e-12)
    assert opt.count == int(adam.count) == 5


def test_clip_by_global_norm_has_no_epsilon():
    """optax's ``g / norm * max_norm``: a gradient of norm exactly 2
    clipped to 1 halves exactly (torch's clip_grad_norm_ adds 1e-6)."""
    cfg = TrainingConfig(grad_clip_norm=1.0, learning_rate=0.0,
                         weight_decay=0.0)
    p = {"x": torch.zeros(4)}
    opt, _ = optim.create_optimizer(cfg, 10, p)
    g = torch.tensor([1.0, 1.0, 1.0, 1.0])
    opt.step({"x": g})
    assert torch.equal(opt.mu["x"], 0.1 * (g / 2.0 * 1.0))


def test_global_norm_of_a_large_leaf():
    """A one-pass f32 accumulation (the CPU's ``vector_norm``) is 2.7e-3
    off on 38 M entries; the per-tensor ``sum`` stays within 1e-6."""
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(50257, 768, generator=g) * 1e-3,
             torch.randn(768, generator=g), torch.zeros(5)]
    want = float(sum(t.double().square().sum() for t in grads).sqrt())
    assert float(optim.global_norm(grads)) == pytest.approx(want, rel=1e-6)


def test_state_dict_round_trip():
    rs = np.random.RandomState(1)
    params = {k: torch.tensor(v) for k, v in _tree(rs).items()}
    cfg = TrainingConfig(adam_mu_dtype="bfloat16")
    opt, _ = optim.create_optimizer(cfg, 10, params)
    opt.step({k: torch.ones_like(v) for k, v in params.items()})
    other, _ = optim.create_optimizer(cfg, 10, {k: v.clone() for k, v in
                                                 params.items()})
    other.load_state_dict(opt.state_dict())
    assert other.count == 1
    for k in params:
        assert torch.equal(other.mu[k], opt.mu[k])
        assert other.mu[k].dtype == torch.bfloat16
        assert torch.equal(other.nu[k], opt.nu[k])
