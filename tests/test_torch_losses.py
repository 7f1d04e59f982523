"""The port's training losses (train/losses.py) against the JAX package's
on the CPU, from numpy-seeded inputs, within 1e-6 relative: shifted
cross-entropy (pad-id masking and an explicit target mask), the
doubly-stochastic attention regularisation, the contrastive loss, and
``CombinedLoss`` with the contrastive and ITM losses and the attention
regularisation on, its ITM head and projections bridged from the flax
module's parameters (``params.loss_from_flax``) and one set of ITM
negatives injected into both (the two draw them from different
generators)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.train import losses as jax_losses
from image_captioning_ml_project_tpu_torch.params import loss_from_flax
from image_captioning_ml_project_tpu_torch.train import losses

torch.set_num_threads(1)

RTOL = 1e-6
B, T, V, S = 6, 9, 37, 5


def _inputs(seed):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((B, T, V)).astype(np.float32)
    targets = rs.randint(0, V, (B, T)).astype(np.int32)
    targets[:, -3:] = 0  # pad id 0 at the tail
    mask = (targets != 0).astype(np.int32)
    mask[:, -3] = 1      # an EOS that equals pad stays supervised
    return rs, logits, targets, mask


@pytest.mark.parametrize("masked", [False, True])
def test_shifted_cross_entropy(masked):
    _, logits, targets, mask = _inputs(0)
    want = jax_losses.shifted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), 0,
        target_mask=jnp.asarray(mask) if masked else None)
    got = losses.shifted_cross_entropy(
        torch.tensor(logits), torch.tensor(targets), 0,
        target_mask=torch.tensor(mask) if masked else None)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_attention_regularization_and_contrastive():
    rs = np.random.RandomState(1)
    w = rs.rand(B, T, S).astype(np.float32)
    tm = (rs.rand(B, T) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.attention_regularization(torch.tensor(w),
                                              torch.tensor(tm))),
        float(jax_losses.attention_regularization(jnp.asarray(w),
                                                  jnp.asarray(tm))),
        rtol=RTOL)
    img = rs.standard_normal((B, 16)).astype(np.float32)
    txt = rs.standard_normal((B, 16)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.contrastive_loss(torch.tensor(img), torch.tensor(txt),
                                      0.07)),
        float(jax_losses.contrastive_loss(jnp.asarray(img), jnp.asarray(txt),
                                          0.07)), rtol=RTOL)


@pytest.mark.parametrize("batch", [2, 5, 8])
def test_itm_negatives_are_never_positives(batch):
    g = torch.Generator().manual_seed(batch)
    for num_neg in range(1, batch + 1):
        img, txt = losses.itm_negative_indices(g, batch, num_neg)
        assert img.shape == txt.shape == (num_neg,)
        assert bool((img != txt).all())


@pytest.mark.parametrize("use_contrastive,use_itm,reg",
                         [(True, True, 0.3), (True, False, 0.0),
                          (False, True, 0.5)])
def test_combined_loss_matches_flax(use_contrastive, use_itm, reg,
                                    monkeypatch):
    rs, logits, targets, mask = _inputs(2)
    img = rs.standard_normal((B, 24)).astype(np.float32)
    txt = rs.standard_normal((B, 12)).astype(np.float32)
    attw = rs.rand(B, T, S).astype(np.float32)
    kw = dict(pad_token_id=0, use_contrastive=use_contrastive,
              use_itm=use_itm, contrastive_weight=0.2, itm_weight=0.3,
              temperature=0.07, hidden_dim=16, attention_reg_weight=reg)
    flax_loss = jax_losses.CombinedLoss(**kw)
    args = (jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(img),
            jnp.asarray(txt), jnp.asarray(attw), jnp.asarray(mask))
    # one set of negatives for both modules: adjacent entries of a numpy
    # permutation, as itm_negative_indices takes them
    perm = np.random.RandomState(7).permutation(B)
    nxt = (np.arange(B // 2) + 1) % B
    neg = (perm[:B // 2], perm[nxt])
    monkeypatch.setattr(jax_losses, "itm_negative_indices",
                        lambda *a, **k: tuple(jnp.asarray(x) for x in neg))
    monkeypatch.setattr(losses, "itm_negative_indices",
                        lambda *a, **k: tuple(torch.tensor(x) for x in neg))
    itm_key = jax.random.PRNGKey(5)
    variables = flax_loss.init({"params": jax.random.PRNGKey(3),
                                "itm": itm_key}, *args)
    want = flax_loss.apply(variables, *args, deterministic=True,
                           rngs={"itm": itm_key})

    port = losses.CombinedLoss(**kw, image_dim=24, text_dim=12)
    port.load_state_dict(loss_from_flax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.tensor(logits), torch.tensor(targets),
                   torch.tensor(img), torch.tensor(txt), torch.tensor(attw),
                   target_mask=torch.tensor(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
