"""The Q-Former (port: models/captioning_model.py ``QFormer`` and its
pre-LN layers) against the JAX package's on the CPU at f32: the module
alone on the same weights (with a vision projection, 8 queries of width
48 over 64-wide features), with a vision mask and without one, queries
within 1e-5 relative; and a captioning model with it (ViT's unmasked
features, and BUTD's masked regions), whose ``encode`` hands the decoder
the queries under an all-ones mask, also within 1e-5 relative; its
dropout is the decoder's rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.models.captioning_model import (
    QFormer as JaxQFormer)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    QFormer)
from image_captioning_ml_project_tpu_torch.params import _Bridge, _flatten
from image_captioning_ml_project_tpu_torch.params import _q_former
from torch_port_helpers import (family_inputs, family_models, jax_inputs,
                                port_inputs)

torch.set_num_threads(1)

B, S, D, Q, NQ = 3, 7, 64, 48, 8


def _pair():
    jq = JaxQFormer(query_dim=Q, vision_dim=D, num_queries=NQ,
                    num_layers=2, num_heads=4)
    feats = jnp.zeros((B, S, D))
    params = jq.init(jax.random.PRNGKey(4), feats)["params"]
    # the queries' N(0, 0.02) draw and the zero biases made visible
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size),
                                               p.shape), params)
    br = _Bridge({f"q_former/{k}": v for k, v in _flatten(params).items()})
    _q_former(br)
    assert not br.flat
    port = QFormer(query_dim=Q, vision_dim=D, num_queries=NQ, num_layers=2,
                   num_heads=4)
    port.load_state_dict({k[len("q_former."):]: v
                          for k, v in br.out.items()}, strict=True)
    return jq, params, port.eval()


@pytest.mark.parametrize("masked", [False, True])
def test_q_former_matches_jax(masked):
    jq, params, port = _pair()
    rs = np.random.RandomState(5)
    feats = rs.randn(B, S, D).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(S)[None] < np.array([[2], [5], [7]])
    want = np.asarray(jq.apply({"params": params}, jnp.asarray(feats),
                               None if mask is None else jnp.asarray(mask)
                               )["queries"])
    with torch.no_grad():
        got = port(torch.from_numpy(feats),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (B, NQ, Q)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("family", ["qformer", "butd_qformer"])
def test_encode_gives_the_queries_under_an_all_ones_mask(family):
    cfg, model, variables, port = family_models(family)
    assert port.q_former.encoder[0].rate == cfg.model.decoder.dropout
    x = family_inputs(cfg, 9)
    want = model.apply(variables, jax_inputs(x), method=model.encode)
    with torch.no_grad():
        got = port.encode(port_inputs(x))
    a, b = got["features"].numpy(), np.asarray(want["features"])
    assert a.shape == (2, 8, 48)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert got["attention_mask"].all()
    np.testing.assert_array_equal(got["attention_mask"].numpy(),
                                  np.asarray(want["attention_mask"]))
