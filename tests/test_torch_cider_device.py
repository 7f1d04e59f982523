"""The port's on-device CIDEr-D (evaluate/cider_device.py) against the
JAX package's: ``build_df_table``'s hash tables equal and idfs within
1e-6; ``encode_references`` identical; ``per_sample_cider_device`` within
rtol 1e-5 / atol 1e-6 of JAX's over several seeds, with token 0 as a real
word, an empty candidate and an image with one valid reference; and the
same ids scored against the port's host ``cider_d`` (ids as words), as
``tests/test_cider_device.py::test_device_cider_matches_host`` holds
JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.evaluate import (
    cider_device as jax_cider)
from image_captioning_ml_project_tpu_torch.evaluate.cider_device import (
    MAX_N, build_df_table, encode_references, per_sample_cider_device)
from image_captioning_ml_project_tpu_torch.evaluate.metrics import cider_d

RTOL, ATOL = 1e-5, 1e-6
PAD, BOS, EOS = 0, 1, 2
SPECIALS = (PAD, BOS, EOS)


def _corpus(rs, num_images, vocab, max_len):
    """Per image 1-5 references of BOS, words, EOS; image 1 has one."""
    refs = []
    for i in range(num_images):
        k = 1 if i == 1 else rs.randint(1, 6)
        refs.append([[BOS] + rs.randint(3, vocab, rs.randint(
            1, max_len - 2)).tolist() + [EOS] for _ in range(k)])
    return refs


def _candidates(rs, refs, L, vocab, pad):
    """[B, L]: image 0 copies its first reference, image 2 is empty (BOS
    then pads), the others random."""
    B = len(refs)
    cand = np.full((B, L), pad, dtype=np.int32)
    for i in range(B):
        if i == 0:
            seq = refs[0][0]
        elif i == 2:
            seq = [BOS]
        else:
            seq = [BOS] + rs.randint(3, vocab, rs.randint(
                1, L - 1)).tolist()
        cand[i, :len(seq[:L])] = seq[:L]
    return cand


def _both(refs, specials, max_refs, max_len):
    jdf = jax_cider.build_df_table(refs, special_ids=specials)
    pdf = build_df_table(refs, special_ids=specials)
    jt, jv = jax_cider.encode_references(refs, max_refs, max_len)
    pt, pv = encode_references(refs, max_refs, max_len)
    return jdf, pdf, (jt, jv), (pt, pv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_df_table_and_references_equal_jax_s(seed):
    rs = np.random.RandomState(seed)
    refs = _corpus(rs, 8, 40, 14)
    jdf, pdf, (jt, jv), (pt, pv) = _both(refs, SPECIALS, 5, 16)
    assert pdf.log_n == pytest.approx(jdf.log_n, rel=1e-12)
    for n in range(MAX_N):
        assert pdf.tables[n].dtype == torch.int64
        np.testing.assert_array_equal(pdf.tables[n].numpy(),
                                      np.asarray(jdf.tables[n]).astype(
                                          np.int64))
        np.testing.assert_allclose(pdf.idfs[n].numpy(),
                                   np.asarray(jdf.idfs[n]), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pv, jv)
    assert pt.dtype == jt.dtype and pv.dtype == jv.dtype


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_cider_equals_jax_s(seed):
    rs = np.random.RandomState(seed)
    refs = _corpus(rs, 6, 30, 12)
    jdf, pdf, (rt, rv), _ = _both(refs, SPECIALS, 5, 14)
    cand = _candidates(rs, refs, 14, 30, PAD)
    want = np.asarray(jax_cider.per_sample_cider_device(
        jnp.asarray(cand), jnp.asarray(rt), jnp.asarray(rv), jdf, SPECIALS))
    got = per_sample_cider_device(torch.from_numpy(cand),
                                  torch.from_numpy(rt), torch.from_numpy(rv),
                                  pdf, SPECIALS)
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert got[2] == 0.0                   # the empty candidate
    assert got[0] > got[1:].max()          # the copied reference wins


def test_token_zero_counts_as_a_word():
    """GPT-2's specials (50256 for all three): token 0 is a real word in
    references and candidates; the sentinel is -1."""
    specials = (50256, 50256, 50256)
    rs = np.random.RandomState(5)
    refs = [[[50256, 0, 5, 6, 0, 7, 50256], [50256, 5, 6, 7, 50256]],
            [[50256, 8, 9, 0, 50256]],
            [[50256, 0, 0, 0, 50256], [50256, 3, 0, 50256]]]
    jdf, pdf, (rt, rv), _ = _both(refs, specials, 3, 8)
    cand = np.full((3, 8), 50256, dtype=np.int32)
    cand[0, :5] = [50256, 0, 5, 6, 0]
    cand[1, :4] = [50256, 8, 9, 0]
    cand[2, 1:4] = rs.randint(0, 3, 3)
    want = np.asarray(jax_cider.per_sample_cider_device(
        jnp.asarray(cand), jnp.asarray(rt), jnp.asarray(rv), jdf, specials))
    got = per_sample_cider_device(torch.from_numpy(cand),
                                  torch.from_numpy(rt), torch.from_numpy(rv),
                                  pdf, specials).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[0] > 0 and got[1] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_device_cider_matches_the_host_scorer(seed):
    """The same ids as words through the port's ``cider_d``."""
    rs = np.random.RandomState(seed)
    refs = _corpus(rs, 6, 30, 12)
    refs[1] = refs[1] + [list(refs[1][0])]   # a duplicate reference
    _, pdf, _, (rt, rv) = _both(refs, SPECIALS, 5, 14)
    cand = _candidates(rs, refs, 14, 30, PAD)
    got = per_sample_cider_device(torch.from_numpy(cand),
                                  torch.from_numpy(rt), torch.from_numpy(rv),
                                  pdf, SPECIALS).numpy()

    def words(toks):
        return [str(t) for t in toks if t not in SPECIALS]

    _, host = cider_d([words(c) for c in cand],
                      [[words(r) for r in rs_] for rs_ in refs])
    np.testing.assert_allclose(got, host, rtol=1e-4, atol=1e-4)
