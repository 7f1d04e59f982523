"""The device-resident resize (port: ops/resize.py ``_resize_weights``,
``resize_square``, ``resize_normalize``) against the JAX package's
``ops/resize.py`` on the CPU, over canvases whose squares are the whole
canvas, larger than the output (downscaled, antialiased), equal to it and
smaller (upscaled): the weights within 1e-6, the resized pixels within
1e-4 on the 0-255 scale and the normalised images within 1e-4 absolute
(the products are summed in another order: about 1e-5 apart, not
bit-equal). And ``load_image_square`` gives the JAX package's canvases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.data import coco as jax_coco
from image_captioning_ml_project_tpu.ops import resize as jax_resize
from image_captioning_ml_project_tpu_torch.data import coco
from image_captioning_ml_project_tpu_torch.ops import resize

torch.set_num_threads(1)

CANVAS = 48
# per image: the whole canvas, a downscale, the output size, an upscale
SIDES = [(48, 40, 32, 20), (33, 17, 9, 48), (1, 2, 47, 32)]


def _canvases(sides, seed):
    rs = np.random.RandomState(seed)
    out = np.zeros((len(sides), CANVAS, CANVAS, 3), np.uint8)
    for i, s in enumerate(sides):
        out[i, :s, :s] = rs.randint(0, 256, (s, s, 3))
    return out, np.asarray(sides, np.int32)


@pytest.mark.parametrize("out_size", [32, 24])
@pytest.mark.parametrize("sides", SIDES)
def test_resize_matches_jax(sides, out_size):
    canvas, s = _canvases(sides, sum(sides) + out_size)
    w = resize._resize_weights(torch.from_numpy(s), CANVAS, out_size)
    for i, side in enumerate(s):
        np.testing.assert_allclose(
            w[i].numpy(), np.asarray(jax_resize._resize_weights(
                jnp.int32(side), CANVAS, out_size)), atol=1e-6, rtol=0)
    got = resize.resize_square(torch.from_numpy(canvas), torch.from_numpy(s),
                               out_size)
    want = np.asarray(jax_resize.resize_square(canvas, s, out_size))
    assert got.shape == want.shape == (len(s), out_size, out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    got = resize.resize_normalize(torch.from_numpy(canvas),
                                  torch.from_numpy(s), out_size)
    want = np.asarray(jax_resize.resize_normalize(canvas, s, out_size))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_a_square_at_the_output_size_is_copied():
    """At ``s == out`` the triangle filter is the identity: the square's
    pixels come back (to float rounding) whatever lies beyond it."""
    canvas, s = _canvases((32, 32), 3)
    canvas[1, 32:] = 255
    got = resize.resize_square(torch.from_numpy(canvas), torch.from_numpy(s),
                               32)
    np.testing.assert_allclose(got.numpy(), canvas[:, :32, :32], atol=1e-3)


@pytest.mark.parametrize("fmt,size,jitter", [("png", 40, 9),
                                             ("jpg", 90, 40)])
def test_load_image_square_matches_jax(tmp_path, fmt, size, jitter):
    from image_captioning_ml_project_tpu_torch.data.synthetic import (
        make_synthetic_coco)

    root = make_synthetic_coco(str(tmp_path), num_images=6, image_size=size,
                               image_format=fmt, size_jitter=jitter)
    folder = tmp_path / "val2014"
    sides = set()
    for name in sorted(p.name for p in folder.iterdir()):
        for target, canvas in ((24, 48), (32, 48)):
            want = jax_coco.load_image_square(str(folder / name), target,
                                              canvas)
            got = coco.load_image_square(str(folder / name), target, canvas)
            assert got[1] == want[1] and got[1].dtype == np.int32
            np.testing.assert_array_equal(got[0], want[0])
            sides.add(int(got[1]))
    assert root and min(sides) < 48 and max(sides) == 48
