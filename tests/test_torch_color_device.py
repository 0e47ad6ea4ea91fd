"""The device half of the port's colour prep (``piccolo_tpu_torch.color``)
against the JAX package's, on the CPU (where the histogram kernels run
their plain versions).

  * ``cloud_color_cdf`` and ``cloud_sharpen_state`` equal the JAX package's
    outputs bit for bit (the same numpy code).
  * ``color_mod_device`` equals JAX's ``color_mod_device`` bit for bit: the
    YCrCb math, the Y histogram counts and the LUT are exact integers in
    both, and the one float division matches.
  * ``color_match_device`` is within 1e-5 of JAX's.  Not bit for bit: the
    sin(latitude) weights (torch's and XLA's ``sin`` differ in the last bit
    on some rows) and the weighted sums (per-row counts here, one MXU-shaped
    dot there) are f32 in another order, and the LUT is linear in the
    quantile, so one ulp of a channel's quantile moves every pixel of that
    bin by ulps.  Both stay within 1e-5 of the host's f64 ``color_match``.
  * ``interp`` equals ``jnp.interp`` on the padded CDF nodes to one ulp
    (XLA compiles the blend's divide its own way); black pixels
    and padded cloud rows stay exactly 0; ``num_bins`` and ``pad_to`` are
    validated.
"""

import numpy as np
import pytest
import torch

from piccolo_tpu_torch import color as tcolor
from piccolo_tpu_torch.convert import cdf_from_numpy, sharpen_state_from_numpy

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _images(rng, H=64, W=128):
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8).astype(np.float32) / 255.0
    img[5:9, 10:20] = 0.0  # a black patch
    return img


@pytest.mark.parametrize("quantized", [False, True])
def test_cloud_states_equal_jax(rng, quantized):
    from piccolo_tpu import color as jcolor

    rgb = rng.random((3000, 3)).astype(np.float32)
    if quantized:  # uint8-derived colours and a heavily padded channel
        rgb = (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0
        rgb[:, 2] = np.round(rgb[:, 2] * 7) / 7
    for a, b in zip(tcolor.cloud_color_cdf(rgb), jcolor.cloud_color_cdf(rgb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = tcolor.cloud_sharpen_state(rgb, pad_to=3300)
    want = jcolor.cloud_sharpen_state(rgb, pad_to=3300)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape,pad_to", [((48, 96), 3300), ((32, 64), 3000)])
def test_color_mod_device_bit_exact_with_jax(rng, shape, pad_to):
    import jax.numpy as jnp

    from piccolo_tpu import color as jcolor

    img = _images(rng, *shape)
    img[:6, :6] = 0.0
    rgb = (rng.random((3000, 3)) * 255).astype(np.uint8).astype(np.float32) / 255.0
    st = tcolor.cloud_sharpen_state(rgb, pad_to=pad_to)
    got_img, got_rgb = tcolor.color_mod_device(
        torch.tensor(img), sharpen_state_from_numpy(st, "cpu"))
    want_img, want_rgb = jcolor.color_mod_device(
        jnp.asarray(img), jcolor.SharpenState(*(jnp.asarray(a) for a in st)))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_rgb.numpy(), np.asarray(want_rgb))
    assert got_img.dtype == got_rgb.dtype == torch.float32
    assert torch.all(got_img[:6, :6] == 0.0)
    assert torch.all(got_rgb[3000:] == 0.0)
    # and the host colour_mod within the JAX package's own tolerance
    h_img, h_rgb = tcolor.color_mod(img.copy(), rgb, 256)
    tol = 1.001 / 255.0
    assert np.abs(got_img.numpy() - h_img).max() <= tol
    assert np.abs(got_rgb.numpy()[:3000] - h_rgb).max() <= tol


@pytest.mark.parametrize("quantized", [False, True])
def test_color_match_device_matches_jax(rng, quantized):
    import jax.numpy as jnp

    from piccolo_tpu import color as jcolor

    img = _images(rng)
    rgb = rng.random((5000, 3)).astype(np.float32)
    if quantized:
        rgb = (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0
        rgb[:, 2] = np.round(rgb[:, 2] * 7) / 7
    vals, qnt = tcolor.cloud_color_cdf(rgb)
    got = tcolor.color_match_device(torch.tensor(img),
                                    *cdf_from_numpy((vals, qnt), "cpu"))
    got = got.numpy()
    want = np.asarray(jcolor.color_match_device(
        jnp.asarray(img), jnp.asarray(vals), jnp.asarray(qnt)))
    assert got.shape == img.shape and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(got - tcolor.color_match(img.copy(), rgb)).max() < 1e-5
    assert np.all(got[5:9, 10:20] == 0.0)


def test_color_match_device_row_counts_are_exact(rng):
    """The per-(channel, row) bin counts that feed the weighting equal
    numpy's bincount of each row's non-black pixels."""
    from piccolo_tpu_torch.kernels.block_histogram import block_histogram

    img = _images(rng, 16, 32)
    img_i = (torch.tensor(img) * 255).to(torch.int32)
    nonblack = img_i.sum(-1) > 0
    ids = img_i.permute(2, 0, 1).reshape(48, 32).contiguous()
    mask = nonblack.to(torch.float32).repeat(3, 1).contiguous()
    counts = block_histogram(ids, mask, 256).numpy()
    ref = np.stack([np.bincount(ids[r][mask[r] > 0].numpy(), minlength=256)
                    for r in range(48)])
    np.testing.assert_array_equal(counts, ref)


def test_interp_matches_jnp_on_padded_nodes(rng):
    import jax.numpy as jnp

    rgb = rng.random((2000, 3)).astype(np.float32)
    rgb[:, 2] = np.round(rgb[:, 2] * 7) / 7  # few unique values: heavy pad
    vals, qnt = tcolor.cloud_color_cdf(rgb)
    q = np.concatenate([np.linspace(0, 1, 513), [-0.5, 1.0, 1.5, 7.0]]
                       ).astype(np.float32)
    for c in range(3):
        got = tcolor.interp(torch.tensor(q), torch.tensor(qnt[c]),
                            torch.tensor(vals[c])).numpy()
        want = np.asarray(jnp.interp(jnp.asarray(q), jnp.asarray(qnt[c]),
                                     jnp.asarray(vals[c])))
        # one ulp: XLA compiles the blend's divide its own way
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
        assert (got == want).mean() > 0.9
        v, cnt = np.unique(rgb[:, c], return_counts=True)
        ref = np.interp(q[:513], np.cumsum(cnt) / rgb.shape[0], v)
        np.testing.assert_allclose(got[:513], ref, rtol=0, atol=1e-6)


def test_validation(rng):
    rgb = rng.random((100, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="num_bins"):
        tcolor.cloud_sharpen_state(rgb, num_bins=128)
    with pytest.raises(ValueError, match="pad_to"):
        tcolor.cloud_sharpen_state(rgb, pad_to=50)
