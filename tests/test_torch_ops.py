"""PyTorch port ops (unet_tpu_torch/ops: resize, pool, bitpack) against
their JAX counterparts in unet_tpu/ops on the same numpy inputs. Layouts
are transposed NHWC <-> NCHW at the boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops import bitpack as jbitpack
from unet_tpu.ops import pool as jpool
from unet_tpu.ops import resize as jresize
from unet_tpu_torch.ops import bitpack, pool, resize

torch.set_num_threads(2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('shape,out_hw', [
    ((2, 16, 16, 4), (32, 32)),    # the decoder's 2x
    ((1, 9, 7, 3), (18, 14)),      # odd sizes
    ((2, 5, 11, 2), (13, 6)),      # up in H, down in W
    ((1, 1, 6, 2), (4, 9)),        # a single source row
])
def test_resize_matches_jax(shape, out_hw, rng):
    """f32, atol 2e-6: ATen forms the source coordinate i*(in-1)/(out-1)
    in f32 where the JAX tables use f64, so each lerp weight can be off by
    half an f32 ulp of the coordinate (< 4.8e-7 below 16), times
    |b - a| <= 2 for inputs in [-1, 1], on each of the two axes; the
    lerp formulas also differ (w0*a + w1*b against a + (b-a)*w,
    resize.py:85) in the last bit."""
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear_align_corners(
        jnp.asarray(x), *out_hw))
    got = _nhwc(resize.resize_bilinear_align_corners(_nchw(x), *out_hw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_upsample2x_matches_jax(rng):
    x = rng.uniform(-1, 1, (2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(jresize.upsample2x_align_corners(jnp.asarray(x)))
    got = _nhwc(resize.upsample2x_align_corners(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize('src_hw,dst_hw', [
    ((8, 8), (8, 8)), ((8, 8), (9, 9)), ((4, 6), (9, 11)), ((2, 2), (3, 6)),
])
def test_pad_to_match_matches_jax(src_hw, dst_hw, rng):
    x = rng.standard_normal((2, *src_hw, 3)).astype(np.float32)
    want = np.asarray(jresize.pad_to_match(jnp.asarray(x), *dst_hw))
    got = _nhwc(resize.pad_to_match(_nchw(x), *dst_hw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('hw', [(8, 8), (9, 7), (5, 12)])
def test_max_pool_matches_jax(hw, rng):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jpool.max_pool(jnp.asarray(x)))
    got = _nhwc(pool.max_pool(_nchw(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('w', [50, 64, 3])
def test_pack_masks_device_matches_jax_and_numpy(w, rng):
    m = rng.random((2, 5, w)) > 0.5
    want_np = np.packbits(m.astype(np.uint8), axis=-1)
    want_jax = np.asarray(jbitpack.pack_masks_device(jnp.asarray(m)))
    got = bitpack.pack_masks_device(torch.from_numpy(m)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want_np)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(bitpack.unpack_masks_host(got, w),
                                  m.astype(np.uint8))
