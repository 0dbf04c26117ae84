"""The port's warp (unet_tpu_torch/ops/warp.py) against the JAX
package's fused warp (`augmentations._grid_sample_fused`) and its Pallas
kernel in interpret mode (`grid_sample_fused_pallas`), on the same numpy
inputs. The CUDA kernel runs only on a GPU; chip_smoke.py holds it
against the plain version there.

Contract (tests/test_pallas_warp.py:5-10): masks identical, images
within 2 f32 ULP (the JAX side's compilers may contract the lerp into
FMAs; the port's plain version rounds each operation once).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.data.augmentations import (_grid_sample_bilinear,
                                         _grid_sample_fused,
                                         _grid_sample_nearest)
from unet_tpu.ops.pallas.warp import grid_sample_fused_pallas
from unet_tpu_torch.ops import warp
from unet_tpu_torch.ops._build import launches

torch.set_num_threads(2)

H, W = 32, 128  # the Pallas kernel's smallest tile-aligned plane


def _case(name, n=2, h=H, w=W, c=1):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    img = rng.random((n, h, w, c)).astype(np.float32)
    msk = (rng.random((n, h, w)) > 0.7).astype(np.int32)
    return rng, img, msk


def _coords(kind, rng, n=2, h=H, w=W):
    rr = np.broadcast_to(np.arange(h, dtype=np.float32)[None, :, None],
                         (n, h, w))
    cc = np.broadcast_to(np.arange(w, dtype=np.float32)[None, None, :],
                         (n, h, w))
    if kind == 'scatter':      # incoherent, 6 px past every border
        return (rng.uniform(-6, h + 6, (n, h, w)).astype(np.float32),
                rng.uniform(-6, w + 6, (n, h, w)).astype(np.float32))
    if kind == 'identity':
        return rr.copy(), cc.copy()
    if kind == 'shift':        # sub-pixel shift with .5 column ties
        return rr + np.float32(3.25), cc - np.float32(7.5)
    if kind == 'rotation':     # +-15 degrees plus a smooth wobble
        yy, xx = rr - (h - 1) / 2, cc - (w - 1) / 2
        a = np.asarray([0.26, -0.26], np.float32)[:, None, None]
        rows = np.cos(a) * yy + np.sin(a) * xx + (h - 1) / 2 \
            + rng.normal(0, 0.7, (n, h, w))
        cols = -np.sin(a) * yy + np.cos(a) * xx + (w - 1) / 2 \
            + rng.normal(0, 0.7, (n, h, w))
        return rows.astype(np.float32), cols.astype(np.float32)
    assert kind == 'ties'      # frac == .5 on both axes everywhere
    return rr + np.float32(0.5), cc + np.float32(0.5)


def assert_ulp_close(got, want, max_ulp=2):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    ok = (ulp <= max_ulp) | (got == want)
    assert ok.all(), f'{(~ok).sum()} px beyond {max_ulp} ULP'


def _port(img, msk, rows, cols):
    """The port's wrapper on CPU tensors (the plain route), NHWC in/out."""
    out_i, out_m = warp.grid_sample_fused(
        torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(msk.astype(np.uint8)),
        torch.from_numpy(np.ascontiguousarray(rows)),
        torch.from_numpy(np.ascontiguousarray(cols)))
    return out_i.permute(0, 2, 3, 1).numpy(), out_m.numpy()


@pytest.mark.parametrize('kind', ['scatter', 'identity', 'shift',
                                  'rotation', 'ties'])
def test_plain_warp_matches_jax_fused_and_pallas(kind):
    rng, img, msk = _case(kind)
    rows, cols = _coords(kind, rng)
    got_i, got_m = _port(img, msk, rows, cols)
    args = [jnp.asarray(a) for a in (img, msk, rows, cols)]
    for want_i, want_m in (_grid_sample_fused(*args),
                           grid_sample_fused_pallas(*args)):
        assert_ulp_close(got_i, want_i)
        np.testing.assert_array_equal(got_m, np.asarray(want_m))


@pytest.mark.parametrize('kind', ['scatter', 'rotation', 'ties'])
def test_plain_warp_any_plane_size(kind):
    """A plane the Pallas kernel does not take (20 x 36): held against
    the fused XLA path only."""
    rng, img, msk = _case('odd' + kind, h=20, w=36)
    rows, cols = _coords(kind, rng, h=20, w=36)
    got_i, got_m = _port(img, msk, rows, cols)
    want_i, want_m = _grid_sample_fused(
        *[jnp.asarray(a) for a in (img, msk, rows, cols)])
    assert_ulp_close(got_i, want_i)
    np.testing.assert_array_equal(got_m, np.asarray(want_m))


def test_smallest_plane_takes_the_last_row():
    """H = W = 2: r0 is clamped to 0, so at the last row wr = 1.0 and
    the mask takes row 1."""
    img = np.asarray([[[[1.0], [2.0]], [[3.0], [4.0]]]], np.float32)
    msk = np.asarray([[[0, 0], [1, 1]]], np.int32)
    rows = np.full((1, 2, 2), 1.0, np.float32)
    cols = np.asarray([[[0.0, 1.0], [0.25, 0.75]]], np.float32)
    got_i, got_m = _port(img, msk, rows, cols)
    np.testing.assert_array_equal(got_i[0, ..., 0], [[3.0, 4.0],
                                                     [3.25, 3.75]])
    np.testing.assert_array_equal(got_m[0], [[1, 1], [1, 1]])


@pytest.mark.parametrize('kind', ['scatter', 'rotation', 'shift'])
def test_bilinear_and_nearest_pair_for_multichannel(kind):
    """C > 1: the plain bilinear and nearest samplers against
    `_grid_sample_bilinear` / `_grid_sample_nearest` (3 channels)."""
    rng, img, msk = _case('mc' + kind, c=3)
    rows, cols = _coords(kind, rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got_i = warp.grid_sample_bilinear(t(img).permute(0, 3, 1, 2),
                                      t(rows), t(cols))
    got_m = warp.grid_sample_nearest(t(msk), t(rows), t(cols))
    want_i = _grid_sample_bilinear(jnp.asarray(img), jnp.asarray(rows),
                                   jnp.asarray(cols))
    want_m = _grid_sample_nearest(jnp.asarray(msk), jnp.asarray(rows),
                                  jnp.asarray(cols))
    assert_ulp_close(got_i.permute(0, 2, 3, 1).numpy(), want_i)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_wrapper_on_cpu_takes_plain_path(monkeypatch):
    monkeypatch.setitem(launches, 'warp', 0)
    rng, img, msk = _case('wrap')
    rows, cols = _coords('rotation', rng)
    args = (torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(msk.astype(np.uint8)), torch.from_numpy(rows),
            torch.from_numpy(cols))
    got = warp.grid_sample_fused(*args)
    want = warp.grid_sample_fused_reference(*args)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.uint8
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launches['warp'] == 0


@pytest.mark.parametrize('breakage,error', [
    ('mask_int32', TypeError), ('image_f64', TypeError),
    ('three_channels', ValueError), ('one_row', ValueError),
    ('cols_shape', ValueError), ('meta_device', ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(breakage, error):
    n, h, w = 2, 8, 8
    img = torch.rand(n, 1, h, w)
    msk = torch.zeros(n, h, w, dtype=torch.uint8)
    rows, cols = torch.rand(n, h, w), torch.rand(n, h, w)
    if breakage == 'mask_int32':
        msk = msk.int()
    elif breakage == 'image_f64':
        img = img.double()
    elif breakage == 'three_channels':
        img = torch.rand(n, 3, h, w)
    elif breakage == 'one_row':
        img, msk = img[:, :, :1], msk[:, :1]
        rows, cols = rows[:, :1], cols[:, :1]
    elif breakage == 'cols_shape':
        cols = cols[:, :, :-1]
    elif breakage == 'meta_device':
        img, msk, rows, cols = (t.to('meta') for t in (img, msk, rows, cols))
    with pytest.raises(error):
        warp.grid_sample_fused(img, msk, rows, cols)
