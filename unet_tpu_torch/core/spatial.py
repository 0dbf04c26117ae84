"""Height-sharded eval forward of UNet and AttentionUNet over a list of
devices, in one process.

Counterpart of ``unet_tpu/core/mesh.py::spatial_sharding``, which shards
the image height of a batch over the devices and lets GSPMD partition
every op of the forward, inserting the exchanges that keep it exact.
This module makes those exchanges by hand:

- **Bands.** Each device holds a contiguous band of rows
  (``band_edges``): edges on multiples of 2^4 (the models' four pools)
  where the height allows it, so that every 2x2 max-pool starts on an
  even row; uneven bands where the height does not split evenly.
- **3x3 convs.** Before every 3x3 conv each band takes one halo row
  from each neighbouring band (zeros at the global top and bottom) and
  convolves without padding along the height.
- **Max-pool.** Band [s, e) pools to [s // 2, e // 2), taking a row it
  lacks from its neighbour. Bands left without rows drop out, so where a
  level has fewer rows than bands (the bottleneck at 32^2 over 8
  devices) its rows are regathered onto fewer devices.
- **Align-corners upsamples** (``Up``'s 2x and the gate's resize of
  ``W_g(g)``): output row i reads source row i * (H_in - 1) / (H_out -
  1) on the global heights, which may lie on another band; a band
  gathers the source rows its output rows read and computes only those
  (``ops/resize.py::resize_rows_align_corners``). ``pad_to_match``'s
  rows are zeros. The stride-2 transposed conv's output row j reads
  source row j // 2.
- **Row-local ops**: eval BatchNorm, ReLU, the 1x1 convs, sigmoid,
  ``x * att``, concat and ``OutConv``.
- **Gates.** Where the model runs a gate fused (``AttentionGate.
  takes_fused`` on the whole map's shapes, the rule of the unsharded
  forward), each band gathers the rows of ``g`` its rows read and
  launches the gate kernel on its band (``ops/attention_gate.py::
  GateBand``), which computes the band's rows on the global coordinates.
  Elsewhere the gate's ATen route runs on each band: ``W_g`` on the
  coarse bands, resized to the band's rows.

Deep supervision's heads are a training output: the eval forward returns
the logits, as the model's own eval forward does.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.models.unet import AttentionUNet, UNet
from unet_tpu_torch.ops.attention_gate import GateBand
from unet_tpu_torch.ops.pool import max_pool
from unet_tpu_torch.ops.resize import resize_rows_align_corners, source_rows

LEVELS = 4  # the models' pooling depth
_CL = torch.channels_last


def band_edges(height: int, bands: int) -> List[int]:
    """Row edges (``bands + 1`` of them, or fewer where the height has
    fewer rows than bands) that split ``height`` rows into bands on
    multiples of the largest 2^k (k <= LEVELS) leaving every band at
    least one multiple; the multiples split as evenly as they go (the
    first bands take one more), and the last band also takes the rows
    past the last multiple."""
    for k in range(LEVELS, -1, -1):
        unit = 2 ** k
        units = height // unit
        if units >= bands:
            break
    bands = min(bands, units)
    q, r = divmod(units, bands)
    edges = [0]
    for b in range(bands):
        edges.append(edges[-1] + (q + (b < r)) * unit)
    edges[-1] = height
    return edges


def _guard(device: torch.device):
    return (torch.cuda.device(device) if device.type == 'cuda'
            else contextlib.nullcontext())


class _Band:
    """Rows [start, start + t.shape[2]) of a tensor, on ``device``."""

    def __init__(self, device: torch.device, start: int, t: torch.Tensor):
        self.device, self.start, self.t = device, start, t

    @property
    def stop(self) -> int:
        return self.start + self.t.shape[2]


class _Banded:
    """An (N, C, height, W) tensor held as row bands over devices."""

    def __init__(self, height: int, bands: List[_Band]):
        self.height, self.bands = height, bands

    @property
    def width(self) -> int:
        return self.bands[0].t.shape[3]

    def rows(self, start: int, stop: int, device: torch.device
             ) -> torch.Tensor:
        """Global rows [start, stop) on ``device``, copied from the bands
        that hold them; zeros above row 0 and below the last row."""
        ref = self.bands[0].t
        zeros = lambda k: ref.new_zeros((ref.shape[0], ref.shape[1], k,
                                         ref.shape[3]), device=device)
        parts = [zeros(-start)] if start < 0 else []
        for band in self.bands:
            a, b = max(start, band.start), min(stop, band.stop)
            if a < b:
                parts.append(band.t[:, :, a - band.start:b - band.start]
                             .to(device))
        if stop > self.height:
            parts.append(zeros(stop - self.height))
        out = parts[0] if len(parts) == 1 else torch.cat(parts, 2)
        return out.contiguous(memory_format=_CL)


class SpatialShardedModel(nn.Module):
    """``model`` (a ``UNet`` or ``AttentionUNet`` in eval mode) with its
    forward sharded along the image height over ``devices``: one eval
    copy per device (the model itself on its own device), each band's
    ops enqueued under its device's guard. ``forward(x)`` takes and
    returns whole (N, C, H, W) tensors on x's device; the logits equal
    the unsharded forward's up to the order of float sums."""

    def __init__(self, model: nn.Module, devices):
        super().__init__()
        if not isinstance(model, (UNet, AttentionUNet)):
            raise TypeError(f'cannot shard {type(model).__name__}: a UNet '
                            'or AttentionUNet is needed')
        self.model = model.eval()
        self.devices = [torch.device(d) for d in devices]
        self._copies = {next(model.parameters()).device: self.model}
        for d in self.devices:
            if d not in self._copies:
                self._copies[d] = copy.deepcopy(self.model).to(d).eval()
        for d in self._copies:
            if d.type == 'cuda':
                torch.cuda.synchronize(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.model
        x = x.to(dtype=m.dtype, memory_format=_CL)
        edges = band_edges(x.shape[2], len(self.devices))
        b = _Banded(x.shape[2], [
            _Band(d, s, x[:, :, s:e].to(d))
            for d, s, e in zip(self.devices, edges[:-1], edges[1:])])
        x1 = self._double_conv(b, lambda m: m.inc)
        x2 = self._down(x1, lambda m: m.down1)
        x3 = self._down(x2, lambda m: m.down2)
        x4 = self._down(x3, lambda m: m.down3)
        x5 = self._down(x4, lambda m: m.down4)
        up = (self._attention_up if isinstance(m, AttentionUNet)
              else self._up)
        y = up(x5, x4, lambda m: m.up1)
        y = up(y, x3, lambda m: m.up2)
        y = up(y, x2, lambda m: m.up3)
        y = up(y, x1, lambda m: m.up4)
        y = self._map(y, lambda m, t: m.outc(t).float())
        return y.rows(0, y.height, x.device)

    # -- band ops ------------------------------------------------------

    def _map(self, b: _Banded, fn: Callable) -> _Banded:
        """A row-local ``fn(model copy, rows)`` on every band."""
        out = []
        for band in b.bands:
            with _guard(band.device):
                out.append(_Band(band.device, band.start,
                                 fn(self._copies[band.device], band.t)))
        return _Banded(b.height, out)

    def _conv3x3(self, b: _Banded, get: Callable) -> _Banded:
        """The bias-free 3x3 SAME conv ``get(model)`` on halo rows."""
        out = []
        for band in b.bands:
            with _guard(band.device):
                conv = get(self._copies[band.device])
                halo = b.rows(band.start - 1, band.stop + 1, band.device)
                out.append(_Band(band.device, band.start, F.conv2d(
                    halo, conv.weight.to(halo.dtype), None, 1, (0, 1))))
        return _Banded(b.height, out)

    def _double_conv(self, b: _Banded, get: Callable) -> _Banded:
        """``get(model)``, a DoubleConv: (3x3 conv, BN, ReLU) twice."""
        for i in (0, 3):
            b = self._conv3x3(b, lambda m: get(m).double_conv[i])
            b = self._map(b, lambda m, t: get(m).double_conv[i + 2](
                get(m).double_conv[i + 1](t)))
        return b

    def _down(self, b: _Banded, get: Callable) -> _Banded:
        """Max-pool, then ``get(model)``'s DoubleConv."""
        bands = []
        for band in b.bands:
            s, e = band.start // 2, band.stop // 2
            if e > s:
                with _guard(band.device):
                    bands.append(_Band(band.device, s, max_pool(
                        b.rows(2 * s, 2 * e, band.device))))
        return self._double_conv(_Banded(b.height // 2, bands),
                                 lambda m: get(m).maxpool_conv[1])

    def _upsampled(self, coarse: _Banded, skip: _Banded,
                   get: Callable) -> _Banded:
        """On the skip's bands, ``pad_to_match(upsample(coarse), H, W)``
        of ``get(model)`` (an ``Up`` or ``AttentionUp``): the 2x
        align-corners resize, or the stride-2 transposed conv."""
        hu, wu = 2 * coarse.height, 2 * coarse.width
        top = (skip.height - hu) // 2
        dw = skip.width - wu
        out = []
        for band in skip.bands:
            d = band.device
            j0, j1 = band.start - top, band.stop - top  # upsampled rows
            a, z = max(j0, 0), min(j1, hu)
            with _guard(d):
                up = get(self._copies[d]).up
                if a >= z:  # every row is pad_to_match's
                    a = z = j0
                    ref = coarse.bands[0].t
                    t = ref.new_zeros((ref.shape[0], ref.shape[1] if up is
                                       None else up.out_channels, 0, wu),
                                      device=d)
                elif up is None:
                    lo, hi = source_rows(coarse.height, hu, a, z)
                    t = resize_rows_align_corners(
                        coarse.rows(lo, hi, d), lo, coarse.height, hu, wu,
                        a, z)
                else:
                    lo = a // 2
                    t = up(coarse.rows(lo, (z + 1) // 2, d))
                    t = t[:, :, a - 2 * lo:z - 2 * lo]
                t = F.pad(t, (dw // 2, dw - dw // 2, a - j0, j1 - z))
                out.append(_Band(d, band.start,
                                 t.contiguous(memory_format=_CL)))
        return _Banded(skip.height, out)

    def _concat_conv(self, skip: _Banded, up: _Banded,
                     get: Callable) -> _Banded:
        """``get(model)``'s DoubleConv on [skip, up] (channels)."""
        cat = _Banded(skip.height, [
            _Band(s.device, s.start, torch.cat((s.t, u.t), 1))
            for s, u in zip(skip.bands, up.bands)])
        return self._double_conv(cat, lambda m: get(m).conv)

    def _up(self, coarse: _Banded, skip: _Banded, get: Callable
            ) -> _Banded:
        """``Up``: upsample the coarse map, pad, concat, DoubleConv."""
        return self._concat_conv(skip, self._upsampled(coarse, skip, get),
                                 get)

    def _attention_up(self, coarse: _Banded, skip: _Banded,
                      get: Callable) -> _Banded:
        """``AttentionUp``: the gate on the skip's bands, then ``Up``. The
        gate runs fused where the unsharded forward runs it fused (each
        band with the coarse rows it reads), else its ATen route
        (``W_g`` on the coarse bands, resized to each band's rows on the
        global heights)."""
        ref = coarse.bands[0].t
        fused = get(self.model).attention.takes_fused(
            (ref.shape[0], ref.shape[1], coarse.height, coarse.width),
            (ref.shape[0], skip.bands[0].t.shape[1], skip.height,
             skip.width))
        if not fused:
            wg = self._map(coarse, lambda m, t: get(m).attention.W_g(t))
        gated = []
        for band in skip.bands:
            d, s, e = band.device, band.start, band.stop
            with _guard(d):
                gate = get(self._copies[d]).attention
                lo, hi = source_rows(coarse.height, skip.height, s, e)
                if fused:
                    out = gate.fused(coarse.rows(lo, hi, d), band.t,
                                     GateBand(s, lo, coarse.height,
                                              skip.height))
                else:
                    g1 = resize_rows_align_corners(
                        wg.rows(lo, hi, d), lo, coarse.height, skip.height,
                        skip.width, s, e)
                    att = torch.sigmoid(gate.psi(torch.relu(
                        g1 + gate.W_x(band.t))))
                    out = band.t * att.to(band.t.dtype)
                gated.append(_Band(d, s, out))
        gated = _Banded(skip.height, gated)
        return self._concat_conv(gated, self._upsampled(coarse, gated, get),
                                 get)
