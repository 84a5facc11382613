"""Spatial (height) sharding: one frame split by rows over a mesh's devices.

Counterpart of ``retinex_tpu/parallel/spatial.py``. There GSPMD partitions
the jitted forward over a 1-D mesh with the frame's height sharded, and
inserts every halo exchange and all-reduce itself. Here a mesh is the
ordered devices of this process (``parallel/mesh.py``) and a sharded frame
is a list of row slabs, slab i on device i (``shard_rows``); one process
drives every slab, as JAX's single controller does, so the same code runs
on several cards, on a mesh that repeats one card, and on n logical CPU
shards. The cross-slab steps are written by hand:

- a stage's rows that another slab holds (a convolution's or a pool's halo,
  a resize's neighbouring rows) are copied from it: ``_Net.rows`` assembles
  any global row range of a stage from whichever slabs hold it, zeros (or
  nothing) beyond the frame's top and bottom;
- a global mean (the FAM's channel attention, ASPP's pool) is the sum of the
  slabs' partial sums over the frame's count, on the first device, copied
  to every slab;
- CLAHE's tile tables are concatenated from the slabs' tile rows.

``make_spatial_forward`` runs the standard forward (``MultiScaleUPRetinex``,
not the packed one) in the model's dtype. Every stage's rows are split over
the slabs as evenly as they go (``split_rows``): with H % (8 n) == 0 every
stage down to /8 splits evenly, and a stage that does not (the scale-3
tower's H/16, 8.5 rows a slab at 1088 rows on 8, or 4 rows over 8 slabs at
64) has slabs of uneven height, some of them empty. Each slab computes its
own output rows of each operation from the input rows that they read. Its
outputs equal the one-device forward's but for the means' summation order
(within 2e-6 in f32, as the JAX package's GSPMD forward).

``make_spatial_clahe`` runs the classical ``clahe`` (K1, K2, K3 in their
float instances) and ``clahe_luma`` (K2, K7) with each slab holding whole
tile rows: K2 builds each slab's tile rows' tables, the tables are gathered
into the frame's, and K3 or K7 applies them to each slab at its cell-row
offset ``row0``. Its bytes are those of the one-device route.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from retinex_tpu_torch.models.layers import (
    ASPPModule,
    BatchNorm,
    Conv,
    ConvTranspose,
    Dropout,
    EnhancedFAM,
    PreActResBlock,
    ResBlock,
    Sigmoid,
    UpBlock,
)
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops import bf16
from retinex_tpu_torch.ops.resize import resize_bilinear_nchw
from retinex_tpu_torch.parallel.mesh import Mesh

# The modules that act on each pixel alone (the net is in eval mode), so a
# slab computes them on its own rows.
_POINTWISE = (BatchNorm, Dropout, nn.ReLU, Sigmoid, nn.Identity)


def split_rows(n_rows: int, n: int) -> list[int]:
    """Bounds of `n_rows` rows split into n slabs as evenly as they go:
    slab i holds rows [b[i], b[i+1])."""
    return [i * n_rows // n for i in range(n + 1)]


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """An NHWC frame batch [B,H,W,C] as its mesh.size row slabs
    (``split_rows``), slab i copied to mesh.devices[i]: the counterpart of
    ``jax.device_put(x, spatial_sharding(mesh))``."""
    b = split_rows(x.shape[1], mesh.size)
    return [x[:, lo:hi].to(d) for lo, hi, d in zip(b, b[1:], mesh.devices)]


def gather_rows(slabs: list[torch.Tensor], device: str | torch.device) -> torch.Tensor:
    """Row slabs of NHWC frames joined on one device."""
    return torch.cat([s.to(device) for s in slabs], dim=1)


def _on(dev: torch.device):
    """The card of `dev` current (the kernels launch on the current card)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------- classical CLAHE


def make_spatial_clahe(
    mesh: Mesh,
    mode: str = "clahe",
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
):
    """H-sharded classical CLAHE of one frame batch.

    Returns fn(slabs) -> slabs: float [0,1] NHWC row slabs (``shard_rows``)
    in, float [0,1] NHWC slabs out, the bytes of the one-device route of
    `mode` ("clahe": ``ops/clahe.clahe_lab_rgb``, "clahe_luma":
    ``ops/clahe_luma.clahe_luma_rgb``). The mesh size must divide `tiles`
    and H, W be multiples of 2 * tiles, so that each slab holds 2 * tiles / n
    whole cell rows. Per slab: the mode's prologue (K1's float instance, or
    the quantised frame and its luma) and K2 on the slab's tile rows; then
    the frame's tables, concatenated from the slabs' on every device (a
    tile's LUT depends only on its own histogram and the common tile area,
    so gathering LUTs gives the JAX package's all-gathered histograms'
    bytes); then K3's float instance or K7 on NHWC at the slab's cell-row
    offset."""
    from retinex_tpu_torch.ops import clahe_gather as cg
    from retinex_tpu_torch.ops import clahe_luma as cl
    from retinex_tpu_torch.ops.colorspace import ieee_div

    if mode not in ("clahe", "clahe_luma"):
        raise ValueError(f"unknown spatial CLAHE mode {mode!r}")
    n = mesh.size
    ncy, ncx = 2 * tiles, 2 * tiles
    if tiles % n != 0:
        raise ValueError(f"mesh size {n} must divide the tile grid ({tiles})")
    ncy_loc = ncy // n

    def fn(slabs: list[torch.Tensor]) -> list[torch.Tensor]:
        if len(slabs) != n:
            raise ValueError(f"{len(slabs)} slabs for a mesh of {n}")
        h, w = sum(s.shape[1] for s in slabs), slabs[0].shape[2]
        if h % ncy or w % ncx:
            raise ValueError(
                f"spatial CLAHE needs H % {ncy} == 0 and W % {ncx} == 0; got {(h, w)} (tiles={tiles}, mesh={n})"
            )
        if any(s.shape[1] != h // n for s in slabs):
            raise ValueError(f"the slabs must be the frame's {n} equal row slabs (shard_rows)")
        planes, luts = [], []
        for s, dev in zip(slabs, mesh.devices):
            with _on(dev):
                if mode == "clahe":
                    plane = cg.lab_fwd_f32_nhwc(s.to(torch.float32))
                    src = plane
                else:
                    xq = torch.clamp(torch.round(torch.clamp(s, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8)
                    xq = xq.contiguous()
                    plane = (xq, cl._luma_u8(xq, dim=3))
                    src = plane[1]
                planes.append(plane)
                luts.append(cg.clahe_tables(src, clip_limit, tiles // n, tiles, hist_subsample))
        # The one cross-slab step: every slab's tile rows into the frame's
        # [b, tiles, tiles, 256] tables, on each device.
        frame_luts = {d: torch.cat([t.to(d) for t in luts], dim=1) for d in dict.fromkeys(mesh.devices)}
        out = []
        for i, (plane, dev) in enumerate(zip(planes, mesh.devices)):
            with _on(dev):
                if mode == "clahe":
                    out.append(cg.clahe_apply_f32_nhwc(plane, frame_luts[dev], i * ncy_loc, ncy_loc))
                else:
                    o = cl.clahe_luma_apply_u8(plane[0], plane[1], frame_luts[dev], i * ncy_loc, ncy_loc)
                    out.append(ieee_div(o.to(torch.float32), 255.0))
        return out

    return fn


# ---------------------------------------------------------------- the net


@dataclasses.dataclass
class Rows:
    """One stage's NCHW tensor split by rows: parts[i] holds the frame's
    rows [bounds[i], bounds[i + 1]) on the mesh's device i."""

    parts: list[torch.Tensor]
    bounds: list[int]

    @property
    def n_rows(self) -> int:
        return self.bounds[-1]


class _Net:
    """The standard forward of one MultiScaleUPRetinex on row slabs; nets[i]
    is the copy of the weights on the mesh's device i. Each method mirrors
    the module of the same name in ``models/layers.py`` and
    ``models/retinex_net.py`` with the same operations in the same order;
    the convolutions run through the module's own ``Conv.padded``. A module
    type with no rule here raises (``module``)."""

    def __init__(self, nets: list[MultiScaleUPRetinex], devices: tuple[torch.device, ...]):
        self.nets = nets
        self.devices = devices
        self.n = len(devices)

    # -- moving rows

    def rows(self, t: Rows, lo: int, hi: int, i: int) -> torch.Tensor:
        """The stage's rows [lo, hi) on device i, from whichever slabs hold
        them; rows beyond the frame's top or bottom are zeros (the
        convolutions' padding, and the pools' on non-negative inputs)."""
        if (lo, hi) == (t.bounds[i], t.bounds[i + 1]):
            return t.parts[i]
        dev, ref = self.devices[i], t.parts[i]
        b, c, _, w = ref.shape
        pieces = []

        def zeros(k: int) -> torch.Tensor:
            return ref.new_zeros((b, c, k, w)).contiguous(memory_format=torch.channels_last)

        top, bottom = max(0, min(0, hi) - lo), max(0, hi - max(t.n_rows, lo))
        if top:
            pieces.append(zeros(top))
        for j in range(self.n):
            s0, s1 = max(lo, t.bounds[j]), min(hi, t.bounds[j + 1])
            if s0 < s1:
                pieces.append(t.parts[j][:, :, s0 - t.bounds[j] : s1 - t.bounds[j]].to(dev))
        if bottom:
            pieces.append(zeros(bottom))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)

    def _stencil(self, t: Rows, n_out: int, out_ch: int, out_w: int, dtype, compute) -> Rows:
        """A stage of n_out rows: part i = compute(o0, o1, i) for its rows
        [o0, o1), empty where a slab holds none."""
        bounds = split_rows(n_out, self.n)
        parts = []
        for i in range(self.n):
            o0, o1 = bounds[i], bounds[i + 1]
            if o0 == o1:
                ref = t.parts[i]
                empty = ref.new_empty((ref.shape[0], out_ch, 0, out_w), dtype=dtype)
                parts.append(empty.contiguous(memory_format=torch.channels_last))
            else:
                parts.append(compute(o0, o1, i))
        return Rows(parts, bounds)

    def map(self, fn, *ts: Rows) -> Rows:
        """A pointwise function of stages that share their rows' split, per
        slab: fn(i, *parts)."""
        if any(t.bounds != ts[0].bounds for t in ts[1:]):
            raise ValueError(f"pointwise stages split their rows differently: {[t.bounds for t in ts]}")
        return Rows([fn(i, *ps) for i, ps in enumerate(zip(*(t.parts for t in ts)))], ts[0].bounds)

    def mean(self, t: Rows) -> list[torch.Tensor]:
        """The frame's mean over H and W, [B,C,1,1] in t's dtype, on each
        device: the slabs' f32 sums added on the first device, over the
        frame's count (``MeanPool``: f32; bf16 rounded once)."""
        home = self.devices[0]
        total = None
        for p in t.parts:
            s = p.float().sum(dim=(2, 3), keepdim=True).to(home)
            total = s if total is None else total + s
        m = (total / (t.n_rows * t.parts[0].shape[3])).to(t.parts[0].dtype)
        return [m.to(d) for d in self.devices]

    # -- operations with a reach in H

    def conv(self, name, t: Rows) -> Rows:
        """The convolution `name(net)` of each slab's copy (stride, dilation
        and 'same' padding as the module's)."""
        ms = [name(net) for net in self.nets]
        m = ms[0]
        k, s, d, p = m.kernel_size[0], m.stride[0], m.dilation[0], m.padding[0]
        kw, sw, dw, pw = m.kernel_size[1], m.stride[1], m.dilation[1], m.padding[1]
        w = t.parts[0].shape[3]
        n_out = (t.n_rows + 2 * p - d * (k - 1) - 1) // s + 1
        out_w = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1

        def compute(o0, o1, i):
            return ms[i].padded(self.rows(t, s * o0 - p, s * (o1 - 1) - p + d * (k - 1) + 1, i), (0, pw))

        return self._stencil(t, n_out, m.out_channels, out_w, m.compute_dtype, compute)

    def conv_transpose(self, name, t: Rows) -> Rows:
        """``ConvTranspose`` (2x2, stride 2): output row r from input row r // 2."""
        ms = [name(net) for net in self.nets]
        m = ms[0]

        def compute(o0, o1, i):
            a = o0 // 2
            y = ms[i](self.rows(t, a, (o1 + 1) // 2, i))
            return y[:, :, o0 - 2 * a : o1 - 2 * a]

        return self._stencil(t, 2 * t.n_rows, m.out_channels, 2 * t.parts[0].shape[3], m.compute_dtype, compute)

    def max_pool(self, t: Rows, k: int, s: int, p: int) -> Rows:
        """``max_pool_nonneg`` / ``nn.MaxPool2d``: zeros beyond the frame in
        H (exact for the non-negative inputs), the module's padding in W."""
        ref = t.parts[0]
        w = ref.shape[3]

        def compute(o0, o1, i):
            return F.max_pool2d(self.rows(t, s * o0 - p, s * (o1 - 1) - p + k, i), k, s, (0, p))

        return self._stencil(t, (t.n_rows + 2 * p - k) // s + 1, ref.shape[1], (w + 2 * p - k) // s + 1, ref.dtype,
                             compute)

    def resize_down(self, t: Rows, k: int, out_w: int) -> Rows:
        """``resize_bilinear_nchw`` to t.n_rows / k rows, an exact integer
        downscale: output rows [o0, o1) read input rows [k o0, k o1) alone."""
        ref = t.parts[0]

        def compute(o0, o1, i):
            return resize_bilinear_nchw(self.rows(t, k * o0, k * o1, i), o1 - o0, out_w)

        return self._stencil(t, t.n_rows // k, ref.shape[1], out_w, ref.dtype, compute)

    def resize_up(self, t: Rows, out_h: int, out_w: int) -> Rows:
        """``resize_bilinear_nchw`` (half-pixel centres, edge clamp) from
        t.n_rows rows up to out_h. Where out_h = f * t.n_rows, each slab
        resizes the input rows [a, b) its outputs read, with one more on
        either side where the frame has it, to f (b - a) rows: their source
        coordinates are the frame's less a, so the rows it keeps are the
        frame's (the clamp acts only at the frame's edges). Otherwise each
        slab resizes the whole gathered stage and keeps its rows."""
        ref = t.parts[0]
        n_in = t.n_rows
        f = out_h // n_in if out_h % n_in == 0 else None

        def compute(o0, o1, i):
            if f is None:
                return resize_bilinear_nchw(self.rows(t, 0, n_in, i), out_h, out_w)[:, :, o0:o1]
            a, b = max(0, o0 // f - 1), min(n_in, -(-o1 // f) + 1)
            y = resize_bilinear_nchw(self.rows(t, a, b, i), f * (b - a), out_w)
            return y[:, :, o0 - f * a : o1 - f * a]

        return self._stencil(t, out_h, ref.shape[1], out_w, ref.dtype, compute)

    # -- the modules

    def seq(self, name, t: Rows) -> Rows:
        """An nn.Sequential `name(net)`, module by module."""
        seqs = [name(net) for net in self.nets]
        for k, m in enumerate(seqs[0]):
            t = self.module(lambda net, k=k, name=name: name(net)[k], m, t)
        return t

    def module(self, name, m: nn.Module, t: Rows) -> Rows:
        """One module `name(net)` (m: the first copy's) on the slabs."""
        if isinstance(m, Conv):
            return self.conv(name, t)
        if isinstance(m, ConvTranspose):
            return self.conv_transpose(name, t)
        if isinstance(m, nn.MaxPool2d):
            return self.max_pool(t, m.kernel_size, m.stride, m.padding)
        if isinstance(m, EnhancedFAM):
            return self.fam(name, t)
        if isinstance(m, ResBlock):
            return self.res_block(name, t)
        if isinstance(m, PreActResBlock):
            return self.preact_block(name, t)
        if isinstance(m, ASPPModule):
            return self.aspp(name, t)
        if isinstance(m, UpBlock):
            return self.seq(lambda net: name(net).conv, self.conv_transpose(lambda net: name(net).up, t))
        if isinstance(m, nn.Sequential):
            return self.seq(name, t)
        if isinstance(m, _POINTWISE):  # BatchNorm and Dropout in eval mode
            return self.map(lambda i, p: name(self.nets[i])(p), t)
        raise TypeError(f"the spatial forward has no row rule for {type(m).__name__}")

    def fam(self, name, x: Rows) -> Rows:
        def sub(attr):
            return lambda net: getattr(name(net), attr)

        b1 = self.conv(sub("branch1"), x)
        b2 = self.conv(sub("branch2_conv"), self.max_pool(x, 3, 1, 1))
        b3 = self.conv(sub("branch3_conv2"), self.map(lambda i, p: F.relu(p), self.conv(sub("branch3_conv1"), x)))
        b4 = self.conv(sub("branch4_conv2"), self.map(lambda i, p: F.relu(p), self.conv(sub("branch4_conv1"), x)))
        cat = self.map(lambda i, *ps: torch.cat(ps, dim=1), b1, b2, b3, b4)
        out = self.map(lambda i, p: F.relu(p), self.conv(sub("fusion"), cat))
        # Channel attention on the frame's mean: the slabs' partial sums.
        mean = self.mean(out)
        ca = [name(net).channel_attention[1:](m) for net, m in zip(self.nets, mean)]
        out = self.map(lambda i, p: p * ca[i], out)
        sa = self.map(lambda i, p: torch.cat([bf16.mean(p, 1, keepdim=True), p.amax(dim=1, keepdim=True)], dim=1), out)
        att = self.seq(sub("spatial_attention"), sa)
        return self.map(lambda i, p, a: p * a, out, att)

    def res_block(self, name, x: Rows) -> Rows:
        def sub(attr):
            return lambda net: getattr(name(net), attr)

        y = self.map(lambda i, p: F.relu(name(self.nets[i]).bn1(p)), self.conv(sub("conv1"), x))
        y = self.map(lambda i, p: name(self.nets[i]).bn2(p), self.conv(sub("conv2"), y))
        sc = self.seq(sub("shortcut"), x) if len(name(self.nets[0]).shortcut) else x
        return self.map(lambda i, a, b: F.relu(a + b), y, sc)

    def preact_block(self, name, x: Rows) -> Rows:
        def sub(attr):
            return lambda net: getattr(name(net), attr)

        pre = self.map(lambda i, p: F.relu(name(self.nets[i]).bn1(p)), x)
        sc = self.seq(sub("shortcut"), pre) if name(self.nets[0]).needs_proj else x
        y = self.map(lambda i, p: F.relu(name(self.nets[i]).bn2(p)), self.conv(sub("conv1"), pre))
        return self.map(lambda i, a, b: a + b, self.conv(sub("conv2"), y), sc)

    def aspp(self, name, x: Rows) -> Rows:
        m0 = name(self.nets[0])
        feats = [self.seq(lambda net: name(net).conv1x1, x)]
        for k in range(len(m0.aspp_branches)):
            feats.append(self.seq(lambda net, k=k: name(net).aspp_branches[k], x))
        pooled = [name(net).global_pool[1:](m) for net, m in zip(self.nets, self.mean(x))]
        w = x.parts[0].shape[3]
        feats.append(self.map(lambda i, p: pooled[i].expand(-1, -1, p.shape[2], w), x))
        cat = self.map(lambda i, *ps: torch.cat(ps, dim=1), *feats)
        return self.seq(lambda net: name(net).fusion, cat)

    def ie_net(self, x: Rows) -> Rows:
        ie = lambda net: net.ie_net  # noqa: E731

        def sub(attr):
            return lambda net: getattr(ie(net), attr)

        def block(n, t):
            return self.module(n, n(self.nets[0]), t)

        x1 = self.map(lambda i, p: F.relu(p), self.conv(sub("input_layer"), x))
        x2 = block(sub("enc1"), x1)
        x3 = block(sub("enc2"), x2)
        y = block(sub("enc3"), x3)
        for k in range(len(self.nets[0].ie_net.bottleneck)):
            y = block(lambda net, k=k: ie(net).bottleneck[k], y)
        add = lambda i, a, b: a + b  # noqa: E731
        d3 = self.map(add, block(sub("dec3"), y), x3)
        d2 = self.map(add, block(sub("dec2"), d3), x2)
        d1 = self.map(add, block(sub("dec1"), d2), x1)
        residual = self.seq(sub("residual_head"), d1)
        return self.map(lambda i, p, r: bf16.sigmoid(p.mean(dim=1, keepdim=True) + r), x, residual)

    def forward(self, x: Rows) -> tuple[Rows, Rows, Rows]:
        eps = self.nets[0].epsilon
        illu = self.ie_net(x)
        reflectance = self.map(lambda i, p, il: p / (il + eps), x, illu)
        h, w = x.n_rows, x.parts[0].shape[3]
        x2 = self.resize_down(x, 2, int(w * 0.5))
        x3 = self.resize_down(x, 4, int(w * 0.25))
        f1 = self.seq(lambda net: net.scale1, x)
        f2 = self.resize_up(self.seq(lambda net: net.scale2, x2), h, w)
        f3 = self.resize_up(self.seq(lambda net: net.scale3, x3), h, w)

        def head(i, a, b, c):
            net = self.nets[i]
            return bf16.sigmoid(net.output_layer(net.fusion(torch.cat([a, b, c], dim=1))))

        e_map = self.map(head, f1, f2, f3)
        enhanced = self.map(lambda i, r, e: r * e + (1.0 - r) * (e * e), reflectance, e_map)
        return enhanced, reflectance, illu


def make_spatial_forward(model: MultiScaleUPRetinex, mesh: Mesh):
    """The standard forward of `model` (in eval mode, in its dtype) with
    the frame's height split over the mesh.

    Returns fn(slabs) -> (enhanced, reflectance, illumination), each a list
    of NHWC row slabs on the mesh's devices: the input's float NHWC slabs
    (``shard_rows``) in, the outputs left sharded (``gather_rows`` joins
    them). One copy of the weights lives on each distinct device. Raises
    ValueError unless H % (8 * mesh.size) == 0."""
    home = next(model.parameters()).device
    copies = {d: model if d == home else copy.deepcopy(model).to(d) for d in dict.fromkeys(mesh.devices)}
    net = _Net([copies[d].eval() for d in mesh.devices], mesh.devices)
    n = mesh.size

    def fn(slabs: list[torch.Tensor]):
        if len(slabs) != n:
            raise ValueError(f"{len(slabs)} slabs for a mesh of {n}")
        h = sum(s.shape[1] for s in slabs)
        if h % (8 * n) != 0:
            raise ValueError(f"spatial forward needs H divisible by 8*mesh ({8 * n}); got H={h}")
        bounds = split_rows(h, n)
        if [s.shape[1] for s in slabs] != [b - a for a, b in zip(bounds, bounds[1:])]:
            raise ValueError(f"the slabs must be the frame's {n} equal row slabs (shard_rows)")
        with torch.inference_mode():
            x = Rows([s.permute(0, 3, 1, 2) for s in slabs], bounds)
            outs = net.forward(x)
        return tuple([p.permute(0, 2, 3, 1) for p in o.parts] for o in outs)

    return fn
