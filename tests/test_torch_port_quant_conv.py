"""PyTorch port: the quantized convolutions against the JAX package, on the
CPU.

- ``w8a8_conv`` (the plain version ``w8a8_conv_torch`` on CPU tensors)
  against the JAX package's ``w8a8_conv`` BITWISE: ResNet-50's 11 spatial
  path geometries at small H / W and ragged cases (B = 1, odd sizes,
  cin = 3, cout off the 64-channel tile, dilation 2, groups 2, explicit
  symmetric pads, codes all -128 / 127); a float64 convolution of int8
  codes is exact below 2**53 and is rounded to f32 once, as the int32 ->
  f32 conversion of the JAX package's s32 sum is;
- ``w4a16_conv`` against the JAX package's at f32 tolerance (the same
  dequantized weights, convolved in another summation order);
- ``_is_pointwise`` routing, as the JAX package's
  ``tests/test_quantized_predict.py`` checks it (:100, :120): a 1x1 /
  stride-1 conv is the ``w8a8`` matmul, explicit padding keeps it on the
  conv path;
- a numpy model of the ``w8a8_conv2d`` kernel (``csrc/quant_conv.cu``,
  constants read from the source): which (image, input row, input column,
  channel) every byte of a staged A tile reads, in its three loaders
  (16-byte pieces, runs from staged input rows, byte gathers), and the B
  tile read from the K-major pack, against ``F.unfold``'s im2col; the
  entry point's route and staged-rows rule; then the whole product
  replayed through the PTX m16n8k32 fragment layouts, the split of K and
  the merge of its partials, and the epilogue's mapping, bitwise against
  the plain version, so the kernel's index maths is checked before the
  card.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.nn.layers.conv import conv_pads
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DN = jax.lax.conv_dimension_numbers((1,) * 4, (1,) * 4,
                                    ("NHWC", "HWIO", "NHWC"))


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy the tolerances assume."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


# (x shape, (kh, kw, cin/g, cout), stride, padding, dilation, groups):
# ResNet-50's 11 spatial shapes at 224 x 224 (chip_smoke.conv_inventory)
# with H / W cut to 9-17 and the batch to 2, then ragged cases; padding is
# "same" (each side's own SAME pads) or explicit per-axis (lo, hi)
PATH = (
    ((2, 16, 16, 3), (7, 7, 3, 64), 2, "same", 1, 1),
    ((2, 9, 9, 64), (3, 3, 64, 64), 1, "same", 1, 1),
    ((2, 10, 10, 128), (3, 3, 128, 128), 2, "same", 1, 1),
    ((2, 10, 10, 256), (1, 1, 256, 512), 2, "same", 1, 1),
    ((2, 9, 9, 128), (3, 3, 128, 128), 1, "same", 1, 1),
    ((2, 10, 10, 256), (3, 3, 256, 256), 2, "same", 1, 1),
    ((2, 10, 10, 512), (1, 1, 512, 1024), 2, "same", 1, 1),
    ((2, 7, 7, 256), (3, 3, 256, 256), 1, "same", 1, 1),
    ((2, 8, 8, 512), (3, 3, 512, 512), 2, "same", 1, 1),
    ((2, 8, 8, 1024), (1, 1, 1024, 2048), 2, "same", 1, 1),
    ((2, 5, 5, 512), (3, 3, 512, 512), 1, "same", 1, 1),
)
RAGGED = (
    ((1, 13, 11, 3), (7, 7, 3, 70), 2, "same", 1, 1),
    ((2, 9, 7, 16), (3, 3, 16, 61), 1, [(1, 1), (1, 1)], 1, 1),
    ((2, 11, 13, 32), (3, 3, 32, 64), 1, "same", 2, 1),
    ((2, 8, 8, 64), (3, 3, 32, 128), 2, "same", 1, 2),
    ((2, 7, 7, 16), (3, 3, 8, 24), 1, [(2, 2), (2, 2)], 1, 2),
    ((3, 7, 9, 24), (5, 3, 24, 40), (2, 1), "same", 1, 1),
    ((2, 9, 9, 32), (1, 1, 32, 96), 2, "valid", 1, 1),
)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(geom):
    xshape, kshape, stride, padding, dil, _ = geom
    if isinstance(padding, str):
        return conv_pads(padding, xshape[1:3], kshape[:2], _pair(stride),
                         _pair(dil))
    return [tuple(p) for p in padding]


def _jax_padding(padding):
    return padding.upper() if isinstance(padding, str) else padding


def _codes(g, shape, extremes):
    if extremes:
        return g.choice(np.array([-128, 127], np.int8), shape)
    return g.integers(-128, 128, shape, dtype=np.int8)


def _case(seed, geom, extremes=False):
    g = np.random.default_rng(seed)
    x = _codes(g, geom[0], extremes)
    w = _codes(g, geom[1], extremes)
    scale = g.uniform(1e-4, 1e-2, geom[1][-1]).astype(np.float32)
    return x, w, scale


def _jax_w8a8(x, w, scale, geom):
    _, _, stride, padding, dil, groups = geom
    return np.asarray(jqm.w8a8_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        window_strides=_pair(stride), padding=_jax_padding(padding),
        rhs_dilation=_pair(dil), dimension_numbers=DN,
        feature_group_count=groups, impl="xla"))


@pytest.mark.parametrize("extremes", [False, True])
@pytest.mark.parametrize("index", range(len(PATH + RAGGED)),
                         ids=[f"path{i}" for i in range(len(PATH))]
                         + [f"ragged{i}" for i in range(len(RAGGED))])
def test_w8a8_conv_plain_bitwise_vs_jax(index, extremes):
    geom = (PATH + RAGGED)[index]
    x, w, scale = _case(100 + index, geom, extremes)
    want = _jax_w8a8(x, w, scale, geom)
    _, _, stride, _, dil, groups = geom
    got = tqm.w8a8_conv(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(scale),
                        window_strides=_pair(stride), padding=_pads(geom),
                        rhs_dilation=_pair(dil), feature_group_count=groups)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("geom", [PATH[0], PATH[3], PATH[7], RAGGED[2],
                                  RAGGED[3],
                                  ((2, 6, 6, 40), (1, 1, 40, 24), 1,
                                   "same", 1, 1)])
@pytest.mark.parametrize("group_size", [64, 10])
def test_w4a16_conv_vs_jax(geom, group_size):
    """f32 products of the same dequantized weights in another order
    (oneDNN vs XLA; the pointwise case through the w4a16 matmul's plain
    version): atol 1e-5, rtol 1e-5 on unit-scale activations."""
    g = np.random.default_rng(7)
    xshape, kshape, stride, padding, dil, groups = geom
    x = g.standard_normal(xshape).astype(np.float32)
    wf = (g.standard_normal(kshape) * 0.1).astype(np.float32)
    from analytics_zoo_tpu_torch.inference.quantize import _quantize_w4
    leaves = _quantize_w4(wf, group_size)
    want = np.asarray(jqm.w4a16_conv(
        jnp.asarray(x), jnp.asarray(leaves["W_q4"]),
        jnp.asarray(leaves["s_g"]), kshape, window_strides=_pair(stride),
        padding=_jax_padding(padding), rhs_dilation=_pair(dil),
        dimension_numbers=DN, feature_group_count=groups, impl="xla"))
    got = tqm.w4a16_conv(torch.from_numpy(x),
                         torch.from_numpy(leaves["W_q4"]),
                         torch.from_numpy(leaves["s_g"]), kshape,
                         window_strides=_pair(stride), padding=_pads(geom),
                         rhs_dilation=_pair(dil), feature_group_count=groups)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kshape,strides,dil,groups,padding,want", [
    ((1, 1, 8, 4), (1, 1), (1, 1), 1, "SAME", True),
    ((1, 1, 8, 4), (1, 1), (1, 1), 1, "VALID", True),
    ((1, 1, 8, 4), (1, 1), (1, 1), 1, [(0, 0), (0, 0)], True),
    ((1, 1, 8, 4), (1, 1), (1, 1), 1, [(1, 1), (1, 1)], False),
    ((1, 1, 8, 4), (2, 2), (1, 1), 1, "SAME", False),
    ((1, 1, 8, 4), (1, 1), (2, 2), 1, "SAME", False),
    ((1, 1, 4, 4), (1, 1), (1, 1), 2, "SAME", False),
    ((3, 3, 8, 4), (1, 1), (1, 1), 1, "SAME", False),
])
def test_is_pointwise_matches_jax(kshape, strides, dil, groups, padding,
                                  want):
    assert tqm._is_pointwise(kshape, strides, dil, groups, padding) is want
    assert jqm._is_pointwise(kshape, strides, dil, groups, padding) is want


def test_w8a8_pointwise_conv_routes_through_matmul(monkeypatch):
    """A 1x1 / stride-1 conv is a channel matmul: it reaches
    ``w8a8_matmul`` with the (B·H·W, cin) view, and equals the general
    conv bitwise; explicit padding keeps a 1x1 conv on the conv path
    (it grows the output), as in the JAX package."""
    g = np.random.default_rng(3)
    b, h, w, cin, cout = 2, 4, 4, 24, 10
    x = torch.from_numpy(g.integers(-127, 128, (b, h, w, cin),
                                    dtype=np.int8))
    wq = torch.from_numpy(g.integers(-127, 128, (1, 1, cin, cout),
                                     dtype=np.int8))
    scale = torch.from_numpy((g.random(cout).astype(np.float32) + 0.1)
                             * 0.01)
    seen = []
    matmul = tqm.w8a8_matmul

    def spy(x2, w2, s, impl=None):
        seen.append((tuple(x2.shape), tuple(w2.shape)))
        return matmul(x2, w2, s, impl=impl)

    monkeypatch.setattr(tqm, "w8a8_matmul", spy)
    kw = dict(window_strides=(1, 1), rhs_dilation=(1, 1))
    routed = tqm.w8a8_conv(x, wq, scale, padding=[(0, 0), (0, 0)], **kw)
    assert seen == [((b * h * w, cin), (cin, cout))]
    general = tqm.w8a8_conv_torch(x, wq, scale, (1, 1), [(0, 0), (0, 0)])
    assert torch.equal(routed, general)
    padded = tqm.w8a8_conv(x, wq, scale, padding=[(1, 1), (1, 1)], **kw)
    assert len(seen) == 1
    assert padded.shape == (b, h + 2, w + 2, cout)
    want = _jax_w8a8(x.numpy(), wq.numpy(), scale.numpy(),
                     ((b, h, w, cin), (1, 1, cin, cout), 1,
                      [(1, 1), (1, 1)], 1, 1))
    np.testing.assert_array_equal(padded.numpy(), want)


@pytest.mark.parametrize("bad,match", [
    (dict(x=(2, 5, 5, 6), w=(3, 3, 4, 8)), "groups"),
    (dict(x=(2, 5, 5, 8), w=(3, 3, 8, 6), groups=4), "groups"),
    (dict(x=(2, 2, 2, 8), w=(5, 5, 8, 4), pads=[(0, 0), (0, 0)]),
     "no output"),
    (dict(pads=[(-1, 0), (0, 0)]), "non-negative"),
    (dict(strides=(0, 1)), "positive"),
    (dict(scale=3), r"\(cout,\)"),
    (dict(x=(2, 5, 5)), "NHWC"),
])
def test_w8a8_conv2d_argument_checks(bad, match):
    x = torch.zeros(bad.get("x", (2, 5, 5, 8)), dtype=torch.int8)
    w = torch.zeros(bad.get("w", (3, 3, 8, 4)), dtype=torch.int8)
    s = torch.ones(bad.get("scale", w.shape[-1]))
    with pytest.raises(ValueError, match=match):
        tqm.w8a8_conv2d(x, w, s, strides=bad.get("strides", (1, 1)),
                        pads=bad.get("pads", [(1, 1), (1, 1)]),
                        groups=bad.get("groups", 1))


def test_w8a8_conv2d_cuda_route_needs_a_card():
    """``impl="cuda"`` on CPU tensors raises; ``auto`` on CPU tensors is
    the plain version, and nothing is built at import."""
    x = torch.zeros(1, 4, 4, 3, dtype=torch.int8)
    w = torch.zeros(3, 3, 3, 2, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.w8a8_conv2d(x, w, torch.ones(2), strides=(1, 1),
                        pads=[(1, 1), (1, 1)], impl="cuda")
    assert tqm._conv_fn is None
    assert (_build.CSRC / f"{tqm.KERNEL_CONV}.cu").exists()


# -- a numpy model of the w8a8_conv2d kernel -------------------------------------

def _constants():
    """The kernel's ``constexpr int kCv*`` values, from the source."""
    src = (_build.CSRC / f"{tqm.KERNEL_CONV}.cu").read_text()
    out = {}
    for name, expr in re.findall(r"constexpr int (kCv\w+) = ([^;]+);", src):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


C = _constants()
BM, BK, THREADS = C["kCvBM"], C["kCvBK"], C["kCvThreads"]
BNS = (C["kCvBNSmall"], C["kCvBNLarge"])
MAX_SPLIT, OUT_PAD, HALO_CAP = C["kCvMaxSplit"], C["kCvOutPad"], \
    C["kCvHaloCap"]
TID = np.arange(THREADS)
LANE = np.arange(32)
GQ, TQ = LANE >> 2, LANE & 3


def test_kernel_constants_match_the_wrapper():
    """The wrapper's rule and pack use the kernel's tiles; the staged rows'
    cap is the kernel's alone."""
    assert (tqm.CONV_BM, tqm.CONV_BK, tqm.CONV_BNS, tqm.CONV_SPLITS[-1]) \
        == (BM, BK, BNS, MAX_SPLIT)
    assert HALO_CAP == 65536
    assert C["kCvStages"] >= 3 and THREADS == 256


def swz(row, chunk):
    """Byte offset of 16-byte chunk ``chunk`` of ``row`` in a staged tile
    (rows of BK bytes, chunks XOR-swizzled by (row >> 1) & 3)."""
    return row * BK + ((chunk ^ ((row >> 1) & 3)) << 4)


def unswizzle(tile, rows):
    """(rows, BK) logical bytes of a staged tile."""
    r = np.arange(rows)[:, None]
    c = np.arange(BK)[None, :]
    return tile[swz(r, c >> 4) + (c & 15)]


class Geom:
    """The kernel's ConvGeom for an NHWC conv with explicit pads."""

    def __init__(self, xshape, kshape, strides, pads, dil, groups):
        self.B, self.H, self.W, self.C = xshape
        self.KH, self.KW, self.CG, self.COUT = kshape
        self.G = groups
        self.NG = self.COUT // groups
        self.SH, self.SW = strides
        self.DH, self.DW = dil
        (self.PT, self.PB), (self.PL, self.PR) = pads
        self.HO = (self.H + sum(pads[0]) - (self.KH - 1) * self.DH - 1) \
            // self.SH + 1
        self.WO = (self.W + sum(pads[1]) - (self.KW - 1) * self.DW - 1) \
            // self.SW + 1
        self.M = self.B * self.HO * self.WO
        self.K = self.KH * self.KW * self.CG
        self.Kp = -(-self.K // BK) * BK
        self.avec = self.CG % 16 == 0 and self.C % 16 == 0
        # the RUN route (the entry point's plan): a kernel row's KW·C
        # bytes contiguous in x, the rows a tile stages within the cap
        self.run = self.DW == 1 and groups == 1 and \
            16 <= self.KW * self.C <= 32 and self.KH <= 32
        rows = halo_rows_of(self) if self.run else 0
        self.halo_rows = rows if rows * self.W * self.C + 16 <= HALO_CAP \
            else 0


def halo_rows_of(g):
    """The entry point's ``halo_rows_of``: the most rows of the (B·H, W·C)
    view a tile's windows cover, over the last tile start on a multiple
    of gcd(BM, HO·WO) in each output row of an image."""
    hw = g.HO * g.WO
    step = math.gcd(BM, hw)
    most = 0
    for ho in range(g.HO):
        first = ((ho + 1) * g.WO - 1) // step * step
        if first < ho * g.WO:
            continue
        last = min(first + BM - 1, g.M - 1)
        lo = min(max(ho * g.SH - g.PT, 0), g.H)
        hi = last // hw * g.H + min(max((last % hw) // g.WO * g.SH - g.PT
                                        + (g.KH - 1) * g.DH, -1), g.H - 1)
        most = max(most, hi - lo + 1)
    return most


def _pixel(g, m, grp):
    """``pixel()``: (ok, image, ih0, iw0, channel offset) of output
    pixels ``m``."""
    ok = m < g.M
    mm = np.where(ok, m, 0)
    img, rem = mm // (g.HO * g.WO), mm % (g.HO * g.WO)
    return ok, img, (rem // g.WO) * g.SH - g.PT, \
        (rem % g.WO) * g.SW - g.PL, grp * g.CG


def _tap(g, k):
    c = k % g.CG
    tap = k // g.CG
    return c, tap % g.KW, tap // g.KW


def tile_rows(g, m0):
    """(gi_lo, rows) of the tile at ``m0``: the kernel's clamped first
    and last rows of the (B·H, W·C) view its windows cover."""
    hw = g.HO * g.WO
    first, last = m0, min(m0 + BM, g.M) - 1
    lo = first // hw * g.H + min(max((first % hw) // g.WO * g.SH - g.PT, 0),
                                 g.H)
    hi = last // hw * g.H + min(max((last % hw) // g.WO * g.SH - g.PT
                                    + (g.KH - 1) * g.DH, -1), g.H - 1)
    return lo, hi - lo + 1


def halo_span(g, m0):
    """(gi_lo, rows) the tile at ``m0`` stages: at most ``halo_rows``."""
    lo, rows = tile_rows(g, m0)
    return lo, min(rows, g.halo_rows)


def stage_halo(g, x, m0, x_off):
    """The halo as the kernel copies it: byte a of x at index a minus the
    16-byte-aligned address of the first staged row (x ``x_off`` bytes
    into an aligned buffer)."""
    lo, rows = halo_span(g, m0)
    wc = g.W * g.C
    mis = (x_off + lo * wc) % 16
    halo = np.zeros(max(rows, 0) * wc + 32, np.int8)
    if rows > 0:
        halo[mis:mis + rows * wc] = x.reshape(-1)[lo * wc:(lo + rows) * wc]
    return halo, lo, rows, mis


def stage_run(g, x, m0, k0, x_off=0, junk=0):
    """The A stage as ``build16_run`` builds it (one warp a chunk, a lane
    a pixel): each pixel's 16 bytes of k are at most two runs of KW·C
    contiguous halo bytes, loaded as 16 bytes each (``load16u``: past the
    staged bytes the load reads whatever lies there, here ``junk``) and
    kept by the masks of the pixel's kernel rows and columns and k < K."""
    halo, lo, rows, mis = stage_halo(g, x, m0, x_off)
    guard = 48
    g8 = np.random.default_rng(junk).integers(-128, 128, guard, np.int8)
    mem = np.concatenate([g8, halo, g8])
    tile = np.zeros(BM * BK, np.int8)
    ca, ra = (TID >> 5) & 3, 32 * (TID >> 7) + (TID & 31)
    rlen, wc = g.KW * g.C, g.W * g.C
    for t in range(THREADS):
        k = k0 + 16 * int(ca[t])
        kh0, j0 = k // rlen, k % rlen
        n1 = min(16, rlen - j0)
        for h in (0, 1):
            prow = int(ra[t]) + 64 * h
            ok, img, ih0, iw0, _ = (int(np.asarray(v).reshape(-1)[0])
                                    for v in _pixel(g, np.array([m0 + prow]),
                                                    0))
            hrow = img * g.H - lo
            rowbits = sum(1 << kh for kh in range(g.KH)
                          if ok and 0 <= ih0 + kh * g.DH < g.H
                          and 0 <= hrow + ih0 + kh * g.DH < rows)
            cols = [kw for kw in range(g.KW) if 0 <= iw0 + kw < g.W]
            run = ((1 << (g.C * (cols[-1] + 1))) - (1 << (g.C * cols[0]))
                   if cols else 0)
            base = (hrow + ih0) * wc + iw0 * g.C + mis + guard
            m = 0
            if k < g.K:
                if rowbits >> kh0 & 1:
                    m |= (run >> j0) & ((1 << n1) - 1)
                if rowbits >> (kh0 + 1) & 1:
                    m |= (run << n1) & 0xFFFF & ~((1 << n1) - 1)
                m &= (1 << min(16, g.K - k)) - 1
            a1 = base + kh0 * g.DH * wc + j0
            a2 = base + (kh0 + 1) * g.DH * wc - n1
            p1 = mem[a1:a1 + 16] if m & ((1 << n1) - 1) else np.zeros(16)
            p2 = mem[a2:a2 + 16] if m >> n1 else np.zeros(16)
            for e in range(16):
                if m >> e & 1:
                    tile[swz(prow, int(ca[t])) + e] = \
                        p1[e] if e < n1 else p2[e]
    return tile


def stage_a(g, x, m0, grp, k0, mode):
    """The A stage (BM x BK bytes, swizzled) as the loaders that read x
    write it: thread t takes chunk t & 3 of pixels t >> 2 and (t >> 2) +
    64.  ``avec``: one 16-byte copy from the chunk's first tap;
    ``bytes``: each byte gathered by its own (kh, kw, c)."""
    tile = np.zeros(BM * BK, np.int8)
    ca, ra = TID & 3, TID >> 2
    for h in (0, 1):
        prow = ra + 64 * h
        ok, img, ih0, iw0, coff = _pixel(g, m0 + prow, grp)
        for e in range(16):
            k = k0 + 16 * ca + (0 if mode == "avec" else e)
            c, kw, kh = _tap(g, k)
            c = c + (e if mode == "avec" else 0)
            ih, iw = ih0 + kh * g.DH, iw0 + kw * g.DW
            inb = ok & (k0 + 16 * ca + e < g.K) & (ih >= 0) & (ih < g.H) \
                & (iw >= 0) & (iw < g.W)
            val = np.where(inb, x[np.where(inb, img, 0),
                                  np.clip(ih, 0, g.H - 1),
                                  np.clip(iw, 0, g.W - 1),
                                  np.clip(coff + c, 0, g.C - 1)], 0)
            tile[swz(prow, ca) + e] = val
    return tile


def stage_b(g, pack, n0, grp, k0, bn):
    """The B stage (bn rows of BK bytes, swizzled): 16-byte copies of the
    pack's rows, piece q = t + THREADS·h is row q >> 2, chunk q & 3."""
    tile = np.zeros(bn * BK, np.int8)
    for h in range(bn * 4 // THREADS):
        q = TID + THREADS * h
        nb, cb = q >> 2, q & 3
        inb = n0 + nb < g.NG
        rows = pack[grp, np.clip(n0 + nb, 0, g.NG - 1)]
        for e in range(16):
            tile[swz(nb, cb) + e] = np.where(
                inb, rows[TID, k0 + 16 * cb + e], 0)
    return tile


def a_mode(g, x_off=0):
    """The entry point's route: copies where x's pieces lie on 16 bytes,
    runs from staged rows where they fit, else byte gathers."""
    if g.avec and x_off % 16 == 0:
        return "avec"
    return "run" if g.halo_rows > 0 else "bytes"


def stage(g, x, m0, grp, k0, mode, x_off=0):
    if mode == "run":
        return stage_run(g, x, m0, k0, x_off)
    return stage_a(g, x, m0, grp, k0, mode)


def _im2col(x, g, grp):
    """(M, K) rows of the conv's A operand in (kh, kw, c) order, from
    ``F.unfold`` of the padded NCHW input: the reference for the
    gather."""
    xp = np.pad(x[..., grp * g.CG:(grp + 1) * g.CG],
                ((0, 0), (g.PT, g.PB), (g.PL, g.PR), (0, 0)))
    t = torch.from_numpy(xp.astype(np.float32)).permute(0, 3, 1, 2)
    cols = F.unfold(t, (g.KH, g.KW), dilation=(g.DH, g.DW),
                    stride=(g.SH, g.SW))         # (B, CG·KH·KW, HO·WO)
    cols = cols.reshape(g.B, g.CG, g.KH, g.KW, -1).permute(0, 4, 2, 3, 1)
    return cols.reshape(g.M, g.K).numpy().astype(np.int8)


def _word(b4):
    """Little-endian words of (..., 4) int8 bytes."""
    u = b4.astype(np.uint8).astype(np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def _s8(word, j):
    return ((word >> (8 * j)) & 0xFF).astype(np.int64) - \
        (((word >> (8 * j + 7)) & 1) << 8).astype(np.int64)


def _mma(acc, a, b):
    """m16n8k32 s8 x s8 + s32 by the PTX ISA's fragment layouts: A reg r
    byte j of lane (g, t) is A[g + 8 (r & 1), 4t + j + 16 (r >> 1)]; B reg
    r byte j is B[4t + j + 16 r, g]; C element e is C[g + 8 (e >> 1),
    2t + (e & 1)]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    Cm = np.zeros((16, 8), np.int64)
    for j in range(4):
        for r in range(4):
            A[GQ + 8 * (r & 1), 4 * TQ + j + 16 * (r >> 1)] = _s8(a[r], j)
        for r in range(2):
            B[4 * TQ + j + 16 * r, GQ] = _s8(b[r], j)
    for e in range(4):
        Cm[GQ + 8 * (e >> 1), 2 * TQ + (e & 1)] = acc[e]
    D = Cm + A @ B
    return [D[GQ + 8 * (e >> 1), 2 * TQ + (e & 1)] for e in range(4)]


def ldsm4(tile, row, chunk):
    """ldmatrix.x4 (b16): lane l addresses row l & 7 of matrix l >> 3 (16
    bytes at ``swz(row, chunk)``); lane (g, t) receives word t of row g
    of each matrix."""
    words = _word(tile[swz(row, chunk)[:, None] + np.arange(16)]
                  .reshape(32, 4, 4))
    return [words[8 * q + GQ, TQ] for q in range(4)]


def block_partial(g, x, pack, m0, n0, grp, kts, bn, mode, x_off=0):
    """One block's staged s32 tile (BM x (bn + OUT_PAD)) after its
    k-tiles ``kts``: fragments by ldmatrix from the swizzled stages, s8
    mmas, accumulators stored as the epilogue stages them."""
    ni = bn // 16
    acc = {(w_, i, j): [np.zeros(32, np.int64)] * 4
           for w_ in range(8) for i in range(2) for j in range(ni)}
    for kt in kts:
        sa = stage(g, x, m0, grp, kt * BK, mode, x_off)
        sb = stage_b(g, pack, n0, grp, kt * BK, bn)
        for w_ in range(8):
            wm, wn = w_ & 3, w_ >> 2
            for s in range(BK // 32):
                af = [ldsm4(sa, 32 * wm + 16 * i + (LANE & 7)
                            + 8 * ((LANE >> 3) & 1), 2 * s + (LANE >> 4))
                      for i in range(2)]
                bf = []
                for j in range(ni // 2):
                    r = ldsm4(sb, bn // 2 * wn + 16 * j + (LANE & 7)
                              + 8 * (LANE >> 4), 2 * s + ((LANE >> 3) & 1))
                    bf += [r[0:2], r[2:4]]
                for i in range(2):
                    for j in range(ni):
                        acc[w_, i, j] = _mma(acc[w_, i, j], af[i], bf[j])
    st = np.zeros((BM, bn + OUT_PAD), np.int64)
    for (w_, i, j), a in acc.items():
        wm, wn = w_ & 3, w_ >> 2
        for e in range(4):
            st[32 * wm + 16 * i + GQ + 8 * (e >> 1),
               bn // 2 * wn + 8 * j + 2 * TQ + (e & 1)] = a[e]
    return st


def replay(x, w, scale, g, bn=None, split=None, x_off=0, drop=None):
    """The kernel's output: every cluster's blocks (one K slice each),
    their partials merged as the epilogue does (block r sums rows
    [r·BM/split, (r+1)·BM/split) over the cluster, in s32, reading the
    others' staged tiles from distributed shared memory) and written
    with the scale.  ``bn`` / ``split`` as forced through the wrapper
    (default: ``conv_config``'s rule on 132 SMs); ``drop``: a rank whose
    partial the merge leaves out (a planted fault)."""
    bn, split = tqm.conv_config(g.M, g.NG, g.K, g.G, 132, bn, split)
    pack = tqm.pack_conv_weight(torch.from_numpy(w), g.G).numpy()
    mode = a_mode(g, x_off)
    kt_all = g.Kp // BK
    per = -(-kt_all // split)
    out = np.full((g.M, g.COUT), np.nan, np.float32)
    for grp in range(g.G):
        for m0 in range(0, g.M, BM):
            for n0 in range(0, g.NG, bn):
                parts = []
                for rank in range(split):
                    kt0 = min(kt_all, rank * per)
                    kts = range(kt0, min(kt_all, kt0 + per))
                    parts.append(block_partial(g, x, pack, m0, n0, grp,
                                               kts, bn, mode, x_off))
                rows = BM // split
                for rank in range(split):
                    r = np.arange(rank * rows, (rank + 1) * rows)
                    tot = sum(parts[(rank + q) % split][r]
                              for q in range(split)
                              if (rank + q) % split != drop)
                    tot = ((tot + 2 ** 31) % 2 ** 32 - 2 ** 31)[:, :bn]
                    m = m0 + r[:, None]
                    n = n0 + np.arange(bn)[None, :]
                    keep = (m < g.M) & (n < g.NG)
                    mm, nn = np.broadcast_arrays(m, n)
                    col = grp * g.NG + nn[keep]
                    out[mm[keep], col] = tot[keep].astype(np.int32) \
                        .astype(np.float32) * scale[col]
    return out.reshape(g.B, g.HO, g.WO, g.COUT)


# geometries for the model: the stem (cin = 3: the runs, K = 147 past two
# stages), a strided 3x3 with SAME's (0, 1) pads, dilation 2 with a ragged
# M and cout off the tile, groups 2 (16-byte pieces), a strided 1x1
MODEL_GEOMS = (
    ((1, 11, 9, 3), (7, 7, 3, 20), (2, 2), [(2, 3), (3, 3)], (1, 1), 1),
    ((1, 8, 8, 32), (3, 3, 32, 72), (2, 2), [(0, 1), (0, 1)], (1, 1), 1),
    ((2, 7, 5, 16), (3, 3, 16, 13), (1, 1), [(2, 2), (2, 2)], (2, 2), 1),
    ((1, 6, 6, 64), (3, 3, 32, 40), (1, 1), [(1, 1), (1, 1)], (1, 1), 2),
    ((2, 9, 9, 48), (1, 1, 48, 64), (2, 2), [(0, 0), (0, 0)], (1, 1), 1),
)


@pytest.mark.parametrize("geom", MODEL_GEOMS)
def test_kernel_tile_gather_matches_unfold(geom):
    """Every staged A stage (each loader the shape can take: byte
    gathers, 16-byte copies, runs from the staged rows on an aligned and
    a misaligned x), unswizzled, is the im2col block of ``F.unfold``:
    zero for padding, past M and past K; every staged B stage,
    unswizzled, is the weight block transposed, read from the pack."""
    g = Geom(*geom)
    x, w, _ = _case(5, (geom[0], geom[1], 1, "same", 1, 1))
    pack = tqm.pack_conv_weight(torch.from_numpy(w), g.G).numpy()
    modes = [("bytes", 0)] + ([("avec", 0)] if g.avec else []) + \
        ([("run", 0), ("run", 7)] if g.run else [])
    assert g.halo_rows > 0 or not g.run
    for grp in range(g.G):
        cols = _im2col(x, g, grp)
        w2 = w.reshape(g.K, g.COUT)[:, grp * g.NG:(grp + 1) * g.NG]
        for m0 in range(0, g.M, BM):
            for k0 in range(0, g.Kp, BK):
                want = np.zeros((BM, BK), np.int8)
                blk = cols[m0:m0 + BM, k0:k0 + BK]
                want[:blk.shape[0], :blk.shape[1]] = blk
                for mode, off in modes:
                    got = stage(g, x, m0, grp, k0, mode, off)
                    np.testing.assert_array_equal(unswizzle(got, BM), want)
        for bn in BNS:
            for n0 in range(0, g.NG, bn):
                for k0 in range(0, g.Kp, BK):
                    want = np.zeros((bn, BK), np.int8)
                    blk = w2[k0:k0 + BK, n0:n0 + bn].T
                    want[:blk.shape[0], :blk.shape[1]] = blk
                    np.testing.assert_array_equal(
                        unswizzle(stage_b(g, pack, n0, grp, k0, bn), bn),
                        want)


@pytest.mark.parametrize("geom", MODEL_GEOMS[:4])
def test_kernel_replay_bitwise_vs_plain(geom):
    """The whole kernel replayed at the rule's config (stages, ldmatrix
    fragments, mmas through the PTX layouts, the staged s32 tile, the
    epilogue) equals the plain version bitwise."""
    g = Geom(*geom)
    x, w, scale = _case(6, (geom[0], geom[1], 1, "same", 1, 1))
    got = replay(x, w, scale, g)
    want = tqm.w8a8_conv_torch(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(scale), geom[2], geom[3],
                               geom[4], geom[5]).numpy()
    np.testing.assert_array_equal(got, want)


# K = 576 (9 k-tiles, so split 8 leaves three slices empty), cout 72 (off
# both tiles), M = 2 · 6 · 6 = 72 (a ragged tile)
SPLIT_GEOM = ((2, 6, 6, 64), (3, 3, 64, 72), (1, 1), [(1, 1), (1, 1)],
              (1, 1), 1)


@pytest.mark.parametrize("split", tqm.CONV_SPLITS)
@pytest.mark.parametrize("bn", BNS)
def test_kernel_replay_forced_split_bitwise_vs_plain(bn, split):
    """Every tile config and split, forced as the wrapper forces them:
    each block's K slice, the partials merged across the cluster row by
    row, bitwise the plain version."""
    g = Geom(*SPLIT_GEOM)
    x, w, scale = _case(8, (SPLIT_GEOM[0], SPLIT_GEOM[1], 1, "same", 1, 1))
    got = replay(x, w, scale, g, bn, split)
    want = tqm.w8a8_conv_torch(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(scale), *SPLIT_GEOM[2:]
                               ).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_model_rejects_a_shifted_pad():
    """The model is sharp: a tile gathered with the top pad one more
    (the planted fault of chip_smoke's image phase) is not im2col's."""
    geom = MODEL_GEOMS[1]
    g = Geom(*geom)
    x, _, _ = _case(5, (geom[0], geom[1], 1, "same", 1, 1))
    want = _im2col(x, g, 0)[:BM, :BK]
    g.PT += 1
    got = unswizzle(stage(g, x, 0, 0, 0, a_mode(g)), BM)
    assert not np.array_equal(got[:want.shape[0]], want)


def test_kernel_model_rejects_a_dropped_slice():
    """A merge that leaves out one block's K slice (the planted fault of
    chip_smoke's image phase) is not the plain version."""
    g = Geom(*SPLIT_GEOM)
    x, w, scale = _case(8, (SPLIT_GEOM[0], SPLIT_GEOM[1], 1, "same", 1, 1))
    want = tqm.w8a8_conv_torch(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(scale), *SPLIT_GEOM[2:]
                               ).numpy()
    got = replay(x, w, scale, g, 64, 4, drop=1)
    assert not np.array_equal(got, want)


# -- the pack, the tile and split rule, the halo rule ---------------------------

@pytest.mark.parametrize("geom", MODEL_GEOMS + (SPLIT_GEOM,))
def test_conv_pack_matches_jax_layout_w_q(geom):
    """The K-major pack of the JAX quantizer's ``W_q`` (kh, kw, cin/g,
    cout): pack[grp, n, k] = W_q as (K, cout) at [k, grp·cout/g + n],
    zero from K to Kp; the port's quantizer gives the same codes."""
    from analytics_zoo_tpu.inference import quantize as jquant
    from analytics_zoo_tpu_torch.inference import quantize as tquant
    g = Geom(*geom)
    wf = np.random.default_rng(11).standard_normal(geom[1]).astype(
        np.float32)
    wq = np.array(jquant._quantize_w8(wf, 1.0)["W_q"])
    np.testing.assert_array_equal(tquant._quantize_w8(wf, 1.0)["W_q"], wq)
    pack = tqm.pack_conv_weight(torch.from_numpy(wq), g.G)
    assert pack.dtype == torch.int8
    assert tuple(pack.shape) == (g.G, g.NG, g.Kp) and g.Kp % BK == 0
    w2 = wq.reshape(g.K, g.COUT)
    for grp in range(g.G):
        np.testing.assert_array_equal(
            pack[grp, :, :g.K].numpy(),
            w2[:, grp * g.NG:(grp + 1) * g.NG].T)
    assert not pack[:, :, g.K:].any()


def _resnet50_spatial(batch):
    """ResNet-50's 11 distinct spatial convs at 224 x 224: (M, N, K)."""
    shapes = [(112, 64, 147)]                     # the stem 7x7/2
    for side, cin, stride in ((56, 64, 1), (28, 128, 2), (28, 128, 1),
                              (14, 256, 2), (14, 256, 1), (7, 512, 2),
                              (7, 512, 1)):
        shapes.append((side * side, cin, 9 * cin))    # 3x3
        if stride == 2:                               # the projection 1x1/2
            shapes.append((side * side, 4 * cin, 2 * cin))
    assert len(shapes) == 11
    return [(batch * hw, n, k) for hw, n, k in shapes]


@pytest.mark.parametrize("batch", [1, 16, 64])
def test_conv_config_rule_at_resnet50_shapes(batch):
    """A legal (bn, split) at every ResNet-50 path shape: 128 channels a
    tile past 64; a split keeps its blocks within one a multiprocessor
    and its slices at CONV_MIN_SLICE k-tiles or more, and is the largest
    that does (so at batches 16 and 64 at least half the 132
    multiprocessors hold a block wherever K >= 1152: stage 4's 3x3s split
    4 ways to 112 blocks, stage 3's 2 ways to 100, stage 2's 98 tiles and
    stage 4's 1x1/2 at 112 unsplit); forced values pass through, others
    are refused."""
    for m, n, k in _resnet50_spatial(batch):
        bn, split = tqm.conv_config(m, n, k, 1, 132)
        assert bn == (128 if n > 64 else 64) and split in tqm.CONV_SPLITS
        kt = -(-k // BK)
        tiles = -(-m // BM) * -(-n // bn)
        if split > 1:
            assert kt // split >= tqm.CONV_MIN_SLICE
            assert tiles * split <= 132
        assert split == MAX_SPLIT or 2 * split * tiles > 132 \
            or kt < 2 * split * tqm.CONV_MIN_SLICE, (m, n, k, split)
        if batch >= 16 and k >= 1152:
            assert 2 * tiles * split >= 132, (m, n, k, bn, split)
    assert [tqm.conv_config(m, n, k, 1, 132)[1]
            for m, n, k in _resnet50_spatial(16)] == \
        [1, 1, 1, 1, 1, 2, 1, 2, 4, 1, 4]
    assert tqm.conv_config(784, 512, 4608, 1, 132, 64, 2) == (64, 2)
    for bad in (dict(bn=96), dict(split=3), dict(split=16)):
        with pytest.raises(ValueError):
            tqm.conv_config(784, 512, 4608, 1, 132, **bad)


@pytest.mark.parametrize("geom", MODEL_GEOMS + (
    ((16, 224, 224, 3), (7, 7, 3, 64), (2, 2), [(2, 3), (2, 3)], (1, 1), 1),
    ((3, 10, 12, 24), (5, 3, 24, 40), (2, 1), [(1, 2), (1, 1)], (1, 1), 1),
    ((2, 3, 40, 8), (3, 3, 8, 8), (1, 1), [(2, 2), (5, 5)], (1, 1), 1)))
def test_conv_halo_rows_cover_every_window(geom):
    """The staged-rows rule of the entry point (``halo_rows_of``): every
    input row an in-bounds tap of a tile's pixels reads lies in the
    tile's rows [gi_lo, gi_lo + rows), and no tile spans more rows than
    the rule gives; the stem of ResNet-50 at batch 16 stages exactly 9
    rows of 672 bytes (a tile's 128 pixels cover two output rows of
    112); rows past the cap send the conv to byte gathers."""
    g = Geom(*geom)
    most = halo_rows_of(g)
    spans = []
    for m0 in range(0, g.M, BM):
        lo, rows = tile_rows(g, m0)
        spans.append(rows)
        m = np.arange(m0, min(m0 + BM, g.M))
        _, img, ih0, _, _ = _pixel(g, m, 0)
        ih = ih0[:, None] + g.DH * np.arange(g.KH)[None, :]
        gi = (img[:, None] * g.H + ih)[(ih >= 0) & (ih < g.H)]
        if gi.size:
            assert gi.min() >= lo and gi.max() < lo + rows
    assert 0 < max(spans) <= most
    assert g.halo_rows == (most if g.run else 0)
    if geom[0] == (16, 224, 224, 3):
        assert g.halo_rows == max(spans) == 9
        assert g.halo_rows * g.W * g.C == 6048 and a_mode(g) == "run"
    # 4000 x 8 channels a row: 3-4 rows pass the cap, so bytes from x
    wide = Geom((1, 9, 4000, 8), (3, 3, 8, 8), (1, 1), [(1, 1), (1, 1)],
                (1, 1), 1)
    assert wide.run and halo_rows_of(wide) >= 3 and wide.halo_rows == 0
    assert a_mode(wide) == "bytes"


def test_quantized_conv_layer_pack_follows_w_q():
    """A quantized conv's pack (``_w8_pack``, asked as a launch on the
    card asks it): kept while ``W_q`` is the same tensor at the same
    version; rebuilt after an in-place write and for a new ``W_q``; made
    anew at every call for an inference tensor, which counts no versions;
    none on the plain route or for a CPU input."""
    from types import SimpleNamespace
    from analytics_zoo_tpu_torch.inference import quantize as tquant
    from analytics_zoo_tpu_torch.nn.layers.conv import Convolution2D
    from analytics_zoo_tpu_torch.nn.models import Sequential
    g = np.random.default_rng(4)
    x = g.normal(size=(2, 10, 10, 24)).astype(np.float32)
    conv = Convolution2D(40, 3, border_mode="same", input_shape=(10, 10, 24))
    model = Sequential([conv]).init_weights(2)
    tquant.quantize(model, x, bits=8)
    card, host = SimpleNamespace(is_cuda=True), SimpleNamespace(is_cuda=False)
    pads = [(1, 1), (1, 1)]
    first = conv._w8_pack(card, pads)
    assert torch.equal(first, tqm.pack_conv_weight(conv.W_q, 1))
    assert conv._w8_pack(card, pads) is first
    with torch.no_grad():
        conv.W_q.neg_()
    written = conv._w8_pack(card, pads)
    assert written is not first
    assert torch.equal(written, tqm.pack_conv_weight(conv.W_q, 1))
    conv.W_q = conv.W_q.clone()
    assert conv._w8_pack(card, pads) is not written
    with torch.inference_mode():
        conv.W_q = conv.W_q.clone()
    one, two = conv._w8_pack(card, pads), conv._w8_pack(card, pads)
    assert one is not two and torch.equal(one, two)
    assert conv._w8_pack(host, pads) is None
    conv.impl = "torch"
    assert conv._w8_pack(card, pads) is None
