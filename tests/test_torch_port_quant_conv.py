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
  channel) every byte of a staged A tile reads, in both loaders (16-byte
  pieces and byte gathers), and the transposed B tile, against
  ``F.unfold``'s im2col; then the whole product replayed through the PTX
  m16n8k32 fragment layouts and the epilogue's mapping, bitwise against
  the plain version, so the kernel's index maths is checked before the
  card.
"""

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
BM, BN, BK = C["kCvBM"], C["kCvBN"], C["kCvBK"]
THREADS, PITCH = C["kCvThreads"], C["kCvPitch"]
TID = np.arange(THREADS)


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
        self.avec = self.CG % 16 == 0 and self.C % 16 == 0
        self.bvec = self.NG % 4 == 0 and self.COUT % 4 == 0


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


def stage_a(g, x, m0, grp, k0, avec):
    """The A tile (BM x PITCH bytes, k at column k - k0) as ``fetch_a``
    stages it: thread t takes piece j = t & 3 of pixels t >> 2 and
    (t >> 2) + 32; ``avec`` copies a 16-byte piece from its first byte's
    tap, otherwise each byte is gathered by its own (kh, kw, c)."""
    tile = np.zeros((BM, PITCH), np.int8)
    j, r0 = TID & 3, TID >> 2
    for h in (0, 1):
        rows = r0 + 32 * h
        ok, img, ih0, iw0, coff = _pixel(g, m0 + rows, grp)
        for e in range(16):
            k = k0 + 16 * j + (0 if avec else e)
            c, kw, kh = _tap(g, k)
            c = c + (e if avec else 0)
            ih, iw = ih0 + kh * g.DH, iw0 + kw * g.DW
            inb = ok & (k0 + 16 * j + e < g.K) & (ih >= 0) & (ih < g.H) \
                & (iw >= 0) & (iw < g.W)
            val = np.where(inb, x[np.where(inb, img, 0),
                                  np.clip(ih, 0, g.H - 1),
                                  np.clip(iw, 0, g.W - 1),
                                  np.clip(coff + c, 0, g.C - 1)], 0)
            tile[rows, 16 * j + e] = val
    return tile


def _word(b4):
    """Little-endian words of (..., 4) int8 bytes."""
    u = b4.astype(np.uint8).astype(np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def _bytes(word):
    return np.stack([(word >> (8 * i)) & 0xFF for i in range(4)],
                    -1).astype(np.uint8).astype(np.int8)


def _transpose4(r):
    """``transpose4``'s PRMTs: byte c of r[j] to byte j of o[c]."""
    def perm(a, b, sel):
        src = np.concatenate([_bytes(a), _bytes(b)], -1)
        idx = [(sel >> (4 * i)) & 0x7 for i in range(4)]
        return _word(src[..., idx])
    s0, s1 = perm(r[0], r[1], 0x5140), perm(r[0], r[1], 0x7362)
    s2, s3 = perm(r[2], r[3], 0x5140), perm(r[2], r[3], 0x7362)
    return [perm(s0, s2, 0x5410), perm(s0, s2, 0x7632),
            perm(s1, s3, 0x5410), perm(s1, s3, 0x7632)]


def stage_b(g, w, n0, grp, k0):
    """The transposed B tile ([channel][k], BN x PITCH bytes) as
    ``fetch_b`` reads 4 x 4 pieces and ``store_staged`` transposes
    them."""
    w2 = w.reshape(g.K, g.COUT)
    tile = np.zeros((BN, PITCH), np.int8)
    warp, lane = TID >> 5, TID & 31
    kb = (lane >> 2) + 8 * (warp & 1)
    nb = (lane & 3) + 4 * (warp >> 1)
    for h in (0, 1):
        n = n0 + 4 * (nb + 8 * h)
        rows = []
        for r in range(4):
            k = k0 + 4 * kb + r
            cols = n[:, None] + np.arange(4)
            inb = (k < g.K)[:, None] & (cols < g.NG)
            raw = np.where(inb, w2[np.clip(k, 0, g.K - 1)[:, None],
                                   grp * g.NG + np.clip(cols, 0, g.NG - 1)],
                           0)
            rows.append(_word(raw))
        o = _transpose4(rows)
        for c in range(4):
            tile[(4 * (nb + 8 * h) + c)[:, None],
                 4 * kb[:, None] + np.arange(4)] = \
                _bytes(o[c])
    return tile


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


def _s8(word, j):
    return ((word >> (8 * j)) & 0xFF).astype(np.int64) - \
        (((word >> (8 * j + 7)) & 1) << 8).astype(np.int64)


GQ, TQ = np.arange(32) >> 2, np.arange(32) & 3


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


def _lds32(tile, row, col):
    return _word(tile[row[:, None], col[:, None] + np.arange(4)])


def replay(x, w, scale, g):
    """The kernel's output: every block's stages, fragment loads (4-byte
    words of the staged rows), s8 mmas and epilogue, in numpy."""
    out = np.full((g.M, g.COUT), np.nan, np.float32)
    for grp in range(g.G):
        for m0 in range(0, g.M, BM):
            for n0 in range(0, g.NG, BN):
                acc = {(w_, i, jn): [np.zeros(32, np.int64)] * 4
                       for w_ in range(4) for i in range(2)
                       for jn in range(4)}
                for k0 in range(0, g.K, BK):
                    sa = stage_a(g, x, m0, grp, k0, g.avec)
                    sb = stage_b(g, w, n0, grp, k0)
                    for w_ in range(4):
                        wm, wn = w_ & 1, w_ >> 1
                        for s in range(BK // 32):
                            col = 32 * s + 4 * TQ
                            for i in range(2):
                                row = 32 * wm + 16 * i + GQ
                                af = [_lds32(sa, row, col),
                                      _lds32(sa, row + 8, col),
                                      _lds32(sa, row, col + 16),
                                      _lds32(sa, row + 8, col + 16)]
                                for jn in range(4):
                                    nrow = 32 * wn + 8 * jn + GQ
                                    bf = [_lds32(sb, nrow, col),
                                          _lds32(sb, nrow, col + 16)]
                                    acc[w_, i, jn] = _mma(acc[w_, i, jn],
                                                          af, bf)
                for (w_, i, jn), a in acc.items():
                    wm, wn = w_ & 1, w_ >> 1
                    for e in range(4):
                        m = m0 + 32 * wm + 16 * i + GQ + 8 * (e >> 1)
                        n = n0 + 32 * wn + 8 * jn + 2 * TQ + (e & 1)
                        keep = (m < g.M) & (n < g.NG)
                        col = grp * g.NG + n[keep]
                        out[m[keep], col] = a[e][keep].astype(np.int32) \
                            .astype(np.float32) * scale[col]
    return out.reshape(g.B, g.HO, g.WO, g.COUT)


# geometries for the model: the stem (byte gathers, K = 147 past two
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
    """Every staged A tile (both loaders, whatever the shape takes) is the
    im2col block of ``F.unfold``: zero for padding, past M and past K;
    every staged B tile is the weight block transposed."""
    g = Geom(*geom)
    x, w, _ = _case(5, (geom[0], geom[1], 1, "same", 1, 1))
    for grp in range(g.G):
        cols = _im2col(x, g, grp)
        w2 = w.reshape(g.K, g.COUT)[:, grp * g.NG:(grp + 1) * g.NG]
        for m0 in range(0, g.M, BM):
            for k0 in range(0, g.K, BK):
                want = np.zeros((BM, BK), np.int8)
                blk = cols[m0:m0 + BM, k0:k0 + BK]
                want[:blk.shape[0], :blk.shape[1]] = blk
                for avec in {False, g.avec}:
                    got = stage_a(g, x, m0, grp, k0, avec)
                    np.testing.assert_array_equal(got[:, :BK], want)
        for n0 in range(0, g.NG, BN):
            for k0 in range(0, g.K, BK):
                want = np.zeros((BN, BK), np.int8)
                blk = w2[k0:k0 + BK, n0:n0 + BN].T
                want[:blk.shape[0], :blk.shape[1]] = blk
                np.testing.assert_array_equal(
                    stage_b(g, w, n0, grp, k0)[:, :BK], want)


@pytest.mark.parametrize("geom", MODEL_GEOMS[:4])
def test_kernel_replay_bitwise_vs_plain(geom):
    """The whole kernel replayed (stages, fragment loads, mmas through the
    PTX layouts, epilogue) equals the plain version bitwise."""
    g = Geom(*geom)
    x, w, scale = _case(6, (geom[0], geom[1], 1, "same", 1, 1))
    got = replay(x, w, scale, g)
    want = tqm.w8a8_conv_torch(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(scale), geom[2], geom[3],
                               geom[4], geom[5]).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_model_rejects_a_shifted_pad():
    """The model is sharp: a tile gathered with the top pad one more
    (the planted fault of chip_smoke's image phase) is not im2col's."""
    geom = MODEL_GEOMS[1]
    g = Geom(*geom)
    x, _, _ = _case(5, (geom[0], geom[1], 1, "same", 1, 1))
    want = _im2col(x, g, 0)[:BM, :BK]
    g.PT += 1
    got = stage_a(g, x, 0, 0, 0, g.avec)[:want.shape[0], :BK]
    assert not np.array_equal(got, want)
