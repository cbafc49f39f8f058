"""PyTorch port: the rest of ``nn/layers/conv.py`` and the 3-D pools
against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) and the same weights (the port
layer's own draw, exported in the JAX layout) go through each port layer
and its JAX twin; outputs and the gradients of Σ y·r with respect to
every parameter and the input are compared (``torch_layer_parity``):

- the shape layers: ``ZeroPadding1D`` / ``3D``, ``Cropping1D`` / ``2D`` /
  ``3D``, ``UpSampling1D`` / ``2D`` / ``3D``;
- ``DepthwiseConvolution2D`` and ``SeparableConvolution2D``, "same" at
  stride 2 on even sizes (XLA's (0, 1) pads), depth multipliers, channels
  first;
- the ``_ConvND`` family's rest: ``Convolution3D``, ``AtrousConvolution2D``
  and ``ShareConvolution2D`` in float, int8 (codes and scales from the
  JAX quantizer; outputs bitwise) and int4; the 3-D int8 conv's kernel
  route (depth taps folded into the channels on the ``w8a8_conv2d``
  plain version) bitwise against its plain version;
- ``Deconvolution2D`` ("valid" / "same", strides below, at and above the
  kernel), ``LocallyConnected1D`` / ``2D``, ``ResizeBilinear`` (TF1's
  grid, with and without ``align_corners``), ``LRN2D``;
- ``MaxPooling3D`` / ``AveragePooling3D`` (valid, same, explicit
  padding) and the 3-D global pools.

Tolerances: LAYER_TOL (1e-5, f32 summation order) for float layers; int8
bitwise; int4 within 1e-5 (the dequantized weight is the same, the
convolution's summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import quantize as jquant
from analytics_zoo_tpu.nn.layers import conv as jconv
from analytics_zoo_tpu.nn.layers import pooling as jpool
from analytics_zoo_tpu_torch.nn.layers import conv as tconv
from analytics_zoo_tpu_torch.nn.layers import pooling as tpool
from analytics_zoo_tpu_torch.ops import quant_matmul as qm
from analytics_zoo_tpu_torch.utils.convert import load_jax_params
from torch_layer_parity import check_layer, f32_policy, params_np, to_np

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    with f32_policy():
        yield


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _seeded(layer, seed):
    layer.init_weights(seed)
    # a non-zero bias, so that its gradient and its place are checked
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith("b"):
                p.copy_(torch.from_numpy(np.random.default_rng(seed).normal(
                    0, 0.1, tuple(p.shape)).astype(np.float32)))
    return layer


# -- the shape layers ------------------------------------------------------------

SHAPE_CASES = {
    "zeropad1d": (lambda: tconv.ZeroPadding1D(2, input_shape=(5, 3)),
                  lambda: jconv.ZeroPadding1D(2), (2, 5, 3)),
    "zeropad1d_pair": (lambda: tconv.ZeroPadding1D((1, 3),
                                                   input_shape=(5, 3)),
                       lambda: jconv.ZeroPadding1D((1, 3)), (2, 5, 3)),
    "zeropad3d": (lambda: tconv.ZeroPadding3D((1, 0, 2),
                                              input_shape=(3, 4, 2, 3)),
                  lambda: jconv.ZeroPadding3D((1, 0, 2)), (2, 3, 4, 2, 3)),
    "crop1d": (lambda: tconv.Cropping1D((1, 2), input_shape=(7, 3)),
               lambda: jconv.Cropping1D((1, 2)), (2, 7, 3)),
    "crop2d": (lambda: tconv.Cropping2D(((1, 0), (2, 1)),
                                        input_shape=(6, 7, 3)),
               lambda: jconv.Cropping2D(((1, 0), (2, 1))), (2, 6, 7, 3)),
    "crop2d_th": (lambda: tconv.Cropping2D(((0, 2), (1, 1)),
                                           dim_ordering="th",
                                           input_shape=(3, 6, 7)),
                  lambda: jconv.Cropping2D(((0, 2), (1, 1)),
                                           dim_ordering="th"),
                  (2, 3, 6, 7)),
    "crop3d": (lambda: tconv.Cropping3D(((1, 1), (0, 2), (1, 0)),
                                        input_shape=(4, 5, 6, 2)),
               lambda: jconv.Cropping3D(((1, 1), (0, 2), (1, 0))),
               (2, 4, 5, 6, 2)),
    "upsample1d": (lambda: tconv.UpSampling1D(3, input_shape=(4, 2)),
                   lambda: jconv.UpSampling1D(3), (2, 4, 2)),
    "upsample2d": (lambda: tconv.UpSampling2D((2, 3), input_shape=(3, 4, 2)),
                   lambda: jconv.UpSampling2D((2, 3)), (2, 3, 4, 2)),
    "upsample2d_th": (lambda: tconv.UpSampling2D(2, dim_ordering="th",
                                                 input_shape=(2, 3, 4)),
                      lambda: jconv.UpSampling2D(2, dim_ordering="th"),
                      (2, 2, 3, 4)),
    "upsample3d": (lambda: tconv.UpSampling3D((1, 2, 3),
                                              input_shape=(2, 3, 2, 2)),
                   lambda: jconv.UpSampling3D((1, 2, 3)), (2, 2, 3, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_layers_match_jax(case):
    build_t, build_j, shape = SHAPE_CASES[case]
    tl = build_t()
    want = check_layer(tl, build_j(), _x(1, shape))
    assert tuple(tl.compute_output_shape(shape[1:])) == want.shape[1:]


# -- depthwise and separable -------------------------------------------------------

DW_CASES = {
    "3x3_s1_same": dict(kernel_size=3, border_mode="same"),
    "3x3_s2_same": dict(kernel_size=3, subsample=2, border_mode="same",
                        activation="relu6"),
    "3x3_s2_valid_nobias": dict(kernel_size=3, subsample=2, bias=False),
    "mult2": dict(kernel_size=(3, 2), depth_multiplier=2,
                  border_mode="same"),
    "channels_first": dict(kernel_size=3, subsample=2, border_mode="same",
                           dim_ordering="th"),
}


@pytest.mark.parametrize("case", sorted(DW_CASES))
@pytest.mark.parametrize("kind", ["depthwise", "separable"])
def test_depthwise_and_separable_match_jax(case, kind):
    kw = dict(DW_CASES[case])
    th = kw.get("dim_ordering") == "th"
    shape = (4, 8, 8) if th else (8, 8, 4)
    if kind == "depthwise":
        tl = tconv.DepthwiseConvolution2D(input_shape=shape, name="d", **kw)
        jl = jconv.DepthwiseConvolution2D(name="d", **kw)
    else:
        tl = tconv.SeparableConvolution2D(5, input_shape=shape, name="d",
                                          **kw)
        jl = jconv.SeparableConvolution2D(5, name="d", **kw)
    _seeded(tl, 3)
    want = check_layer(tl, jl, _x(2, (2,) + shape))
    assert tuple(tl.compute_output_shape(shape)) == want.shape[1:]


# -- the rest of the _ConvND family, float and quantized -------------------------

ND_CASES = {
    "conv3d_same": (tconv.Convolution3D, jconv.Convolution3D,
                    dict(nb_filter=5, kernel_size=3, border_mode="same",
                         subsample=(1, 2, 2)), (6, 6, 5, 3)),
    "conv3d_valid_dilated": (tconv.Convolution3D, jconv.Convolution3D,
                             dict(nb_filter=4, kernel_size=(2, 3, 2),
                                  dilation=(2, 1, 2), activation="relu"),
                             (6, 5, 6, 3)),
    "conv3d_groups": (tconv.Convolution3D, jconv.Convolution3D,
                      dict(nb_filter=6, kernel_size=(3, 1, 3), groups=2,
                           border_mode="same", subsample=(2, 1, 1)),
                      (5, 4, 4, 4)),
    "conv3d_pointwise": (tconv.Convolution3D, jconv.Convolution3D,
                         dict(nb_filter=5, kernel_size=1), (3, 4, 4, 6)),
    "conv3d_th": (tconv.Convolution3D, jconv.Convolution3D,
                  dict(nb_filter=4, kernel_size=2, dim_ordering="th"),
                  (3, 4, 5, 4)),
    "atrous2d": (tconv.AtrousConvolution2D, jconv.AtrousConvolution2D,
                 dict(nb_filter=6, kernel_size=3, atrous_rate=(2, 3),
                      border_mode="same"), (11, 12, 4)),
    "share2d": (tconv.ShareConvolution2D, jconv.ShareConvolution2D,
                dict(nb_filter=5, kernel_size=3, pad_h=1, pad_w=2,
                     subsample=2), (9, 8, 3)),
}


def _nd_layers(case):
    tcls, jcls, kw, shape = ND_CASES[case]
    tl = _seeded(tcls(input_shape=shape, name="c", **kw), 4)
    return tl, jcls(name="c", **kw), shape


@pytest.mark.parametrize("case", sorted(ND_CASES))
def test_conv_nd_float_matches_jax(case):
    tl, jl, shape = _nd_layers(case)
    want = check_layer(tl, jl, _x(5, (2,) + shape))
    assert tuple(tl.compute_output_shape(shape)) == want.shape[1:]


def _quantized_pair(case, bits):
    """The port and JAX layers of ``case`` quantized by the JAX quantizer
    (int8 at the input's absmax), the JAX leaves loaded into the port."""
    tl, jl, shape = _nd_layers(case)
    x = _x(6, (2,) + shape)
    p = params_np(tl)
    leaves = jquant._quantize_w8(p["W"], float(np.abs(x).max())) \
        if bits == 8 else jquant._quantize_w4(p["W"], 16)
    leaves = {k: np.asarray(v) for k, v in leaves.items()}
    leaves["b"] = p["b"]
    load_jax_params(tl, leaves)
    return tl, jl, leaves, x


@pytest.mark.parametrize("case", sorted(ND_CASES))
@pytest.mark.parametrize("bits", [8, 4])
def test_conv_nd_quantized_matches_jax(case, bits):
    tl, jl, leaves, x = _quantized_pair(case, bits)
    assert tl.bits == bits
    want = np.asarray(jl.call({k: jnp.asarray(v) for k, v in leaves.items()},
                              x))
    with torch.no_grad():
        got = to_np(tl(torch.from_numpy(x)))
    assert got.shape == want.shape
    if bits == 8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["conv3d_same", "conv3d_valid_dilated",
                                  "conv3d_groups"])
def test_conv3d_int8_folded_route_is_bitwise(case):
    """The 3-D int8 kernel route gathers the depth taps into the channels
    and runs ``w8a8_conv2d``; on the CPU that call takes its plain
    version, so the fold's indexing is held here, bitwise against the
    plain float64 ``conv3d`` and extreme codes."""
    tl, _, _, x = _quantized_pair(case, 8)
    g = np.random.default_rng(7)
    for extremes in (False, True):
        vals = np.array([-128, 127], np.int8)
        shape = (2,) + tuple(x.shape[1:4]) + (x.shape[-1],)
        xq = torch.from_numpy(g.choice(vals, shape) if extremes else
                              g.integers(-128, 128, shape, dtype=np.int8))
        w = tl.W_q
        kshape, strides, dilation = tl._geometry()
        pads = tl._pads(xq.shape[1:4])
        scale = tl.s_x * tl.s_w
        plain = qm.w8a8_conv3d(xq, w, scale, strides=strides, pads=pads,
                               dilation=dilation, groups=tl.groups,
                               impl="torch")
        folded = qm.w8a8_conv3d_folded(xq, w, scale, strides=strides,
                                       pads=pads, dilation=dilation,
                                       groups=tl.groups, impl="torch")
        assert torch.equal(plain, folded)


def test_conv3d_int8_routes_to_the_conv_kernel_entry(monkeypatch):
    """A spatial 3-D int8 conv goes to ``w8a8_conv3d`` and a pointwise one
    to the matmul: what a CUDA tensor would launch."""
    seen = []
    real3, realmm = qm.w8a8_conv3d, qm.w8a8_matmul
    monkeypatch.setattr(qm, "w8a8_conv3d", lambda *a, **k: seen.append(
        "conv3d") or real3(*a, **k))
    monkeypatch.setattr(qm, "w8a8_matmul", lambda *a, **k: seen.append(
        "matmul") or realmm(*a, **k))
    for case in ("conv3d_same", "conv3d_pointwise"):
        tl, _, _, x = _quantized_pair(case, 8)
        with torch.no_grad():
            tl(torch.from_numpy(x))
    assert seen == ["conv3d", "matmul"]


# -- transposed, locally connected, resize, LRN ----------------------------------

DECONV_CASES = {
    "valid_s1": dict(kernel_size=3),
    "valid_s2": dict(kernel_size=3, subsample=2),
    "same_s2": dict(kernel_size=3, subsample=2, border_mode="same"),
    "same_s2_k4": dict(kernel_size=4, subsample=2, border_mode="same"),
    "same_s3_k2": dict(kernel_size=2, subsample=3, border_mode="same"),
    "same_rect": dict(kernel_size=(3, 2), subsample=(1, 2),
                      border_mode="same", activation="tanh"),
    "channels_first": dict(kernel_size=3, subsample=2, border_mode="same",
                           dim_ordering="th"),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution2d_matches_jax(case):
    kw = DECONV_CASES[case]
    shape = (3, 5, 6) if kw.get("dim_ordering") == "th" else (5, 6, 3)
    tl = _seeded(tconv.Deconvolution2D(4, input_shape=shape, name="dc",
                                       **kw), 8)
    want = check_layer(tl, jconv.Deconvolution2D(4, name="dc", **kw),
                       _x(9, (2,) + shape))
    assert tuple(tl.compute_output_shape(shape)) == want.shape[1:]


@pytest.mark.parametrize("case", ["lc1d", "lc1d_nobias", "lc2d", "lc2d_s2"])
def test_locally_connected_matches_jax(case):
    if case.startswith("lc1d"):
        kw = dict(activation="relu", bias=case == "lc1d")
        tl = tconv.LocallyConnected1D(4, 3, input_shape=(7, 3), name="l",
                                      **kw)
        jl, shape = jconv.LocallyConnected1D(4, 3, name="l", **kw), (7, 3)
    else:
        kw = dict(subsample=2 if case == "lc2d_s2" else 1)
        tl = tconv.LocallyConnected2D(5, 3, 2, input_shape=(7, 6, 3),
                                      name="l", **kw)
        jl, shape = jconv.LocallyConnected2D(5, 3, 2, name="l", **kw), \
            (7, 6, 3)
    _seeded(tl, 10)
    want = check_layer(tl, jl, _x(11, (2,) + shape))
    assert tuple(tl.compute_output_shape(shape)) == want.shape[1:]


@pytest.mark.parametrize("out_hw", [(9, 7), (3, 4), (5, 5)])
@pytest.mark.parametrize("align", [False, True])
def test_resize_bilinear_matches_jax(out_hw, align):
    tl = tconv.ResizeBilinear(*out_hw, align_corners=align)
    want = check_layer(tl, jconv.ResizeBilinear(*out_hw,
                                                align_corners=align),
                       _x(12, (2, 5, 6, 3)))
    assert tuple(tl.compute_output_shape((5, 6, 3))) == want.shape[1:]


def test_resize_bilinear_is_not_half_pixel():
    """The TF1 grid differs from ``F.interpolate``'s half-pixel centres."""
    x = torch.from_numpy(_x(13, (1, 4, 4, 2)))
    got = tconv.ResizeBilinear(8, 8)(x)
    half = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(8, 8), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    assert not torch.allclose(got, half, atol=1e-3)


@pytest.mark.parametrize("kw", [dict(), dict(alpha=1e-2, k=2.0, beta=0.5,
                                             n=3), dict(dim_ordering="th")])
def test_lrn2d_matches_jax(kw):
    tl = tconv.LRN2D(**kw)
    check_layer(tl, jconv.LRN2D(**kw), _x(14, (2, 4, 5, 7)) * 3.0)


# -- 3-D pools -------------------------------------------------------------------

POOL3D_CASES = {
    "valid": dict(pool_size=2),
    "same_s2": dict(pool_size=3, strides=2, border_mode="same"),
    "rect": dict(pool_size=(1, 2, 3), strides=(1, 1, 2)),
    "padded": dict(pool_size=2, padding=((1, 0), (0, 1), (1, 1))),
    "channels_first": dict(pool_size=2, dim_ordering="th"),
}


@pytest.mark.parametrize("case", sorted(POOL3D_CASES))
@pytest.mark.parametrize("op", ["max", "avg"])
def test_pool3d_matches_jax(case, op):
    kw = POOL3D_CASES[case]
    shape = (3, 5, 6, 7) if kw.get("dim_ordering") == "th" else (5, 6, 7, 3)
    name = "MaxPooling3D" if op == "max" else "AveragePooling3D"
    tl = getattr(tpool, name)(**kw)
    want = check_layer(tl, getattr(jpool, name)(**kw), _x(15, (2,) + shape))
    assert tuple(tl.compute_output_shape(shape)) == want.shape[1:]


@pytest.mark.parametrize("name", ["GlobalMaxPooling3D",
                                  "GlobalAveragePooling3D"])
@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_global_pool3d_matches_jax(name, ordering):
    tl = getattr(tpool, name)(dim_ordering=ordering)
    want = check_layer(tl, getattr(jpool, name)(dim_ordering=ordering),
                       _x(16, (2, 3, 4, 5, 6)))
    assert tuple(tl.compute_output_shape((3, 4, 5, 6))) == want.shape[1:]
