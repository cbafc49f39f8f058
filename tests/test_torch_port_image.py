"""PyTorch port: image records and preprocessing against the JAX package,
on the CPU (host-side numpy / ``cv2`` code, so every comparison is exact).

- every transform of ``feature/image`` and ``feature/common`` against its
  JAX twin on seeded images, the random ones from the same seed over
  several images in turn;
- ``ImageSet`` (``read`` of a labelled directory, ``from_arrays``,
  ``transform``, ``to_feature_set``, ``to_distributed``) and
  ``DistributedImageSet``;
- ``ImageClassificationConfig.preprocessing("resnet50")`` (resize 256 ->
  center crop 224 -> BGR mean subtraction) and ``register``;
- the serving engine's ``default_preprocess`` of ``image`` records, the
  float path and the ``u8`` path, bit for bit against the JAX engine's,
  a 255 pixel included, and the u8 batch's way to the device: never cast
  to int8, 255 arrives as 255.0;
- without ``cv2`` the modules import and the transforms construct; one
  that needs OpenCV raises when it runs.
"""

import base64

import cv2
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import common as jcommon
from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.models import imageclassification as jic
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu_torch.feature import common as tcommon
from analytics_zoo_tpu_torch.feature import image as timage
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import imageclassification as tic
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Flatten
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import engine as teng

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


def _images(seed, n=3, shape=(40, 50, 3)):
    g = np.random.default_rng(seed)
    imgs = [g.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    imgs[0][0, 0] = 255
    return imgs


# name -> factory(module): the same construction on both sides
TRANSFORMS = {
    "resize_linear": lambda m: m.ImageResize(24, 30),
    "resize_nearest": lambda m: m.ImageResize(17, 33, mode="nearest"),
    "resize_cubic": lambda m: m.ImageResize(64, 48, mode="cubic"),
    "resize_area": lambda m: m.ImageResize(20, 25, mode="area"),
    "aspect_scale": lambda m: m.ImageAspectScale(30, max_size=45),
    "random_aspect_scale": lambda m: m.ImageRandomAspectScale(
        [20, 30, 36], seed=3),
    "center_crop": lambda m: m.ImageCenterCrop(21, 33),
    "random_crop": lambda m: m.ImageRandomCrop(21, 33, seed=4),
    "fixed_crop": lambda m: m.ImageFixedCrop(3, 5, 30, 25),
    "fixed_crop_normalized": lambda m: m.ImageFixedCrop(
        0.1, 0.2, 0.7, 0.9, normalized=True),
    "hflip": lambda m: m.ImageHFlip(),
    "vflip": lambda m: m.ImageVFlip(),
    "random_flip": lambda m: m.ImageRandomFlip(0.5, seed=5),
    "brightness": lambda m: m.ImageBrightness(-32, 32, seed=6),
    "contrast": lambda m: m.ImageContrast(0.5, 1.5, seed=7),
    "saturation": lambda m: m.ImageSaturation(0.5, 1.5, seed=8),
    "hue": lambda m: m.ImageHue(-18, 18, seed=9),
    "color_jitter": lambda m: m.ImageColorJitter(seed=10),
    "channel_normalize": lambda m: m.ImageChannelNormalize(
        103.939, 116.779, 123.68, 58.4, 57.1, 57.4),
    "pixel_normalizer": lambda m: m.ImagePixelNormalizer(
        np.full((40, 50, 3), 100.5, np.float32)),
    "expand": lambda m: m.ImageExpand(max_expand_ratio=1.5, seed=11),
    "filler": lambda m: m.ImageFiller(0.1, 0.2, 0.5, 0.6, value=7),
    "random_transformer": lambda m: m.ImageRandomTransformer(
        m.ImageHFlip(), 0.5, seed=12),
    "random_preprocessing": lambda m: m.ImageRandomPreprocessing(
        m.ImageVFlip(), 0.5, seed=13),
    "channel_scaled_normalizer": lambda m: m.ImageChannelScaledNormalizer(
        123, 117, 104, 0.017),
    "mat_to_floats": lambda m: m.ImageMatToFloats(),
    "channel_order": lambda m: m.ImageChannelOrder(),
    "mirror": lambda m: m.ImageMirror(),
    "random_resize": lambda m: m.ImageRandomResize(20, 40, seed=14),
    "buffered_resize": lambda m: m.BufferedImageResize(33, 21),
    "mat_to_tensor_nchw": lambda m: m.ImageMatToTensor(format="NCHW"),
    "feature_to_tensor": lambda m: m.ImageFeatureToTensor(),
    "chain": lambda m: (m.ImageResize(44, 44) >> m.ImageCenterCrop(40, 40)
                        >> m.ImageChannelNormalize(1.0, 2.0, 3.0)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    """Each transform on three seeded images in turn (random ones draw
    from the same seeded generator on both sides): equal arrays, dtypes
    and feature keys."""
    jop, top = TRANSFORMS[name](jimage), TRANSFORMS[name](timage)
    for img in _images(1):
        want = jop.transform(jimage.ImageFeature(image=img, uri="u"))
        got = top.transform(timage.ImageFeature(image=img, uri="u"))
        assert isinstance(got, timage.ImageFeature)
        assert sorted(got) == sorted(want)
        assert got.image.dtype == want.image.dtype
        np.testing.assert_array_equal(got.image, want.image)


def test_bytes_decoders_and_sample_converter_match_jax():
    img = _images(2, 1)[0]
    ok, png = cv2.imencode(".png", img)
    assert ok
    feat = {"bytes": png.tobytes(), "uri": "a"}
    want = jimage.ImageBytesToMat().transform(jimage.ImageFeature(feat))
    got = timage.ImageBytesToMat().transform(timage.ImageFeature(feat))
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.image, img)
    raw = {"bytes": img.tobytes()}
    want = jimage.ImagePixelBytesToMat(40, 50).transform(
        jimage.ImageFeature(raw))
    got = timage.ImagePixelBytesToMat(40, 50).transform(
        timage.ImageFeature(raw))
    np.testing.assert_array_equal(got.image, want.image)
    f = timage.ImageFeature(image=img, label=3)
    gx, gl = timage.ImageSetToSample().transform(f)
    wx, wl = jimage.ImageSetToSample().transform(jimage.ImageFeature(f))
    np.testing.assert_array_equal(gx, wx)
    assert gl == wl == 3


def test_common_preprocessing_matches_jax():
    """``>>`` flattens chains; the generic transforms and the feature /
    label zip give the JAX package's outputs."""
    for mod in (jcommon, tcommon):
        c = mod.FnPreprocessing(lambda s: s + 1) >> \
            mod.FnPreprocessing(lambda s: s * 2)
        c = c >> mod.ScalarToTensor()
        assert len(c.stages) == 3
    samples = [(np.arange(4.0), 2.0), (np.ones(4), 5.0)]

    def run(mod):
        pre = mod.FeatureLabelPreprocessing(
            mod.ArrayToTensor(np.float64) >> mod.FnPreprocessing(
                lambda a: a * 3), mod.ScalarToTensor())
        return pre(samples)
    for (gf, gl), (wf, wl) in zip(run(tcommon), run(jcommon)):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)
        assert gf.dtype == wf.dtype and gl.dtype == wl.dtype


def _chain(mod):
    return mod.ImageResize(36, 36) >> mod.ImageRandomCrop(32, 32, seed=2) \
        >> mod.ImageChannelNormalize(103.939, 116.779, 123.68)


@pytest.mark.parametrize("to_chw,float_scale", [(False, None),
                                                (True, 0.5)])
def test_image_set_from_arrays_to_feature_set_matches_jax(to_chw,
                                                          float_scale):
    imgs = _images(3, 5)
    labels = [1, 0, 2, 2, 1]
    jset = jimage.ImageSet.from_arrays(imgs, labels).transform(
        _chain(jimage))
    tset = timage.ImageSet.from_arrays(imgs, labels).transform(
        _chain(timage))
    assert len(tset) == len(jset) == 5
    assert tset.get_label() == jset.get_label()
    want = jset.to_feature_set(to_chw=to_chw, float_scale=float_scale)
    got = tset.to_feature_set(to_chw=to_chw, float_scale=float_scale)
    np.testing.assert_array_equal(got.xs[0], want.xs[0])
    np.testing.assert_array_equal(got.ys[0], want.ys[0])
    # labels absent: no y
    assert timage.ImageSet.from_arrays(imgs).to_feature_set().ys == []


def test_image_set_read_and_distributed_match_jax(tmp_path):
    """``read`` of a labelled directory of PNGs (class = subdirectory,
    1-based) and of a glob; ``to_distributed`` shards and a deterministic
    transform over the shards (thread pool) give the JAX package's
    arrays."""
    imgs = _images(4, 6, (20, 24, 3))
    for i, img in enumerate(imgs):
        d = tmp_path / ("cat" if i % 2 else "dog")
        d.mkdir(exist_ok=True)
        cv2.imwrite(str(d / f"{i}.png"), img)
    (tmp_path / "dog" / "broken.png").write_bytes(b"not an image")
    for kw in ({"with_label": True}, {"with_label": True,
                                      "one_based_label": False}, {}):
        jset = jimage.ImageSet.read(str(tmp_path), **kw)
        tset = timage.ImageSet.read(str(tmp_path), **kw)
        assert len(tset) == len(jset) == 6
        assert [f["uri"] for f in tset.features] == \
            [f["uri"] for f in jset.features]
        assert tset.get_label() == jset.get_label()
        for a, b in zip(tset.get_image(), jset.get_image()):
            np.testing.assert_array_equal(a, b)
    glob = str(tmp_path / "cat" / "*.png")
    assert len(timage.ImageSet.read(glob)) == len(jimage.ImageSet.read(glob))
    op = lambda m: m.ImageResize(16, 16) >> m.ImageHFlip()  # noqa: E731
    jd = jimage.ImageSet.read(str(tmp_path), with_label=True) \
        .to_distributed(3).transform(op(jimage))
    td = timage.ImageSet.read(str(tmp_path), with_label=True) \
        .to_distributed(3).transform(op(timage))
    assert td.is_distributed and len(td) == len(jd) == 6
    assert len(td.shards) == 3
    want, got = jd.to_feature_set(), td.to_feature_set()
    np.testing.assert_array_equal(got.xs[0], want.xs[0])
    np.testing.assert_array_equal(got.ys[0], want.ys[0])


def test_resnet50_preprocessing_matches_jax():
    """The registry's ImageNet default (resize 256, center crop 224, BGR
    means 103.939 / 116.779 / 123.68) and a registered override."""
    imgs = _images(5, 2, (300, 280, 3))
    want = jic.ImageClassificationConfig.preprocessing("resnet50")
    got = tic.ImageClassificationConfig.preprocessing("resnet50")
    assert [type(s).__name__ for s in got.stages] == \
        [type(s).__name__ for s in want.stages] == \
        ["ImageResize", "ImageCenterCrop", "ImageChannelNormalize"]
    for img in imgs:
        a = got.transform(timage.ImageFeature(image=img)).image
        b = want.transform(jimage.ImageFeature(image=img)).image
        assert a.shape == (224, 224, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    custom = timage.ImageCenterCrop(8, 8)
    tic.ImageClassificationConfig.register("tiny-net", custom)
    try:
        assert tic.ImageClassificationConfig.preprocessing("tiny-net") \
            is custom
    finally:
        tic.ImageClassificationConfig._REGISTRY.pop("tiny-net")


def _image_record(img, fmt=".png", **extra):
    ok, buf = cv2.imencode(fmt, img)
    assert ok
    return {"uri": "r", "image": base64.b64encode(buf.tobytes()).decode(),
            **extra}


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
@pytest.mark.parametrize("extra", [{}, {"resize": [24, 31]}, {"u8": 1},
                                   {"u8": 1, "resize": [24, 31]}])
def test_default_preprocess_image_records_match_jax(fmt, extra):
    """Float path (converted before resizing) and u8 path (resized as
    uint8, a QuantizedTensor of scale 1.0), bit for bit; a 255 pixel
    survives both."""
    img = _images(6, 1, (37, 45, 3))[0]
    img[:3, :3] = 255
    rec = _image_record(img, fmt, **extra)
    want = jeng.default_preprocess(dict(rec))
    got = teng.default_preprocess(dict(rec))
    if extra.get("u8"):
        assert isinstance(got, teng.QuantizedTensor)
        assert isinstance(want, jeng.QuantizedTensor)
        assert got.data.dtype == want.data.dtype == np.uint8
        assert got.scale == want.scale == 1.0
        np.testing.assert_array_equal(got.data, want.data)
        assert got.data.max() == 255
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got.max() == 255.0
    shape = tuple(extra.get("resize", (37, 45))) + (3,)
    data = got.data if extra.get("u8") else got
    assert data.shape == shape


def test_client_enqueue_image_records_decode_to_the_image():
    """``InputQueue.enqueue_image`` (an HWC array encoded to PNG, with
    ``device_uint8``) writes a record the engine decodes to the same
    pixels."""
    from analytics_zoo_tpu_torch.serving.client import InputQueue
    from analytics_zoo_tpu_torch.serving.queues import InProcQueue
    q = InProcQueue()
    img = _images(7, 1, (30, 20, 3))[0]
    InputQueue(q).enqueue_image("a", img, device_uint8=True)
    InputQueue(q).enqueue_image("b", img, resize=(15, 10))
    recs = {r["uri"]: r for _, r in q.read_batch(10)}
    qt = teng.default_preprocess(recs["a"])
    np.testing.assert_array_equal(qt.data, img)
    small = teng.default_preprocess(recs["b"])
    np.testing.assert_array_equal(
        small, jeng.default_preprocess(dict(recs["b"])))
    assert small.shape == (15, 10, 3)


def test_uint8_batch_reaches_the_model_as_its_pixel_values():
    """A compact uint8 batch with per-row scales travels in uint8 (the
    engine's ``_stack_group``, ``InferenceModel``'s bucket padding) and is
    dequantized on the device: a 255 pixel reaches the model as 255.0,
    never through int8 (where it would be -1)."""
    x = np.zeros((3, 2, 2, 3), np.uint8)
    x[0, 0, 0] = [255, 128, 1]
    items = [teng.QuantizedTensor(a, 1.0) for a in x]
    staged = teng.ClusterServing._stack_group(
        ["a", "b", "c"], items, [None] * 3, [None] * 3, 0.0, [{}] * 3)
    assert staged.tensors.dtype == np.uint8
    np.testing.assert_array_equal(staged.scales, np.ones(3, np.float32))
    model = Sequential([Flatten(input_shape=(2, 2, 3)), Dense(2)])
    model.init_weights(0)
    seen = []
    model.layers_list[1].register_forward_pre_hook(
        lambda m, a: seen.append(a[0].clone()))
    im = InferenceModel(max_batch=4, device="cpu").do_load_model(model)
    im.do_predict(staged.tensors, scales=staged.scales)
    assert seen[0].dtype == torch.float32
    assert seen[0].shape == (4, 12)               # padded to the bucket
    np.testing.assert_array_equal(seen[0][0, :3].numpy(), [255., 128., 1.])
    assert im.aot_stats()["programs"] == {"b4x2x2x3/|u1+scales": 1}


def test_without_cv2_transforms_construct_and_raise_when_run(monkeypatch):
    monkeypatch.setattr(timage, "cv2", None)
    chain = tic.ImageClassificationConfig.preprocessing("resnet50")
    img = _images(8, 1, (300, 300, 3))[0]
    with pytest.raises(RuntimeError, match="OpenCV"):
        chain.transform(timage.ImageFeature(image=img))
    # the transforms that need no OpenCV still run
    out = (timage.ImageCenterCrop(224, 224) >> timage.ImageChannelNormalize(
        103.939, 116.779, 123.68)).transform(timage.ImageFeature(image=img))
    assert out.image.shape == (224, 224, 3)
    rec = _image_record(img)
    with pytest.raises(RuntimeError, match="OpenCV"):
        teng.default_preprocess(rec)
