"""ImageSet + OpenCV-backed image transforms; the port's own copy of the JAX
package's ``feature/image.py`` (host-side numpy / ``cv2`` code, copied, not
redesigned).

Reference parity: `ImageSet` (feature/image/ImageSet.scala:46-340) and the ~30 transform
ops in feature/image/*.scala (Resize, AspectScale, CenterCrop, RandomCrop, Flip,
Brightness/Contrast/Saturation/Hue/ColorJitter, ChannelNormalize, Expand, Filler,
RandomTransformer, ImageSetToSample...).  These run in the host data path feeding the
device, never on the accelerator.  Images are numpy HWC uint8/float32 BGR (OpenCV
convention, matching the reference's OpenCVMat behaviour).

``cv2`` is imported optionally, as in the JAX package: without it the module and
every transform still construct, and a transform that needs OpenCV (decode, resize,
colour conversion) raises when it runs.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

from analytics_zoo_tpu_torch.feature.common import Preprocessing
from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet

_INTERP = {"linear": "INTER_LINEAR", "nearest": "INTER_NEAREST",
           "cubic": "INTER_CUBIC", "area": "INTER_AREA"}


def _cv2():
    """The ``cv2`` module, or a clear error where OpenCV is not installed."""
    if cv2 is None:
        raise RuntimeError("this image transform needs OpenCV (cv2), which "
                           "is not installed")
    return cv2


class ImageFeature(dict):
    """Per-image record: keys `image` (HWC ndarray), `label`, `uri`, ... —
    feature/image ImageFeature parity."""

    @property
    def image(self):
        return self["image"]

    @property
    def label(self):
        return self.get("label")


class ImageSet:
    """Local image collection with lazy-free eager transforms (LocalImageSet; the
    distributed variant is the same API over sharded file lists)."""

    def __init__(self, features: List[ImageFeature]):
        self.features = features

    # -- constructors (ImageSet.read, ImageSet.scala:236) ---------------------
    @staticmethod
    def read(path: str, with_label: bool = False,
             one_based_label: bool = True) -> "ImageSet":
        """Read images from `path` (file, dir, or glob).  With labels: subdirectory
        names become class labels (sorted, 1-based by default)."""
        if os.path.isfile(path):
            files = [path]
        elif os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "**", "*.*"),
                                     recursive=True))
        else:
            files = sorted(glob.glob(path))
        feats = []
        classes = {}
        if with_label:
            dirs = sorted({os.path.basename(os.path.dirname(f)) for f in files})
            classes = {d: i + (1 if one_based_label else 0)
                       for i, d in enumerate(dirs)}
        cv = _cv2()
        for f in files:
            img = cv.imread(f, cv.IMREAD_COLOR)
            if img is None:
                continue
            feat = ImageFeature(image=img, uri=f)
            if with_label:
                feat["label"] = classes[os.path.basename(os.path.dirname(f))]
            feats.append(feat)
        return ImageSet(feats)

    @staticmethod
    def from_arrays(images: Sequence[np.ndarray],
                    labels: Optional[Sequence] = None) -> "ImageSet":
        feats = []
        for i, img in enumerate(images):
            f = ImageFeature(image=np.asarray(img))
            if labels is not None:
                f["label"] = labels[i]
            feats.append(f)
        return ImageSet(feats)

    # -- transform ------------------------------------------------------------
    def transform(self, op: Preprocessing) -> "ImageSet":
        return ImageSet([op.transform(f) for f in self.features])

    def to_distributed(self, num_shards: int = 4) -> "DistributedImageSet":
        """Split into roughly equal shards (ImageSet.toDistributed analog)."""
        idx = np.array_split(np.arange(len(self.features)),
                             max(num_shards, 1))
        return DistributedImageSet(
            [ImageSet([self.features[i] for i in part]) for part in idx])

    is_distributed = False

    def __len__(self):
        return len(self.features)

    def get_image(self) -> List[np.ndarray]:
        return [f.image for f in self.features]

    def get_label(self) -> List:
        return [f.label for f in self.features]

    def to_feature_set(self, to_chw: bool = False,
                       float_scale: Optional[float] = None) -> ArrayFeatureSet:
        """Stack into (N, H, W, C) float32 arrays (+ labels) for the Estimator.
        to_chw=True emits NCHW ("th" ordering)."""
        imgs = []
        for f in self.features:
            img = np.asarray(f.image, np.float32)
            if float_scale:
                img = img * float_scale
            if to_chw:
                img = np.transpose(img, (2, 0, 1))
            imgs.append(img)
        x = np.stack(imgs)
        labels = [f.label for f in self.features]
        y = (np.asarray(labels, np.float32).reshape(len(labels), -1)
             if labels[0] is not None else None)
        return ArrayFeatureSet(x, y)


class ImageTransform(Preprocessing):
    """Base: subclasses implement `apply_image(img) -> img`."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        out = ImageFeature(feature)
        out["image"] = self.apply_image(feature["image"])
        return out

    def apply_image(self, img):
        raise NotImplementedError


class ImageBytesToMat(Preprocessing):
    """Decode encoded bytes (`bytes` key) to an image (ImageBytesToMat parity)."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        out = ImageFeature(feature)
        buf = np.frombuffer(feature["bytes"], np.uint8)
        cv = _cv2()
        out["image"] = cv.imdecode(buf, cv.IMREAD_COLOR)
        return out


class ImageResize(ImageTransform):
    def __init__(self, resize_h: int, resize_w: int, mode: str = "linear"):
        self.h, self.w = int(resize_h), int(resize_w)
        self.interp = _INTERP[mode]

    def apply_image(self, img):
        cv = _cv2()
        return cv.resize(img, (self.w, self.h),
                         interpolation=getattr(cv, self.interp))


class ImageAspectScale(ImageTransform):
    """Resize so the short side == scale, capped at max_size (AspectScale.scala)."""

    def __init__(self, scale: int, max_size: int = 1000):
        self.scale, self.max_size = int(scale), int(max_size)

    def apply_image(self, img):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        ratio = self.scale / short
        if long * ratio > self.max_size:
            ratio = self.max_size / long
        return _cv2().resize(img, (int(round(w * ratio)), int(round(h * ratio))))


class ImageRandomAspectScale(ImageTransform):
    def __init__(self, scales: Sequence[int], max_size: int = 1000, seed=None):
        self.scales = list(scales)
        self.max_size = int(max_size)
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        scale = int(self.rng.choice(self.scales))
        return ImageAspectScale(scale, self.max_size).apply_image(img)


class ImageCenterCrop(ImageTransform):
    def __init__(self, crop_h: int, crop_w: int):
        self.ch, self.cw = int(crop_h), int(crop_w)

    def apply_image(self, img):
        h, w = img.shape[:2]
        y0 = max(0, (h - self.ch) // 2)
        x0 = max(0, (w - self.cw) // 2)
        return img[y0:y0 + self.ch, x0:x0 + self.cw]


class ImageRandomCrop(ImageTransform):
    def __init__(self, crop_h: int, crop_w: int, seed=None):
        self.ch, self.cw = int(crop_h), int(crop_w)
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        h, w = img.shape[:2]
        y0 = int(self.rng.integers(0, max(1, h - self.ch + 1)))
        x0 = int(self.rng.integers(0, max(1, w - self.cw + 1)))
        return img[y0:y0 + self.ch, x0:x0 + self.cw]


class ImageFixedCrop(ImageTransform):
    """Crop by absolute or normalized box (FixedCrop.scala)."""

    def __init__(self, x1, y1, x2, y2, normalized: bool = False):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def apply_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = int(x1 * w), int(x2 * w)
            y1, y2 = int(y1 * h), int(y2 * h)
        return img[int(y1):int(y2), int(x1):int(x2)]


class ImageHFlip(ImageTransform):
    def apply_image(self, img):
        return img[:, ::-1].copy()


class ImageVFlip(ImageTransform):
    def apply_image(self, img):
        return img[::-1].copy()


class ImageRandomFlip(ImageTransform):
    def __init__(self, p: float = 0.5, seed=None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        return img[:, ::-1].copy() if self.rng.random() < self.p else img


class ImageBrightness(ImageTransform):
    """Add a random delta in [delta_low, delta_high] (Brightness.scala)."""

    def __init__(self, delta_low: float, delta_high: float, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        delta = self.rng.uniform(self.lo, self.hi)
        return np.clip(img.astype(np.float32) + delta, 0, 255)


class ImageContrast(ImageTransform):
    def __init__(self, delta_low: float, delta_high: float, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        f = self.rng.uniform(self.lo, self.hi)
        return np.clip(img.astype(np.float32) * f, 0, 255)


class ImageSaturation(ImageTransform):
    def __init__(self, delta_low: float, delta_high: float, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        f = self.rng.uniform(self.lo, self.hi)
        cv = _cv2()
        hsv = cv.cvtColor(img.astype(np.uint8), cv.COLOR_BGR2HSV).astype(
            np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * f, 0, 255)
        return cv.cvtColor(hsv.astype(np.uint8), cv.COLOR_HSV2BGR)


class ImageHue(ImageTransform):
    def __init__(self, delta_low: float, delta_high: float, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        d = self.rng.uniform(self.lo, self.hi)
        cv = _cv2()
        hsv = cv.cvtColor(img.astype(np.uint8), cv.COLOR_BGR2HSV).astype(
            np.float32)
        hsv[..., 0] = (hsv[..., 0] + d) % 180
        return cv.cvtColor(hsv.astype(np.uint8), cv.COLOR_HSV2BGR)


class ImageColorJitter(Preprocessing):
    """Random brightness/contrast/saturation in random order (ColorJitter.scala)."""

    def __init__(self, brightness=32.0, contrast=(0.5, 1.5),
                 saturation=(0.5, 1.5), seed=None):
        self.rng = np.random.default_rng(seed)
        self.ops = [ImageBrightness(-brightness, brightness, seed),
                    ImageContrast(contrast[0], contrast[1], seed),
                    ImageSaturation(saturation[0], saturation[1], seed)]

    def transform(self, feature):
        order = self.rng.permutation(len(self.ops))
        for i in order:
            feature = self.ops[i].transform(feature)
        return feature


class ImageChannelNormalize(ImageTransform):
    """(img - mean) / std per channel (ChannelNormalize.scala)."""

    def __init__(self, mean_b, mean_g, mean_r, std_b=1.0, std_g=1.0, std_r=1.0):
        self.mean = np.asarray([mean_b, mean_g, mean_r], np.float32)
        self.std = np.asarray([std_b, std_g, std_r], np.float32)

    def apply_image(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


class ImagePixelNormalizer(ImageTransform):
    """Subtract a per-pixel mean image (PixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply_image(self, img):
        return img.astype(np.float32) - self.means


class ImageExpand(ImageTransform):
    """Random-place the image on a larger mean-filled canvas (Expand.scala)."""

    def __init__(self, means=(123, 117, 104), max_expand_ratio: float = 2.0,
                 seed=None):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_expand_ratio
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        h, w = img.shape[:2]
        ratio = self.rng.uniform(1.0, self.max_ratio)
        H, W = int(h * ratio), int(w * ratio)
        canvas = np.tile(self.means, (H, W, 1)).astype(img.dtype)
        y0 = int(self.rng.integers(0, H - h + 1))
        x0 = int(self.rng.integers(0, W - w + 1))
        canvas[y0:y0 + h, x0:x0 + w] = img
        return canvas


class ImageFiller(ImageTransform):
    """Fill a normalized sub-rectangle with a value (Filler.scala)."""

    def __init__(self, x1, y1, x2, y2, value: int = 255):
        self.box, self.value = (x1, y1, x2, y2), value

    def apply_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        out = img.copy()
        out[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return out


class ImageRandomTransformer(Preprocessing):
    """Apply an op with probability p (RandomTransformer.scala)."""

    def __init__(self, op: Preprocessing, p: float = 0.5, seed=None):
        self.op, self.p = op, p
        self.rng = np.random.default_rng(seed)

    def transform(self, feature):
        return self.op.transform(feature) if self.rng.random() < self.p \
            else feature


class ImageRandomPreprocessing(ImageRandomTransformer):
    pass  # alias used in pyzoo


class ImageChannelScaledNormalizer(ImageTransform):
    def __init__(self, mean_r, mean_g, mean_b, scale: float):
        self.mean = np.asarray([mean_b, mean_g, mean_r], np.float32)
        self.scale = scale

    def apply_image(self, img):
        return (img.astype(np.float32) - self.mean) * self.scale


class ImageMatToFloats(ImageTransform):
    def apply_image(self, img):
        return np.asarray(img, np.float32)


class ImageSetToSample(Preprocessing):
    """ImageFeature -> (image, label) tuple (ImageSetToSample parity)."""

    def transform(self, feature):
        return np.asarray(feature["image"], np.float32), feature.get("label")


class ImageChannelOrder(ImageTransform):
    """Swap BGR <-> RGB channel order (ImageChannelOrder.scala)."""

    def apply_image(self, img):
        return np.ascontiguousarray(img[..., ::-1])


class ImageMirror(ImageHFlip):
    """Horizontal mirror — BigDL's Mirror naming (ImageMirror.scala)."""


class ImageRandomResize(ImageTransform):
    """Resize to a size sampled uniformly from [min_size, max_size]
    (ImageRandomResize.scala); keeps the aspect ratio square like the
    reference (resizes both dims to the sampled value)."""

    def __init__(self, min_size: int, max_size: int, seed=None):
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.rng = np.random.default_rng(seed)

    def apply_image(self, img):
        s = int(self.rng.integers(self.min_size, self.max_size + 1))
        return _cv2().resize(img, (s, s))


class BufferedImageResize(ImageResize):
    """Resize alias matching the reference's BufferedImageResize (a JVM
    BufferedImage code path; same capability = plain resize here)."""


class ImagePixelBytesToMat(ImageTransform):
    """Raw pixel bytes (H*W*C uint8 buffer in the feature) -> ndarray image
    (ImagePixelBytesToMat.scala)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.shape = (int(height), int(width), int(channels))

    def transform(self, feature: ImageFeature) -> ImageFeature:
        out = ImageFeature(feature)
        buf = feature["bytes"] if "bytes" in feature.keys() else feature["image"]
        out["image"] = np.frombuffer(bytes(buf), np.uint8).reshape(self.shape)
        return out


class ImageMatToTensor(ImageMatToFloats):
    """float tensor conversion with optional CHW layout
    (ImageMatToTensor.scala); format="NCHW" transposes."""

    def __init__(self, format: str = "NHWC"):
        self.format = format

    def apply_image(self, img):
        out = np.asarray(img, np.float32)
        if self.format.upper() == "NCHW":
            out = np.transpose(out, (2, 0, 1))
        return out


class ImageFeatureToTensor(ImageMatToTensor):
    """ImageFeatureToTensor.scala naming alias."""


class DistributedImageSet:
    """Sharded image collection (DistributedImageSet parity): the same
    transform/to_feature_set API over N shards, with shard transforms
    running on a thread pool (host-side preprocessing parallelism — the
    reference's Spark-partition parallelism analog)."""

    def __init__(self, shards: List["ImageSet"]):
        self.shards = shards

    @staticmethod
    def read(path: str, num_shards: int = 4, **kw) -> "DistributedImageSet":
        return ImageSet.read(path, **kw).to_distributed(num_shards)

    def transform(self, op: Preprocessing) -> "DistributedImageSet":
        import copy
        from concurrent.futures import ThreadPoolExecutor

        # np.random.Generator is not thread-safe: give each shard its own
        # deep-copied op with an independently seeded generator
        ops = []
        for i in range(len(self.shards)):
            o = copy.deepcopy(op)
            if hasattr(o, "rng"):
                o.rng = np.random.default_rng(
                    np.random.SeedSequence(entropy=hash((id(op), i)) & (2**63 - 1)))
            ops.append(o)
        with ThreadPoolExecutor(max_workers=len(self.shards)) as ex:
            return DistributedImageSet(
                list(ex.map(lambda so: so[0].transform(so[1]),
                            zip(self.shards, ops))))

    def to_local(self) -> "ImageSet":
        return ImageSet([f for s in self.shards for f in s.features])

    def to_feature_set(self, **kw):
        return self.to_local().to_feature_set(**kw)

    def __len__(self):
        return sum(len(s) for s in self.shards)

    is_distributed = True


