"""Object detection — the JAX package's ``models/objectdetection.py``:
the SSD graphs, the box utilities, the MultiBox loss and the mAP
evaluation.

Reference parity: SSD assembly (ssd/SSD.scala:1-214, SSDGraph.scala:1-220),
``BboxUtil`` (common/BboxUtil.scala:1-1033: encode/decode with center-size
variances, IoU, NMS), ``MultiBoxLoss`` (common/MultiBoxLoss.scala:1-622:
smooth-L1 localisation + cross-entropy with 3:1 hard negative mining) and
the PascalVOC mAP evaluator (common/evaluation/EvalUtil.scala:1-223).

Split between host and device, as in the JAX package: anchor matching and
target encoding run on the host per image (numpy, copied from the JAX
module line for line); the network forward and ``multibox_loss`` run on
the model's device over dense (B, num_priors, ...) tensors; ``detect``
runs the forward and the class softmax on the device, then decodes and
applies NMS on the host copies.  The mAP evaluation and the dataset
parsers are host code.

The SSD constructors and ``ObjectDetector`` are entry points: they build
on ``device`` (``cuda:0`` unless told otherwise, raising with no CUDA;
``device="cpu"`` builds on the CPU).  Their weights exist from
construction (the port's layers draw them when built), so there is no
``init_weights`` step before ``predict``; ``save`` / ``load_model`` write
and read the JAX package's weights file (``utils/serialization.py``).

Quantized serving needs nothing here: ``InferenceModel.do_quantize`` over
``SSDVGG``'s graph ``Model`` quantizes its 35 convolutions, the 30
spatial ones onto ``w8a8_conv2d`` and the 5 pointwise ones onto ``w8a8``
(int8) or ``w4a16`` (int4).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.common.context import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.conv import Convolution2D
from analytics_zoo_tpu_torch.nn.layers.core import (Activation,
                                                    BatchNormalization,
                                                    Reshape, merge)
from analytics_zoo_tpu_torch.nn.layers.pooling import MaxPooling2D
from analytics_zoo_tpu_torch.nn.models import Model
from analytics_zoo_tpu_torch.nn.module import Layer, to_shape

# ---------------------------------------------------------------------------
# bbox utils (BboxUtil parity; boxes are (x1, y1, x2, y2) normalised to [0,1])
# ---------------------------------------------------------------------------


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, 4) x (Nb, 4) -> (Na, Nb) IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.clip(union, 1e-9, None)


def encode_boxes(priors: np.ndarray, boxes: np.ndarray,
                 variances=(0.1, 0.2)) -> np.ndarray:
    """gt boxes -> center-size offsets relative to priors (BboxUtil.encodeBoxes)."""
    pcx = (priors[:, 0] + priors[:, 2]) / 2
    pcy = (priors[:, 1] + priors[:, 3]) / 2
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    gcx = (boxes[:, 0] + boxes[:, 2]) / 2
    gcy = (boxes[:, 1] + boxes[:, 3]) / 2
    gw = np.clip(boxes[:, 2] - boxes[:, 0], 1e-8, None)
    gh = np.clip(boxes[:, 3] - boxes[:, 1], 1e-8, None)
    return np.stack([
        (gcx - pcx) / (pw * variances[0]),
        (gcy - pcy) / (ph * variances[0]),
        np.log(gw / pw) / variances[1],
        np.log(gh / ph) / variances[1]], axis=1).astype(np.float32)


def decode_boxes(priors: np.ndarray, deltas: np.ndarray,
                 variances=(0.1, 0.2)) -> np.ndarray:
    pcx = (priors[:, 0] + priors[:, 2]) / 2
    pcy = (priors[:, 1] + priors[:, 3]) / 2
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    cx = deltas[:, 0] * variances[0] * pw + pcx
    cy = deltas[:, 1] * variances[0] * ph + pcy
    w = np.exp(deltas[:, 2] * variances[1]) * pw
    h = np.exp(deltas[:, 3] * variances[1]) * ph
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        top_k: int = 200) -> np.ndarray:
    """Greedy NMS; returns kept indices (BboxUtil.nms semantics)."""
    order = np.argsort(-scores)[:top_k]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = iou_matrix(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_threshold]
    return np.asarray(keep, np.int64)


def match_priors(priors: np.ndarray, gt_boxes: np.ndarray,
                 gt_labels: np.ndarray, iou_threshold: float = 0.5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Assign each prior a class (0 = background) and encoded loc target
    (MultiBoxLoss matching stage: best-prior-per-gt forced + per-prior threshold)."""
    P = priors.shape[0]
    cls_t = np.zeros((P,), np.int32)
    loc_t = np.zeros((P, 4), np.float32)
    if gt_boxes.shape[0] == 0:
        return cls_t, loc_t
    ious = iou_matrix(priors, gt_boxes)              # (P, G)
    best_gt = ious.argmax(1)
    best_gt_iou = ious.max(1)
    # force-match the best prior for every gt
    best_prior = ious.argmax(0)
    best_gt[best_prior] = np.arange(gt_boxes.shape[0])
    best_gt_iou[best_prior] = 1.0
    pos = best_gt_iou >= iou_threshold
    cls_t[pos] = gt_labels[best_gt[pos]]
    loc_t[pos] = encode_boxes(priors[pos], gt_boxes[best_gt[pos]])
    return cls_t, loc_t


# ---------------------------------------------------------------------------
# prior boxes (PriorBox op parity)
# ---------------------------------------------------------------------------

def generate_priors(feature_sizes: Sequence[int], image_size: int,
                    min_scale: float = 0.2, max_scale: float = 0.9,
                    aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5)
                    ) -> np.ndarray:
    """Dense anchors over len(feature_sizes) scales -> (P, 4) in [0,1]."""
    K = len(feature_sizes)
    scales = [min_scale + (max_scale - min_scale) * k / max(K - 1, 1)
              for k in range(K)]
    priors = []
    for k, fs in enumerate(feature_sizes):
        for i, j in itertools.product(range(fs), repeat=2):
            cx = (j + 0.5) / fs
            cy = (i + 0.5) / fs
            for ar in aspect_ratios:
                w = scales[k] * math.sqrt(ar)
                h = scales[k] / math.sqrt(ar)
                priors.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    return np.clip(np.asarray(priors, np.float32), 0.0, 1.0)


# ---------------------------------------------------------------------------
# SSD network
# ---------------------------------------------------------------------------

def _conv_block(x, filters, name, stride=1):
    x = Convolution2D(filters, 3, subsample=stride, border_mode="same",
                      bias=False, init="he_normal", name=name + "_conv")(x)
    x = BatchNormalization(name=name + "_bn")(x)
    return Activation("relu", name=name + "_act")(x)


class _SSDDetectMixin:
    """Shared target assembly + decode/NMS (requires self.model, self.priors,
    self.class_num)."""

    def encode_targets(self, gt_boxes_list, gt_labels_list) -> np.ndarray:
        """Per-image gt -> dense (B, P, 5) [cls, loc4] targets."""
        out = []
        for boxes, labels in zip(gt_boxes_list, gt_labels_list):
            cls_t, loc_t = match_priors(self.priors, np.asarray(boxes),
                                        np.asarray(labels))
            out.append(np.concatenate([cls_t[:, None].astype(np.float32),
                                       loc_t], axis=1))
        return np.stack(out)

    @torch.no_grad()
    def _loc_probs(self, images: np.ndarray, batch_size: int):
        """The eval forward and the class softmax on the model's device, in
        batches of ``batch_size``; returns host (N, P, 4) box deltas and
        (N, P, classes) probabilities."""
        model = self.model.eval()
        dev = next(model.parameters()).device
        locs, probs = [], []
        for i in range(0, images.shape[0], batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch_size], np.float32)).to(dev)
            loc, conf = model(x)
            locs.append(loc.cpu().numpy())
            probs.append(torch.softmax(conf, dim=-1).cpu().numpy())
        return np.concatenate(locs), np.concatenate(probs)

    def detect(self, images: np.ndarray, score_threshold: float = 0.3,
               iou_threshold: float = 0.45, top_k: int = 100,
               batch_size: int = 32):
        """Returns per-image [(class, score, box(4,))...] after decode + NMS
        (DetectionOutputSSD semantics)."""
        loc, probs = self._loc_probs(images, batch_size)
        results = []
        for b in range(images.shape[0]):
            dets = []
            boxes = decode_boxes(self.priors, loc[b])
            for c in range(1, self.class_num):     # skip background
                sc = probs[b, :, c]
                mask = sc > score_threshold
                if not mask.any():
                    continue
                keep = nms(boxes[mask], sc[mask], iou_threshold, top_k)
                for i in keep:
                    idx = np.where(mask)[0][i]
                    dets.append((c, float(sc[idx]), boxes[idx]))
            results.append(dets)
        return results


class SSD(_SSDDetectMixin):
    """Compact SSD: conv backbone + per-scale loc/conf heads.

    NOT a published architecture — a small fast stand-in for fixtures/CI,
    registered under honest "ssd-compact-*" names; the published SSD-VGG16 is
    `SSDVGG` below.  Outputs [loc (B, P, 4), conf (B, P, classes)];
    `num_anchors` per cell follows the aspect-ratio list.  For parity the
    class count INCLUDES background at index 0.  Its BatchNorms follow
    3x3 convs, so its fusion plan is empty."""

    def __init__(self, class_num: int, image_size: int = 96,
                 aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5),
                 base_filters: int = 32, device: DeviceLike = None):
        self.class_num = int(class_num)
        self.image_size = int(image_size)
        self.aspect_ratios = tuple(aspect_ratios)
        self.base = base_filters
        self.feature_sizes = [image_size // 8, image_size // 16,
                              image_size // 32]
        self.priors = generate_priors(self.feature_sizes, image_size,
                                      aspect_ratios=self.aspect_ratios)
        self.device = resolve_device(device)
        self.model = self._build().to(self.device)

    def _build(self) -> Model:
        A = len(self.aspect_ratios)
        C = self.class_num
        inp = Input(shape=(self.image_size, self.image_size, 3),
                    name="ssd_input")
        x = _conv_block(inp, self.base, "ssd_c1", stride=2)
        x = _conv_block(x, self.base * 2, "ssd_c2", stride=2)
        f1 = _conv_block(x, self.base * 4, "ssd_c3", stride=2)    # /8
        f2 = _conv_block(f1, self.base * 4, "ssd_c4", stride=2)   # /16
        f3 = _conv_block(f2, self.base * 4, "ssd_c5", stride=2)   # /32
        locs, confs = [], []
        for i, f in enumerate([f1, f2, f3]):
            fs = self.feature_sizes[i]
            loc = Convolution2D(A * 4, 3, border_mode="same",
                                name=f"ssd_loc{i}")(f)
            loc = Reshape((fs * fs * A, 4), name=f"ssd_loc{i}_r")(loc)
            conf = Convolution2D(A * C, 3, border_mode="same",
                                 name=f"ssd_conf{i}")(f)
            conf = Reshape((fs * fs * A, C), name=f"ssd_conf{i}_r")(conf)
            locs.append(loc)
            confs.append(conf)
        loc_all = merge(locs, mode="concat", concat_axis=1, name="ssd_loc")
        conf_all = merge(confs, mode="concat", concat_axis=1, name="ssd_conf")
        return Model(input=inp, output=[loc_all, conf_all], name="SSD")


# ---------------------------------------------------------------------------
# SSD-VGG16: the published architecture (SSD.scala:1-214 vgg16 +
# SSDGraph.scala:1-220)
# ---------------------------------------------------------------------------

class NormalizeScale(Layer):
    """Channel-axis L2 normalisation with a learnable per-channel scale
    (init 20) — the conv4_3_norm layer (SSDGraph.scala NormalizeScale,
    `scale = 20f`).  Computes in f32, eps inside the square root; its
    param tree is ``{gamma (C,)}``."""

    def __init__(self, scale: float = 20.0, eps: float = 1e-10,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.scale = float(scale)
        self.eps = float(eps)
        self._build_declared()

    def build(self, input_shape):
        c = to_shape(input_shape)[-1]
        self.gamma = nn.Parameter(torch.full((c,), self.scale,
                                             dtype=dtypes.param_dtype()))

    def reset_parameters(self, gen):
        self.gamma.fill_(self.scale)

    def _tree(self) -> Dict:
        return {"gamma": self.gamma}

    def forward(self, x):
        xf = x.to(torch.float32)
        n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (xf / n * self.gamma).to(x.dtype)


# per-resolution SSD component tables (SSD.scala build: ComponetParam per
# feature layer).  min/max sizes in PIXELS of the input resolution.
_SSD_TABLES = {
    ("pascal", 300): dict(
        sizes=[30, 60, 111, 162, 213, 264, 315],
        feature_sizes=[38, 19, 10, 5, 3, 1],
        steps=[8, 16, 32, 64, 100, 300],
        ars=[(2,), (2, 3), (2, 3), (2, 3), (2,), (2,)]),
    ("coco", 300): dict(
        sizes=[21, 45, 99, 153, 207, 261, 315],
        feature_sizes=[38, 19, 10, 5, 3, 1],
        steps=[8, 16, 32, 64, 100, 300],
        ars=[(2,), (2, 3), (2, 3), (2, 3), (2,), (2,)]),
    ("pascal", 512): dict(
        sizes=[35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6],
        feature_sizes=[64, 32, 16, 8, 4, 2, 1],
        steps=[8, 16, 32, 64, 128, 256, 512],
        ars=[(2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)]),
    ("coco", 512): dict(
        sizes=[20.48, 51.2, 133.12, 215.04, 296.96, 378.88, 460.8, 542.72],
        feature_sizes=[64, 32, 16, 8, 4, 2, 1],
        steps=[8, 16, 32, 64, 128, 256, 512],
        ars=[(2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)]),
}


def caffe_ssd_priors(resolution: int = 300, dataset: str = "pascal",
                     sizes: Optional[Sequence[float]] = None) -> np.ndarray:
    """Caffe-SSD PriorBox layout (PriorBox op semantics; SSDGraph
    getPriorBox): per cell [min@ar1, sqrt(min*max)@ar1, then each ar and its
    flip], centers at (j+0.5)*step, NO clipping.  300 -> 8732 priors,
    512 -> 24564."""
    tab = dict(_SSD_TABLES[(dataset, resolution)])
    if sizes is not None:
        tab["sizes"] = list(sizes)
    out = []
    img = float(resolution)
    for fs, step, ars, k in zip(tab["feature_sizes"], tab["steps"],
                                tab["ars"], range(len(tab["steps"]))):
        s_min = tab["sizes"][k]
        s_max = tab["sizes"][k + 1]
        whs = [(s_min / img, s_min / img),
               (math.sqrt(s_min * s_max) / img,
                math.sqrt(s_min * s_max) / img)]
        for ar in ars:
            r = math.sqrt(ar)
            whs.append((s_min * r / img, s_min / r / img))
            whs.append((s_min / r / img, s_min * r / img))   # flip
        for i, j in itertools.product(range(fs), repeat=2):
            cx = (j + 0.5) * step / img
            cy = (i + 0.5) * step / img
            for w, h in whs:
                out.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    return np.asarray(out, np.float32)


def ssd_num_priors_per_cell(ars: Sequence[float]) -> int:
    return 2 + 2 * len(ars)


# torchvision VGG16 `features.<i>` indices -> caffe/SSD conv names, for
# importing published ImageNet VGG16 weights through the torch ecosystem
# (the reference initialised SSD from pretrained VGG16 the same way).
TORCH_VGG16_FEATURES = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
    "conv5_1": 24, "conv5_2": 26, "conv5_3": 28,
}


class SSDVGG(_SSDDetectMixin):
    """The actual VGG16-SSD (SSD.scala vgg16 + SSDGraph.scala, 300 or 512):
    VGG16 through conv5_3 (explicit caffe padding, ceil-mode pools), pool5
    3x3/s1, dilated fc6 (3x3, dilation 6), 1x1 fc7, conv6-9(-10) extra
    feature layers, conv4_3 L2-NormalizeScale(20), per-scale 3x3 loc/conf
    heads with caffe PriorBox counts (4/6/6/6/4/4 at 300 -> 8732 priors).

    Outputs [loc (B, P, 4), conf (B, P, classes)] for multibox_loss /
    detect().  Weight init is Xavier (the reference's init); pretrained
    ImageNet VGG16 backbone weights import via `load_torch_vgg16_backbone`
    (torchvision state_dict layout, supplied by the caller as a file)."""

    def __init__(self, class_num: int, resolution: int = 300,
                 dataset: str = "pascal",
                 sizes: Optional[Sequence[float]] = None,
                 device: DeviceLike = None):
        if resolution not in (300, 512):
            raise ValueError("SSDVGG supports 300x300 or 512x512 input")
        self.class_num = int(class_num)
        self.image_size = self.resolution = int(resolution)
        self.dataset = dataset
        tab = _SSD_TABLES[(dataset, resolution)]
        self.feature_sizes = tab["feature_sizes"]
        self.n_priors = [ssd_num_priors_per_cell(a) for a in tab["ars"]]
        self.priors = caffe_ssd_priors(resolution, dataset, sizes)
        self.device = resolve_device(device)
        self.model = self._build().to(self.device)

    @staticmethod
    def _conv(x, cout, name, kernel=3, pad=1, stride=1, dilation=1,
              relu=True):
        return Convolution2D(cout, kernel, border_mode=pad, subsample=stride,
                             dilation=dilation,
                             activation="relu" if relu else None,
                             init="glorot_uniform", name=name)(x)

    def _build(self) -> Model:
        C = self.class_num
        res = self.resolution
        cv = self._conv
        inp = Input(shape=(res, res, 3), name="data")
        # VGG16 base (SSD.scala vgg16): 3x3 pad-1 convs, 2x2/s2 ceil pools
        x = cv(inp, 64, "conv1_1")
        x = cv(x, 64, "conv1_2")
        x = MaxPooling2D(2, name="pool1")(x)
        x = cv(x, 128, "conv2_1")
        x = cv(x, 128, "conv2_2")
        x = MaxPooling2D(2, name="pool2")(x)
        x = cv(x, 256, "conv3_1")
        x = cv(x, 256, "conv3_2")
        x = cv(x, 256, "conv3_3")
        # ceil mode: 75 -> 38 at 300 needs a (0,1) pad; even sizes need none
        pool3_pad = ((0, 1), (0, 1)) if res == 300 else None
        x = MaxPooling2D(2, padding=pool3_pad, name="pool3")(x)
        x = cv(x, 512, "conv4_1")
        x = cv(x, 512, "conv4_2")
        relu4_3 = cv(x, 512, "conv4_3")
        x = MaxPooling2D(2, name="pool4")(relu4_3)
        x = cv(x, 512, "conv5_1")
        x = cv(x, 512, "conv5_2")
        x = cv(x, 512, "conv5_3")
        x = MaxPooling2D(3, strides=1, padding=((1, 1), (1, 1)),
                         name="pool5")(x)
        # SSDGraph head: dilated fc6 + 1x1 fc7
        x = cv(x, 1024, "fc6", kernel=3, pad=6, dilation=6)
        fc7 = cv(x, 1024, "fc7", kernel=1, pad=0)
        # extra feature layers
        x = cv(fc7, 256, "conv6_1", kernel=1, pad=0)
        conv6_2 = cv(x, 512, "conv6_2", stride=2)
        x = cv(conv6_2, 128, "conv7_1", kernel=1, pad=0)
        conv7_2 = cv(x, 256, "conv7_2", stride=2)
        x = cv(conv7_2, 128, "conv8_1", kernel=1, pad=0)
        if res == 300:
            conv8_2 = cv(x, 256, "conv8_2", pad=0)
            x = cv(conv8_2, 128, "conv9_1", kernel=1, pad=0)
            conv9_2 = cv(x, 256, "conv9_2", pad=0)
            feats = [None, fc7, conv6_2, conv7_2, conv8_2, conv9_2]
        else:
            conv8_2 = cv(x, 256, "conv8_2", stride=2)
            x = cv(conv8_2, 128, "conv9_1", kernel=1, pad=0)
            conv9_2 = cv(x, 256, "conv9_2", stride=2)
            x = cv(conv9_2, 128, "conv10_1", kernel=1, pad=0)
            conv10_2 = cv(x, 256, "conv10_2", kernel=4, pad=1)
            feats = [None, fc7, conv6_2, conv7_2, conv8_2, conv9_2, conv10_2]
        feats[0] = NormalizeScale(20.0, name="conv4_3_norm")(relu4_3)
        feat_names = (["conv4_3_norm", "fc7", "conv6_2", "conv7_2",
                       "conv8_2", "conv9_2"]
                      + (["conv10_2"] if res == 512 else []))
        locs, confs = [], []
        for f, fname, fs, A in zip(feats, feat_names, self.feature_sizes,
                                   self.n_priors):
            loc = Convolution2D(A * 4, 3, border_mode=1,
                                name=f"{fname}_mbox_loc")(f)
            locs.append(Reshape((fs * fs * A, 4),
                                name=f"{fname}_mbox_loc_flat")(loc))
            conf = Convolution2D(A * C, 3, border_mode=1,
                                 name=f"{fname}_mbox_conf")(f)
            confs.append(Reshape((fs * fs * A, C),
                                 name=f"{fname}_mbox_conf_flat")(conf))
        loc_all = merge(locs, mode="concat", concat_axis=1, name="mbox_loc")
        conf_all = merge(confs, mode="concat", concat_axis=1,
                         name="mbox_conf")
        return Model(input=inp, output=[loc_all, conf_all],
                     name=f"SSDVGG{res}")

    @torch.no_grad()
    def load_torch_vgg16_backbone(self, state_dict) -> "SSDVGG":
        """Import published ImageNet VGG16 conv weights (torchvision
        `vgg16().features` state_dict layout: 'features.<i>.weight' OIHW
        torch tensors or numpy arrays) into conv1_1..conv5_3, transposed
        to HWIO.  SSD-specific layers keep their Xavier init — the
        reference's finetune story
        (examples/objectdetection/finetune/ssd/Train.scala)."""
        layers = {layer.name: layer for layer in self.model.graph_layers}

        def put(dst, src):
            src = src.detach().cpu() if isinstance(src, torch.Tensor) \
                else torch.from_numpy(np.asarray(src))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        for name, idx in TORCH_VGG16_FEATURES.items():
            w = state_dict[f"features.{idx}.weight"]
            w = w.permute(2, 3, 1, 0) if isinstance(w, torch.Tensor) \
                else np.asarray(w).transpose(2, 3, 1, 0)
            put(layers[name].W, w)
            put(layers[name].b, state_dict[f"features.{idx}.bias"])
        return self


def multibox_loss(y_pred, y_true, *, class_num: int,
                  neg_pos_ratio: float = 3.0, loc_weight: float = 1.0):
    """MultiBoxLoss (smooth-L1 + CE with hard negative mining) as a per-sample
    loss usable by the Estimator.  y_pred = [loc (B,P,4), conf (B,P,C)];
    y_true = (B, P, 5) [cls, loc4].  Negatives are ranked by a stable sort,
    as ``jnp.argsort`` ranks them: among equal CE the lower prior index
    is kept first."""
    loc_pred, conf_pred = y_pred
    cls_t = y_true[..., 0].to(torch.int64)             # (B, P)
    loc_t = y_true[..., 1:]
    pos = (cls_t > 0).to(torch.float32)
    n_pos = torch.clamp_min(pos.sum(dim=1), 1.0)

    # smooth L1 on positives
    diff = torch.abs(loc_pred - loc_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    loc_loss = (sl1 * pos).sum(dim=1) / n_pos

    # CE with hard negative mining
    logp = torch.log_softmax(conf_pred, dim=-1)
    ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]  # (B, P)
    neg_ce = torch.where(pos > 0, -math.inf, ce.detach())
    n_neg = torch.minimum(neg_pos_ratio * n_pos,
                          (1 - pos).sum(dim=1)).to(torch.int32)
    # rank negatives: a negative is kept if its ce is within the top n_neg
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order).contiguous())
    neg_keep = (ranks < n_neg[:, None]).to(torch.float32) * (1 - pos)
    conf_loss = ((ce * pos).sum(dim=1)
                 + (ce * neg_keep).sum(dim=1)) / n_pos
    return loc_weight * loc_loss + conf_loss


# ---------------------------------------------------------------------------
# mAP evaluation (EvalUtil / PascalVocEvaluator parity)
# ---------------------------------------------------------------------------

def _precision_recall(detections, ground_truths, class_id: int,
                      iou_threshold: float):
    """Greedy IoU matching -> (precision, recall) curves for one class.

    ground_truths entries are (boxes, labels) or (boxes, labels, difficult);
    VOC protocol: difficult boxes are excluded from the GT count and
    detections matching them are ignored (neither TP nor FP)."""
    scores, matches, ignored = [], [], []
    total_gt = 0
    for dets, gt in zip(detections, ground_truths):
        gt_boxes, gt_labels = gt[0], gt[1]
        difficult = (np.asarray(gt[2]) if len(gt) > 2
                     else np.zeros(len(gt_labels), np.int64))
        gt_mask = np.asarray(gt_labels) == class_id
        boxes = np.asarray(gt_boxes)[gt_mask]
        diff = difficult[gt_mask].astype(bool)
        total_gt += int((~diff).sum())
        used = np.zeros(boxes.shape[0], bool)
        for (c, sc, box) in sorted([d for d in dets if d[0] == class_id],
                                   key=lambda d: -d[1]):
            scores.append(sc)
            if boxes.shape[0] == 0:
                matches.append(0)
                ignored.append(False)
                continue
            ious = iou_matrix(box[None], boxes)[0]
            j = ious.argmax()
            if ious[j] >= iou_threshold and diff[j]:
                matches.append(0)
                ignored.append(True)          # matched a difficult box
            elif ious[j] >= iou_threshold and not used[j]:
                used[j] = True
                matches.append(1)
                ignored.append(False)
            else:
                matches.append(0)
                ignored.append(False)
    if total_gt == 0 or not scores:
        return None
    order = np.argsort(-np.asarray(scores))
    keep = ~np.asarray(ignored)[order]
    tp = np.asarray(matches)[order][keep]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1 - tp)
    recall = tp_cum / total_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return precision, recall


def average_precision(detections, ground_truths, class_id: int,
                      iou_threshold: float = 0.5) -> float:
    """detections: per-image [(cls, score, box)]; ground_truths: per-image
    (boxes (G,4), labels (G,)[, difficult (G,)]).  VOC-style AP
    (all-point interpolation)."""
    pr = _precision_recall(detections, ground_truths, class_id, iou_threshold)
    if pr is None:
        return 0.0
    precision, recall = pr
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        mask = recall >= r
        ap += precision[mask].max() if mask.any() else 0.0
    return float(ap / 101)


def mean_average_precision(detections, ground_truths, num_classes: int,
                           iou_threshold: float = 0.5) -> float:
    aps = [average_precision(detections, ground_truths, c, iou_threshold)
           for c in range(1, num_classes)]
    return float(np.mean(aps)) if aps else 0.0


def average_precision_07(detections, ground_truths, class_id: int,
                         iou_threshold: float = 0.5) -> float:
    """VOC2007 11-point interpolated AP (EvalUtil.scala use_07_metric path);
    shares the matching/PR computation with average_precision."""
    pr = _precision_recall(detections, ground_truths, class_id, iou_threshold)
    if pr is None:
        return 0.0
    precision, recall = pr
    ap = 0.0
    for r in np.arange(0.0, 1.1, 0.1):
        mask = recall >= r
        ap += precision[mask].max() if mask.any() else 0.0
    return float(ap / 11.0)


# -- dataset plumbing (models/.../common/dataset parity) ----------------------

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def parse_voc_annotation(xml_path: str,
                         class_to_id: Optional[Dict[str, int]] = None):
    """Pascal VOC XML -> (boxes (G,4) [xmin,ymin,xmax,ymax] normalized,
    labels (G,) 1-based, is_difficult (G,)) (PascalVoc.scala parity)."""
    import xml.etree.ElementTree as ET
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    W = float(size.find("width").text)
    H = float(size.find("height").text)
    c2i = class_to_id or {c: i + 1 for i, c in enumerate(VOC_CLASSES)}
    boxes, labels, difficult = [], [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.strip()
        if name not in c2i:
            continue
        bb = obj.find("bndbox")
        boxes.append([float(bb.find("xmin").text) / W,
                      float(bb.find("ymin").text) / H,
                      float(bb.find("xmax").text) / W,
                      float(bb.find("ymax").text) / H])
        labels.append(c2i[name])
        d = obj.find("difficult")
        difficult.append(int(d.text) if d is not None else 0)
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64),
            np.asarray(difficult, np.int64))


def load_coco_annotations(json_path: str):
    """COCO instances json -> {image_id: (boxes normalized, labels)}
    (Coco.scala parity; category ids remapped densely 1..K)."""
    import json as _json
    with open(json_path) as f:
        coco = _json.load(f)
    dims = {im["id"]: (float(im["width"]), float(im["height"]))
            for im in coco["images"]}
    cats = sorted(c["id"] for c in coco.get("categories", []))
    remap = {cid: i + 1 for i, cid in enumerate(cats)}
    out: Dict[int, list] = {im_id: ([], []) for im_id in dims}
    for ann in coco["annotations"]:
        W, H = dims[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        out[ann["image_id"]][0].append(
            [x / W, y / H, (x + w) / W, (y + h) / H])
        out[ann["image_id"]][1].append(remap.get(ann["category_id"],
                                                 ann["category_id"]))
    return {k: (np.asarray(b, np.float32).reshape(-1, 4),
                np.asarray(l, np.int64)) for k, (b, l) in out.items()}


class PascalVocEvaluator:
    """mAP evaluator with the VOC2007 (11-point) / VOC2012 (all-point)
    protocols (common/evaluation/EvalUtil.scala:1-223,
    PascalVocEvaluator parity).  ``num_classes`` counts the background:
    classes 1 .. num_classes - 1 are scored."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False):
        self.num_classes = int(num_classes)
        self.iou = float(iou_threshold)
        self.use_07 = bool(use_07_metric)

    def evaluate(self, detections, ground_truths) -> Dict[str, float]:
        ap_fn = average_precision_07 if self.use_07 else average_precision
        aps = {c: ap_fn(detections, ground_truths, c, self.iou)
               for c in range(1, self.num_classes)}
        aps["mAP"] = float(np.mean(list(aps.values()))) if aps else 0.0
        return aps


# -- pretrained config registry (ObjectDetectionConfig.scala:1-176) -----------

class ObjectDetectionConfig:
    """Per-model-name architecture + preprocessing registry
    (ObjectDetectionConfig.scala:1-176).  The VGG names resolve to the
    published architecture (`SSDVGG`, arch="vgg16"); weights load from the
    zoo save_weights format or a torchvision VGG16 state_dict (backbone).
    Compact stand-in backbones are registered under honest "ssd-compact-*"
    names, never under a published model's name."""

    _REGISTRY: Dict[str, Dict] = {}

    @classmethod
    def register(cls, name: str, *, class_num: int, image_size: int,
                 arch: str = "compact", dataset: str = "pascal",
                 aspect_ratios=(1.0, 2.0, 0.5), base_filters: int = 32,
                 mean=(123.0, 117.0, 104.0), scale: float = 1.0,
                 label_map=None):
        cls._REGISTRY[name] = dict(
            class_num=class_num, image_size=image_size, arch=arch,
            dataset=dataset,
            aspect_ratios=tuple(aspect_ratios), base_filters=base_filters,
            mean=tuple(mean), scale=scale, label_map=label_map)

    @classmethod
    def get(cls, name: str) -> Dict:
        if name not in cls._REGISTRY:
            raise KeyError(
                f"unknown object-detection model {name!r}; registered: "
                f"{sorted(cls._REGISTRY)}")
        return dict(cls._REGISTRY[name])


_VOC_LABELS = ("__background__",) + VOC_CLASSES
for _name, _cfg in {
    # published architectures (SSDVGG)
    "ssd-vgg16-300x300": dict(class_num=21, image_size=300, arch="vgg16",
                              label_map=_VOC_LABELS),
    "ssd-vgg16-512x512": dict(class_num=21, image_size=512, arch="vgg16",
                              label_map=_VOC_LABELS),
    "ssd-vgg16-300x300-coco": dict(class_num=81, image_size=300,
                                   arch="vgg16", dataset="coco"),
    "ssd-vgg16-512x512-coco": dict(class_num=81, image_size=512,
                                   arch="vgg16", dataset="coco"),
    # compact stand-ins (not published models; a small fast backbone for
    # fixtures and CI)
    "ssd-compact-288x288": dict(class_num=21, image_size=288,
                                label_map=_VOC_LABELS),
    "ssd-compact-small-288x288": dict(class_num=21, image_size=288,
                                      base_filters=16,
                                      label_map=_VOC_LABELS),
}.items():
    ObjectDetectionConfig.register(_name, **_cfg)


class ObjectDetector:
    """Detection facade (ObjectDetector.scala / ImageModel.doPredictImage):
    config-by-name, predict over ImageSets, decode + NMS postprocessing.
    The model lives on ``device`` (``cuda:0`` unless told otherwise)."""

    def __init__(self, model_name: str = "ssd-vgg16-300x300",
                 weights_path: Optional[str] = None,
                 device: DeviceLike = None):
        cfg = ObjectDetectionConfig.get(model_name)
        self.cfg = cfg
        if cfg["arch"] == "vgg16":
            self.ssd = SSDVGG(cfg["class_num"], resolution=cfg["image_size"],
                              dataset=cfg["dataset"], device=device)
        else:
            self.ssd = SSD(cfg["class_num"], image_size=cfg["image_size"],
                           aspect_ratios=cfg["aspect_ratios"],
                           base_filters=cfg["base_filters"], device=device)
        self.device = self.ssd.device
        self.label_map = cfg.get("label_map")
        if weights_path:
            self.ssd.model.load_weights(weights_path)

    def save(self, path: str):
        self.ssd.model.save_weights(path)

    @staticmethod
    def load_model(model_name: str, weights_path: str,
                   device: DeviceLike = None) -> "ObjectDetector":
        return ObjectDetector(model_name, weights_path, device=device)

    def _preprocess(self, images: np.ndarray) -> np.ndarray:
        x = np.asarray(images, np.float32)
        return (x - np.asarray(self.cfg["mean"], np.float32)) \
            * self.cfg["scale"]

    def predict_image_set(self, image_set, score_threshold: float = 0.3,
                          iou_threshold: float = 0.45, top_k: int = 100):
        """ImageSet -> per-image [(class_id, score, box)] detections."""
        import cv2
        s = self.cfg["image_size"]
        imgs = np.stack([cv2.resize(np.asarray(f.image, np.float32), (s, s))
                         for f in image_set.features])
        return self.predict(imgs, score_threshold=score_threshold,
                            iou_threshold=iou_threshold, top_k=top_k)

    def predict(self, images: np.ndarray, score_threshold: float = 0.3,
                iou_threshold: float = 0.45, top_k: int = 100):
        x = self._preprocess(images)
        return self.ssd.detect(x, score_threshold=score_threshold,
                               iou_threshold=iou_threshold, top_k=top_k)
