"""Image classification zoo: the ResNet family, the per-model
preprocessing registry and the ``ImageClassifier`` façade — the JAX
package's ``models/imageclassification.py``.

The graphs are the JAX package's ResNet-v1.5, node for node and name for
name (``<name>_s<stage>b<block>_<1|2|3|down>_{conv,bn,act}``), so its
param and state trees load as they are (``KerasNet.set_weights``):
NHWC, every conv bias-free with a BatchNormalization after it (eps 1e-3,
momentum 0.99), SAME padding (asymmetric at stride 2) or, with
``padding="torch"``, torchvision's symmetric padding and eps 1e-5 for
exact import of torchvision weights (``load_torch_resnet``).

In training, each bottleneck's ``_1`` and ``_3`` 1×1 convs and a
stride-1 downsample run with their BatchNorm through the fused
conv + BN-statistics kernel (the graph ``Model``'s fusion plan): 33 pairs
in ResNet-50.  ``ImageClassifier.predict_image_set`` runs an ``ImageSet``
through the model's preprocessing (``feature/image``; by default resize
256 → center crop 224 → subtract the BGR means) and returns the top-k
classes.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.feature.common import ChainedPreprocessing
from analytics_zoo_tpu_torch.feature.image import (ImageCenterCrop,
                                                   ImageChannelNormalize,
                                                   ImageResize)
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn.graph import Input, SymTensor
from analytics_zoo_tpu_torch.nn.layers.conv import (Convolution2D,
                                                    SpaceToDepth,
                                                    stem_7x7_to_s2d)
from analytics_zoo_tpu_torch.nn.layers.core import (Activation,
                                                    BatchNormalization,
                                                    Dense, merge)
from analytics_zoo_tpu_torch.nn.layers.pooling import (GlobalAveragePooling2D,
                                                       MaxPooling2D)
from analytics_zoo_tpu_torch.nn.models import Model


def _conv_bn(x: SymTensor, filters: int, kernel: int, stride: int, name: str,
             activation: Optional[str] = "relu", border_mode="same",
             bn_eps: float = 1e-3):
    x = Convolution2D(filters, kernel, subsample=stride,
                      border_mode=border_mode, bias=False, init="he_normal",
                      name=name + "_conv")(x)
    x = BatchNormalization(epsilon=bn_eps, name=name + "_bn")(x)
    if activation:
        x = Activation(activation, name=name + "_act")(x)
    return x


def _bottleneck(x: SymTensor, filters: int, stride: int, name: str,
                downsample: bool, pad3="same", bn_eps: float = 1e-3):
    shortcut = x
    if downsample:
        shortcut = _conv_bn(x, filters * 4, 1, stride, name + "_down",
                            activation=None, bn_eps=bn_eps)
    h = _conv_bn(x, filters, 1, 1, name + "_1", bn_eps=bn_eps)
    h = _conv_bn(h, filters, 3, stride, name + "_2", border_mode=pad3,
                 bn_eps=bn_eps)
    h = _conv_bn(h, filters * 4, 1, 1, name + "_3", activation=None,
                 bn_eps=bn_eps)
    out = merge([h, shortcut], mode="sum", name=name + "_add")
    return Activation("relu", name=name + "_out")(out)


def _basic_block(x: SymTensor, filters: int, stride: int, name: str,
                 downsample: bool, pad3="same", bn_eps: float = 1e-3):
    shortcut = x
    if downsample:
        shortcut = _conv_bn(x, filters, 1, stride, name + "_down",
                            activation=None, bn_eps=bn_eps)
    h = _conv_bn(x, filters, 3, stride, name + "_1", border_mode=pad3,
                 bn_eps=bn_eps)
    h = _conv_bn(h, filters, 3, 1, name + "_2", activation=None,
                 border_mode=pad3, bn_eps=bn_eps)
    out = merge([h, shortcut], mode="sum", name=name + "_add")
    return Activation("relu", name=name + "_out")(out)


_RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def resnet(depth: int = 50, num_classes: int = 1000,
           input_shape: Tuple[int, int, int] = (224, 224, 3),
           include_top: bool = True, stem: str = "imagenet",
           padding: str = "same", name: Optional[str] = None) -> Model:
    """ResNet-v1.5 graph (built on the host; move it with ``.to``).
    ``stem="cifar"``: a 3×3 stem, no max-pool; ``stem="s2d"``:
    SpaceToDepth(2) + a 4×4/s1 conv, equivalent to the 7×7/s2 stem through
    ``stem_7x7_to_s2d``.  ``padding="torch"``: torchvision's symmetric
    padding (stem conv 3, stem pool 1, 3×3 convs 1) and BN eps 1e-5, for
    exact import of torchvision weights; only with the "imagenet" stem."""
    kind, blocks = _RESNET_SPECS[depth]
    block_fn = _bottleneck if kind == "bottleneck" else _basic_block
    name = name or f"resnet{depth}"
    torch_pad = padding == "torch"
    if torch_pad and stem == "s2d":
        raise ValueError("padding='torch' requires stem='imagenet' "
                         "(s2d stem equivalence is defined in SAME alignment)")
    pad3 = 1 if torch_pad else "same"
    bn_eps = 1e-5 if torch_pad else 1e-3
    inp = Input(shape=input_shape, name=name + "_input")
    if stem == "imagenet":
        x = _conv_bn(inp, 64, 7, 2, name + "_stem",
                     border_mode=3 if torch_pad else "same", bn_eps=bn_eps)
        x = MaxPooling2D(3, strides=2,
                         **({"padding": ((1, 1), (1, 1))} if torch_pad
                            else {"border_mode": "same"}),
                         name=name + "_stem_pool")(x)
    elif stem == "s2d":
        x = SpaceToDepth(2, name=name + "_stem_s2d")(inp)
        x = _conv_bn(x, 64, 4, 1, name + "_stem")
        x = MaxPooling2D(3, strides=2, border_mode="same",
                         name=name + "_stem_pool")(x)
    else:
        x = _conv_bn(inp, 64, 3, 1, name + "_stem")
    filters = 64
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            x = block_fn(x, filters, stride, f"{name}_s{stage}b{b}",
                         downsample=(b == 0), pad3=pad3, bn_eps=bn_eps)
        filters *= 2
    if include_top:
        x = GlobalAveragePooling2D(name=name + "_gap")(x)
        x = Dense(num_classes, activation="softmax", name=name + "_fc")(x)
    return Model(input=inp, output=x, name=name)


def _resnet_depth(model_name: str) -> int:
    """Depth from a model name: short names ("resnet50") and the
    reference's registry names ("analytics-zoo_resnet-50_imagenet_0.1.0");
    ResNet variants (wide, ResNeXt) and unknown depths raise."""
    lower = model_name.lower()
    if "resnext" in lower or "wide_resnet" in lower or "wide-resnet" in lower:
        raise ValueError(
            f"{model_name!r} is a ResNet VARIANT; only plain ResNet-v1.5 "
            f"depths {sorted(_RESNET_SPECS)} are supported")
    m = re.search(r"resnet[-_]?(\d+)", lower)
    depth = int(m.group(1)) if m else None
    if depth not in _RESNET_SPECS:
        raise ValueError(
            f"cannot resolve a supported ResNet depth from {model_name!r}; "
            f"supported depths: {sorted(_RESNET_SPECS)}")
    return depth


class ImageClassificationConfig:
    """Per-model preprocessing registry (ImageClassificationConfig.scala)."""

    _REGISTRY: Dict[str, ChainedPreprocessing] = {}

    @classmethod
    def register(cls, model_name: str, preprocessing):
        cls._REGISTRY[model_name] = preprocessing

    @classmethod
    def preprocessing(cls, model_name: str):
        if model_name in cls._REGISTRY:
            return cls._REGISTRY[model_name]
        # imagenet default: resize-256 -> center-crop-224 -> mean-subtract
        return (ImageResize(256, 256)
                >> ImageCenterCrop(224, 224)
                >> ImageChannelNormalize(103.939, 116.779, 123.68))


def _as_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.asarray(v))


@torch.no_grad()
def load_torch_resnet(model: Model, state_dict, *, name: str = "resnet50",
                      blocks: Sequence[int] = (3, 4, 6, 3),
                      stem: str = "imagenet", bn_eps: float = 1e-5) -> Model:
    """Import a torchvision-layout ResNet state_dict (OIHW convs, fc
    (out, in); tensors or numpy arrays) into a ``resnet()`` graph in
    place, bottleneck or basic.  ``stem="s2d"`` maps the 7×7 stem through
    ``stem_7x7_to_s2d``.  A basic-block first stage, where torchvision has
    an identity shortcut and the graph a projection, gets the exact
    identity (W = I, gamma 1, beta 0, mean 0, var 1 - eps)."""
    layers = {layer.name: layer for layer in model.graph_layers}

    def put(dst: torch.Tensor, src) -> None:
        src = _as_tensor(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    def put_conv(lname, key):
        w = _as_tensor(state_dict[key + ".weight"]).permute(2, 3, 1, 0)
        if lname == f"{name}_stem_conv" and stem == "s2d":
            w = stem_7x7_to_s2d(w)
        put(layers[lname].W, w)

    def put_bn(lname, key):
        bn = layers[lname]
        put(bn.gamma, state_dict[key + ".weight"])
        put(bn.beta, state_dict[key + ".bias"])
        put(bn.mean, state_dict[key + ".running_mean"])
        put(bn.var, state_dict[key + ".running_var"])

    put_conv(f"{name}_stem_conv", "conv1")
    put_bn(f"{name}_stem_bn", "bn1")
    n_convs = 3 if "layer1.0.conv3.weight" in state_dict else 2
    for st, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            pre = f"layer{st + 1}.{b}"
            base = f"{name}_s{st}b{b}"
            for ci in range(1, n_convs + 1):
                put_conv(f"{base}_{ci}_conv", f"{pre}.conv{ci}")
                put_bn(f"{base}_{ci}_bn", f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in state_dict:
                put_conv(f"{base}_down_conv", f"{pre}.downsample.0")
                put_bn(f"{base}_down_bn", f"{pre}.downsample.1")
            elif f"{base}_down_conv" in layers:
                conv, bn = layers[f"{base}_down_conv"], layers[f"{base}_down_bn"]
                c = conv.W.shape[-1]
                conv.W.zero_()
                conv.W[0, 0].copy_(torch.eye(c))
                bn.gamma.fill_(1.0)
                bn.beta.zero_()
                bn.mean.zero_()
                # BN divides by sqrt(var + eps): cancel it exactly
                bn.var.fill_(1.0 - bn_eps)
    if "fc.weight" in state_dict and f"{name}_fc" in layers:
        put(layers[f"{name}_fc"].W, _as_tensor(state_dict["fc.weight"]).t())
        put(layers[f"{name}_fc"].b, state_dict["fc.bias"])
    return model


class ImageClassifier(ZooModel):
    """Façade over a ResNet graph, its preprocessing and predict over
    ImageSets (ImageClassifier.scala:28, ImageModel.doPredictImage):
    ``ImageClassifier("resnet50").model`` is ``resnet(50, 1000, (224, 224,
    3))`` on ``device`` (``cuda:0`` unless told otherwise)."""

    def __init__(self, model_name: str = "resnet50", num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 stem: str = "imagenet", padding: str = "same",
                 device: DeviceLike = None):
        self.model_name = model_name
        self.num_classes = num_classes
        self.input_shape = tuple(input_shape)
        self.stem = stem
        self.padding = padding
        super().__init__(device)
        self.preprocessor = ImageClassificationConfig.preprocessing(
            model_name)

    def build_model(self) -> Model:
        depth = _resnet_depth(self.model_name)
        return resnet(depth, self.num_classes, self.input_shape,
                      stem=self.stem, padding=self.padding,
                      name=self.model_name)

    def load_torch_state_dict(self, state_dict) -> "ImageClassifier":
        """Import torchvision-layout ResNet weights.  Construct with
        ``padding="torch"`` for exact (torch-aligned) inference: SAME pads
        strided convs (0, 1) where torch pads (1, 1)."""
        if self.padding != "torch":
            import warnings
            warnings.warn(
                "importing torch weights into a SAME-padded graph: strided "
                "convs pad (0,1) where torch pads (1,1) — construct "
                "ImageClassifier(..., padding='torch') for exact parity",
                stacklevel=2)
        depth = _resnet_depth(self.model_name)
        load_torch_resnet(self.model, state_dict, name=self.model_name,
                          blocks=_RESNET_SPECS[depth][1], stem=self.stem,
                          bn_eps=1e-5 if self.padding == "torch" else 1e-3)
        return self

    def predict_image_set(self, image_set, batch_size: int = 32,
                          top_k: int = 5):
        """Preprocess + forward an ImageSet; returns (top-k class ids,
        probs)."""
        processed = image_set.transform(self.preprocessor)
        fs = processed.to_feature_set()
        probs = self.predict(fs.xs[0], batch_size=batch_size)
        idx = np.argsort(-probs, axis=-1)[:, :top_k]
        return idx, np.take_along_axis(probs, idx, axis=-1)
