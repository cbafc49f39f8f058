"""PyTorch port: object detection against the JAX package, on the CPU.

``analytics_zoo_tpu_torch.models.objectdetection`` against
``analytics_zoo_tpu.models.objectdetection`` on the same numpy inputs:

- the host code, exactly: IoU, box encoding and decoding, NMS, prior
  matching, the dense and the caffe priors (8732 at 300, 24564 at 512),
  the tables, AP (all-point and VOC07 11-point), mAP and the evaluator,
  VOC XML and COCO JSON parsing, the registry;
- ``multibox_loss`` value and gradients within LOSS_TOL (1e-5), on a
  random batch, on a batch whose negatives tie in their CE (the stable
  sort of the hard-negative ranking decides which are kept, and the
  gradients show it) and on a batch with no positive;
- the compact ``SSD`` (64x64, ``base_filters=8``): its empty fusion plan
  (its BNs follow 3x3 convs), the eval forward (FORWARD_TOL, 1e-5), the
  losses of 4 ``Estimator.fit`` steps of Adam from the same weights and
  shuffle seed (FIT_TOL, 1e-4: BN in training, f32 in other summation
  orders), then ``detect``: the same classes in the same order, scores
  within DETECT_TOL (1e-5), boxes within DETECT_TOL of their largest
  coordinate (``_same_detections``);
- ``SSDVGG`` at 300 and 512: structure, priors and parameter counts
  (24,013,232 with 4 classes at 300; 26,285,486 for the
  ``ssd-vgg16-300x300`` facade), one batch-1 forward at 300 from the
  same weights (VGG_TOL: atol 1e-4 of the output's largest magnitude,
  rtol 1e-4), the torchvision VGG16 backbone import;
- the JAX weights file into ``ObjectDetector.load_model`` and back, each
  leaf exactly, and ``predict_image_set`` on both sides;
- a quantized compact SSD: the quantizer's targets and int8 / int4
  leaves exactly (each calibrated ``s_x`` past the first conv within
  rtol 1e-5: the activations are f32 sums in other orders), and the JAX
  quantized tree served by the port within PROB_TOL (1e-5);
- ``chip_smoke.py`` phase 16's host logic at a tiny size.
"""

import copy
import functools
import json

import cv2

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.feature.image import ImageSet as JaxImageSet
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.models import objectdetection as jod
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.common.context import (ZooConf, ZooContext,
                                                    init_context)
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.feature.image import ImageSet
from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import objectdetection as tod
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.utils.convert import export_params, export_state
from torch_layer_parity import f32_policy, flat, to_np, tree_np

torch.set_num_threads(4)

pytestmark = pytest.mark.timeout(600)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
FORWARD_TOL = dict(atol=1e-5, rtol=1e-5)
FIT_TOL = 1e-4
DETECT_TOL = 1e-5
VGG_TOL = (1e-4, 1e-4)
PROB_TOL = 1e-5
COMPACT = dict(class_num=4, image_size=64, base_filters=8)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    with f32_policy():
        yield


def _boxes(g, n):
    xy = g.uniform(0, 0.7, (n, 2))
    wh = g.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- host code ---------------------------------------------------------------

def test_box_utilities_match_jax():
    g = np.random.default_rng(0)
    a, b = _boxes(g, 37), _boxes(g, 11)
    assert np.array_equal(tod.iou_matrix(a, b), jod.iou_matrix(a, b))
    priors = tod.generate_priors([4, 2], 64)
    gt = _boxes(g, len(priors))
    enc = tod.encode_boxes(priors, gt)
    assert np.array_equal(enc, jod.encode_boxes(priors, gt))
    assert np.array_equal(tod.encode_boxes(priors, gt, (0.2, 0.1)),
                          jod.encode_boxes(priors, gt, (0.2, 0.1)))
    deltas = g.normal(size=enc.shape).astype(np.float32)
    assert np.array_equal(tod.decode_boxes(priors, deltas),
                          jod.decode_boxes(priors, deltas))
    np.testing.assert_allclose(tod.decode_boxes(priors, enc), gt,
                               atol=1e-5)
    boxes = _boxes(g, 300)
    scores = g.uniform(size=300).astype(np.float32)
    scores[10:20] = scores[5]                     # tied scores
    for thr, k in ((0.45, 200), (0.3, 50), (0.7, 400)):
        got = tod.nms(boxes, scores, thr, k)
        assert got.dtype == np.int64
        assert np.array_equal(got, jod.nms(boxes, scores, thr, k))


def test_match_priors_match_jax():
    g = np.random.default_rng(1)
    priors = tod.caffe_ssd_priors(300)
    for n in (0, 1, 3, 7):
        gt = _boxes(g, n)
        labels = g.integers(1, 21, n)
        got = tod.match_priors(priors, gt, labels)
        want = jod.match_priors(priors, gt, labels)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    ssd = tod.SSD(**COMPACT, device="cpu")
    jssd = jod.SSD(**COMPACT)
    gts = [_boxes(g, k) for k in (2, 0, 1)]
    labels = [g.integers(1, 4, len(b)) for b in gts]
    assert np.array_equal(ssd.encode_targets(gts, labels),
                          jssd.encode_targets(gts, labels))


def test_priors_and_tables_match_jax():
    for fs, size, ars in (([8, 4, 2], 64, (1.0, 2.0, 0.5)),
                          ([9, 5], 96, (1.0, 3.0)), ([1], 32, (1.0,))):
        assert np.array_equal(tod.generate_priors(fs, size,
                                                  aspect_ratios=ars),
                              jod.generate_priors(fs, size,
                                                  aspect_ratios=ars))
    counts = {300: 8732, 512: 24564}
    for res in (300, 512):
        for dataset in ("pascal", "coco"):
            got = tod.caffe_ssd_priors(res, dataset)
            assert got.shape == (counts[res], 4)
            assert np.array_equal(got, jod.caffe_ssd_priors(res, dataset))
    sizes = [20, 50, 100, 150, 200, 250, 300]
    assert np.array_equal(tod.caffe_ssd_priors(300, sizes=sizes),
                          jod.caffe_ssd_priors(300, sizes=sizes))
    assert tod._SSD_TABLES == jod._SSD_TABLES
    assert tod.TORCH_VGG16_FEATURES == jod.TORCH_VGG16_FEATURES
    assert tod.VOC_CLASSES == jod.VOC_CLASSES
    for ars in ((2,), (2, 3)):
        assert tod.ssd_num_priors_per_cell(ars) == \
            jod.ssd_num_priors_per_cell(ars)
    assert tod.ObjectDetectionConfig._REGISTRY == \
        jod.ObjectDetectionConfig._REGISTRY
    assert len(tod.ObjectDetectionConfig._REGISTRY) == 6
    with pytest.raises(KeyError, match="unknown object-detection model"):
        tod.ObjectDetectionConfig.get("ssd-mobilenet-300x300")


def _detections(g, n_img, classes):
    dets = []
    for _ in range(n_img):
        k = int(g.integers(0, 12))
        dets.append([(int(g.integers(1, classes)),
                      float(np.round(g.uniform(), 2)), b)
                     for b in _boxes(g, k)])
    return dets


def _ground_truths(g, n_img, classes, difficult):
    out = []
    for _ in range(n_img):
        k = int(g.integers(0, 5))
        gt = (_boxes(g, k), g.integers(1, classes, k))
        out.append(gt + ((g.integers(0, 2, k),) if difficult else ()))
    return out


@pytest.mark.parametrize("difficult", [False, True])
def test_average_precision_and_map_match_jax(difficult):
    """Seeded detections (scores rounded to 0.01, so many tie) and
    ground truths, some detections moved onto a ground-truth box: each
    class's AP on both protocols, mAP and the evaluator, exactly."""
    g = np.random.default_rng(2 + difficult)
    classes = 5
    gts = _ground_truths(g, 24, classes, difficult)
    dets = _detections(g, 24, classes)
    for d, gt in zip(dets, gts):
        for j, (box, lab) in enumerate(zip(gt[0], gt[1])):
            if j % 2 == 0:
                d.append((int(lab), float(np.round(g.uniform(), 2)),
                          box + g.normal(0, 0.01, 4).astype(np.float32)))
    for c in range(1, classes + 1):
        for thr in (0.5, 0.3):
            assert tod.average_precision(dets, gts, c, thr) == \
                jod.average_precision(dets, gts, c, thr)
            assert tod.average_precision_07(dets, gts, c, thr) == \
                jod.average_precision_07(dets, gts, c, thr)
    got = tod.mean_average_precision(dets, gts, classes)
    assert got == jod.mean_average_precision(dets, gts, classes) and got > 0
    for use07 in (True, False):
        for n in (classes, classes + 1):
            assert tod.PascalVocEvaluator(n, use_07_metric=use07).evaluate(
                dets, gts) == jod.PascalVocEvaluator(
                    n, use_07_metric=use07).evaluate(dets, gts)


def test_voc_and_coco_parsing_match_jax(tmp_path):
    xml = tmp_path / "000001.xml"
    xml.write_text("""<annotation><size><width>500</width>
<height>375</height><depth>3</depth></size>
<object><name>dog</name><difficult>0</difficult><bndbox><xmin>48</xmin>
<ymin>240</ymin><xmax>195</xmax><ymax>371</ymax></bndbox></object>
<object><name> person </name><difficult>1</difficult><bndbox>
<xmin>8</xmin><ymin>12</ymin><xmax>352</xmax><ymax>498</ymax></bndbox>
</object>
<object><name>unicorn</name><bndbox><xmin>1</xmin><ymin>2</ymin>
<xmax>3</xmax><ymax>4</ymax></bndbox></object>
<object><name>cat</name><bndbox><xmin>100</xmin><ymin>50</ymin>
<xmax>300</xmax><ymax>200</ymax></bndbox></object>
</annotation>""")
    for c2i in (None, {"dog": 1, "cat": 2}):
        got = tod.parse_voc_annotation(str(xml), c2i)
        want = jod.parse_voc_annotation(str(xml), c2i)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert len(tod.parse_voc_annotation(str(xml))[1]) == 3
    coco = {"images": [{"id": 7, "width": 640, "height": 480},
                       {"id": 9, "width": 320, "height": 240}],
            "categories": [{"id": 18}, {"id": 1}, {"id": 44}],
            "annotations": [
                {"image_id": 7, "bbox": [10, 20, 100, 50],
                 "category_id": 18},
                {"image_id": 7, "bbox": [0, 0, 640, 480], "category_id": 1},
                {"image_id": 7, "bbox": [5, 5, 10, 10], "category_id": 90}]}
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(coco))
    got, want = tod.load_coco_annotations(str(path)), \
        jod.load_coco_annotations(str(path))
    assert sorted(got) == sorted(want) == [7, 9]
    for k in want:
        for x, y in zip(got[k], want[k]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# -- multibox_loss ------------------------------------------------------------

def _loss_case(kind, B=3, P=600, C=4):
    g = np.random.default_rng({"random": 10, "tie": 11, "none": 12}[kind])
    loc = g.normal(size=(B, P, 4)).astype(np.float32)
    conf = g.normal(size=(B, P, C)).astype(np.float32)
    y = np.zeros((B, P, 5), np.float32)
    y[..., 1:] = g.normal(size=(B, P, 4))
    if kind != "none":
        for b in range(B):
            pos = g.choice(P, 8 + 5 * b, replace=False)
            y[b, pos, 0] = g.integers(1, C, len(pos))
    if kind == "tie":
        # most priors' logits equal and far from the background: their CE
        # ties above every other negative's, and there are far more of
        # them than the 3:1 ratio keeps, so the ranking's tie order picks
        # the kept ones
        conf[:, 40:] = [0.0, 5.0, 5.0, 5.0]
        conf[:, 40::37] = g.normal(size=conf[:, 40::37].shape)
        loc[:, ::3] = y[:, ::3, 1:] + 0.5         # smooth-L1 below 1
    return loc, conf, y


@pytest.mark.parametrize("kind", ["random", "tie", "none"])
def test_multibox_loss_and_gradients_match_jax(kind):
    loc, conf, y = _loss_case(kind)

    def jloss(lp, cp):
        return jod.multibox_loss([lp, cp], jnp.asarray(y), class_num=4)
    want = np.asarray(jloss(loc, conf))
    jg = jax.grad(lambda lp, cp: jloss(lp, cp).sum(), argnums=(0, 1))(
        loc, conf)
    lt = torch.tensor(loc, requires_grad=True)
    ct = torch.tensor(conf, requires_grad=True)
    got = tod.multibox_loss([lt, ct], torch.tensor(y), class_num=4)
    assert got.shape == (3,)
    np.testing.assert_allclose(to_np(got), want, **LOSS_TOL)
    got.sum().backward()
    np.testing.assert_allclose(to_np(lt.grad), np.asarray(jg[0]), **LOSS_TOL)
    np.testing.assert_allclose(to_np(ct.grad), np.asarray(jg[1]), **LOSS_TOL)
    if kind == "tie":
        # the kept negatives are the lowest-indexed of the tied ones: a
        # conf gradient on the first tied priors, none on the last
        rows = np.abs(to_np(ct.grad)).sum(-1)
        neg = y[..., 0] == 0
        tied = np.zeros_like(neg)
        tied[:, 40:] = True
        tied[:, 40::37] = False
        for b in range(3):
            idx = np.where(neg[b] & tied[b])[0]
            kept = rows[b, idx] > 0
            assert kept.any() and not kept.all()
            assert not np.any(kept[np.argmin(kept):])   # a prefix
    if kind == "none":
        assert np.all(to_np(lt.grad) == 0)


# -- the compact SSD ----------------------------------------------------------

@pytest.fixture(scope="module")
def compact_weights():
    """Seeded compact-SSD params and state (numpy trees): the port's
    initializer, BN gamma / beta / moving statistics drawn."""
    ssd = tod.SSD(**COMPACT, device="cpu")
    ssd.model.init_weights(20)
    g = np.random.default_rng(20)
    with torch.no_grad():
        for m in ssd.model.modules():
            if isinstance(m, tcore.BatchNormalization):
                d = m.gamma.shape[0]
                for t, v in ((m.gamma, g.uniform(0.5, 1.5, d)),
                             (m.beta, g.normal(0, 0.1, d)),
                             (m.mean, g.normal(0, 0.1, d)),
                             (m.var, g.uniform(0.5, 2.0, d))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return tree_np(export_params(ssd.model)), \
        tree_np(export_state(ssd.model))


def _pair(weights):
    ssd = tod.SSD(**COMPACT, device="cpu")
    ssd.model.set_weights(*weights)
    jssd = jod.SSD(**COMPACT)
    jssd.model.set_weights(*copy.deepcopy(weights))
    return ssd, jssd


def test_compact_ssd_fusion_plan_and_forward_match_jax(compact_weights):
    ssd, jssd = _pair(compact_weights)
    assert ssd.model.fusion_plan == ()         # BNs after 3x3 convs
    assert np.array_equal(ssd.priors, jssd.priors)
    assert ssd.model.param_count() == jssd.model.param_count()
    x = np.random.default_rng(21).uniform(0, 1, (3, 64, 64, 3)) \
        .astype(np.float32)
    want, _ = jssd.model.apply(*compact_weights, x, training=False)
    with torch.no_grad():
        got = ssd.model(torch.from_numpy(x))
    assert [tuple(t.shape) for t in got] == [(3, 252, 4), (3, 252, 4)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **FORWARD_TOL)


@pytest.fixture(scope="module")
def fitted(compact_weights):
    """The JAX and the port's Estimator, each fit with multibox_loss for
    2 epochs (4 steps of 8) of Adam(2e-3) from the same weights, data
    (the planted-rectangle fixture at 64x64) and shuffle seed (42)."""
    ssd, jssd = _pair(compact_weights)
    x, gts = cs.ssd_fixture(0, n=16, image_size=64)
    y = ssd.encode_targets([b for b, _ in gts], [lab for _, lab in gts])
    assert np.array_equal(y, jssd.encode_targets(
        [b for b, _ in gts], [lab for _, lab in gts]))
    jax_context().set_seed(42)
    je = JaxEstimator(jssd.model, optimizer=jopt.Adam(lr=2e-3),
                      loss=functools.partial(jod.multibox_loss,
                                             class_num=4))
    te = Estimator(ssd.model, optimizer=topt.Adam(lr=2e-3),
                   loss=functools.partial(tod.multibox_loss, class_num=4),
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    je.fit(x, y, batch_size=8, epochs=2, verbose=False)
    te.fit(x, y, batch_size=8, epochs=2, verbose=False)
    jssd.model._params, jssd.model._state = je.params, je.state
    return dict(ssd=ssd, jssd=jssd, x=x, gts=gts, losses=losses)


def test_fit_losses_match_jax(fitted):
    lj, lp = fitted["losses"]["jax"], fitted["losses"]["port"]
    assert len(lj) == len(lp) == 4
    np.testing.assert_allclose(lp, lj, rtol=0, atol=FIT_TOL)


def _same_detections(got, want):
    """Per image the same classes in the same order, each score within
    DETECT_TOL and each box within DETECT_TOL of its largest coordinate's
    magnitude (at least 1): a box is decoded through exp of its deltas,
    and an f32 error in its size shows in both its corners."""
    for g_img, w_img in zip(got, want):
        assert [c for c, _, _ in g_img] == [c for c, _, _ in w_img]
        for (_, gs, gb), (_, ws, wb) in zip(g_img, w_img):
            assert abs(gs - ws) <= DETECT_TOL
            scale = max(1.0, float(np.abs(wb).max()))
            np.testing.assert_allclose(gb, wb, rtol=0,
                                       atol=DETECT_TOL * scale)


def test_detect_matches_jax(fitted):
    """After the fit: per image the same (class, score, box) list, classes
    in the same order, scores and boxes within DETECT_TOL."""
    x = fitted["x"]
    for thr in (0.3, 0.05):
        got = fitted["ssd"].detect(x, score_threshold=thr, batch_size=5)
        want = fitted["jssd"].detect(x, score_threshold=thr)
        assert len(got) == len(want) == len(x)
        assert sum(len(d) for d in want) > 0
        _same_detections(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_compact_ssd_matches_jax(compact_weights, bits):
    """Each side's ``do_quantize`` from the same float weights: 11 targets
    (5 backbone convs, 6 heads), every leaf exactly (int8: the first
    conv's ``s_x`` too; later ones within rtol 1e-5); then the JAX
    quantized tree loaded into a float port model serves within
    PROB_TOL of the JAX ``InferenceModel``."""
    calib = np.random.default_rng(22).uniform(0, 1, (4, 64, 64, 3)) \
        .astype(np.float32)
    jim = JaxIM(2, 8).do_load_model(jod.SSD(**COMPACT).model,
                                    *copy.deepcopy(compact_weights))
    ssd = tod.SSD(**COMPACT, device="cpu")
    tim = InferenceModel(2, 8, device="cpu").do_load_model(
        ssd.model, *compact_weights)
    for im in (jim, tim):
        im.do_quantize(calib if bits == 8 else None, force=True, bits=bits)
    targets = [p for _, _, p in tq._target_layers(tim._model, tim._params)]
    assert targets == [p for _, _, p in jq._target_layers(jim._model,
                                                          jim._params)]
    assert len(targets) == 11 and targets[0] == "ssd_c1_conv"
    wl = flat(tree_np(jax.tree.map(np.asarray, jim._params)))
    gl = flat(tree_np(tim._params))
    assert sorted(gl) == sorted(wl)
    for path, want in wl.items():
        assert gl[path].dtype == want.dtype, path
        if path.endswith("/s_x") and not path.startswith("/ssd_c1_conv/"):
            np.testing.assert_allclose(gl[path], want, rtol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(gl[path], want, err_msg=path)
    qparams = jax.tree.map(np.asarray, jim._params)
    served = InferenceModel(2, 8, device="cpu").do_load_model(
        tod.SSD(**COMPACT, device="cpu").model, qparams,
        compact_weights[1])
    x = np.random.default_rng(23).uniform(0, 1, (3, 64, 64, 3)) \
        .astype(np.float32)
    want, got = jim.do_predict(x), served.do_predict(x)
    assert isinstance(got, list) and len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=PROB_TOL)


# -- SSD-VGG16 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg300():
    """SSDVGG(4, 300) in both packages with the port's seeded weights."""
    ssd = tod.SSDVGG(4, resolution=300, device="cpu")
    ssd.model.init_weights(30)
    params = tree_np(export_params(ssd.model))
    state = tree_np(export_state(ssd.model))
    jssd = jod.SSDVGG(4, resolution=300)
    jssd.model.set_weights(copy.deepcopy(params), state)
    return ssd, jssd, params, state


def test_ssdvgg300_structure_matches_jax(vgg300):
    ssd, jssd, params, _ = vgg300
    assert ssd.model.param_count() == cs.SSD_PARAMS == 24_013_232
    assert ssd.model.param_count() == jssd.model.param_count()
    assert ssd.model.fusion_plan == ()
    assert np.array_equal(ssd.priors, jssd.priors)
    assert ssd.priors.shape == (cs.SSD_PRIORS, 4)
    assert ssd.feature_sizes == jssd.feature_sizes == [38, 19, 10, 5, 3, 1]
    assert ssd.n_priors == jssd.n_priors == [4, 6, 6, 6, 4, 4]
    assert float(params["conv4_3_norm"]["gamma"][0]) == 20.0
    assert params["fc6"]["W"].shape == (3, 3, 512, 1024)
    assert params["fc7"]["W"].shape == (1, 1, 1024, 1024)
    assert params["fc7_mbox_conf"]["W"].shape == (3, 3, 1024, 6 * 4)
    shapes = jax.eval_shape(lambda: jssd.model.init(jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in flat(tree_np(params)).items()} == {
        k: v.shape for k, v in flat(shapes[0]).items()}
    assert tod.ObjectDetector(cs.SSD_FACADE, device="cpu").ssd.model \
        .param_count() == cs.SSD_FACADE_PARAMS == 26_285_486
    inv = cs.conv_inventory(ssd.model, 16)
    assert (len(inv["spatial"]), len(inv["matmuls"])) == (30, 5)
    assert len(tq._target_layers(ssd.model, params)) == 35


def test_ssdvgg512_structure_matches_jax():
    ssd = tod.SSDVGG(21, resolution=512, device="cpu")
    jssd = jod.SSDVGG(21, resolution=512)
    assert np.array_equal(ssd.priors, jssd.priors)
    assert ssd.priors.shape == (24564, 4)
    assert ssd.feature_sizes == [64, 32, 16, 8, 4, 2, 1]
    assert ssd.n_priors == jssd.n_priors == [4, 6, 6, 6, 6, 4, 4]
    shapes = jax.eval_shape(lambda: jssd.model.init(jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in flat(tree_np(export_params(
        ssd.model))).items()} == {k: v.shape
                                  for k, v in flat(shapes[0]).items()}
    with pytest.raises(ValueError, match="300x300 or 512x512"):
        tod.SSDVGG(21, resolution=400, device="cpu")


def test_ssdvgg300_forward_matches_jax(vgg300):
    """One batch-1 forward at 300x300 from the same weights: loc and conf
    within VGG_TOL (23 convolutions of K up to 9216 and the ×20 scale of
    conv4_3_norm, f32 in other summation orders)."""
    ssd, jssd, params, state = vgg300
    x = np.random.default_rng(31).uniform(0, 1, (1, 300, 300, 3)) \
        .astype(np.float32)
    want, _ = jssd.model.apply(params, state, x, training=False)
    with torch.no_grad():
        got = ssd.model(torch.from_numpy(x))
    assert tuple(got[0].shape) == (1, 8732, 4)
    assert tuple(got[1].shape) == (1, 8732, 4)
    for a, b in zip(got, want):
        a, b = to_np(a), np.asarray(b)
        scale = np.abs(b).max()
        assert np.all(np.abs(a - b) <= VGG_TOL[0] * scale
                      + VGG_TOL[1] * np.abs(b)), np.abs(a - b).max() / scale


def test_vgg16_backbone_import_matches_jax():
    """A torchvision-layout VGG16 ``features`` state dict (numpy, then
    torch tensors) into both packages: conv1_1 .. conv5_3 equal JAX's
    import (OIHW -> HWIO) exactly; the SSD layers keep their weights."""
    g = np.random.default_rng(32)
    ssd = tod.SSDVGG(4, resolution=300, device="cpu")
    before = tree_np(export_params(ssd.model))
    jssd = jod.SSDVGG(4, resolution=300)
    jssd.model.set_weights(copy.deepcopy(before),
                           tree_np(export_state(ssd.model)))
    cin = {"conv1_1": 3, "conv1_2": 64, "conv2_1": 64, "conv2_2": 128,
           "conv3_1": 128, "conv3_2": 256, "conv3_3": 256, "conv4_1": 256}
    sd = {}
    for name, idx in tod.TORCH_VGG16_FEATURES.items():
        w = before[name]["W"]
        sd[f"features.{idx}.weight"] = g.normal(
            size=(w.shape[3], cin.get(name, 512), 3, 3)).astype(np.float32)
        sd[f"features.{idx}.bias"] = g.normal(size=w.shape[3]).astype(
            np.float32)
    jssd.load_torch_vgg16_backbone(sd)
    want = flat(tree_np(jax.tree.map(np.asarray, jssd.model.get_weights())))
    for state in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        assert ssd.load_torch_vgg16_backbone(state) is ssd
        got = flat(tree_np(export_params(ssd.model)))
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    assert np.array_equal(want["/fc6/W"], before["fc6"]["W"])


# -- the facade -------------------------------------------------------------

FACADE = "ssd-compact-small-288x288"


def _jax_facade_params(od):
    return flat(tree_np(jax.tree.map(np.asarray, od.ssd.model._params)))


def test_weights_file_both_ways_and_predict_image_set(tmp_path):
    """The JAX ``ObjectDetector``'s weights file into the port's
    ``load_model``, each leaf exactly; the port's ``save`` into JAX's
    ``load_model`` likewise; then ``predict_image_set`` over the same
    seeded images: the port's equals its ``detect`` of the cv2-resized
    images, whose box deltas and class logits are JAX's within
    DETECT_TOL of their largest magnitude."""
    jod_ = jod.ObjectDetector(FACADE)
    jpath = str(tmp_path / "jax.npz")
    jod_.save(jpath)
    port = tod.ObjectDetector.load_model(FACADE, jpath, device="cpu")
    assert port.device == torch.device("cpu")
    got = flat(tree_np(export_params(port.ssd.model)))
    want = _jax_facade_params(jod_)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    port.ssd.model.init_weights(40)
    tpath = str(tmp_path / "port.npz")
    port.save(tpath)
    back = jod.ObjectDetector.load_model(FACADE, tpath)
    want = flat(tree_np(export_params(port.ssd.model)))
    got = _jax_facade_params(back)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    g = np.random.default_rng(41)
    imgs = [g.integers(0, 256, (200 + 30 * i, 240, 3), dtype=np.uint8)
            for i in range(2)]
    got = port.predict_image_set(ImageSet.from_arrays(imgs),
                                 score_threshold=0.3)
    want = back.predict_image_set(JaxImageSet.from_arrays(imgs),
                                  score_threshold=0.3)
    assert len(got) == len(want) == 2 and sum(len(d) for d in want) > 0
    # the port's predict_image_set is its detect of the cv2-resized,
    # mean-subtracted images, and that input is JAX's
    size = port.cfg["image_size"]
    resized = np.stack([cv2.resize(np.asarray(im, np.float32),
                                   (size, size)) for im in imgs])
    x = port._preprocess(resized)
    assert np.array_equal(x, back._preprocess(resized))
    again = port.ssd.detect(x, score_threshold=0.3)
    assert [[(c, sc) for c, sc, _ in d] for d in got] == \
        [[(c, sc) for c, sc, _ in d] for d in again]
    # random weights saturate the softmax, so scores tie and NMS orders
    # them by f32 noise: the forward is held to JAX's before the softmax
    with torch.no_grad():
        got = [to_np(t) for t in port.ssd.model(torch.from_numpy(x))]
    want = back.ssd.model.predict(x, batch_size=32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=DETECT_TOL * max(
            1.0, float(np.abs(b).max())))


# -- chip_smoke.py phase 16 ---------------------------------------------------

def test_ssd_fixture_is_the_examples():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ssd_voc_eval", cs.os.path.join(cs.os.path.dirname(cs.__file__),
                                        "examples", "ssd_voc_eval.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    a, ga = cs.ssd_fixture(0, n=6, image_size=64)
    b, gb = ex.synth_fixture(n=6, image_size=64)
    assert np.array_equal(a, b)
    for (x1, y1), (x2, y2) in zip(ga, gb):
        assert np.array_equal(x1, x2) and np.array_equal(y1, y2)


@pytest.fixture
def tiny_phase(monkeypatch):
    """Phase 16's constants at a CPU size: the compact SSD at 64x64 in
    place of SSD-VGG16-300, 16 images, batch 8, 3 epochs (its last
    epoch's loss held to 12, the compact model's own scale); the compact
    facade."""
    monkeypatch.setattr(cs, "ssd_model", lambda dev: tod.SSD(
        **COMPACT, device=dev))
    for name, value in (("SSD_RESOLUTION", 64), ("SSD_IMAGES", 16),
                        ("SSD_BATCH", 8), ("SSD_EPOCHS", 3),
                        ("SSD_SERVE_BATCH", 8), ("SSD_FACADE", FACADE),
                        ("SSD_LOSS_MAX", 12.0),
                        ("SSD_FACADE_PARAMS", tod.ObjectDetector(
                            FACADE, device="cpu").ssd.model.param_count())):
        monkeypatch.setattr(cs, name, value)
    init_context(device="cpu", seed=0)
    yield


def test_phase16_host_logic_on_cpu(tiny_phase, tmp_path):
    """The phase's fit (the loss falls, and a loss above SSD_LOSS_MAX is
    refused; cuDNN's setting restored after it), detect and its scoring, the
    serving checks in f32, int8 and int4 against the plain route with no
    launch expected off the card, the mAP gaps, and the facade's save /
    load / predict_image_set / device-vs-CPU checks."""
    dev = torch.device("cpu")
    ssd = cs.ssd_model(dev)
    ssd.model.init_weights(0)
    x, gts = cs.ssd_fixture(0, n=cs.SSD_IMAGES, image_size=64)
    targets = ssd.encode_targets([b for b, _ in gts],
                                 [lab for _, lab in gts])
    run = cs.ssd_train(ssd.model, x, targets, 0)
    assert len(run["walls"]) == 3
    assert torch.backends.cudnn.deterministic is False
    train = cs.check_ssd_train(run)
    assert train["epoch_loss"][-1] < train["epoch_loss"][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "SSD_LOSS_MAX", train["epoch_loss"][-1] * 0.99)
        with pytest.raises(cs.SmokeFailure, match="last epoch's mean loss"):
            cs.check_ssd_train(run)
    dets = ssd.detect(x, score_threshold=cs.SSD_EVAL_SCORE)
    maps = cs.voc_maps(dets, gts)
    assert 0.0 <= maps["voc07"] <= 1.0 and 0.0 <= maps["voc12"] <= 1.0
    calib = [x[i:i + 8] for i in range(0, len(x), 8)]
    served = cs.ssd_serve_phase(ssd, x, gts, calib, dev)
    assert sorted(served) == ["f32", "int4", "int8"]
    ref = cs.served_detections(ssd.priors, served["f32"]["loc"],
                               served["f32"]["conf"], ssd.class_num)
    assert cs.voc_maps(ref, gts) == served["f32"]["maps"]
    out = cs.ssd_facade_phase(0, dev, str(tmp_path))
    assert out["card_vs_cpu"] == {"loc": 0.0, "conf": 0.0}


def test_plain_int8_conv_output_is_contiguous_nhwc():
    """The plain version of ``w8a8_conv2d`` writes contiguous NHWC, as the
    kernel does, so a channel reduction after it (``NormalizeScale``)
    sums in one order on both routes."""
    from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
    g = np.random.default_rng(50)
    x = torch.from_numpy(g.integers(-127, 128, (2, 9, 9, 8), dtype=np.int8))
    w = torch.from_numpy(g.integers(-127, 128, (3, 3, 8, 16),
                                    dtype=np.int8))
    y = tqm.w8a8_conv2d(x, w, torch.ones(16), strides=(1, 1),
                        pads=((1, 1), (1, 1)))
    assert y.shape == (2, 9, 9, 16) and y.is_contiguous()
