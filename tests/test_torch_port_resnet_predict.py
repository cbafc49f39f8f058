"""PyTorch port: ResNet-50 image classification served, against the JAX
package, on the CPU.

ResNet-50 (ImageNet stem, SAME padding, BN eps 1e-3) at 32×32×3 with 10
classes, batch 4, from one seeded weight set with non-trivial BN moving
statistics (the head scaled so the softmax is not saturated), loaded into
both packages (``do_load_model`` with params and state):

- the quantizer: 54 target layers (53 convolutions and the head); the
  port's own int8 / int4 ``quantize`` leaves against the JAX package's:
  weights, their scales and biases bit for bit, each activation scale
  ``s_x`` from its side's own calibration pass to f32 noise (the stem's,
  which sees the input itself, bit for bit); with one shared calibration
  every leaf bit for bit; ``calibrate_featureset`` against JAX's;
- ``InferenceModel.do_predict`` in f32, int8 and int4 against the JAX
  ``InferenceModel`` (tolerances stated at each test);
- ``ImageClassifier.predict_image_set`` over an ``ImageSet`` through a
  registered preprocessing chain: top-k ids equal;
- ``ClusterServing`` in predict mode over image records (PNG, the float
  path and the ``u8`` path): each record's top-N equal to the direct
  predict of the same decoded image, f32 and int8.
"""

import base64

import cv2
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.feature.dataset import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models import imageclassification as jic
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.common import context as tcontext
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.feature import image as timage
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import imageclassification as tic
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving.client import InputQueue
from analytics_zoo_tpu_torch.serving.queues import InProcQueue
from analytics_zoo_tpu_torch.utils.convert import export_params, export_state

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(600)

SHAPE, CLASSES, BATCH = (32, 32, 3), 10, 4
# the port and the JAX package run the same f32 math in other summation
# orders (oneDNN vs XLA convolutions); through 53 convolutions the
# probabilities read 3.6e-7 apart (f32), 4.2e-7 (int4)
PROB_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else
            (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out.update(_leaves(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v.detach().cpu().numpy()
                                          if isinstance(v, torch.Tensor)
                                          else v)})
    return out


def _images(seed, n):
    g = np.random.default_rng(seed)
    return g.standard_normal((n,) + SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """Seeded ResNet-50 params and state (numpy trees): weights from the
    port's initializer, BN gamma / beta / moving statistics drawn, the
    head scaled by 3e-3 so its logits spread over a few units."""
    tm = tic.resnet(50, CLASSES, SHAPE)
    tm.init_weights(30)
    g = np.random.default_rng(30)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tcore.BatchNormalization):
                d = m.gamma.shape[0]
                m.gamma.copy_(torch.from_numpy(
                    g.uniform(0.5, 1.5, d).astype(np.float32)))
                m.beta.copy_(torch.from_numpy(
                    g.normal(0, 0.1, d).astype(np.float32)))
                m.mean.copy_(torch.from_numpy(
                    g.normal(0, 0.1, d).astype(np.float32)))
                m.var.copy_(torch.from_numpy(
                    g.uniform(0.5, 2.0, d).astype(np.float32)))
    params, state = _np_tree(export_params(tm)), _np_tree(export_state(tm))
    params["resnet50_fc"]["W"] = params["resnet50_fc"]["W"] \
        * np.float32(3e-3)
    return params, state


@pytest.fixture(scope="module")
def jax_model():
    return jic.resnet(50, CLASSES, SHAPE)


def _port(weights):
    params, state = weights
    return InferenceModel(2, 8, device="cpu").do_load_model(
        tic.resnet(50, CLASSES, SHAPE), params, state)


def _jax(jax_model, weights):
    params, state = weights
    return JaxIM(2, 8).do_load_model(jax_model, params, state)


@pytest.fixture(scope="module")
def calib():
    return _images(40, BATCH)


@pytest.fixture(scope="module")
def quantized(weights, jax_model, calib):
    """bits -> (JAX InferenceModel, port InferenceModel), each quantized
    by its own ``do_quantize`` from the same float weights."""
    out = {}
    for bits in (8, 4):
        jim, tim = _jax(jax_model, weights), _port(weights)
        for im in (jim, tim):
            im.do_quantize(calib if bits == 8 else None, force=True,
                           bits=bits)
        out[bits] = (jim, tim)
    return out


def test_quantizer_targets_every_conv_and_the_head(weights, jax_model):
    tim = _port(weights)
    jt = jq._target_layers(jax_model, weights[0])
    tt = tq._target_layers(tim._model, tim._params)
    assert [p for _, _, p in tt] == [p for _, _, p in jt]
    assert len(tt) == 54
    assert sum(type(layer).__name__ == "Convolution2D"
               for layer, _, _ in tt) == 53


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_leaves_match_jax(quantized, bits):
    """Weights, weight scales and biases bit for bit (the same numpy
    recipe on the same f32 weights); ``s_x`` from each side's own
    calibration pass within rtol 1e-5 (the activations reach each layer
    through f32 math summed in other orders), the stem's bit for bit."""
    jim, tim = quantized[bits]
    wl = _leaves(jax.tree.map(np.asarray, jim._params))
    gl = _leaves(tim._params)
    assert sorted(gl) == sorted(wl)
    n_q = 0
    for path, want in wl.items():
        got = gl[path]
        assert got.dtype == want.dtype, path
        if path.endswith("/s_x") and "stem" not in path:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
        n_q += path.endswith("/W_q" if bits == 8 else "/W_q4")
    assert n_q == 54
    assert tq.quantized_bits(tim._params) == bits
    assert tq.weight_bytes(tim._params) == jq.weight_bytes(jim._params)
    layers = {m.name: m for m in tim._model.modules()
              if hasattr(m, "bits")}
    assert {m.bits for m in layers.values()} == {bits}
    assert not any(m.fusable_with_bn() for m in layers.values()
                   if hasattr(m, "fusable_with_bn"))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_load_and_export_bit_for_bit(quantized, weights,
                                                     bits):
    """The JAX package's quantized tree (numpy leaves) loaded into a float
    port model switches every conv and the head to the quantized form;
    exported back, every leaf is bit for bit the one loaded."""
    jim, _ = quantized[bits]
    qparams = jax.tree.map(np.asarray, jim._params)
    tim = InferenceModel(device="cpu").do_load_model(
        tic.resnet(50, CLASSES, SHAPE), qparams, weights[1])
    wl, gl = _leaves(qparams), _leaves(export_params(tim._model))
    assert sorted(gl) == sorted(wl)
    for path in wl:
        assert gl[path].dtype == wl[path].dtype, path
        np.testing.assert_array_equal(gl[path], wl[path], err_msg=path)


def test_shared_calibration_gives_identical_leaves(weights, jax_model,
                                                   calib):
    """One absmax dict (the JAX package's calibration) through both
    quantizers: every leaf of the int8 tree bit for bit."""
    params, state = weights
    absmax = jq.calibrate(jax_model, params, state, [calib])
    want = jq.quantize_params(jax_model, params, absmax, bits=8)
    tim = _port(weights)
    got = tq.quantize_params(tim._model, export_params(tim._model), absmax,
                             bits=8)
    wl = _leaves(jax.tree.map(np.asarray, want))
    gl = _leaves(got)
    assert sorted(gl) == sorted(wl)
    for path in wl:
        np.testing.assert_array_equal(gl[path], wl[path], err_msg=path)


def test_calibrate_featureset_matches_jax(weights, jax_model):
    """The first ``n_batches`` batches of a ``FeatureSet`` (labels
    dropped, the last batch zero-padded): the same per-path absmax keys,
    values to f32 noise (rtol 1e-5), the stem's exact; and ``quantize``
    takes the FeatureSet itself."""
    x = _images(41, 10)
    y = np.arange(10, dtype=np.float32)
    params, state = weights
    want = jq.calibrate_featureset(jax_model, params, state,
                                   JaxFeatureSet.from_arrays(x, y),
                                   n_batches=2, batch_size=4)
    tim = _port(weights)
    got = tq.calibrate_featureset(tim._model, FeatureSet.from_arrays(x, y),
                                  n_batches=2, batch_size=4)
    assert sorted(got) == sorted(want) and len(got) == 54
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert got["resnet50_stem_conv"] == want["resnet50_stem_conv"]
    tim.do_quantize(FeatureSet.from_arrays(x, y), force=True, bits=8)
    assert tq.quantized_bits(tim._params) == 8


@pytest.mark.parametrize("n,batch_size", [(4, None), (7, 3)])
def test_do_predict_f32_matches_jax(weights, jax_model, n, batch_size):
    x = _images(50 + n, n)
    want = _jax(jax_model, weights).do_predict(x, batch_size=batch_size)
    got = _port(weights).do_predict(x, batch_size=batch_size)
    assert got.shape == want.shape == (n, CLASSES)
    assert 0.01 < want.max() < 0.9             # an unsaturated softmax
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


def _record_codes(monkeypatch, mod):
    """Patch ``mod``'s int8 conv and dense entry points to record the
    activation codes they are given, in call order."""
    seen = []
    for name in ("w8a8_conv", "w8a8_dense"):
        def spy(x_q, *args, _fn=getattr(mod, name), **kwargs):
            seen.append(np.array(x_q.cpu() if isinstance(x_q, torch.Tensor)
                                 else x_q))
            return _fn(x_q, *args, **kwargs)
        monkeypatch.setattr(mod, name, spy)
    return seen


def test_do_predict_int8_matches_jax(weights, jax_model, calib,
                                     monkeypatch):
    """The JAX package's int8 tree loaded into the port (the same weight
    codes and activation scales).  An activation code may differ by one
    step where the two sides' f32 noise puts ``x / s_x`` on the other
    side of a rounding edge: the codes of all 54 quantized layers are
    compared, at most one step apart, and at this seed none differs, so
    the int8 forward is the same integer arithmetic on both sides and the
    probabilities agree to f32 noise (PROB_ATOL)."""
    jim = _jax(jax_model, weights).do_quantize(calib, force=True, bits=8)
    qparams = jax.tree.map(np.asarray, jim._params)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(
        tic.resnet(50, CLASSES, SHAPE), qparams, weights[1])
    x = _images(60, BATCH)
    want = jim.do_predict(x)
    jcodes = _record_codes(monkeypatch, jqm)
    tcodes = _record_codes(monkeypatch, tqm)
    jax_model.apply(qparams, weights[1], x, training=False)
    got = tim.do_predict(x)
    assert len(jcodes) == len(tcodes) == 54
    steps = [np.abs(a.astype(np.int32) - b.astype(np.int32))
             for a, b in zip(tcodes, jcodes)]
    assert max(int(s.max()) for s in steps) <= 1
    assert sum(int(s.sum()) for s in steps) == 0
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert np.array_equal(np.argsort(-got, 1)[:, :3],
                          np.argsort(-want, 1)[:, :3])


def test_do_predict_int4_matches_jax(quantized):
    """Weight-only int4: both sides convolve the same dequantized weights
    in f32 (the spatial convs as a dequantize + convolution, the
    pointwise ones through the w4a16 matmul's plain version):
    PROB_ATOL."""
    jim, tim = quantized[4]
    x = _images(61, BATCH)
    np.testing.assert_allclose(tim.do_predict(x), jim.do_predict(x),
                               atol=PROB_ATOL)


def _chain(mod):
    return mod.ImageResize(36, 40) >> mod.ImageCenterCrop(32, 32) \
        >> mod.ImageChannelNormalize(103.939, 116.779, 123.68, 58.4, 57.1,
                                     57.4)


def test_predict_image_set_matches_jax(weights, monkeypatch):
    """``predict_image_set`` through a registered preprocessing chain
    (resize, center crop, per-channel normalization): the top-3 ids
    equal, probabilities within PROB_ATOL.  (The port's ``predict`` runs
    an ``Estimator``, whose process context is put on the CPU here.)"""
    monkeypatch.setattr(tcontext, "_global_ctx",
                        tcontext.ZooContext(tcontext.ZooConf(device="cpu")))
    for mod, ic in ((jimage, jic), (timage, tic)):
        ic.ImageClassificationConfig.register("resnet50", _chain(mod))
    try:
        jclf = jic.ImageClassifier("resnet50", CLASSES, SHAPE)
        tclf = tic.ImageClassifier("resnet50", CLASSES, SHAPE, device="cpu")
    finally:
        jic.ImageClassificationConfig._REGISTRY.pop("resnet50")
        tic.ImageClassificationConfig._REGISTRY.pop("resnet50")
    jclf.set_weights(*weights)
    tclf.set_weights(*weights)
    g = np.random.default_rng(62)
    imgs = [g.integers(0, 256, (40, 44, 3), dtype=np.uint8)
            for _ in range(5)]
    want_i, want_p = jclf.predict_image_set(
        jimage.ImageSet.from_arrays(imgs), batch_size=2, top_k=3)
    got_i, got_p = tclf.predict_image_set(
        timage.ImageSet.from_arrays(imgs), batch_size=2, top_k=3)
    assert got_i.shape == (5, 3)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_p, want_p, atol=PROB_ATOL)


def _png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("bits", [0, 8])
def test_cluster_serving_image_records_equal_direct_predict(tmp_path,
                                                            weights, calib,
                                                            bits):
    """Image records (PNG; even records on the float path, odd ones on
    the u8 path, resized 40 x 36 -> 32 x 32 by the engine) served in
    predict mode: each record's top-5 equal to the direct predict of the
    same decoded image by the same model (the engine quantizes at
    construction with ``ServingParams.quantize``)."""
    im = _port(weights)
    spec = None
    if bits:
        path = tmp_path / "calib.npy"
        np.save(path, calib)
        spec = {"bits": 8, "calib": str(path)}
    q = InProcQueue()
    serving = teng.ClusterServing(im, q, teng.ServingParams(
        batch_size=4, top_n=5, quantize=spec))
    g = np.random.default_rng(63)
    iq = InputQueue(q)
    decoded = []
    for i in range(6):
        img = g.integers(0, 256, (40, 36, 3), dtype=np.uint8)
        img[0, 0] = 255
        iq.enqueue_image(f"img{i}", _png(img), resize=(32, 32),
                         device_uint8=bool(i % 2))
        rec = {"image": base64.b64encode(_png(img)).decode(),
               "resize": [32, 32], "u8": i % 2}
        out = teng.default_preprocess(rec)
        decoded.append(out.data.astype(np.float32) if i % 2 else out)
    served = 0
    while served < 6:
        n = serving.serve_once()
        assert n > 0
        served += n
    serving.shutdown()
    assert im.aot_stats()["programs"].keys() <= {
        "b4x32x32x3/<f4", "b4x32x32x3/|u1+scales", "b2x32x32x3/<f4",
        "b2x32x32x3/|u1+scales"}
    want = im.do_predict(np.stack(decoded))
    res = q.get_results([f"img{i}" for i in range(6)])
    for i in range(6):
        top = res[f"img{i}"]["value"]
        order = np.argsort(-want[i])[:5]
        assert [c for c, _ in top] == order.tolist()
        np.testing.assert_allclose([p for _, p in top], want[i][order],
                                   atol=1e-6)
