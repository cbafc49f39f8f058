"""PyTorch port: MobileNet v1 built from ``keras2`` against the JAX
package, on the CPU.

``chip_smoke.mobilenet_v1`` builds the model from either package's
``keras2`` constructors (the layer names of tf.keras's MobileNet, so the
two param trees match).  At full width (alpha 1.0, 224x224, 1000 classes)
it has tf.keras's 4,231,976 trainable parameters and 13 fused (pointwise
conv, BN) pairs.  Narrowed (widths / 8, 32x32 input, 10 classes, batch
2), from one seeded weight set with drawn BN moving statistics loaded into
both packages:

- the eval forward;
- one training step: the loss and the new BN moving statistics against
  JAX's (the port's training forward takes its fusion plan: 13 pairs
  through ``fused_bn``'s plain version), and every parameter's gradient
  against float64 (below);
- int8 and int4: the quantizer's 15 targets (the stem, 13 pointwise convs,
  the head) and their leaves, and ``InferenceModel.do_predict`` of the
  JAX package's quantized trees loaded into the port;
- phase 15's host logic of ``chip_smoke.py`` at a tiny size: the k-step
  fit, the lockstep pairs and the f32 / int8 / int4 serving checks.

Tolerances: MOBILENET_TOL (1e-4) for the forward, the loss and the BN
statistics: f32 in other summation orders through 28 convolutions and 27
BatchNorms; int8 codes and scales exactly; PROB_ATOL (1e-5) for the
quantized probabilities.  The gradients at this geometry are below f32's
resolution for both packages: the last blocks' BNs normalise 2 values a
channel (1x1 maps at batch 2), and the stem's gradient (|g| up to 318)
read 2.0 from its float64 value in JAX's f32 and 0.48 in the port's.  So
each gradient tensor is held to the port's own float64 gradient (the
unfused graph in float64), no further from it than JAX's f32 gradient is
(or 1e-4), and JAX's f32 gradient within 2% of its largest entry of that
float64 gradient, which holds the float64 graph to the JAX semantics.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.nn import graph as jgraph
from analytics_zoo_tpu.nn import keras2 as jk2
from analytics_zoo_tpu.nn import models as jmodels
from analytics_zoo_tpu.nn import objectives as jobj
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import init_context
from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import objectives as tobj
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.utils.convert import export_params, export_state
from torch_layer_parity import (f32_policy, flat, live_leaves, to_np,
                                tree_np)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(600)

NARROW = dict(alpha=1 / 8, input_shape=(32, 32, 3), classes=10)
BATCH = 2
MOBILENET_TOL = dict(atol=1e-4, rtol=1e-4)
PROB_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    with f32_policy():
        yield


def _jax_model(**kw):
    return cs.mobilenet_v1(**kw, k2=jk2, graph=jgraph, models=jmodels)


@pytest.fixture(scope="module")
def weights():
    """Seeded narrow params and state (numpy trees): the port's
    initializer, BN gamma / beta / moving statistics drawn."""
    tm = cs.mobilenet_v1(**NARROW)
    tm.init_weights(40)
    g = np.random.default_rng(40)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tcore.BatchNormalization):
                d = m.gamma.shape[0]
                for t, v in ((m.gamma, g.uniform(0.5, 1.5, d)),
                             (m.beta, g.normal(0, 0.1, d)),
                             (m.mean, g.normal(0, 0.1, d)),
                             (m.var, g.uniform(0.5, 2.0, d))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return tree_np(export_params(tm)), tree_np(export_state(tm))


def _port(weights):
    tm = cs.mobilenet_v1(**NARROW)
    tm.set_weights(*weights)
    return tm


def _images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n,) + NARROW["input_shape"]).astype(np.float32)


def test_full_width_matches_tf_keras_and_jax():
    tm = cs.mobilenet_v1(**cs.MOBILENET)
    assert tm.param_count() == cs.MOBILENET_PARAMS == 4_231_976
    assert len(tm.fusion_plan) == cs.MOBILENET_PAIRS == 13
    jm = _jax_model(**cs.MOBILENET)
    assert jm.param_count() == cs.MOBILENET_PARAMS
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.applications.MobileNet(weights=None)
    assert sum(int(np.prod(w.shape)) for w in km.trainable_weights) \
        == cs.MOBILENET_PARAMS


def test_eval_forward_matches_jax(weights):
    tm = _port(weights).eval()
    x = _images(41)
    want, _ = _jax_model(**NARROW).apply(*weights, x, training=False)
    with torch.no_grad():
        got = to_np(tm(torch.from_numpy(x)))
    assert 0.05 < float(np.max(want)) < 0.95        # unsaturated
    np.testing.assert_allclose(got, np.asarray(want), **MOBILENET_TOL)


def _port_grads(model, x, y, dt):
    model.train()
    loss = tobj.get("sparse_categorical_crossentropy")(
        model(torch.from_numpy(x).to(dt)), torch.from_numpy(y)).mean()
    loss.backward()
    return loss, {k: v.grad.double().numpy()
                  for k, v in live_leaves(model).items()}


def test_training_step_matches_jax(weights):
    """Loss and the new moving statistics of one training forward against
    JAX's; every parameter's gradient (the port's through its 13 fused
    pairs) against the port's float64 gradient, as close as JAX's f32
    gradient is (module docstring)."""
    params, state = weights
    tm = _port(weights)
    assert len(tm.fusion_plan) == 13
    x, y = _images(42), np.array([3, 7])
    jm = _jax_model(**NARROW)

    def loss_fn(p):
        out, new = jm.apply(p, state, x, training=True)
        return jobj.get("sparse_categorical_crossentropy")(out, y).mean(), \
            new
    (jloss, jstate), jgrad = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    loss, got = _port_grads(tm, x, y, torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **MOBILENET_TOL)
    m64 = copy.deepcopy(tm).double()
    m64.fusion_plan = ()
    tdtypes.set_policy(None, torch.float64)
    try:
        _, g64 = _port_grads(m64, x, y, torch.float64)
    finally:
        tdtypes.set_policy(None)
    want = flat(tree_np(jgrad))
    assert sorted(want) == sorted(got) == sorted(g64) and len(got) == 83
    for path in got:
        scale = np.abs(g64[path]).max()
        err_jax = np.abs(want[path] - g64[path]).max()
        err_port = np.abs(got[path] - g64[path]).max()
        assert err_jax <= 2e-2 * scale, (path, err_jax, scale)
        assert err_port <= max(err_jax, 1e-4), (path, err_port, err_jax)
    wst, gst = flat(tree_np(jstate)), flat(tree_np(export_state(tm)))
    assert sorted(wst) == sorted(gst)
    for path in wst:
        np.testing.assert_allclose(gst[path], wst[path], **MOBILENET_TOL,
                                   err_msg=path)


@pytest.fixture(scope="module")
def quantized(weights):
    """bits -> (JAX InferenceModel, port InferenceModel), each quantized
    by its own ``do_quantize`` from the same float weights."""
    calib = _images(43, 4)
    out = {}
    for bits in (8, 4):
        jim = JaxIM(2, 8).do_load_model(_jax_model(**NARROW), *weights)
        tim = InferenceModel(2, 8, device="cpu").do_load_model(
            cs.mobilenet_v1(**NARROW), *weights)
        for im in (jim, tim):
            im.do_quantize(calib if bits == 8 else None, force=True,
                           bits=bits)
        out[bits] = (jim, tim)
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_targets_and_leaves_match_jax(quantized, bits):
    """15 targets: the stem, the 13 pointwise convs and the head (the
    depthwise convs stay float, as in JAX); weights, scales and biases bit
    for bit, each ``s_x`` from its side's calibration within rtol 1e-5
    (the stem's exactly)."""
    jim, tim = quantized[bits]
    targets = [p for _, _, p in tq._target_layers(tim._model, tim._params)]
    assert targets == [p for _, _, p in jq._target_layers(
        jim._model, jim._params)]
    assert len(targets) == 15 and targets[0] == "conv1" \
        and targets[-1] == "predictions"
    wl = flat(tree_np(jax.tree.map(np.asarray, jim._params)))
    gl = flat(tree_np(tim._params))
    assert sorted(gl) == sorted(wl)
    for path, want in wl.items():
        assert gl[path].dtype == want.dtype, path
        if path.endswith("/s_x") and not path.startswith("/conv1/"):
            np.testing.assert_allclose(gl[path], want, rtol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(gl[path], want, err_msg=path)
    assert tq.weight_bytes(tim._params) == jq.weight_bytes(jim._params)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_predict_matches_jax(quantized, weights, bits):
    """The JAX package's quantized tree loaded into a float port model:
    ``do_predict`` within PROB_ATOL of the JAX ``InferenceModel`` (int8:
    the same codes and integer sums; int4: the same dequantized weights),
    top-3 equal."""
    jim, _ = quantized[bits]
    qparams = jax.tree.map(np.asarray, jim._params)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(
        cs.mobilenet_v1(**NARROW), qparams, weights[1])
    assert {m.bits for m in tim._model.modules()
            if hasattr(m, "bits")} == {bits}
    x = _images(44, 4)
    want, got = jim.do_predict(x), tim.do_predict(x)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert np.array_equal(np.argsort(-got, 1)[:, :3],
                          np.argsort(-want, 1)[:, :3])


@pytest.fixture
def tiny_phase(monkeypatch):
    """Phase 15's constants at a CPU size."""
    for name, value in (("MOBILENET", NARROW), ("MOBILENET_BATCH", 8),
                        ("MOBILENET_BATCHES", 4), ("MOBILENET_K", 2),
                        ("MOBILENET_CLASSES", 4), ("MOBILENET_LOCKSTEP", 2),
                        ("MOBILENET_SERVE_BATCH", 4),
                        ("MOBILENET_RECORDS", 8), ("MOBILENET_LR", 0.02)):
        monkeypatch.setattr(cs, name, value)
    init_context(device="cpu", seed=0)
    yield


def test_phase15_host_logic_on_cpu(tiny_phase):
    """The phase's fit (2 epochs, groups of 2: eager on the CPU), its
    checks with no launch expected, the lockstep pairs and the serving
    checks in f32, int8 and int4 against the plain route."""
    host = cs.mobilenet_v1(**cs.MOBILENET)
    host.init_weights(0)
    x, y, x_eval, _ = cs.mobilenet_data(0, batches=4)
    x_eval = np.concatenate([x_eval, x[:4]])
    pairs, fused = cs.mobilenet_lockstep(host, x, y, 0)
    assert len(pairs) == 2 and fused == 0
    assert max(abs(a - b) for a, b in pairs) <= cs.MOBILENET_LOSS_TOL
    model = copy.deepcopy(host)
    run = cs.mobilenet_train(model, x, y, 0)
    assert len(run["walls"]) == 2
    cs.check_mobilenet_train(run, card=False)
    served = cs.mobilenet_serve_phase(0, model.eval(), x_eval,
                                      torch.device("cpu"))
    assert sorted(served) == ["f32", "int4", "int8"]
