"""PyTorch port: losses, metrics, optimizers, schedules, triggers and the
FeatureSet against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Each
tolerance is stated where it is used, with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import triggers as jtrig
from analytics_zoo_tpu.feature import dataset as jdata
from analytics_zoo_tpu.nn import metrics as jmet
from analytics_zoo_tpu.nn import objectives as jobj
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.common import triggers as ttrig
from analytics_zoo_tpu_torch.feature import dataset as tdata
from analytics_zoo_tpu_torch.nn import metrics as tmet
from analytics_zoo_tpu_torch.nn import objectives as tobj
from analytics_zoo_tpu_torch.nn import optimizers as topt

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

# f32 elementwise math and small reductions in another order: a few ulps
ATOL, RTOL = 1e-6, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# -- losses --------------------------------------------------------------------

def _loss_inputs(name, g):
    """(y_pred, y_true) numpy pairs each loss is defined on: probabilities
    for the cross-entropies, log-probabilities for class_nll, +-1 targets
    for the hinges, positives for msle/poisson, ids for the sparse ones."""
    B, C = 6, 5
    logits = g.normal(size=(B, C)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    ids = g.integers(0, C, B)
    onehot = np.eye(C, dtype=np.float32)[ids]
    reg = g.normal(size=(B, 3, 2)).astype(np.float32)
    reg_t = g.normal(size=(B, 3, 2)).astype(np.float32)
    if name in ("categorical_crossentropy", "kld",
                "kullback_leibler_divergence"):
        return probs, onehot * 0.9 + 0.02
    if name == "sparse_categorical_crossentropy":
        return probs, ids.astype(np.int32)
    if name == "sparse_categorical_crossentropy_from_logits":
        return logits, ids[:, None].astype(np.int32)
    if name == "class_nll":
        return np.log(probs), ids.astype(np.float32)
    if name in ("binary_crossentropy",):
        return 1 / (1 + np.exp(-reg)), (reg_t > 0).astype(np.float32)
    if name in ("binary_crossentropy_from_logits",):
        return reg, (reg_t > 0).astype(np.float32)
    if name in ("hinge", "squared_hinge"):
        return reg, np.sign(reg_t).astype(np.float32)
    if name in ("msle", "mean_squared_logarithmic_error", "poisson"):
        return np.abs(reg) + 0.1, np.abs(reg_t)
    if name == "rank_hinge":
        return reg[:, 0, :1], None
    return reg, reg_t


@pytest.mark.parametrize("name", sorted(jobj._LOSSES))
def test_every_loss_matches_jax(name):
    g = np.random.default_rng(len(name))
    y_pred, y_true = _loss_inputs(name, g)
    jf, tf = jobj.get(name), tobj.get(name)
    if y_true is None:
        y_true = np.zeros_like(y_pred)
    want = np.asarray(jf(jnp.asarray(y_pred), jnp.asarray(y_true)))
    got = tf(_t(y_pred), _t(y_true)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_loss_get_resolves_callables_and_rejects_unknown():
    assert tobj.get(tobj.hinge) is tobj.hinge
    assert sorted(tobj._LOSSES) == sorted(jobj._LOSSES)
    with pytest.raises(ValueError, match="unknown loss"):
        tobj.get("nope")


def test_losses_are_differentiable():
    y = torch.rand(4, 5, requires_grad=True)
    tobj.sparse_categorical_crossentropy(
        torch.softmax(y, -1), torch.tensor([0, 1, 2, 3])).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()


# -- metrics -------------------------------------------------------------------

def _metric_batches(kind, g):
    """Two weighted batches (the second with weight-0 padding rows)."""
    out = []
    for n in (8, 6):
        w = np.ones(n, np.float32)
        w[-2:] = 0.0 if n == 6 else 1.0
        if kind == "multiclass":
            yp = g.normal(size=(n, 7)).astype(np.float32)
            yt = g.integers(0, 7, (n, 1)).astype(np.float32)
        elif kind == "onehot":
            yp = g.normal(size=(n, 7)).astype(np.float32)
            yt = np.eye(7, dtype=np.float32)[g.integers(0, 7, n)]
        elif kind == "binary":
            yp = g.uniform(size=(n, 1)).astype(np.float32)
            yt = (g.uniform(size=(n, 1)) > 0.5).astype(np.float32)
        else:   # regression
            yp = g.normal(size=(n, 3)).astype(np.float32)
            yt = g.normal(size=(n, 3)).astype(np.float32)
        out.append((yp, yt, w))
    return out


METRIC_CASES = [
    ("accuracy", lambda m: m.Accuracy(), "multiclass"),
    ("accuracy_onehot", lambda m: m.Accuracy(), "onehot"),
    ("accuracy_binary", lambda m: m.Accuracy(), "binary"),
    ("accuracy_one_based", lambda m: m.Accuracy(zero_based_label=False),
     "multiclass"),
    ("top3", lambda m: m.TopK(3), "multiclass"),
    ("top5", lambda m: m.Top5Accuracy(), "multiclass"),
    ("mae", lambda m: m.MAE(), "regression"),
    ("loss", lambda m: m.Loss((jobj if m is jmet else tobj)
                              .mean_squared_error), "regression"),
    ("auc", lambda m: m.AUC(50), "binary"),
]


@pytest.mark.parametrize("tag,make,kind", METRIC_CASES,
                         ids=[c[0] for c in METRIC_CASES])
def test_metrics_stream_like_jax(tag, make, kind):
    g = np.random.default_rng(len(tag))
    jm, tm = make(jmet), make(tmet)
    assert jm.name == tm.name
    ja, ta = jm.init(), tm.init()
    for yp, yt, w in _metric_batches(kind, g):
        ja = jm.update(ja, jnp.asarray(yp), jnp.asarray(yt), jnp.asarray(w))
        ta = tm.update(ta, _t(yp), _t(yt), _t(w))
    # AUC integrates 50 buckets of f32 rates: rounding of the sum
    assert tm.result(ta) == pytest.approx(jm.result(ja), abs=1e-6)


def test_metric_get():
    assert isinstance(tmet.get("ACC"), tmet.Accuracy)
    assert tmet.get("top5").name == "top5_accuracy"
    assert isinstance(tmet.get("auc"), tmet.AUC)
    m = tmet.MAE()
    assert tmet.get(m) is m and isinstance(tmet.get(tmet.MAE), tmet.MAE)
    with pytest.raises(ValueError, match="unknown metric"):
        tmet.get("nope")


# -- schedules -----------------------------------------------------------------

SCHEDULES = [
    ("poly", lambda o: o.poly(0.1, 2.0, 10)),
    ("warmup", lambda o: o.warmup(0.01, 5, 0.002)),
    ("sequential", lambda o: o.sequential_schedule(
        [o.warmup(0.0, 3, 0.01), o.poly(0.03, 1.0, 6)], [3])),
    ("warmup_poly", lambda o: o.warmup_poly(0.05, 4, 12, 1.5)),
    ("exp", lambda o: o.exponential_decay(0.1, 0.5, 3)),
    ("exp_staircase", lambda o: o.exponential_decay(0.1, 0.5, 3, True)),
]


@pytest.mark.parametrize("tag,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_optax(tag, make):
    js, ts = make(jopt), make(topt)
    for count in range(16):
        # optax evaluates in f32, the port in float64 on the host
        assert ts(count) == pytest.approx(float(js(jnp.int32(count))),
                                          rel=1e-6, abs=1e-9)


# -- optimizers ----------------------------------------------------------------

SHAPES = {"W": (4, 3), "b": (3,), "ln": {"gamma": (3,), "beta": (3,)}}


def _tree(g, shapes, scale=1.0):
    return {k: _tree(g, v, scale) if isinstance(v, dict)
            else (scale * g.normal(size=v)).astype(np.float32)
            for k, v in shapes.items()}


def _flat(tree):
    return [a for _, a in sorted(jax.tree_util.tree_flatten_with_path(
        tree)[0], key=lambda kv: jax.tree_util.keystr(kv[0]))]


def _run_both(make, n_steps=5, grad_scale=1.0, zero_grads=False, seed=0,
              clip_norm=None, clip_value=None):
    """``n_steps`` updates of one param dict by the JAX optimizer (optax)
    and by the port's, from the same params and gradients.  Returns the
    two final parameter lists (leaves in the same order)."""
    g = np.random.default_rng(seed)
    params = _tree(g, SHAPES)
    grads = [_tree(g, SHAPES, grad_scale) for _ in range(n_steps)]
    if zero_grads:
        grads = [jax.tree.map(np.zeros_like, gr) for gr in grads]
    jo, to = make(jopt), make(topt)
    if clip_norm or clip_value:
        jo = jopt.with_gradient_clipping(jo, clip_norm, clip_value)
        to = topt.with_gradient_clipping(to, clip_norm, clip_value)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in _flat(params)]
    ts = to.init(tp)
    for gr in grads:
        upd, js = jo.update(jax.tree.map(jnp.asarray, gr), js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(a.copy()) for a in _flat(gr)]
        topt.apply_updates(tp, to.update(tg, ts, tp))
    return [np.asarray(a) for a in _flat(jp)], [t.numpy() for t in tp]


OPTIMIZERS = [
    ("sgd", lambda o: o.SGD(0.1)),
    ("sgd_momentum", lambda o: o.SGD(0.1, momentum=0.9)),
    ("sgd_nesterov", lambda o: o.SGD(0.1, momentum=0.9, nesterov=True)),
    ("sgd_keras_decay", lambda o: o.SGD(0.1, decay=0.5)),
    ("adam", lambda o: o.Adam(0.01)),
    ("adam_keras_decay", lambda o: o.Adam(0.01, decay=0.3)),
    ("adam_schedule", lambda o: o.Adam(schedule=o.poly(0.01, 1.0, 4))),
    ("adamw", lambda o: o.AdamWeightDecay(0.01, weight_decay=0.1)),
    ("adamw_warmup", lambda o: o.AdamWeightDecay(0.01, 0.4, 5)),
    ("rmsprop", lambda o: o.RMSprop(0.01)),
    ("adagrad", lambda o: o.Adagrad(0.1)),
    ("adadelta", lambda o: o.Adadelta(1.0)),
    ("adamax", lambda o: o.Adamax(0.02)),
    ("nadam", lambda o: o.Nadam(0.02)),
    ("ftrl", lambda o: o.Ftrl(0.5)),
]


@pytest.mark.parametrize("tag,make", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizers_match_optax_over_five_updates(tag, make):
    """Same params, same 5 gradients.  f32 on both sides; the moments and
    divisions are rounded in another order (XLA fuses, torch runs one op
    at a time), a few ulps of the parameters."""
    want, got = _run_both(make)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_warmup_gives_the_first_step_a_learning_rate_of_zero():
    """optax reads a schedule at the count before the update: the first
    AdamW step of a warm-up from 0 moves nothing (torch.optim would read
    it after)."""
    for o in (jopt, topt):
        assert o.warmup_poly(0.1, 4, 10)(0) == 0.0
    want, got = _run_both(lambda o: o.AdamWeightDecay(0.01, 0.4, 5),
                          n_steps=1)
    g = np.random.default_rng(0)
    start = _flat(_tree(g, SHAPES))
    for a, b, p0 in zip(got, want, start):
        np.testing.assert_array_equal(a, p0)
        np.testing.assert_array_equal(b, p0)


def test_adamw_decays_biases_and_layernorm_with_zero_gradients():
    """optax.adamw decays every leaf: with zero gradients each step is
    p -= lr * wd * p, biases and LayerNorm included."""
    want, got = _run_both(lambda o: o.AdamWeightDecay(0.1, weight_decay=0.5),
                          n_steps=3, zero_grads=True)
    g = np.random.default_rng(0)
    start = _flat(_tree(g, SHAPES))
    for a, b, p0 in zip(got, want, start):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(a, p0 * (1 - 0.1 * 0.5) ** 3, rtol=1e-6)


@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (0.01, False)])
def test_global_norm_clipping_matches_optax(grad_scale, clipped):
    """Above the threshold every leaf scales by max_norm/|g|; below it the
    gradients pass unchanged (no epsilon, unlike clip_grad_norm_)."""
    g = np.random.default_rng(3)
    grads = [torch.from_numpy(a) for a in
             _flat(_tree(g, SHAPES, grad_scale))]
    norm = float(topt.global_norm(grads))
    assert (norm > 1.0) is clipped
    out = topt.ClipByGlobalNorm(1.0).update([t.clone() for t in grads], {},
                                            None)
    if clipped:
        assert float(topt.global_norm(out)) == pytest.approx(1.0, rel=1e-6)
    else:
        assert all(torch.equal(a, b) for a, b in zip(out, grads))
    want, got = _run_both(lambda o: o.SGD(0.1), grad_scale=grad_scale,
                          clip_norm=1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_clip_value_then_norm_matches_optax():
    want, got = _run_both(lambda o: o.Adam(0.01), grad_scale=3.0,
                          clip_norm=2.0, clip_value=0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_optimizer_get():
    assert isinstance(topt.get("Adam"), topt.Chain)
    opt = topt.SGD()
    assert topt.get(opt) is opt
    assert sorted(topt._OPTIMIZERS) == sorted(jopt._OPTIMIZERS)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get("lamb")


# -- triggers ------------------------------------------------------------------

def _states(m):
    return [m.TrainState(epoch=e, iteration=i, loss=l, score=s,
                         epoch_finished=f)
            for e, i, l, s, f in [(0, 0, float("inf"), None, False),
                                  (1, 10, 0.5, 0.7, True),
                                  (2, 15, 0.05, 0.95, False),
                                  (3, 20, 0.2, None, True)]]


TRIGGERS = [
    ("every_epoch", lambda m: m.EveryEpoch()),
    ("several_iteration", lambda m: m.SeveralIteration(5)),
    ("max_epoch", lambda m: m.MaxEpoch(2)),
    ("max_iteration", lambda m: m.MaxIteration(15)),
    ("max_score", lambda m: m.MaxScore(0.9)),
    ("min_loss", lambda m: m.MinLoss(0.1)),
    ("and", lambda m: m.MaxEpoch(1) & m.EveryEpoch()),
    ("or", lambda m: m.MinLoss(0.1) | m.MaxIteration(20)),
    ("and_or_classes", lambda m: m.Or(m.And(m.MaxEpoch(2),
                                            m.EveryEpoch()),
                                      m.MaxScore(0.9))),
]


@pytest.mark.parametrize("tag,make", TRIGGERS, ids=[t[0] for t in TRIGGERS])
def test_triggers_match_jax(tag, make):
    jt, tt = make(jtrig), make(ttrig)
    assert [tt(s) for s in _states(ttrig)] == [jt(s) for s in _states(jtrig)]


# -- FeatureSet ----------------------------------------------------------------

@pytest.mark.parametrize("n,batch,shuffle", [(37, 8, True), (32, 8, False),
                                             (5, 8, True)])
def test_feature_set_batches_match_jax(n, batch, shuffle):
    """Same shuffle generator, same order, same weight-0 padding with
    copies of sample 0."""
    g = np.random.default_rng(n)
    x = [g.normal(size=(n, 3)).astype(np.float32), g.integers(0, 9, (n, 2))]
    y = g.integers(0, 4, (n,))
    jb = list(jdata.ArrayFeatureSet(x, y).batches(
        batch, shuffle=shuffle, rng=np.random.default_rng(42)))
    tb = list(tdata.ArrayFeatureSet(x, y).batches(
        batch, shuffle=shuffle, rng=np.random.default_rng(42)))
    assert len(jb) == len(tb) == -(-n // batch)
    for (jx, jy, jw), (tx, ty, tw) in zip(jb, tb):
        for a, b in zip(jx, tx):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jy, ty)
        np.testing.assert_array_equal(jw, tw)
        assert tw.shape == (batch,)
    fs = tdata.FeatureSet.from_arrays(x[0], y)
    assert fs.size() == n
    a, b = fs.split(0.5, seed=1)
    assert a.size() + b.size() == n
    assert fs.partition(0, 2).size() == n // 2
