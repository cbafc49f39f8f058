"""PyTorch port: the recommendation slice against the JAX package, on the
CPU.

The same numpy inputs (fixed seeds) go through the JAX function and the
port's, and the JAX weights are carried across with ``load_jax_params``:

- ``Embedding``: ids in range, float ids with fractions, ids in [-V, -1]
  (wrapped), ids >= V and < -V (a row of NaN on both sides), and the
  table's gradient of a sum loss (none to an out-of-range id's row);
- every other layer of ``nn/layers/core.py`` the slice adds, against its
  JAX twin (forward and output shape), the noise layers by the mean and
  variance of their draws;
- ``NeuralCF`` (both ``include_mf`` branches): ``predict``,
  ``recommend_for_user`` / ``recommend_for_item``; ``Estimator.fit`` for
  two epochs of seeded ``training_arrays`` (the loss at every step, the
  trained parameters, ``evaluate``), then ``evaluate_ranking`` (HR@10,
  NDCG@10) on the same trained weights;
- the numpy data pipeline, exactly: ``hit_ratio``, ``ndcg``,
  ``generate_negative_samples``, ``load_ml1m``, ``synthetic_ml1m``,
  ``leave_one_out``, ``training_arrays``, ``_cross_columns`` and
  ``to_model_inputs``;
- ``WideAndDeep`` for each model type (forward), and a short ``fit`` of
  ``wide_n_deep`` step by step;
- int8 and int4 predict of both models through the port's plain routes
  against the JAX package's ``do_quantize`` + ``do_predict`` on the same
  weights and calibration batch ``[(users, items)]``: weight codes and
  scales, the activation codes of every quantized layer, probabilities.

Each tolerance is stated where it is used, with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.models.recommendation import movielens as jml
from analytics_zoo_tpu.models.recommendation import wide_and_deep as jwad
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import (ZooConf, ZooContext,
                                                    init_context)
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.models.recommendation import movielens as tml
from analytics_zoo_tpu_torch.models.recommendation import \
    wide_and_deep as twad
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """Both packages at the f32 dtype policy the tolerances here assume
    (each policy is process-global), and the port's context on the CPU
    (``predict`` of a zoo model reads it)."""
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    init_context(device="cpu", seed=42)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v.detach().cpu() if isinstance(
                v, torch.Tensor) else v)
    return out


# -- Embedding -----------------------------------------------------------------

V, D = 7, 5
EMBED_IDS = {
    "in_range": np.array([[0, 1, 6], [3, 3, 2]], np.float32),
    "fractions": np.array([[-0.5, 3.99, 0.2], [5.5, -0.99, 6.999]],
                          np.float32),
    "wrapped": np.array([[-1, -7, -3], [-2.5, -6.0, 0]], np.float32),
    "out_of_range": np.array([[7, -8, 100], [2, -7.5, 3e10]], np.float32),
    "saturated": np.array([[-3e10, np.nan, np.inf], [-np.inf, 1.5, 4]],
                          np.float32),
    "int_ids": np.array([[6, -1, 9], [0, -8, 2]], np.int32),
}


def _embed_pair(seed=0):
    je = jcore.Embedding(V, D, name="emb")
    E = np.asarray(je.build(jax.random.PRNGKey(seed), (3,))["E"])
    te = tcore.Embedding(V, D, name="emb")
    load_jax_params(te, {"E": E})
    return je, E, te


@pytest.mark.parametrize("case", sorted(EMBED_IDS))
def test_embedding_forward_matches_jax(case):
    """Exact: a gather moves the table's values unchanged.  Out-of-range
    ids give a row of NaN on both sides (``assert_array_equal`` takes NaN
    as equal to NaN), and the NaN rows sit where the JAX package puts
    them."""
    je, E, te = _embed_pair()
    x = EMBED_IDS[case]
    want = np.asarray(je.call({"E": E}, jnp.asarray(x)))
    got = te(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == x.shape + (D,)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(want).any() == (case in ("out_of_range", "int_ids",
                                             "saturated"))


@pytest.mark.parametrize("case", sorted(EMBED_IDS))
def test_embedding_table_gradient_matches_jax(case):
    """The gradient of a sum loss on the table, exact (counts of ids a
    row): a wrapped id's row gets its gradient, an out-of-range id's
    clamped row gets none."""
    je, E, te = _embed_pair(1)
    x = EMBED_IDS[case]
    w = np.random.default_rng(3).normal(size=x.shape + (D,)).astype(
        np.float32)

    def jloss(E):
        y = je.call({"E": E}, jnp.asarray(x))
        return jnp.sum(jnp.where(jnp.isnan(y), 0.0, y * w))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(E)))
    y = te(torch.from_numpy(x))
    (torch.nan_to_num(y, nan=0.0) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(te.E.grad.numpy(), want)
    te.E.grad = None
    te(torch.from_numpy(x)).sum().backward()     # NaN in the loss
    assert torch.isfinite(te.E.grad).all()
    if case == "out_of_range":
        # row 0 once, for -7.5 (-> -7, wrapped), not for the four ids out
        # of range that gather it clamped; row 2 once
        want_rows = torch.zeros(V, D)
        want_rows[[0, 2]] = 1.0
        assert torch.equal(te.E.grad, want_rows)


def test_embedding_init_and_graph_shape():
    """U(-0.05, 0.05) as the JAX ``uniform``; (B, *shape) -> (B, *shape,
    D)."""
    te = tcore.Embedding(1000, 16)
    assert te.E.shape == (1000, 16)
    E = te.E.detach()
    assert float(E.abs().max()) <= 0.05
    assert abs(float(E.mean())) < 0.003
    assert te.compute_output_shape((3,)) == (3, 16)


# -- the rest of core.py -----------------------------------------------------------

def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _masked():
    x = _x((3, 5, 4), 9)
    x[0, 1] = 0.0
    x[2, 4] = 0.0
    x[1, 2, :2] = 0.0                 # partly zero: kept
    return x


# (name, JAX layer, port layer, input shape without the batch axis, input)
CORE_CASES = {
    "reshape": (lambda m: m.Reshape((4, 6)), (2, 3, 4), None),
    "reshape_infer": (lambda m: m.Reshape((-1, 3)), (2, 3, 4), None),
    "permute": (lambda m: m.Permute((3, 1, 2)), (2, 3, 4), None),
    "repeat_vector": (lambda m: m.RepeatVector(3), (5,), None),
    "squeeze": (lambda m: m.Squeeze(2), (4, 1, 3), None),
    "squeeze_last": (lambda m: m.Squeeze(-1), (4, 1), None),
    "expand_dim": (lambda m: m.ExpandDim(1), (4, 3), None),
    "expand_dim_last": (lambda m: m.ExpandDim(-1), (4, 3), None),
    "lambda": (lambda m: m.Lambda(lambda t: t[:, 1:3] * 2.0 + 1.0),
               (5, 2), None),
    "select": (lambda m: m.Select(1, 2), (4, 3), None),
    "select_negative": (lambda m: m.Select(-1, -1), (4, 3), None),
    "narrow": (lambda m: m.Narrow(2, 1, 2), (3, 4), None),
    "narrow_negative": (lambda m: m.Narrow(1, -3, 2), (5, 2), None),
    "input_layer": (lambda m: m.InputLayer(input_shape=(4,)), (4,), None),
    "masking": (lambda m: m.Masking(0.0), (5, 4), _masked),
    "gaussian_noise_eval": (lambda m: m.GaussianNoise(0.3), (6,), None),
    "gaussian_dropout_eval": (lambda m: m.GaussianDropout(0.2), (6,),
                              None),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_core_layer_matches_jax(case):
    """Exact: each of these layers moves or masks values without
    arithmetic (``Lambda``'s affine map is the same f32 ops on both
    sides; the noise layers outside training are the identity).  The
    port's output-shape rule against the JAX package's shape inference."""
    make, shape, data = CORE_CASES[case]
    jl, tl = make(jcore), make(tcore)
    x = data() if data else _x((3,) + shape, len(case))
    want = np.asarray(jl.call({}, jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tuple(tl.compute_output_shape(shape)) == \
        tuple(jl.get_output_shape(shape))


def test_lambda_over_a_list():
    jl = jcore.Lambda(lambda xs: xs[0] * xs[1])
    tl = tcore.Lambda(lambda xs: xs[0] * xs[1])
    a, b = _x((2, 3), 1), _x((2, 3), 2)
    np.testing.assert_array_equal(
        tl([torch.from_numpy(a), torch.from_numpy(b)]).numpy(),
        np.asarray(jl.call({}, [jnp.asarray(a), jnp.asarray(b)])))
    assert tl.compute_output_shape([(3,), (3,)]) == (3,)


def test_squeeze_of_a_wide_axis_raises_as_jax_does():
    x = _x((2, 3, 4))
    with pytest.raises(ValueError):
        jcore.Squeeze(1).call({}, jnp.asarray(x))
    with pytest.raises(ValueError, match="cannot squeeze"):
        tcore.Squeeze(1)(torch.from_numpy(x))


N_NOISE = 400_000


@pytest.mark.parametrize("kind", ["noise", "dropout"])
def test_noise_layers_match_jax_in_distribution(kind):
    """The port draws from its own generator, so its draws match the JAX
    layer's in distribution: the implied N(0, 1) draws of both have mean
    within 5 sigma of 0 (sigma = 1/sqrt(n)) and variance within 5 sigma
    of 1 (sigma = sqrt(2/n)), and the two variances agree to 2 % (far
    above the 0.3 % sampling noise at n = 400,000, far below a wrong
    scale).  The same seed draws the same noise, another seed another."""
    x = np.random.default_rng(7).uniform(0.5, 1.5, N_NOISE).astype(
        np.float32)[None]
    if kind == "noise":
        jl, tl = jcore.GaussianNoise(0.3), tcore.GaussianNoise(0.3)

        def draws(y):
            return (y - x) / 0.3
    else:
        jl, tl = jcore.GaussianDropout(0.2), tcore.GaussianDropout(0.2)
        std = np.sqrt(0.2 / 0.8)

        def draws(y):
            return (y / x - 1.0) / std
    jy = np.asarray(jl.call({}, jnp.asarray(x), training=True,
                            rng=jax.random.PRNGKey(5)))
    tl.train()
    tl.seed_dropout(5)
    ty = tl(torch.from_numpy(x)).numpy()
    moments = []
    for y in (jy, ty):
        z = draws(y.astype(np.float64))
        assert abs(z.mean()) < 5 / np.sqrt(N_NOISE)
        assert abs(z.var() - 1.0) < 5 * np.sqrt(2 / N_NOISE)
        moments.append(z.var())
    assert moments[1] == pytest.approx(moments[0], rel=0.02)
    assert np.array_equal(tl(torch.from_numpy(x)).numpy(), ty)
    tl.seed_dropout(6)
    assert not np.array_equal(tl(torch.from_numpy(x)).numpy(), ty)
    tl.eval()
    assert np.array_equal(tl(torch.from_numpy(x)).numpy(), x)


# -- NeuralCF ---------------------------------------------------------------------

USERS, ITEMS = 50, 30
NCF_GEO = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8),
               mf_embed=8)


def _ncf_pair(include_mf, seed=0):
    jn = jrec.NeuralCF(USERS, ITEMS, 2, include_mf=include_mf, **NCF_GEO)
    params = _np(jn.model.init_weights(jax.random.PRNGKey(seed)))
    tn = trec.NeuralCF(USERS, ITEMS, 2, include_mf=include_mf, **NCF_GEO,
                       device="cpu")
    tn.set_weights(params)
    return jn, tn, params


def _pairs(seed, n):
    g = np.random.default_rng(seed)
    return (g.integers(1, USERS + 1, (n, 1)).astype(np.float32),
            g.integers(1, ITEMS + 1, (n, 1)).astype(np.float32))


# f32 products of 8-32 terms in another order (XLA vs PyTorch CPU): read
# at ~6e-8 on probabilities ~0.5
PRED_ATOL = 1e-6


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_predict_matches_jax(include_mf):
    jn, tn, params = _ncf_pair(include_mf)
    assert tn.model.param_count() == sum(
        a.size for a in jax.tree.leaves(params))
    assert sorted(_leaves(export_params(tn.model))) == sorted(
        _leaves(params))
    u, i = _pairs(1, 77)
    want = jn.predict([u, i], batch_size=32)
    got = tn.predict([u, i], batch_size=32)
    assert got.shape == want.shape == (77, 2)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_recommend_matches_jax(include_mf):
    """The same top items / users in the same order, the same classes,
    and their scores within PRED_ATOL (the seeded weights leave no two
    scores of a list within 1e-5 of each other)."""
    jn, tn, _ = _ncf_pair(include_mf, seed=3)
    for call, ids, top in (("recommend_for_user", [1, 17, 50], 5),
                           ("recommend_for_item", [2, 30], 7)):
        want = getattr(jn, call)(ids, top, batch_size=16)
        got = getattr(tn, call)(ids, top, batch_size=16)
        assert len(got) == len(want) == len(ids) * top
        for a, b in zip(got, want):
            assert (a.user_id, a.item_id, a.prediction) == \
                (b.user_id, b.item_id, b.prediction)
            assert a.probability == pytest.approx(b.probability,
                                                  abs=PRED_ATOL)
        assert isinstance(got[0], trec.UserItemPrediction)


def _ml_small():
    ratings = jml.synthetic_ml1m(n_users=USERS, n_items=ITEMS,
                                 ratings_per_user=10, seed=4)
    return jml.leave_one_out(ratings)


@pytest.fixture(scope="module")
def ncf_trained():
    """The JAX and the port's Estimator, each fit for two epochs of
    ``training_arrays(..., seed=epoch)`` (batch 256: 9 steps an epoch, the
    last padded) from the same weights and shuffle seed, Adam 1e-3."""
    jn, tn, _ = _ncf_pair(True, seed=2)
    train_pos, test_pos = _ml_small()
    jax_context().set_seed(42)
    je = JaxEstimator(jn.model, optimizer=jopt.Adam(1e-3),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])
    te = Estimator(tn.model, optimizer=topt.Adam(1e-3),
                   loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"],
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    for epoch in range(2):
        users, items, labels = jml.training_arrays(train_pos, ITEMS,
                                                   n_neg=4, seed=epoch)
        je.fit([users, items], labels, batch_size=256, epochs=1,
               verbose=False)
        te.fit([users, items], labels, batch_size=256, epochs=1,
               verbose=False)
    return dict(jn=jn, tn=tn, je=je, te=te, losses=losses,
                train_pos=train_pos, test_pos=test_pos,
                data=(users, items, labels))


def test_neuralcf_fit_loss_per_step_matches_jax(ncf_trained):
    """Each step's weighted loss, as ``test_torch_port_train.py`` holds
    ``fit``: atol 1e-5 (f32 forward and backward in another summation
    order, read at ~1e-7 on losses ~0.5-0.7); and the loss falls."""
    lj, lp = ncf_trained["losses"]["jax"], ncf_trained["losses"]["port"]
    n_pos = len(ncf_trained["train_pos"])
    assert len(lj) == len(lp) == 2 * -(-5 * n_pos // 256)
    np.testing.assert_allclose(lp, lj, atol=1e-5)
    assert np.mean(lp[-4:]) < np.mean(lp[:4])


def test_neuralcf_fit_trained_params_match_jax(ncf_trained):
    """Leaf by leaf after 18 Adam steps, at ``test_torch_port_train.py``'s
    atol 5e-5 (a twentieth of lr: an element whose gradient is at f32
    noise moves by up to lr a step in a direction the noise picks)."""
    want = _leaves(_np(ncf_trained["je"].params))
    got = _leaves(export_params(ncf_trained["tn"].model))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=5e-5,
                                   err_msg=path)


def test_neuralcf_evaluate_after_fit_matches_jax(ncf_trained):
    """Loss to 1e-5 (f32 noise), accuracy equal (no probability within
    f32 noise of 0.5)."""
    users, items, labels = ncf_trained["data"]
    ej = ncf_trained["je"].evaluate([users, items], labels, batch_size=256)
    ep = ncf_trained["te"].evaluate([users, items], labels, batch_size=256)
    assert ep["loss"] == pytest.approx(ej["loss"], abs=1e-5)
    assert ep["accuracy"] == pytest.approx(ej["accuracy"], abs=1e-7)


def test_neuralcf_evaluate_ranking_matches_jax(ncf_trained):
    """HR@10 and NDCG@10 of the NCF protocol (the user's seen items
    excluded from the negatives) on the JAX package's trained weights,
    loaded into the port: equal, since no negative's score is within f32
    noise of its positive's.  The ranking must beat chance (10/21 here:
    21 candidates a user)."""
    jn, train_pos, test_pos = (ncf_trained["jn"], ncf_trained["train_pos"],
                               ncf_trained["test_pos"])
    trained = _np(ncf_trained["je"].params)
    jn.model.set_weights(trained)
    tn = trec.NeuralCF(USERS, ITEMS, 2, include_mf=True, **NCF_GEO,
                       device="cpu")
    tn.set_weights(trained)
    seen = {}
    for u, i in train_pos:
        seen.setdefault(int(u), set()).add(int(i))
    kw = dict(num_neg=20, k=10, seed=123, batch_size=64, exclude_pos=seen)
    want = jrec.evaluate_ranking(jn, test_pos, ITEMS, **kw)
    got = trec.evaluate_ranking(tn, test_pos, ITEMS, **kw)
    assert got == want
    assert set(got) == {"hit_ratio", "ndcg"}
    # through an InferenceModel as well (its predict is do_predict)
    im = InferenceModel(2, 64, device="cpu").do_load_model(tn.model)
    assert trec.evaluate_ranking(im, test_pos, ITEMS, **kw) == want


# -- the numpy pipeline ----------------------------------------------------------

def test_ranking_metrics_match_jax():
    g = np.random.default_rng(0)
    scores = g.normal(size=(200, 51)).astype(np.float32)
    scores[:40, 0] = 10.0
    scores[40:60, 0] = -10.0
    for k in (1, 5, 10, 50):
        assert trec.hit_ratio(scores, k) == jrec.hit_ratio(scores, k)
        assert trec.ndcg(scores, k) == jrec.ndcg(scores, k)


def test_negative_samples_match_jax():
    pairs = np.array([[1, 2], [1, 3], [2, 2], [3, 9], [3, 1]], np.int64)
    for neg, seed in ((1, 0), (4, 7)):
        want = jrec.generate_negative_samples(pairs, 9, neg, seed)
        got = trec.generate_negative_samples(pairs, 9, neg, seed)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_movielens_pipeline_matches_jax(tmp_path):
    kw = dict(n_users=60, n_items=40, ratings_per_user=12, dim=8, seed=5)
    want = jml.synthetic_ml1m(**kw)
    got = tml.synthetic_ml1m(**kw)
    np.testing.assert_array_equal(got, want)
    tr_w, te_w = jml.leave_one_out(want)
    tr_g, te_g = tml.leave_one_out(got)
    np.testing.assert_array_equal(tr_g, tr_w)
    np.testing.assert_array_equal(te_g, te_w)
    for seed in (0, 1):
        for a, b in zip(tml.training_arrays(tr_g, 40, n_neg=4, seed=seed),
                        jml.training_arrays(tr_w, 40, n_neg=4, seed=seed)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.float32
    (tmp_path / "ratings.dat").write_text(
        "1::1193::5::978300760\n1::661::3::978302109\n"
        "2::1193::4::978298413\n2::3952::1::978299000\nbroken line\n")
    np.testing.assert_array_equal(tml.load_ml1m(str(tmp_path)),
                                  jml.load_ml1m(str(tmp_path)))
    got, tag = tml.load_or_synthesize(str(tmp_path))
    want, jtag = jml.load_or_synthesize(str(tmp_path))
    np.testing.assert_array_equal(got, want)
    assert tag == jtag
    assert (tml.ML1M_USERS, tml.ML1M_ITEMS) == (6040, 3706)


CROSS_CASES = [
    ("education_id_occupation_id",
     {"education_id": 1, "occupation_id": 1, "education": 1}),
    ("a_b_c", {"a": 1, "a_b": 1, "b_c": 1}),          # backtracks past a_b
    ("a_b_c", {"a": 1, "a_b": 1, "b_c": None}),       # no usable split
    ("age_bucket_hours_bucket", {"age_bucket": 1, "hours_bucket": 1,
                                 "age_bucket_hours_bucket": None}),
    ("x_y", {"x_y": 1}),                              # never itself
]


@pytest.mark.parametrize("name,columns", CROSS_CASES)
def test_cross_columns_match_jax(name, columns):
    assert twad._cross_columns(name, columns) == \
        jwad._cross_columns(name, columns)


def _info(mod):
    return mod.ColumnFeatureInfo(
        wide_base_cols=["age_bucket", "edu_id"], wide_base_dims=[4, 5],
        wide_cross_cols=["age_bucket_edu_id"], wide_cross_dims=[7],
        indicator_cols=["wc_id", "gender_id"], indicator_dims=[3, 2],
        embed_cols=["edu_id", "occ_id"], embed_in_dims=[5, 6],
        embed_out_dims=[3, 4], continuous_cols=["age_norm", "hours_norm"])


def _columns(n, seed):
    g = np.random.default_rng(seed)
    return {"age_bucket": g.integers(0, 4, n), "edu_id": g.integers(0, 5, n),
            "occ_id": g.integers(0, 6, n), "wc_id": g.integers(0, 3, n),
            "gender_id": g.integers(0, 2, n),
            "age_norm": g.normal(size=n), "hours_norm": g.normal(size=n)}


MODEL_TYPES = ["wide", "deep", "wide_n_deep"]


def _wad_pair(model_type, seed=0):
    jw = jwad.WideAndDeep(2, _info(jwad), model_type, hidden_layers=(8, 4))
    params = _np(jw.model.init_weights(jax.random.PRNGKey(seed)))
    tw = twad.WideAndDeep(2, _info(twad), model_type, hidden_layers=(8, 4),
                          device="cpu")
    tw.set_weights(params)
    return jw, tw, params


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_to_model_inputs_match_jax(model_type):
    jw, tw, _ = _wad_pair(model_type)
    cols = _columns(33, 1)
    want, got = jw.to_model_inputs(cols), tw.to_model_inputs(cols)
    assert len(got) == len(want) == {"wide": 1, "deep": 3,
                                     "wide_n_deep": 4}[model_type]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert dataclasses.asdict(_info(twad)) == dataclasses.asdict(_info(jwad))
    assert _info(twad).wide_dim == 16 and _info(twad).indicator_dim == 5


def test_to_model_inputs_unknown_cross_raises():
    info = dataclasses.replace(_info(twad), wide_cross_cols=["nope_none"])
    tw = twad.WideAndDeep(2, info, "wide", device="cpu")
    with pytest.raises(ValueError, match="matches no input columns"):
        tw.to_model_inputs(_columns(3, 0))


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_wide_and_deep_forward_matches_jax(model_type):
    """f32 products of up to 16 terms in another order: PRED_ATOL."""
    jw, tw, params = _wad_pair(model_type)
    assert tw.model.param_count() == sum(
        a.size for a in jax.tree.leaves(params))
    x = jw.to_model_inputs(_columns(45, 2))
    want = jw.predict(x, batch_size=16)
    got = tw.predict(x, batch_size=16)
    assert got.shape == want.shape == (45, 2)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)


def test_wide_and_deep_fit_losses_match_jax():
    """``wide_n_deep``, Adam 1e-3, 3 epochs of 96 rows at batch 32: the
    loss at every step (atol 1e-5, as for NeuralCF) and the trained
    parameters (atol 5e-5)."""
    jw, tw, _ = _wad_pair("wide_n_deep", seed=4)
    cols = _columns(96, 3)
    x = jw.to_model_inputs(cols)
    y = ((cols["age_norm"] + cols["edu_id"] * 0.3) > 0.6).astype(
        np.float32)[:, None]
    jax_context().set_seed(42)
    je = JaxEstimator(jw.model, optimizer=jopt.Adam(1e-3),
                      loss="sparse_categorical_crossentropy")
    te = Estimator(tw.model, optimizer=topt.Adam(1e-3),
                   loss="sparse_categorical_crossentropy",
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    je.fit(x, y, batch_size=32, epochs=3, verbose=False)
    te.fit(x, y, batch_size=32, epochs=3, verbose=False)
    assert len(losses["port"]) == len(losses["jax"]) == 9
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-5)
    want = _leaves(_np(je.params))
    got = _leaves(export_params(tw.model))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=5e-5,
                                   err_msg=path)


# -- quantized predict ------------------------------------------------------------

def _record_codes(monkeypatch, mod):
    """Patch ``mod.w8a8_dense`` to record the activation codes it is
    given, in call order."""
    seen = []

    def spy(x_q, *args, _fn=mod.w8a8_dense, **kwargs):
        seen.append(np.array(x_q.cpu() if isinstance(x_q, torch.Tensor)
                             else x_q))
        return _fn(x_q, *args, **kwargs)
    monkeypatch.setattr(mod, "w8a8_dense", spy)
    return seen


def _ncf_case():
    jn, tn, params = _ncf_pair(True, seed=6)
    calib = [_pairs(8, 64)]                 # one batch of (users, items)
    return jn.model, tn.model, params, calib, list(_pairs(9, 50)), 3


def _wad_case():
    jw, tw, params = _wad_pair("wide_n_deep", seed=7)
    calib = [tuple(jw.to_model_inputs(_columns(64, 8)))]
    return jw.model, tw.model, params, calib, \
        jw.to_model_inputs(_columns(50, 9)), 4


QUANT_CASES = {"neuralcf": _ncf_case, "wide_and_deep": _wad_case}


def _quantized(case, bits):
    jm, tm, params, calib, x, n_dense = QUANT_CASES[case]()
    jim = JaxIM(2, 64).do_load_model(jm, params, jm._state)
    tim = InferenceModel(2, 64, device="cpu").do_load_model(tm)
    jim.do_quantize(calib, force=True, bits=bits)
    tim.do_quantize(calib, force=True, bits=bits)
    return jim, tim, x, n_dense, tm


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_leaves_match_jax(case, bits):
    """Both sides quantize the same float weights, calibrated on the same
    batch ``[(users, items)]`` (a list of one multi-input batch): weight
    codes, their scales and the int4 group scales exactly equal, every
    ``Dense`` quantized.  An activation scale ``s_x`` is the absmax of a
    layer's input over the batch, which past the first layer is an f32
    sum in another order: within rtol 1e-6 (read at one ulp, 8e-8)."""
    jim, tim, _, n_dense, _ = _quantized(case, bits)
    want, got = _leaves(_np(jim._params)), _leaves(tim._params)
    assert sorted(got) == sorted(want)
    for path in want:
        if path.endswith("/s_x"):
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    key = "/W_q" if bits == 8 else "/W_q4"
    assert sum(p.endswith(key) for p in got) == n_dense


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_int8_predict_matches_jax(case, monkeypatch):
    """The JAX package's int8 tree loaded into the port (its codes and
    scales, ``s_x`` to the bit): the activation codes of every quantized
    layer exactly equal (the s8 products are then summed exactly on both
    sides), and the probabilities within PRED_ATOL (f32 noise in the
    float ops between the products).  The port's own quantized model
    (``s_x`` an ulp apart, above) gives the same probabilities within
    PRED_ATOL."""
    jim, own, x, n_dense, tm = _quantized(case, 8)
    tim = InferenceModel(2, 64, device="cpu").do_load_model(
        tm, _np(jim._params))
    want = jim.do_predict(x, batch_size=16)
    np.testing.assert_allclose(own.do_predict(x), want, atol=PRED_ATOL)
    jcodes = _record_codes(monkeypatch, jqm)
    tcodes = _record_codes(monkeypatch, tqm)
    jim._model.apply(jim._params, jim._state, [jnp.asarray(a) for a in x],
                     training=False)
    got = tim.do_predict(x, batch_size=64)
    assert len(jcodes) == len(tcodes) == n_dense
    for a, b in zip(tcodes, jcodes):
        np.testing.assert_array_equal(a[:len(b)], b)
    assert got.shape == want.shape == (50, 2)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_int4_predict_matches_jax(case):
    """Weight-only int4: both sides multiply f32 activations by the same
    dequantized weights; f32 noise over up to 16-term sums and a softmax:
    1e-5."""
    jim, tim, x, _, _ = _quantized(case, 4)
    np.testing.assert_allclose(tim.do_predict(x, batch_size=16),
                               jim.do_predict(x, batch_size=16), atol=1e-5)


def test_multi_input_bucket_padding_pads_every_input():
    """A 5-row two-input batch is padded to the 8-row bucket in both
    inputs; the padded rows (id 0, in range) never reach the result."""
    _, tn, _ = _ncf_pair(True)
    im = InferenceModel(2, 8, device="cpu").do_load_model(tn.model)
    shapes = []
    hook = tn.model.register_forward_pre_hook(
        lambda m, a: shapes.append([tuple(t.shape) for t in a[0]]))
    u, i = _pairs(11, 5)
    out = im.do_predict([u, i])
    hook.remove()
    assert shapes == [[(8, 1), (8, 1)]]
    np.testing.assert_allclose(out, tn.predict([u, i]), atol=1e-7)
    with pytest.raises(ValueError, match="single-input"):
        im.do_predict([u, i], scales=np.ones(5, np.float32))


def test_session_recommender_is_not_ported_yet():
    """The stub that raised is gone: ``SessionRecommender`` is ported
    (``tests/test_torch_port_session.py`` holds it against the JAX
    package) and builds its graph on the CPU."""
    sr = trec.SessionRecommender(10, item_embed=4, rnn_hidden_layers=(3,),
                                 session_length=4, device="cpu")
    assert sr.model.compute_output_shape(None) == (11,)
