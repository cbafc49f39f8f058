"""PyTorch port: ``automl`` against the JAX package on the CPU.

- The search space: every sampler, ``sample_config`` and every engine give
  the same configs for the same seed and space, over every recipe's
  ``search_space`` (with and without the ``selected_features`` subsets,
  the MTNet recipe's dependent ``lookback``); ``BayesSearchEngine`` and
  ``GridRandomSearchEngine`` with a deterministic ``train_fn`` give the
  same trials.  Compared exactly.
- ``TimeSequenceFeatureTransformer``: ``fit_transform``, ``transform``,
  ``inverse_scale_target``, ``post_processing``, ``save`` / ``restore``
  exactly equal, and a file saved by one package restores in the other.
- ``_build_trial_model``: the same layer names and param-tree keys and
  shapes for the LSTM, two-layer LSTM, Seq2seq and MTNet branches.
- ``TimeSequencePredictor.fit`` with ``SmokeRecipe`` and
  ``MTNetSmokeRecipe`` (dropout 0), each trial started from the JAX
  package's initial weights for its seed (the port looks them up by the
  seed it computed, so the trial seeds must be equal): trial MSEs within
  FIT_TOL of JAX's, the same best config, and the pipelines' ``predict``
  / ``evaluate`` within FIT_TOL.
- A thread-pooled grid (``parallelism=2``) gives the trial metrics of the
  sequential loop exactly.
- ``distributed=True`` is a no-op in one process.
- ``PopulationTrainer`` with batch = all rows (one step an epoch, so row
  order cannot matter), dropout 0 and the JAX members' initial weights:
  the ``(epochs, K)`` losses and the best member's parameters within
  POP_TOL of JAX's, and the same ``best_index``; dropout draws shaped
  (K, ...) per site under ``vmap``.

FIT_TOL = 1e-4: an Adam trajectory of up to 60 steps over f32 sums in
another order (XLA over 8 CPU devices against PyTorch's CPU kernels).
POP_TOL = 1e-5: 3 full-batch steps.
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.automl import feature as jfeature
from analytics_zoo_tpu.automl import population as jpopulation
from analytics_zoo_tpu.automl import regression as jregression
from analytics_zoo_tpu.automl import search as jsearch
from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.nn import models as jmodels
from analytics_zoo_tpu.nn.layers.core import Dense as JDense
from analytics_zoo_tpu.nn.layers.core import Dropout as JDropout
from analytics_zoo_tpu.nn.layers.recurrent import LSTM as JLSTM
from analytics_zoo_tpu_torch.automl import feature as tfeature
from analytics_zoo_tpu_torch.automl import population as tpopulation
from analytics_zoo_tpu_torch.automl import regression as tregression
from analytics_zoo_tpu_torch.automl import search as tsearch
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import init_context
from analytics_zoo_tpu_torch.nn import models as tmodels
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
from analytics_zoo_tpu_torch.nn.layers.recurrent import LSTM
from analytics_zoo_tpu_torch.utils.convert import export_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(600)

FIT_TOL = 1e-4
POP_TOL = 1e-5

RECIPES = ("SmokeRecipe", "MTNetSmokeRecipe", "RandomRecipe", "BayesRecipe",
           "GridRandomRecipe", "LSTMGridRandomRecipe",
           "MTNetGridRandomRecipe")


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    init_context(device="cpu", seed=42)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _series(n=300, seed=0, extra=False):
    g = np.random.default_rng(seed)
    t = np.arange(n)
    df = pd.DataFrame({
        "datetime": pd.date_range("2014-07-01", periods=n, freq="30min"),
        "value": (10 + 4 * np.sin(2 * np.pi * t / 48)
                  + g.normal(0, 0.3, n)).astype(np.float64)})
    if extra:
        df["temp"] = g.normal(20, 3, n)
        df["load"] = g.uniform(0, 1, n)
    return df


def _same(a, b):
    """Configs equal exactly: same keys, values of the same type and
    value (lists element by element)."""
    assert list(a) == list(b)
    for k in a:
        va, vb = a[k], b[k]
        assert type(va) is type(vb), (k, va, vb)
        if isinstance(va, list):
            assert [type(e) for e in va] == [type(e) for e in vb], k
        assert va == vb, (k, va, vb)


# -- the search space ----------------------------------------------------------

SAMPLERS = {
    "Uniform": lambda m: m.Uniform(0.1, 2.0),
    "LogUniform": lambda m: m.LogUniform(1e-4, 1e-1),
    "RandInt": lambda m: m.RandInt(3, 17),
    "QUniform": lambda m: m.QUniform(0.0, 5.0, 0.25),
    "Choice": lambda m: m.Choice([8, "a", 2.5]),
    "GridSearch": lambda m: m.GridSearch([1, 2, 3]),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_draw_the_same_values(name):
    js, ts = SAMPLERS[name](jsearch), SAMPLERS[name](tsearch)
    gj, gt = np.random.default_rng(11), np.random.default_rng(11)
    got = [ts.sample(gt) for _ in range(25)]
    want = [js.sample(gj) for _ in range(25)]
    assert got == want and [type(v) for v in got] == [type(v) for v in want]
    if name in ("Choice", "GridSearch"):
        assert ts.grid() == js.grid()
    else:
        with pytest.raises(NotImplementedError):
            ts.grid()


def test_sample_config_defers_sample_fns():
    def space(m):
        return {"a": m.RandInt(1, 4), "b": m.SampleFn(
            lambda cfg, rng: cfg["a"] * 10 + int(rng.integers(0, 3))),
            "c": 5, "d": m.Uniform(0, 1)}
    gj, gt = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(10):
        _same(tsearch.sample_config(space(tsearch), gt),
              jsearch.sample_config(space(jsearch), gj))


@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("recipe", RECIPES)
def test_recipes_sample_the_same_configs(recipe, features):
    jr, tr = getattr(jregression, recipe)(), getattr(tregression, recipe)()
    feats = tfeature.TimeSequenceFeatureTransformer(
        extra_features_col=["temp"]).get_feature_list() if features else ()
    assert feats == (list(jfeature.TimeSequenceFeatureTransformer(
        extra_features_col=["temp"]).get_feature_list()) if features else ())
    js, ts = jr.search_space(feats), tr.search_space(feats)
    assert list(js) == list(ts)
    je, te = jr.engine(), tr.engine()
    assert type(je).__name__ == type(te).__name__
    assert (je.mode, getattr(je, "parallelism", None)) == (
        te.mode, getattr(te, "parallelism", None))
    if hasattr(je, "sample_all"):
        got, want = te.sample_all(ts), je.sample_all(js)
    else:                     # BayesSearchEngine: its first draws
        gj, gt = np.random.default_rng(0), np.random.default_rng(0)
        want = [jsearch.sample_config(js, gj) for _ in range(6)]
        got = [tsearch.sample_config(ts, gt) for _ in range(6)]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same(a, b)
    if recipe == "MTNetGridRandomRecipe":
        assert all(c["lookback"] == (c["long_num"] + 1) * c["time_step"]
                   for c in got)
    if features and "selected_features" in ts:
        assert all(len(c["selected_features"]) >= 3 for c in got)


def _space(m):
    return {"x": m.Uniform(-2.0, 2.0), "y": m.LogUniform(1e-3, 1.0),
            "k": m.Choice([1, 2, 3]), "g": m.GridSearch([4, 5]),
            "q": m.QUniform(0.0, 1.0, 0.1),
            "dep": m.SampleFn(lambda cfg, rng: cfg["x"] * 2), "fixed": 7}


ENGINES = {
    "random": lambda m: m.RandomSearchEngine(n_trials=6, seed=3),
    "random_threads": lambda m: m.RandomSearchEngine(n_trials=6, seed=3,
                                                     parallelism=2),
    "grid": lambda m: m.GridSearchEngine(seed=4),
    "grid_random": lambda m: m.GridRandomSearchEngine(num_rand_samples=3,
                                                      seed=5),
    "bayes": lambda m: m.BayesSearchEngine(n_trials=12, seed=6),
    "bayes_max": lambda m: m.BayesSearchEngine(n_trials=12, seed=6,
                                               mode="max"),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engines_run_the_same_trials(engine):
    je, te = ENGINES[engine](jsearch), ENGINES[engine](tsearch)
    want = je.run(lambda c: (c["x"] - 0.3) ** 2 + c["y"] + c["k"],
                  _space(jsearch))
    got = te.run(lambda c: (c["x"] - 0.3) ** 2 + c["y"] + c["k"],
                 _space(tsearch))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a.config, b.config)
        assert a.metric == b.metric and not a.failed
    _same(te.get_best_config(), je.get_best_config())
    assert [f.name for f in dataclasses.fields(tsearch.Trial)] == \
        [f.name for f in dataclasses.fields(jsearch.Trial)]
    with pytest.raises(RuntimeError, match="no trials"):
        tsearch.RandomSearchEngine().get_best_trial()


# -- the feature transformer ---------------------------------------------------

@pytest.mark.parametrize("extra", [False, True])
def test_feature_transformer_matches_jax(extra, tmp_path):
    df = _series(240, seed=1, extra=extra)
    cols = ["temp", "load"] if extra else None
    sel = ("HOUR", "MINUTE", "IS_AWAKE", "temp") if extra else \
        ("HOUR", "DAY", "MONTH", "DAYOFWEEK", "WEEKEND", "IS_BUSY_HOURS")
    jft = jfeature.TimeSequenceFeatureTransformer(extra_features_col=cols)
    tft = tfeature.TimeSequenceFeatureTransformer(extra_features_col=cols)
    for a, b in zip(tft.fit_transform(df[:180], lookback=7, horizon=2,
                                      dt_features=sel),
                    jft.fit_transform(df[:180], lookback=7, horizon=2,
                                      dt_features=sel)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tft.transform(df[150:], lookback=7, horizon=2,
                                  dt_features=sel),
                    jft.transform(df[150:], lookback=7, horizon=2,
                                  dt_features=sel)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tft.transform(df[150:], lookback=5, dt_features=sel,
                      with_label=False),
        jft.transform(df[150:], lookback=5, dt_features=sel,
                      with_label=False))
    y = np.random.default_rng(0).normal(size=(20, 2)).astype(np.float32)
    np.testing.assert_array_equal(tft.inverse_scale_target(y),
                                  jft.inverse_scale_target(y))
    np.testing.assert_array_equal(tft.unscale_uncertainty(y),
                                  jft.unscale_uncertainty(y))
    pd.testing.assert_frame_equal(tft.post_processing(df, y, 7),
                                  jft.post_processing(df, y, 7))
    tft.save(str(tmp_path / "t.json"))
    jft.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    for src, cls in (("t.json", jfeature), ("j.json", tfeature)):
        back = cls.TimeSequenceFeatureTransformer.restore(
            str(tmp_path / src))
        np.testing.assert_array_equal(back._min, jft._min)
        np.testing.assert_array_equal(back._max, jft._max)
        assert back.extra == jft.extra
    for bad in (df[:5], df[::-1]):            # too short, descending
        with pytest.raises(ValueError) as want:
            jft.transform(bad, lookback=7)
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            tft.transform(bad, lookback=7)
    assert tfeature.ALL_DT_FEATURES == jfeature.ALL_DT_FEATURES


# -- trial models --------------------------------------------------------------

TRIAL_CFGS = {
    "lstm": {"model": "LSTM", "lstm_units": 6, "dropout": 0.1, "horizon": 2},
    "lstm2": {"model": "LSTM", "lstm_1_units": 7, "dropout_1": 0.2,
              "lstm_units": 5, "dropout": 0.0, "horizon": 1},
    "seq2seq": {"model": "Seq2seq", "latent_dim": 6, "dropout": 0.3,
                "horizon": 3},
    "mtnet": {"model": "MTNet", "time_step": 3, "long_num": 2,
              "filter_size": 4, "ar_size": 2, "dropout": 0.1, "horizon": 1},
}


def _tree_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_tree_shapes(v, path))
        else:
            out[path] = tuple(v.shape)
    return out


@pytest.mark.parametrize("kind", sorted(TRIAL_CFGS))
def test_build_trial_model_names_and_tree(kind):
    cfg = TRIAL_CFGS[kind]
    shape = (9, 3)
    jm = jregression._build_trial_model(cfg, shape)
    tm = tregression._build_trial_model(cfg, shape)
    assert jm.name == tm.name
    assert [(l.name, type(l).__name__) for l in jm.layers_list] == \
        [(l.name, type(l).__name__) for l in tm.layers_list]
    params, _ = jm.init(jax.random.PRNGKey(0), shape)
    assert _tree_shapes(export_params(tm)) == _tree_shapes(params)


# -- TimeSequencePredictor -----------------------------------------------------

@pytest.fixture
def jax_inits(monkeypatch):
    """Record the JAX package's trial initial weights by trial seed, and
    make the port's trials start from them: the port's ``init_weights``
    looks its seed up (a seed the JAX run never drew raises KeyError)."""
    inits = {}
    orig = jmodels.KerasNet.init_weights

    def record(self, rng=None, input_shape=None):
        params = orig(self, rng, input_shape)
        data = rng if rng.dtype == np.uint32 else jax.random.key_data(rng)
        seed = int(np.asarray(data)[-1])
        inits[seed] = jax.tree.map(np.asarray, params)
        return params

    def load(self, seed=0):
        self.set_weights(inits[int(seed)])
        return self

    monkeypatch.setattr(jmodels.KerasNet, "init_weights", record)
    monkeypatch.setattr(tmodels.Sequential, "init_weights", load,
                        raising=False)
    return inits


@pytest.mark.parametrize("recipe", ["SmokeRecipe", "MTNetSmokeRecipe"])
def test_predictor_fit_matches_jax(recipe, jax_inits, monkeypatch):
    df = _series(300, seed=2)
    train, val, test = df[:200], df[180:250], df[230:]
    jax_context().set_seed(42)
    jp = jregression.TimeSequencePredictor(
        recipe=getattr(jregression, recipe)())
    if recipe == "MTNetSmokeRecipe":
        # dropout 0 for parity: the dropout draws differ by design
        monkeypatch.setattr(jregression.MTNetSmokeRecipe, "search_space",
                            _no_dropout(jregression.MTNetSmokeRecipe))
        monkeypatch.setattr(tregression.MTNetSmokeRecipe, "search_space",
                            _no_dropout(tregression.MTNetSmokeRecipe))
    jpipe = jp.fit(train, val)
    tp = tregression.TimeSequencePredictor(
        recipe=getattr(tregression, recipe)(), device="cpu")
    tpipe = tp.fit(train, val)
    seeds = {tregression.trial_seed(t.config) for t in tp._last_trials}
    assert seeds <= set(jax_inits)
    assert len(tp._last_trials) == len(jp._last_trials)
    for a, b in zip(tp._last_trials, jp._last_trials):
        _same(a.config, b.config)
        assert abs(a.metric - b.metric) <= FIT_TOL, (a.metric, b.metric)
    _same(tpipe.config, jpipe.config)
    np.testing.assert_allclose(tpipe.predict(test), jpipe.predict(test),
                               atol=FIT_TOL, rtol=FIT_TOL)
    got = tpipe.evaluate(test, ("mse", "rmse", "mae", "smape"))
    want = jpipe.evaluate(test, ("mse", "rmse", "mae", "smape"))
    assert list(got) == list(want)
    for k in got:
        assert abs(got[k] - want[k]) <= FIT_TOL * max(1.0, abs(want[k])), k


def _no_dropout(cls):
    orig = cls.search_space

    def space(self, all_available_features=()):
        s = orig(self, all_available_features)
        s["dropout"] = type(s["lr"])([0.0])
        return s
    return space


def test_trial_seeds_match_jax_formula():
    cfg = {"model": "LSTM", "lr": 0.004, "lookback": np.int64(8),
           "selected_features": [np.str_("HOUR"), "temp"]}
    import json
    import zlib
    want = zlib.crc32(json.dumps(
        {k: repr(v) for k, v in sorted(cfg.items())}).encode())
    assert tregression.trial_seed(cfg) == want
    assert tregression.trial_seed(dict(cfg, lr=0.005)) != want


def test_thread_pooled_trials_equal_the_sequential_loop():
    df = _series(260, seed=3)

    def trials(parallelism):
        recipe = tregression.LSTMGridRandomRecipe(
            epochs=1, lstm_1_units=(6,), lstm_2_units=(4, 5),
            batch_size=(32,), parallelism=parallelism)
        p = tregression.TimeSequencePredictor(recipe=recipe, device="cpu")
        p.fit(df[:200], df[190:])
        return [(t.config, t.metric) for t in p._last_trials]
    two, one = trials(2), trials(1)
    assert len(two) == len(one) == 2
    for (ca, ma), (cb, mb) in zip(two, one):
        _same(ca, cb)
        assert ma == mb


def test_distributed_is_a_no_op_in_one_process():
    df = _series(200, seed=4)
    p = tregression.TimeSequencePredictor(recipe=tregression.SmokeRecipe(),
                                          distributed=True, device="cpu")
    pipe = p.fit(df[:150], df[140:])
    assert len(p._last_trials) == 2 and pipe.config["model"] == "LSTM"


# -- PopulationTrainer ---------------------------------------------------------

def _pop_models(T=6, D=2):
    jm = jmodels.Sequential()
    jm.add(JLSTM(5, input_shape=(T, D), name="pop_lstm"))
    jm.add(JDropout(0.0, name="pop_drop"))
    jm.add(JDense(2, name="pop_out"))
    tm = tmodels.Sequential()
    tm.add(LSTM(5, input_shape=(T, D), name="pop_lstm"))
    tm.add(Dropout(0.0, name="pop_drop"))
    tm.add(Dense(2, name="pop_out"))
    return jm, tm


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_population_trainer_matches_jax(monkeypatch):
    g = np.random.default_rng(5)
    x = g.normal(size=(40, 6, 2)).astype(np.float32)
    y = g.normal(size=(40, 2)).astype(np.float32)
    lrs = [1e-3, 5e-3, 2e-2, 5e-2]
    jm, tm = _pop_models()
    want = jpopulation.PopulationTrainer(jm).fit(
        x, y, lrs, epochs=3, batch_size=len(x), seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), len(lrs))
    inits = [jax.tree.map(np.asarray, jm.init(k, (6, 2))[0]) for k in keys]
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    monkeypatch.setattr(
        tpopulation.PopulationTrainer, "_member_init",
        lambda self, k, seed: self.model.set_weights(inits[k]))
    got = tpopulation.PopulationTrainer(tm).fit(
        x, y, lrs, epochs=3, batch_size=len(x), seed=0)
    assert got["losses"].shape == (3, len(lrs)) and got[
        "population_size"] == len(lrs)
    np.testing.assert_allclose(got["losses"], want["losses"], atol=POP_TOL,
                               rtol=POP_TOL)
    assert got["best_index"] == want["best_index"]
    assert got["best_lr"] == want["best_lr"]
    jb, tb = _flat(want["best_params"]), _flat(got["best_params"])
    assert sorted(tb) == sorted(jb)
    for path, leaf in jb.items():
        np.testing.assert_allclose(tb[path], leaf, atol=POP_TOL,
                                   rtol=POP_TOL, err_msg=path)
    for n, p in tm.named_parameters():     # the model's weights restored
        assert torch.equal(p, before[n]) and not tm.training


def test_population_trainer_dropout_draws_per_member():
    """With dropout on, each member draws its own masks (K, ...) a site a
    step from the trainer's generator: the run repeats exactly for one
    seed, and the members part for equal lrs."""
    T, D = 5, 2
    g = np.random.default_rng(6)
    x = g.normal(size=(48, T, D)).astype(np.float32)
    y = g.normal(size=(48, 1)).astype(np.float32)

    def model():
        m = tmodels.Sequential()
        m.add(LSTM(4, input_shape=(T, D), return_sequences=True,
                   name="d_lstm1"))
        m.add(Dropout(0.5, name="d_drop"))
        m.add(LSTM(3, name="d_lstm2"))
        m.add(Dense(1, name="d_out"))
        return m

    class Same(tpopulation.PopulationTrainer):
        def _member_init(self, k, seed):
            self.model.init_weights(0)

    a = Same(model()).fit(x, y, [1e-2] * 3, epochs=2, batch_size=16)
    b = Same(model()).fit(x, y, [1e-2] * 3, epochs=2, batch_size=16)
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert len(set(np.round(a["losses"][-1], 7))) == 3
    assert np.isfinite(a["losses"]).all()
