"""PyTorch port: the tagger models (``models/textmodels``: ``NER``,
``SequenceTagger``, ``IntentEntity``) against the JAX package's on the
CPU, at a narrow width (vocabularies 50 words / 20 characters, words of 4
characters, sentences of 6, embeddings 8 and 5, LSTM 6).

The JAX model's seeded param tree goes into the port's through
``load_jax_params``; inputs and labels are seeded numpy arrays:

- the param trees' leaves and shapes are equal;
- eval-mode outputs within TOL = 1e-5: NER's emissions and its CRF
  potentials broadcast over the batch, SequenceTagger's two per-token
  heads, IntentEntity's per-token entity head and pooled intent head;
- each model's own loss (NER's CRF negative log-likelihood on the
  potentials in ``y_pred``, the joint losses) and its gradient with
  respect to every parameter (``jax.grad`` against autograd) within TOL;
- one ``Estimator.fit`` step with Adam from the same weights (dropout 0,
  so no random draw), the loss and every trained parameter within TOL;
- ``NER.predict``'s Viterbi paths equal the JAX model's;
- a char input of another width than ``word_length`` raises in both.

TOL: f32 LSTM recurrences of 6 steps in another summation order, read at
~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.models import textmodels as jtm
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import (ZooConf, ZooContext,
                                                    init_context)
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.models import textmodels as ttm
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5
B, T, W = 8, 6, 4
WORDS, CHARS = 50, 20
GEO = dict(word_vocab_size=WORDS, char_vocab_size=CHARS, word_length=W,
           word_emb_dim=8, char_emb_dim=5, tagger_lstm_dim=6)
N_TAGS, N_POS, N_CHUNK, N_INTENTS = 5, 7, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    init_context(device="cpu", seed=42)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


BUILDS = {
    "ner": lambda mod, **kw: mod.NER(N_TAGS, **GEO, **kw),
    "tagger": lambda mod, **kw: mod.SequenceTagger(N_POS, N_CHUNK, **GEO,
                                                   **kw),
    "intent": lambda mod, **kw: mod.IntentEntity(N_INTENTS, N_TAGS, **GEO,
                                                 **kw),
}


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


def _pair(kind, seed=0, dropout=0.5, lr=1e-3):
    """The JAX model with seeded params preloaded, and the port's with the
    same params."""
    jm = BUILDS[kind](jtm, dropout=dropout, optimizer=jopt.Adam(lr=lr))
    params = _np(jm.model.build(jax.random.PRNGKey(seed), None))
    # every leaf off its initial value, so zero biases and start / end
    # count too
    g = np.random.default_rng(seed + 100)
    params = jax.tree.map(
        lambda a: (a + 0.1 * g.normal(size=a.shape)).astype(np.float32),
        params)
    jm.model._params, jm.model._state = params, {}
    tm = BUILDS[kind](ttm, dropout=dropout, optimizer=topt.Adam(lr=lr),
                      device="cpu",
                      ctx=ZooContext(ZooConf(seed=42, device="cpu")))
    tm.estimator._obs_registry = MetricsRegistry()
    load_jax_params(tm.model, params)
    return jm, tm, params


def _inputs(seed, width=W):
    g = np.random.default_rng(seed)
    words = g.integers(1, WORDS, (B, T)).astype(np.float32)
    words[: B // 2, T - 2:] = 0               # padded tails
    chars = g.integers(1, CHARS, (B, T, width)).astype(np.float32)
    return [words, chars]


def _labels(kind, seed):
    g = np.random.default_rng(seed)
    if kind == "ner":
        return g.integers(0, N_TAGS, (B, T)).astype(np.float32)
    if kind == "tagger":
        return np.stack([g.integers(0, N_POS, (B, T)),
                         g.integers(0, N_CHUNK, (B, T))], -1).astype(
            np.float32)
    return np.concatenate([g.integers(0, N_INTENTS, (B, 1)),
                           g.integers(0, N_TAGS, (B, T))], 1).astype(
        np.float32)


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_tagger_tree_matches_jax(kind):
    _, tm, params = _pair(kind)
    want = {k: v.shape for k, v in _leaves(params).items()}
    assert {k: v.shape for k, v in _leaves(export_params(tm.model)).items()
            } == want
    assert tm.model.param_count() == sum(int(np.prod(s))
                                         for s in want.values())


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_tagger_outputs_match_jax(kind):
    jm, tm, params = _pair(kind, seed=1)
    x = _inputs(2)
    want = jm.model.call(params, [jnp.asarray(a) for a in x])
    with torch.no_grad():
        got = tm.model([torch.from_numpy(a) for a in x])
    assert len(got) == len(want) == (4 if kind == "ner" else 2)
    for i, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL, err_msg=f"output {i}")


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_tagger_loss_and_gradients_match_jax(kind):
    jm, tm, params = _pair(kind, seed=3)
    x, y = _inputs(4), _labels(kind, 5)
    jloss, tloss = jm.estimator.loss, tm.estimator.loss

    def jax_loss(p):
        out = jm.model.call(p, [jnp.asarray(a) for a in x])
        return jnp.mean(jloss(out, jnp.asarray(y)))

    want, grads = jax.value_and_grad(jax_loss)(jax.tree.map(jnp.asarray,
                                                            params))
    got = tloss(tm.model([torch.from_numpy(a) for a in x]),
                torch.from_numpy(y)).mean()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=TOL)
    got.backward()
    tg = _leaves(_grad_tree(tm.model))
    jg = _leaves(_np(grads))
    assert sorted(tg) == sorted(jg)
    for path in jg:
        np.testing.assert_allclose(tg[path], jg[path], atol=TOL,
                                   err_msg=path)


def _grad_tree(model):
    """The parameters' gradients in the param tree's layout."""
    def walk(v):
        if isinstance(v, dict):
            return {k: walk(a) for k, a in v.items()}
        return v.grad if v.grad is not None else torch.zeros_like(v)
    return walk(_tensor_tree(model))


def _tensor_tree(model):
    from analytics_zoo_tpu_torch.nn.module import Layer

    def walk(v):
        if isinstance(v, Layer):
            return walk(v._tree())
        if isinstance(v, dict):
            return {k: walk(a) for k, a in v.items()}
        return v
    return walk(model)


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_tagger_fit_step_matches_jax(kind):
    """One Adam step of batch 8 (dropout 0): the loss and every trained
    parameter within TOL of the JAX ``Estimator``'s."""
    jm, tm, _ = _pair(kind, seed=6, dropout=0.0)
    x, y = _inputs(7), _labels(kind, 8)
    jax_context().set_seed(42)
    losses = {"jax": [], "port": []}
    jm.estimator._listeners.append(
        lambda s, l: losses["jax"].append(float(l)))
    tm.estimator._listeners.append(
        lambda s, l: losses["port"].append(float(l)))
    jm.fit(x, y, batch_size=B, epochs=1, verbose=False)
    tm.fit(x, y, batch_size=B, epochs=1, verbose=False)
    assert len(losses["port"]) == len(losses["jax"]) == 1
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=TOL)
    want = _leaves(_np(jm.estimator.params))
    got = _leaves(export_params(tm.model))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=TOL,
                                   err_msg=path)


def test_ner_predict_paths_equal_jax():
    jm, tm, _ = _pair("ner", seed=9)
    x = _inputs(10)
    want = jm.predict(x, batch_size=B)
    got = tm.predict(x, batch_size=B)
    assert got.shape == (B, T) and got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_tagger_word_length_is_checked(kind):
    jm, tm, params = _pair(kind)
    x = _inputs(11, width=W + 1)
    with pytest.raises(ValueError, match="word_length"):
        jm.model.call(params, [jnp.asarray(a) for a in x])
    with pytest.raises(ValueError, match="word_length"):
        tm.model([torch.from_numpy(a) for a in x])
