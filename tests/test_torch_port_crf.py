"""PyTorch port: the linear-chain CRF (``nn/layers/crf.py``) against the
JAX package's on the CPU.

The same seeded numpy potentials and emissions go through the JAX
``CRF`` (its ``lax.scan`` recursions) and the port's (loops over T), the
potentials loaded by ``load_jax_params``, with and without a mask that
pads rows to different lengths (a row of one valid step included):

- ``log_partition``, ``score`` and ``neg_log_likelihood`` within TOL =
  1e-5 (f32 ``logsumexp`` in another order, read at ~1e-7);
- their gradients with respect to the emissions, the transitions, start
  and end (``jax.grad`` against autograd) within TOL;
- ``decode`` equal, also on emissions full of ties (both packages take the
  first maximum);
- ``log_partition`` against brute force over every path at K = 3, T = 4.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.nn.layers.crf import CRF as JaxCRF
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.nn.layers import CRF
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5
B, T, K = 4, 7, 5
KEYS = ("transitions", "start", "end")


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _case(seed, k=K, b=B, t=T, masked=False):
    g = np.random.default_rng(seed)
    params = {"transitions": g.normal(size=(k, k)).astype(np.float32),
              "start": g.normal(size=k).astype(np.float32),
              "end": g.normal(size=k).astype(np.float32)}
    e = g.normal(size=(b, t, k)).astype(np.float32)
    tags = g.integers(0, k, (b, t))
    mask = None
    if masked:
        lens = np.concatenate([[t, 1], g.integers(1, t + 1, b - 2)])
        mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    crf = CRF(k)
    load_jax_params(crf, params)
    return crf, params, e, tags, mask


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def test_crf_tree_matches_jax():
    jp = JaxCRF(K).build(jax.random.PRNGKey(0), (None, K))
    crf = CRF(K)
    assert {k: tuple(v.shape) for k, v in export_params(crf).items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert crf(torch.ones(2, 3, K)).shape == (2, 3, K)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["log_partition", "score",
                                "neg_log_likelihood"])
def test_crf_scores_and_gradients_match_jax(fn, masked):
    crf, params, e, tags, mask = _case(3 + masked, masked=masked)
    jcrf = JaxCRF(K)
    cot = np.random.default_rng(9).normal(size=B).astype(np.float32)
    with_tags = fn != "log_partition"

    def jax_fn(p, em):
        args = (p, em) + ((jnp.asarray(tags),) if with_tags else ())
        return getattr(jcrf, fn)(*args, _j(mask))

    want = np.asarray(jax_fn(_j_tree(params), jnp.asarray(e)))
    g_p, g_e = jax.grad(lambda p, em: jnp.sum(jax_fn(p, em) * cot),
                        argnums=(0, 1))(_j_tree(params), jnp.asarray(e))
    et = torch.from_numpy(e).requires_grad_(True)
    args = (et,) + ((torch.from_numpy(tags),) if with_tags else ())
    got = getattr(crf, fn)(*args, _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(g_e), atol=TOL)
    for key in KEYS:
        np.testing.assert_allclose(getattr(crf, key).grad.numpy(),
                                   np.asarray(g_p[key]), atol=TOL,
                                   err_msg=key)


def _j_tree(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_crf_potentials_from_params_match_own(masked):
    """The ``params=`` route (the potentials ``NER``'s loss takes from
    ``y_pred``) scores as the layer's own potentials do."""
    crf, params, e, tags, mask = _case(5, masked=masked)
    own = crf.neg_log_likelihood(_t(e), _t(tags), _t(mask))
    given = CRF(K).neg_log_likelihood(
        _t(e), _t(tags), _t(mask),
        params={k: torch.from_numpy(v) for k, v in params.items()})
    torch.testing.assert_close(given, own, rtol=0, atol=0)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_crf_decode_equals_jax(masked, ties):
    crf, params, e, _, mask = _case(11 + masked, b=6, masked=masked)
    if ties:
        # few distinct values: many equal path scores
        e = np.round(e).astype(np.float32)
        params = {k: np.round(v).astype(np.float32)
                  for k, v in params.items()}
        load_jax_params(crf, params)
    want = np.asarray(JaxCRF(K).decode(_j_tree(params), jnp.asarray(e),
                                       _j(mask)))
    got = crf.decode(_t(e), _t(mask)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if mask is not None:
        # padded steps repeat the last valid tag
        for row, m in zip(got, mask):
            n = int(m.sum())
            assert (row[n:] == row[n - 1]).all()


def test_crf_decode_is_the_best_path():
    k, t = 3, 4
    crf, params, e, _, _ = _case(21, k=k, b=2, t=t)
    got = crf.decode(_t(e)).numpy()
    with torch.no_grad():
        for b in range(2):
            best = max(itertools.product(range(k), repeat=t),
                       key=lambda p: float(crf.score(_t(e[b:b + 1]),
                                                     torch.tensor([p]))[0]))
            assert tuple(got[b]) == best


def _brute_force_logz(e, trans, start, end):
    t, k = e.shape
    scores = [start[p[0]] + end[p[-1]] + sum(e[i, p[i]] for i in range(t))
              + sum(trans[p[i], p[i + 1]] for i in range(t - 1))
              for p in itertools.product(range(k), repeat=t)]
    m = max(scores)
    return m + np.log(np.sum(np.exp(np.asarray(scores, np.float64) - m)))


def test_crf_log_partition_matches_brute_force():
    crf, params, e, _, _ = _case(31, k=3, b=2, t=4)
    logz = crf.log_partition(_t(e)).detach().numpy()
    for b in range(2):
        ref = _brute_force_logz(e[b].astype(np.float64),
                                *(params[k].astype(np.float64)
                                  for k in KEYS))
        np.testing.assert_allclose(logz[b], ref, rtol=1e-5)
