"""PyTorch port: multi-process parallelism against the JAX package, on the
CPU, in real ``torch.distributed`` gloo worlds.

Two spawns of ``tests/torch_parallel_worker.py`` (4 ranks, then 2), each
meeting through a ``FileStore`` in ``tmp_path``.  The JAX oracle runs in
this process on ``jax.devices()[:4]`` of the conftest's 8-device CPU mesh
(or on one device where the JAX test's oracle is the single-device
result), from inputs seeded with numpy; its weights reach the port
through ``load_jax_params``.  The cases are those of the JAX package's
``tests/test_parallel.py``, ``test_moe.py``, ``test_multihost.py`` and
``test_automl_multiprocess.py``, each with its tolerance:

- ring attention, the einsum and the flash hop bodies (the port's flash
  body on the CPU takes the flash kernel's plain version), causal and
  full: outputs and the gradients of sum(out * ct), atol 1e-5 against the
  JAX ring of the same body and 2e-4 against full attention (the JAX
  test's bound);
- the column-parallel matmul (1e-5) and a megatron GPT-2-tiny forward
  and gradients, each rank's slices against the JAX gradients (1e-5);
- ``pipeline_apply`` and ``pipeline_apply_stages`` forward (1e-5) and
  gradients (1e-4 / 1e-5, the JAX test's);
- MoE expert parallelism (rtol 1e-4, atol 1e-5);
- seq-parallel (data 2 x seq 2) and pipeline (data 2 x pipe 2) ``fit``
  against the JAX single-device fit (rtol 2e-4, atol 2e-5), and a
  megatron ``fit`` with global-norm clipping (1e-5);
- a 2-process ``fit`` over process-local partitions against the JAX
  one-process fit of the same global batches (rtol 1e-5, atol 1e-6),
  uneven partitions not deadlocking;
- ``MultiProcessSearchEngine`` over 2 ranks: trials split 2 / 2, metrics
  equal to the port's one-process search (no speed assertion: the JAX
  throughput test is flaky under load).

Each spawn takes well under a minute on the CPU.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.nn import objectives as jobj
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.layers import attention as jatt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers.moe import MixtureOfExperts as JaxMoE
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.ops.attention import _attention_xla
from analytics_zoo_tpu.parallel import pipeline as jpipe
from analytics_zoo_tpu.parallel.pipeline_model import \
    PipelinedTransformer as JaxPT
from analytics_zoo_tpu.parallel.ring_attention import ring_attention
from analytics_zoo_tpu_torch.common.context import shard_slice

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_parallel_worker as worker  # noqa: E402

pytestmark = pytest.mark.timeout(600)

SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy the tolerances assume."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _spawn(bundle, tmp, world, inputs):
    """Run ``world`` ranks of ``bundle`` over ``inputs``; their outputs by
    rank.  Every process is killed if one fails or the spawn times out."""
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         bundle, str(tmp), str(world), str(r)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"out-{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _once(tmp_path_factory, name, compute):
    """``compute()`` once for the whole run: under pytest-xdist every
    worker that runs a test of this module would build the module fixture
    again, so the first one computes under a file lock and the others
    read its pickled result."""
    import fcntl
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            result = compute()
            with open(path, "wb") as f:
                pickle.dump(result, f)
            return result
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _mesh(shape, axes):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes)


def _local(full, layout, index):
    """A full leaf's slice at ``index`` under a worker's layout."""
    dim, _, groups = layout
    idx = shard_slice(full.shape[dim], 4, index, groups).numpy()
    return np.take(full, idx, axis=dim)


def _jax_fit(model, x, y, loss, optimizer, batch, epochs, **kw):
    jax_context().set_seed(42)
    est = JaxEstimator(model, optimizer=optimizer, loss=loss, **kw)
    losses = []
    est._listeners.append(lambda s, l: losses.append(float(l)))
    hist = est.fit(x, y, batch_size=batch, epochs=epochs, shuffle=False,
                   verbose=False)
    return losses, hist.history["loss"], est


# -- the JAX oracle and the 4-rank spawn -------------------------------------------

GPT_GEO = (64, 32, 2, 4, 16)        # vocab, hidden, blocks, heads, T


def _gpt_jax():
    V, H, NB, NH, T = GPT_GEO
    m = JaxSeq([jatt.TransformerLayer(vocab=V, hidden_size=H, n_block=NB,
                                      n_head=NH, seq_len=T, input_shape=(T,),
                                      name="tl"),
                jcore.Dense(V, activation="softmax", name="head")])
    params = _np(m.init_weights(jax.random.PRNGKey(0)))
    return m, params


def _ring_oracle(inp):
    """The JAX ring (both bodies, 4 devices) and full attention, with the
    gradients of sum(out * ct)."""
    q, k, v, ct = (jnp.asarray(inp[n]) for n in "qkvc")
    mesh = _mesh((4,), ("seq",))
    spec = NamedSharding(mesh, JP(None, None, "seq", None))
    qs, ks, vs = (jax.device_put(t, spec) for t in (q, k, v))
    out = {}
    for causal in (False, True):
        # the einsum ring's gradient compiles for ~20 s a case on the CPU:
        # its output is held here, its gradients against full attention's
        out[f"ring/xla/{int(causal)}"] = dict(o=np.asarray(ring_attention(
            qs, ks, vs, mesh, causal=causal, impl="xla")))
        o, vjp = jax.vjp(lambda a, b, c, causal=causal: ring_attention(
            a, b, c, mesh, causal=causal, impl="flash"), qs, ks, vs)
        g = vjp(ct)
        out[f"ring/flash/{int(causal)}"] = dict(
            o=np.asarray(o), dq=np.asarray(g[0]), dk=np.asarray(g[1]),
            dv=np.asarray(g[2]))
    for causal in (False, True):
        def loss(a, b, c, causal=causal):
            return jnp.sum(_attention_xla(a, b, c, causal=causal) * ct)
        g = jax.grad(loss, (0, 1, 2))(q, k, v)
        out[f"full/{int(causal)}"] = dict(
            o=np.asarray(_attention_xla(q, k, v, causal=causal)),
            dq=np.asarray(g[0]), dk=np.asarray(g[1]), dv=np.asarray(g[2]))
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The JAX oracle, then the 4-rank spawn over the same inputs (once
    a run)."""
    return _once(tmp_path_factory, "torch_parallel_four",
                 lambda: _four(tmp_path_factory))


def _four(tmp_path_factory):
    g = np.random.default_rng(11)
    ring = {n: np.asarray(g.normal(size=(1, 2, 128, 16)), np.float32)
            for n in "qkvc"}
    oracle = {"ring": _ring_oracle(ring)}
    inputs = {"ring": ring}

    g = np.random.default_rng(0)
    x = np.asarray(g.normal(size=(16, 32)), np.float32)
    W = np.asarray(g.normal(size=(32, 64)), np.float32)
    inputs["tp"] = {"x": x, "W": W}
    oracle["tp/matmul"] = x @ W

    jm, params = _gpt_jax()
    V, H, NB, NH, T = GPT_GEO
    g = np.random.default_rng(1)
    ids = g.integers(0, V, (4, T)).astype(np.int32)
    labels = g.integers(0, V, (4, T)).astype(np.int32)
    inputs["gpt"] = {"geo": GPT_GEO, "params": params, "x": ids,
                     "y": labels}
    ce = jobj.get("sparse_categorical_crossentropy")

    def gpt_loss(p):
        pred, _ = jm.apply(p, jm._state, jnp.asarray(ids))
        return jnp.mean(ce(pred, jnp.asarray(labels))), pred
    (lval, pred), grads = jax.value_and_grad(gpt_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    oracle["tp/gpt"] = dict(pred=np.asarray(pred), loss=float(lval),
                            grads=dict(worker.tsh.leaf_paths(_np(grads))))

    # pipelines: the JAX test's seeds and shapes
    mesh4 = _mesh((4,), ("pipe",))
    g = np.random.default_rng(3)
    plist = [{"W": np.asarray(g.normal(size=(8, 8)) * 0.3, np.float32),
              "b": np.asarray(g.normal(size=(8,)) * 0.1, np.float32)}
             for _ in range(4)]
    px = np.asarray(g.normal(size=(16, 8)), np.float32)
    stacked = _np(jpipe.stack_stage_params(
        [jax.tree.map(jnp.asarray, p) for p in plist]))
    oracle["pipe/fwd"] = np.asarray(jpipe.from_microbatches(
        jpipe.pipeline_apply(lambda p, t: jnp.tanh(t @ p["W"] + p["b"]),
                             stacked, jpipe.to_microbatches(px, 8), mesh4)))
    g = np.random.default_rng(4)
    gW = np.stack([np.asarray(g.normal(size=(4, 4)) * 0.3, np.float32)
                   for _ in range(4)])
    gx = np.asarray(g.normal(size=(8, 4)), np.float32)

    def pipe_loss(sp):
        y = jpipe.pipeline_apply(lambda p, t: jnp.tanh(t @ p["W"]), sp,
                                 jpipe.to_microbatches(gx, 4), mesh4)
        return jnp.sum(y ** 2)
    oracle["pipe/grad"] = np.asarray(jax.grad(pipe_loss)({"W": gW})["W"])
    inputs["pipe"] = {"fwd_params": stacked, "x": px, "grad_W": gW,
                      "gx": gx}

    g = np.random.default_rng(9)
    p0 = {"W": np.asarray(g.normal(size=(8, 8)) * 0.3, np.float32),
          "b": np.asarray(g.normal(size=(8,)) * 0.1, np.float32)}
    p1 = {"gate": {"A": np.asarray(g.normal(size=(8, 8)) * 0.3,
                                   np.float32)},
          "scale": np.asarray(1.5, np.float32)}
    hx = np.asarray(g.normal(size=(8, 8)), np.float32)

    def f0(p, t):
        return jnp.tanh(t @ p["W"] + p["b"])

    def f1(p, t):
        return t * jax.nn.sigmoid(t @ p["gate"]["A"]) * p["scale"]
    mesh2 = _mesh((2,), ("pipe",))
    hm = jpipe.to_microbatches(hx, 4)

    def stages_loss(ps):
        return jnp.sum(jpipe.pipeline_apply_stages([f0, f1], list(ps), hm,
                                                   mesh2) ** 2)
    gs = jax.grad(stages_loss)((p0, p1))
    oracle["stages"] = dict(
        y=np.asarray(jpipe.from_microbatches(jpipe.pipeline_apply_stages(
            [f0, f1], [p0, p1], hm, mesh2))),
        W=np.asarray(gs[0]["W"]), b=np.asarray(gs[0]["b"]),
        A=np.asarray(gs[1]["gate"]["A"]), scale=np.asarray(gs[1]["scale"]))
    inputs["stages"] = {"p0": p0, "p1": p1, "x": hx}

    # MoE: the replicated forward is the JAX expert-parallel test's oracle
    moe = JaxMoE(4, 16, top_k=2, name="moe")
    mparams = _np(moe.build(jax.random.PRNGKey(0), (6, 8)))
    mx = np.asarray(np.random.default_rng(1).normal(size=(8, 6, 8)),
                    np.float32)
    oracle["moe"] = np.asarray(moe.call(mparams, jnp.asarray(mx)))
    inputs["moe"] = {"params": mparams, "x": mx}

    # fits, each from the weights the JAX run starts from
    g = np.random.default_rng(7)
    sx = g.integers(0, 50, (16, 16)).astype(np.float32)
    sy = g.normal(size=(16, 16, 32)).astype(np.float32)
    tl = jatt.TransformerLayer(vocab=50, hidden_size=32, n_block=2, n_head=2,
                               seq_len=16, embedding_drop=0.0, attn_drop=0.0,
                               resid_drop=0.0, name="tl")
    tl._params, tl._state = _np(tl.build(jax.random.PRNGKey(0), (16,))), {}
    sparams = tl._params
    oracle["seq_fit"], _, _ = _jax_fit(tl, sx, sy, "mse", "sgd", 8, 2)
    inputs["seq_fit"] = {"geo": (50, 32, 16), "params": sparams, "x": sx,
                         "y": sy}

    g = np.random.default_rng(8)
    px = g.integers(0, 50, (16, 8)).astype(np.float32)
    py = g.integers(0, 50, (16, 8)).astype(np.float32)
    pt = JaxPT(vocab=50, hidden_size=32, n_stages=2, n_head=2, seq_len=8,
               n_micro=4, pipelined=False, name="pt")
    pt._params, pt._state = _np(pt.build(jax.random.PRNGKey(0), (8,))), {}
    pparams = pt._params
    losses, _, est = _jax_fit(
        pt, px, py, "sparse_categorical_crossentropy_from_logits", "sgd",
        8, 2)
    oracle["pipe_fit"] = dict(losses=losses, trained=dict(
        worker.tsh.leaf_paths(_np(est.params))))
    inputs["pipe_fit"] = {"geo": (50, 32, 8), "params": pparams, "x": px,
                          "y": py}

    jm, params = _gpt_jax()
    g = np.random.default_rng(2)
    s = g.integers(0, GPT_GEO[0], (32, GPT_GEO[4] + 1))
    fx, fy = s[:, :-1].astype(np.int32), s[:, 1:].astype(np.int32)
    losses, _, est = _jax_fit(jm, fx, fy, "sparse_categorical_crossentropy",
                              jopt.Adam(lr=1e-3), 8, 1, clip_norm=0.5)
    oracle["mega_fit"] = dict(losses=losses, trained=dict(
        worker.tsh.leaf_paths(_np(est.params))))
    inputs["mega_fit"] = {"geo": GPT_GEO, "params": params, "x": fx,
                          "y": fy}
    outs = _spawn("four", tmp_path_factory.mktemp("four"), 4, inputs)
    return oracle, outs


# ring attention

RING_ATOL = 1e-5     # the same f32 math per hop, merged in another order
FULL_TOL = 2e-4      # the JAX test's bound against full attention


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_ring_and_full(four, impl, causal):
    oracle, outs = four
    key = f"ring/{impl}/{int(causal)}"
    for part in ("o", "dq", "dk", "dv"):
        got = np.concatenate([o[key][part] for o in outs], axis=2)
        if part in oracle["ring"][key]:
            np.testing.assert_allclose(got, oracle["ring"][key][part],
                                       atol=RING_ATOL, rtol=1e-5,
                                       err_msg=f"{key} {part}")
        np.testing.assert_allclose(
            got, oracle["ring"][f"full/{int(causal)}"][part],
            atol=FULL_TOL, rtol=FULL_TOL, err_msg=f"{key} {part} vs full")


# tensor parallelism

def test_tensor_parallel_matmul_correct(four):
    oracle, outs = four
    for o in outs:
        np.testing.assert_allclose(o["tp/matmul"], oracle["tp/matmul"],
                                   rtol=1e-5, atol=1e-5)


def test_megatron_gpt_forward_and_gradients_match_jax(four):
    """Heads, FFN columns and the vocabulary (64 rows) split over 4 ranks;
    each rank's gradient slices against the JAX gradients, the
    replicated leaves whole on every rank."""
    oracle, outs = four
    want = oracle["tp/gpt"]
    for rank, o in enumerate(outs):
        got = o["tp/gpt"]
        np.testing.assert_allclose(got["pred"], want["pred"], atol=1e-5,
                                   rtol=1e-5)
        assert abs(got["loss"] - want["loss"]) < 1e-5
        assert set(got["grads"]) == set(want["grads"])
        for path, g in got["grads"].items():
            ref = want["grads"][path]
            if path in got["layout"]:
                ref = _local(ref, got["layout"][path], rank)
            np.testing.assert_allclose(g, ref, atol=1e-5, rtol=1e-5,
                                       err_msg=f"rank {rank} {path}")
    lay = outs[0]["tp/gpt"]["layout"]
    assert lay["tl/tl_block0/attn/qkv/W"] == (1, "model", 3)
    assert lay["tl/wte"] == (0, "model", 1)
    assert "tl/tl_block0/ffn/proj/W" not in lay   # replicated, as in JAX


# pipelines

def test_pipeline_parallel_matches_jax(four):
    oracle, outs = four
    for o in outs:
        np.testing.assert_allclose(o["pipe/fwd"], oracle["pipe/fwd"],
                                   rtol=1e-5, atol=1e-5)
        s = o["pipe/grad"]["stage"]
        np.testing.assert_allclose(o["pipe/grad"]["gW"],
                                   oracle["pipe/grad"][s], rtol=1e-4,
                                   atol=1e-4)
    assert sorted(o["pipe/grad"]["stage"] for o in outs) == [0, 1, 2, 3]


def test_heterogeneous_pipeline_stages_match_jax(four):
    """Forward on every rank, and every stage's gradients on every rank
    (the owner's, summed over pipe), as the JAX transpose gives them."""
    oracle, outs = four
    want = oracle["stages"]
    for o in outs:
        np.testing.assert_allclose(o["stages"]["y"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        for k in ("W", "b", "A", "scale"):
            np.testing.assert_allclose(o["stages"][k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


# expert parallelism

def test_moe_expert_parallel_matches_jax(four):
    oracle, outs = four
    for o in outs:
        lo, hi = o["moe"]["rows"]
        assert o["moe"]["held"] == 2          # 4 experts over expert 2
        np.testing.assert_allclose(o["moe"]["y"], oracle["moe"][lo:hi],
                                   rtol=1e-4, atol=1e-5)


# fits

def test_seq_parallel_fit_matches_single_device(four):
    """Tokens over seq 2 (ring attention engaged), rows over data 2: the
    loss of every step against the JAX single-device fit."""
    oracle, outs = four
    for o in outs:
        assert o["seq_fit"]["ring_calls"] > 0
        np.testing.assert_allclose(o["seq_fit"]["losses"], oracle["seq_fit"],
                                   rtol=2e-4, atol=2e-5)


def test_pipeline_fit_matches_sequential(four):
    """2 GPipe stages over pipe (x data 2) against the JAX sequential
    (``pipelined=False``) fit: every step's loss, and each rank's stage
    of the trained stacked weights."""
    oracle, outs = four
    want = oracle["pipe_fit"]
    for o in outs:
        got = o["pipe_fit"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-5)
        for path, w in got["trained"].items():
            ref = want["trained"][path]
            if path.startswith("stages/"):
                ref = ref[got["stage"]:got["stage"] + 1]
            np.testing.assert_allclose(w, ref, rtol=2e-4, atol=2e-5,
                                       err_msg=path)


def test_megatron_fit_with_clipping_matches_jax(four):
    """Adam with global-norm clipping 0.5 over a model split 4 ways: the
    norm sums the sharded leaves' squares over model."""
    oracle, outs = four
    want = oracle["mega_fit"]
    for rank, o in enumerate(outs):
        got = o["mega_fit"]
        assert got["route"] == "eager"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   atol=1e-5)
        for path, w in got["trained"].items():
            ref = want["trained"][path]
            if path in got["layout"]:
                ref = _local(ref, got["layout"][path], rank)
            np.testing.assert_allclose(w, ref, atol=1e-5, rtol=1e-5,
                                       err_msg=f"rank {rank} {path}")


# -- the 2-rank spawn --------------------------------------------------------------

def _mh_data(n):
    g = np.random.default_rng(5)
    x = g.normal(size=(n, 6)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    return x, y


def _mh_jax(n, params):
    """The JAX one-process fit over the 2-process global batch order:
    global batch k = [partition 0 rows 16k.., partition 1 rows 16k..]."""
    x, y = _mh_data(n)
    half, fb = n // 2, 16
    order = np.concatenate([
        np.concatenate([np.arange(k * fb, (k + 1) * fb),
                        half + np.arange(k * fb, (k + 1) * fb)])
        for k in range(half // fb)])
    m = JaxSeq([jcore.Dense(16, activation="tanh", input_shape=(6,),
                            name="d1"),
                jcore.Dense(1, activation="sigmoid", name="d2")])
    assert jax.tree.all(jax.tree.map(
        np.array_equal, _np(m.init_weights(jax.random.PRNGKey(0))), params))
    jax_context().set_seed(42)
    est = JaxEstimator(m, optimizer="sgd", loss="binary_crossentropy",
                       metrics=["accuracy"])
    hist = est.fit(x[order], y[order], batch_size=32, epochs=3,
                   shuffle=False, verbose=False)
    return {"losses": hist.history["loss"],
            "accuracy": est.evaluate(x[order], y[order],
                                     batch_size=32)["accuracy"],
            "pred_sum": float(np.sum(est.predict(x[order], batch_size=32)))}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _once(tmp_path_factory, "torch_parallel_two",
                 lambda: _two(tmp_path_factory))


def _two(tmp_path_factory):
    m = JaxSeq([jcore.Dense(16, activation="tanh", input_shape=(6,),
                            name="d1"),
                jcore.Dense(1, activation="sigmoid", name="d2")])
    params = _np(m.init_weights(jax.random.PRNGKey(0)))
    inputs = {}
    for key, n in (("even", 256), ("uneven", 257)):
        x, y = _mh_data(n)
        inputs[key] = {"x": x, "y": y, "params": params}
    ref = _mh_jax(256, params)
    worker.init_context(device="cpu", seed=42)
    one = worker.search_fit(False)
    outs = _spawn("two", tmp_path_factory.mktemp("two"), 2, inputs)
    return ref, one, outs


def test_two_process_fit_matches_single_process(two):
    ref, _, outs = two
    for o in outs:
        np.testing.assert_allclose(o["even"]["losses"], ref["losses"],
                                   rtol=1e-5, atol=1e-6)
        assert abs(o["even"]["accuracy"] - ref["accuracy"]) < 1e-5
    assert sum(len(o["even"]["pred"]) for o in outs) == 256
    np.testing.assert_allclose(sum(float(o["even"]["pred"].sum())
                                   for o in outs), ref["pred_sum"],
                               rtol=1e-4)


def test_uneven_partitions_do_not_deadlock(two):
    """257 rows: partitions of 128 and 129 give 8 and 9 local batches; the
    short one pads a weight-0 batch, and both report one global loss."""
    _, _, outs = two
    assert outs[0]["uneven"]["losses"] == outs[1]["uneven"]["losses"]
    assert sum(len(o["uneven"]["pred"]) for o in outs) == 257
    for o in outs:      # the host arrays of both processes, in rank order
        np.testing.assert_array_equal(o["allgather"], [[0, 10], [1, 11]])


def test_multiprocess_search_splits_trials_and_agrees(two):
    _, one, outs = two
    a, b = (o["search"] for o in outs)
    assert a["trials"] == b["trials"] == one["trials"]
    assert a["best"] == b["best"] == one["best"]
    assert a["local_trial_count"] == b["local_trial_count"] == 2
    assert one["local_trial_count"] == worker.SEARCH_TRIALS
