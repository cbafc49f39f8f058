"""PyTorch port: the training path against the JAX package, on the CPU.

- the flash backward: the port's plain backward (what a CPU tensor gets,
  and the oracle the dq and dk/dv CUDA kernels are held to on the card)
  against ``jax.grad`` through the JAX ``flash_attention`` in Pallas
  interpret mode, as ``tests/test_flash_attention.py`` runs it, including
  a loss on ``flash_attention_with_lse``'s LSE; and against torch
  autograd through ``flash_attention_torch``;
- no fallback: a selected backward kernel that fails raises out of
  ``loss.backward()``;
- ``Estimator.fit`` on a small ``TransformerLayer`` causal LM against the
  JAX ``Estimator.fit`` from the same weights (``load_jax_params``), data
  and shuffle seed: the loss at every step, the trained parameters
  (``export_params``), ``evaluate`` and ``predict``; with Adam, Adam plus
  ``clip_norm`` and AdamWeightDecay with warm-up; the ``KerasNet`` façade;
- training-mode dropout, held by statistics (it cannot match
  ``jax.random`` bit for bit).

Each tolerance is stated where it is used, with its reason.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.layers import attention as jatt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu_torch.common.context import (ZooConf, ZooContext,
                                                    init_context)
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator import estimator as testim
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.nn import module as tmod
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import attention as tatt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import attention as tops
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy the tolerances here assume
    (its policy is process-global; a benchmark run in-process in the same
    worker may leave it at bf16)."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the flash backward --------------------------------------------------------

# the plain backward and the Pallas kernels compute the same f32 gradients;
# the kernels sum over 64-wide blocks, the plain version over whole rows:
# f32 rounding, read at ~2e-6 on gradients of magnitude ~1-5
BWD_ATOL, BWD_RTOL = 2e-5, 1e-5


def _bwd_inputs(seed, T, D=32):
    g = np.random.default_rng(seed)
    q, k, v, w = (np.asarray(g.normal(size=(2, 2, T, D)), np.float32)
                  for _ in range(4))
    wl = np.asarray(g.normal(size=(2, 2, T)), np.float32)
    return q, k, v, w, wl


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 200])
def test_flash_backward_matches_jax_pallas_interpret(T, causal, with_lse):
    """``jax.grad`` through the JAX custom_vjp (``_flash_bwd``'s dq and dk/dv
    Pallas kernels, interpret mode, 64-row blocks: T = 200 pads and masks
    its last block) against autograd through the port's Function on CPU
    tensors.  ``with_lse`` puts a loss on the LSE too, so its cotangent
    enters as the delta shift."""
    q, k, v, w, wl = _bwd_inputs(T + causal, T)

    def jloss(q, k, v):
        if with_lse:
            o, lse = jfa.flash_attention_with_lse(q, k, v, causal, None, 64,
                                                  64, True)
            return (o * w).sum() + (lse * wl).sum()
        return (jfa.flash_attention(q, k, v, causal, None, 64, 64, True)
                * w).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    if with_lse:
        o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
        loss = (o * _t(w)).sum() + (lse * _t(wl)).sum()
    else:
        loss = (tfa.flash_attention(tq, tk, tv, causal=causal) * _t(w)).sum()
    loss.backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=BWD_ATOL, rtol=BWD_RTOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 200])
def test_flash_backward_matches_torch_autograd(T, causal):
    """The plain backward against autograd through the plain forward
    (softmax over whole rows): the same gradients by another route."""
    q, k, v, w, wl = _bwd_inputs(7 * T + causal, T, D=16)
    grads = []
    for fn in (lambda *a: tfa.flash_attention_with_lse(*a, causal=causal),
               lambda *a: tfa.flash_attention_torch(*a, causal,
                                                    with_lse=True)):
        ts = [_t(a).requires_grad_() for a in (q, k, v)]
        o, lse = fn(*ts)
        ((o * _t(w)).sum() + (lse * _t(wl)).sum()).backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=BWD_ATOL, rtol=BWD_RTOL)


def test_flash_backward_torch_is_the_autograd_backward():
    """``flash_attention_bwd_torch`` called directly is what the Function's
    backward computes for CPU tensors."""
    q, k, v, w, wl = _bwd_inputs(3, 40)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.flash_attention_with_lse(*ts, causal=True)
    ((o * _t(w)).sum() + (lse * _t(wl)).sum()).backward()
    direct = tfa.flash_attention_bwd_torch(
        _t(q), _t(k), _t(v), o.detach(), lse.detach(), _t(w), _t(wl),
        causal=True)
    for a, b in zip(direct, ts):
        torch.testing.assert_close(a, b.grad, atol=0, rtol=0)


def test_inference_skips_the_lse_and_saves_nothing(monkeypatch):
    """No input needs a gradient: the forward is called without the LSE
    (the inference path skips that write) and nothing is saved."""
    seen = []
    plain = tfa.flash_attention_torch

    def spy(q, k, v, causal, scale, with_lse, out_dtype):
        seen.append(with_lse)
        return plain(q, k, v, causal, scale, with_lse, out_dtype)
    monkeypatch.setattr(tfa, "flash_attention_torch", spy)
    q, k, v = (torch.randn(1, 2, 8, 32) for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True)
    assert seen == [False] and out.grad_fn is None
    tfa.flash_attention(q.requires_grad_(), k, v, causal=True)
    with torch.no_grad():
        tfa.flash_attention(q, k, v, causal=True)
    assert seen == [False, True, False]


class _KernelDown(RuntimeError):
    pass


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_failing_backward_kernel_propagates_out_of_backward(monkeypatch,
                                                            which):
    """The CUDA route stubbed on CPU tensors: the resolver answers "cuda",
    the forward launcher runs the plain forward, one backward launcher
    works (the plain math) and the other raises.  The failure reaches the
    caller of ``backward()``; nothing slides onto the plain backward."""
    def plain_fwd(q, k, v, causal, scale, with_lse, out_dtype):
        return tfa.flash_attention_torch(q, k, v, causal, scale, with_lse,
                                         out_dtype)

    def down(*args, **kwargs):
        raise _KernelDown(f"{which} launch failed")

    def plain_dq(q, k, v, dO, lse, delta, causal, scale):
        return tfa._bwd_plain(q, k, v, dO, lse, delta, causal, scale)[0]

    def plain_dkv(q, k, v, dO, lse, delta, causal, scale):
        return tfa._bwd_plain(q, k, v, dO, lse, delta, causal, scale)[1:]
    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, x: "cuda")
    monkeypatch.setattr(tfa, "_flash_cuda", plain_fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq", down if which == "dq"
                        else plain_dq)
    monkeypatch.setattr(tfa, "flash_bwd_dkv", down if which == "dkv"
                        else plain_dkv)
    x = torch.randn(2, 16, 3 * 2 * 32, requires_grad=True)
    q, k, v = (t.unflatten(-1, (2, 32)) for t in x.split(64, dim=-1))
    out = tops.attention_bthd(q, k, v, causal=True)
    with pytest.raises(_KernelDown, match=which):
        out.sum().backward()


def _bwd_args(bad):
    """(q, k, v, dO, lse, delta) as the kernels take them, with one
    defect."""
    d = 48 if bad == "head_dim" else 32
    q, k, v, dO = (torch.randn(2, 9, 2, d).transpose(1, 2)
                   for _ in range(4))
    lse, delta = torch.randn(2, 2, 9), torch.randn(2, 2, 9)
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "dO_dtype":
        dO = dO.to(torch.bfloat16)
    elif bad == "d_stride":
        dO = dO.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "misaligned":
        buf = torch.zeros(q.numel() + 1)[1:]
        q = buf.view(2, 9, 2, d).transpose(1, 2)
    elif bad == "shape":
        k = k[:, :, :5]
    elif bad == "lse":
        lse = torch.randn(2, 9, 2).transpose(1, 2)
    elif bad == "delta_dtype":
        delta = delta.double()
    return q, k, v, dO, lse, delta


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "dO_dtype", "d_stride",
                                 "misaligned", "shape", "lse",
                                 "delta_dtype"])
@pytest.mark.parametrize("launcher", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_launchers_reject_what_the_kernels_cannot_take(launcher,
                                                                bad):
    """Checked before anything is built or launched (CPU tensors, which
    the Function itself would give the plain backward)."""
    with pytest.raises((ValueError, TypeError)):
        getattr(tfa, launcher)(*_bwd_args(bad), True, 0.125)
    assert tfa._bwd_fns is None


def test_backward_source_ships_and_build_is_deferred():
    assert (tfa._build.CSRC / f"{tfa.KERNEL_BWD}.cu").exists()
    assert tfa._bwd_fns is None
    assert tfa._build.library_path(tfa.KERNEL_BWD).name.startswith(
        f"lib{tfa.KERNEL_BWD}-")


def test_kernel_grad_layout():
    """dO as the kernels read it: an expanded scalar (zero strides) and a
    bf16 cotangent of f32 inputs become dense copies; a view in the
    kernel's layout passes through untouched."""
    ok = torch.randn(2, 9, 2, 32).transpose(1, 2)
    assert tfa._kernel_grad(ok, torch.float32) is ok
    expanded = torch.ones(()).expand(2, 2, 9, 32)
    dense = tfa._kernel_grad(expanded, torch.float32)
    assert dense.is_contiguous() and torch.equal(dense, expanded)
    assert tfa._kernel_grad(ok.to(torch.bfloat16),
                            torch.float32).dtype == torch.float32


# -- training parity -----------------------------------------------------------

V, H, NB, NH, T = 97, 64, 2, 2, 32      # head_dim 32, the kernels' smallest
N_SEQ, BATCH = 32, 8                     # 4 steps; batch a multiple of the
                                         # JAX test mesh's 8-way data axis


def _layers(m, core):
    return [m.TransformerLayer(vocab=V, hidden_size=H, n_block=NB,
                               n_head=NH, seq_len=T, input_shape=(T,),
                               name="tl"),
            core.Dense(V, activation="softmax", name="head")]


def _lm_data(seed=0):
    g = np.random.default_rng(seed)
    s = g.integers(0, V, (N_SEQ, T + 1))
    return s[:, :-1].astype(np.int32), s[:, 1:].astype(np.int32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = v.detach().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


TRAIN_CASES = {
    "adam": lambda o: dict(optimizer=o.Adam(lr=1e-3)),
    "adam_clip": lambda o: dict(optimizer=o.Adam(lr=1e-3), clip_norm=0.5),
    "adamw_warmup": lambda o: dict(optimizer=o.AdamWeightDecay(
        lr=1e-3, warmup_portion=0.5, total=4)),
}


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def trained(request):
    """The JAX and the port's Estimator, each fit for one epoch (4 steps)
    from the same weights, data and shuffle seed (42 on both sides)."""
    make = TRAIN_CASES[request.param]
    jm = JaxSeq(_layers(jatt, jcore))
    params = jax.tree.map(np.asarray, jm.init_weights(jax.random.PRNGKey(0)))
    tm = Sequential(_layers(tatt, tcore))
    load_jax_params(tm, params)
    x, y = _lm_data()
    jax_context().set_seed(42)
    je = JaxEstimator(jm, loss="sparse_categorical_crossentropy",
                      **make(jopt))
    te = Estimator(tm, loss="sparse_categorical_crossentropy",
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry(), **make(topt))
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    jh = je.fit(x, y, batch_size=BATCH, epochs=1, verbose=False)
    th = te.fit(x, y, batch_size=BATCH, epochs=1, verbose=False)
    return dict(je=je, te=te, jm=jm, tm=tm, x=x, y=y, losses=losses,
                jh=jh, th=th, case=request.param)


def test_fit_loss_per_step_matches_jax(trained):
    """The same 4 batches in the same order: each step's weighted loss.
    f32 forward/backward in another summation order (XLA vs PyTorch CPU
    kernels), read at <= 1e-6 on losses ~4.9."""
    lj, lp = trained["losses"]["jax"], trained["losses"]["port"]
    assert len(lj) == len(lp) == N_SEQ // BATCH
    np.testing.assert_allclose(lp, lj, atol=1e-5)
    assert trained["th"].history["loss"] == pytest.approx(
        trained["jh"].history["loss"], abs=1e-5)
    assert trained["te"].global_step == trained["je"].global_step == 4


def test_fit_trained_params_match_jax(trained):
    """Leaf by leaf after 4 steps.  Adam divides each gradient element by
    its running RMS, so an element whose gradient is at f32 noise level
    moves by up to lr per step in a direction the noise picks: read at
    1.3e-5 (lr 1e-3) on one element of a projection, the rest <= 3e-6.
    atol 5e-5 is a twentieth of lr."""
    want = _leaves(jax.tree.map(np.asarray, trained["je"].params))
    got = _leaves(export_params(trained["tm"]))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=5e-5,
                                   err_msg=path)


def test_evaluate_and_predict_after_fit_match_jax(trained):
    """Eval loss to 1e-5 (f32 noise on ~4.6); predicted probabilities to
    1e-6 (softmax outputs ~1e-2)."""
    x, y = trained["x"], trained["y"]
    ej = trained["je"].evaluate(x, y, batch_size=BATCH)
    ep = trained["te"].evaluate(x, y, batch_size=BATCH)
    assert ep["loss"] == pytest.approx(ej["loss"], abs=1e-5)
    pj = trained["je"].predict(x[:11], batch_size=BATCH)
    pp = trained["te"].predict(x[:11], batch_size=BATCH)
    assert pp.shape == pj.shape == (11, T, V)
    np.testing.assert_allclose(pp, pj, atol=1e-6)


def test_fit_summary_counts_steps_and_weighted_samples(trained):
    s = trained["te"].fit_summary()
    assert s["steps"] == 4 and s["samples"] == N_SEQ
    assert s["step_time"]["count"] == 4
    assert trained["tm"].training is False      # fit leaves eval mode


def test_keras_facade_matches_jax():
    """``compile``/``fit``/``evaluate``/``predict``/``get_weights`` on a
    Dense classifier with a padded final batch (37 rows, batch 8), against
    the JAX façade (f32 noise, as above)."""
    g = np.random.default_rng(5)
    x = g.normal(size=(37, 6)).astype(np.float32)
    y = g.integers(0, 3, (37,)).astype(np.int32)

    def layers(m):
        return [m.Dense(8, activation="relu", input_shape=(6,), name="d1"),
                m.Dense(3, activation="softmax", name="d2")]
    jm = JaxSeq(layers(jcore))
    params = jax.tree.map(np.asarray, jm.init_weights(jax.random.PRNGKey(1)))
    tm = Sequential(layers(tcore))
    tm.set_weights(params)
    jax_context().set_seed(42)
    init_context(device="cpu", seed=42)     # the façade's Estimator reads it
    jm.compile(jopt.SGD(0.5, momentum=0.9), "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    tm.compile(topt.SGD(0.5, momentum=0.9), "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    hj = jm.fit(x, y, batch_size=8, nb_epoch=3, verbose=False)
    ht = tm.fit(x, y, batch_size=8, nb_epoch=3, verbose=False)
    np.testing.assert_allclose(ht.history["loss"], hj.history["loss"],
                               atol=1e-5)
    rj, rt = jm.evaluate(x, y, batch_size=8), tm.evaluate(x, y, batch_size=8)
    assert rt["accuracy"] == pytest.approx(rj["accuracy"], abs=1e-6)
    assert rt["loss"] == pytest.approx(rj["loss"], abs=1e-5)
    np.testing.assert_allclose(tm.predict(x, batch_size=8),
                               jm.predict(x, batch_size=8), atol=1e-5)
    want, got = _leaves(jm.get_weights()), _leaves(tm.get_weights())
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5)


def test_unported_estimator_features_raise():
    m = Sequential([tcore.Dense(2, input_shape=(3,))])
    est = Estimator(m, optimizer="sgd", loss="mse",
                    ctx=ZooContext(ZooConf(device="cpu")))
    x, y = np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32)
    for call, match in ((lambda: est.set_checkpoint("/nonexistent"),
                         "checkpoint"),
                        (est.save_checkpoint, "checkpoint"),
                        (lambda: est.set_tensorboard("/x", "a"),
                         "TensorBoard"),
                        (lambda: est.fit(x, y, steps_per_call=2),
                         "steps_per_call"),
                        (lambda: est.fit(x, y, resume=True), "checkpoint"),
                        (lambda: Estimator(m, param_plan=object()),
                         "param_plan")):
        with pytest.raises(NotImplementedError, match=match):
            call()
    est.ctx.conf.profile_dir = "/tmp/trace"
    with pytest.raises(NotImplementedError, match="profile_dir"):
        est.fit(x, y)
    with pytest.raises(RuntimeError, match="optimizer and loss"):
        Estimator(m, ctx=est.ctx).fit(x, y)


def test_prefetcher_surfaces_iterator_errors():
    def batches():
        yield 1
        raise KeyError("broken batch")
    feed = testim._DevicePrefetcher(batches(), lambda b: b * 2, 2)
    got = []
    with pytest.raises(KeyError, match="broken batch"):
        for item in feed:
            got.append(item)
    assert got == [2]
    feed.close()
    stopped = testim._DevicePrefetcher(iter(range(100)), lambda b: b, 1)
    stopped.close()
    assert not stopped._t.is_alive()


# -- dropout -------------------------------------------------------------------

def test_dropout_statistics_and_eval_identity():
    """Keep fraction within 4 sigma of Binomial(n, keep); every kept value
    exactly x / keep; the identity in eval mode and with no seed; the same
    seed draws the same mask, another seed another."""
    n, p = 200_000, 0.3
    x = torch.rand(n) + 0.5
    d = tcore.Dropout(p, input_shape=(n,))
    d.train()
    assert torch.equal(d(x), x)                  # no seed: JAX's rng=None
    d.seed_dropout(11)
    y = d(x)
    kept = y != 0
    keep = 1 - p
    assert abs(float(kept.float().mean()) - keep) <= 4 * np.sqrt(
        keep * p / n)
    assert torch.equal(y[kept], x[kept] / keep)
    assert torch.equal(d(x), y)
    d.seed_dropout(12)
    assert not torch.equal(d(x), y)
    d.eval()
    assert torch.equal(d(x), x)


def test_seeds_split_per_sublayer():
    """Sub-layer i gets split_seed(seed, i), as split_rng(rng, i); a None
    seed reaches every layer."""
    tl = tatt.TransformerLayer(V, 32, 2, 2, 16, name="s")
    tl.seed_dropout(5)
    blocks = list(tl.sublayers())
    assert [b.dropout_seed for b in blocks] == [tmod.split_seed(5, i)
                                                for i in range(2)]
    blk = blocks[1]
    assert blk.attn.dropout_seed == tmod.split_seed(blk.dropout_seed, 0)
    assert blk.ffn.dropout_seed == tmod.split_seed(blk.dropout_seed, 1)
    assert len({b.dropout_seed for b in blocks}) == 2
    tl.seed_dropout(None)
    assert all(m.dropout_seed is None for m in tl.modules()
               if isinstance(m, tmod.Layer))


def test_transformer_dropouts_in_training_mode(monkeypatch):
    """embedding_drop and resid_drop drop in training mode; attn_drop takes
    the einsum path with the layer's generator (the flash path never sees
    dropout); eval mode is the deterministic forward."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, V, (2, 16)))
    base = tatt.TransformerLayer(V, 32, 1, 2, 16, name="d0")
    drop = tatt.TransformerLayer(V, 32, 1, 2, 16, embedding_drop=0.2,
                                 attn_drop=0.3, resid_drop=0.1, name="d0")
    drop.load_state_dict(base.state_dict())
    with torch.no_grad():
        ref = base(ids)
        assert torch.equal(drop(ids), ref)                 # eval mode
        drop.train()
        drop.seed_dropout(3)
        calls = []
        core = tops._attention_core

        def spy(*args, **kwargs):
            calls.append((kwargs["dropout_rate"], kwargs["dropout_rng"]))
            return core(*args, **kwargs)
        monkeypatch.setattr(tops, "_attention_core", spy)
        a = drop(ids)
        assert len(calls) == 1 and calls[0][0] == 0.3
        assert isinstance(calls[0][1], torch.Generator)
        assert not torch.allclose(a, ref)
        assert torch.equal(drop(ids), a)                   # same seed
        drop.seed_dropout(4)
        assert not torch.equal(drop(ids), a)


def test_fit_seeds_dropout_per_step():
    """The Estimator seeds every step with split_seed(conf.seed, step):
    steps draw different masks, and two fits from one seed the same."""
    def fit():
        m = Sequential([tcore.Dense(16, input_shape=(8,), name="a"),
                        tcore.Dropout(0.5, name="drop"),
                        tcore.Dense(1, name="b")])
        torch.manual_seed(0)
        m.init_weights(1)
        seeds = []
        drop = m.layers_list[1]
        drop.register_forward_pre_hook(
            lambda mod, args: seeds.append(mod.dropout_seed))
        est = Estimator(m, optimizer="sgd", loss="mse",
                        ctx=ZooContext(ZooConf(seed=9, device="cpu")),
                        registry=MetricsRegistry())
        g = np.random.default_rng(0)
        x = g.normal(size=(16, 8)).astype(np.float32)
        est.fit(x, x[:, :1], batch_size=8, epochs=1, verbose=False)
        return seeds, [p.detach().clone() for p in m.parameters()]
    seeds, p1 = fit()
    split = tmod.split_seed
    assert seeds == [split(split(9, s), 1) for s in (0, 1)]
    seeds2, p2 = fit()
    assert seeds2 == seeds and all(torch.equal(a, b) for a, b in zip(p1, p2))
