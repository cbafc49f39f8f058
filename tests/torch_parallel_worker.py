"""A rank of a ``torch.distributed`` gloo world on the CPU, spawned by
``tests/test_torch_port_parallel_world.py``.

Run: ``python tests/torch_parallel_worker.py BUNDLE DIR WORLD RANK``.
The ranks meet through a ``FileStore`` in DIR (no port).  A bundle's
inputs (seeded arrays and the JAX package's weights, written by the test)
are read from ``DIR/inputs.pkl``; each rank writes its results, numpy
arrays keyed by case, to ``DIR/out-<rank>.pkl``.  The process runs one
thread and ends its process group on the way out, failed or not.

Bundles: ``four`` (4 ranks: ring attention, tensor-parallel layers,
pipelines, expert parallelism, seq- / pipe-parallel and megatron fits),
``two`` (2 ranks: a fit over process-local partitions, even and
uneven, and ``MultiProcessSearchEngine``), and ``card`` (4 ranks on
cuda:0: the ring's flash body against the kernel over the whole
sequence; ``tests/test_torch_port_card.py`` spawns it on the card).
"""

import datetime
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from analytics_zoo_tpu_torch.common.context import (P, ZooConf,  # noqa: E402
                                                    ZooContext,
                                                    init_context)
from analytics_zoo_tpu_torch.common.observability import \
    MetricsRegistry  # noqa: E402
from analytics_zoo_tpu_torch.estimator.estimator import \
    Estimator  # noqa: E402
from analytics_zoo_tpu_torch.nn import optimizers as topt  # noqa: E402
from analytics_zoo_tpu_torch.nn.layers import attention as tatt  # noqa: E402
from analytics_zoo_tpu_torch.nn.layers import core as tcore  # noqa: E402
from analytics_zoo_tpu_torch.nn.layers.moe import \
    MixtureOfExperts  # noqa: E402
from analytics_zoo_tpu_torch.nn.models import Sequential  # noqa: E402
from analytics_zoo_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from analytics_zoo_tpu_torch.parallel import ring_attention as tring  # noqa
from analytics_zoo_tpu_torch.parallel import sharding as tsh  # noqa: E402
from analytics_zoo_tpu_torch.parallel.pipeline_model import \
    PipelinedTransformer  # noqa: E402
from analytics_zoo_tpu_torch.utils.convert import (export_params,  # noqa
                                                   load_jax_params)


def np_(t):
    return t.detach().cpu().numpy()


def ctx_for(axes, shape, seed=42):
    return init_context(mesh_axes=axes, mesh_shape=shape, device="cpu",
                        seed=seed)


def fit_losses(est, x, y, batch, epochs, **kw):
    losses = []
    est._listeners.append(lambda s, l: losses.append(float(l)))
    hist = est.fit(x, y, batch_size=batch, epochs=epochs, shuffle=False,
                   verbose=False, **kw)
    return losses, hist.history["loss"]


# -- bundle "four" -----------------------------------------------------------------

def ring_cases(inp, out):
    """Both hop bodies, causal and full: this rank's output block and the
    gradients of sum(out * ct) for its q, k, v blocks."""
    ctx = ctx_for(("seq",), (4,))
    q, k, v, ct = (torch.from_numpy(inp["ring"][n]) for n in "qkvc")
    T = q.shape[2]
    tl, i = T // 4, ctx.mesh.index("seq")

    def block(a):
        return a[:, :, i * tl:(i + 1) * tl].clone().requires_grad_(True)
    for impl in ("xla", "flash"):
        for causal in (False, True):
            qs, ks, vs = block(q), block(k), block(v)
            o = tring.ring_attention(qs, ks, vs, ctx.mesh, causal=causal,
                                     impl=impl)
            (o * ct[:, :, i * tl:(i + 1) * tl]).sum().backward()
            out[f"ring/{impl}/{int(causal)}"] = dict(
                o=np_(o), dq=np_(qs.grad), dk=np_(ks.grad), dv=np_(vs.grad))


def tp_cases(inp, out):
    """The column-parallel matmul, and a megatron GPT-2-tiny forward and
    gradients (this rank's slices)."""
    ctx = ctx_for(("model",), (4,))
    x, W = inp["tp"]["x"], inp["tp"]["W"]
    d = tcore.Dense(W.shape[1], input_shape=(W.shape[0],), name="fc")
    load_jax_params(d, {"W": W, "b": np.zeros(W.shape[1], np.float32)})
    tsh.ShardingPlan([(r".*W$", P(None, "model"))]).shard(d, ctx.mesh)
    out["tp/matmul"] = np_(d(torch.from_numpy(x)))
    g = inp["gpt"]
    m = Sequential(gpt_layers(g["geo"]))
    load_jax_params(m, g["params"])
    tsh.megatron_plan().shard(m, ctx.mesh)
    ids, labels = torch.from_numpy(g["x"]), torch.from_numpy(g["y"])
    pred = m(ids)
    from analytics_zoo_tpu_torch.nn import objectives
    loss = objectives.get("sparse_categorical_crossentropy")(
        pred, labels).mean()
    loss.backward()
    out["tp/gpt"] = dict(
        pred=np_(pred), loss=float(loss),
        grads={p: np_(t.grad) for p, t in named_leaves(m)},
        layout={p: tuple(l) for p, l in m.shard_layout.items()})


def named_leaves(m):
    """(path, parameter) of every leaf of the model's param tree."""
    out = []

    def walk(v, path):
        from analytics_zoo_tpu_torch.nn.module import Layer
        if isinstance(v, Layer):
            walk(v._tree(), path)
        elif isinstance(v, dict):
            for k in v:
                walk(v[k], f"{path}/{k}" if path else k)
        else:
            out.append((path, v))
    walk(m, "")
    return out


def gpt_layers(geo):
    V, H, NB, NH, T = geo
    return [tatt.TransformerLayer(vocab=V, hidden_size=H, n_block=NB,
                                  n_head=NH, seq_len=T, input_shape=(T,),
                                  name="tl"),
            tcore.Dense(V, activation="softmax", name="head")]


def pipeline_cases(inp, out):
    """pipeline_apply forward (4 stages) and gradients; the heterogeneous
    pipeline_apply_stages over pipe 2, forward and gradients."""
    ctx = ctx_for(("pipe",), (4,))
    pp = inp["pipe"]
    stacked = {k: torch.from_numpy(v) for k, v in pp["fwd_params"].items()}

    def stage_fn(p, x):
        return torch.tanh(x @ p["W"] + p["b"])
    xm = tpipe.to_microbatches(torch.from_numpy(pp["x"]), 8)
    out["pipe/fwd"] = np_(tpipe.from_microbatches(
        tpipe.pipeline_apply(stage_fn, stacked, xm, ctx.mesh)))
    W = torch.from_numpy(pp["grad_W"]).requires_grad_(True)
    xm = tpipe.to_microbatches(torch.from_numpy(pp["gx"]), 4)
    y = tpipe.pipeline_apply(lambda p, x: torch.tanh(x @ p["W"]), {"W": W},
                             xm, ctx.mesh)
    (y ** 2).sum().backward()
    s = ctx.mesh.index("pipe")
    out["pipe/grad"] = dict(stage=s, gW=np_(W.grad[s]))

    ctx = ctx_for(("data", "pipe"), (2, 2))
    hp = inp["stages"]
    p0 = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in hp["p0"].items()}
    p1 = {"gate": {"A": torch.from_numpy(hp["p1"]["gate"]["A"])
                   .requires_grad_(True)},
          "scale": torch.from_numpy(hp["p1"]["scale"]).requires_grad_(True)}

    def f0(p, x):
        return torch.tanh(x @ p["W"] + p["b"])

    def f1(p, x):
        return x * torch.sigmoid(x @ p["gate"]["A"]) * p["scale"]
    xm = tpipe.to_microbatches(torch.from_numpy(hp["x"]), 4)
    y = tpipe.pipeline_apply_stages([f0, f1], [p0, p1], xm, ctx.mesh)
    (y ** 2).sum().backward()
    out["stages"] = dict(y=np_(tpipe.from_microbatches(y)),
                         W=np_(p0["W"].grad), b=np_(p0["b"].grad),
                         A=np_(p1["gate"]["A"].grad),
                         scale=np_(p1["scale"].grad))


def moe_case(inp, out):
    """Experts over ``expert`` (data 2 x expert 2): this rank's rows of the
    expert-parallel forward."""
    ctx = ctx_for(("data", "expert"), (2, 2))
    mo = inp["moe"]
    layer = MixtureOfExperts(4, 16, top_k=2, input_shape=(6, 8), name="moe")
    load_jax_params(layer, mo["params"])
    tsh.ShardingPlan([(r"^experts/", P("expert"))]).shard(layer, ctx.mesh)
    d = ctx.mesh.index("data")
    x = torch.from_numpy(mo["x"])
    rows = x.shape[0] // 2
    out["moe"] = dict(rows=(d * rows, (d + 1) * rows), y=np_(
        layer(x[d * rows:(d + 1) * rows])),
        held=int(layer.W1.shape[0]))


def fit_cases(inp, out):
    """Seq-parallel (data 2 x seq 2) and pipeline (data 2 x pipe 2) fits,
    and a megatron fit (model 4) with global-norm clipping: losses and
    this rank's trained slices."""
    sq = inp["seq_fit"]
    ctx = ctx_for(("data", "seq"), (2, 2))
    V, H, T = sq["geo"]
    m = tatt.TransformerLayer(vocab=V, hidden_size=H, n_block=2, n_head=2,
                              seq_len=T, input_shape=(T,), name="tl")
    load_jax_params(m, sq["params"])
    rows = tsh.process_rows(len(sq["x"]), 8, ctx)
    calls = []
    orig = tring.ring_attention

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    tring.ring_attention = counting
    try:
        est = Estimator(m, optimizer="sgd", loss="mse", ctx=ctx,
                        registry=MetricsRegistry())
        losses, hist = fit_losses(est, sq["x"][rows], sq["y"][rows], 8, 2)
    finally:
        tring.ring_attention = orig
    out["seq_fit"] = dict(losses=losses, hist=hist, ring_calls=len(calls))

    pf = inp["pipe_fit"]
    ctx = ctx_for(("data", "pipe"), (2, 2))
    V, H, T = pf["geo"]
    m = PipelinedTransformer(vocab=V, hidden_size=H, n_stages=2, n_head=2,
                             seq_len=T, n_micro=2, name="pt")
    load_jax_params(m, pf["params"])
    rows = tsh.process_rows(len(pf["x"]), 8, ctx)
    est = Estimator(m, optimizer="sgd",
                    loss="sparse_categorical_crossentropy_from_logits",
                    ctx=ctx, param_plan=PipelinedTransformer.sharding_plan(),
                    registry=MetricsRegistry())
    losses, hist = fit_losses(est, pf["x"][rows], pf["y"][rows], 8, 2)
    out["pipe_fit"] = dict(losses=losses, hist=hist,
                           stage=ctx.mesh.index("pipe"),
                           trained={p: np_(t) for p, t in
                                    tsh.leaf_paths(export_params(m))})

    mf = inp["mega_fit"]
    ctx = ctx_for(("model",), (4,))
    m = Sequential(gpt_layers(mf["geo"]))
    load_jax_params(m, mf["params"])
    est = Estimator(m, optimizer=topt.Adam(lr=1e-3), clip_norm=0.5,
                    loss="sparse_categorical_crossentropy", ctx=ctx,
                    param_plan=tsh.megatron_plan(),
                    registry=MetricsRegistry())
    losses, hist = fit_losses(est, mf["x"], mf["y"], 8, 1)
    out["mega_fit"] = dict(
        losses=losses, trained={p: np_(t) for p, t in
                                tsh.leaf_paths(export_params(m))},
        layout={p: tuple(l) for p, l in m.shard_layout.items()},
        route=est.fit_summary()["route"])


# -- bundle "two" ------------------------------------------------------------------

def multiprocess_fit(inp, out):
    """The JAX multi-host protocol: each rank fits its partition; even
    (256 rows) and uneven (257) datasets."""
    from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet
    rank = dist.get_rank()
    for key in ("even", "uneven"):
        c = inp[key]
        ctx = init_context(device="cpu", seed=42)
        m = Sequential([tcore.Dense(16, activation="tanh",
                                    input_shape=(c["x"].shape[1],),
                                    name="d1"),
                        tcore.Dense(1, activation="sigmoid", name="d2")])
        load_jax_params(m, c["params"])
        part = ArrayFeatureSet(c["x"], c["y"]).partition(rank, 2)
        est = Estimator(m, optimizer="sgd", loss="binary_crossentropy",
                        metrics=["accuracy"], ctx=ctx,
                        registry=MetricsRegistry())
        hist = est.fit(part, batch_size=32, epochs=3, shuffle=False,
                       verbose=False)
        ev = est.evaluate(part, batch_size=32)
        pred = est.predict(part, batch_size=32)
        out[key] = dict(losses=hist.history["loss"],
                        accuracy=ev["accuracy"], pred=pred)
    from analytics_zoo_tpu_torch.parallel import comm
    out["allgather"] = comm.process_allgather(
        np.array([rank, 10 + rank], np.int64), mesh=ctx.mesh)


SEARCH_TRIALS = 4


def search_df(n=160):
    """The JAX multi-process AutoML test's series."""
    import pandas as pd
    g = np.random.default_rng(0)
    return pd.DataFrame({
        "datetime": pd.date_range("2020-01-01", periods=n, freq="h"),
        "value": np.sin(np.arange(n) / 12.0)
        + 0.05 * g.normal(size=n).astype(np.float32)})


def search_fit(distributed: bool) -> dict:
    """An AutoTS search of ``SEARCH_TRIALS`` LSTM configs (the JAX
    ``tests/automl_mp_worker.py`` recipe) on the CPU: each trial's
    (units, lr, validation MSE), the best config and the trials this
    process ran."""
    from analytics_zoo_tpu_torch.automl.regression import (
        Recipe, TimeSequencePredictor)
    from analytics_zoo_tpu_torch.automl.search import Choice

    class _R(Recipe):
        n_trials = SEARCH_TRIALS

        def search_space(self, all_available_features=()):
            return {"model": "LSTM", "lstm_units": Choice([4, 8]),
                    "lr": Choice([0.01, 0.003]), "lookback": Choice([8]),
                    "dropout": Choice([0.0]), "epochs": Choice([2]),
                    "batch_size": Choice([32])}
    pred = TimeSequencePredictor(future_seq_len=1, recipe=_R(),
                                 distributed=distributed, device="cpu")
    calls = []
    orig = TimeSequencePredictor._train_one

    def counting(self, cfg, df_):
        calls.append(1)
        return orig(self, cfg, df_)
    TimeSequencePredictor._train_one = counting
    try:
        pipe = pred.fit(search_df(), verbose=False)
    finally:
        TimeSequencePredictor._train_one = orig
    return {"trials": [(t.config["lstm_units"], t.config["lr"],
                        round(t.metric, 6)) for t in pred._last_trials],
            "best": {k: pipe.config[k] for k in ("lstm_units", "lr")},
            "local_trial_count": len(calls) - 1}   # minus the best retrain


def search_case(inp, out):
    """The search with ``distributed=True`` over 2 ranks, each trial in a
    process-local context."""
    init_context(devices=[dist.get_rank()], device="cpu", seed=42)
    out["search"] = search_fit(True)


# -- bundle "card" -----------------------------------------------------------------

def card_ring(inp, out):
    """The ring's flash body on cuda:0 (4 ranks on one card, gloo staging
    the blocks through host memory), causal and full: this rank's output
    block and the gradients of sum(out * ct) for its q, k, v blocks, and
    the flash kernels' launches by the wrappers and on the card."""
    from analytics_zoo_tpu_torch.ops import _impl
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    ctx = init_context(mesh_axes=("seq",), mesh_shape=(4,), device=str(dev),
                       seed=42)
    q, k, v, ct = (torch.from_numpy(inp["ring"][n]).to(dev) for n in "qkvc")
    tl, i = q.shape[2] // 4, ctx.mesh.index("seq")
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for causal in (False, True):
        blocks = [a[:, :, i * tl:(i + 1) * tl].clone().requires_grad_(True)
                  for a in (q, k, v)]
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        with _impl.card_launches(kernels) as card:
            o = tring.ring_attention(*blocks, ctx.mesh, causal=causal,
                                     impl="flash")
            (o * ct[:, :, i * tl:(i + 1) * tl]).sum().backward()
        out[f"ring/{int(causal)}"] = dict(
            o=np_(o), dq=np_(blocks[0].grad), dk=np_(blocks[1].grad),
            dv=np_(blocks[2].grad), card=dict(card),
            wrappers=(fa.launches, fa.dq_launches, fa.dkv_launches))


BUNDLES = {"four": (ring_cases, tp_cases, pipeline_cases, moe_case,
                    fit_cases),
           "two": (multiprocess_fit, search_case),
           "card": (card_ring,)}


def main():
    bundle, tmp, world, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        int(sys.argv[4])
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = {}
        for case in BUNDLES[bundle]:
            case(inp, out)
        with open(os.path.join(tmp, f"out-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return 0
    except Exception:  # noqa: BLE001 — report, then end the group
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
