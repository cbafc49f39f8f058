"""PyTorch port: the Estimator's checkpoints, failure retry, preemption,
``steps_per_call`` and ``profile_dir`` against the JAX package, on the CPU.

- ``utils/chaos.FaultInjector``: the JAX schedules, run on both copies
  (``tests/test_resilience.py``'s injector tests);
- ``estimator/checkpoint.CheckpointManager``: a save/restore round trip
  bit for bit, the ``keep`` newest steps, a restore into live tensors in
  place, a re-save of one step, an async save durable after ``fit``;
- ``fit(resume=True)``: a fit checkpointed at its epoch's end and resumed
  by a fresh Estimator gives the per-step losses of the JAX package's
  resumed fit and, exactly, of the port's uninterrupted fit;
- the failure-retry loop: a step listener that raises once restores the
  latest snapshot and runs the epoch again, with the JAX package's
  history and final weights, and the uninterrupted fit's weights exactly;
- SIGTERM: a worker process (``tests/torch_preemption_worker.py``)
  snapshots and exits 143; a resumed process continues from the
  snapshot with the uninterrupted run's losses;
- ``steps_per_call=4``: the same losses and weights as 4 single steps,
  and the JAX package's scanned fit;
- ``profile_dir``: a Chrome trace of the fit, refused while another
  profiler session holds ``ops/_impl.PROFILER_LOCK``.

Every fit starts from the JAX model's weights (``load_jax_params``) and
the same numpy data.  Tolerances: port vs JAX 1e-5 on losses and weights
(f32 in another summation order, read at ~1e-7 on losses of ~0.7); the
port against itself exactly (the same CPU arithmetic in one thread).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.common.triggers import \
    SeveralIteration as JaxSeveralIteration
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.utils import chaos as jchaos
from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.common.triggers import (EveryEpoch,
                                                     SeveralIteration)
from analytics_zoo_tpu_torch.estimator.checkpoint import CheckpointManager
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.utils import chaos as tchaos
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_preemption_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))

# port vs JAX: f32 in another summation order
ATOL = 1e-5
CHAOS = {"jax": jchaos, "port": tchaos}


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


# -- FaultInjector ---------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(CHAOS))
def test_injector_schedules_by_index_and_predicate(pkg):
    inj = CHAOS[pkg].FaultInjector()
    inj.fail_at("pre", indices=[1, 3])
    inj.fail_when("predict", lambda ctx: ctx.get("rid") == "poison")
    outcomes = []
    for _ in range(5):
        try:
            inj.maybe_fail("pre")
            outcomes.append("ok")
        except CHAOS[pkg].InjectedFault:
            outcomes.append("boom")
    assert outcomes == ["ok", "boom", "ok", "boom", "ok"]
    assert inj.fired == ["pre#1", "pre#3"]
    inj.maybe_fail("predict", rid="fine")
    with pytest.raises(CHAOS[pkg].InjectedFault):
        inj.maybe_fail("predict", rid="poison")


@pytest.mark.parametrize("pkg", sorted(CHAOS))
def test_injector_wrap_outage_and_custom_exception(pkg):
    inj = CHAOS[pkg].FaultInjector().fail("q", times=1, exc=ConnectionError,
                                          message="redis down")
    calls = []
    wrapped = inj.wrap("q", lambda x: calls.append(x) or x)
    with pytest.raises(ConnectionError, match="redis down"):
        wrapped(1)
    assert wrapped(2) == 2
    assert calls == [2] and inj.count("q") == 2
    inj.reset("q")
    assert inj.count("q") == 0
    with inj.outage("a", "b"):
        for site in ("a", "b"):
            with pytest.raises(CHAOS[pkg].InjectedFault, match="outage"):
                inj.maybe_fail(site)
    inj.maybe_fail("a")
    assert inj._plans["a"] == [] and inj.fired == ["q#0", "a#0", "b#0"]


def test_injector_thread_safety_counts():
    inj = tchaos.FaultInjector()
    n_threads, per = 8, 200

    def hammer():
        for _ in range(per):
            inj.maybe_fail("site")

    ts = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert inj.count("site") == n_threads * per


# -- CheckpointManager -----------------------------------------------------------

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": [torch.randn(3, 4, generator=g),
                       torch.randn(4, generator=g)],
            "opt_state": {"inner": [{"count": seed,
                                     "mu": [torch.randn(2, generator=g)]},
                                    {}]},
            "model_state": {"bn": torch.randn(5, generator=g)}}


def _save(mgr, step, tree, wait=False):
    mgr.save(step, tree["params"], tree["opt_state"], tree["model_state"],
             extra={"epoch": step // 4}, wait=wait)


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b) and a.dtype == b.dtype
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_trees_equal(u, v)
    else:
        assert a == b


def test_checkpoint_roundtrip_is_bitwise_and_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None
    trees = {s: _tree(s) for s in (4, 8, 12)}
    for s, t in trees.items():
        _save(mgr, s, t)
        t["params"][0].add_(1.0)   # the copy was taken at save()
    assert mgr.latest_step() == 12 and mgr.steps() == [8, 12]
    assert sorted(os.listdir(mgr.directory)) == ["12", "8"]
    got = mgr.restore(step=8)
    want = _tree(8)
    _assert_trees_equal(got, dict(want, global_step=8, extra={"epoch": 2}))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_copies_into_live_tensors(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _save(mgr, 4, _tree(1), wait=True)
    live = _tree(2)
    ids = [id(t) for t in live["params"]]
    like = dict(live, global_step=0, extra={"epoch": 0})
    out = mgr.restore(like)
    assert [id(t) for t in out["params"]] == ids
    _assert_trees_equal(out["params"], _tree(1)["params"])
    assert out["global_step"] == 4
    assert out["opt_state"]["inner"][0]["count"] == 1
    bad = dict(like, params=[torch.zeros(2, 2), torch.zeros(4)])
    with pytest.raises(ValueError, match="params/0"):
        mgr.restore(bad)


def test_resave_of_a_step_and_no_partial_snapshot(tmp_path):
    """A step saved twice keeps the second; a save's temporary directory
    is never taken for a step."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _save(mgr, 4, _tree(1))
    _save(mgr, 4, _tree(3), wait=True)
    _assert_trees_equal(mgr.restore()["params"], _tree(3)["params"])
    os.makedirs(os.path.join(mgr.directory, ".tmp-8-1-1"))
    open(os.path.join(mgr.directory, ".tmp-8-1-1", "state.pt"), "wb").close()
    os.makedirs(os.path.join(mgr.directory, "12"))   # no state file
    assert mgr.latest_step() == 4


# -- Estimator parity ------------------------------------------------------------

N, D, BATCH = 32, 6, 8        # 4 steps an epoch; batch a multiple of the
                              # JAX test mesh's 8-way data axis


def _layers(core):
    # tanh, not relu: a relu unit at its kink can tip on an f32 rounding
    # and part the two packages' runs by 1e-4 within a few steps
    return [core.Dense(8, activation="tanh", input_shape=(D,), name="d1"),
            core.Dense(1, activation="sigmoid", name="d2")]


def _data(seed=0, n=N):
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, D)).astype(np.float32)
    return x, (x.sum(-1, keepdims=True) > 0).astype(np.float32)


def _jax_model():
    jm = JaxSeq(_layers(jcore))
    jm.init_weights(jax.random.PRNGKey(3))
    return jm


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, _jax_model().get_weights())


def _jax_est(params, **kw):
    """The JAX Estimator over a model holding ``params`` (the same
    seeded draw, layer names fixed)."""
    jm = _jax_model()
    jax_context().set_seed(42)
    return JaxEstimator(jm, optimizer=jopt.Adam(lr=0.02),
                        loss="binary_crossentropy", **kw)


def _port_est(params, **kw):
    tm = Sequential(_layers(tcore))
    load_jax_params(tm, params)
    return Estimator(tm, optimizer=topt.Adam(lr=0.02),
                     loss="binary_crossentropy", registry=MetricsRegistry(),
                     ctx=ZooContext(ZooConf(seed=42, device="cpu")), **kw)


def _record(est):
    log = []
    est._listeners.append(lambda s, l: log.append((s, float(l))))
    return log


def _port_weights(est):
    return {f"{k}/{n}": v.detach().numpy().copy()
            for k, sub in export_params(est.model).items()
            for n, v in sub.items()}


def _jax_weights(est):
    return {f"{k}/{n}": np.asarray(v) for k, sub in est.params.items()
            for n, v in sub.items()}


def _close(a, b, atol=ATOL):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def test_resumed_fit_matches_jax_and_uninterrupted(init_params, tmp_path):
    x, y = _data()
    fit = dict(batch_size=BATCH, verbose=False, shuffle=False)
    whole = _port_est(init_params)
    whole_log = _record(whole)
    whole.fit(x, y, epochs=2, **fit)
    out = {}
    for pkg, make in (("jax", _jax_est), ("port", _port_est)):
        first = make(init_params)
        first.set_checkpoint(str(tmp_path / pkg), trigger=(
            JaxSeveralIteration(4) if pkg == "jax" else EveryEpoch()))
        first.fit(x, y, epochs=1, **fit)
        second = make(init_params)
        second.set_checkpoint(str(tmp_path / pkg))
        log = _record(second)
        second.fit(x, y, epochs=1, resume=True, **fit)
        out[pkg] = (log, second)
    (jlog, je), (tlog, te) = out["jax"], out["port"]
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == [5, 6, 7, 8]
    np.testing.assert_allclose([v for _, v in tlog], [v for _, v in jlog],
                               atol=ATOL)
    assert tlog == whole_log[4:]
    assert te.global_step == je.global_step == 8 and te.epoch == 2
    _close(_port_weights(te), _jax_weights(je))
    _close(_port_weights(te), _port_weights(whole), atol=0)


def test_failure_retry_matches_jax_and_uninterrupted(init_params, tmp_path):
    """A listener raises once at step 6; the loop restores step 4's
    snapshot and runs epoch 2 again."""
    x, y = _data()
    fit = dict(batch_size=BATCH, epochs=3, verbose=False, shuffle=False)
    whole = _port_est(init_params)
    whole.fit(x, y, **fit)
    out = {}
    for pkg, make, trig in (("jax", _jax_est, JaxSeveralIteration),
                            ("port", _port_est, SeveralIteration)):
        est = make(init_params)
        est.ctx.conf.failure_retry_backoff_s = 0.0
        est.set_checkpoint(str(tmp_path / pkg), trigger=trig(4))
        log = _record(est)
        # the 6th listener call: step 6, the first time through
        inj = CHAOS[pkg].FaultInjector().fail_at("step", indices=[5])
        est._listeners.append(lambda s, l, inj=inj: inj.maybe_fail("step"))
        hist = est.fit(x, y, **fit)
        out[pkg] = (log, est, hist, inj.fired)
    (jlog, je, jh, jf), (tlog, te, th, tf) = out["jax"], out["port"]
    assert jf == tf == ["step#5"]
    steps = [1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9, 10, 11, 12]
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == steps
    np.testing.assert_allclose([v for _, v in tlog], [v for _, v in jlog],
                               atol=ATOL)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               atol=ATOL)
    assert len(th.history["loss"]) == 3
    _close(_port_weights(te), _jax_weights(je))
    _close(_port_weights(te), _port_weights(whole), atol=0)


def test_failure_without_snapshot_or_retries_raises(init_params, tmp_path):
    x, y = _data()
    for retries, ckpt in ((5, False), (0, True)):
        est = _port_est(init_params)
        est.ctx.conf.failure_retry_times = retries
        if ckpt:
            est.set_checkpoint(str(tmp_path / "c"), trigger=SeveralIteration(2))

        def boom(step, loss):
            if step == 3:
                raise tchaos.InjectedFault("step 3")
        est._listeners.append(boom)
        with pytest.raises(tchaos.InjectedFault, match="step 3"):
            est.fit(x, y, batch_size=BATCH, verbose=False, shuffle=False)


def test_async_save_is_durable_after_fit(init_params, tmp_path):
    x, y = _data()
    est = _port_est(init_params)
    est.set_checkpoint(str(tmp_path / "c"), trigger=SeveralIteration(2),
                       keep=2)
    est.fit(x, y, batch_size=BATCH, epochs=2, verbose=False)
    mgr = est._ckpt_mgr
    assert mgr._thread is None and mgr.steps() == [6, 8]
    assert sorted(os.listdir(mgr.directory)) == ["6", "8"]
    restored = mgr.restore()
    assert restored["global_step"] == 8 and restored["extra"]["epoch"] == 2
    for got, p in zip(restored["params"], est.params):
        assert torch.equal(got, p.detach())
    assert restored["opt_state"]["inner"][0]["count"] == 8


def _worker(ckpt, *flags):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, WORKER, ckpt, *flags],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO, env=env)


def _steps(lines):
    docs = [json.loads(line) for line in lines if line.strip()]
    return [(d["step"], d["loss"]) for d in docs if "step" in d]


def test_sigterm_snapshots_and_resume_continues(tmp_path):
    """The victim exits 143 with a snapshot at the step where it noticed
    the signal; the resumed process starts at the next step, and every
    loss either prints is the uninterrupted run's."""
    import torch_preemption_worker as worker
    lines = []
    worker.run(str(tmp_path / "whole"), emit=lines.append)
    whole = dict(_steps(lines))
    assert sorted(whole) == list(range(1, worker.STEPS + 1))

    ckpt = str(tmp_path / "ckpt")
    p = _worker(ckpt, "--slow")
    try:
        assert "start" in p.stdout.readline()
        first = p.stdout.readline()
        assert "step" in first                 # inside the loop
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        p.kill()
    assert p.returncode == 128 + signal.SIGTERM, err[-2000:]
    seen = _steps([first] + out.splitlines())
    snap = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    assert seen and snap == seen[-1][0] < worker.STEPS
    p2 = _worker(ckpt, "--resume")
    try:
        out2, err2 = p2.communicate(timeout=120)
    finally:
        p2.kill()
    assert p2.returncode == 0, err2[-2000:]
    resumed = _steps(out2.splitlines())
    assert [s for s, _ in resumed] == list(range(snap + 1, worker.STEPS + 1))
    assert json.loads(out2.splitlines()[-1])["final_step"] == worker.STEPS
    for step, loss in seen + resumed:
        assert loss == whole[step], step


# -- steps_per_call ----------------------------------------------------------------

def test_steps_per_call_matches_single_steps_and_jax_scan(init_params):
    """10 batches an epoch in groups of 4, 4 and 2, for 2 epochs: the
    port's losses and weights equal its single steps exactly; its epoch
    means, its losses at each group's end and its weights match the JAX
    scanned fit's."""
    x, y = _data(1, n=80)
    fit = dict(batch_size=BATCH, epochs=2, verbose=False, shuffle=True)
    one = _port_est(init_params)
    one_log = _record(one)
    one.fit(x, y, **fit)
    four = _port_est(init_params)
    four_log = _record(four)
    th = four.fit(x, y, steps_per_call=4, **fit)
    assert four_log == one_log and four.global_step == 20
    _close(_port_weights(four), _port_weights(one), atol=0)
    je = _jax_est(init_params)
    jlog = _record(je)
    jh = je.fit(x, y, steps_per_call=4, **fit)
    ends = [4, 8, 10, 14, 18, 20]
    assert [s for s, _ in jlog] == ends
    np.testing.assert_allclose([dict(four_log)[s] for s in ends],
                               [v for _, v in jlog], atol=ATOL)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               atol=ATOL)
    _close(_port_weights(four), _jax_weights(je))
    summ = four.fit_summary()
    assert summ["steps"] == 20 and summ["samples"] == 160


def test_step_scalars_as_tensors_give_the_same_update():
    """An optimizer's ``apply`` given its step scalars as 0-dim float32
    tensors (what a captured graph reads) updates the parameters bit for
    bit as ``update`` with Python floats does, for every optimizer with
    scalars and a warm-up schedule."""
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=g), torch.randn(3, generator=g)]
    grads = [[torch.randn(p.shape, generator=g) for p in params]
             for _ in range(3)]
    for make in (lambda: topt.Adam(1e-2), lambda: topt.Nadam(),
                 lambda: topt.Adamax(), lambda: topt.AdamWeightDecay(
                     1e-3, warmup_portion=0.5, total=3),
                 lambda: topt.with_gradient_clipping(topt.SGD(0.1, 0.9),
                                                     clip_norm=0.5)):
        runs = []
        for as_tensor in (False, True):
            opt, ps = make(), [p.clone() for p in params]
            state = opt.init(ps)
            for gr in grads:
                gr = [t.clone() for t in gr]
                sc = opt.step_scalars(state)
                assert len(sc) == opt.n_scalars
                if as_tensor:
                    sc = list(torch.tensor(sc, dtype=torch.float32).unbind())
                topt.apply_updates(ps, opt.apply(gr, state, ps, sc))
            runs.append(ps)
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# -- profile_dir ---------------------------------------------------------------------

def test_profile_dir_writes_a_trace_and_refuses_a_second_session(
        init_params, tmp_path):
    x, y = _data()
    est = _port_est(init_params)
    est.ctx.conf.profile_dir = str(tmp_path / "prof")
    est.fit(x, y, batch_size=BATCH, verbose=False)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("fit-")
    assert est.profile_path == str(tmp_path / "prof" / files[0])
    with open(est.profile_path) as f:
        names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert not _impl.PROFILER_LOCK.locked()
    step = est.global_step
    with _impl.PROFILER_LOCK:
        with pytest.raises(RuntimeError, match="profiler session"):
            est.fit(x, y, batch_size=BATCH, verbose=False)
    assert est.global_step == step and len(os.listdir(tmp_path / "prof")) == 1


def test_fit_accepts_a_feature_set_with_steps_per_call(init_params):
    x, y = _data()
    est = _port_est(init_params)
    hist = est.fit(ArrayFeatureSet(x, y), batch_size=BATCH, epochs=1,
                   verbose=False, steps_per_call=3)
    assert est.global_step == 4 and len(hist.history["loss"]) == 1
