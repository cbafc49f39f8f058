"""PyTorch port: TensorBoard event files against the JAX package, on the
CPU.

- ``utils/tbwriter.py``: with the wall time and host pinned, the port's
  writer writes the JAX writer's file name and bytes for the same
  scalars and histograms; each package's readers read the other's file;
- ``Estimator.set_tensorboard``: from the same weights and data, the
  port's train and validation event files carry the JAX package's tags
  and steps, and its ``Loss`` and validation values within 1e-5 (f32 in
  another summation order); ``StepTime_s`` is a histogram in both;
- ``ClusterServing(tensorboard_dir=...)``: the JAX engine's
  ``Serving Throughput`` and ``Total Records Number`` tags and steps.
"""

import os
import socket

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.common.observability import \
    MetricsRegistry as JaxRegistry
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu.utils import tbwriter as jtb
from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.utils import tbwriter as ttb
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TB = {"jax": jtb, "port": ttb}
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _write(mod, logdir):
    w = mod.FileWriter(logdir)
    for i in range(5):
        w.add_scalar("Loss", 1.0 / (i + 1), i)
    w.add_scalar("Throughput", 1000.0, 4)
    w.add_histogram("StepTime_s", [0.01, 0.02, 0.02, 0.5], 4,
                    bucket_limits=(0.005, 0.01, 0.05, 0.1))
    w.add_histogram("free", [3.0, 1.0, 2.5], 5)
    w.add_histogram("one", [7.0], 6)
    w.add_histogram("none", [], 7)
    w.close()
    return w.path


def test_writer_bytes_match_jax_with_the_wall_time_pinned(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(jtb.time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host-a")
    paths = {pkg: _write(mod, str(tmp_path / pkg)) for pkg, mod in TB.items()}
    assert os.path.basename(paths["port"]) == os.path.basename(paths["jax"]) \
        == "events.out.tfevents.1700000000.host-a"
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and len(got) > 0


@pytest.mark.parametrize("writer", sorted(TB))
@pytest.mark.parametrize("reader", sorted(TB))
def test_readers_read_either_file(writer, reader, tmp_path):
    path = _write(TB[writer], str(tmp_path))
    scalars = TB[reader].read_scalars(str(tmp_path))
    assert scalars == jtb.read_scalars(path)
    assert [s for s, _ in scalars["Loss"]] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(scalars["Loss"][2][1], 1.0 / 3, rtol=1e-6)
    assert scalars["Throughput"] == [(4, 1000.0)]
    hist = TB[reader].read_histograms(path)
    assert hist == jtb.read_histograms(str(tmp_path))
    (step, h), = hist["StepTime_s"]
    assert step == 4 and h["bucket"] == [0.0, 1.0, 2.0, 0.0, 1.0]
    assert h["bucket_limit"][-1] == float("inf") and h["num"] == 4.0
    assert set(hist) == {"StepTime_s", "free", "one"}


def test_crc32c_matches_jax():
    g = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 1000):
        data = g.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttb.crc32c(data) == jtb.crc32c(data)
        assert ttb._masked_crc(data) == jtb._masked_crc(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283


D = 6


def _layers(core):
    # tanh, not relu: a relu unit at its kink can tip on an f32 rounding
    # and part the two packages' runs by 1e-4 within a few steps
    return [core.Dense(8, activation="tanh", input_shape=(D,), name="d1"),
            core.Dense(1, activation="sigmoid", name="d2")]


def test_estimator_event_files_match_jax(tmp_path):
    g = np.random.default_rng(0)
    x = g.normal(size=(64, D)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    jm = JaxSeq(_layers(jcore))
    params = jax.tree.map(np.asarray, jm.init_weights(jax.random.PRNGKey(4)))
    tm = Sequential(_layers(tcore))
    load_jax_params(tm, params)
    jax_context().set_seed(42)
    # each with a registry of its own: the step-time histogram mirrored
    # into the event file holds this fit's steps only
    je = JaxEstimator(jm, optimizer=jopt.Adam(lr=0.01),
                      loss="binary_crossentropy", metrics=["accuracy"],
                      registry=JaxRegistry())
    te = Estimator(tm, optimizer=topt.Adam(lr=0.01),
                   loss="binary_crossentropy", metrics=["accuracy"],
                   registry=MetricsRegistry(),
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")))
    docs = {}
    for pkg, est in (("jax", je), ("port", te)):
        est.set_tensorboard(str(tmp_path / pkg), "myapp")
        est.fit(x, y, batch_size=16, epochs=2, validation_data=(x, y),
                verbose=False, shuffle=False, log_every=2)
        base = os.path.join(str(tmp_path / pkg), "myapp")
        docs[pkg] = {d: (TB[pkg].read_scalars(os.path.join(base, d)),
                         TB[pkg].read_histograms(os.path.join(base, d)))
                     for d in ("train", "validation")}
    for d in ("train", "validation"):
        (js, jh), (ts, th) = docs["jax"][d], docs["port"][d]
        assert set(ts) == set(js)
        for tag in js:
            assert [s for s, _ in ts[tag]] == [s for s, _ in js[tag]], tag
        assert {t: [s for s, _ in v] for t, v in th.items()} == \
            {t: [s for s, _ in v] for t, v in jh.items()}
    (js, jh), (ts, th) = docs["jax"]["train"], docs["port"]["train"]
    assert set(ts) == {"Loss", "Throughput", "StepTime_ms_mean"}
    assert [s for s, _ in ts["Loss"]] == [2, 4, 4, 6, 8, 8]
    np.testing.assert_allclose([v for _, v in ts["Loss"]],
                               [v for _, v in js["Loss"]], atol=ATOL)
    assert [h["num"] for _, h in th["StepTime_s"]] == \
        [h["num"] for _, h in jh["StepTime_s"]] == [4.0, 8.0]
    vj, vt = docs["jax"]["validation"][0], docs["port"]["validation"][0]
    assert set(vt) == {"accuracy", "loss"}
    for tag in vt:
        np.testing.assert_allclose([v for _, v in vt[tag]],
                                   [v for _, v in vj[tag]], atol=ATOL)


def test_serving_tensorboard_matches_jax(tmp_path):
    jm = JaxSeq([jcore.Dense(4, input_shape=(3,), activation="softmax",
                             name="head")])
    params, state = jm.init(jax.random.PRNGKey(0), (3,))
    tm = Sequential([tcore.Dense(4, input_shape=(3,), activation="softmax",
                                 name="head")])
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    models = {"jax": JaxIM().do_load_model(jm, params, state),
              "port": InferenceModel(device="cpu").do_load_model(tm)}
    got = {}
    for pkg, eng, queues, client in (("jax", jeng, jqueues, jclient),
                                     ("port", teng, tqueues, tclient)):
        q = queues.InProcQueue()
        logdir = str(tmp_path / pkg)
        s = eng.ClusterServing(models[pkg], q, eng.ServingParams(
            batch_size=4), tensorboard_dir=logdir)
        try:
            for rid in ("a", "b", "c"):
                client.InputQueue(q).enqueue_tensor(
                    rid, np.arange(3, dtype=np.float32))
            assert s.serve_once() == 3
        finally:
            s.shutdown()
        got[pkg] = TB[pkg].read_scalars(logdir)
    assert {t: [s for s, _ in v] for t, v in got["port"].items()} == \
        {t: [s for s, _ in v] for t, v in got["jax"].items()} == \
        {"Serving Throughput": [3], "Total Records Number": [3]}
    assert got["port"]["Total Records Number"] == \
        got["jax"]["Total Records Number"]
