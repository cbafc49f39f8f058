"""PyTorch port: ``inference/resources.ResourceLedger`` and the engine's
resource surfaces against the JAX package on the CPU.

- ``doc()`` for the same weights (f32, int8, int4): equal weight bytes,
  quantized width and total; the executables' count and per-program
  execution counts after the same predictions, cold and warmed.
- The generation plane: the ledger's ``kv_state`` equals the batcher's
  ``state_bytes`` / ``state_bytes_doc``, and the scheduler's programs join
  the program map, as in JAX.
- ``InferenceModel.aot_memory_bytes`` is None where no CUDA graph was
  captured (the CPU); ``capture`` refuses a CPU model.
- The engine's ``resources`` and ``process`` health blocks and the
  ``serving_hbm_bytes{component=}`` / ``process_*`` series have the JAX
  engine's keys and names.
- A ``retune`` of ``max_batch`` past the warmed bucket ladder serves, and
  its cold first call is counted in ``aot_stats()``.
"""

import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference import resources as jres
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models.textmodels import TransformerLM as JaxLM
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving import generate as jgen
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu_torch.inference import resources as tres
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import generate as tgen
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.serving.client import OutputQueue
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DIN, DH, DOUT = 64, 48, 32


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _pair(max_batch=1024):
    def layers(m):
        return [m.Dense(DH, input_shape=(DIN,), activation="relu",
                        name="d1"),
                m.Dense(DOUT, activation="softmax", name="d2")]
    jm = JaxSeq(layers(jcore))
    params, state = jm.init(jax.random.PRNGKey(4), (DIN,))
    params = jax.tree.map(np.asarray, params)
    tm = Sequential(layers(tcore))
    load_jax_params(tm, params)
    return (JaxIM(2, max_batch).do_load_model(jm, params, state),
            InferenceModel(2, max_batch, device="cpu").do_load_model(tm))


def _calib():
    return np.random.default_rng(0).normal(size=(8, DIN)).astype(np.float32)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_ledger_doc_matches_jax_for_the_same_weights(bits):
    jim, tim = _pair()
    if bits:
        for im in (jim, tim):
            im.do_quantize(_calib() if bits == 8 else None, force=True,
                           bits=bits, group_size=16)
    jdoc, tdoc = jres.ResourceLedger(jim).doc(), tres.ResourceLedger(tim).doc()
    assert tdoc["weights_bytes"] == jdoc["weights_bytes"] > 0
    assert tdoc["quantized_bits"] == jdoc["quantized_bits"] == bits
    assert tdoc["kv_state_bytes"] == jdoc["kv_state_bytes"] == 0
    assert tdoc["total_bytes"] == tdoc["weights_bytes"]
    assert tdoc["executables"]["code_bytes"] is None
    assert set(tdoc) == set(jdoc)
    assert set(tdoc["executables"]) == set(jdoc["executables"])
    assert tres.ResourceLedger.COMPONENTS == jres.ResourceLedger.COMPONENTS
    for comp in tres.ResourceLedger.COMPONENTS + ("other",):
        want = jres.ResourceLedger(jim).hbm_bytes(comp)
        got = tres.ResourceLedger(tim).hbm_bytes(comp)
        if comp != "executables":
            assert got == want, comp
    if bits == 4:
        f32 = tres.ResourceLedger(_pair()[1]).weights_bytes()
        assert f32 / tdoc["weights_bytes"] > 4


def test_ledger_programs_match_jax_cold_and_warmed():
    """The same predictions, first cold, then after a warm-up of the
    remaining buckets: equal executables counts and per-program
    execution counts."""
    jim, tim = _pair(max_batch=8)
    g = np.random.default_rng(1)
    for n in (3, 3, 7):
        x = g.normal(size=(n, DIN)).astype(np.float32)
        jim.do_predict(x)
        tim.do_predict(x)
    for led in ("cold", "warm"):
        jex = jres.ResourceLedger(jim).executables()
        tex = tres.ResourceLedger(tim).executables()
        assert (tex["count"], tex["programs"]) == \
            (jex["count"], jex["programs"]), led
        assert tim.aot_stats()["compiles"] == jim.aot_stats()["compiles"]
        for im in (jim, tim):
            for b in (1, 2):
                im.warm(b, (DIN,))
    assert tres.ResourceLedger(tim).executables()["count"] == 4
    assert tim.aot_memory_bytes() is None
    with pytest.raises(ValueError, match="CUDA"):
        tim.capture(lambda x: x * 2, [torch.zeros(2)])


GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)


@pytest.mark.parametrize("gen", [
    dict(max_active_slots=4, max_tokens=8, max_prompt_len=16,
         bucket_lens=[32]),
    dict(max_active_slots=4, max_tokens=8, max_prompt_len=16, paged=True,
         block_len=8),
    dict(max_active_slots=4, max_tokens=8, max_prompt_len=16, paged=True,
         block_len=8, kv_quant="int8")])
def test_generation_ledger_matches_jax(gen):
    """The ledger's decode-state bytes are the batcher's, in both packages
    and equal between them; after the same requests the scheduler's
    programs join the ledger's map with the same counts."""
    jlm = JaxLM(**GEO)
    params = jlm.build(jax.random.PRNGKey(1))
    tlm = TransformerLM(**GEO, device="cpu")
    load_jax_params(tlm, jax.tree.map(np.asarray, params))
    jim = JaxIM().do_load_model(jlm, params, {})
    tim = InferenceModel(device="cpu").do_load_model(tlm)
    jb = jgen.ContinuousBatcher(jim, jgen.GenerationParams(**gen))
    tb = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**gen))
    jl, tl = jres.ResourceLedger(jim, jb), tres.ResourceLedger(tim, tb)
    for b, mod in ((jb, jgen), (tb, tgen)):
        for i, p in enumerate(([1, 2, 3], [4, 5], list(range(1, 12)))):
            assert b.submit(mod.GenRequest(f"g{i}",
                                           np.asarray(p, np.int32)))
        for _ in range(100):
            b.step()
            if b.idle:
                break
    assert tl.kv_state_bytes() == tb.state_bytes() > 0
    assert tl.doc()["kv_state"] == tb.state_bytes_doc()
    assert tl.kv_state_bytes() == jl.kv_state_bytes()
    assert tl.doc()["kv_state"] == jl.doc()["kv_state"]
    assert tl.weights_bytes() == jl.weights_bytes()
    tp = tl.executables()["programs"]
    assert tp == jl.executables()["programs"]
    assert tb.program_stats()["programs"].items() <= tp.items()


def _engine(pkg, im, q, **params):
    mod = {"jax": jeng, "port": teng}[pkg]
    return mod.ClusterServing(im, q, mod.ServingParams(
        batch_size=4, poll_timeout_s=0.02, **params))


def test_engine_resource_blocks_and_gauges_match_jax():
    jim, tim = _pair()
    out = {}
    for pkg, im, qmod in (("jax", jim, jqueues), ("port", tim, tqueues)):
        q = qmod.InProcQueue()
        s = _engine(pkg, im, q)
        for i in range(4):
            q.xadd({"uri": f"u{i}", "data": [0.1] * DIN})
        while s.serve_once():
            pass
        h = s.health()
        prom = s.prom_metrics()
        names = [f'serving_hbm_bytes{{component="{c}"}}'
                 for c in ("weights", "kv_state", "executables")] + [
            "process_resident_memory_bytes", "process_cpu_seconds_total",
            "process_open_fds", "process_threads_total"]
        out[pkg] = (sorted(h["resources"]), sorted(h["process"]),
                    h["resources"]["weights_bytes"],
                    h["resources"]["executables"]["programs"],
                    [n in prom for n in names])
        assert h["process"]["rss_bytes"] > 0
        s.shutdown()
        # a stopped engine leaves no sampler behind
        assert s._gauge_fns == []
    assert out["port"] == out["jax"]
    assert all(out["port"][4])


def test_retune_past_the_warmed_ladder_serves_cold():
    """Warm-up covers buckets 1-4; a retune to max_batch 16 lets a batch
    of 16 form, which runs its bucket's first call cold: it serves, and
    ``aot_stats()`` counts the cold first call beside the warmed ones
    (and the hits only for warmed buckets)."""
    _, tim = _pair(max_batch=16)
    q = tqueues.InProcQueue()
    s = teng.ClusterServing(tim, q, teng.ServingParams(
        batch_size=4, max_wait_ms=50.0, poll_timeout_s=0.02,
        warmup={"shape": [DIN], "max_batch": 4, "scales": "off"}))
    s.start()
    try:
        for _ in range(500):
            if s.health()["warmup"]["state"] not in ("pending", "warming"):
                break
            time.sleep(0.01)
        st0 = tim.aot_stats()
        assert st0["compiles"] == st0["cached_programs"] == 3
        assert s.retune(max_batch=100) == {"max_batch": 16}
        assert s.knobs()["max_batch"] == 16
        # the boundary applies it once the read loop turns
        for _ in range(500):
            if s.params.max_batch == 16:
                break
            time.sleep(0.01)
        x = np.random.default_rng(2).normal(size=(16, DIN)).astype(
            np.float32)
        for i in range(16):
            q.xadd({"uri": f"r{i}", "data": x[i].tolist()})
        res = OutputQueue(q).query_many([f"r{i}" for i in range(16)],
                                        timeout_s=60.0)
    finally:
        s.shutdown(drain_s=2.0)
    assert all("value" in r for r in res.values())
    st = tim.aot_stats()
    cold = set(st["programs"]) - {f"b{b}x{DIN}/<f4" for b in (1, 2, 4)}
    assert cold, st["programs"]
    assert st["compiles"] == st["cached_programs"] == 3 + len(cold)
    assert st["hits"] == sum(n for k, n in st["programs"].items()
                             if k not in cold)
