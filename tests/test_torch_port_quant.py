"""PyTorch port: the predict path's kernels' plain versions and the
quantized predict path against the JAX package, on the CPU.

- flash forward: the port's plain version (what a CPU tensor gets, and the
  oracle the CUDA kernel is held to on the card) against the JAX Pallas
  kernel in interpret mode, as ``tests/test_flash_attention.py`` runs it;
- ``w8a8``: the plain version against ``w8a8_matmul_pallas(...,
  interpret=True)``, BITWISE;
- ``w4a16``: against ``w4a16_matmul_pallas(..., interpret=True)`` on the
  shapes the TPU kernel takes and against ``w4a16_matmul_xla`` on the
  ragged ones it routes away;
- int4 packing, group scales, calibration, ``quantize_params`` and the
  accounting helpers;
- ``InferenceModel.do_quantize`` + ``do_predict``/``dispatch`` and the
  serving engine's ``quantize`` option, int8 and int4, against the JAX
  ``InferenceModel`` and engine.

Each tolerance is stated where it is used, with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.nn.layers import attention as jatt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import pooling as jpool
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving.queues import InProcQueue as JaxQueue
from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn.layers import attention as tatt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import pooling as tpool
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving.client import InputQueue
from analytics_zoo_tpu_torch.serving.queues import InProcQueue
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

V, H, T, NB, NH = 48, 32, 16, 2, 2


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy the tolerances here assume.
    Its policy is process-global, and a test that runs a benchmark
    in-process in the same worker may leave it at bf16."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = v.detach().cpu().numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


# -- flash forward -------------------------------------------------------------

# the plain version and the Pallas kernel compute the same f32 function;
# the kernel sums its online softmax blockwise, the plain version over
# whole rows, so they differ by f32 rounding (~1e-7 at these magnitudes)
FLASH_ATOL, FLASH_RTOL = 2e-5, 1e-5


def _qkv(seed, B=2, Hh=2, Tt=64, D=16):
    g = np.random.default_rng(seed)
    return [np.asarray(g.normal(size=(B, Hh, Tt, D)), np.float32)
            for _ in range(3)]


# (T, block): T a multiple of the block, T with a ragged last block (the
# Pallas call pads to its grid and masks keys >= T), T shorter than one
# block
FLASH_SHAPES = [(64, 16), (50, 16), (40, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", FLASH_SHAPES)
def test_flash_plain_matches_pallas_interpret(causal, t, block):
    q, k, v = _qkv(0, Tt=t)
    want = np.asarray(jfa.flash_attention(q, k, v, causal, None, block,
                                          block, True))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)
    # the plain version called directly is what auto gives a CPU tensor
    direct, _ = tfa.flash_attention_torch(_t(q), _t(k), _t(v), causal)
    np.testing.assert_array_equal(direct.numpy(), got.numpy())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", FLASH_SHAPES)
def test_flash_with_lse_matches_pallas_interpret(causal, t, block):
    q, k, v = _qkv(1, Tt=t, D=32)
    scale = 0.3
    want_o, want_lse = jfa.flash_attention_with_lse(
        q, k, v, causal, scale, block, block, True)
    got_o, got_lse = tfa.flash_attention_with_lse(
        _t(q), _t(k), _t(v), causal=causal, scale=scale)
    assert got_lse.shape == (2, 2, t) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=FLASH_ATOL, rtol=FLASH_RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=FLASH_ATOL, rtol=FLASH_RTOL)


def test_flash_bf16_inputs_with_f32_out_dtype_match_jax():
    """bf16 inputs, f32 math and an f32 output (the ``out_dtype`` override):
    both sides upcast the same bf16 values, so the f32 tolerance holds."""
    q, k, v = _qkv(2, Tt=48)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    want_o, want_lse = jfa.flash_attention_with_lse(
        *jb, True, None, 16, 16, True, jnp.float32)
    got_o, got_lse = tfa.flash_attention_with_lse(
        *tb, causal=True, out_dtype=torch.float32)
    assert got_o.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=FLASH_ATOL, rtol=FLASH_RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=FLASH_ATOL, rtol=FLASH_RTOL)


# -- w8a8 ----------------------------------------------------------------------

# (M, K, N): one row, the Pallas tile edges, and a ragged shape the TPU
# kernel pads on every axis
W8_SHAPES = [(1, 128, 130), (5, 40, 24), (37, 100, 61), (33, 256, 129)]


@pytest.mark.parametrize("m,k,n", W8_SHAPES)
def test_w8a8_plain_bitwise_vs_pallas_interpret(m, k, n):
    """Bitwise: the int32 sum is exact on both sides and the output is one
    f32 multiply of it."""
    g = np.random.default_rng(m * 1000 + k)
    x = g.integers(-127, 128, (m, k)).astype(np.int8)
    w = g.integers(-127, 128, (k, n)).astype(np.int8)
    s = g.uniform(1e-4, 1e-2, n).astype(np.float32)
    want = np.asarray(jqm.w8a8_matmul_pallas(x, w, s, interpret=True))
    got = tqm.w8a8_matmul(_t(x), _t(w), _t(s)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got, want)


def test_w8a8_dense_any_rank_bitwise_vs_jax():
    g = np.random.default_rng(7)
    x = g.integers(-127, 128, (2, 3, 24)).astype(np.int8)
    w = g.integers(-127, 128, (24, 10)).astype(np.int8)
    s = g.uniform(1e-3, 1e-2, 10).astype(np.float32)
    want = np.asarray(jqm.w8a8_dense(x, w, s, impl="interpret"))
    got = tqm.w8a8_dense(_t(x), _t(w), _t(s)).numpy()
    np.testing.assert_array_equal(got, want)


# -- w4a16 ---------------------------------------------------------------------

# f32 sums of K products taken in another order (the TPU kernel sums per
# group half, the plain version in one matmul): |err| ~ K * 2^-24 * |x||w|
W4_ATOL, W4_RTOL = 1e-5, 1e-5


def _w4_case(seed, m, k, n, group):
    g = np.random.default_rng(seed)
    W = np.asarray(g.normal(size=(k, n)) * 0.1, np.float32)
    x = np.asarray(g.normal(size=(m, k)), np.float32)
    leaves = jq._quantize_w4(W, group)
    return x, np.asarray(leaves["W_q4"]), np.asarray(leaves["s_g"])


@pytest.mark.parametrize("m,k,n,group", [(3, 128, 40, 32), (8, 256, 130, 64),
                                         (1, 64, 7, 32)])
def test_w4a16_plain_vs_pallas_interpret(m, k, n, group):
    x, wq, sg = _w4_case(k + n, m, k, n, group)
    assert jqm._w4_pallas_ok(k, sg.shape[0])
    want = np.asarray(jqm.w4a16_matmul_pallas(x, wq, sg, interpret=True))
    got = tqm.w4a16_matmul(_t(x), _t(wq), _t(sg)).numpy()
    np.testing.assert_allclose(got, want, atol=W4_ATOL, rtol=W4_RTOL)


@pytest.mark.parametrize("m,k,n,group", [(5, 100, 61, 34), (3, 101, 61, 26),
                                         (2, 96, 16, 40), (4, 7, 5, 64)])
def test_w4a16_ragged_shapes_vs_xla(m, k, n, group):
    """Odd K, a ragged last group, a single group: the shapes the TPU
    kernel routes to XLA, which the port's kernel takes itself."""
    x, wq, sg = _w4_case(k * 7 + n, m, k, n, group)
    assert not jqm._w4_pallas_ok(k, sg.shape[0])
    want = np.asarray(jqm.w4a16_matmul_xla(x, wq, sg))
    got = tqm.w4a16_matmul(_t(x), _t(wq), _t(sg)).numpy()
    np.testing.assert_allclose(got, want, atol=W4_ATOL, rtol=W4_RTOL)
    # bf16 activations: both sides upcast the same bf16 values
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want_b = np.asarray(jqm.w4a16_matmul_xla(jnp.asarray(x, jnp.bfloat16),
                                             wq, sg))
    got_b = tqm.w4a16_matmul(_t(xb).to(torch.bfloat16), _t(wq),
                             _t(sg)).numpy()
    np.testing.assert_allclose(got_b, want_b, atol=W4_ATOL, rtol=W4_RTOL)


@pytest.mark.parametrize("k", [1, 2, 7, 64, 101])
def test_pack_unpack_int4_bitwise_vs_jax(k):
    g = np.random.default_rng(k)
    q = g.integers(-8, 8, (k, 5)).astype(np.int8)
    packed = tqm.pack_int4(q)
    np.testing.assert_array_equal(packed, jqm.pack_int4(q))
    assert packed.shape == ((k + 1) // 2, 5) and packed.dtype == np.uint8
    got = tqm.unpack_int4(_t(packed), k)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jqm.unpack_int4(packed, k)))
    np.testing.assert_array_equal(got.numpy(), q)


@pytest.mark.parametrize("k,groups", [(64, 2), (100, 3), (10, 4), (7, 7)])
def test_expand_group_scales_matches_jax(k, groups):
    s = np.random.default_rng(k).random((groups, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tqm.expand_group_scales(_t(s), k).numpy(),
        np.asarray(jqm.expand_group_scales(s, k)))


@pytest.mark.parametrize("bad", ["w8_rank", "w8_k", "w8_scale", "w4_rows",
                                 "w4_groups"])
def test_quant_matmul_argument_checks(bad):
    x8 = torch.zeros(2, 8, dtype=torch.int8)
    w8 = torch.zeros(8, 4, dtype=torch.int8)
    s8 = torch.ones(4)
    x4, w4, s4 = torch.zeros(2, 8), torch.zeros(4, 4, dtype=torch.uint8), \
        torch.ones(2, 4)
    with pytest.raises(ValueError):
        if bad == "w8_rank":
            tqm.w8a8_matmul(x8[0], w8, s8)
        elif bad == "w8_k":
            tqm.w8a8_matmul(x8, w8[:7], s8)
        elif bad == "w8_scale":
            tqm.w8a8_matmul(x8, w8, s8[:3])
        elif bad == "w4_rows":
            tqm.w4a16_matmul(x4, w4[:3], s4)
        else:
            tqm.w4a16_matmul(x4, w4, torch.ones(9, 4))


# -- the quantizer -------------------------------------------------------------

def _pair(seed=0):
    """The slice's model at a tiny width, in both packages, same
    weights."""
    def layers(att, pool, core):
        return [att.TransformerLayer(vocab=V, hidden_size=H, n_block=NB,
                                     n_head=NH, seq_len=T, input_shape=(T,),
                                     name="tl"),
                pool.GlobalAveragePooling1D(name="gap"),
                core.Dense(24, activation="relu", name="mid"),
                core.Dense(V, activation="softmax", name="head")]
    jm = JaxSeq(layers(jatt, jpool, jcore))
    params, state = jm.init(jax.random.PRNGKey(seed), (T,))
    params = _np(params)
    tm = Sequential(layers(tatt, tpool, tcore))
    load_jax_params(tm, params)
    return jm, params, state, tm


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, V, (n, T)).astype(
        np.float32)


def test_calibrate_matches_jax():
    """Per-layer input absmax keyed by path; the inputs come through f32
    math summed in other orders, hence rtol 1e-5 (exact keys)."""
    jm, params, state, tm = _pair()
    batches = [_ids(1, 3), _ids(2, 5)]
    want = jq.calibrate(jm, params, state, batches)
    got = tq.calibrate(tm, batches)
    assert sorted(got) == sorted(want) == ["head", "mid"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    want_p = jq.calibrate(jm, params, state, batches, percentile=90.0)
    got_p = tq.calibrate(tm, batches, percentile=90.0)
    for key in want_p:
        np.testing.assert_allclose(got_p[key], want_p[key], rtol=1e-5)
        assert got_p[key] <= got[key]


@pytest.mark.parametrize("bits,group", [(8, 64), (4, 64), (4, 10)])
def test_quantize_params_shared_absmax_gives_identical_leaves(bits, group):
    """One absmax dict through both quantizers: every leaf equal bitwise
    (the same numpy recipe on the same f32 weights)."""
    jm, params, state, tm = _pair()
    absmax = {"head": 3.25, "mid": 1.5}
    want = jq.quantize_params(jm, params, absmax, bits=bits,
                              group_size=group)
    got = tq.quantize_params(tm, export_params(tm), absmax, bits=bits,
                             group_size=group)
    wl, gl = _leaves(want), _leaves(got)
    assert sorted(gl) == sorted(wl)
    for path in wl:
        assert gl[path].dtype == wl[path].dtype, path
        np.testing.assert_array_equal(gl[path], wl[path], err_msg=path)
    assert tq.quantized_bits(got) == jq.quantized_bits(want) == bits
    assert tq.weight_bytes(got) == jq.weight_bytes(want)
    assert tq.weight_bytes(export_params(tm)) == jq.weight_bytes(params)
    # loaded back, the port's Dense layers take the quantized form
    load_jax_params(tm, got)
    assert [layer.bits for layer in tm.layers_list[2:]] == [bits, bits]
    assert tq.quantized_bits(export_params(tm)) == bits


def test_quantize_params_int8_skips_uncalibrated_and_refreshes_s_x():
    jm, params, state, tm = _pair()
    got = tq.quantize_params(tm, export_params(tm), {"head": 2.0}, bits=8)
    assert "W" in got["mid"] and "W_q" in got["head"]
    again = tq.quantize_params(tm, got, {"head": 4.0}, bits=8)
    assert float(again["head"]["s_x"]) == np.float32(4.0 / 127.0)
    np.testing.assert_array_equal(again["head"]["W_q"], got["head"]["W_q"])
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params(tm, got, {}, bits=2)
    with pytest.raises(ValueError, match="calibration"):
        tq.quantize(tm, None, bits=8)


# -- InferenceModel: quantized predict -------------------------------------------

# int4 is weight-only: both sides run f32 math on identical dequantized
# weights, so only summation order differs
PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def quantized_models():
    """JAX and port InferenceModels quantized from the same float weights
    by their own ``do_quantize`` (calibration included)."""
    calib = [_ids(60, 4), _ids(61, 3)]
    out = {}
    for bits in (8, 4):
        jm, params, state, tm = _pair()
        jim = JaxIM(2, 8).do_load_model(jm, params, state)
        tim = InferenceModel(2, 8, device="cpu").do_load_model(tm)
        jim.do_quantize(calib if bits == 8 else None, force=True, bits=bits,
                        group_size=16)
        tim.do_quantize(calib if bits == 8 else None, force=True, bits=bits,
                        group_size=16)
        out[bits] = (jim, tim)
    return out


def _int8_tolerance(tim, x):
    """Per-row bound for an int8 head: the activation codes are
    ``round(x / s_x)``, and f32 noise in ``x`` may put a code on the other
    side of a rounding edge.  One code step moves a logit by at most
    ``s_x * s_w * max|W_q|`` and a softmax probability by less than the
    largest logit move, so the bound is PROB_ATOL plus that step for every
    layer's codes that sit within 1e-3 of an edge."""
    tol = PROB_ATOL
    seen = {}
    hooks = [layer.register_forward_pre_hook(
        lambda m, a: seen.setdefault(m.name, a[0].clone()))
        for layer in tim._model.layers_list if getattr(layer, "bits", 0)]
    tim.do_predict(x)
    for h in hooks:
        h.remove()
    for layer in tim._model.layers_list:
        if getattr(layer, "bits", 0) != 8:
            continue
        u = seen[layer.name] / layer.s_x
        near = ((u - u.floor() - 0.5).abs() < 1e-3).sum(-1).max()
        tol += float(near) * float(layer.s_x) * float(
            (layer.W_q.float().abs() * layer.s_w).max())
    return tol


@pytest.mark.parametrize("bits", [8, 4])
def test_do_quantize_leaves_match_jax(quantized_models, bits):
    """int4: every leaf bitwise (weight-only, same recipe).  int8: the
    weights and their scales bitwise; ``s_x`` from each side's own
    calibration pass agrees to f32 noise (rtol 1e-5)."""
    jim, tim = quantized_models[bits]
    wl, gl = _leaves(_np(jim._params)), _leaves(tim._params)
    assert sorted(gl) == sorted(wl)
    for path in wl:
        if path.endswith("s_x"):
            np.testing.assert_allclose(gl[path], wl[path], rtol=1e-5)
        else:
            np.testing.assert_array_equal(gl[path], wl[path], err_msg=path)
    assert tq.quantized_bits(tim._params) == bits
    assert tq.weight_bytes(tim._params) == jq.weight_bytes(jim._params)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,batch_size", [(1, None), (5, None), (11, 3)])
def test_quantized_do_predict_matches_jax(quantized_models, bits, n,
                                          batch_size):
    jim, tim = quantized_models[bits]
    x = _ids(70 + n, n)
    want = jim.do_predict(x, batch_size=batch_size)
    got = tim.do_predict(x, batch_size=batch_size)
    assert got.shape == want.shape == (n, V)
    tol = _int8_tolerance(tim, x) if bits == 8 else PROB_ATOL
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(tim.dispatch(x).result(), got, atol=1e-7)


def test_do_quantize_needs_force_and_warns_without_tpu_numbers():
    _, _, _, tm = _pair()
    tim = InferenceModel(device="cpu").do_load_model(tm)
    with pytest.warns(UserWarning, match="force=True") as rec:
        tim.do_quantize(None, bits=4)
    assert "TPU" not in str(rec[0].message) and "v5e" not in \
        str(rec[0].message)
    assert tq.quantized_bits(tim._params) == 0
    assert all(layer.bits == 0 for layer in tm.layers_list[2:])


# -- the engine's quantize option -------------------------------------------------

def _engine_pair(spec_j, spec_t):
    jm, params, state, tm = _pair()
    jim = JaxIM(2, 8).do_load_model(jm, params, state)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(tm)
    jq_, tq_ = JaxQueue(), InProcQueue()
    js = jeng.ClusterServing(jim, jq_, jeng.ServingParams(
        batch_size=4, top_n=4, quantize=spec_j))
    ts = teng.ClusterServing(tim, tq_, teng.ServingParams(
        batch_size=4, top_n=4, quantize=spec_t))
    return js, ts, jq_, tq_, tim


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_quantize_matches_jax(tmp_path, bits):
    """``ServingParams.quantize`` quantizes at construction on both
    engines; the same records then give equal top-N class lists, with
    probabilities within the int8 / int4 tolerances above (at these seeds
    no activation code sits near a rounding edge, so int8 classes agree
    too)."""
    calib = tmp_path / "calib.npy"
    np.save(calib, _ids(80, 6))
    spec = {"bits": 8, "calib": str(calib)} if bits == 8 else "int4"
    js, ts, jq_, tq_, tim = _engine_pair(spec, spec)
    assert ts.health()["quantized_bits"] == \
        js.health()["quantized_bits"] == bits
    x = _ids(81, 7)
    iq = InputQueue(tq_)
    for i, row in enumerate(x):
        iq.enqueue_tensor(f"r{i}", row)
        jq_.xadd({"uri": f"r{i}", "data": row.tolist()})
    served = 0
    while served < len(x):
        n = ts.serve_once()
        assert n > 0
        served += n
    while js.serve_once():
        pass
    rids = [f"r{i}" for i in range(len(x))]
    want, got = jq_.get_results(rids), tq_.get_results(rids)
    tol = _int8_tolerance(tim, x) if bits == 8 else PROB_ATOL
    for rid in rids:
        w, g = want[rid]["value"], got[rid]["value"]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   atol=tol)
        assert [c for c, _ in g] == [c for c, _ in w]
    js.shutdown()
    ts.shutdown()


def test_engine_int8_without_calibration_fails_construction():
    _, _, _, tm = _pair()
    tim = InferenceModel(device="cpu").do_load_model(tm)
    with pytest.raises(ValueError, match="calib"):
        teng.ClusterServing(tim, InProcQueue(),
                            teng.ServingParams(quantize="int8"))
    assert tq.quantized_bits(tim._params) == 0
