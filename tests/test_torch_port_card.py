"""PyTorch port: every CUDA kernel against its plain version, on the card.

Each test carries the ``gpu`` marker and decides inside its fixture whether
a card is present, so it skips on a machine without one.  The module
imports no JAX, so it runs where only PyTorch is installed, without the
repository's ``conftest.py`` (which configures JAX)::

    python -m pytest -m gpu --noconftest -p no:cacheprovider \\
        tests/test_torch_port_card.py -q

The kernels are built from ``analytics_zoo_tpu_torch/csrc/`` at their first
launch.  Tolerances: the same f32 math in another summation order (atol
2e-5, rtol 1e-5) for the paged and flash kernels (forward, LSE and the
backward's dq, dk, dv); one bf16 rounding step for bf16 outputs; bitwise
for ``w8a8``, ``w8a8_conv2d`` (also at every forced tile config and split
of K, and its K-major weight pack against the CPU's) and for two launches
of the flash backward;
f32 sums of up to 768 products in another order for ``w4a16`` (atol 1e-4,
also at ResNet-50's 2048-deep pointwise shapes); for ``fused_bn``,
y as f32 sums of up to 300 products of unit-scale values in another order
(atol 2e-5, rtol 1e-5; bf16 y one rounding step, rtol 8e-3) and the sums
over the rows to rtol 1e-5 (Σ with atol 1e-5·Σ|y|), two launches bitwise
equal.  CUDA graphs (``inference/aot.capture``): decode quanta replayed
give the eager route's tokens (the same kernels in the same order), for
``TransformerLM``'s lanes and for a ``Seq2seq`` bare-state lane;
their kernel launches are counted on the card (``ops/_impl.
card_launches``, a profiler trace), and the wrappers' counters, which
count eager launches, count none for a capture or a replay.  The
time-series zoo: the forecasting heads' shapes, a quantized
``LSTMForecaster``'s one launch a forward, MTNet's none, thread-pooled
trials equal to the loop and the population trainer under ``vmap``.  The
front door: a warmed engine's HTTP gateway serving paged generation (the
eager batcher's tokens, graph replays only, the tenant's tokens charged),
a ``/debug/profile`` trace holding the paged kernel with
``card_launches`` counting as before after it, and the resource ledger
against the allocator.
"""

import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.inference import aot
from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers.attention import TransformerLayer
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.nn.layers.pooling import GlobalAveragePooling1D
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import fused_bn as tfb
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.serving import generate as tgen


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python -m "
                    "pytest -m gpu --noconftest "
                    "tests/test_torch_port_card.py)")
    return torch.device("cuda", 0)


def _paged_case(seed, lengths, rows=4, n_table=4, bl=8, nh=2, hd=8):
    """Random pool (garbage in the trash block and every unreferenced
    block), tables with tail entries on block 0, rows 2 and 3 sharing
    their first block."""
    g = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_blocks = 1 + rows * n_table
    perm = g.permutation(np.arange(1, n_blocks)).reshape(rows, n_table)
    tables = np.zeros((rows, n_table), np.int32)
    for a in range(rows):
        used = -(-int(lengths[a]) // bl)
        tables[a, :used] = perm[a, :used]
    tables[3, 0] = tables[2, 0]
    q = g.normal(size=(rows, nh, hd))
    kp = g.normal(size=(n_blocks, bl, nh, hd))
    vp = g.normal(size=(n_blocks, bl, nh, hd))
    return [torch.from_numpy(np.asarray(a, np.float32))
            for a in (q, kp, vp)] \
        + [torch.from_numpy(tables), torch.from_numpy(lengths)]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths", [(32, 32, 32, 32), (32, 17, 9, 1),
                                     (8, 16, 24, 3)])
def test_paged_kernel_matches_plain_on_card(cuda_device, quant, lengths):
    args = [a.to(cuda_device) for a in _paged_case(5, lengths)]
    kw = {}
    if quant:
        qk, ks = tq.kv_pack_int8(args[1])
        qv, vs = tq.kv_pack_int8(args[2])
        args[1], args[2] = qk, qv
        kw = {"k_scale": ks, "v_scale": vs}
    n0 = tpa.launches
    got = tpa.paged_attention(*args, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    ref = tpa.paged_attention(*args, impl="torch", **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("parts", [None, 3, 8])
@pytest.mark.parametrize("hd", tpa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernel_partitions_match_plain_on_card(cuda_device, quant, hd,
                                                     parts):
    """A 36-entry table: the rule's 3 partitions of 96 positions, or 3 / 8
    forced, at lengths 0 (uniform over the table), 1, 96 +- 1 and past the
    table, for every head_dim."""
    args = [a.to(cuda_device) for a in _paged_case(
        hd, (0, 1, 95, 96, 97, 300), rows=6, n_table=36, nh=3, hd=hd)]
    ks = vs = None
    if quant:
        args[1], ks = tq.kv_pack_int8(args[1])
        args[2], vs = tq.kv_pack_int8(args[2])
    n0 = tpa.launches
    got = tpa._paged_cuda(*args, ks, vs, parts=parts)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    ref = tpa.paged_attention(*args, ks, vs, impl="torch")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-5)


def _flash_case(device, dtype, B, T, H, D):
    """q, k, v as (B, H, T, D) views of one (B, T, 3·H·D) projection."""
    g = np.random.default_rng(T + D)
    qkv = torch.from_numpy(np.asarray(g.normal(size=(B, T, 3 * H * D)),
                                      np.float32)).to(device, dtype)
    return [t.unflatten(-1, (H, D)).transpose(1, 2)
            for t in qkv.split(H * D, dim=-1)]


FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (4e-3, 8e-3)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,D", [(77, 64), (130, 32), (64, 128)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, causal, T,
                                            D):
    q, k, v = _flash_case(cuda_device, dtype, 2, T, 3, D)
    n0 = tfa.launches
    got, glse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                             impl="cuda")
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    ref, rlse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                             impl="torch")
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(glse, rlse, rtol=1e-5, atol=2e-5)


def _flash_grads(q, k, v, causal, impl, seed=0, lse_loss=True,
                 out_dtype=None):
    """dq, dk, dv through autograd: a loss on the output and, with
    ``lse_loss``, on the LSE (so both cotangents reach the backward).
    ``out_dtype`` float32 for bf16 inputs hands the backward an f32 dO."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            out_dtype=out_dtype, impl=impl)
    g = torch.Generator(device=q.device).manual_seed(seed)
    w = torch.randn(out.shape, generator=g, device=q.device)
    wl = torch.randn(lse.shape, generator=g, device=q.device)
    loss = (out.float() * w).sum()
    if lse_loss:
        loss = loss + (lse * wl).sum()
    loss.backward()
    return q.grad, k.grad, v.grad


# the backward kernels' tiles are 64 rows of their own and 32 streamed rows:
# T from one position through ragged tiles (15, 77, 130, 1000) to whole ones
# (1024), at every head_dim, with both cotangents; then one case without the
# LSE cotangent and one with bf16 inputs and an f32 dO
_BWD_CASES = [(dt, causal, T, D, True, None)
              for dt in (torch.float32, torch.bfloat16)
              for causal in (False, True)
              for T in (1, 15, 77, 130, 1000, 1024)
              for D in (32, 64, 128)] + [
    (torch.float32, True, 1000, 64, False, None),
    (torch.bfloat16, True, 130, 64, True, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,T,D,lse_loss,out_dtype", _BWD_CASES)
def test_flash_backward_kernels_match_plain_on_card(cuda_device, dtype,
                                                    causal, T, D, lse_loss,
                                                    out_dtype):
    q, k, v = _flash_case(cuda_device, dtype, 2, T, 3, D)
    n0 = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    got = _flash_grads(q, k, v, causal, "cuda", lse_loss=lse_loss,
                       out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        n + 1 for n in n0)
    ref = _flash_grads(q, k, v, causal, "torch", lse_loss=lse_loss,
                       out_dtype=out_dtype)
    atol, rtol = FLASH_TOL[dtype]
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T", [(2, 4, 200), (8, 12, 1024)])
def test_flash_backward_is_deterministic_on_card(cuda_device, B, H, T):
    """No atomics: every gradient element is written by one block (also at
    the training path's shape)."""
    q, k, v = _flash_case(cuda_device, torch.float32, B, T, H, 64)
    a = _flash_grads(q, k, v, True, "cuda")
    b = _flash_grads(q, k, v, True, "cuda")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_attention_bthd_takes_the_kernel_on_card(cuda_device):
    q, k, v = (t.transpose(1, 2)
               for t in _flash_case(cuda_device, torch.float32, 2, 40, 2, 64))
    n0 = tfa.launches
    got = tatt.attention_bthd(q, k, v, causal=True)
    assert tfa.launches == n0 + 1
    ref = tatt._attention_torch_bthd(q, k, v, causal=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 768, 1000), (8, 100, 61),
                                   (33, 64, 129), (1, 768, 50257),
                                   (8, 768, 50257), (9, 777, 61),
                                   (64, 20, 15), (20, 777, 1),
                                   (33, 100, 1000), (65, 777, 61)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("extremes", [False, True])
def test_w8a8_kernel_bitwise_on_card(cuda_device, m, k, n, offset,
                                     extremes):
    """One, two, three, five and eight m-tiles a block, and two blocks of
    rows; K below one k-step, ragged, odd and past one x segment; N = 1,
    15, odd and the head's; ``offset``: the weight that many bytes into its
    buffer; ``extremes``: values -128 and 127 only."""
    g = np.random.default_rng(m + k + n)
    if extremes:
        ends = np.array([-128, 127], np.int8)
        x, w = g.choice(ends, (m, k)), g.choice(ends, (k, n))
    else:
        x = g.integers(-128, 128, (m, k)).astype(np.int8)
        w = g.integers(-128, 128, (k, n)).astype(np.int8)
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, n).astype(np.float32))
    x, s = torch.from_numpy(x).to(cuda_device), s.to(cuda_device)
    w = torch.from_numpy(w).to(cuda_device)
    if offset:
        buf = torch.zeros(k * n + offset, dtype=torch.int8,
                          device=cuda_device)
        buf[offset:] = w.flatten()
        w = buf[offset:].view(k, n)
    n0 = tqm.launches_w8a8
    got = tqm.w8a8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert tqm.launches_w8a8 == n0 + 1
    assert torch.equal(got, tqm.w8a8_matmul(x, w, s, impl="torch"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,group", [(8, 768, 1000, 64),
                                         (5, 100, 61, 34), (33, 101, 7, 26),
                                         (1, 768, 1000, 64),
                                         (17, 768, 300, 64), (8, 64, 40, 5),
                                         (8, 96, 70, 96), (8, 2000, 130, 64),
                                         (33, 2000, 130, 64)])
@pytest.mark.parametrize("offset", [0, 3])
def test_w4a16_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n,
                                            group, offset):
    """Groups straddling a chunk and the two halves (100, 34), odd K, small
    and whole-K groups, several x segments; ``offset``: the packed weight
    that many bytes into its buffer."""
    g = np.random.default_rng(m + k + n)
    leaves = tq._quantize_w4(
        np.asarray(g.normal(size=(k, n)) * 0.05, np.float32), group)
    x = torch.from_numpy(np.asarray(g.normal(size=(m, k)), np.float32))
    x = x.to(cuda_device, dtype)
    packed = torch.from_numpy(leaves["W_q4"]).to(cuda_device)
    buf = torch.zeros(packed.numel() + offset, dtype=torch.uint8,
                      device=cuda_device)
    buf[offset:] = packed.flatten()
    wq = buf[offset:].view(packed.shape)
    sg = torch.from_numpy(leaves["s_g"]).to(cuda_device)
    n0 = tqm.launches_w4a16
    got = tqm.w4a16_matmul(x, wq, sg)
    torch.cuda.synchronize()
    assert tqm.launches_w4a16 == n0 + 1
    torch.testing.assert_close(got, tqm.w4a16_matmul(x, wq, sg,
                                                     impl="torch"),
                               rtol=1e-5, atol=1e-4)


# w8a8_conv2d: (x shape, (kh, kw, cin/g, cout), strides, pads, dilation,
# groups): ResNet-50's 11 spatial path shapes at 224 x 224 with the batch
# cut to 2, then ragged cases (cout off the tile and off 4 bytes, cin = 3
# and 24, odd sizes, dilation 2, groups 2 at 32 and 8 channels a group,
# explicit pads)
CONV_PATH = (
    ((2, 224, 224, 3), (7, 7, 3, 64), (2, 2), ((2, 3), (2, 3))),
    ((2, 56, 56, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),
    ((2, 56, 56, 128), (3, 3, 128, 128), (2, 2), ((0, 1), (0, 1))),
    ((2, 56, 56, 256), (1, 1, 256, 512), (2, 2), ((0, 0), (0, 0))),
    ((2, 28, 28, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1))),
    ((2, 28, 28, 256), (3, 3, 256, 256), (2, 2), ((0, 1), (0, 1))),
    ((2, 28, 28, 512), (1, 1, 512, 1024), (2, 2), ((0, 0), (0, 0))),
    ((2, 14, 14, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1))),
    ((2, 14, 14, 512), (3, 3, 512, 512), (2, 2), ((0, 1), (0, 1))),
    ((2, 14, 14, 1024), (1, 1, 1024, 2048), (2, 2), ((0, 0), (0, 0))),
    ((2, 7, 7, 512), (3, 3, 512, 512), (1, 1), ((1, 1), (1, 1))),
)
CONV_RAGGED = (
    ((1, 37, 45, 3), (7, 7, 3, 70), (2, 2), ((3, 3), (3, 3)), (1, 1), 1),
    ((2, 13, 11, 16), (3, 3, 16, 61), (1, 1), ((1, 1), (1, 1)), (1, 1), 1),
    ((2, 17, 19, 32), (3, 3, 32, 64), (1, 1), ((2, 2), (2, 2)), (2, 2), 1),
    ((2, 14, 14, 64), (3, 3, 32, 128), (2, 2), ((0, 1), (0, 1)), (1, 1), 2),
    ((2, 9, 9, 16), (3, 3, 8, 24), (1, 1), ((1, 1), (1, 1)), (1, 1), 2),
    ((3, 10, 12, 24), (5, 3, 24, 40), (2, 1), ((1, 2), (1, 1)), (1, 1), 1),
)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [c + ((1, 1), 1) for c in CONV_PATH]
                         + list(CONV_RAGGED))
@pytest.mark.parametrize("extremes", [False, True])
def test_w8a8_conv2d_kernel_bitwise_on_card(cuda_device, geom, extremes):
    """The s8 implicit-GEMM conv against its plain version (a float64
    convolution of the codes), bitwise; ``extremes``: codes -128 and 127
    only (the largest sums)."""
    xshape, kshape, strides, pads, dil, groups = geom
    g = np.random.default_rng(sum(xshape) + sum(kshape))
    if extremes:
        ends = np.array([-128, 127], np.int8)
        x, w = g.choice(ends, xshape), g.choice(ends, kshape)
    else:
        x = g.integers(-128, 128, xshape).astype(np.int8)
        w = g.integers(-128, 128, kshape).astype(np.int8)
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, kshape[-1]).astype(
        np.float32)).to(cuda_device)
    x = torch.from_numpy(x).to(cuda_device)
    w = torch.from_numpy(w).to(cuda_device)
    kw = dict(strides=strides, pads=pads, dilation=dil, groups=groups)
    n0 = tqm.launches_conv
    got = tqm.w8a8_conv2d(x, w, s, **kw)
    torch.cuda.synchronize()
    assert tqm.launches_conv == n0 + 1
    assert torch.equal(got, tqm.w8a8_conv2d(x, w, s, impl="torch", **kw))


@pytest.mark.gpu
def test_w8a8_conv2d_byte_gather_route_on_card(cuda_device):
    """x one byte into its buffer (off 16 bytes: the loader gathers bytes
    instead of copying 16-byte pieces) and a planted off-by-one pad, which
    the bitwise check must reject."""
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.integers(-128, 128, (2, 14, 14, 64))
                         .astype(np.int8)).to(cuda_device)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=cuda_device)
    buf[1:] = x.flatten()
    xo = buf[1:].view(x.shape)
    w = torch.from_numpy(g.integers(-128, 128, (3, 3, 64, 64))
                         .astype(np.int8)).to(cuda_device)
    s = torch.full((64,), 1e-3, device=cuda_device)
    pads = ((0, 1), (0, 1))
    ref = tqm.w8a8_conv2d(x, w, s, strides=(2, 2), pads=pads, impl="torch")
    assert torch.equal(tqm.w8a8_conv2d(xo, w, s, strides=(2, 2), pads=pads),
                       ref)
    shifted = tqm.w8a8_conv2d(x, w, s, strides=(2, 2),
                              pads=((1, 0), (1, 0)))
    assert shifted.shape == ref.shape and not torch.equal(shifted, ref)


def _conv_case(device, xshape, kshape, seed, x_offset=0):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.integers(-128, 128, xshape).astype(np.int8))
    w = torch.from_numpy(g.integers(-128, 128, kshape).astype(np.int8))
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, kshape[-1]).astype(
        np.float32))
    x = x.to(device)
    if x_offset:
        buf = torch.zeros(x.numel() + x_offset, dtype=torch.int8,
                          device=device)
        buf[x_offset:] = x.flatten()
        x = buf[x_offset:].view(xshape)
    return x, w.to(device), s.to(device)


# forced configs: the stem (its input rows staged, A built by runs), a
# stage-4 3x3, cout 61 (scalar stores), groups 2, x one byte into its
# buffer (byte-gathered A), a stem-like conv on an x three bytes in (runs
# from rows staged off 16 bytes) and rows of 32000 bytes (a tile's rows
# past the cap: byte gathers)
CONV_FORCED = (
    CONV_PATH[0] + ((1, 1), 1, 0),
    CONV_PATH[10] + ((1, 1), 1, 0),
    CONV_RAGGED[1] + (0,),
    CONV_RAGGED[3] + (0,),
    ((2, 14, 14, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), (1, 1), 1,
     1),
    ((2, 23, 21, 3), (7, 7, 3, 64), (2, 2), ((2, 3), (2, 3)), (1, 1), 1, 3),
    ((1, 9, 4000, 8), (3, 3, 8, 8), (1, 1), ((1, 1), (1, 1)), (1, 1), 1, 0),
)


@pytest.mark.gpu
@pytest.mark.parametrize("split", tqm.CONV_SPLITS)
@pytest.mark.parametrize("bn", tqm.CONV_BNS)
@pytest.mark.parametrize("geom", CONV_FORCED)
def test_w8a8_conv2d_forced_configs_bitwise_on_card(cuda_device, geom, bn,
                                                    split):
    """Every tile config and split of K over a cluster, forced through the
    launch's override (a slice may be empty), bitwise the plain version."""
    xshape, kshape, strides, pads, dil, groups, off = geom
    x, w, s = _conv_case(cuda_device, xshape, kshape, sum(kshape), off)
    pack = tqm.pack_conv_weight(w, groups)
    got = tqm._w8a8_conv_cuda(x, w, s, strides, pads, dil, groups, pack,
                              bn, split)
    torch.cuda.synchronize()
    assert torch.equal(got, tqm.w8a8_conv2d(x, w, s, strides=strides,
                                            pads=pads, dilation=dil,
                                            groups=groups, impl="torch"))


@pytest.mark.gpu
@pytest.mark.parametrize("kshape,groups", [((7, 7, 3, 64), 1),
                                           ((3, 3, 512, 512), 1),
                                           ((3, 3, 16, 61), 1),
                                           ((3, 3, 8, 24), 2),
                                           ((1, 1, 1024, 2048), 1)])
def test_w8a8_conv2d_pack_on_card_equals_cpu_pack(cuda_device, kshape,
                                                  groups):
    """The K-major pack made on the card equals the one made on the CPU,
    and a launch given it equals one that packs on the call."""
    g = np.random.default_rng(sum(kshape))
    w = torch.from_numpy(g.integers(-128, 128, kshape).astype(np.int8))
    on_card = tqm.pack_conv_weight(w.to(cuda_device), groups)
    assert on_card.is_cuda and on_card.data_ptr() % 16 == 0
    assert torch.equal(on_card.cpu(), tqm.pack_conv_weight(w, groups))
    xshape = (2, 9, 9, kshape[2] * groups)
    x, _, s = _conv_case(cuda_device, xshape, kshape, 3)
    kw = dict(strides=(2, 2), pads=((1, 1), (1, 1)), groups=groups)
    w = w.to(cuda_device)
    assert torch.equal(tqm.w8a8_conv2d(x, w, s, w_pack=on_card, **kw),
                       tqm.w8a8_conv2d(x, w, s, **kw))


@pytest.mark.gpu
def test_quantized_conv_layer_keeps_its_pack_on_card(cuda_device):
    """A quantized 3x3 conv packs W_q at its first forward and reuses the
    pack; rewriting W_q rebuilds it; the pack is no parameter or buffer."""
    from analytics_zoo_tpu_torch.nn.layers.conv import Convolution2D
    g = np.random.default_rng(4)
    x = torch.from_numpy(g.normal(size=(2, 10, 10, 24)).astype(np.float32))
    x = x.to(cuda_device)
    conv = Convolution2D(40, 3, border_mode="same", input_shape=(10, 10, 24))
    model = Sequential([conv]).init_weights(2).to(cuda_device)
    tq.quantize(model, x.cpu().numpy(), bits=8)
    first = model(x)
    pack = conv._pack[2]
    assert torch.equal(pack, tqm.pack_conv_weight(conv.W_q, 1))
    assert torch.equal(model(x), first) and conv._pack[2] is pack
    names = {n for n, _ in model.named_parameters()} | \
        {n for n, _ in model.named_buffers()}
    assert not any("pack" in n for n in names)
    with torch.no_grad():
        conv.W_q.neg_()
    again = model(x)
    assert conv._pack[2] is not pack
    conv.impl = "torch"
    assert torch.equal(again, model(x))


# ResNet-50's pointwise (M, K, N) at a batch of 16: the 33 1x1 stride-1
# convolutions' distinct shapes and the head's
POINTWISE = ((50176, 64, 64), (50176, 64, 256), (50176, 256, 64),
             (50176, 256, 128), (12544, 128, 512), (12544, 512, 128),
             (12544, 512, 256), (3136, 256, 1024), (3136, 1024, 256),
             (3136, 1024, 512), (784, 512, 2048), (784, 2048, 512),
             (16, 2048, 1000))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", POINTWISE)
def test_matmul_kernels_at_resnet_pointwise_shapes_on_card(cuda_device, m,
                                                           k, n):
    """The w8a8 (bitwise) and w4a16 (f32 x, atol 1e-4, rtol 1e-5)
    kernels, designed around M <= 64, at the large M and small N of a
    quantized ResNet-50's pointwise convolutions."""
    g = np.random.default_rng(m + k + n)
    x = torch.from_numpy(g.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(g.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, n).astype(np.float32))
    x, w, s = (t.to(cuda_device) for t in (x, w, s))
    assert torch.equal(tqm.w8a8_matmul(x, w, s),
                       tqm.w8a8_matmul(x, w, s, impl="torch"))
    leaves = tq._quantize_w4(
        np.asarray(g.normal(size=(k, n)) * 0.05, np.float32), 64)
    xf = torch.from_numpy(np.asarray(g.normal(size=(m, k)), np.float32))
    xf = xf.to(cuda_device)
    wq = torch.from_numpy(leaves["W_q4"]).to(cuda_device)
    sg = torch.from_numpy(leaves["s_g"]).to(cuda_device)
    torch.testing.assert_close(tqm.w4a16_matmul(xf, wq, sg),
                               tqm.w4a16_matmul(xf, wq, sg, impl="torch"),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_quantized_convs_take_the_kernels_on_card(cuda_device):
    """An int8 3x3 conv runs w8a8_conv2d and an int8 1x1 conv the w8a8
    matmul, each once a forward, bitwise equal to their plain route."""
    from analytics_zoo_tpu_torch.nn.layers.conv import Convolution2D
    g = np.random.default_rng(9)
    x = torch.from_numpy(g.normal(size=(2, 12, 12, 32)).astype(np.float32))
    x = x.to(cuda_device)
    for k, kernel in ((3, "conv"), (1, "w8a8")):
        conv = Convolution2D(16, k, border_mode="same",
                             input_shape=(12, 12, 32))
        model = Sequential([conv]).init_weights(1).to(cuda_device)
        tq.quantize(model, x.cpu().numpy(), bits=8)
        assert conv.bits == 8
        before = (tqm.launches_conv, tqm.launches_w8a8)
        got = model(x)
        torch.cuda.synchronize()
        after = (tqm.launches_conv, tqm.launches_w8a8)
        assert [a - b for a, b in zip(after, before)] == \
            ([1, 0] if kernel == "conv" else [0, 1])
        conv.impl = "torch"
        assert torch.equal(got, model(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(300, 33, 10), (128, 64, 64),
                                   (1000, 256, 70), (7, 1, 3)])
def test_fused_bn_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    """Ragged shapes: M not a multiple of the 128-row tile, K odd or 1, N
    not a multiple of the 64-column tile; x read through a row stride."""
    g = np.random.default_rng(m + k + n)
    wide = torch.from_numpy(np.asarray(g.normal(size=(m, k + 3)),
                                       np.float32)).to(cuda_device, dtype)
    x = wide[:, 1:k + 1]
    w = torch.from_numpy(np.asarray(g.normal(size=(k, n)) / np.sqrt(k),
                                    np.float32)).to(cuda_device, dtype)
    n0 = tfb.launches
    y, stats = tfb.fused_bn(x, w)
    torch.cuda.synchronize()
    assert tfb.launches == n0 + 1
    y_ref, s_ref = tfb.fused_bn(x, w, impl="torch")
    rtol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol,
                               atol=2e-5 if dtype == torch.float32 else 1e-5)
    torch.testing.assert_close(stats[1], s_ref[1], rtol=1e-5, atol=1e-6)
    abs_sum = float(y_ref.float().abs().sum(0).max())
    torch.testing.assert_close(stats[0], s_ref[0], rtol=1e-5,
                               atol=1e-5 * abs_sum)


@pytest.mark.gpu
def test_fused_bn_kernel_is_deterministic_on_card(cuda_device):
    """No atomics: per-tile partials summed in a fixed order, so two
    launches give bitwise-equal y and sums."""
    g = np.random.default_rng(9)
    x = torch.from_numpy(np.asarray(g.normal(size=(5000, 256)),
                                    np.float32)).to(cuda_device)
    w = torch.from_numpy(np.asarray(g.normal(size=(256, 64)) / 16,
                                    np.float32)).to(cuda_device)
    a = tfb.fused_bn(x, w)
    b = tfb.fused_bn(x, w)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(300, 2048, 130), (129, 600, 64)])
def test_fused_bn_kernel_deep_k_on_card(cuda_device, dtype, m, k, n):
    """K deep enough to wrap the cp.async ring many times (f32 k-tiles of
    32, bf16 of 64), N past one column tile: y and the sums against the
    plain version at the tolerances above."""
    g = np.random.default_rng(m + k)
    x = torch.from_numpy(np.asarray(g.normal(size=(m, k)),
                                    np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy(np.asarray(g.normal(size=(k, n)) / np.sqrt(k),
                                    np.float32)).to(cuda_device, dtype)
    y, stats = tfb.fused_bn(x, w)
    torch.cuda.synchronize()
    y_ref, s_ref = tfb.fused_bn(x, w, impl="torch")
    rtol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol,
                               atol=2e-5 if dtype == torch.float32 else 1e-5)
    torch.testing.assert_close(stats[1], s_ref[1], rtol=1e-5, atol=1e-6)
    abs_sum = float(y_ref.float().abs().sum(0).max())
    torch.testing.assert_close(stats[0], s_ref[0], rtol=1e-5,
                               atol=1e-5 * abs_sum)


# -- CUDA graphs: decode quanta, predict buckets, the paged kernel ------------

@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_paged_cluster_launch_replays_in_a_graph_on_card(cuda_device, quant):
    """The paged kernel split over a thread-block cluster (three forced
    partitions, launched through ``cudaLaunchKernelEx``) captured once and
    replayed over fresh inputs copied into the graph's static tensors."""
    def case(seed):
        args = [a.to(cuda_device) for a in _paged_case(
            seed, (0, 1, 95, 96, 97, 300), rows=6, n_table=36, nh=3,
            hd=64)]
        if quant:
            args[1], ks = tq.kv_pack_int8(args[1])
            args[2], vs = tq.kv_pack_int8(args[2])
            return args + [ks, vs]
        return args + [None, None]

    args = case(11)
    static = [a for a in args if a is not None]

    def run(*ts):
        it = iter(ts)
        full = [next(it) if a is not None else None for a in args]
        return tpa._paged_cuda(*full, parts=3)
    run(*static)
    torch.cuda.synchronize()
    n0 = tpa.launches
    prog = aot.capture(run, static, cuda_device)
    with _impl.card_launches(("paged",)) as card:
        for seed in (12, 13):
            fresh = [a for a in case(seed) if a is not None]
            for dst, src in zip(prog.inputs, fresh):
                dst.copy_(src)
            got = prog.replay()
            torch.cuda.synchronize()
            ref = tpa.paged_attention(
                *(fresh if quant else fresh + [None] * 2), impl="torch")
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-5)
    assert card["paged"] == 2 and prog.replays == 2
    assert tpa.launches == n0          # no wrapper ran for either


def _gen_model(device):
    lm = TransformerLM(vocab_size=97, hidden=64, n_head=4, n_layers=12,
                       max_len=128, seed=3, device=device)
    return InferenceModel(device=device).do_load_model(lm)


GEN_CARD = dict(paged=True, block_len=8, max_active_slots=4, max_tokens=10,
                max_prompt_len=24, decode_quantum=3, stream_interval=0)


def _gen_reqs(seed, n=10, tag=""):
    g = np.random.default_rng(seed)
    return [(f"{tag}r{i}", g.integers(0, 97, int(g.integers(2, 25)))
             .astype(np.int32), int(g.integers(3, 11))) for i in range(n)]


def _serve(batcher, reqs, on_step=None):
    for rid, prompt, budget in reqs:
        assert batcher.submit(tgen.GenRequest(rid, prompt,
                                              max_tokens=budget))
    done = {}
    for _ in range(1000):
        for ev in batcher.step():
            assert ev.kind not in ("shed", "quarantine"), (ev.kind,
                                                           ev.error)
            if ev.kind == "finish":
                done[ev.rid] = list(ev.tokens)
        if on_step is not None:
            on_step(batcher)
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"stalled: {len(done)}/{len(reqs)} finished")


@pytest.mark.gpu
@pytest.mark.parametrize("gen", [
    GEN_CARD, dict(GEN_CARD, kv_quant="int8"),
    dict(GEN_CARD, paged=False, bucket_lens=[32, 64])],
    ids=["paged-f32", "paged-int8", "monolithic"])
def test_decode_graphs_serve_the_eager_tokens_on_card(cuda_device, gen):
    """After ``warm()`` every decode quantum replays its lane's graph: the
    tokens equal an eager batcher's, two waves of churn capture nothing
    and run no quantum eagerly, and the card runs the paged kernel decode
    steps x 12 layers times, none of them through a wrapper.  On the eager
    batcher the card's count equals the wrapper's."""
    im = _gen_model(cuda_device)
    layers = 12 if gen["paged"] else 0
    reqs = _gen_reqs(1)
    eager = tgen.ContinuousBatcher(im, tgen.GenerationParams(**gen))
    n0 = tpa.launches
    with _impl.card_launches(("paged",)) as card:
        want = _serve(eager, reqs)
    assert card["paged"] == tpa.launches - n0 \
        == eager.decode_steps * layers
    want2 = _serve(eager, _gen_reqs(2, tag="b"))
    assert eager.stats()["replays"] == 0 and eager.stats()["captures"] == 0
    b = tgen.ContinuousBatcher(im, tgen.GenerationParams(**gen))
    n_decode = sum(e.kind in ("paged_decode", "decode_step")
                   for e in b.warmup_manifest())
    doc = b.warm()
    assert doc["failed"] == 0, doc
    assert doc["compile_stats"]["captures"] == n_decode == b.captures
    n0, steps0 = tpa.launches, b.decode_steps
    with _impl.card_launches(("paged",)) as card:
        assert _serve(b, reqs) == want
        assert _serve(b, _gen_reqs(2, tag="b")) == want2
    st = b.stats()
    assert st["captures"] == n_decode and st["eager_quanta"] == 0
    assert st["replays"] * gen["decode_quantum"] == st["decode_steps"] > 0
    assert card["paged"] == (st["decode_steps"] - steps0) * layers
    assert tpa.launches == n0


@pytest.mark.gpu
def test_warm_beside_an_active_int8_slot_on_card(cuda_device):
    """``warm()`` on another thread while the lane serves int8 slots: the
    decode graph is captured between two boundaries, without a dry run
    over the active rows, and every token equals an unwarmed batcher's."""
    im = _gen_model(cuda_device)
    gen = dict(GEN_CARD, kv_quant="int8")
    reqs = _gen_reqs(3, n=12)
    want = _serve(tgen.ContinuousBatcher(im, tgen.GenerationParams(**gen)),
                  reqs)
    b = tgen.ContinuousBatcher(im, tgen.GenerationParams(**gen))
    docs = []
    warmer = threading.Thread(target=lambda: docs.append(b.warm()))

    def start_warm(batcher):
        if batcher.active and batcher.decode_steps and not docs \
                and not warmer.is_alive() and warmer.ident is None:
            warmer.start()
    assert _serve(b, reqs, on_step=start_warm) == want
    warmer.join(timeout=120)
    assert not warmer.is_alive() and docs and docs[0]["failed"] == 0
    assert b.captures == 1


def _predict_model(device, T=64):
    model = Sequential([
        TransformerLayer(vocab=97, hidden_size=64, n_block=2, n_head=2,
                         seq_len=T, input_shape=(T,)),
        GlobalAveragePooling1D(),
        Dense(97, activation="softmax")]).init_weights(0)
    return InferenceModel(4, 4, device=device).do_load_model(model)


@pytest.mark.gpu
def test_predict_warm_then_dispatch_on_card(cuda_device):
    """``warm()`` runs a bucket once; three dispatches of different
    inputs to it, left in flight together, each equal their
    ``do_predict`` outputs, find their bucket warm, and launch the flash
    kernel twice each (2 blocks) on the card, every launch counted by the
    wrapper."""
    T = 64
    im = _predict_model(cuda_device, T)
    g = np.random.default_rng(5)
    xs = [g.integers(0, 97, (4, T)).astype(np.float32) for _ in range(3)]
    want = [im.do_predict(x) for x in xs]
    assert im.warm(4, (T,)) and not im.warm(4, (T,))
    torch.cuda.synchronize()
    st0, f0 = im.aot_stats(), tfa.launches
    with _impl.card_launches(("flash_fwd",)) as card:
        handles = [im.dispatch(x) for x in xs]
        got = [h.result() for h in handles]
    st = im.aot_stats()
    assert st["hits"] - st0["hits"] == 3 and st["compiles"] == 1
    assert card["flash_fwd"] == tfa.launches - f0 == 3 * 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-5)


# the recommendation zoo's Dense shapes (K, N): NeuralCF at MovieLens-1M
# width (128x128, 128x64, 64x32, 96x2) and WideAndDeep at the Census
# columns (173x2 unbiased wide, 34x64, 32x16, 16x2), at one row, the
# predict bucket and a batch past it
RECO_KN = ((128, 128), (128, 64), (64, 32), (96, 2), (173, 2), (34, 64),
           (32, 16), (16, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8192, 9000])
@pytest.mark.parametrize("k,n", RECO_KN)
def test_recommendation_shapes_w8a8_and_w4a16_on_card(cuda_device, m, k, n):
    """Each weight its own allocation of exactly its bytes: ``w8a8``
    bitwise; ``w4a16`` (group 64, ragged groups at K = 96 and 173) within
    its tolerance; both on f32 x."""
    _check_matmul_kernels(cuda_device, m, k, n)


def _check_matmul_kernels(cuda_device, m, k, n):
    g = np.random.default_rng(m + 7 * k + n)
    x = torch.from_numpy(g.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(g.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, n).astype(np.float32))
    x, w, s = (t.to(cuda_device) for t in (x, w, s))
    got = tqm.w8a8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(got, tqm.w8a8_matmul(x, w, s, impl="torch"))
    leaves = tq._quantize_w4(
        np.asarray(g.normal(size=(k, n)) * 0.05, np.float32), 64)
    xf = torch.from_numpy(np.asarray(g.normal(size=(m, k)), np.float32))
    wq = torch.from_numpy(leaves["W_q4"]).to(cuda_device)
    sg = torch.from_numpy(leaves["s_g"]).to(cuda_device)
    xf = xf.to(cuda_device)
    got = tqm.w4a16_matmul(xf, wq, sg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tqm.w4a16_matmul(xf, wq, sg,
                                                     impl="torch"),
                               rtol=1e-5, atol=1e-4)


# the recurrent zoo's Dense shapes (K, N): SessionRecommender at RSC15's
# item count (the GRU's 20 and the history MLP's 20 onto 37,484 items;
# the MLP's 100 x 40 and 40 x 20) and AnomalyDetector's head (15 x 1), at
# one row, the training and serving batch and a batch off a multiple
RECURRENT_KN = ((20, 37484), (100, 40), (40, 20), (15, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 1024, 1000])
@pytest.mark.parametrize("k,n", RECURRENT_KN)
def test_recurrent_zoo_shapes_w8a8_and_w4a16_on_card(cuda_device, m, k, n):
    """K = 20 and 15 give x rows off 16 bytes, N = 37,484 is not a
    multiple of a column block, N = 1: ``w8a8`` bitwise (each weight its
    own allocation, and again inside a buffer of 127s); ``w4a16`` (one
    ragged group of 64 at K = 15 and 20) within atol 1e-4."""
    _check_matmul_kernels(cuda_device, m, k, n)
    g = np.random.default_rng(m + k + n)
    x = torch.from_numpy(g.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(g.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, n).astype(np.float32))
    x, w, s = (t.to(cuda_device) for t in (x, w, s))
    buf = torch.full((w.numel() + 96,), 127, dtype=torch.int8,
                     device=cuda_device)
    buf[48:48 + w.numel()] = w.flatten()
    got = tqm.w8a8_matmul(x, buf[48:48 + w.numel()].view(k, n), s)
    torch.cuda.synchronize()
    assert torch.equal(got, tqm.w8a8_matmul(x, w, s, impl="torch"))


def _seq2seq_model(device):
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
    m = Seq2seq(97, embed_dim=16, hidden_sizes=(64, 32), device=device)
    m.init_weights(3)
    return InferenceModel(device=device).do_load_model(m)


GEN_SEQ2SEQ = dict(paged=False, max_active_slots=4, max_tokens=10,
                   max_prompt_len=24, decode_quantum=3, stream_interval=0,
                   start_id=1)


@pytest.mark.gpu
def test_seq2seq_lane_graph_serves_the_eager_tokens_on_card(cuda_device):
    """A ``Seq2seq`` bare-state lane after ``warm()``: its decode quantum
    (a list of (h, c) pairs copied back in place) is captured as one CUDA
    graph; two waves of churn replay it only, and give an eager batcher's
    tokens.  The trace of the card shows no launch of any hand-written
    kernel (the lane has none) and the wrappers count none."""
    im = _seq2seq_model(cuda_device)
    eager = tgen.ContinuousBatcher(im, tgen.GenerationParams(**GEN_SEQ2SEQ))
    want = _serve(eager, _gen_reqs(1))
    want2 = _serve(eager, _gen_reqs(2, tag="b"))
    assert eager.stats()["eager_quanta"] > 0
    b = tgen.ContinuousBatcher(im, tgen.GenerationParams(**GEN_SEQ2SEQ))
    doc = b.warm()
    assert doc["failed"] == 0 and b.captures == 1, doc
    counters = (tqm.launches_w8a8, tqm.launches_w4a16, tpa.launches)
    with _impl.card_launches() as card:
        assert _serve(b, _gen_reqs(1)) == want
        assert _serve(b, _gen_reqs(2, tag="b")) == want2
    st = b.stats()
    assert st["eager_quanta"] == 0 and st["can_resume"] is False
    assert st["replays"] * GEN_SEQ2SEQ["decode_quantum"] \
        == st["decode_steps"] > 0
    assert set(card.values()) == {0}
    assert (tqm.launches_w8a8, tqm.launches_w4a16, tpa.launches) == counters


@pytest.mark.gpu
def test_embedding_out_of_range_ids_on_card(cuda_device):
    """Ids past the table on either side give a row of NaN, with no
    device-side assert: the context stays usable, and a later lookup and
    product run."""
    from analytics_zoo_tpu_torch.nn.layers.core import Embedding
    emb = Embedding(10, 4).to(cuda_device)
    ids = torch.tensor([[3.0, 10.0, -11.0, -1.0, 1e12, 9.9]],
                       device=cuda_device)
    out = emb(ids)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(out).all(-1)[0].tolist()
    assert nan_rows == [False, True, True, False, True, False]
    assert torch.equal(out[0, 3], emb.E[9]) and torch.equal(out[0, 5],
                                                            emb.E[9])
    out.nan_to_num(0.0).sum().backward()
    assert torch.isfinite(emb.E.grad).all()
    again = emb(torch.tensor([[0.0, 2.0]], device=cuda_device))
    assert torch.equal(again[0], emb.E[[0, 2]])
    assert float((again @ again.transpose(1, 2)).sum()) >= 0.0


# the text zoo's one-row geometries of w8a8_conv2d (a Convolution1D as the
# (1, k) conv of (B, 1, T, C)): the classifier's (T 500, 200 channels,
# kernel 5, valid), an odd T under same, an even kernel (pads (1, 2)),
# 300 channels, 16 channels (the copied route), dilation 2 at 200 and 16
TEXT_CONV = (
    ((128, 1, 500, 200), (1, 5, 200, 256), (1, 1), ((0, 0), (0, 0)), (1, 1),
     1),
    ((8, 1, 499, 200), (1, 5, 200, 256), (1, 1), ((0, 0), (2, 2)), (1, 1), 1),
    ((8, 1, 500, 200), (1, 4, 200, 256), (1, 1), ((0, 0), (1, 2)), (1, 1), 1),
    ((8, 1, 500, 300), (1, 5, 300, 256), (1, 1), ((0, 0), (2, 2)), (1, 1), 1),
    ((8, 1, 77, 16), (1, 5, 16, 64), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
    ((8, 1, 500, 200), (1, 5, 200, 256), (1, 1), ((0, 0), (4, 4)), (1, 2), 1),
    ((3, 1, 501, 16), (1, 5, 16, 256), (1, 1), ((0, 0), (4, 4)), (1, 2), 1),
)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", TEXT_CONV)
@pytest.mark.parametrize("extremes", [False, True])
def test_w8a8_conv2d_one_row_geometries_on_card(cuda_device, geom,
                                                extremes):
    """The text zoo's 1-D convs on the s8 kernel, bitwise against its plain
    version, with the weight packed beforehand and on the call."""
    xshape, kshape, strides, pads, dil, groups = geom
    g = np.random.default_rng(sum(xshape) + sum(kshape))
    if extremes:
        ends = np.array([-128, 127], np.int8)
        x, w = g.choice(ends, xshape), g.choice(ends, kshape)
    else:
        x = g.integers(-128, 128, xshape).astype(np.int8)
        w = g.integers(-128, 128, kshape).astype(np.int8)
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, kshape[-1]).astype(
        np.float32)).to(cuda_device)
    x = torch.from_numpy(x).to(cuda_device)
    w = torch.from_numpy(w).to(cuda_device)
    kw = dict(strides=strides, pads=pads, dilation=dil, groups=groups)
    ref = tqm.w8a8_conv2d(x, w, s, impl="torch", **kw)
    n0 = tqm.launches_conv
    got = tqm.w8a8_conv2d(x, w, s, w_pack=tqm.pack_conv_weight(w, groups),
                          **kw)
    torch.cuda.synchronize()
    assert tqm.launches_conv == n0 + 1
    assert torch.equal(got, ref)
    assert torch.equal(tqm.w8a8_conv2d(x, w, s, **kw), ref)


# the text zoo's Dense (K, N): TextClassifier's heads (256 -> 128 -> 20)
# and KNRM's (21 kernels -> 1; x rows of 21 bytes, off 16; int4 one
# ragged group of 64), at one row, a batch of 128 and a batch off it
TEXT_KN = ((256, 128), (128, 20), (21, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16, 128, 1000])
@pytest.mark.parametrize("k,n", TEXT_KN)
def test_text_zoo_shapes_w8a8_and_w4a16_on_card(cuda_device, m, k, n):
    _check_matmul_kernels(cuda_device, m, k, n)


@pytest.mark.gpu
def test_int8_text_classifier_launches_on_card(cuda_device):
    """An int8 TextClassifier (cnn) forward at a narrow width runs
    w8a8_conv2d once and w8a8 twice; the profiler trace of the card shows
    those launches, equal to the wrappers' counts; its probabilities are
    bitwise the plain route's."""
    from analytics_zoo_tpu_torch.models import TextClassifier
    tc = TextClassifier(5, 300, embedding_dim=24, sequence_length=40,
                        encoder_output_dim=32, device=cuda_device)
    tc.init_weights(4)
    g = np.random.default_rng(5)
    x = g.integers(0, 300, (16, 40)).astype(np.float32)
    im = InferenceModel(max_batch=16, device=cuda_device).do_load_model(
        tc.model)
    im.do_quantize(x, bits=8, force=True)
    im.do_predict(x)                       # packs the conv's weight
    torch.cuda.synchronize()
    before = (tqm.launches_conv, tqm.launches_w8a8)
    with _impl.card_launches(("w8a8", "w8a8_conv")) as card:
        got = im.do_predict(x)
        torch.cuda.synchronize()
    wrapper = (tqm.launches_conv - before[0], tqm.launches_w8a8 - before[1])
    assert wrapper == (1, 2)
    assert (card["w8a8_conv"], card["w8a8"]) == wrapper
    for m in im._model.modules():
        if hasattr(m, "impl"):
            m.impl = "torch"
    assert np.array_equal(got, InferenceModel(
        max_batch=16, device=cuda_device).do_load_model(
        im._model).do_predict(x))


# the forecasting heads' (K, N): the AutoTS grid's lstm_2_units (16, 32,
# 64) and LSTMForecaster's default 8 onto a horizon of 1
FORECAST_KN = ((8, 1), (16, 1), (32, 1), (64, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 32, 64, 1024])
@pytest.mark.parametrize("k,n", FORECAST_KN)
def test_forecast_head_shapes_w8a8_and_w4a16_on_card(cuda_device, m, k, n):
    _check_matmul_kernels(cuda_device, m, k, n)


def _forecaster_im(cuda_device, bits, cls="LSTMForecaster"):
    from analytics_zoo_tpu_torch import zouwu
    f = getattr(zouwu, cls)(feature_dim=3, lookback=8 if cls ==
                            "LSTMForecaster" else 16, device=cuda_device)
    f.init_weights(6)
    g = np.random.default_rng(7)
    x = g.normal(size=(96, f.lookback, 3)).astype(np.float32)
    im = InferenceModel(max_batch=32, device=cuda_device).do_load_model(
        f.model)
    if bits:
        im.do_quantize(x[:32] if bits == 8 else None, bits=bits, force=True)
    return im, x


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_lstm_forecaster_launches_on_card(cuda_device, bits):
    """An int8 (int4) LSTMForecaster forward runs w8a8 (w4a16) once, for
    its Dense head: the profiler trace of the card shows the launches,
    equal to the wrapper's count; int8 predictions are bitwise the plain
    route's, int4 within atol 1e-4."""
    im, x = _forecaster_im(cuda_device, bits)
    name = "w8a8" if bits == 8 else "w4a16"
    counter = "launches_w8a8" if bits == 8 else "launches_w4a16"
    im.do_predict(x[:32])
    torch.cuda.synchronize()
    before = getattr(tqm, counter)
    with _impl.card_launches((name,)) as card:
        got = im.do_predict(x, batch_size=32)
        torch.cuda.synchronize()
    assert getattr(tqm, counter) - before == card[name] == 3
    for m in im._model.modules():
        if hasattr(m, "impl"):
            m.impl = "torch"
    want = InferenceModel(max_batch=32, device=cuda_device).do_load_model(
        im._model).do_predict(x, batch_size=32)
    if bits == 8:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
def test_int8_mtnet_launches_nothing_on_card(cuda_device):
    """MTNet quantizes no layer (the quantizer walks only layer lists):
    its int8 forward launches no kernel and equals f32 bitwise."""
    im, x = _forecaster_im(cuda_device, 0, "MTNetForecaster")
    want = im.do_predict(x, batch_size=32)
    im8, _ = _forecaster_im(cuda_device, 8, "MTNetForecaster")
    with _impl.card_launches(("w8a8", "w4a16")) as card:
        got = im8.do_predict(x, batch_size=32)
        torch.cuda.synchronize()
    assert card == {"w8a8": 0, "w4a16": 0}
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_thread_pooled_trials_equal_the_loop_on_card(cuda_device):
    """Two trials trained at once on two threads of one card give the
    validation MSEs of the sequential loop bit for bit."""
    import pandas as pd

    from analytics_zoo_tpu_torch.automl import (LSTMGridRandomRecipe,
                                                TimeSequencePredictor)
    from analytics_zoo_tpu_torch.common.context import init_context
    init_context(device=str(cuda_device), seed=42)
    t = np.arange(400)
    df = pd.DataFrame({"datetime": pd.date_range("2014-07-01", periods=400,
                                                 freq="30min"),
                       "value": np.sin(2 * np.pi * t / 48) + 0.1 * np.cos(t)})
    metrics = {}
    for par in (2, 1):
        recipe = LSTMGridRandomRecipe(epochs=1, lstm_1_units=(16,),
                                      lstm_2_units=(8, 16),
                                      batch_size=(32,), parallelism=par)
        p = TimeSequencePredictor(recipe=recipe, device=cuda_device)
        p.fit(df[:300], df[280:])
        metrics[par] = [tr.metric for tr in p._last_trials]
    assert len(metrics[2]) == 2 and metrics[2] == metrics[1]


@pytest.mark.gpu
def test_population_trainer_on_card(cuda_device):
    """K members under ``torch.func.vmap`` on the card, dropout draws
    (K, ...) a site: finite losses that fall, and the run repeats
    exactly."""
    from analytics_zoo_tpu_torch.automl import PopulationTrainer
    from analytics_zoo_tpu_torch.zouwu import LSTMForecaster
    g = np.random.default_rng(8)
    x = g.normal(size=(256, 8, 3)).astype(np.float32)
    y = (x[:, -1, :1] * 0.5).astype(np.float32)
    runs = [PopulationTrainer(LSTMForecaster(
        feature_dim=3, lookback=8, device=cuda_device).model).fit(
        x, y, [1e-3, 3e-3, 1e-2, 3e-2], epochs=3, batch_size=64)
        for _ in range(2)]
    a = runs[0]["losses"]
    assert a.shape == (3, 4) and np.isfinite(a).all()
    assert (a[-1] < a[0]).all()
    np.testing.assert_array_equal(a, runs[1]["losses"])


# -- the front door on the card -----------------------------------------------

def _http(url, data=None, headers=None, method=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _gateway_engine(im, **params):
    from analytics_zoo_tpu_torch.serving.engine import (ClusterServing,
                                                        ServingParams)
    from analytics_zoo_tpu_torch.serving.queues import InProcQueue
    return ClusterServing(im, InProcQueue(), ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=GEN_CARD, warmup=True,
        http_port=0, **params))


def _wait_ready(s, timeout_s=120.0):
    import time
    t0 = time.monotonic()
    while s.health()["warmup"]["state"] in ("pending", "warming"):
        assert time.monotonic() - t0 < timeout_s, s.health()["warmup"]
        time.sleep(0.02)
    assert s.health()["warmup"]["state"] == "ready"


def _post_and_poll(url, reqs, tenant="acme"):
    import json
    from analytics_zoo_tpu_torch.serving import wire
    for rid, prompt, budget in reqs:
        frame = wire.encode_frame(
            {"uri": rid, "gen": {"max_tokens": budget}},
            payload=np.asarray(prompt, "<f4"))
        st, _, body = _http(url + "/v1/enqueue", frame,
                            {"Content-Type": "application/octet-stream",
                             "X-Tenant": tenant})
        assert st == 200, body
    out = {}
    for rid, _, _ in reqs:
        while rid not in out:
            st, _, body = _http(url + f"/v1/result/{rid}?timeout_s=5")
            doc = json.loads(body) if st == 200 else {}
            if st == 200 and not doc.get("partial"):
                out[rid] = doc
    return out


@pytest.mark.gpu
def test_gateway_serves_paged_generation_on_card(cuda_device):
    """Binary frames through ``/v1/enqueue`` into a warmed engine on the
    card: every token list equals an eager batcher's, every quantum is a
    graph replay, the paged kernel runs decode steps x 12 on the card, and
    the tokens charged to the tenant are those delivered less each
    request's prefill token."""
    im = _gen_model(cuda_device)
    reqs = _gen_reqs(4)
    want = _serve(tgen.ContinuousBatcher(im, tgen.GenerationParams(
        **GEN_CARD)), reqs)
    s = _gateway_engine(im)
    s.start()
    try:
        _wait_ready(s)
        b = s._batcher
        steps0 = b.decode_steps
        with _impl.card_launches(("paged",)) as card:
            got = _post_and_poll(s._http.url, reqs)
        steps = b.decode_steps - steps0
        usage = s.health()["usage"]["tenants"]["acme"]
    finally:
        s.shutdown(drain_s=5.0)
    assert {rid: r["value"]["tokens"] for rid, r in got.items()} == want
    assert b.stats()["eager_quanta"] == 0
    assert card["paged"] == steps * 12 > 0
    assert usage["records"] == len(reqs)
    assert usage["tokens"] == sum(len(t) - 1 for t in want.values())


@pytest.mark.gpu
def test_profile_trace_holds_the_paged_kernel_on_card(cuda_device,
                                                      tmp_path):
    """``POST /debug/profile`` while traffic flows: 202, then 409 for a
    second trace; the Chrome trace written holds the paged kernel's
    launches; afterwards ``card_launches`` counts as before."""
    import json
    import time
    im = _gen_model(cuda_device)
    s = _gateway_engine(im)
    s.profile_dir = str(tmp_path)
    s.start()
    try:
        _wait_ready(s)
        url = s._http.url
        stop = threading.Event()

        def traffic():
            k = 0
            while not stop.is_set():
                _post_and_poll(url, _gen_reqs(5, n=4, tag=f"p{k}-"))
                k += 1

        th = threading.Thread(target=traffic)
        th.start()
        try:
            st, _, body = _http(url + "/debug/profile?seconds=1", b"",
                                method="POST")
            assert st == 202, body
            path = json.loads(body)["path"]
            assert _http(url + "/debug/profile?seconds=1", b"",
                         method="POST")[0] == 409
            t0 = time.monotonic()
            while not [e for e in s.recorder.events()
                       if e.get("event") in ("profile_done",
                                             "profile_error")
                       and e.get("replica") == s.replica_id]:
                assert time.monotonic() - t0 < 120
                time.sleep(0.05)
        finally:
            stop.set()
            th.join(120)
        ev = [e for e in s.recorder.events()
              if e.get("event", "").startswith("profile_")
              and e.get("replica") == s.replica_id][-1]
        assert ev["event"] == "profile_done", ev
        with open(f"{path}/trace.json") as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
        assert any(_impl.KERNEL_NAMES["paged"] in n for n in names)
        steps0 = s._batcher.decode_steps
        with _impl.card_launches(("paged",)) as card:
            _post_and_poll(url, _gen_reqs(6, n=4, tag="after-"))
        assert card["paged"] == (s._batcher.decode_steps - steps0) * 12
    finally:
        s.shutdown(drain_s=5.0)


@pytest.mark.gpu
def test_resource_ledger_against_the_allocator_on_card(cuda_device):
    """The ledger of a warmed generation engine: weights = the bytes of
    the model's stored parameters and buffers, kv_state = the batcher's
    ``state_bytes()``, the CUDA-graph pools > 0; weights + kv_state within
    ``torch.cuda.memory_allocated()``, and with the pools (segments the
    allocator reserves for the graphs' replays) within
    ``memory_reserved()``."""
    im = _gen_model(cuda_device)
    s = _gateway_engine(im)
    s.start()
    try:
        _wait_ready(s)
        _post_and_poll(s._http.url, _gen_reqs(7, n=4))
        res = s.health()["resources"]
        kv = s._batcher.state_bytes()
    finally:
        s.shutdown(drain_s=5.0)
    module = im._model
    stored = {t.data_ptr(): t.numel() * t.element_size()
              for t in list(module.parameters()) + list(module.buffers())}
    assert res["weights_bytes"] == sum(stored.values())
    assert res["kv_state_bytes"] == kv
    code = res["executables"]["code_bytes"]
    assert code is not None and code > 0
    torch.cuda.synchronize()
    assert res["weights_bytes"] + kv <= torch.cuda.memory_allocated()
    assert res["weights_bytes"] + kv + code <= torch.cuda.memory_reserved()
