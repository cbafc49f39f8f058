"""PyTorch port: the arithmetic of the ``w4a16`` CUDA kernel, on the CPU.

``csrc/quant_matmul.cu`` runs w4a16's products on the tensor cores with
the operands swapped (out^T = W^T·x^T) and the group scale factored out:
for every chunk of at most 64 packed rows that lies inside one group of
the low rows and one of the high rows (chunks end at every group boundary,
at the end of an x segment and at K), each half's products sum into a
zeroed partial, and ``acc += s[g, n] · partial`` is one f32 multiply-add.
f32 x takes two TF32 products a k-step of 8 rows (x's small half, then its
big half, split by Veltkamp's method in f32 arithmetic, against the codes,
which are exact in TF32), bf16 x one bf16 product of 16 rows.  An mma sums its terms against its C operand with
truncation (``mma_probe.py``: terms aligned to the largest and cut towards
zero, the sum cut to f32's 24 bits).

The kernel cannot run here, so this file emulates that arithmetic in
float32 with helpers local to the test (the port's plain version stays the
plain ``x @ (q·s)`` in f32) and holds it to the JAX package's
``w4a16_matmul_xla`` and to the port's plain version at the kernel's
tolerance on the card, ``chip_smoke.W4_TOL`` (atol 1e-4, rtol 1e-5: f32
sums of up to K products of unit-scale x and weights ~0.05 in another
order, of which the chunk partials change only the grouping).  One TF32
product a k-step (no small half of x) misses it at K = 768.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

# chip_smoke.W4_TOL
ATOL, RTOL = 1e-4, 1e-5
# the kernel's chunk: packed rows at most; x segments of 384 (f32) or 768
# (bf16) packed rows at one m-tile a block (M <= 8), a quarter at four
KT = 64
# bits the mma keeps below the largest term's last bit before it cuts
GUARD = 3


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy: it is process-global, and a
    test that runs a benchmark in-process in the same worker may leave it
    at bf16."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _tf32_read(x):
    """An f32 operand as the TF32 mma reads it: its low 13 mantissa bits
    dropped (towards zero)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split of f32 x: big = x to 11 significant bits by
    Veltkamp's split (c = x·(2^13 + 1), big = c - (c - x), in f32), small =
    x - big (exact), which the mma reads to 11 bits."""
    c = x * 8193.0
    big = c - (c - x)
    return big, _tf32_read(x - big)


def _trunc24(d):
    """float64 -> float32 rounded towards zero."""
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(c, a, b):
    """One mma as the tensor core sums it: ``c`` (R, C) f32 plus ``a`` (R,
    k) @ ``b`` (k, C), every term cut towards zero to a multiple of
    2^-GUARD of the largest term's last f32 bit, the sum cut to f32."""
    terms = a.double()[:, :, None] * b.double()[None, :, :]
    terms = torch.cat([c.double()[:, None, :], terms], 1)
    top = terms.abs().amax(1, keepdim=True).clamp_min(1e-300)
    q = torch.pow(2.0, torch.floor(torch.log2(top)) - 23 - GUARD)
    return _trunc24((torch.trunc(terms / q) * q).sum(1))


def _chunks(K, G, M, f32):
    """The kernel's chunks (r0, r1, low group, high group or None)."""
    kh = (K + 1) // 2
    gs = -(-K // G)
    kseg = (384 if f32 else 768) // (1 if M <= 8 else 4)
    r0 = 0
    while r0 < kh:
        glo = r0 // gs
        r1 = min(r0 + KT, kh, (r0 // kseg + 1) * kseg, (glo + 1) * gs)
        ghi = None
        if kh + r0 < K:
            ghi = (kh + r0) // gs
            r1 = min(r1, (ghi + 1) * gs - kh)
        yield r0, r1, glo, ghi
        r0 = r1


def _w4_tc(x, wq, sg, one_product=False):
    """The kernel's arithmetic: (M, N) f32 from x (M, K) f32 or bf16."""
    m, k = x.shape
    n = wq.shape[1]
    f32 = x.dtype == torch.float32
    b = wq.to(torch.int32)
    codes = (((b & 0xF) ^ 8) - 8, ((b >> 4) ^ 8) - 8)     # low, high rows
    kh = wq.shape[0]
    xf = x.float()
    acc = torch.zeros(n, m)
    for r0, r1, glo, ghi in _chunks(k, sg.shape[0], m, f32):
        for hf, grp in ((0, glo), (1, ghi)):
            if grp is None:
                continue
            ks = hf * kh + torch.arange(r0, r1)
            xs = torch.where(ks < k, xf[:, ks.clamp_max(k - 1)], 0.0).T
            a = codes[hf][r0:r1].T.float()                 # (N, rows)
            part = torch.zeros(n, m)
            step = 8 if f32 else 16
            for s in range(0, r1 - r0, step):
                sl = slice(s, s + step)
                if f32:
                    big, small = _split(xs[sl])
                    if not one_product:
                        part = _mma(part, a[:, sl], small)
                    part = _mma(part, a[:, sl], big)
                else:
                    part = _mma(part, a[:, sl], xs[sl])
            acc = (sg[grp].double()[:, None] * part.double()
                   + acc.double()).float()
    return acc.T


def _case(seed, m, k, n, group, dtype):
    g = np.random.default_rng(seed)
    W = np.asarray(g.normal(size=(k, n)) * 0.05, np.float32)
    x = torch.from_numpy(np.asarray(g.normal(size=(m, k)), np.float32))
    leaves = jq._quantize_w4(W, group)
    return (x.to(dtype), torch.from_numpy(np.array(leaves["W_q4"])),
            torch.from_numpy(np.array(leaves["s_g"])))


# (K, group size): the predict head's K with 64-row groups; a ragged last
# group whose boundaries fall inside a chunk and one group straddling the
# low and high halves (100, 34); odd K (101, 26); groups of 5 rows; one
# group over all of K; several x segments (2000, 64)
SHAPES = [(768, 64), (100, 34), (101, 26), (64, 5), (96, 96), (2000, 64)]


@pytest.mark.parametrize("k,group", SHAPES)
@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_arithmetic_matches_jax_and_plain(dtype, m, k, group):
    x, wq, sg = _case(k + m, m, k, 48, group, dtype)
    got = _w4_tc(x, wq, sg).numpy()
    xj = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    want = np.asarray(jqm.w4a16_matmul_xla(xj, wq.numpy(), sg.numpy()))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    plain = tqm.w4a16_matmul_torch(x, wq, sg).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k,group,m", [(100, 34, 8), (101, 26, 3),
                                       (64, 5, 8), (2000, 64, 8),
                                       (2000, 64, 33)])
@pytest.mark.parametrize("f32", [True, False])
def test_chunks_cover_k_inside_one_group_a_half(k, group, m, f32):
    kh = (k + 1) // 2
    gs = -(-k // -(-k // group))
    seen = []
    for r0, r1, glo, ghi in _chunks(k, -(-k // group), m, f32):
        assert 0 < r1 - r0 <= KT
        assert {r // gs for r in range(r0, r1)} == {glo}
        high = [kh + r for r in range(r0, r1) if kh + r < k]
        assert {q // gs for q in high} == ({ghi} if high else set())
        seen += range(r0, r1)
    assert seen == list(range(kh))


def test_one_tf32_product_misses():
    """Without x's small half the products are TF32-rounded x: at the
    head's K = 768 that is off by more than the tolerance."""
    x, wq, sg = _case(3, 8, 768, 64, 64, torch.float32)
    ref = tqm.w4a16_matmul_torch(x, wq, sg).double()
    ok = (ATOL + RTOL * ref.abs()).numpy()
    one = _w4_tc(x, wq, sg, one_product=True).double()
    assert ((one - ref).abs().numpy() > ok).any()
    two = _w4_tc(x, wq, sg).double()
    assert ((two - ref).abs().numpy() <= ok).all()
