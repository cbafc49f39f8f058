"""PyTorch port: the arithmetic of the ``fused_bn`` CUDA kernel, on the CPU.

``csrc/fused_bn.cu`` runs its product on the tensor cores: f32 operands in
3xTF32 (each x split into ``big = cvt.rna.tf32.f32(x)`` and ``small =
cvt.rna.tf32.f32(x - big)``, and ``big·small + small·big`` accumulated
before ``big·big``) with ``mma.sync.m16n8k8``, bf16 operands with
``mma.sync.m16n8k16``.  An mma sums its terms against its C operand with
truncation (``mma_probe.py``: the terms are aligned to the largest and cut
towards zero, and the sum is cut to f32's 24 bits), so the kernel sums the
k-steps of one k-tile (4 of them: 32 deep in f32, 64 in bf16) into a
zeroed partial and adds each partial to the accumulator with an f32 add.

The kernel cannot run here, so this file emulates that arithmetic with
helpers local to the test (the port's plain version stays plain f32) and
holds it to the tolerances the kernel meets on the card
(``chip_smoke.FUSED_BN_TOL`` and ``STATS_RTOL``): against float64 in f32,
against the probe's own Pallas kernel in interpret mode in bf16.  A
design with one TF32 product, or with one chain of mmas over all of K,
misses them at K = 2048.
"""

import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the kernel's tolerances on the card (chip_smoke.FUSED_BN_TOL[float32],
# STATS_RTOL)
ATOL, RTOL = 2e-5, 1e-5
STATS_RTOL = 1e-5
# k-steps a partial: one k-tile (BK = 32 in f32, 64 in bf16)
F32_STEPS, BF16_STEPS = 4, 4
# bits the mma keeps below the largest term's last bit before it cuts
GUARD = 3


def _tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 of f32's 23 mantissa bits, rounding to
    nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _trunc24(d):
    """float64 -> float32 rounded towards zero."""
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(c, a, b):
    """One mma as the tensor core sums it: ``c`` (..., R, C) f32 plus
    ``a`` (..., R, k) @ ``b`` (..., k, C), every term (c and the k
    products, exact in float64) cut towards zero to a multiple of 2^-GUARD
    of the largest term's last f32 bit, the sum cut towards zero to f32."""
    terms = a.double()[..., :, :, None] * b.double()[..., None, :, :]
    terms = torch.cat([c.double()[..., :, None, :], terms], -2)
    top = terms.abs().amax(-2, keepdim=True).clamp_min(1e-300)
    q = torch.pow(2.0, torch.floor(torch.log2(top)) - 23 - GUARD)
    return _trunc24((torch.trunc(terms / q) * q).sum(-2))


def _product(x, w, ks, steps, pairs):
    """x @ w in k-steps of ``ks``, each step's mmas ``pairs(sl)`` (a list of
    (A, B) operand slices) summed into a partial that an f32 add puts into
    the sum every ``steps`` k-steps (None: one chain over all of K)."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    part = torch.zeros_like(acc)
    n = -(-x.shape[1] // ks)
    for s in range(n):
        for a, b in pairs(slice(s * ks, (s + 1) * ks)):
            part = _mma(part, a, b)
        if steps is not None and ((s + 1) % steps == 0 or s == n - 1):
            acc = acc + part
            part = torch.zeros_like(acc)
    return acc if steps is not None else part


def _fused_f32(x, w, steps=F32_STEPS, three=True):
    """The kernel's f32 y: 3xTF32 (or one TF32 product) m16n8k8 mmas."""
    xb, xs = _split(x)
    wb, ws = _split(w)
    if three:
        return _product(x, w, 8, steps, lambda sl: [
            (xb[:, sl], ws[sl]), (xs[:, sl], wb[sl]), (xb[:, sl], wb[sl])])
    return _product(x, w, 8, steps, lambda sl: [(xb[:, sl], wb[sl])])


def _fused_bf16(x, w, steps=BF16_STEPS):
    """The kernel's f32 accumulator from bf16 operands: m16n8k16 mmas."""
    xf, wf = x.float(), w.float()
    return _product(x, w, 16, steps, lambda sl: [(xf[:, sl], wf[sl])])


def _stats(y):
    return torch.stack([y.sum(0), (y * y).sum(0)])


def _stats_errs(s, ref, y_ref):
    """(Σ error over 1e-5·Σ|y| + STATS_RTOL·|Σ|, Σ² error over
    STATS_RTOL·Σ²): both within 1 when the check passes."""
    s, ref = s.double(), ref.double()
    floor = 1e-5 * y_ref.double().abs().sum(0) + STATS_RTOL * ref[0].abs()
    return (float(((s[0] - ref[0]).abs() / floor).max()),
            float(((s[1] - ref[1]).abs() / (STATS_RTOL * ref[1])).max()))


def _f32_operands(seed, m, k, n):
    """Unit-scale x and w ~ N(0, 1/K), as chip_smoke.fused_bn_case."""
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal((m, k), dtype=np.float32))
    w = torch.from_numpy((g.standard_normal((k, n)) / math.sqrt(k)).astype(
        np.float32))
    return x, w


def test_mma_model_reproduces_the_probe_readings():
    """``mma_probe.py`` on the H100: C = 1 plus a term of 1.5 ulp gives
    1 + 1 ulp, plus 2^-24 gives 1, plus eight terms of 0.75 ulp gives
    1 + 6 ulp, plus −2^-30 gives 1."""
    ulp = 2.0 ** -23

    def one(terms):
        a = torch.tensor([terms], dtype=torch.float32)
        return float(_mma(torch.ones(1, 1), a, torch.ones(len(terms), 1)))
    assert one([1.5 * ulp]) == 1 + ulp
    assert one([2.0 ** -24]) == 1.0
    assert one([0.75 * ulp] * 8) == 1 + 6 * ulp
    assert one([-(2.0 ** -30)]) == 1.0


@pytest.mark.parametrize("k", [64, 2048])
def test_3xtf32_partials_meet_the_f32_tolerances(k):
    """At (256, K) @ (K, 64): y within FUSED_BN_TOL[f32] of float64, Σ and
    Σy² within STATS_RTOL (Σy² read ~5e-7 relative at K = 2048)."""
    x, w = _f32_operands(k, 256, k, 64)
    y64 = x.double() @ w.double()
    y = _fused_f32(x, w)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), atol=ATOL, rtol=RTOL)
    e_sum, e_sq = _stats_errs(_stats(y), _stats(y64), y64)
    assert e_sum <= 1 and e_sq <= 1, (e_sum, e_sq)


def test_one_tf32_product_or_one_chain_over_k_misses():
    """At K = 2048: one TF32 product is ~1e-3 off in y; one chain of mmas
    over all of K drifts towards zero, ~6e-5 in y and ~3e-5 relative in
    Σy², past both tolerances, where a partial a k-tile stays within."""
    x, w = _f32_operands(2048, 256, 2048, 64)
    y64 = x.double() @ w.double()
    ok = (y64.abs() * RTOL + ATOL).numpy()
    single = _fused_f32(x, w, three=False)
    assert ((single.double() - y64).abs().numpy() > ok).any()
    chain = _fused_f32(x, w, steps=None)
    assert ((chain.double() - y64).abs().numpy() > ok).any()
    _, e_sq = _stats_errs(_stats(chain), _stats(y64), y64)
    assert e_sq > 1, e_sq
    # the drift is towards zero: Σy² of the chain is low
    assert bool((_stats(chain)[1].double() < _stats(y64)[1]).all())


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "fused_bn_probe", REPO / "tools" / "fused_bn_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_call(probe, x, w, block_m):
    """The probe's ``_fused_kernel`` under its grid and block specs
    (``make_pallas_fused``), at this M, in interpret mode."""
    m, k = x.shape
    n = w.shape[1]
    return pl.pallas_call(
        functools.partial(probe._fused_kernel, block_m=block_m),
        out_shape=[jax.ShapeDtypeStruct((m, n), x.dtype),
                   jax.ShapeDtypeStruct((2, n), "float32")],
        grid=(m // block_m,),
        in_specs=[pl.BlockSpec((block_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((block_m, n), lambda i: (i, 0)),
                   pl.BlockSpec((2, n), lambda i: (0, 0))],
        interpret=True)(x, w)


@pytest.mark.parametrize("k", [64, 2048])
def test_bf16_partials_match_the_probe_kernel_in_interpret_mode(probe, k):
    """bf16 x and w (unit x, w ~ N(0, 1/K)) at (256, K) @ (K, 64): y (bf16)
    within one bf16 step of the probe's (rtol 2**-7), Σ and Σy² within
    STATS_RTOL of its f32 sums.  One chain over all of K drifts ~30x
    further from float64 in Σy² than a partial a k-tile."""
    g = np.random.default_rng(k + 1)
    x = jnp.asarray(g.standard_normal((256, k)), jnp.bfloat16)
    w = jnp.asarray(g.standard_normal((k, 64)) / math.sqrt(k), jnp.bfloat16)
    y, stats = _probe_call(probe, x, w, 128)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (x, w))
    acc = _fused_bf16(tx, tw)
    np.testing.assert_allclose(acc.bfloat16().float().numpy(),
                               np.asarray(y.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)
    y_ref = torch.from_numpy(np.array(y.astype(jnp.float32)))
    e_sum, e_sq = _stats_errs(_stats(acc), torch.from_numpy(
        np.array(stats)), y_ref)
    assert e_sum <= 1 and e_sq <= 1, (e_sum, e_sq)
    if k == 2048:
        y64 = tx.double() @ tw.double()
        drift = [float(((_stats(a)[1].double() - (y64 ** 2).sum(0)).abs()
                        / (y64 ** 2).sum(0)).max())
                 for a in (acc, _fused_bf16(tx, tw, steps=None))]
        assert drift[1] > 10 * drift[0], drift
