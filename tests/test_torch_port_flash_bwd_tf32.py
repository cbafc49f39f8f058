"""PyTorch port: the arithmetic of the flash backward's CUDA kernels, on the CPU.

``csrc/flash_attention_bwd.cu`` runs all five products of the backward (s,
dp, dq; sᵀ, dpᵀ, dv, dk) on the tensor cores in 3xTF32: each f32 operand
x is split into ``big = cvt.rna.tf32.f32(x)`` and ``small =
cvt.rna.tf32.f32(x - big)``, and ``big·small + small·big`` is accumulated
before ``big·big`` in an f32 accumulator.  The kernels cannot run here, so
this file emulates that arithmetic on f32 bits (a helper local to the test;
the port's plain backward stays plain f32) and holds the backward computed
with it against the JAX package's ``_flash_bwd``, its dq and dk/dv Pallas
kernels in interpret mode, from the same numpy-seeded inputs, within the
f32 tolerance the kernels are held to on the card (``FLASH_TOL``: atol
2e-5, rtol 1e-5).  A backward whose products are a single TF32 product
breaks that tolerance at T = 1024, so a design that drops the correction
terms fails here on the numbers.
"""

import math

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

# the kernels' f32 tolerance on the card (chip_smoke.FLASH_TOL[float32])
ATOL, RTOL = 2e-5, 1e-5
BLOCK = 64   # the Pallas kernels' block in interpret mode


def _tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 of f32's 23 mantissa bits, rounding to
    nearest with ties away from zero (add half of the dropped unit to the
    magnitude's bits, then clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_3xtf32(a, b):
    """a @ b as the kernels compute it: the correction products first,
    then big·big, f32 sums of products of TF32 values."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return (ab @ bs + as_ @ bb) + ab @ bb


def _mm_tf32(a, b):
    """a @ b from one TF32 product: what a design without the correction
    terms computes."""
    return _tf32(a) @ _tf32(b)


def _bwd(q, k, v, dO, lse, delta, causal, scale, mm):
    """The kernels' backward over whole rows: s and dp recomputed, p from
    the LSE, then dq, dk and dv, every product through ``mm``."""
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        T = q.shape[-2]
        p = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (mm(dO, v.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    dv = mm(p.transpose(-1, -2), dO)
    return dq, dk, dv


def _case(seed, B, H, T, D, causal, lse_ct):
    """Inputs from numpy, the JAX forward (output and LSE) and the JAX
    backward through ``_flash_bwd``'s Pallas kernels in interpret mode;
    returns the torch inputs of the emulated backward and JAX's dq, dk, dv."""
    g = np.random.default_rng(seed)
    q, k, v, dO = (np.asarray(g.normal(size=(B, H, T, D)), np.float32)
                   for _ in range(4))
    g_lse = np.asarray(g.normal(size=(B, H, T)), np.float32) \
        if lse_ct else None
    scale = 1.0 / math.sqrt(D)
    bq = min(BLOCK, T)
    out, lse = jfa._flash_fwd(q, k, v, causal, scale, bq, bq, True,
                              emit_lse=True)
    want = jfa._flash_bwd(q, k, v, out, lse, dO, causal, scale, bq, bq,
                          True, g_lse=g_lse)
    t = lambda a: torch.from_numpy(np.array(a))
    delta = tfa._delta(t(out), t(dO), None if g_lse is None else t(g_lse))
    inputs = (t(q), t(k), t(v), t(dO), t(lse), delta, causal, scale)
    return inputs, [np.asarray(w) for w in want]


def _errs(got, want):
    return [float(np.abs(a.numpy() - b).max()) for a, b in zip(got, want)]


def test_tf32_helper_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10   # the TF32 neighbour of 1 above it
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0, 0.0],
                     dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got == [one, -one, 1.0, 3.0, 0.0]
    big, small = _split(torch.tensor([math.pi], dtype=torch.float32))
    assert (big + small).item() == pytest.approx(math.pi, rel=2 ** -22)
    assert _tf32(small).item() == small.item()


@pytest.mark.parametrize("T,D,causal,lse_ct", [
    (64, 32, False, False),
    (77, 32, True, True),
    (130, 64, True, False),
    (200, 64, False, True),
])
def test_3xtf32_backward_matches_jax_pallas_interpret(T, D, causal, lse_ct):
    inputs, want = _case(T + D, 2, 2, T, D, causal, lse_ct)
    got = _bwd(*inputs, _mm_3xtf32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)


def test_single_tf32_product_breaks_the_tolerance_at_t1024():
    """At (1, 2, 1024, 64) causal the 3xTF32 backward stays within the
    kernels' f32 tolerance of the Pallas kernels, and one TF32 product
    misses it by orders of magnitude (~1e-3 on gradients of magnitude
    ~1-4)."""
    inputs, want = _case(1024, 1, 2, 1024, 64, True, False)
    good = _bwd(*inputs, _mm_3xtf32)
    for a, b in zip(good, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)
    bad = _bwd(*inputs, _mm_tf32)
    errs = _errs(bad, want)
    assert min(errs) > 10 * ATOL, errs
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad[0].numpy(), want[0], atol=ATOL,
                                   rtol=RTOL)
