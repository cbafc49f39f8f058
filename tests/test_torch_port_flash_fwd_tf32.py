"""PyTorch port: the arithmetic of the flash forward's CUDA kernel, on the CPU.

``csrc/flash_attention.cu`` runs both products of the forward on the
tensor cores in 3xTF32 (``mma.sync.m16n8k8``; each f32 operand x split
into ``big = cvt.rna.tf32.f32(x)`` and ``small = cvt.rna.tf32.f32(x -
big)``, ``big·small + small·big`` accumulated before ``big·big``): s =
(q·scale)·kᵀ over 32-key tiles, two k-steps over the head dimension
summed into a zeroed partial; the online softmax in f32 with exp as a
power of two; then p·v, one k-step of 8 keys a partial.  An mma sums its
terms against its C operand with truncation (``mma_probe.py``), which is
why the partials exist.

The kernel cannot run here, so this file emulates that arithmetic with
helpers local to the test (the port's plain version stays plain f32) and
holds the output and the LSE to the JAX package's ``_flash_fwd`` (its
Pallas kernel in interpret mode) from the same numpy-seeded inputs, within
the tolerances the kernel meets on the card (``chip_smoke.FLASH_TOL`` and
``LSE_TOL``).  One TF32 product misses them at T = 1024.
"""

import math

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import flash_attention as jfa

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

# the kernel's f32 tolerances on the card (chip_smoke.FLASH_TOL[float32],
# LSE_TOL)
ATOL, RTOL = 2e-5, 1e-5
BLOCK = 64     # the Pallas kernel's block in interpret mode
KEYS = 32      # the CUDA kernel's key tile
LOG2E = 1.4426950408889634
GUARD = 3      # bits the mma keeps below the largest term's last bit


def _tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 of f32's 23 mantissa bits, rounding to
    nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _trunc24(d):
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(c, a, b):
    """One mma as the tensor core sums it: c (..., R, C) plus a (..., R, 8)
    @ b (..., 8, C), every term cut towards zero to a multiple of 2^-GUARD
    of the largest term's last f32 bit, the sum cut towards zero to f32."""
    terms = a.double()[..., :, :, None] * b.double()[..., None, :, :]
    terms = torch.cat([c.double()[..., :, None, :], terms], -2)
    top = terms.abs().amax(-2, keepdim=True).clamp_min(1e-300)
    q = torch.pow(2.0, torch.floor(torch.log2(top)) - 23 - GUARD)
    return _trunc24((torch.trunc(terms / q) * q).sum(-2))


def _mm(a, b, steps, three):
    """a @ b over its last axis in k-steps of 8, ``steps`` k-steps a
    zeroed partial, each k-step 3xTF32 (or one TF32 product)."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for u in range(0, a.shape[-1], 8 * steps):
        part = torch.zeros_like(out)
        for k in range(u, u + 8 * steps, 8):
            sl = slice(k, k + 8)
            if three:
                part = _mma(part, ab[..., sl], bs[..., sl, :])
                part = _mma(part, as_[..., sl], bb[..., sl, :])
            part = _mma(part, ab[..., sl], bb[..., sl, :])
        out = out + part
    return out


def _fwd(q, k, v, causal, scale, three=True):
    """The kernel's forward over (B, H, T, D) f32: (out, lse)."""
    T = q.shape[-2]
    qs = q * scale
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros_like(q)
    rows = torch.arange(T)[:, None]
    for k0 in range(0, T, KEYS):
        kt, vt = k[..., k0:k0 + KEYS, :], v[..., k0:k0 + KEYS, :]
        s = _mm(qs, kt.transpose(-1, -2), 2, three)
        keys = k0 + torch.arange(kt.shape[-2])[None, :]
        if causal:
            s = torch.where(keys <= rows, s, -math.inf)
        mx = torch.maximum(m, s.amax(-1))
        mb = (mx * LOG2E).float()
        alpha = torch.exp2((m.double() * LOG2E - mb.double()).float())
        p = torch.exp2((s.double() * LOG2E - mb.double()[..., None]).float())
        l = (l.double() * alpha.double() + p.sum(-1).double()).float()
        m = mx
        acc = acc * alpha[..., None] + _mm(p, vt, 1, three)
    l = l.clamp_min(1e-30)
    return acc / l[..., None], m + torch.log(l)


def _case(seed, T, causal):
    g = np.random.default_rng(seed)
    q, k, v = (np.asarray(g.normal(size=(1, 2, T, 64)), np.float32)
               for _ in range(3))
    scale = 1.0 / math.sqrt(64)
    out, lse = jfa._flash_fwd(q, k, v, causal, scale, BLOCK, BLOCK, True,
                              emit_lse=True)
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(q), t(k), t(v), scale), np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_forward_matches_jax_pallas_interpret(causal):
    """At (1, 2, 1024, 64): out within FLASH_TOL[f32], the LSE within
    LSE_TOL of the Pallas kernel's."""
    (q, k, v, scale), want, want_lse = _case(1024 + causal, 1024, causal)
    out, lse = _fwd(q, k, v, causal, scale)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=RTOL)


def test_single_tf32_product_misses_the_tolerance():
    """One TF32 product in each of the forward's products misses FLASH_TOL
    by orders of magnitude at (1, 2, 1024, 64) causal."""
    (q, k, v, scale), want, _ = _case(2048, 1024, True)
    out, _ = _fwd(q, k, v, True, scale, three=False)
    err = np.abs(out.numpy() - want)
    assert err.max() > 10 * ATOL, err.max()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
