"""PyTorch port: every CUDA kernel against its plain version, on the card.

Each test carries the ``gpu`` marker and decides inside its fixture whether
a card is present, so it skips on a machine without one.  The module
imports no JAX, so it runs where only PyTorch is installed, without the
repository's ``conftest.py`` (which configures JAX)::

    python -m pytest -m gpu --noconftest -p no:cacheprovider \\
        tests/test_torch_port_card.py -q

The kernels are built from ``analytics_zoo_tpu_torch/csrc/`` at their first
launch.  Tolerances: the same f32 math in another summation order (atol
2e-5, rtol 1e-5) for the paged and flash kernels and the LSE; one bf16
rounding step for bf16 outputs; bitwise for ``w8a8``; f32 sums of up to
768 products in another order for ``w4a16`` (atol 1e-4).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm


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
                                   (33, 64, 129)])
def test_w8a8_kernel_bitwise_on_card(cuda_device, m, k, n):
    g = np.random.default_rng(m + k + n)
    x = torch.from_numpy(g.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(g.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, n).astype(np.float32))
    x, w, s = (t.to(cuda_device) for t in (x, w, s))
    n0 = tqm.launches_w8a8
    got = tqm.w8a8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert tqm.launches_w8a8 == n0 + 1
    assert torch.equal(got, tqm.w8a8_matmul(x, w, s, impl="torch"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,group", [(8, 768, 1000, 64),
                                         (5, 100, 61, 34), (33, 101, 7, 26)])
def test_w4a16_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n,
                                            group):
    g = np.random.default_rng(m + k + n)
    leaves = tq._quantize_w4(
        np.asarray(g.normal(size=(k, n)) * 0.05, np.float32), group)
    x = torch.from_numpy(np.asarray(g.normal(size=(m, k)), np.float32))
    x = x.to(cuda_device, dtype)
    wq = torch.from_numpy(leaves["W_q4"]).to(cuda_device)
    sg = torch.from_numpy(leaves["s_g"]).to(cuda_device)
    n0 = tqm.launches_w4a16
    got = tqm.w4a16_matmul(x, wq, sg)
    torch.cuda.synchronize()
    assert tqm.launches_w4a16 == n0 + 1
    torch.testing.assert_close(got, tqm.w4a16_matmul(x, wq, sg,
                                                     impl="torch"),
                               rtol=1e-5, atol=1e-4)
