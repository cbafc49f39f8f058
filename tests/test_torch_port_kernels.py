"""PyTorch port: the paged-attention op and the int8 KV contract against the
JAX package.

The same numpy inputs (fixed seeds) go through the JAX reference
(``paged_attention_xla``, ``kv_pack_int8``/``kv_unpack_int8``) and the
port (``paged_attention(impl="torch")``, the port's pack/unpack), on the
CPU.  The JAX side is held to its XLA path, the one its CPU serving runs.

Tolerances: the paged op at atol 1e-5 (both sides compute the same f32
gather + einsum + softmax; only the summation order may differ); the int8
pack/unpack bitwise (same formula, same half-to-even rounding).

The predict path's kernels (flash forward, ``w8a8``, ``w4a16``) are held
to the JAX package in ``test_torch_port_quant.py``; here are their
wrappers' contracts: operands checked before anything is built, and no
fallback once a kernel is selected.

The card tests (marker ``gpu``) are in ``test_torch_port_card.py``, which
imports no JAX so that it runs on the card's machine.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.ops import paged_attention as jpa
from analytics_zoo_tpu_torch.inference import quantize as tq
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

ATOL = 1e-5


def _case(seed, lengths, rows=4, n_table=4, bl=8, nh=2, hd=8, share=True):
    """Random pool (garbage in the trash block and every unreferenced
    block), tables with tail entries on block 0 and, with ``share``, rows
    2 and 3 sharing their first block."""
    g = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_blocks = 1 + rows * n_table
    perm = g.permutation(np.arange(1, n_blocks)).reshape(rows, n_table)
    tables = np.zeros((rows, n_table), np.int32)
    for a in range(rows):
        used = -(-int(lengths[a]) // bl)
        tables[a, :used] = perm[a, :used]
    if share and lengths[2] > 0 and lengths[3] > 0:
        tables[3, 0] = tables[2, 0]
    q = np.asarray(g.normal(size=(rows, nh, hd)), np.float32)
    kp = np.asarray(g.normal(size=(n_blocks, bl, nh, hd)), np.float32)
    vp = np.asarray(g.normal(size=(n_blocks, bl, nh, hd)), np.float32)
    return q, kp, vp, tables, lengths


LENGTHS = [(32, 32, 32, 32),      # full tables
           (32, 17, 9, 1),        # ragged, one block edge + one token
           (8, 16, 24, 3)]        # block edges


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lengths", LENGTHS)
def test_paged_attention_float_matches_jax(lengths):
    q, kp, vp, tables, lens = _case(0, lengths)
    want = np.asarray(jpa.paged_attention_xla(q, kp, vp, tables, lens))
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                              impl="torch").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # auto on CPU tensors takes the same plain version
    auto = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                               _t(lens)).numpy()
    np.testing.assert_array_equal(auto, got)


@pytest.mark.parametrize("lengths", LENGTHS)
def test_paged_attention_int8_matches_jax(lengths):
    q, kp, vp, tables, lens = _case(1, lengths)
    qk, ks = (np.asarray(x) for x in jq.kv_pack_int8(kp))
    qv, vs = (np.asarray(x) for x in jq.kv_pack_int8(vp))
    want = np.asarray(jpa.paged_attention_xla(q, qk, qv, tables, lens,
                                              k_scale=ks, v_scale=vs))
    got = tpa.paged_attention(_t(q), _t(qk), _t(qv), _t(tables), _t(lens),
                              _t(ks), _t(vs), impl="torch").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_paged_attention_trash_contents_do_not_leak():
    """Whatever the trash block and the unreferenced blocks hold, the
    masked positions add nothing."""
    q, kp, vp, tables, lens = _case(2, (32, 17, 9, 1))
    base = tpa.paged_attention_torch(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(lens))
    used = set(tables[tables != 0].tolist())
    junk = [b for b in range(kp.shape[0]) if b not in used]
    assert 0 in junk
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[junk] = 1e3
    vp2[junk] = -1e3
    # and the positions past row 1's length (17) in its last block
    kp2[tables[1, 2], 1:] = 1e3
    vp2[tables[1, 2], 1:] = -1e3
    out = tpa.paged_attention_torch(_t(q), _t(kp2), _t(vp2), _t(tables),
                                    _t(lens))
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=0, atol=ATOL)


def test_kv_pack_unpack_bitwise_vs_jax():
    g = np.random.default_rng(3)
    x = np.asarray(g.normal(size=(5, 8, 2, 8)) * 3.0, np.float32)
    # exact halves exercise the half-to-even rounding
    x[0, 0, 0, :4] = np.float32(127.0 / 2.0)
    x[0, 1, 0, :] = 0.0
    x[1] = 0.0                                   # an all-zero block
    jqv, jsc = (np.asarray(a) for a in jq.kv_pack_int8(x))
    tqv, tsc = tq.kv_pack_int8(_t(x))
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    np.testing.assert_array_equal(tsc.numpy(), jsc)
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    jy = np.asarray(jq.kv_unpack_int8(jqv, jsc))
    ty = tq.kv_unpack_int8(_t(jqv), _t(jsc)).numpy()
    np.testing.assert_array_equal(ty, jy)


def test_resolve_impl_rules():
    cpu = torch.zeros(1)
    assert _impl.resolve_impl(None, cpu) == "torch"
    assert _impl.resolve_impl("auto", cpu) == "torch"
    assert _impl.resolve_impl("torch", cpu) == "torch"
    with pytest.raises(ValueError):
        _impl.resolve_impl("cuda", cpu)        # no kernel for a CPU tensor
    with pytest.raises(ValueError):
        _impl.resolve_impl("pallas", cpu)


@pytest.mark.parametrize("bad", ["q_rank", "pool_shape", "table_rows",
                                 "lengths", "one_scale", "scale_shape"])
def test_paged_attention_argument_checks(bad):
    q, kp, vp, tables, lens = _case(4, (32, 17, 9, 1))
    q, kp, vp, tables, lens = map(_t, (q, kp, vp, tables, lens))
    ks = torch.ones(kp.shape[0], kp.shape[2])
    kw = {}
    if bad == "q_rank":
        q = q[0]
    elif bad == "pool_shape":
        vp = vp[:, :4]
    elif bad == "table_rows":
        tables = tables[:2]
    elif bad == "lengths":
        lens = lens[:2]
    elif bad == "one_scale":
        kw = {"k_scale": ks}
    elif bad == "scale_shape":
        kw = {"k_scale": ks[:, :1], "v_scale": ks[:, :1]}
    with pytest.raises(ValueError):
        tpa.paged_attention(q, kp, vp, tables, lens, impl="torch", **kw)


@pytest.mark.parametrize("bad", ["head_dim", "tables_dtype",
                                 "pool_without_scales", "misaligned_q",
                                 "strided_q"])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad):
    """The CUDA wrapper checks dtype, layout, alignment and head_dim before
    it builds or launches anything (run here on CPU tensors, which
    ``paged_attention`` itself would hand to the plain version)."""
    hd = 12 if bad == "head_dim" else 8
    q, kp, vp, tables, lens = _case(6, (32, 17, 9, 1), hd=hd)
    q, kp, vp, tables, lens = map(_t, (q, kp, vp, tables, lens))
    if bad == "tables_dtype":
        tables = tables.long()
    elif bad == "pool_without_scales":
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
    elif bad == "misaligned_q":
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    elif bad == "strided_q":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        tpa._paged_cuda(q, kp, vp, tables, lens, None, None)
    assert tpa._fns is None


def test_kernel_source_and_build_are_deferred():
    """The CUDA source ships in the package, and nothing is compiled or
    loaded at import: the CPU tests import every module."""
    assert (tpa._build.CSRC / "paged_attention.cu").exists()
    assert tpa._fns is None
    assert tpa._build.library_path(tpa.KERNEL).name.startswith(
        "libpaged_attention-")


@pytest.mark.parametrize("mod,attr", [(tfa, "_fn"), (tqm, "_fns")])
def test_predict_kernel_sources_ship_and_build_is_deferred(mod, attr):
    assert (mod._build.CSRC / f"{mod.KERNEL}.cu").exists()
    assert getattr(mod, attr) is None
    assert mod._build.library_path(mod.KERNEL).name.startswith(
        f"lib{mod.KERNEL}-")


def _flash_args(bad):
    """q/k/v (B, H, T, D) views of one projection, with one defect."""
    d = 48 if bad == "head_dim" else 32
    qkv = torch.randn(2, 9, 3 * 2 * d)
    q, k, v = (t.unflatten(-1, (2, d)).transpose(1, 2)
               for t in qkv.split(2 * d, dim=-1))
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "d_stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "misaligned":
        buf = torch.zeros(q.numel() + 1)[1:]
        q = buf.view(2, 9, 2, d).transpose(1, 2)
    elif bad == "shape":
        k = k[:, :, :5]
    return q, k, v


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed_dtype",
                                 "d_stride", "misaligned", "shape"])
def test_flash_wrapper_rejects_what_the_kernel_cannot_take(bad):
    """Checked before anything is built or launched (on CPU tensors, which
    ``flash_attention`` itself would give the plain version)."""
    q, k, v = _flash_args(bad)
    with pytest.raises((ValueError, TypeError)):
        tfa._flash_cuda(q, k, v, True, 0.125, False, None)
    assert tfa._fn is None


@pytest.mark.parametrize("bad", ["x_dtype", "scale_dtype", "strided",
                                 "w4_dtype", "w4_x_dtype", "s_g_dtype"])
def test_quant_wrappers_reject_what_the_kernels_cannot_take(bad):
    x8 = torch.zeros(3, 8, dtype=torch.int8)
    w8 = torch.zeros(8, 5, dtype=torch.int8)
    x4, w4, sg = torch.zeros(3, 8), torch.zeros(4, 5, dtype=torch.uint8), \
        torch.ones(2, 5)
    with pytest.raises((ValueError, TypeError)):
        if bad == "x_dtype":
            tqm._w8a8_cuda(x8.float(), w8, torch.ones(5))
        elif bad == "scale_dtype":
            tqm._w8a8_cuda(x8, w8, torch.ones(5, dtype=torch.float64))
        elif bad == "strided":
            tqm._w8a8_cuda(x8, w8.t().contiguous().t(), torch.ones(5))
        elif bad == "w4_dtype":
            tqm._w4a16_cuda(x4, w4.to(torch.int8), sg)
        elif bad == "w4_x_dtype":
            tqm._w4a16_cuda(x4.half(), w4, sg)
        else:
            tqm._w4a16_cuda(x4, w4, sg.double())
    assert tqm._fns is None


@pytest.mark.parametrize("use_flash,head_dim,dtype,mask,dropping,want",
                         [(None, 64, torch.float32, None, False, True),
                          (None, 128, torch.bfloat16, None, False, True),
                          (None, 32, torch.float32, None, False, True),
                          (None, 48, torch.float32, None, False, False),
                          (None, 64, torch.float16, None, False, False),
                          (None, 64, torch.float32, "m", False, False),
                          (None, 64, torch.float32, None, True, False),
                          (True, 48, torch.float32, None, False, True),
                          (True, 64, torch.float32, "m", False, False),
                          (False, 64, torch.float32, None, False, False)])
def test_select_flash_takes_the_kernel_for_every_call_it_can_express(
        use_flash, head_dim, dtype, mask, dropping, want):
    """No T threshold (the TPU crossover is not carried over): an unmasked,
    dropout-free call at a built head_dim and dtype takes the flash path
    at any length, whatever device its tensors are on."""
    assert tatt._select_flash(use_flash, head_dim, dtype, mask,
                              dropping) is want


@pytest.mark.parametrize("front", ["bthd", "bhtd"])
def test_cpu_unmasked_attention_takes_the_plain_flash(monkeypatch, front):
    """On the CPU an unmasked call reaches ``flash_attention_torch``, the
    same plain version the card's checks hold the kernel against; the
    einsum path serves masked and dropout calls only."""
    seen = []
    plain = tfa.flash_attention_torch

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return plain(*args, **kwargs)
    monkeypatch.setattr(tfa, "flash_attention_torch", spy)
    q, k, v = (torch.randn(2, 16, 2, 32) for _ in range(3))
    if front == "bthd":
        out = tatt.attention_bthd(q, k, v, causal=True)
        ref = tatt._attention_torch_bthd(q, k, v, causal=True)
    else:
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        out = tatt.dot_product_attention(qh, kh, vh, causal=True)
        ref = tatt._attention_torch(qh, kh, vh, causal=True)
    assert seen == [(2, 2, 16, 32)]
    # the two plain versions differ only in summation order and mask fill
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    seen.clear()
    tatt.attention_bthd(q, k, v, mask=torch.ones(16, 16), causal=True)
    assert seen == []


class _KernelDown(RuntimeError):
    pass


@pytest.mark.parametrize("front", ["bthd", "bhtd"])
def test_selected_flash_kernel_failure_propagates(monkeypatch, front):
    """A selected kernel that fails raises through the attention front-end:
    nothing catches it and slides onto the plain path.  The CUDA route is
    stubbed: the resolver answers "cuda" and the launcher raises."""
    def down(*args, **kwargs):
        raise _KernelDown("launch failed")
    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, x: "cuda")
    monkeypatch.setattr(tfa, "_flash_cuda", down)
    q, k, v = (torch.randn(2, 16, 2, 32) for _ in range(3))
    with pytest.raises(_KernelDown):
        if front == "bthd":
            tatt.attention_bthd(q, k, v, causal=True, use_flash=True)
        else:
            tatt.dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True,
                                       use_flash=True)


@pytest.mark.parametrize("bits", [8, 4])
def test_selected_quant_kernel_failure_propagates(monkeypatch, bits):
    """The same for a quantized Dense: its product goes to the kernel and
    a launch failure reaches the caller."""
    def down(*args, **kwargs):
        raise _KernelDown("launch failed")
    monkeypatch.setattr(tqm, "resolve_impl", lambda impl, x: "cuda")
    monkeypatch.setattr(tqm, "_w8a8_cuda" if bits == 8 else "_w4a16_cuda",
                        down)
    d = Dense(6, input_shape=(8,))
    leaves = {"W_q": np.ones((8, 6), np.int8), "s_w": np.ones(6, np.float32),
              "s_x": np.float32(0.1)} if bits == 8 else \
        {"W_q4": np.zeros((4, 6), np.uint8), "s_g": np.ones((1, 6),
                                                             np.float32)}
    leaves["b"] = np.zeros(6, np.float32)
    load_jax_params(d, leaves)
    with pytest.raises(_KernelDown):
        d(torch.randn(3, 8))
