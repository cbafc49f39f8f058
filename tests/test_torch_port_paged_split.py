"""PyTorch port: the paged-decode kernel's walk, partitions and merges, on
the CPU.

``csrc/paged_attention.cu`` splits a row's table into ``partitions``
(flash-decoding: one block of a thread-block cluster each), cuts each
partition's valid positions into chunks that its 8 warps take in turn,
runs an online softmax over each warp's chunks, merges the warps of a
block and then the blocks of a cluster.  The kernel cannot run here, so
this file models that order in float32 with helpers local to the test
(the port's plain version stays the gather + einsum + softmax it is) and
holds the model to the JAX package's ``paged_attention_xla`` at atol 1e-5
(the same f32 values summed in another order), for the partition counts
the kernel's rule picks and forced to many partitions.  The Pallas kernel
is reached only through ``paged_attention_xla``: its own parity tests in
``test_paged_kv.py`` need ``pltpu.TPUCompilerParams``, which this JAX
lacks.  The card tests (``test_torch_port_card.py``) hold the kernel
itself to the plain version at the same kinds of lengths.
"""

import math

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import quantize as jq
from analytics_zoo_tpu.ops import paged_attention as jpa
from analytics_zoo_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

ATOL = 1e-5
# the kernel's block: warps a block; 16-byte lane loads (4 f32 elements, up
# to 16 int8 ones), 4 (f32) or 3 (int8) loads of K a chunk
WARPS = 8


def _chunk(head_dim, quant):
    vec = min(head_dim, 16) if quant else 4
    return (32 // (head_dim // vec)) * (3 if quant else 4)


def _case(seed, lengths, rows=6, n_table=12, bl=8, nh=2, hd=8):
    """Random pool with garbage in the trash block (0) and every
    unreferenced block; tail entries on block 0; the last two rows share
    their first two blocks."""
    g = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_blocks = 1 + rows * n_table
    perm = g.permutation(np.arange(1, n_blocks)).reshape(rows, n_table)
    tables = np.zeros((rows, n_table), np.int32)
    for a in range(rows):
        used = -(-int(lengths[a]) // bl)
        tables[a, :used] = perm[a, :used]
    tables[rows - 1, :2] = tables[rows - 2, :2]
    q = np.asarray(g.normal(size=(rows, nh, hd)), np.float32)
    kp = np.asarray(g.normal(size=(n_blocks, bl, nh, hd)), np.float32)
    vp = np.asarray(g.normal(size=(n_blocks, bl, nh, hd)), np.float32)
    return q, kp, vp, tables, lengths


def _merge(parts):
    """(max, sum, accumulator) partials -> one; a partial with max -inf
    (it saw no valid position) counts for nothing."""
    mx = max(m for m, _, _ in parts)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros(())
    for m, l, acc in parts:
        if m == -math.inf:
            continue
        c = torch.exp(torch.tensor(m - mx, dtype=torch.float32))
        num = num + acc * c
        den = den + l * c
    return mx, den, num


def _kernel_model(q, kp, vp, tables, lengths, ks=None, vs=None, parts=None):
    """The kernel's order in float32: partitions of ``tpa.partitions``'
    entries, each partition's positions [p0, p1) below the length in chunks
    warp w takes at w, w + 8, ...; an online softmax a warp; the warps of a
    partition merged, then the partitions."""
    q, kp, vp = (torch.from_numpy(np.asarray(a)) for a in (q, kp, vp))
    quant = ks is not None
    if quant:
        ks, vs = torch.from_numpy(np.asarray(ks)), torch.from_numpy(
            np.asarray(vs))
    rows, nh, hd = q.shape
    bl = kp.shape[1]
    n_table = tables.shape[1]
    n_parts, per = tpa.partitions(n_table, parts)
    chunk = _chunk(hd, quant)
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(rows, nh, hd)
    for a in range(rows):
        n = int(lengths[a])
        uniform = n <= 0
        if uniform or n > n_table * bl:
            n = n_table * bl
        for h in range(nh):
            partials = []
            for p in range(n_parts):
                e0 = p * per
                p0 = e0 * bl
                p1 = min(n, (e0 + min(per, n_table - e0)) * bl)
                warps = []
                for w in range(WARPS):
                    m, l, acc = -math.inf, torch.zeros(()), torch.zeros(hd)
                    for pc in range(p0 + w * chunk, p1, WARPS * chunk):
                        js = np.arange(pc, min(pc + chunk, p1))
                        blk = torch.from_numpy(tables[a, js // bl].astype(
                            np.int64))
                        slot = torch.from_numpy(js % bl)
                        k = kp[blk, slot, h].float()
                        v = vp[blk, slot, h].float()
                        s = k @ q[a, h]
                        if quant:
                            s = s * ks[blk, h]
                            v = v * vs[blk, h][:, None]
                        s = torch.zeros_like(s) if uniform else s * scale
                        m_new = max(m, float(s.max()))
                        alpha = torch.exp(torch.tensor(m - m_new))
                        pr = torch.exp(s - m_new)
                        acc = acc * alpha + pr @ v
                        l = l * alpha + pr.sum()
                        m = m_new
                    warps.append((m, l, acc))
                partials.append(_merge(warps))
            _, den, num = _merge(partials)
            out[a, h] = num / den
    return out.numpy()


def _int8(kp, vp):
    qk, ks = (np.array(x) for x in jq.kv_pack_int8(kp))
    qv, vs = (np.array(x) for x in jq.kv_pack_int8(vp))
    return qk, qv, ks, vs


def test_partition_rule():
    """One partition a 16 entries (the decode path's tables take one), at
    most 8, and no more blocks than one wave of the card; a forced count is
    clamped and covers the table."""
    assert tpa.partitions(1) == (1, 1)
    assert tpa.partitions(16) == (1, 16)
    assert tpa.partitions(17) == (2, 9)
    assert tpa.partitions(64) == (4, 16)
    assert tpa.partitions(1000) == (8, 125)
    assert tpa.partitions(16, 8) == (8, 2)
    assert tpa.partitions(10, 8) == (5, 2)
    assert tpa.partitions(3, 8) == (3, 1)
    assert tpa.partitions(12, 0) == (1, 12)
    # one wave of 2 blocks an SM: 8 rows x 12 heads on 132 SMs take 2
    assert tpa.partitions(64, pairs=96) == (2, 32)
    assert tpa.partitions(1000, pairs=96) == (2, 500)
    assert tpa.partitions(64, pairs=300) == (1, 64)
    assert tpa.partitions(64, 4, pairs=300) == (4, 16)
    for n in range(1, 200):
        for forced in (None, 1, 3, 8, 50):
            parts, per = tpa.partitions(n, forced, pairs=n % 7 + 1)
            assert 1 <= parts <= tpa.MAX_PARTS
            assert (parts - 1) * per < n <= parts * per


# (lengths of 6 rows, n_table 12, block_len 8: partitions of 12 entries by
# the rule, 4 when forced to 3, 2 when forced to 6, 1 when forced to 12)
LENGTHS = {
    "uniform_and_one": (0, 1, 96, 40, 7, 9),        # 0: over the whole table
    "partition_edges": (31, 32, 33, 63, 64, 65),    # +-1 of 32 and 64
    "past_the_table": (200, 97, 95, 16, 48, 50),
}


@pytest.mark.parametrize("parts", [None, 3, 6, 12])
@pytest.mark.parametrize("tag", sorted(LENGTHS))
@pytest.mark.parametrize("quant", [False, True])
def test_partitioned_walk_matches_jax(quant, tag, parts):
    q, kp, vp, tables, lens = _case(len(tag) + (parts or 0), LENGTHS[tag])
    if quant:
        kp, vp, ks, vs = _int8(kp, vp)
        want = jpa.paged_attention_xla(q, kp, vp, tables, lens, k_scale=ks,
                                       v_scale=vs)
        got = _kernel_model(q, kp, vp, tables, lens, ks, vs, parts=parts)
    else:
        want = jpa.paged_attention_xla(q, kp, vp, tables, lens)
        got = _kernel_model(q, kp, vp, tables, lens, parts=parts)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd", tpa.KERNEL_HEAD_DIMS)
def test_every_head_dim_and_chunk_matches_jax(hd, quant):
    """Every head_dim the kernel takes, whose chunk runs from 4 positions
    (f32, 128) to 96 (int8, 4), with the rule's partitions and 5 forced."""
    q, kp, vp, tables, lens = _case(hd, (0, 1, 47, 48, 49, 95), nh=1,
                                    hd=hd)
    kw = {}
    if quant:
        kp, vp, ks, vs = _int8(kp, vp)
        kw = {"k_scale": ks, "v_scale": vs}
    want = np.asarray(jpa.paged_attention_xla(q, kp, vp, tables, lens, **kw))
    for parts in (None, 5):
        got = _kernel_model(q, kp, vp, tables, lens, kw.get("k_scale"),
                            kw.get("v_scale"), parts=parts)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_empty_partitions_contribute_nothing():
    """Forced to 12 partitions of one entry, a row of length 1 has 11
    partitions with no valid position; its output is its one value row."""
    q, kp, vp, tables, lens = _case(7, (1, 1, 8, 9, 2, 3))
    got = _kernel_model(q, kp, vp, tables, lens, parts=12)
    for a in range(2):
        np.testing.assert_allclose(got[a], vp[tables[a, 0], 0], rtol=0,
                                   atol=ATOL)
    want = np.asarray(jpa.paged_attention_xla(q, kp, vp, tables, lens))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
