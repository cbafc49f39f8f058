"""PyTorch port: the data movement of the ``w8a8`` CUDA kernel, on the CPU.

``csrc/quant_matmul.cu`` runs w8a8 on the tensor cores as s8 ``mma.sync``
m16n8k32 with the operands swapped (out^T = W^T·x^T), over a ``cp.async``
ring of 64-row chunks whose rows are 16-byte aligned supersets of a
block's columns, read at each row's byte offset with a funnel shift and
transposed in registers with ``__byte_perm``; lane group t takes rows
16t .. 16t + 15 of a chunk, so x's fragments of both k-steps are one
16-byte load.  The kernel cannot run here, so this file replays what it
does, lane by lane, in numpy:

- the ring's copies (``copy16``: whole 16-byte copies, byte copies before a
  weight base off 16 bytes, zero fill past the end), into slots that start
  with garbage and keep stale rows;
- x staged zero past K and past M;
- each lane's word loads, funnel shifts and 4 x 4 byte transposes;
- every ``mma`` through the PTX ISA's fragment layouts for m16n8k32 s8
  (which register of which lane holds which element of A, B and C),
  independent of the kernel's choice of rows and columns;
- the epilogue: one int32 -> f32 conversion and one f32 multiply into an
  output tile, stored a row at a time.

The replay must be BITWISE equal to the JAX package's
``w8a8_matmul_pallas`` (interpret mode) and to the port's plain version;
the same replay with x's two k-steps swapped must not be.  The kernel's
constants are read from the source, and its shared-memory loads are
checked for bank conflicts.
"""

import re

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


def _constants():
    """The kernel's ``constexpr int kW8*`` values, from the source."""
    src = (_build.CSRC / f"{tqm.KERNEL}.cu").read_text()
    out = {}
    for name, expr in re.findall(r"constexpr int (kW8\w+) = ([^;]+);", src):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


C = _constants()
THREADS, BN, KC = C["kW8Threads"], C["kW8BN"], C["kW8KC"]
COPIES, PITCH, GROUP = C["kW8Copies"], C["kW8Pitch"], C["kW8Group"]
STAGE, STAGES = C["kW8Stage"], C["kW8Stages"]
XSEG, XPITCH, OPITCH = C["kW8XSeg"], C["kW8XPitch"], C["kW8OPitch"]
WARPS = THREADS // 32
LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def _mt(m):
    """m-tiles a block, as ``w8a8_matmul`` picks them."""
    return min(-(-m // 8), 8)


def _word(buf, off, rows=None):
    """Little-endian uint32 at byte offsets ``off`` (array) of ``buf``,
    or of rows ``rows`` of a 2-D ``buf``."""
    cols = off[:, None] + np.arange(4)
    b = (buf[cols] if rows is None else buf[rows[:, None], cols])
    b = b.astype(np.uint64)
    return (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24)


def _funnel_r(lo, hi, sh):
    return ((hi << 32 | lo) >> (sh & 31)) & 0xFFFFFFFF


def _byte_perm(x, y, sel):
    both = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                    + [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= both[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _transpose4(r):
    s0 = _byte_perm(r[0], r[1], 0x5140)
    s1 = _byte_perm(r[0], r[1], 0x7362)
    s2 = _byte_perm(r[2], r[3], 0x5140)
    s3 = _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(s0, s2, 0x5410), _byte_perm(s0, s2, 0x7632),
            _byte_perm(s1, s3, 0x5410), _byte_perm(s1, s3, 0x7632)]


def _s8(word, j):
    return ((word >> (8 * j)) & 0xFF).astype(np.int64) - \
        (((word >> (8 * j + 7)) & 1) << 8).astype(np.int64)


def _mma(acc, a, b):
    """m16n8k32 s8 x s8 + s32 by the PTX ISA's fragment layouts: A reg r
    byte j of lane (g, t) is A[g + 8 (r & 1), 4t + j + 16 (r >> 1)]; B reg
    r byte j is B[4t + j + 16 r, g]; C element e is C[g + 8 (e >> 1),
    2t + (e & 1)]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    Cm = np.zeros((16, 8), np.int64)
    for j in range(4):
        for r in range(4):
            A[G + 8 * (r & 1), 4 * T + j + 16 * (r >> 1)] = _s8(a[r], j)
        for r in range(2):
            B[4 * T + j + 16 * r, G] = _s8(b[r], j)
    for e in range(4):
        Cm[G + 8 * (e >> 1), 2 * T + (e & 1)] = acc[e]
    D = Cm + A @ B
    return [D[G + 8 * (e >> 1), 2 * T + (e & 1)] for e in range(4)]


def _copy16(slot, d, arena, a, lo, hi):
    if a >= lo and a + 16 <= hi:
        slot[d:d + 16] = arena[a:a + 16]
    elif a < lo < a + 16:
        for b in range(16):
            if lo <= a + b < hi:
                slot[d + b] = arena[a + b]
    elif a < hi < a + 16:
        n = hi - a
        slot[d:d + n] = arena[a:a + n]
        slot[d + n:d + 16] = 0


def replay(x, w, scale, w_offset=0, swap_ksteps=False, seed=0):
    """The kernel's output for int8 ``x`` (M, K), ``w`` (K, N) placed
    ``w_offset`` bytes past a 256-byte boundary, f32 ``scale`` (N,)."""
    g = np.random.default_rng(seed)
    M, K = x.shape
    N = w.shape[1]
    mt = _mt(M)
    mr = 8 * mt
    pad = 256
    arena = g.integers(0, 256, pad + w_offset + K * N + pad, dtype=np.uint8)
    wbase = pad + w_offset
    wend = wbase + K * N
    arena[wbase:wend] = w.view(np.uint8).ravel()
    out = np.full((M, N), np.nan, np.float32)
    nchunks = -(-K // KC)
    for by in range(-(-M // mr)):
        m0 = by * mr
        for bx in range(-(-N // BN)):
            n0 = bx * BN
            ring = g.integers(0, 256, (STAGES, STAGE), dtype=np.uint8)
            xs = np.zeros((mr, XPITCH), np.uint8)
            lo = (wbase + np.arange(16) * N + n0) & 15
            uoff = np.arange(16) * PITCH + (lo & ~3)
            sh = (8 * (lo & 3)).astype(np.uint64)
            acc = np.zeros((WARPS, 2, mt, 4, 32), np.int64)
            seg = -1
            for c in range(nchunks):
                k0 = c * KC
                if k0 // XSEG != seg:
                    seg = k0 // XSEG
                    xs[:] = 0
                    rows = x[m0:m0 + mr, seg * XSEG:(seg + 1) * XSEG]
                    xs[:rows.shape[0], :rows.shape[1]] = rows.view(np.uint8)
                slot = ring[c % STAGES]
                for r in range(min(KC, K - k0)):
                    start = (wbase + (k0 + r) * N + n0) & ~15
                    for q in range(COPIES):
                        _copy16(slot, (r >> 4) * GROUP + (r & 15) * PITCH
                                + 16 * q, arena, start + 16 * q, wbase, wend)
                xk = k0 - seg * XSEG
                for wp in range(WARPS):
                    lane_off = T * GROUP + wp * 32 + 4 * G
                    wv = [_funnel_r(_word(slot, lane_off + uoff[u]),
                                    _word(slot, lane_off + uoff[u] + 4),
                                    sh[u]) for u in range(16)]
                    a = [_transpose4(wv[4 * v:4 * v + 4]) for v in range(4)]
                    for j in range(mt):
                        b = [_word(xs, xk + 16 * T + 4 * q, 8 * j + G)
                             for q in range(4)]
                        if swap_ksteps:
                            b = b[2:] + b[:2]
                        for i in range(2):
                            for ks in range(2):
                                acc[wp, i, j] = _mma(
                                    acc[wp, i, j],
                                    [a[2 * ks][2 * i], a[2 * ks][2 * i + 1],
                                     a[2 * ks + 1][2 * i],
                                     a[2 * ks + 1][2 * i + 1]],
                                    [b[2 * ks], b[2 * ks + 1]])
            # the output tile (rows 8j + 2t + (e & 1), block columns), then
            # out a row at a time
            ot = np.full((mr, OPITCH), np.nan, np.float32)
            for wp in range(WARPS):
                cw = wp * 32 + 4 * G
                for i in range(2):
                    for e in range(4):
                        col = cw + 2 * i + (e >> 1)
                        s = np.where(n0 + col < N,
                                     scale[np.minimum(n0 + col, N - 1)], 0)
                        for j in range(mt):
                            v = acc[wp, i, j, e]
                            assert np.all(np.abs(v) < 2 ** 31)
                            ot[8 * j + 2 * T + (e & 1), col] = (
                                v.astype(np.int32).astype(np.float32)
                                * s.astype(np.float32))
            rows, cols = min(mr, M - m0), min(BN, N - n0)
            out[m0:m0 + rows, n0:n0 + cols] = ot[:rows, :cols]
    return out


# (M, K, N, weight offset, extremes): one, two, three, five and eight
# m-tiles a block, and two blocks of rows (70); K < 32, ragged and odd K,
# K past one x segment (777); N below one mma tile, odd, past one block;
# weight bases off 16 bytes; all -128 / 127
CASES = [(1, 20, 1, 0, False), (8, 100, 61, 1, False),
         (9, 777, 15, 3, False), (20, 64, 200, 0, False),
         (33, 130, 385, 7, False), (64, 33, 17, 0, False),
         (70, 40, 30, 2, False), (5, 96, 193, 0, True),
         (8, 777, 40, 9, True)]


def _case(m, k, n, extremes, seed):
    g = np.random.default_rng(seed)
    if extremes:
        x = g.choice(np.array([-128, 127], np.int8), (m, k))
        w = g.choice(np.array([-128, 127], np.int8), (k, n))
    else:
        x = g.integers(-128, 128, (m, k), dtype=np.int8)
        w = g.integers(-128, 128, (k, n), dtype=np.int8)
    s = g.uniform(1e-4, 1e-2, n).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("m,k,n,offset,extremes", CASES)
def test_w8a8_replay_bitwise_vs_pallas_and_plain(m, k, n, offset, extremes):
    x, w, s = _case(m, k, n, extremes, m * 1000 + k + n)
    got = replay(x, w, s, w_offset=offset)
    want = np.asarray(jqm.w8a8_matmul_pallas(x, w, s, interpret=True))
    np.testing.assert_array_equal(got, want)
    plain = tqm.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, plain)


def test_w8a8_replay_sees_a_k_order_fault():
    """x's two k-steps swapped against the weight's: sums of other
    products, so the replay is sensitive to the k order it models."""
    x, w, s = _case(8, 100, 61, False, 5)
    want = np.asarray(jqm.w8a8_matmul_xla(x, w, s))
    assert not np.array_equal(replay(x, w, s, swap_ksteps=True), want)
    np.testing.assert_array_equal(replay(x, w, s), want)


def _distinct_banks(byte_offsets, width=4):
    """Every bank that the loads at ``byte_offsets`` (one per lane of a
    phase) touch is touched once."""
    banks = ((byte_offsets[:, None] + np.arange(0, width, 4)) // 4) % 32
    return len(np.unique(banks)) == banks.size


@pytest.mark.parametrize("n", [1, 15, 61, 50257, 50260, 1000])
@pytest.mark.parametrize("w_offset", [0, 1, 6])
def test_w8a8_shared_loads_are_free_of_bank_conflicts(n, w_offset):
    """The 16 word pairs a lane reads from a ring slot (each 32-bit load
    one wavefront for the warp: 32 distinct banks), and x's 16-byte loads
    (each quarter warp of 8 lanes: 32 distinct banks), at every block
    column offset the head has."""
    for n0 in (0, BN, 5 * BN):
        lo = (256 + w_offset + np.arange(16) * n + n0) & 15
        for wp in range(WARPS):
            lane_off = T * GROUP + wp * 32 + 4 * G
            for u in range(16):
                base = lane_off + u * PITCH + (lo[u] & ~3)
                assert _distinct_banks(base) and _distinct_banks(base + 4)
    for mt in range(1, 9):
        for j in range(mt):
            for xk in range(0, XSEG, KC):
                offs = (8 * j + G) * XPITCH + xk + 16 * T
                for q in range(4):
                    assert _distinct_banks(offs[8 * q:8 * q + 8], 16)


def test_w8a8_geometry_fits_two_blocks_an_sm():
    """Two blocks of 6 warps an SM at every m-tile count (227 KB of shared
    memory less 1 KB reserved a block), 192 columns a block: the head's
    262 blocks are one wave on 132 SMs."""
    for mt in range(1, 9):
        smem = 8 * mt * XPITCH + STAGES * STAGE
        assert 2 * (smem + 1024) <= 232448
        assert 8 * mt * OPITCH * 4 <= STAGES * STAGE
    assert -(-50257 // BN) <= 2 * 132
    assert BN == 32 * WARPS and COPIES * 16 >= BN + 15
    assert XSEG % KC == 0 and KC == 64
