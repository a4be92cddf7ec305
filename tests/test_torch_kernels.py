"""The port's two hand-kernel wrappers against the JAX package's Pallas
kernels (interpret mode off-TPU) and its host f64 entropy route.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
kernel-vs-plain cases are in tests/test_torch_cuda.py.
"""

from typing import Sequence, Tuple

import numpy as np
import pytest
import torch

from delphi_tpu.ops import pallas_kernels as pk
from delphi_tpu.ops.entropy import _entropy_with_correction
from delphi_tpu_torch.ops.entropy import _with_correction
from delphi_tpu_torch.ops.kernels import entropy as k_entropy
from delphi_tpu_torch.ops.kernels import pair_counts as k_pair

# (n, vx, vy): tests/test_pallas.py's cases plus the widest vocabulary the
# Pallas kernel takes (2047 values + the NULL slot = 2048)
PAIR_CASES = [(1, 1, 1), (100, 3, 5), (513, 7, 7), (2000, 40, 17),
              (2000, 2047, 2047)]


def _codes(rng, n, v, null_frac=0.1):
    c = rng.integers(0, v, n).astype(np.int32)
    c[rng.random(n) < null_frac] = -1
    return c


def _torch_pair(x, y, vx, vy):
    codes = torch.from_numpy(np.stack([x, y]))
    flat, off = k_pair.pair_counts(codes, [(0, 1)], [vx, vy])
    return flat.numpy()[off[0]:off[1]].reshape(vx + 1, vy + 1)


@pytest.mark.parametrize("n,vx,vy", PAIR_CASES)
def test_pair_counts_plain_matches_pallas(n, vx, vy):
    rng = np.random.default_rng(n + vx)
    x, y = _codes(rng, n, vx), _codes(rng, n, vy)
    want = pk.pallas_pair_counts(x, y, vx, vy)
    got = _torch_pair(x, y, vx, vy)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n


def test_pair_counts_all_null():
    x = np.full(50, -1, dtype=np.int32)
    y = np.full(50, -1, dtype=np.int32)
    got = _torch_pair(x, y, 4, 4)
    np.testing.assert_array_equal(got, pk.pallas_pair_counts(x, y, 4, 4))
    assert got[0, 0] == 50 and got.sum() == 50


def test_pair_counts_batch_offsets():
    """Several pairs in one call come back cut by their offsets, in pair
    order, each equal to its own single-pair count."""
    rng = np.random.default_rng(5)
    vocab = [3, 9, 1, 30]
    cols = np.stack([_codes(rng, 777, v) for v in vocab])
    pairs = [(0, 1), (2, 3), (3, 0), (1, 1)]
    flat, off = k_pair.pair_counts(torch.from_numpy(cols), pairs, vocab)
    assert len(off) == len(pairs) + 1 and off[-1] == flat.numel()
    for p, (a, b) in enumerate(pairs):
        got = flat.numpy()[off[p]:off[p + 1]].reshape(vocab[a] + 1,
                                                      vocab[b] + 1)
        np.testing.assert_array_equal(
            got, pk.pallas_pair_counts(cols[a], cols[b], vocab[a], vocab[b]))


def _count_segments(rng):
    mats = [rng.integers(0, 100, size=(13, 29)),
            rng.integers(0, 5, size=(1, 1)),
            np.zeros((4, 4), dtype=np.int64),
            rng.integers(0, 3000, size=(41, 7))]
    for m in mats:
        m[m < 30] = 0
    flat = np.concatenate([m.ravel() for m in mats]).astype(np.int32)
    off = np.concatenate([[0], np.cumsum([m.size for m in mats])])
    return mats, flat, off


def test_entropy_plain_matches_pallas():
    """The Pallas kernel reduces in f32, so 1e-4 absolute is its own
    precision (tests/test_pallas.py holds it to the same)."""
    rng = np.random.default_rng(3)
    mats, flat, off = _count_segments(rng)
    n_rows = int(flat.sum()) + 500
    h, tot, nnz = k_entropy.entropy_terms(torch.from_numpy(flat), off, n_rows)
    assert h.dtype == torch.float64 and tot.dtype == torch.int64
    for s, m in enumerate(mats):
        ph, ptot, pnnz = pk.pallas_entropy_terms(m.astype(np.float64), n_rows)
        assert abs(float(h[s]) - ph) < 1e-4
        assert int(tot[s]) == int(ptot) == int(m.sum())
        assert int(nnz[s]) == pnnz == int((m > 0).sum())


def test_entropy_plain_matches_host_f64(monkeypatch):
    """Corrected entropies against the JAX host f64 route within 1e-12
    relative: both are f64, only the summation order differs."""
    monkeypatch.setenv("DELPHI_PALLAS", "0")
    rng = np.random.default_rng(4)
    mats, flat, off = _count_segments(rng)
    n_rows = int(flat.sum()) + 777
    h, tot, nnz = k_entropy.entropy_terms(torch.from_numpy(flat), off, n_rows)
    for s, m in enumerate(mats):
        ub = int(m.size) * 3
        want = _entropy_with_correction(m, n_rows, ub)
        got = _with_correction(float(h[s]), int(tot[s]), int(nnz[s]),
                               n_rows, ub)
        assert abs(got - want) <= 1e-12 * max(abs(want), 1e-300)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card reaches no plain
    version: the wrapper raises."""
    codes = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k_pair.pair_counts(codes, [(0, 1)], [1, 1])
    with pytest.raises(ValueError):
        k_entropy.entropy_terms(torch.zeros(4, dtype=torch.int32,
                                            device="meta"), [0, 4], 4)



# -- launch planning (pure Python; the card runs what these plans say) ------

def _random_pairs(rng, m, n_pairs):
    return [tuple(int(v) for v in rng.integers(0, m, 2))
            for _ in range(n_pairs)]


@pytest.mark.parametrize("m,n_pairs,vmax", [
    (5, 9, 10), (8, 28, 200), (17, 136, 20), (40, 300, 60), (3, 1, 2047),
    (30, 129, 3)])
def test_pair_launch_plan_covers_output_once(m, n_pairs, vmax):
    """Launches take consecutive pairs, at most MAX_PAIRS over at most
    MAX_COLS columns each; their output ranges tile the flat output exactly
    once; shared offsets never overlap and fit the block."""
    rng = np.random.default_rng(m * 1000 + n_pairs)
    vocab = tuple(int(v) for v in rng.integers(1, vmax + 1, m))
    pairs = tuple(_random_pairs(rng, m, n_pairs))
    plan = k_pair.plan_launches(pairs, vocab)
    off = k_pair.matrix_offsets(pairs, vocab)
    covered = np.zeros(int(off[-1]), dtype=np.int64)
    stop = 0
    for ln in plan:
        assert ln.first == stop and ln.stop > ln.first
        stop = ln.stop
        group = pairs[ln.first:ln.stop]
        assert len(group) <= k_pair.MAX_PAIRS
        assert set(ln.cols) == {c for p in group for c in p}
        assert len(ln.cols) <= k_pair.MAX_COLS
        covered[off[ln.first]:off[ln.stop]] += 1
        sizes = np.diff(off[ln.first:ln.stop + 1])
        used = np.zeros(ln.hist_bins, dtype=np.int64)
        for s, size in zip(ln.smem_off, sizes):
            if s >= 0:
                used[s:s + size] += 1
        assert (used == 1).all()
        assert ln.smem_bytes <= 227 * 1024
    assert stop == len(pairs)
    assert (covered == 1).all()
    if n_pairs > k_pair.MAX_PAIRS:
        assert len(plan) > 1


@pytest.mark.parametrize("m,n_pairs", [(5, 9), (17, 136), (16, 128)])
def test_pair_table_matches_documented_layout(m, n_pairs):
    """The ctypes table has the byte layout csrc/pair_counts.cu documents,
    stays within the 4 KB parameter limit, and carries the plan."""
    import ctypes
    assert ctypes.sizeof(k_pair.PairEntry) == 24
    assert ctypes.sizeof(k_pair.PairTable) == 3176 <= 4096
    layout = {"codes": 0, "out": 8, "n_rows": 16, "n_pairs": 24,
              "n_cols": 28, "hist_bins": 32, "pad": 36, "cols": 40,
              "pairs": 104}
    for name, at in layout.items():
        assert getattr(k_pair.PairTable, name).offset == at
    entry = {"out_off": 0, "smem_off": 8, "wy": 12, "bins": 16, "xs": 20,
             "ys": 21}
    for name, at in entry.items():
        assert getattr(k_pair.PairEntry, name).offset == at
    rng = np.random.default_rng(m)
    vocab = [int(v) for v in rng.integers(1, 30, m)]
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)][:n_pairs]
    off = k_pair.matrix_offsets(pairs, vocab)
    plan = k_pair.plan_launches(tuple(pairs), tuple(vocab))
    tables = k_pair.pack_tables(pairs, vocab, 0x1000, 0x2000, 12345)
    assert len(tables) == len(plan)
    for ln, t in zip(plan, tables):
        raw = bytes(t)
        assert np.frombuffer(raw[0:16], np.uint64).tolist() == [0x1000,
                                                                 0x2000]
        assert np.frombuffer(raw[16:24], np.int64)[0] == 12345
        head = np.frombuffer(raw[24:40], np.int32)
        assert head.tolist() == [ln.stop - ln.first, len(ln.cols),
                                 ln.hist_bins, 0]
        assert np.frombuffer(raw[40:104], np.int32)[:len(ln.cols)].tolist() \
            == list(ln.cols)
        for k, p in enumerate(range(ln.first, ln.stop)):
            e = raw[104 + 24 * k:128 + 24 * k]
            x, y = pairs[p]
            assert np.frombuffer(e[0:8], np.int64)[0] == off[p]
            assert np.frombuffer(e[8:20], np.int32).tolist() == [
                ln.smem_off[k], vocab[y] + 1, int(off[p + 1] - off[p])]
            assert ln.cols[e[20]] == x and ln.cols[e[21]] == y


LANES = 32


def _chunk_ranges(offsets: np.ndarray, chunk_base: np.ndarray, chunk: int) \
        -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(segment, lo, hi) of every chunk, as the K2 kernel's warps derive them:
    chunk j of segment s covers ``[off[s] + j*chunk, min(off[s+1], ...))``."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n_chunks = int(chunk_base[-1])
    w = np.arange(n_chunks, dtype=np.int64)
    seg = np.searchsorted(chunk_base, w, side="right") - 1
    lo = offsets[seg] + (w - chunk_base[seg]) * chunk
    hi = np.minimum(offsets[seg + 1], lo + chunk)
    return seg, lo, hi


def _tree(x: torch.Tensor) -> torch.Tensor:
    """The kernel's shuffle tree over the last axis (32 lanes): lane i adds
    lane i + o for o = 16, 8, 4, 2, 1; lane 0's sum."""
    x = x.clone()
    o = LANES // 2
    while o:
        x[..., :o] = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x[..., 0]


def _entropy_emulated(counts: torch.Tensor, offsets: Sequence[int],
                           n_rows: int, chunk: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's two-level reduction replayed in torch: the chunk plan, each
    count on the lane the kernel's head/int4-body/tail split gives it (for a
    16-byte-aligned buffer), each lane's sum in index order, the lane tree
    per chunk, then per segment the lane-strided sum of its chunk partials
    in chunk order and the same tree."""
    off = np.asarray(offsets, dtype=np.int64)
    n_seg = len(off) - 1
    dev = counts.device
    chunk_base = k_entropy.plan_chunks(off, chunk)
    seg, lo, hi = _chunk_ranges(off, chunk_base, chunk)
    n_chunks = len(seg)
    part_h = torch.zeros((n_chunks, LANES), dtype=torch.float64, device=dev)
    part_t = torch.zeros((n_chunks, LANES), dtype=torch.int64, device=dev)
    part_n = torch.zeros((n_chunks, LANES), dtype=torch.int64, device=dev)
    for w in range(n_chunks):
        a = min(int(hi[w]), -(-int(lo[w]) // 4) * 4)
        b = a + (int(hi[w]) - a) // 4 * 4
        idx = torch.arange(int(lo[w]), int(hi[w]), device=dev)
        lane = torch.where(idx < a, idx - int(lo[w]),
                           torch.where(idx < b, ((idx - a) // 4) % LANES,
                                       idx - b))
        c = counts[int(lo[w]):int(hi[w])]
        nz = c > 0
        p = torch.where(nz, c.double(),
                        torch.ones_like(c, dtype=torch.float64)) / n_rows
        terms = torch.where(nz, p * torch.log2(p), torch.zeros_like(p))
        for ln in range(LANES):  # each lane's sum in index order
            sel = lane == ln
            acc = torch.zeros((), dtype=torch.float64, device=dev)
            for v in terms[sel]:
                acc = acc + v
            part_h[w, ln] = acc
            part_t[w, ln] = c[sel].long().sum()
            part_n[w, ln] = nz[sel].long().sum()
    ch_h, ch_t, ch_n = _tree(part_h), _tree(part_t), _tree(part_n)
    h = torch.empty(n_seg, dtype=torch.float64, device=dev)
    total = torch.empty(n_seg, dtype=torch.int64, device=dev)
    nnz = torch.empty(n_seg, dtype=torch.int64, device=dev)
    for s in range(n_seg):
        cb, k = int(chunk_base[s]), int(chunk_base[s + 1] - chunk_base[s])
        if k == 1:
            sh, st, sn = ch_h[cb], ch_t[cb], ch_n[cb]
        else:
            lanes_h = torch.zeros(LANES, dtype=torch.float64, device=dev)
            lanes_t = torch.zeros(LANES, dtype=torch.int64, device=dev)
            lanes_n = torch.zeros(LANES, dtype=torch.int64, device=dev)
            for i in range(k):  # lane i % 32 adds partial i, in chunk order
                lanes_h[i % LANES] += ch_h[cb + i]
                lanes_t[i % LANES] += ch_t[cb + i]
                lanes_n[i % LANES] += ch_n[cb + i]
            sh, st, sn = _tree(lanes_h), _tree(lanes_t), _tree(lanes_n)
        h[s], total[s], nnz[s] = 0.0 - sh, st, sn
    return h, total, nnz


@pytest.mark.parametrize("offsets,chunk", [
    ([0, 5], 4), ([0, 0, 0], 8), ([0, 3, 3, 64, 65, 200], 16),
    ([7, 7, 1031, 1032, 5000], 1024), (list(range(0, 4101, 41)), 2048)])
def test_entropy_chunk_plan_tiles_segments(offsets, chunk):
    """Chunks tile each segment exactly, in order, at most ``chunk`` counts
    each; an empty segment keeps one empty chunk."""
    off = np.asarray(offsets, dtype=np.int64)
    base = k_entropy.plan_chunks(off, chunk)
    seg, lo, hi = _chunk_ranges(off, base, chunk)
    assert base[0] == 0 and len(base) == len(off)
    for s in range(len(off) - 1):
        mine = np.flatnonzero(seg == s)
        assert len(mine) >= 1
        assert mine.tolist() == list(range(base[s], base[s + 1]))
        assert lo[mine[0]] == off[s] and hi[mine[-1]] == off[s + 1]
        assert (lo[mine[1:]] == hi[mine[:-1]]).all()
        sizes = (hi - lo)[mine]
        assert (sizes <= chunk).all() and (sizes >= 0).all()
        if off[s + 1] == off[s]:
            assert len(mine) == 1


@pytest.mark.parametrize("total,chunk", [
    (0, 256), (55, 256), (424, 256), (65_536, 256), (256 * 2048 + 1, 512),
    (2048 * 2048, 2048), (10**9, 8192)])
def test_entropy_chunk_length_adapts_to_the_call(total, chunk):
    """About TARGET_CHUNKS chunks per call, a power of two in
    [MIN_CHUNK, MAX_CHUNK]."""
    assert k_entropy.chunk_length(np.array([0, total])) == chunk


def test_entropy_table_matches_documented_layout():
    """The ctypes table has the layout csrc/entropy.cu documents and stays
    within the 4 KB parameter limit; its mode follows the segments."""
    import ctypes
    assert ctypes.sizeof(k_entropy.EntropyTable) == 3208 <= 4096
    layout = {"counts": 0, "h": 8, "total": 16, "nnz": 24, "part_h": 32,
              "part_total": 40, "part_nnz": 48, "tickets": 56,
              "table_dev": 64, "n_rows": 72, "base": 80, "stride": 88,
              "chunk": 96, "n_segments": 104, "n_chunks": 108,
              "chunks_per_segment": 112, "mode": 116, "table": 120}
    for name, at in layout.items():
        assert getattr(k_entropy.EntropyTable, name).offset == at
    counts = torch.zeros(10_000, dtype=torch.int32)
    uniform, _ = k_entropy.pack_table(counts, np.arange(6) * 1000, 10)
    assert (uniform.mode, uniform.base, uniform.stride,
            uniform.chunks_per_segment, uniform.n_chunks) \
        == (0, 0, 1000, 4, 20)
    off = np.array([0, 3, 3, 5000, 9000])
    inline, _ = k_entropy.pack_table(counts, off, 10)
    base = k_entropy.plan_chunks(off, k_entropy.chunk_length(off))
    assert inline.mode == 1 and inline.n_chunks == int(base[-1])
    assert list(inline.table[:10]) == off.tolist() + base.tolist()
    assert inline.tickets != 0            # 5000 counts cross a chunk edge
    # past the inline capacity the table goes up from pinned memory, so
    # only the plan is checked here
    many = np.r_[np.arange(0, 9_960, 40), 9_999].astype(np.int64)
    chunk = k_entropy.chunk_length(many)
    raw, host_table, n_chunks, _ = k_entropy._plan(many.tobytes(), chunk)
    planned = k_entropy.EntropyTable.from_buffer_copy(raw)
    assert planned.mode == 2 and planned.n_segments == len(many) - 1
    np.testing.assert_array_equal(
        host_table, np.r_[many, k_entropy.plan_chunks(many, chunk)])
    assert n_chunks == len(many) - 1


@pytest.mark.parametrize("offsets", [[0, 5, 3], [-1, 4], [0]])
def test_entropy_plan_rejects_bad_offsets(offsets):
    """Descending, negative or segment-less offsets never reach a launch."""
    with pytest.raises(ValueError):
        k_entropy._plan(np.asarray(offsets, dtype=np.int64).tobytes(), 256)


def _emulation_case(rng, lengths, density=0.4):
    flat = np.where(rng.random(sum(lengths)) < density,
                    rng.integers(1, 3000, sum(lengths)), 0).astype(np.int32)
    return flat, np.concatenate([[0], np.cumsum(lengths)])


@pytest.mark.parametrize("lengths,chunk", [
    ([70, 0, 1, 129, 64], 32), ([1000], 64), ([3, 0, 0, 517, 2], 16),
    ([300, 300, 300], 128)])
def test_entropy_two_level_reduction_matches_plain(lengths, chunk):
    """K2's chunk partials and fixed-order finish, replayed in torch on
    segments that cross chunk edges, agree with the plain version: totals
    equal, h within 1e-12 relative."""
    rng = np.random.default_rng(sum(lengths) + chunk)
    flat, off = _emulation_case(rng, lengths)
    n_rows = int(flat.sum()) + 1000
    counts = torch.from_numpy(flat)
    he, te, ne = _entropy_emulated(counts, off, n_rows, chunk)
    hp, tp, np_ = k_entropy.entropy_terms_plain(counts, off, n_rows)
    assert torch.equal(te, tp) and torch.equal(ne, np_)
    assert torch.allclose(he, hp, rtol=1e-12, atol=0.0)
    he2, _, _ = _entropy_emulated(counts, off, n_rows, chunk)
    assert torch.equal(he, he2)


def test_entropy_to_host_is_one_packed_copy():
    h = torch.tensor([0.5, -0.0, 1e-300], dtype=torch.float64)
    total = torch.tensor([1, 2, 3])
    nnz = torch.tensor([4, 5, 6])
    got = k_entropy.to_host(h, total, nnz)
    np.testing.assert_array_equal(got[0], h.numpy())
    np.testing.assert_array_equal(got[1], [1, 2, 3])
    np.testing.assert_array_equal(got[2], [4, 5, 6])
