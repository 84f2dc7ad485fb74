"""The block scorers' work lists (``pathway_tpu_torch/ops/score_blocks.py``)
on the CPU, against the reference's int8 host path.

The int8 kernel takes a list that grows with blocks and entries: per block
its payload pointers, row count and first tile, then the group offsets,
queries and columns. A tile finds its block by a binary search over the
first tiles. These tests walk that list in numpy exactly as the kernel's
producer walks it, and hold the walk against the fp32 kernel's list of
one word per 128-row tile, and its scores against the reference's
``approx_scores`` bit for bit. No tolerance: the int8 dot is exact
integers and the epilogue repeats the reference's order of operations."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn_quant as ref_quant
from pathway_tpu_torch.ops import knn_quant as port_quant
from pathway_tpu_torch.ops import score_blocks

torch.set_num_threads(1)

METRICS = ["l2sq", "cos", "ip"]
PAGE = port_quant.PAGE


def _blocks(rng, d, caps, probes, nq):
    """int8 blocks of ``caps`` rows (reference quantization, ~10% dead
    rows), block b probed by the queries ``probes[b]`` (possibly none),
    laid out as the store lays out a batch. Returns (int8 payloads, fp32
    payloads of the same row counts, host arrays, groups, width)."""
    quant, f32, host, offsets, gq, gcol = [], [], [], [0], [], []
    widths = np.zeros(nq, dtype=np.int64)
    for n, qs in zip(caps, probes):
        vecs = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
        norms = np.sum(vecs * vecs, axis=1).astype(np.float32)
        mask = np.where(rng.random(n) < 0.1, np.float32(-np.inf), np.float32(0.0))
        cap = max(PAGE, -(-n // PAGE) * PAGE)
        padded = np.zeros((cap, d), dtype=np.float32)
        padded[:n] = vecs
        codes, qscale, _ = ref_quant.quantize_block(padded)
        arrs = (np.ascontiguousarray(codes[:n]), ref_quant.row_scales(qscale, cap)[:n], norms,
                mask.astype(np.float32))
        host.append(arrs)
        quant.append(tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))
        f32.append((torch.from_numpy(vecs), quant[-1][2], quant[-1][3]))
        qs = np.sort(np.asarray(qs, dtype=np.int64))
        gq.append(qs)
        gcol.append(widths[qs].copy())
        widths[qs] += n
        offsets.append(offsets[-1] + len(qs))
    groups = score_blocks.BlockGroups(
        np.asarray(offsets, dtype=np.int64), np.concatenate(gq), np.concatenate(gcol))
    return quant, f32, host, groups, int(max(widths.max(), 1))


def _random_case(seed, d):
    """Ragged blocks around the tile size, empty blocks, and blocks no query
    probes, under random groups."""
    rng = np.random.default_rng(seed)
    r = score_blocks.tile_rows(d)
    caps = [0, 1, r - 1, r, r + 1, 3 * r + 5, 0, 2 * r] + rng.integers(1, 3 * r, 4).tolist()
    nq = 11
    sizes = [int(rng.integers(1, nq)) if b % 3 else int(rng.integers(0, 5))
             for b in range(len(caps))]
    sizes[7] = 0  # 2R rows that no query probes
    probes = [rng.choice(nq, size=k, replace=False) for k in sizes]
    return rng, caps, probes, nq, r


def _walk_int8(table, n_tiles, offs, n_blocks, r):
    """The int8 kernel's walk of its list: tile i -> (block, first row,
    rows, entries)."""
    head = table[offs[0]:offs[1]].reshape(n_blocks, 6)
    goff = table[offs[1]:offs[2]]
    first = head[:, 5]
    for i in range(n_tiles):
        b = int(np.searchsorted(first, i, side="right") - 1)
        row0 = int(i - first[b]) * r
        yield b, row0, min(r, int(head[b, 4]) - row0), range(int(goff[b]), int(goff[b + 1]))


def _walk_tiles(table, n_tiles, offs, n_blocks):
    """The fp32 kernel's list: one word ``(block << 32) | first row`` per
    128-row tile."""
    head = table[offs[0]:offs[1]].reshape(n_blocks, 6)
    goff = table[offs[1]:offs[2]]
    for w in table[offs[2]:offs[3]]:
        b, row0 = int(w >> 32), int(w & 0xFFFFFFFF)
        yield b, row0, min(score_blocks.TILE, int(head[b, 4]) - row0), \
            range(int(goff[b]), int(goff[b + 1]))


def _triples(walk):
    return sorted((b, row, e) for b, row0, rows, ents in walk
                  for row in range(row0, row0 + rows) for e in ents)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("d", [16, 384, 1024])
def test_int8_work_list_walks_the_same_work_as_the_tile_list(seed, d):
    """Every (block, row, entry) the old list of one word per tile names,
    the new list's walk names once, and nothing else; its length grows with
    blocks and entries, not tiles."""
    rng, caps, probes, nq, r = _random_case(seed, d)
    quant, f32, _host, groups, _w = _blocks(rng, d, caps, probes, nq)
    table, n_tiles, offs = score_blocks.work_table(quant, groups, 1)
    old, old_tiles, old_offs = score_blocks.work_table(f32, groups, 0)
    n_blocks, n_entries = len(caps), len(groups.queries)
    assert len(table) == 7 * n_blocks + 1 + 2 * n_entries
    probed = [n > 0 and len(p) > 0 for n, p in zip(caps, probes)]
    assert n_tiles == sum(-(-n // r) for n, p in zip(caps, probed) if p)
    walk = list(_walk_int8(table, n_tiles, offs, n_blocks, r))
    assert all(1 <= rows <= r and len(ents) > 0 for _b, _r0, rows, ents in walk)
    got = _triples(walk)
    assert len(got) == len(set(got))
    assert got == _triples(_walk_tiles(old, old_tiles, old_offs, n_blocks))
    assert len(old) == 7 * n_blocks + 1 + old_tiles + 2 * n_entries


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [16, 384])
def test_int8_work_list_walk_scores_the_reference_bitwise(metric, d):
    """Scoring each tile of the walk against each of its entries (the
    kernel's work, here with the plain per-block scorer) fills the output
    with the reference's ``approx_scores`` at the right columns, -inf
    elsewhere."""
    rng, caps, probes, nq, r = _random_case(7, d)
    quant, _f32, host, groups, width = _blocks(rng, d, caps, probes, nq)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    q_codes, q_scales = ref_quant.quantize_queries(queries)
    qn = np.sum(queries * queries, axis=1).astype(np.float32)
    qc, qs, qnt = (torch.from_numpy(a) for a in (q_codes, q_scales, qn))
    table, n_tiles, offs = score_blocks.work_table(quant, groups, 1)
    out = torch.full((nq, width), -np.inf)
    for b, row0, rows, ents in _walk_int8(table, n_tiles, offs, len(caps), r):
        tile = tuple(t[row0:row0 + rows] for t in quant[b])
        for e in ents:
            q, col = int(groups.queries[e]), int(groups.cols[e])
            out[q, col + row0:col + row0 + rows] = port_quant.quant_score_block_plain(
                *tile, qc[q:q + 1], qs[q:q + 1], qnt[q:q + 1], metric)[0]
    want = np.full((nq, width), -np.inf, dtype=np.float32)
    for b, (codes, srow, norms, mask) in enumerate(host):
        sel = slice(groups.offsets[b], groups.offsets[b + 1])
        qsel, cols = groups.queries[sel], groups.cols[sel]
        if len(qsel) == 0 or len(norms) == 0:
            continue
        sub = ref_quant.approx_scores(q_codes[qsel].astype(np.float32), q_scales[qsel], qn[qsel],
                                      codes.astype(np.float32), srow, norms, metric, maskadd=mask)
        want[qsel[:, None], cols[:, None] + np.arange(len(norms))[None, :]] = sub
    np.testing.assert_array_equal(out.numpy(), want)
    plain = score_blocks.quant_score_blocks(quant, groups, qc, qs, qnt, width, metric)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("d", [16, 32, 384, 400, 1024, 4096, score_blocks.INT8_MAX_DIM])
def test_tile_rows_keep_a_tile_near_48_kb(d):
    r = score_blocks.tile_rows(d)
    assert r % 8 == 0 and 8 <= r <= 128
    assert r == 128 if d <= 384 else (r * d <= 49152 or r == 8)


def test_work_table_refuses_a_payload_off_a_16_byte_boundary():
    rng = np.random.default_rng(3)
    quant, _f32, _host, groups, _w = _blocks(rng, 32, [40], [[0]], 1)
    codes, srow, norms, mask = quant[0]
    shifted = (codes[1:], srow[1:], norms[1:], mask[1:])  # 32 B and 4 B past the start
    with pytest.raises(ValueError, match="16-byte boundary"):
        score_blocks.work_table([shifted], groups, 1)


@pytest.mark.parametrize("d,dtype,match", [
    (24, torch.int8, "multiple of 16"), (30, torch.float32, "multiple of 4"),
    (score_blocks.INT8_MAX_DIM + 16, torch.int8, "wider than"),
])
def test_check_row_width_refuses_rows_the_kernels_cannot_copy(d, dtype, match):
    with pytest.raises(ValueError, match=match):
        score_blocks.check_row_width(d, dtype)
