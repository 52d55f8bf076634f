"""Host-side geometry of the kernels that stream their weights through
``csrc/wstream.cuh`` (``fused_o_mlp``, ``fused_micro_step``): how a matrix
phase is cut into one item per CTA, and the stage schedule of a CTA's ring.

The kernels take the tile width, the row splits and the chunk from here; the
stage schedule mirrors ``wstream::produce`` for the CPU tests.  Plain Python,
no torch.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

VEC = 8  # columns per thread and row: every width is a multiple of it
STAGE_BYTES = 16384  # one ring stage (fused_o_mlp's are twice that)
MIN_COLS = 32  # a bf16 row segment of a tile covers whole 32-byte sectors twice over
MIN_SPLIT_ROWS = 64  # a row split is worth a CTA from here


class Geo(NamedTuple):
    """Column tiles of ``cols`` columns x ``splits`` row splits of ``chunk``
    rows: ``tiles * splits`` items, at most one per CTA."""
    cols: int
    splits: int
    chunk: int


class Item(NamedTuple):
    """One CTA's share of a phase: columns [n0, n0 + cols) over rows
    [k_lo, k_hi)."""
    n0: int
    cols: int
    k_lo: int
    k_hi: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tile_cols(N: int, grid: int, min_cols: int = MIN_COLS) -> int:
    """The narrowest tile width (a multiple of 8, at least ``min_cols``)
    that cuts N columns into at most ``grid`` tiles."""
    return max(min_cols, VEC * _ceil(_ceil(N, VEC), grid))


def phase_geo(K: int, N: int, grid: int, split_rows: bool = True,
              min_cols: int = MIN_COLS) -> Geo:
    """Tiles and row splits of a [K, N] matrix phase for a grid of ``grid``
    CTAs: as many row splits as keep the items within the grid, each of at
    least MIN_SPLIT_ROWS rows (a multiple of 8)."""
    cols = tile_cols(N, grid, min_cols)
    tiles = _ceil(N, cols)
    splits = max(1, min(grid // tiles, _ceil(K, MIN_SPLIT_ROWS))) if split_rows else 1
    chunk = VEC * _ceil(_ceil(K, splits), VEC)
    return Geo(cols, _ceil(K, chunk), chunk)


def num_items(K: int, N: int, geo: Geo) -> int:
    return _ceil(N, geo.cols) * geo.splits


def item_of(cta: int, K: int, N: int, geo: Geo):
    """CTA ``cta``'s item of the phase (tile ``cta % tiles``, split
    ``cta // tiles``), or None past the last item: the kernel's mapping."""
    tiles = _ceil(N, geo.cols)
    if cta >= tiles * geo.splits:
        return None
    ks, n0 = cta // tiles, (cta % tiles) * geo.cols
    k_lo = ks * geo.chunk
    return Item(n0, min(geo.cols, N - n0), k_lo, min(K, k_lo + geo.chunk))


def stage_schedule(jobs: Sequence[Tuple[int, int]], stages: int,
                   stage_bytes: int = STAGE_BYTES) -> List[Tuple[int, int, int, int]]:
    """The ring's schedule for a CTA whose jobs are ``(rows, row_bytes)`` in
    consumption order: one ``(job, row0, rows, slot)`` per stage, each at
    most ``stage_bytes``, jobs without rows skipped, slots taken round robin
    over ``stages`` (``wstream::produce``)."""
    out = []
    for j, (rows, row_bytes) in enumerate(jobs):
        if rows <= 0:
            continue
        per = stage_bytes // row_bytes
        if per < 1:
            raise ValueError(f"a row of {row_bytes} bytes does not fit a stage")
        for row0 in range(0, rows, per):
            out.append((j, row0, min(per, rows - row0), len(out) % stages))
    return out
