"""Cell-grid neighbor engine — the scale path past O(N^2).

The dense tiled engine (ops/neighbors.py) is exact but streams a (tile, P)
distance slab per query tile: at 500k points one radius pass is 2.5e11 pair
distances — the reference's kd-tree call sites (src/features.cpp:34-41,
171-176, src/matching.cpp:50-56) are unreachable that way. This module is
the replacement at scale (SURVEY.md §7 "grid-hash
neighborhoods").

Design (bucket-centric: whole-block gathers, no per-query row gathers):
  - Points are binned by WRAPPED integer cell coordinates (cell edge >=
    query radius; coordinates taken modulo static grid dims) and scattered
    once into a dense (H, C) cell tensor — contiguous (C, 3) blocks per
    cell.
  - Queries are binned the SAME way. All queries of one cell share one
    candidate set: the 27 neighbor cells' blocks, gathered as whole (C, 3)
    slabs — 27 block gathers per CELL, not per query (a per-query gather
    issues one XLA row gather per query and was far slower).
  - Wrapping makes per-cell sharing exact: the wrapped ids of a cell's 27
    neighbors equal the 27 neighbor ids of the wrapped cell, so queries
    that collide by wrapping still scan a superset of their true neighbor
    cells, and the exact distance test removes the far impostors.

Correctness model:
  - cell edge >= radius guarantees every true neighbor lies in one of the
    27 neighbor cells; wrap collisions only ADD candidates; duplicate ids
    among the 27 (tiny grids) are deduped so nothing is double counted.
  - the only approximation is the bucket capacity `scan_cap` (points and
    queries beyond it in one cell are dropped at build time). Overflow is
    COUNTED and returned by build_grid / surfaced by the feature pipeline
    (CloudFeatures.scan_overflow) — no silent caps.

Everything is mask-aware and fixed-shape; cells are processed in tiles
under lax.map, so peak memory is one (tile, C, 27*C) distance block.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from mapmerge_tpu.core.cloud import FAR

#: squared-distance value used to exclude masked/absent candidates
BIG = 1.0e12

# 27 neighbor-cell offsets, x fastest — numpy on purpose: this module is
# lazily imported from inside jit traces (ops/neighbors.py dispatch), and a
# module-level jnp constant created under an ambient trace would leak that
# trace's tracer into every later program.
_OFFSETS = np.asarray(
    [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    np.int32,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Points scattered into a dense (H, C) cell tensor."""

    cell_xyz: jax.Array  # (H, C, 3) float32; empty slots parked FAR
    cell_idx: jax.Array  # (H, C) int32 original index; empty slots = n
    cell_ok: jax.Array  # (H, C) bool slot occupied by a valid point
    count: jax.Array  # (H,) int32 stored (capped) bucket sizes
    raw_max: jax.Array  # () int32 fullest bucket BEFORE capping
    overflow: jax.Array  # () int32 valid points dropped by the cap
    cell_size: float = dataclasses.field(metadata=dict(static=True))
    dims: tuple = dataclasses.field(metadata=dict(static=True))  # (Gx,Gy,Gz)
    cap: int = dataclasses.field(metadata=dict(static=True))  # C


def default_dims(n: int) -> tuple[int, int, int]:
    """Grid dims with H = Gx*Gy*Gz ~ max(4096, n/16), power-of-two axes.

    Sized for the map-merging regime: voxel-downsampled surface clouds
    carry ~(r/res)^2 >= ~36 points per radius-sized cell, so H = n/16
    keeps most cells occupied (padded empty cells are pure waste — every
    (H, C) slot is processed)."""
    h_target = 4096
    while h_target < min(max(n // 16, 4096), 1 << 18):
        h_target <<= 1
    # robot maps are flat-ish: give z only 4 wrap cells and spend the rest
    # on x/y — an even 3-way split wraps a 58 m map at 25 m in y (measured
    # bucket overflow from wrap collisions), while z rarely spans 4 cells
    e = h_target.bit_length() - 1
    ez = min(2, e // 3)
    ex = (e - ez + 1) // 2
    ey = e - ez - ex
    return (1 << ex, 1 << ey, 1 << ez)


def _bucket_of(cells: jax.Array, dims: tuple) -> jax.Array:
    gx, gy, gz = dims
    bx = jnp.mod(cells[..., 0], gx)
    by = jnp.mod(cells[..., 1], gy)
    bz = jnp.mod(cells[..., 2], gz)
    return (bz * gy + by) * gx + bx


def _neighbor_buckets(b: jax.Array, dims: tuple) -> jax.Array:
    """(..., 27) wrapped bucket ids of the 27 neighbor cells of bucket b."""
    gx, gy, gz = dims
    bx = jnp.mod(b, gx)
    by = jnp.mod(b // gx, gy)
    bz = b // (gx * gy)
    off = _OFFSETS  # (27, 3) numpy
    nx = jnp.mod(bx[..., None] + off[:, 0], gx)
    ny = jnp.mod(by[..., None] + off[:, 1], gy)
    nz = jnp.mod(bz[..., None] + off[:, 2], gz)
    return (nz * gy + ny) * gx + nx


def build_grid(
    xyz: jax.Array,
    mask: jax.Array | None,
    cell_size: float,
    dims: tuple | None = None,
    cap: int = 128,
) -> CellGrid:
    """Scatter points into the dense cell tensor. O(N log N) (one sort)."""
    n = xyz.shape[0]
    if dims is None:
        dims = default_dims(n)
    h = dims[0] * dims[1] * dims[2]
    if mask is None:
        mask = jnp.ones((n,), bool)
    cells = jnp.floor(xyz * jnp.float32(1.0 / cell_size)).astype(jnp.int32)
    bucket = _bucket_of(cells, dims)
    bucket = jnp.where(mask, bucket, h)  # invalid points to a spill bucket

    # rank within bucket via one sort: sorted order is bucket-major, so
    # rank = position - start_of_bucket
    order = jnp.argsort(bucket).astype(jnp.int32)
    bucket_s = bucket[order]
    counts_all = jnp.zeros((h + 1,), jnp.int32).at[bucket_s].add(1)
    start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(counts_all[:-1], dtype=jnp.int32)]
    )
    rank = jnp.arange(n, dtype=jnp.int32) - start[bucket_s]

    slot = bucket_s * cap + jnp.minimum(rank, cap - 1)
    keep = (rank < cap) & (bucket_s < h)
    slot = jnp.where(keep, slot, h * cap)  # spill slot (dropped)

    cell_xyz = (
        jnp.full((h * cap + 1, 3), FAR, jnp.float32)
        .at[slot].set(xyz[order], mode="drop")[:-1]
        .reshape(h, cap, 3)
    )
    cell_idx = (
        jnp.full((h * cap + 1,), n, jnp.int32)
        .at[slot].set(order, mode="drop")[:-1]
        .reshape(h, cap)
    )
    cell_ok = (
        jnp.zeros((h * cap + 1,), bool)
        .at[slot].set(keep, mode="drop")[:-1]
        .reshape(h, cap)
    )
    counts = counts_all[:h]
    raw_max = jnp.max(counts)
    overflow = jnp.sum(jnp.maximum(counts - cap, 0))
    return CellGrid(
        cell_xyz=cell_xyz,
        cell_idx=cell_idx,
        cell_ok=cell_ok,
        count=jnp.minimum(counts, cap),
        raw_max=raw_max,
        overflow=overflow,
        cell_size=float(cell_size),
        dims=tuple(dims),
        cap=cap,
    )


def max_bucket_count(grid: CellGrid) -> jax.Array:
    """Fullest bucket BEFORE capping — if this exceeds grid.cap, points
    were dropped (grid.overflow counts them); callers surface it."""
    return grid.raw_max


def grid_query(
    q: jax.Array,
    grid: CellGrid,
    tile_fn: Callable,
    out_defaults,
    q_mask: jax.Array | None = None,
    tile: int = 16,
    q_cap: int | None = None,
    q_values=None,
    p_values=None,
    skip_empty: bool = True,
    qg: CellGrid | None = None,
):
    """Bucket-grouped query processing.

    Bins queries into the same wrapped cell layout as `grid`, processes
    cells in tiles of `tile`, and scatters results back to query order.

    tile_fn(q_block (B, Cq, 3), cand_xyz (B, M, 3), cand_ok (B, M),
            cand_idx (B, M)[, q_vals, p_vals]) -> pytree of (B, Cq, ...)
    outputs. `q_values` / `p_values` are optional pytrees of per-query /
    per-point channel arrays (N, ...); they are pre-scattered into the cell
    layout ONCE (block gathers in the scan body, never per-row gathers) and
    handed to tile_fn as (B, Cq, ...) / (B, M, ...) extra args.

    `out_defaults`: matching pytree of per-query default values (scalars or
    arrays broadcastable to the tail shape) used for queries that overflow
    the query-side bucket capacity — and, with `skip_empty`, for queries in
    buckets that hold none (vacuous: such buckets hold no queries).

    `skip_empty` (default on) wraps each scan step in a `lax.cond` on
    "does this bucket tile hold any query?" — sparse query sets (e.g. the
    SPFH needed-point mask) and the ~4x empty-bucket padding of the hash
    layout then cost a branch instead of a full (B, Cq, 27C) pass. Exact:
    a skipped tile holds no queries, so it had nothing to scatter.

    `qg`: optional PREBUILT query grid (same cell size/dims layout). When
    the queries are the grid's own points under a different mask, callers
    can derive it from `grid` by masking (masked_query_grid) instead of
    paying a second 1M-point sort.

    Returns (outputs, q_overflow_count).
    """
    if qg is None:
        qg = build_grid(q, q_mask, grid.cell_size, grid.dims, q_cap or grid.cap)
    h = grid.count.shape[0]
    nq = q.shape[0]
    c = grid.cap
    cq = qg.cap

    def _pad_rows(v):
        return jnp.concatenate([v, jnp.zeros((1,) + v.shape[1:], v.dtype)])

    # channel arrays in cell layout: one (H*C,)-row gather up front so the
    # scan body only does whole-block gathers
    p_cells = None
    if p_values is not None:
        p_cells = jax.tree_util.tree_map(
            lambda v: _pad_rows(v)[grid.cell_idx], p_values
        )  # (H, C, ...)
    q_cells = None
    if q_values is not None:
        q_cells = jax.tree_util.tree_map(
            lambda v: _pad_rows(v)[qg.cell_idx], q_values
        )  # (H, Cq, ...)

    buckets = jnp.arange(h, dtype=jnp.int32).reshape(-1, tile)

    # scan with in-place scatter of each tile's rows into the final (Q,...)
    # outputs: a map-then-unsort would materialize (H, Cq, ...) tensors,
    # which for wide outputs (radius_neighbors k) is GBs at 1M points
    def init_leaf(default, t):
        # dtype from the tile_fn output (scan carry must be dtype-stable)
        return jnp.broadcast_to(
            jnp.asarray(default, t.dtype), (nq + 1,) + t.shape[2:]
        )

    def body(carry, bucket_tile):  # (B,)
        nbr = _neighbor_buckets(bucket_tile, grid.dims)  # (B, 27)
        # dedupe ids duplicated by wrapping on tiny grids
        nbr = jnp.sort(nbr, axis=-1)
        dup = jnp.concatenate(
            [jnp.zeros((nbr.shape[0], 1), bool), nbr[:, 1:] == nbr[:, :-1]],
            axis=-1,
        )
        cand_xyz = grid.cell_xyz[nbr].reshape(nbr.shape[0], 27 * c, 3)
        cand_ok = (grid.cell_ok[nbr] & ~dup[..., None]).reshape(
            nbr.shape[0], 27 * c
        )
        cand_idx = grid.cell_idx[nbr].reshape(nbr.shape[0], 27 * c)
        q_block = qg.cell_xyz[bucket_tile]  # (B, Cq, 3)
        extras = []
        if q_cells is not None:
            extras.append(
                jax.tree_util.tree_map(lambda v: v[bucket_tile], q_cells)
            )
        if p_cells is not None:
            extras.append(
                jax.tree_util.tree_map(
                    lambda v: v[nbr].reshape(
                        (nbr.shape[0], 27 * c) + v.shape[2:]
                    ),
                    p_cells,
                )
            )
        outs = tile_fn(q_block, cand_xyz, cand_ok, cand_idx, *extras)
        # occupancy-gated scatter: with a derived query grid
        # (masked_query_grid) masked-out points still sit in their slots
        # with real coordinates — route their outputs to the sacrificial
        # row so they keep out_defaults, exactly like a built query grid
        slots = jnp.where(
            qg.cell_ok[bucket_tile], qg.cell_idx[bucket_tile], nq
        ).reshape(-1)  # (B*Cq,)
        return jax.tree_util.tree_map(
            lambda acc, o: acc.at[slots].set(
                o.reshape((-1,) + o.shape[2:]), mode="drop"
            ),
            carry,
            outs,
        )

    def step(carry, bucket_tile):
        if skip_empty:
            has_queries = jnp.any(qg.count[bucket_tile] > 0)
            carry = jax.lax.cond(
                has_queries,
                lambda cr: body(cr, bucket_tile),
                lambda cr: cr,
                carry,
            )
        else:
            carry = body(carry, bucket_tile)
        return carry, None

    # build init from defaults; tail shapes come from a shape-eval of tile_fn
    extras_spec = []
    if q_values is not None:
        extras_spec.append(
            jax.tree_util.tree_map(
                lambda v: jax.ShapeDtypeStruct(
                    (tile, cq) + v.shape[1:], v.dtype
                ),
                q_values,
            )
        )
    if p_values is not None:
        extras_spec.append(
            jax.tree_util.tree_map(
                lambda v: jax.ShapeDtypeStruct(
                    (tile, 27 * c) + v.shape[1:], v.dtype
                ),
                p_values,
            )
        )
    tail = jax.eval_shape(
        tile_fn,
        jax.ShapeDtypeStruct((tile, cq, 3), q.dtype),
        jax.ShapeDtypeStruct((tile, 27 * c, 3), grid.cell_xyz.dtype),
        jax.ShapeDtypeStruct((tile, 27 * c), bool),
        jax.ShapeDtypeStruct((tile, 27 * c), jnp.int32),
        *extras_spec,
    )
    init = jax.tree_util.tree_map(init_leaf, out_defaults, tail)
    out, _ = jax.lax.scan(step, init, buckets)
    outputs = jax.tree_util.tree_map(lambda a: a[:nq], out)
    return outputs, qg.overflow


def masked_query_grid(grid: CellGrid, q_mask: jax.Array, n: int) -> CellGrid:
    """Derive the query grid for "the grid's own points, restricted to
    q_mask" without a second sort: same slots, occupancy intersected with
    the mask.

    Query overflow counts only q_mask points dropped at build time (a
    needed point dropped by the bucket cap is exactly a dropped query;
    build-time drops OUTSIDE q_mask were never queried and must not fire
    the query-overflow warning — ADVICE r4)."""
    mask_pad = jnp.concatenate([q_mask, jnp.zeros((1,), bool)])
    cell_ok = grid.cell_ok & mask_pad[grid.cell_idx]
    # which original points survived the build cap: every index present in
    # an occupied slot (slot index n = empty is sliced off via the pad row)
    kept = (
        jnp.zeros((n + 1,), bool)
        .at[grid.cell_idx.reshape(-1)]
        .max(grid.cell_ok.reshape(-1), mode="drop")[:n]
    )
    overflow = jnp.sum(q_mask[:n] & ~kept).astype(jnp.int32)
    return CellGrid(
        cell_xyz=grid.cell_xyz,
        cell_idx=grid.cell_idx,
        cell_ok=cell_ok,
        count=jnp.sum(cell_ok, axis=1).astype(jnp.int32),
        raw_max=grid.raw_max,
        overflow=overflow,
        cell_size=grid.cell_size,
        dims=grid.dims,
        cap=grid.cap,
    )


def _d2(q_block: jax.Array, cand_xyz: jax.Array) -> jax.Array:
    """(B, Cq, 3) x (B, M, 3) -> (B, Cq, M) squared distances."""
    d = q_block[:, :, None, :] - cand_xyz[:, None, :, :]
    return jnp.sum(d * d, axis=-1)


# --------------------------------------------------------------- public ops
def grid_radius_count(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    p_mask: jax.Array | None = None,
    tile: int = 16,
    include_self: bool = True,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> jax.Array:
    """Grid twin of neighbors.radius_count (exact up to scan_cap).

    Returns (counts, overflow): `overflow` counts queries dropped by the
    query-side bucket cap (their output is the default) — callers surface
    it (no silent caps)."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    r2 = jnp.float32(radius * radius)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        within = cand_ok[:, None, :] & (_d2(q_block, cand_xyz) <= r2)
        return jnp.sum(within, axis=-1).astype(jnp.int32)

    counts, overflow = grid_query(q, grid, tile_fn, jnp.int32(0), tile=tile)
    if not include_self:
        counts = counts - 1
    return counts, overflow


#: query count at or below which grid_radius_neighbors uses the
#: query-centric gather path instead of the bucket-centric cell sweep.
#: The sweep's cost is O(H) scan steps + per-tile top-k regardless of how
#: few queries exist. Chosen on the earlier accelerator; not measured on
#: the H100.
SMALL_Q_THRESHOLD = 4096


def _radius_neighbors_smallq(
    q: jax.Array,
    grid: CellGrid,
    n_p: int,
    radius: float,
    k: int,
    exclude_self: bool,
    chunk: int = 1024,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Query-centric variant for SMALL query sets (keypoint neighborhoods):
    gather each query's 27 neighbor-cell blocks directly into a (Q, 27C)
    candidate slab and top-k it — no cell sweep, no query-side bucketing
    (hence no query overflow; every query is answered exactly)."""
    r2 = jnp.float32(radius * radius)
    c = grid.cap
    nq = q.shape[0]

    cells = jnp.floor(q * jnp.float32(1.0 / grid.cell_size)).astype(jnp.int32)
    bucket = _bucket_of(cells, grid.dims)

    def slab(args):
        q_blk, b_blk = args  # (B, 3), (B,)
        nbr = _neighbor_buckets(b_blk, grid.dims)  # (B, 27)
        nbr = jnp.sort(nbr, axis=-1)
        dup = jnp.concatenate(
            [jnp.zeros((nbr.shape[0], 1), bool), nbr[:, 1:] == nbr[:, :-1]],
            axis=-1,
        )
        cand_xyz = grid.cell_xyz[nbr].reshape(nbr.shape[0], 27 * c, 3)
        cand_ok = (grid.cell_ok[nbr] & ~dup[..., None]).reshape(
            nbr.shape[0], 27 * c
        )
        cand_idx = grid.cell_idx[nbr].reshape(nbr.shape[0], 27 * c)
        d = q_blk[:, None, :] - cand_xyz
        d2 = jnp.sum(d * d, axis=-1)
        d2 = jnp.where(cand_ok, d2, BIG)
        if exclude_self:
            d2 = jnp.where(d2 <= 1e-12, BIG, d2)
        # EXACT two-stage top-k (same argument as the sweep tile_fn below)
        b = d2.shape[0]
        k_cell = min(k, c)
        d2_cells = d2.reshape(b, 27, c)
        neg1, pos1 = jax.lax.top_k(-d2_cells, k_cell)
        cell_base = jnp.arange(27, dtype=jnp.int32)[None, :, None] * c
        pos1_flat = (pos1 + cell_base).reshape(b, 27 * k_cell)
        d2_stage = (-neg1).reshape(b, 27 * k_cell)
        k_eff = min(k, d2_stage.shape[-1])
        neg2, pos2 = jax.lax.top_k(-d2_stage, k_eff)
        d2k = -neg2
        pos = jnp.take_along_axis(pos1_flat, pos2, axis=-1)
        idx = jnp.take_along_axis(cand_idx, pos, axis=-1)
        valid = d2k <= r2
        if k_eff < k:
            pad = k - k_eff
            idx = jnp.pad(idx, ((0, 0), (0, pad)))
            d2k = jnp.pad(d2k, ((0, 0), (0, pad)), constant_values=BIG)
            valid = jnp.pad(valid, ((0, 0), (0, pad)))
        return idx.astype(jnp.int32), d2k, valid

    pad = (-nq) % chunk
    if pad:
        q_p = jnp.concatenate([q, jnp.full((pad, 3), FAR, q.dtype)])
        b_p = jnp.concatenate([bucket, jnp.zeros((pad,), bucket.dtype)])
    else:
        q_p, b_p = q, bucket
    idx, d2k, valid = jax.lax.map(
        slab, (q_p.reshape(-1, chunk, 3), b_p.reshape(-1, chunk))
    )
    unflat = lambda a: a.reshape((-1,) + a.shape[2:])[:nq]
    idx, d2k, valid = unflat(idx), unflat(d2k), unflat(valid)
    idx = jnp.where(idx >= n_p, 0, idx)
    return idx, d2k, valid


def grid_radius_neighbors(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    k: int,
    p_mask: jax.Array | None = None,
    tile: int = 16,
    exclude_self: bool = False,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Grid twin of neighbors.radius_neighbors: up to k nearest within
    radius, nearest first, indices in ORIGINAL point order.

    Returns (idx, d2, valid, overflow) — `overflow` counts queries dropped
    by the query-side bucket cap (their rows come back all-invalid).
    Small query sets dispatch to the query-centric gather path (exact, no
    query-side cap — overflow is structurally 0 there)."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    r2 = jnp.float32(radius * radius)

    if q.shape[0] <= SMALL_Q_THRESHOLD:
        idx, d2k, valid = _radius_neighbors_smallq(
            q, grid, p.shape[0], radius, k, exclude_self
        )
        return idx, d2k, valid, jnp.zeros((), jnp.int32)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        d2 = _d2(q_block, cand_xyz)  # (B, Cq, M)
        d2 = jnp.where(cand_ok[:, None, :], d2, BIG)
        if exclude_self:
            d2 = jnp.where(d2 <= 1e-12, BIG, d2)
        b, cq, m = d2.shape
        c = m // 27
        # EXACT two-stage top-k: the global top-k is contained in the union
        # of per-cell top-k's, and per-cell widths (C) are ~27x narrower —
        # a single top_k over the full M width was the measured hot spot
        k_cell = min(k, c)
        d2_cells = d2.reshape(b, cq, 27, c)
        neg1, pos1 = jax.lax.top_k(-d2_cells, k_cell)  # (B,Cq,27,kc)
        cell_base = jnp.arange(27, dtype=jnp.int32)[None, None, :, None] * c
        pos1_flat = (pos1 + cell_base).reshape(b, cq, 27 * k_cell)
        d2_stage = (-neg1).reshape(b, cq, 27 * k_cell)
        k_eff = min(k, d2_stage.shape[-1])
        neg2, pos2 = jax.lax.top_k(-d2_stage, k_eff)
        d2k = -neg2
        pos = jnp.take_along_axis(pos1_flat, pos2, axis=-1)
        idx = jnp.take_along_axis(
            jnp.broadcast_to(cand_idx[:, None, :], d2.shape), pos, axis=-1
        )
        valid = d2k <= r2
        if k_eff < k:
            pad = k - k_eff
            idx = jnp.pad(idx, ((0, 0), (0, 0), (0, pad)))
            d2k = jnp.pad(d2k, ((0, 0), (0, 0), (0, pad)), constant_values=BIG)
            valid = jnp.pad(valid, ((0, 0), (0, 0), (0, pad)))
        return idx.astype(jnp.int32), d2k, valid

    (idx, d2k, valid), overflow = grid_query(
        q, grid, tile_fn,
        (jnp.int32(0), jnp.float32(BIG), jnp.asarray(False)),
        tile=tile,
    )
    # out-of-cloud sentinel index -> 0 (masked by valid=False anyway)
    idx = jnp.where(idx >= p.shape[0], 0, idx)
    return idx, d2k, valid, overflow


def grid_nearest_neighbor(
    q: jax.Array,
    p: jax.Array,
    bound: float,
    p_mask: jax.Array | None = None,
    tile: int = 16,
    scan_cap: int = 128,
    dims: tuple | None = None,
    q_mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Bounded 1-NN: (idx, d2, overflow) with d2 = BIG when nothing lies
    within `bound`. Exact for every consumer that discards matches beyond a
    known bound (ICP's max_correspondence_distance, transformScore's
    max_range) — up to the query-side bucket cap, whose drops `overflow`
    counts."""
    grid = build_grid(p, p_mask, bound, dims, scan_cap)
    return grid_nn_query(grid, q, p.shape[0], tile=tile, q_mask=q_mask)


def grid_nn_query(
    grid: CellGrid,
    q: jax.Array,
    n_p: int,
    tile: int = 16,
    q_mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Bounded 1-NN against a PREBUILT grid (cell edge = the bound).

    Lets iterative consumers (ICP: the target never moves) build the
    target grid once outside their loop instead of re-sorting every
    iteration. Returns (idx, d2, overflow): queries past the query-side
    bucket cap come back unmatched (d2 = BIG) and are counted."""
    bound = grid.cell_size
    r2 = jnp.float32(bound * bound)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        d2 = _d2(q_block, cand_xyz)
        d2 = jnp.where(cand_ok[:, None, :] & (d2 <= r2), d2, BIG)
        j = jnp.argmin(d2, axis=-1)  # (B, Cq)
        best = jnp.take_along_axis(d2, j[..., None], axis=-1)[..., 0]
        idx = jnp.take_along_axis(
            jnp.broadcast_to(cand_idx[:, None, :], d2.shape), j[..., None],
            axis=-1,
        )[..., 0]
        return idx.astype(jnp.int32), best

    # q_mask keeps padded/invalid queries out of the overflow count (they
    # need no correspondence — counting them fires false no-silent-caps
    # warnings on padded clouds)
    (idx, best), overflow = grid_query(
        q, grid, tile_fn, (jnp.int32(0), jnp.float32(BIG)), tile=tile,
        q_mask=q_mask,
    )
    idx = jnp.where(idx >= n_p, 0, idx)
    return idx, best, overflow


def _radius_reduce_smallq(
    q: jax.Array,
    grid: CellGrid,
    radius: float,
    values: jax.Array,
    reduce: str,
    chunk: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """Query-centric radius_reduce for SMALL query sets (e.g. the Harris
    corner-refinement solves over <=max_keypoints points): gather each
    query's 27 neighbor-cell blocks directly instead of sweeping every
    cell of the grid — the sweep costs O(H) regardless of query count."""
    r2 = jnp.float32(radius * radius)
    c = grid.cap
    nq = q.shape[0]
    v_dim = values.shape[-1]
    # values in cell layout once (the sweep path's p_values channel)
    v_pad = jnp.concatenate(
        [values, jnp.zeros((1, v_dim), values.dtype)]
    )
    v_cells = v_pad[grid.cell_idx]  # (H, C, V)

    cells = jnp.floor(q * jnp.float32(1.0 / grid.cell_size)).astype(jnp.int32)
    bucket = _bucket_of(cells, grid.dims)

    def slab(args):
        q_blk, b_blk = args  # (B, 3), (B,)
        nbr = _neighbor_buckets(b_blk, grid.dims)  # (B, 27)
        nbr = jnp.sort(nbr, axis=-1)
        dup = jnp.concatenate(
            [jnp.zeros((nbr.shape[0], 1), bool), nbr[:, 1:] == nbr[:, :-1]],
            axis=-1,
        )
        cand_xyz = grid.cell_xyz[nbr].reshape(nbr.shape[0], 27 * c, 3)
        cand_ok = (grid.cell_ok[nbr] & ~dup[..., None]).reshape(
            nbr.shape[0], 27 * c
        )
        v = v_cells[nbr].reshape(nbr.shape[0], 27 * c, v_dim)
        d = q_blk[:, None, :] - cand_xyz
        d2 = jnp.sum(d * d, axis=-1)
        within = cand_ok & (d2 <= r2)
        count = jnp.sum(within, axis=-1).astype(jnp.int32)
        if reduce == "sum":
            out = jnp.einsum(
                "bm,bmv->bv", within.astype(jnp.float32), v,
                precision=jax.lax.Precision.HIGHEST,
            )
        elif reduce == "max":
            out = jnp.max(
                jnp.where(within[..., None], v, -BIG), axis=1
            )
        else:
            raise ValueError(f"unknown reduce: {reduce}")
        return count, out

    pad = (-nq) % chunk
    if pad:
        q_p = jnp.concatenate([q, jnp.full((pad, 3), FAR, q.dtype)])
        b_p = jnp.concatenate([bucket, jnp.zeros((pad,), bucket.dtype)])
    else:
        q_p, b_p = q, bucket
    count, out = jax.lax.map(
        slab, (q_p.reshape(-1, chunk, 3), b_p.reshape(-1, chunk))
    )
    count = count.reshape(-1)[:nq]
    out = out.reshape(-1, v_dim)[:nq]
    return count, out


def grid_radius_reduce(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    values: jax.Array,
    p_mask: jax.Array | None = None,
    tile: int = 16,
    reduce: str = "sum",
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Grid twin of neighbors.radius_reduce:
    (count, sum|max of values, query-overflow count).

    Small query sets dispatch to the query-centric gather path (exact, no
    query-side bucket cap — overflow is structurally 0 there)."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    r2 = jnp.float32(radius * radius)
    v_dim = values.shape[-1]

    if q.shape[0] <= SMALL_Q_THRESHOLD:
        count, out = _radius_reduce_smallq(q, grid, radius, values, reduce)
        return count, out, jnp.zeros((), jnp.int32)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx, v):
        # v (B, M, V) arrives via the p_values channel: block gathers from
        # the cell layout, never per-row gathers (the measured Harris hot
        # spot was vals_pad[cand_idx] here — 55k row gathers per tile)
        within = cand_ok[:, None, :] & (_d2(q_block, cand_xyz) <= r2)
        count = jnp.sum(within, axis=-1).astype(jnp.int32)
        if reduce == "sum":
            out = jnp.einsum(
                "bqm,bmv->bqv", within.astype(jnp.float32), v,
                precision=jax.lax.Precision.HIGHEST,
            )
        elif reduce == "max":
            out = jnp.max(
                jnp.where(within[..., None], v[:, None, :, :], -BIG), axis=2
            )
        else:
            raise ValueError(f"unknown reduce: {reduce}")
        return count, out

    (count, out), overflow = grid_query(
        q, grid, tile_fn,
        (jnp.int32(0),
         jnp.zeros((v_dim,), jnp.float32) if reduce == "sum"
         else jnp.full((v_dim,), -BIG, jnp.float32)),
        tile=tile, p_values=values,
    )
    return count, out, overflow


def grid_neighbor_moments(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    p_mask: jax.Array | None = None,
    tile: int = 16,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Grid twin of neighbors.neighbor_moments: (count, mean, cov,
    query-overflow count).

    Candidates are centered on the query before the moment sums, so the
    covariance has no large-coordinate cancellation."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    r2 = jnp.float32(radius * radius)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        rel = cand_xyz[:, None, :, :] - q_block[:, :, None, :]  # (B,Cq,M,3)
        d2 = jnp.sum(rel * rel, axis=-1)
        w = (cand_ok[:, None, :] & (d2 <= r2)).astype(jnp.float32)
        s0 = jnp.sum(w, axis=-1)  # (B, Cq)
        rx, ry, rz = rel[..., 0], rel[..., 1], rel[..., 2]
        # explicit fused sums (6 unique second moments) — an einsum here
        # forces the (B, Cq, M, 3) weighted operand to materialize; these
        # stay elementwise+reduce and fuse with the d2 computation
        s1 = jnp.stack(
            [jnp.sum(w * rx, -1), jnp.sum(w * ry, -1), jnp.sum(w * rz, -1)],
            axis=-1,
        )  # (B, Cq, 3)
        sxx = jnp.sum(w * rx * rx, -1)
        sxy = jnp.sum(w * rx * ry, -1)
        sxz = jnp.sum(w * rx * rz, -1)
        syy = jnp.sum(w * ry * ry, -1)
        syz = jnp.sum(w * ry * rz, -1)
        szz = jnp.sum(w * rz * rz, -1)
        s2 = jnp.stack(
            [
                jnp.stack([sxx, sxy, sxz], -1),
                jnp.stack([sxy, syy, syz], -1),
                jnp.stack([sxz, syz, szz], -1),
            ],
            axis=-2,
        )  # (B, Cq, 3, 3)
        denom = jnp.maximum(s0, 1.0)[..., None]
        mean_rel = s1 / denom
        e_outer = s2 / denom[..., None]
        cov = e_outer - mean_rel[..., :, None] * mean_rel[..., None, :]
        return s0, mean_rel + q_block, cov

    (s0, mean, cov), overflow = grid_query(
        q, grid, tile_fn,
        (jnp.float32(0), jnp.zeros((3,), jnp.float32),
         jnp.zeros((3, 3), jnp.float32)),
        tile=tile,
    )
    return s0, mean, cov, overflow


def grid_gaussian_smooth(
    q: jax.Array,
    p: jax.Array,
    values: jax.Array,
    sigmas: list[float],
    p_mask: jax.Array | None = None,
    tile: int = 16,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> jax.Array:
    """Gaussian-weighted means of `values` (P,) at every sigma:
    ((Q, S), query-overflow count).

    Neighborhood bounded at 3 * max(sigmas) (PCL SIFT scale-space
    truncation). Backs the grid-engine SIFT scale space."""
    r_bound = 3.0 * max(sigmas)
    grid = build_grid(p, p_mask, r_bound, dims, scan_cap)
    r2 = jnp.float32(r_bound * r_bound)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx, v):
        # v (B, M) via the p_values channel (block gathers only)
        d2 = _d2(q_block, cand_xyz)  # (B, Cq, M)
        base_ok = (cand_ok[:, None, :] & (d2 <= r2)).astype(jnp.float32)
        outs = []
        for s in sigmas:
            w = jnp.exp(-d2 * jnp.float32(1.0 / (2.0 * s * s))) * base_ok
            num = jnp.einsum("bqm,bm->bq", w, v)
            den = jnp.sum(w, axis=-1)
            outs.append(num / jnp.maximum(den, 1e-12))
        return jnp.stack(outs, axis=-1)  # (B, Cq, S)

    out, overflow = grid_query(
        q, grid, tile_fn, jnp.zeros((len(sigmas),), jnp.float32), tile=tile,
        p_values=values,
    )
    return out, overflow
