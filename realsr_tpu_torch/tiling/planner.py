"""Tile planning: the reference's halo-padded grid, bucketed by shape.

The port's own copy of ``plan_tiles`` and ``auto_tilesize`` from
``realsr_tpu/tiling/planner.py`` (its TPU cost model is not copied).

Reference semantics (src/realsr.cpp:170-171, 176-186, 235-237, 246-249):
- grid: ``xtiles = ceil(w / T)``, ``ytiles = ceil(h / T)``
- tile (xi, yi) covers input ``[xi*T, min((xi+1)*T, w)) x [yi*T, ...)``
  (``tile_w_nopad x tile_h_nopad``)
- its network input is that rectangle expanded by ``prepadding`` on ALL
  sides — out-of-image coordinates resolved by reflect-101 — so the padded
  extent is ``(tile_w_nopad + 2p) x (tile_h_nopad + 2p)`` exactly. Matching
  these extents matters: the net zero-pads internally at every conv, so a
  different tile extent changes edge-tile pixels.

A W x H image produces at most FOUR distinct padded-tile shapes (interior,
right edge, bottom edge, corner). Tiles are bucketed by shape; each bucket
becomes batched chunks of one shape on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Tile:
    xi: int
    yi: int
    x0: int  # input-space origin (unpadded), = xi * T
    y0: int
    w_nopad: int
    h_nopad: int

    def padded_shape(self, pad: int) -> Tuple[int, int]:
        """(height, width) of the network input for this tile."""
        return (self.h_nopad + 2 * pad, self.w_nopad + 2 * pad)


@dataclasses.dataclass
class TilePlan:
    w: int
    h: int
    tilesize: int
    prepadding: int
    tiles: List[Tile]
    # padded (h, w) -> tile indices into `tiles`
    buckets: Dict[Tuple[int, int], List[int]]

    @property
    def xtiles(self) -> int:
        return -(-self.w // self.tilesize)

    @property
    def ytiles(self) -> int:
        return -(-self.h // self.tilesize)


def plan_tiles(w: int, h: int, tilesize: int, prepadding: int) -> TilePlan:
    tiles: List[Tile] = []
    buckets: Dict[Tuple[int, int], List[int]] = {}
    xtiles = -(-w // tilesize)
    ytiles = -(-h // tilesize)
    for yi in range(ytiles):
        h_nopad = min((yi + 1) * tilesize, h) - yi * tilesize
        for xi in range(xtiles):
            w_nopad = min((xi + 1) * tilesize, w) - xi * tilesize
            t = Tile(xi, yi, xi * tilesize, yi * tilesize, w_nopad, h_nopad)
            buckets.setdefault(t.padded_shape(prepadding), []).append(len(tiles))
            tiles.append(t)
    return TilePlan(w, h, tilesize, prepadding, tiles, buckets)


def auto_tilesize(heap_budget_mb: int, is_cpu: bool = False) -> int:
    """Default tile size from memory budget.

    Mirrors the reference's policy shape (src/main.cpp:748-775: CPU=200;
    GPU 200/100/64/32 for heap > 1900/550/190 MB) with the JAX package's
    top tier, T=128 above 1.9 GB, batched 8 deep by the engine. Below
    1.9 GB the reference's tiers apply unchanged.
    """
    if is_cpu:
        return 200
    if heap_budget_mb > 1900:
        return 128
    if heap_budget_mb > 550:
        return 100
    if heap_budget_mb > 190:
        return 64
    return 32

