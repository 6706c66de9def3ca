"""Tile planning: the reference's halo-padded grid, bucketed by shape.

The port's own copy of ``realsr_tpu/tiling/planner.py``: ``plan_tiles``,
``auto_tilesize`` and the per-image tile pick (``pick_tilesize`` and its cost
model), with the cost anchors measured on the H100
(``realsr_tpu_torch/tiling/calibrate.py``) instead of the TPU's.

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


# the reference's tile on the CPU (src/main.cpp:752); a card engine picks
# its tile per image (pick_tilesize)
CPU_TILESIZE = 200


def auto_tilesize(heap_budget_mb: int, is_cpu: bool = False) -> int:
    """Default tile size from memory budget.

    Mirrors the reference's policy shape (src/main.cpp:748-775: CPU=200;
    GPU 200/100/64/32 for heap > 1900/550/190 MB) with the JAX package's
    top tier, T=128 above 1.9 GB, batched 8 deep by the engine. Below
    1.9 GB the reference's tiers apply unchanged. The port's engine reads
    no free memory and runs none of the card tiers: it takes
    ``CPU_TILESIZE`` on the CPU and picks per image on a card. The tiers
    are kept only for parity with the JAX package's planner.
    """
    if is_cpu:
        return CPU_TILESIZE
    if heap_budget_mb > 1900:
        return 128
    if heap_budget_mb > 550:
        return 100
    if heap_budget_mb > 190:
        return 64
    return 32



# measured per-padded-pixel forward cost on the card by padded tile side,
# relative to 148: the default engine's forward (mixed mode, the K1 trunk
# and the K6 tail) on chunks of 8 x 148², 8 x 212² and 6 x 276² (the batch
# _auto_batch gives each tile in mixed mode), median of interleaved rounds:
# 0.17945 / 0.18112 / 0.18122 us per padded pixel (31.4 / 65.1 / 82.8 ms a
# chunk), by chip_smoke.py phase 8b, the measurement of ``python -m
# realsr_tpu_torch.tiling.calibrate``, on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit. The rate is flat within 1 % on this card, so the
# pick minimizes padded pixels: larger tiles recompute less halo.
_TILE_CANDIDATES = (128, 192, 256)
_RATE_ANCHORS = ((148, 1.00), (212, 1.009), (276, 1.010))
# the card the shipped table was measured on (torch.cuda.get_device_name)
_ANCHOR_DEVICE = "NVIDIA H100 80GB HBM3"


def _anchor_file() -> str:
    """Install-local calibration file, written by
    ``python -m realsr_tpu_torch.tiling.calibrate --save`` after an on-card
    re-measurement. ``REALSR_TPU_CACHE`` names its directory; else the
    port's own cache directory."""
    import os

    base = os.environ.get("REALSR_TPU_CACHE") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache"), "realsr_tpu_torch"
    )
    return os.path.join(base, "planner_anchors.json")


def _parse_anchor_spec(spec: str):
    pairs = tuple(
        (int(s.split(":")[0]), float(s.split(":")[1]))
        for s in spec.split(",")
        if s.strip()
    )
    if pairs and all(p[1] > 0 for p in pairs):
        return tuple(sorted(pairs))
    return None


def _anchors():
    """The cost-model anchors, re-calibratable without editing code.
    Priority: ``REALSR_TPU_RATE_ANCHORS="148:1.0,212:1.009,276:1.010"`` (the
    value ``realsr_tpu_torch.tiling.calibrate`` prints), then the saved
    calibration file (``calibrate --save``), then the shipped table. Any
    parse problem falls through."""
    import json
    import os

    spec = os.environ.get("REALSR_TPU_RATE_ANCHORS", "")
    if spec:
        try:
            got = _parse_anchor_spec(spec)
            if got:
                return got
        except (ValueError, IndexError):
            pass
    try:
        with open(_anchor_file()) as f:
            got = _parse_anchor_spec(json.load(f)["anchors"])
            if got:
                return got
    except (OSError, ValueError, KeyError, IndexError):
        pass
    return _RATE_ANCHORS


def anchor_provenance_notice(device_kind: str) -> str:
    """One-line notice when the cost-model anchors were not measured on
    this kind of card. Returns "" when the anchors' provenance matches: an
    env override is taken as operator intent, a saved calibration file
    counts if its recorded device kind matches, and the shipped table
    counts only on the card it was measured on. ``python -m
    realsr_tpu_torch.tiling.calibrate --save`` clears the notice."""
    import json
    import os

    if os.environ.get("REALSR_TPU_RATE_ANCHORS", ""):
        return ""
    try:
        with open(_anchor_file()) as f:
            saved = json.load(f)
        if _parse_anchor_spec(saved.get("anchors", "")):
            kind = saved.get("device_kind", "")
            if kind == device_kind:
                return ""
            return (
                f"realsr-tpu: planner calibration was measured on "
                f"{kind or 'an unknown device'!s} but this is "
                f"{device_kind}; re-run python -m realsr_tpu_torch.tiling.calibrate --save"
            )
    except (OSError, ValueError, KeyError):
        pass
    if device_kind.startswith(_ANCHOR_DEVICE):
        return ""
    return (
        f"realsr-tpu: tile-size cost anchors were measured on {_ANCHOR_DEVICE}; "
        f"on {device_kind} run python -m realsr_tpu_torch.tiling.calibrate --save "
        "to calibrate (auto tile choice may be suboptimal until then)"
    )


def _px_rate(ph: int, pw: int, anchors=None) -> float:
    """Relative per-padded-pixel cost for a bucket, from its padded side,
    on ``anchors`` (default: :func:`_anchors`)."""
    side = (ph * pw) ** 0.5
    (s0, r0), *rest = anchors or _anchors()
    if side <= s0:
        return r0
    for s1, r1 in rest:
        if side <= s1:
            return r0 + (r1 - r0) * (side - s0) / (s1 - s0)
        s0, r0 = s1, r1
    return r0


def pick_tilesize(
    w: int,
    h: int,
    prepadding: int,
    granule=8,
    candidates: Tuple[int, ...] = _TILE_CANDIDATES,
    n_img: int = 1,
    ndev: int = 1,
    anchors=None,
) -> int:
    """Per-image auto tile size: minimize total padded-tile work.

    The forward cost of a stack of ``n_img`` same-sized images is the sum
    over buckets of ``ceil(n_img*n_bucket/g) * g * padded_h * padded_w`` —
    tiles are chunk-padded to the batching granule (engine) and halo-padded
    by ``prepadding`` (planner), so both pad-waste sources depend on how
    the tile grid lands on the image — weighted by the bucket's measured
    per-pixel cost (_px_rate). ``granule`` may be a callable
    ``tilesize -> g`` so the model uses each candidate's real dispatch
    granule (the engine's batch depends on the tile size). ``ndev``: the
    count a chunk batch is rounded up to a multiple of (1 for the port's
    engine, which deals whole chunks to the mesh's devices). ``anchors``:
    the rate table (default: :func:`_anchors`, read once per call; the
    engine resolves it once at load). Ties break toward larger tiles
    (fewer dispatches).
    """
    gfn = granule if callable(granule) else (lambda _t: granule)
    anchors = anchors or _anchors()
    best = None
    for t in candidates:
        plan = plan_tiles(w, h, t, prepadding)
        g = max(1, gfn(t))
        cost = 0.0
        for (ph, pw), idxs in plan.buckets.items():
            n = len(idxs) * n_img
            nb = min(g, 1 << (n - 1).bit_length())
            nb = -(-nb // ndev) * ndev
            cost += -(-n // nb) * nb * ph * pw * _px_rate(ph, pw, anchors)
        if best is None or cost < best[0] or (cost == best[0] and t > best[1]):
            best = (cost, t)
    return best[1]
