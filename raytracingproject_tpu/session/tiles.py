"""Tile manager (ref: render/tile.cpp TileManager).

The natural work unit is the whole-frame wavefront, so tiles are
for (a) bounding device memory on huge frames, (b) progressive viewport
updates, (c) multi-host frame splits. The manager keeps the reference's
contract: tile generation with ordering strategies (center/left-right/
top-bottom/hilbert-ish spiral), per-tile state machine, progressive
sample advance, and resumable sample-range chunks
(ref: tile.h:122-131 range_start_sample/range_num_samples).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# tile states (ref: render/tile.h:34-40)
TILE_RENDER = 0
TILE_RENDERED = 1
TILE_DENOISE = 2
TILE_DENOISED = 3
TILE_DONE = 4

ORDER_CENTER = "center"
ORDER_RIGHT_TO_LEFT = "right_to_left"
ORDER_LEFT_TO_RIGHT = "left_to_right"
ORDER_TOP_TO_BOTTOM = "top_to_bottom"
ORDER_BOTTOM_TO_TOP = "bottom_to_top"
ORDER_SPIRAL = "spiral"


@dataclass
class Tile:
    index: int
    x: int
    y: int
    w: int
    h: int
    state: int = TILE_RENDER
    sample: int = 0


@dataclass
class TileSlice:
    """Per-sample-chunk work descriptor."""
    tiles: list = field(default_factory=list)
    start_sample: int = 0
    num_samples: int = 0
    resolution_divider: int = 1


class TileManager:
    def __init__(self, width, height, tile_size=0, order=ORDER_CENTER,
                 progressive=True, num_samples=0,
                 range_start_sample=-1, range_num_samples=-1,
                 progressive_chunk=16):
        self.width = width
        self.height = height
        self.tile_size = tile_size  # 0 = whole frame
        self.order = order
        self.progressive = progressive
        self.num_samples = num_samples
        # resumable chunk support (ref: tile.cpp:555-613)
        self.range_start_sample = range_start_sample
        self.range_num_samples = range_num_samples
        self.progressive_chunk = progressive_chunk
        self.reset()

    # ref: TileManager::start_resolution_divider viewport preview
    def reset(self, start_resolution=1):
        self.sample = self.start_sample
        self.resolution_divider = start_resolution
        self.tiles = self.gen_tiles()
        self.done = False

    @property
    def start_sample(self):
        return self.range_start_sample if self.range_start_sample >= 0 else 0

    @property
    def end_sample(self):
        if self.range_num_samples >= 0:
            return self.start_sample + self.range_num_samples
        return self.num_samples

    def gen_tiles(self):
        """ref: TileManager::gen_tiles ordering strategies."""
        ts = self.tile_size or max(self.width, self.height)
        tiles = []
        idx = 0
        for ty in range(0, self.height, ts):
            for tx in range(0, self.width, ts):
                tiles.append(Tile(idx, tx, ty, min(ts, self.width - tx),
                                  min(ts, self.height - ty)))
                idx += 1
        cx, cy = self.width / 2, self.height / 2

        def center_key(t):
            return (t.x + t.w / 2 - cx) ** 2 + (t.y + t.h / 2 - cy) ** 2

        if self.order == ORDER_CENTER:
            tiles.sort(key=center_key)
        elif self.order == ORDER_SPIRAL:
            tiles.sort(key=lambda t: np.arctan2(t.y + t.h / 2 - cy,
                                                t.x + t.w / 2 - cx)
                       + 4 * np.sqrt(center_key(t)) / max(self.width, 1))
        elif self.order == ORDER_RIGHT_TO_LEFT:
            tiles.sort(key=lambda t: -t.x)
        elif self.order == ORDER_TOP_TO_BOTTOM:
            tiles.sort(key=lambda t: -t.y)
        elif self.order == ORDER_BOTTOM_TO_TOP:
            tiles.sort(key=lambda t: t.y)
        # left_to_right is the generation order
        return tiles

    def next(self):
        """Next work slice or None (ref: TileManager::next: progressive
        mode advances samples across all tiles; batch mode renders each
        tile to completion)."""
        if self.done or self.sample >= self.end_sample:
            self.done = True
            return None
        if self.progressive:
            chunk = min(self.progressive_chunk, self.end_sample - self.sample)
            s = TileSlice(tiles=list(self.tiles), start_sample=self.sample,
                          num_samples=chunk,
                          resolution_divider=self.resolution_divider)
            self.sample += chunk
            return s
        # batch: all samples at once, tile by tile handled by caller
        s = TileSlice(tiles=list(self.tiles), start_sample=self.sample,
                      num_samples=self.end_sample - self.sample)
        self.sample = self.end_sample
        return s

    def progress_fraction(self):
        total = self.end_sample - self.start_sample
        if total <= 0:
            return 1.0
        return (self.sample - self.start_sample) / total
