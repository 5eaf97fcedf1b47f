"""Cryptomatte accumulation (ref: render/film.cpp cryptomatte passes,
kernel_id_passes.h kernel_write_id_slots + util_murmurhash.cpp).

Redesigned for the wavefront renderer: instead of in-kernel id-slot
writes (a scatter per sample inside the wavefront), the Session
renders 1-sample chunks when cryptomatte is enabled and folds each
chunk's first-hit id plane into a host-side top-K (id, count)
accumulator — exact coverage, no device scatters.
"""

from __future__ import annotations

import numpy as np


def murmur_hash3_32(data: bytes, seed=0):
    """MurmurHash3 x86_32 (ref: util_murmurhash.cpp util_murmur_hash3)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    nblocks = len(data) // 4
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * c1) & M
        k = rotl(k, 15)
        k = (k * c2) & M
        h ^= k
        h = rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & M
    tail = data[4 * nblocks:]
    k = 0
    for i, b in enumerate(tail):
        k ^= b << (8 * i)
    if tail:
        k = (k * c1) & M
        k = rotl(k, 15)
        k = (k * c2) & M
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    h ^= h >> 16
    return h


def hash_to_float(h):
    """Reinterpret a 32-bit hash as a finite float32 (ref:
    util_hash_to_float / cryptomatte spec: force exponent into range so
    the value is neither 0, inf nor nan)."""
    exponent = (h >> 23) & 0xFF
    if exponent == 0 or exponent == 255:
        h = (h & ~(0xFF << 23)) | (1 << 23)
    return float(np.uint32(h).view(np.float32))


def name_hash(name):
    return hash_to_float(murmur_hash3_32(str(name).encode("utf-8")))


class CryptoAccumulator:
    """Top-K (id, count) accumulator over per-sample id planes."""

    def __init__(self, height, width, depth=2):
        self.depth = int(depth)
        k = 2 * self.depth + 1  # extra slot absorbs churn
        self.ids = np.full((height, width, k), -1.0, np.float32)
        self.counts = np.zeros((height, width, k), np.float32)

    def add_plane(self, ids, ys, xs):
        """Fold one sample's first-hit id value per pixel (float ids;
        -1 = background/no hit is tracked like any id)."""
        ids = np.asarray(ids, np.float32)
        cur_ids = self.ids[ys, xs]          # (n, k)
        cur_cnt = self.counts[ys, xs]
        match = cur_ids == ids[:, None]
        has = match.any(-1)
        # increment matched slot
        cur_cnt += match.astype(np.float32)
        # insert new ids into the lowest-count slot
        ins = ~has
        if ins.any():
            slot = np.argmin(cur_cnt[ins], axis=-1)
            rows = np.nonzero(ins)[0]
            cur_ids[rows, slot] = ids[rows]
            cur_cnt[rows, slot] = 1.0
        self.ids[ys, xs] = cur_ids
        self.counts[ys, xs] = cur_cnt

    def ranked(self, num_samples, id_to_hash=None):
        """(H, W, depth*2) interleaved [hash, coverage] planes ranked by
        coverage — the cryptomatte layer payload."""
        order = np.argsort(-self.counts, axis=-1)
        ids = np.take_along_axis(self.ids, order, -1)[..., :self.depth]
        cnt = np.take_along_axis(self.counts, order, -1)[..., :self.depth]
        cov = cnt / max(float(num_samples), 1.0)
        if id_to_hash is not None:
            lut_keys = np.array(sorted(id_to_hash), np.float32)
            lut_vals = np.array([id_to_hash[k] for k in sorted(id_to_hash)],
                                np.float32)
            flat = ids.reshape(-1)
            idx = np.searchsorted(lut_keys, flat)
            idx = np.clip(idx, 0, len(lut_keys) - 1)
            ok = lut_keys[idx] == flat
            hashed = np.where(ok, lut_vals[idx], 0.0).reshape(ids.shape)
        else:
            hashed = ids
        hashed = np.where(cov > 0, hashed, 0.0)
        out = np.empty(ids.shape[:2] + (2 * self.depth,), np.float32)
        out[..., 0::2] = hashed
        out[..., 1::2] = cov
        return out
