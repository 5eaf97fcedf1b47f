"""Image manager (ref: render/image.h ImageManager, render/image_oiio.cpp).

Collects every image referenced by ImageTexture/EnvironmentTexture nodes,
loads files (utils/image_io.read_image) or takes raw arrays, converts
to linear float32 RGBA and packs them into one padded
(slots, Hmax, Wmax, 4) device array. Shader nodes hold *static* slot
ints, so per-node sampling is a static slice + dynamic (u, v) gather.
"""

from __future__ import annotations

import numpy as np


class TextureStore:
    """Device-side view handed to shader eval contexts."""

    def __init__(self, data, sizes):
        self.data = data          # (S, Hmax, Wmax, 4) — jnp after upload
        self.sizes = sizes        # [(h, w)] python ints (static)

    def get(self, slot):
        if slot < 0 or slot >= len(self.sizes):
            # missing image: mid-gray like the reference's pink would be
            # louder; use white so missing textures are visible but benign
            return self.data[0] * 0 + 1.0, 1, 1
        h, w = self.sizes[slot]
        return self.data[slot], h, w


def _downscale_box(img, limit):
    """Box-filter an image so max(H, W) <= limit (ref:
    render/image.cpp texture_limit handling via OIIO resize)."""
    h, w = img.shape[:2]
    while max(h, w) > limit:
        # halve (pad odd dims by edge replication first)
        if h % 2:
            img = np.concatenate([img, img[-1:]], 0)
            h += 1
        if w % 2:
            img = np.concatenate([img, img[:, -1:]], 1)
            w += 1
        img = (img[0::2, 0::2] + img[1::2, 0::2]
               + img[0::2, 1::2] + img[1::2, 1::2]) * 0.25
        h, w = img.shape[:2]
    return img


def build_mip_chain(img):
    """Full box-filtered mip pyramid down to 1x1 (level 0 = base)."""
    chain = [img]
    while max(img.shape[:2]) > 1:
        img = _downscale_box(
            img, max(1, max(img.shape[:2]) // 2))
        chain.append(img)
    return chain


class ImageManager:
    def __init__(self):
        self.images = []   # list of np (H, W, 4) float32 linear
        self.names = []
        # downscale any image whose max extent exceeds this at pack
        # time (0 = off; ref: render/image.cpp texture_limit)
        self.texture_limit = 0
        # slots that need a mip pyramid packed (auto-mip image nodes)
        self.want_mips = set()

    def add_image(self, source, name=""):
        """source: filename or np array (H, W, C). Returns slot id."""
        if isinstance(source, str):
            from raytracingproject_tpu.utils.image_io import read_image
            arr = read_image(source)
        else:
            arr = np.asarray(source, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
        self.images.append(arr.astype(np.float32))
        self.names.append(name or f"image_{len(self.images)}")
        return len(self.images) - 1

    def replace_image(self, slot, source, name=""):
        """Re-bake into an existing slot (interactive parameter edits
        must not grow the packed texture array without bound)."""
        if not (0 <= slot < len(self.images)):
            return self.add_image(source, name)
        keep, self.images = self.images, []
        new_slot = self.add_image(source, name or self.names[slot])
        arr = self.images[0]
        self.images = keep
        self.images[slot] = arr
        self.names[slot] = name or self.names[slot]
        return slot

    def device_update(self):
        """Pack all images -> (TextureStore-ready data, sizes).

        Applies texture_limit downscaling, then appends mip-pyramid
        levels (for slots in want_mips) as extra rows; mip_slots maps
        base slot -> list of slot ids per level (level 0 = base)."""
        if not self.images:
            data = np.ones((1, 1, 1, 4), np.float32)
            return data, [(1, 1)]
        imgs = list(self.images)
        if self.texture_limit > 0:
            imgs = [_downscale_box(i, int(self.texture_limit))
                    for i in imgs]
        self.mip_slots = {}
        extra = []
        for s in sorted(self.want_mips):
            if not (0 <= s < len(imgs)):
                continue
            chain = build_mip_chain(imgs[s])
            ids = [s]
            for lvl in chain[1:]:
                ids.append(len(imgs) + len(extra))
                extra.append(lvl)
            self.mip_slots[s] = ids
        imgs = imgs + extra
        hmax = max(i.shape[0] for i in imgs)
        wmax = max(i.shape[1] for i in imgs)
        data = np.zeros((len(imgs), hmax, wmax, 4), np.float32)
        sizes = []
        for s, img in enumerate(imgs):
            h, w = img.shape[:2]
            data[s, :h, :w] = img
            sizes.append((h, w))
        return data, sizes
