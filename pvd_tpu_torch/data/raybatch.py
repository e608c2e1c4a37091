"""Host-side ray batches for teacher training (port of
pvd_tpu/data/raybatch.py).

`RayBatcher` binds the port's own copy of the native producer
(`csrc/raybatch.cpp`) through ctypes: threads that draw (image index, pixel
ids, GT pixels) batches from a preloaded image cache into a bounded queue,
each thread from its own PCG32 stream.  With `n_threads=1` the batches are
a deterministic function of the seed (with more threads their order
depends on timing).  The library is built with g++ at first use into
`build/raybatch/` beside the package (git-ignored; `data/hostlib.py`),
named by a hash of the source and flags so an edited source rebuilds;
nothing is built at import time.  The library is always this native
producer: a failed build raises, since the batcher has no second random
stream to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np

from pvd_tpu_torch.data import hostlib

SOURCE = hostlib.CSRC / "raybatch.cpp"
BUILD_DIR = hostlib.BUILD_ROOT / "raybatch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


def library_path() -> Path:
    return hostlib.library_path(SOURCE, BUILD_DIR, GXX_FLAGS)


def build() -> Path:
    """Compile the producer (once per source); raises when g++ fails."""
    return hostlib.build(SOURCE, BUILD_DIR, GXX_FLAGS)


@functools.cache
def load() -> ctypes.CDLL:
    """The producer library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.rb_next.restype = ctypes.c_int
    lib.rb_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    return lib


class RayBatcher:
    """Producer of (img_index, inds [n_rays] int32, pixels [n_rays, C]
    float32) batches over `images` [B, H, W, C]; the batcher keeps a
    contiguous float32 copy alive for the producer threads, which read it
    without copying."""

    def __init__(self, images: np.ndarray, n_rays: int, seed: int = 0,
                 queue_depth: int = 4, n_threads: int = 2):
        self._handle = None
        if images.ndim != 4:
            raise ValueError("images must be [B, H, W, C]")
        self._images = np.ascontiguousarray(images, np.float32)
        b, h, w, c = self._images.shape
        self.n_rays = n_rays
        self.channels = c
        self._hw = h * w
        self._lib = load()
        self._handle = self._lib.rb_create(
            self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            b, h, w, c, n_rays, seed, queue_depth, n_threads)
        self._inds = np.empty(n_rays, np.int32)
        self._pix = np.empty((n_rays, c), np.float32)

    def next(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """The next batch from the queue (blocks until one is ready)."""
        if self._handle is None:
            raise RuntimeError("RayBatcher is closed")
        img_idx = self._lib.rb_next(
            self._handle,
            self._inds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._pix.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return img_idx, self._inds.copy(), self._pix.copy()

    def gather(self, img_idx: int, inds: np.ndarray) -> np.ndarray:
        """Pixels [len(inds), C] of image `img_idx` at caller-chosen pixel
        ids (the error map's importance draw, raybatch.py:100-107)."""
        flat = self._images.reshape(len(self._images), self._hw,
                                    self.channels)
        return flat[int(img_idx), np.asarray(inds, np.int64)]

    def close(self):
        """Stop and join the producer threads."""
        if self._handle is not None:
            self._lib.rb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
