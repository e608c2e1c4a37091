"""pvd_tpu_torch's data layer against cv2 and the JAX package (CPU): the
PNG codec, the blender-format reader (`NeRFDataset`), the synthetic
scene's writer, the area resize, the LPIPS proxy and `PVDConfig.from_json`.

Tolerances: exact everywhere (pixels, poses, intrinsics are the same
bytes and the same float32 arithmetic), but the area resize at a
non-integer factor, which may differ from cv2 by one level (cv2 sums in
float32, the port in float64), and the LPIPS proxy, the JAX package's own
torch code, to 1e-6 relative.
"""

import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.data.provider import NeRFDataset as JNeRFDataset
from pvd_tpu.data.provider import _imread as j_imread
from pvd_tpu.data.synth import make_synthetic_scene as j_make_scene
from pvd_tpu.utils.metrics import lpips_proxy as j_lpips_proxy
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.png import read_png, write_png
from pvd_tpu_torch.data.provider import NeRFDataset, imread, resize_area
from pvd_tpu_torch.data.synth import (make_synthetic_scene,
                                      write_synthetic_scene)
from pvd_tpu_torch.utils.metrics import lpips_proxy

torch.set_num_threads(1)

CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(path, img, ftypes, color_type=None, depth=8, interlace=0):
    """A PNG written by hand: row y filtered with ftypes[y % len(ftypes)]."""
    H, W, C = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[C] if color_type is None \
        else color_type
    cur_all = img.reshape(H, W * C).astype(np.int64)
    raw = b""
    prev = np.zeros(W * C, np.int64)
    for y in range(H):
        cur = cur_all[y]
        a = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        c = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        t = ftypes[y % len(ftypes)]
        pred = [0 * cur, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][t]
        raw += bytes([t]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                             color_type, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _cv2_rgb(path):
    """cv2's read in RGB(A) order, [H, W, C]."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        return img[..., None]
    return img[..., [2, 1, 0, 3][:img.shape[-1]]]


def _image(C, seed=0, H=23, W=31):
    """Noise over a gradient: rows whose filters all have work to do."""
    rng = np.random.default_rng(seed)
    grad = (np.arange(W)[None, :, None] * 7 + np.arange(H)[:, None, None] * 3
            + np.arange(C)[None, None, :] * 50)
    return ((grad + rng.integers(0, 20, (H, W, C))) % 256).astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("C", [1, 2, 3, 4], ids=["grey", "grey_alpha", "rgb",
                                                 "rgba"])
def test_png_reads_each_filter(tmp_path, ftype, C):
    """Every filter type (and all five mixed row by row), each 8-bit
    colour type; cv2 reads the same file to the same pixels."""
    img = _image(C, seed=ftype)
    for ftypes in ([ftype], [0, 1, 2, 3, 4]):
        path = tmp_path / f"f{ftype}_{C}.png"
        _encode(path, img, ftypes)
        np.testing.assert_array_equal(read_png(path), img)
        if C != 2:  # cv2 reads grey + alpha as BGRA
            np.testing.assert_array_equal(_cv2_rgb(path), img)


@pytest.mark.parametrize("C", [1, 3, 4], ids=["grey", "rgb", "rgba"])
def test_png_matches_cv2_both_ways(tmp_path, C):
    """Files cv2 writes (its own filter choice) read back exactly, and
    files the port writes read back exactly in cv2."""
    img = _image(C, seed=10 + C, H=40, W=57)
    theirs = tmp_path / "cv2.png"
    bgr = img if C == 1 else img[..., [2, 1, 0, 3][:C]]
    cv2.imwrite(str(theirs), bgr[..., 0] if C == 1 else bgr)
    np.testing.assert_array_equal(read_png(theirs), img)
    ours = tmp_path / "port.png"
    write_png(ours, img)
    np.testing.assert_array_equal(_cv2_rgb(ours), img)
    # the provider's reader gives what the JAX package's cv2 reader gives
    np.testing.assert_array_equal(imread(str(theirs)), j_imread(str(theirs)))


def test_grey_alpha_reads_as_the_jax_reader_does(tmp_path):
    img = _image(2, seed=7)
    path = tmp_path / "ga.png"
    _encode(path, img, [4])
    np.testing.assert_array_equal(imread(str(path)), j_imread(str(path)))


@pytest.mark.parametrize("kind", ["16bit", "palette", "interlaced",
                                  "not_png"])
def test_png_refuses_what_it_does_not_read(tmp_path, kind):
    path = tmp_path / "x.png"
    img = _image(3, H=4, W=4)
    if kind == "not_png":
        path.write_bytes(b"GIF89a" + bytes(40))
    else:
        _encode(path, img, [0], color_type=3 if kind == "palette" else None,
                depth=16 if kind == "16bit" else 8,
                interlace=int(kind == "interlaced"))
    with pytest.raises(ValueError):
        read_png(path)


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_scene"))
    return j_make_scene(root, n_train=5, n_val=2, n_test=3, H=32, W=32,
                        seed=3)


@pytest.mark.parametrize("split,downscale", [
    ("train", 1), ("val", 1), ("test", 1), ("all", 1), ("trainval", 1),
    ("train", 2)])
def test_dataset_matches_jax(jax_scene, split, downscale):
    """The port's reader on a scene written by the JAX package's cv2
    writer: images, poses, intrinsics and radius exact."""
    kw = dict(path=jax_scene, scale=0.7)
    want = JNeRFDataset(JPVDConfig(**kw), split, downscale=downscale)
    got = NeRFDataset(PVDConfig(**kw), split, downscale=downscale)
    assert (got.H, got.W) == (want.H, want.W) == (32 // downscale,) * 2
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    assert got.radius == want.radius and len(got) == len(want)
    assert got.images_flat().shape == (len(got), got.H * got.W, 4)


def test_dataset_skips_missing_frames_and_makes_the_error_map(jax_scene):
    os.rename(os.path.join(jax_scene, "train", "r_1.png"),
              os.path.join(jax_scene, "train", "hidden.png"))
    try:
        kw = dict(path=jax_scene, error_map=True)
        got = NeRFDataset(PVDConfig(**kw), "train")
        want = JNeRFDataset(JPVDConfig(**kw), "train")
    finally:
        os.rename(os.path.join(jax_scene, "train", "hidden.png"),
                  os.path.join(jax_scene, "train", "r_1.png"))
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.error_map, want.error_map)
    assert NeRFDataset(PVDConfig(**kw), "test").error_map is None


def test_scene_writer_matches_jax(jax_scene, tmp_path):
    """The same seed writes the same frames, poses, camera angle and
    pixels as the JAX package's writer."""
    ours = write_synthetic_scene(str(tmp_path), n_train=5, n_val=2,
                                 n_test=3, H=32, W=32, seed=3)
    for split, n in (("train", 5), ("val", 2), ("test", 3)):
        name = f"transforms_{split}.json"
        with open(os.path.join(ours, name)) as f:
            mine = json.load(f)
        with open(os.path.join(jax_scene, name)) as f:
            theirs = json.load(f)
        assert mine == theirs and len(mine["frames"]) == n
        for fr in mine["frames"]:
            p = fr["file_path"] + ".png"
            np.testing.assert_array_equal(
                read_png(os.path.join(ours, p)),
                _cv2_rgb(os.path.join(jax_scene, p)))


def test_in_memory_scene_is_the_written_one(tmp_path):
    """make_synthetic_scene keeps its meaning: the arrays NeRFDataset
    reads back from write_synthetic_scene's files."""
    kw = dict(n_train=4, n_val=1, n_test=2, H=24, W=24, seed=5)
    mem = make_synthetic_scene(**kw, scale=0.8)
    root = write_synthetic_scene(str(tmp_path), **kw)
    for split in ("train", "val", "test"):
        ds = NeRFDataset(PVDConfig(path=root, scale=0.8), split)
        np.testing.assert_array_equal(mem[split].images, ds.images)
        np.testing.assert_array_equal(mem[split].poses, ds.poses)
        np.testing.assert_array_equal(mem[split].intrinsics, ds.intrinsics)


@pytest.mark.parametrize("f", [2, 3, 4, 6])
def test_resize_area_integer_factors_match_cv2(f):
    rng = np.random.default_rng(f)
    for C in (3, 4):
        img = rng.integers(0, 256, (7 * f, 9 * f, C), dtype=np.uint8)
        want = cv2.resize(img, (9, 7), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(img, 7, 9), want)


def test_resize_area_other_factors_within_one_level_of_cv2():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (49, 61, 4), dtype=np.uint8)
    for H, W in ((24, 30), (7, 7), (20, 13)):
        want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        got = resize_area(img, H, W)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_lpips_proxy_matches_jax():
    rng = np.random.default_rng(4)
    a, b = rng.uniform(size=(2, 40, 36, 3)).astype(np.float32)
    np.testing.assert_allclose(lpips_proxy(a, b), j_lpips_proxy(a, b),
                               rtol=1e-6)
    assert lpips_proxy(a, a) == 0.0


@pytest.mark.parametrize("field,value,item", [
    ("upsample_steps", 8, "A14"), ("num_steps", 64, "A14"),
    ("mesh_shape", [2, 2], "A17")])
def test_from_json_raises_for_unported_options(field, value, item):
    """A JAX config that sets an option the port lacks raises, naming the
    option and its ROADMAP item, instead of loading without it.  A17's
    `mesh_shape` is ported: the JAX package declares it and never reads
    it, and the port carries it unused."""
    text = JPVDConfig(hash_bake_dense=True).to_json()
    raw = json.loads(text)
    raw[field] = value
    if item == "A17":
        assert PVDConfig.from_json(json.dumps(raw)).mesh_shape == (2, 2)
        return
    with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP {item}"):
        PVDConfig.from_json(json.dumps(raw))


def test_from_json_loads_the_ported_options():
    """A JAX config at the defaults of what the port lacks loads, with the
    ported fields (hash_bake_dense among them) as the JAX config has them;
    keys neither package has are dropped."""
    want = JPVDConfig(hash_bake_dense=True, hash_cell_levels=9, path="/s",
                      ckpt="scratch", downscale=2, resolution1=512,
                      wall_budget=60.0, tensorboard=False, PE=6,
                      nerf_layer_num=5, nerf_layer_wide=64, skip=2,
                      plenoxel_degree=2, plenoxel_res=(12, 14, 16),
                      enable_edit_plenoxel=True)
    raw = json.loads(want.to_json())
    raw["no_such_option"] = 1
    got = PVDConfig.from_json(json.dumps(raw))
    for k, v in json.loads(got.to_json()).items():
        assert raw[k] == v, k
    assert got.model_spec("hash").hash_bake_dense
