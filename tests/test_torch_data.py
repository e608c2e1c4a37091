"""pvd_tpu_torch's data layer against cv2 and the JAX package (CPU): the
PNG codec, the JPEG decoder, the blender-format reader (`NeRFDataset`),
the synthetic scene's writer, the area resize, the LPIPS proxy,
`PVDConfig.from_json`, and the small helpers `linear_to_srgb` and
`grid_sample_1d` / `_2d`.

Tolerances: exact everywhere (pixels, JPEG decodes, poses, intrinsics are
the same bytes and the same float32 arithmetic), but the area resize at a
non-integer factor, which may differ from cv2 by one level (cv2 sums in
float32, the port in float64), the LPIPS proxy, the JAX package's own
torch code, to 1e-6 relative, `linear_to_srgb` to 2 ulps (its power is
libm's, not XLA's) and the 1-D and 2-D linear samples to 1e-6 x their
max (XLA:CPU contracts the weighted sums into FMAs).
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
from pvd_tpu.ops.grid_sample import grid_sample_1d as j_grid_sample_1d
from pvd_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample_2d
from pvd_tpu.utils.metrics import lpips_available as j_lpips_available
from pvd_tpu.utils.metrics import lpips_proxy as j_lpips_proxy
from pvd_tpu.utils.misc import linear_to_srgb as j_linear_to_srgb
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
from pvd_tpu_torch.data.png import read_png, write_png
from pvd_tpu_torch.data.provider import NeRFDataset, imread, resize_area
from pvd_tpu_torch.data.synth import (make_synthetic_scene,
                                      write_synthetic_scene)
from pvd_tpu_torch.ops.grid_sample import grid_sample_1d, grid_sample_2d
from pvd_tpu_torch.utils.metrics import (lpips_available, lpips_proxy,
                                         rgb_lpips)
from pvd_tpu_torch.utils.misc import linear_to_srgb

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
    """The options this test once saw refused now load with their values:
    A14's stratified counts, which reach the RenderSpec as in the JAX
    package (no Trainer path reads them), and A17's `mesh_shape`, which
    the JAX package declares and never reads (the port carries it
    unused)."""
    text = JPVDConfig(hash_bake_dense=True).to_json()
    raw = json.loads(text)
    raw[field] = value
    got = PVDConfig.from_json(json.dumps(raw))
    if item == "A17":
        assert got.mesh_shape == (2, 2)
        return
    assert getattr(got, field) == value
    assert getattr(got.render_spec(), field) == value


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


# ---- JPEG frames --------------------------------------------------------

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _cv2_jpeg(img, quality, sampling="444", restart=0):
    """(JPEG bytes cv2 writes for RGB or grey `img`, cv2's decode of them
    as RGB [H, W, 3] or grey [H, W, 1])."""
    bgr = img[..., 0] if img.shape[-1] == 1 else img[..., ::-1]
    ok, buf = cv2.imencode(".jpg", bgr, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    dec = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    return buf.tobytes(), dec[..., None] if dec.ndim == 2 else dec[..., ::-1]


def _photo(H, W, C, seed):
    """Gradients plus noise: every DCT frequency and chroma in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([x * 255.0 / W, y * 255.0 / H, (x + y) * 0.5], -1)
    img = np.clip(base + rng.normal(0, 30, (H, W, 3)), 0, 255)
    return img.astype(np.uint8)[..., :C]


@pytest.mark.parametrize("C,quality,sampling,restart,H,W", [
    (1, 50, "444", 0, 29, 37), (1, 95, "444", 2, 64, 48),
    (3, 95, "444", 0, 32, 32), (3, 50, "422", 0, 23, 41),
    (3, 95, "422", 1, 17, 33), (3, 50, "420", 0, 31, 45),
    (3, 95, "420", 3, 48, 64), (3, 95, "420", 0, 1, 1),
    (3, 50, "420", 0, 2, 3), (3, 90, "440", 0, 22, 30),
    (3, 75, "411", 0, 20, 50), (3, 95, "420", 0, 127, 201)],
    ids=["grey-q50", "grey-q95-rst2", "444-q95", "422-q50", "422-q95-rst1",
         "420-q50-odd", "420-q95-rst3", "420-1x1", "420-2x3", "440-q90",
         "411-q75", "420-q95-large"])
def test_jpeg_matches_cv2(C, quality, sampling, restart, H, W):
    """cv2's own files decode to cv2's pixels, bit for bit: libjpeg's
    integer IDCT, fancy upsampling at the edges of odd sizes, restart
    intervals, its YCbCr -> RGB."""
    data, want = _cv2_jpeg(_photo(H, W, C, seed=H * W + C), quality,
                           sampling, restart)
    assert (b"\xff\xd0" in data) == bool(restart and H * W > 64)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (H, W, C)
    np.testing.assert_array_equal(got, want)


def test_jpeg_fixtures_match_their_cv2_decodes():
    """The committed fixtures (tools/make_jpeg_fixtures.py), which
    chip_smoke.py decodes on the card's machine, against their committed
    cv2 decodes and against cv2 here."""
    names = sorted(f[:-4] for f in os.listdir(JPEG_DIR)
                   if f.endswith(".jpg") and f != "progressive.jpg")
    assert len(names) == 8
    for name in names:
        path = os.path.join(JPEG_DIR, name + ".jpg")
        got = read_jpeg(path)
        want = read_png(os.path.join(JPEG_DIR, name + ".png"))
        np.testing.assert_array_equal(got, want.reshape(got.shape))
        np.testing.assert_array_equal(imread(path), j_imread(path))


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """data with byte `offset` of the first `marker` segment's payload set
    to value."""
    at = data.index(bytes([0xFF, marker])) + 4 + offset
    return data[:at] + bytes([value]) + data[at + 1:]


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "lossless",
                                  "12bit", "cmyk", "truncated", "not_jpeg"])
def test_jpeg_refuses_what_it_does_not_read(kind):
    data, _ = _cv2_jpeg(_photo(16, 16, 3, seed=1), 90)
    sof = data.index(b"\xff\xc0")
    if kind == "progressive":
        with open(os.path.join(JPEG_DIR, "progressive.jpg"), "rb") as f:
            data = f.read()
    elif kind in ("arithmetic", "lossless"):
        code = 0xC9 if kind == "arithmetic" else 0xC3
        data = data[:sof + 1] + bytes([code]) + data[sof + 2:]
    elif kind == "12bit":
        data = _patched(data, 0xC0, 0, 12)
    elif kind == "cmyk":
        data = _patched(data, 0xC0, 5, 4)
    elif kind == "truncated":
        data = data[:sof + 6]
    else:
        data = b"\x89PNG" + data[4:]
    match = {"progressive": "progressive", "arithmetic": "arithmetic",
             "lossless": "lossless", "12bit": "12-bit", "cmyk": "CMYK",
             "truncated": "truncated", "not_jpeg": "not a JPEG"}[kind]
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)


def test_imread_picks_the_decoder_by_content(tmp_path):
    """The provider reads a file by its first bytes, whatever its name:
    a JPEG as the JAX package's cv2 reader reads it, grey as RGB."""
    for C in (3, 1):
        data, want = _cv2_jpeg(_photo(20, 28, C, seed=C), 80, "420")
        for name in ("frame.jpg", "frame.png"):
            path = tmp_path / name
            path.write_bytes(data)
            got = imread(str(path))
            np.testing.assert_array_equal(got, want.repeat(4 - C, -1)
                                          if C == 1 else want)
            if name.endswith(".jpg"):
                np.testing.assert_array_equal(got, j_imread(str(path)))
    write_png(tmp_path / "png.jpg", _photo(5, 6, 3, seed=0))
    np.testing.assert_array_equal(imread(str(tmp_path / "png.jpg")),
                                  _photo(5, 6, 3, seed=0))


def test_scene_with_jpeg_frames_reads_as_in_jax(tmp_path):
    """A blender-format scene whose frames are JPEGs (.jpg in file_path,
    as the reference's real scenes have them): both providers give the
    same images, poses and intrinsics."""
    root = j_make_scene(str(tmp_path), n_train=4, n_val=1, n_test=2, H=40,
                        W=40, seed=9)
    for split in ("train", "val", "test"):
        tpath = os.path.join(root, f"transforms_{split}.json")
        with open(tpath) as f:
            meta = json.load(f)
        for fr in meta["frames"]:
            png = os.path.join(root, fr["file_path"] + ".png")
            rgb = _cv2_rgb(png)[..., :3]
            data, _ = _cv2_jpeg(rgb, 90, "420")
            with open(os.path.join(root, fr["file_path"] + ".jpg"),
                      "wb") as f:
                f.write(data)
            os.remove(png)
            fr["file_path"] += ".jpg"
        with open(tpath, "w") as f:
            json.dump(meta, f)
    for split in ("train", "test", "all"):
        want = JNeRFDataset(JPVDConfig(path=root), split)
        got = NeRFDataset(PVDConfig(path=root), split)
        assert got.images.shape == want.images.shape == (
            len(want), 40, 40, 3)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.poses, want.poses)
        np.testing.assert_array_equal(got.intrinsics, want.intrinsics)


# ---- small helpers ------------------------------------------------------

def test_linear_to_srgb_matches_jax():
    x = np.concatenate([np.linspace(0.0, 0.01, 257),
                        np.random.default_rng(0).uniform(0, 1, 1000)])
    x = x.astype(np.float32)
    got = linear_to_srgb(torch.from_numpy(x)).numpy()
    want = np.asarray(j_linear_to_srgb(x))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


@pytest.mark.parametrize("dim", [1, 2])
def test_grid_sample_1d_2d_match_jax(dim):
    """Corners inside, on and outside the edges (zero padding)."""
    rng = np.random.default_rng(dim)
    table = rng.normal(size=(9, 7, 5)[:dim] + (4,)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (300, dim)).astype(np.float32)
    coords[:4] = [[-1.0] * dim, [1.0] * dim, [0.0] * dim, [1.1] * dim]
    if dim == 1:
        got = grid_sample_1d(torch.from_numpy(table),
                             torch.from_numpy(coords[:, 0]))
        want = j_grid_sample_1d(table, coords[:, 0])
    else:
        got = grid_sample_2d(torch.from_numpy(table),
                             torch.from_numpy(coords))
        want = j_grid_sample_2d(table, coords)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(want[3]).max() > 0 and (got.numpy()[3] == want[3]).all()


def test_lpips_is_none_without_the_package():
    """rgb_lpips gives None where the lpips package is missing, as the
    JAX package's does (the Trainer then reports lpips_proxy)."""
    assert lpips_available() == j_lpips_available()
    img = np.zeros((8, 8, 3), np.float32)
    if not lpips_available():
        assert rgb_lpips(img, img) is None
