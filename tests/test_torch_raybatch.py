"""pvd_tpu_torch's host batcher (`data/raybatch.py` over its own copy of the
native producer) against the JAX package's, and the Trainer's host-batcher
path (CPU).

With one producer thread a batcher's batches are a function of its seed:
the port's equal the JAX package's native library's bit for bit (image
index, pixel ids, pixels), RGB and RGBA.  With two threads each batch
still holds the pixels at its ids.  A failed build raises instead of
drawing from another random stream.  The Trainer with preload=False
trains from the batcher and records it in `train_stats`.
"""

import numpy as np
import pytest
import torch

from pvd_tpu.data.raybatch import RayBatcher as JRayBatcher
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data import raybatch
from pvd_tpu_torch.data.raybatch import RayBatcher
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine.trainer import Trainer

torch.set_num_threads(1)


def _images(b, h, w, c, seed=0):
    return np.random.default_rng(seed).uniform(size=(b, h, w, c)) \
        .astype(np.float32)


@pytest.mark.parametrize("shape,n_rays,seed", [
    ((5, 32, 32, 4), 128, 0), ((3, 17, 23, 3), 1000, 7),
    ((40, 8, 8, 4), 4096, 12345)], ids=["rgba", "rgb-odd", "many-rays"])
def test_batches_equal_jax_native(shape, n_rays, seed):
    images = _images(*shape, seed=seed)
    ours = RayBatcher(images, n_rays, seed=seed, n_threads=1)
    theirs = JRayBatcher(images, n_rays, seed=seed, n_threads=1)
    # the JAX package's batcher falls back to numpy without its library
    assert theirs.is_native
    try:
        idxs = set()
        for _ in range(30):
            a, b = ours.next(), theirs.next()
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
            assert a[1].dtype == np.int32 and a[2].dtype == np.float32
            assert a[2].shape == (n_rays, shape[-1])
            idxs.add(a[0])
        assert len(idxs) > 1
        inds = np.array([0, 5, shape[1] * shape[2] - 1])
        np.testing.assert_array_equal(ours.gather(1, inds),
                                      theirs.gather(1, inds))
    finally:
        ours.close()
        theirs.close()


def test_two_threads_give_valid_batches():
    images = _images(4, 16, 16, 4, seed=3)
    flat = images.reshape(4, 256, 4)
    b = RayBatcher(images, 512, seed=1)
    for _ in range(20):
        idx, inds, pix = b.next()
        assert 0 <= idx < 4 and 0 <= inds.min() and inds.max() < 256
        np.testing.assert_array_equal(pix, flat[idx, inds])
    b.close()
    b.close()  # closing twice is harmless
    with pytest.raises(RuntimeError, match="closed"):
        b.next()


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises."""
    bad = tmp_path / "raybatch.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(raybatch, "SOURCE", bad)
    monkeypatch.setattr(raybatch, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        raybatch.build()
    with pytest.raises(ValueError):
        RayBatcher(np.zeros((4, 4, 3), np.float32), 8)


def test_trainer_trains_from_the_host_batcher(tmp_path):
    """preload=False: 20 steps of batches from the batcher, padded then
    compacted; the loss is finite and the batch PSNR rises."""
    scene = make_synthetic_scene(n_train=4, n_val=0, n_test=0, H=24, W=24,
                                 seed=1)
    cfg = PVDConfig(preload=False, num_rays=256, grid_size=16, max_steps=64,
                    max_samples=24, update_extra_interval=1, iters=20,
                    model_type="tensors", plenoxel_res=(16, 16, 16), lr=5e-2,
                    workspace=str(tmp_path))
    tr = Trainer(cfg, device="cpu")
    tr.train(scene["train"])
    stats = tr.train_stats
    assert stats["host_batcher"] is True and stats["train_steps"] == 20
    assert stats["padded_steps"] == 16 and stats["compacted_steps"] == 4
    psnr = [float(m["psnr"]) for m in tr.history]
    assert np.isfinite(psnr).all() and np.mean(psnr[-4:]) > np.mean(psnr[:4])
