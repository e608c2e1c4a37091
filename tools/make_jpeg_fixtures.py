"""Write the JPEG fixtures of the port's decoder tests with cv2.

    python tools/make_jpeg_fixtures.py [OUT_DIR]   (default tests/data/jpeg)

Each fixture is a small seeded image (gradients plus noise) encoded by cv2
(libjpeg-turbo) at one quality, chroma sampling and restart interval,
stored as `<name>.jpg` beside cv2's own decode of it as `<name>.png` (RGB,
or one channel for grey).  `progressive.jpg`, a progressive file, has no
decode: the port's decoder refuses it.  `tests/test_torch_data.py` and
`chip_smoke.py` hold `pvd_tpu_torch.data.jpeg` against the PNGs bit for
bit.  Needs cv2 and numpy only.
"""

from __future__ import annotations

import os
import sys

import cv2
import numpy as np

# name: (H, W, quality, sampling, restart interval in MCUs, grey)
FIXTURES = {
    "grey_q50": (29, 37, 50, "444", 0, True),
    "s444_q95": (29, 37, 95, "444", 0, False),
    "s422_q50": (23, 41, 50, "422", 0, False),
    "s420_q95": (31, 45, 95, "420", 0, False),
    "s420_q50_rst2": (48, 64, 50, "420", 2, False),
    "s422_q95_rst1": (17, 33, 95, "422", 1, False),
    "s440_q90": (22, 30, 90, "440", 0, False),
    "s411_q75": (20, 50, 75, "411", 0, False),
}
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 3] uint8 RGB: three gradients plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h)], -1)
    return np.clip(base + rng.normal(0.0, 25.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def main(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for i, (name, (h, w, q, samp, rst, grey)) in enumerate(FIXTURES.items()):
        img = image(h, w, i)
        bgr = img[..., 0] if grey else img[..., ::-1]
        ok, buf = cv2.imencode(".jpg", bgr, [
            cv2.IMWRITE_JPEG_QUALITY, q,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[samp],
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok
        buf.tofile(os.path.join(out, f"{name}.jpg"))
        # cv2's decode, stored as cv2 writes it (BGR order in the call)
        cv2.imwrite(os.path.join(out, f"{name}.png"),
                    cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    ok, buf = cv2.imencode(".jpg", image(24, 24, 99)[..., ::-1],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    buf.tofile(os.path.join(out, "progressive.jpg"))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "jpeg"))
