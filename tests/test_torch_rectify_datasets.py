"""Stereo rectification, the dataset loaders and the PNG reader on both
packages (CPU).

- `ops/rectify.py` at EuRoC's factory calibration (752x480):
  `stereo_rectify` within 1e-9, `rectify_map` within 1e-3 px (the
  reference's distortion runs in float32), `remap_bilinear` and
  `StereoRectifier` within 1e-3 gray levels.
- `utils/datasets.py`: the TUM, EuRoC (with and without a sensor.yaml) and
  KITTI loaders on small directories this file writes: equal pairs, ground
  truth within 1e-6.
- `read_png` / `read_image_gray` / `read_depth_tum` equal to the reference's
  PIL reads: PNGs written by PIL (gray, RGB, RGBA, 16-bit gray), PNGs whose
  rows carry each of the five filter types, and the port's `encode_png` /
  `viz.write_png`. The port imports no PIL; this file reads the reference's
  way only where PIL is installed.
"""

import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.ops import rectify as jrectify
from orb_slam2v2_1_tpu.utils import datasets as jdatasets

from orb_slam2v2_1_tpu_torch.ops import rectify
from orb_slam2v2_1_tpu_torch.utils import datasets, viz

torch.set_num_threads(2)

CAL = datasets.EUROC_CALIB


def _calib_args():
    return (CAL["K1"], CAL["D1"], CAL["K2"], CAL["D2"], CAL["R"], CAL["T"], CAL["size"])


def test_euroc_calibration_constants_equal():
    np.testing.assert_array_equal(datasets.EUROC_CAM0_T_BS, jdatasets.EUROC_CAM0_T_BS)
    assert datasets.EUROC_CALIB == jdatasets.EUROC_CALIB


def test_stereo_rectify_parity():
    ref = jrectify.stereo_rectify(*_calib_args())
    got = rectify.stereo_rectify(*_calib_args())
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-9, err_msg=k)


@pytest.mark.parametrize("eye", [1, 2])
def test_rectify_map_parity(eye):
    c = rectify.stereo_rectify(*_calib_args())
    args = (c[f"K{eye}"], c[f"D{eye}"], c[f"R{eye}"], c["K_new"], CAL["size"])
    ref = jrectify.rectify_map(*args)
    got = rectify.rectify_map(*args)
    assert got.shape == ref.shape == (480, 752, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_remap_and_rectifier_parity(rng):
    W, H = CAL["size"]
    left = (rng.random((H, W)) * 255).astype(np.float32)
    right = (rng.random((H, W)) * 255).astype(np.float32)
    jr = jrectify.StereoRectifier(*_calib_args())
    tr = rectify.StereoRectifier(*_calib_args(), device="cpu")
    np.testing.assert_allclose(tr.maps.numpy(), np.asarray(jr.maps), atol=1e-3)
    assert tr.K == pytest.approx(jr.K, abs=1e-9) and tr.bf == pytest.approx(jr.bf, abs=1e-9)
    # The maps agree to 1e-3 px; on noise images that moves a sample by up
    # to a quarter gray level, so the resampling is held on one set of maps.
    maps = np.asarray(jr.maps)
    tr.maps = torch.from_numpy(maps.copy())
    ref_l, ref_r = jr(jnp.asarray(left), jnp.asarray(right))
    got_l, got_r = tr(left, right)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=1e-3)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), atol=1e-3)
    for b, img in enumerate((left, right)):
        ref = np.asarray(jrectify.remap_bilinear(jnp.asarray(img), jnp.asarray(maps[b])))
        got = rectify.remap_bilinear(torch.from_numpy(img), torch.from_numpy(maps[b].copy())).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-3)
    # Leading dims share one map.
    both = rectify.remap_bilinear(torch.from_numpy(np.stack([left, right])), torch.from_numpy(maps[0].copy())).numpy()
    np.testing.assert_allclose(both[1], np.asarray(jrectify.remap_bilinear(jnp.asarray(right), jnp.asarray(maps[0]))),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _filter_row(f, row, prior, bpp):
    """Filter one row (ints) with PNG filter type f."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return bytes([f] + out)


def _png_with_filters(img, filters):
    """PNG bytes of img (8-bit gray / RGB / RGBA, or uint16 gray), row r
    filtered with filters[r % len(filters)]."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    body = img.astype(">u2") if depth == 16 else img
    rows = [np.frombuffer(np.ascontiguousarray(body[y]).tobytes(), np.uint8).tolist() for y in range(h)]
    bpp = ch * depth // 8
    raw, prior = b"", [0] * len(rows[0])
    for r, row in enumerate(rows):
        raw += _filter_row(filters[r % len(filters)], row, prior, bpp)
        prior = row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _images(rng):
    return {
        "gray": (rng.random((23, 31)) * 255).astype(np.uint8),
        "rgb": (rng.random((23, 31, 3)) * 255).astype(np.uint8),
        "rgba": (rng.random((23, 31, 4)) * 255).astype(np.uint8),
        "gray16": (rng.random((23, 31)) * 65535).astype(np.uint16),
    }


def _pil_array(path):
    Image = pytest.importorskip("PIL.Image")
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 0, 2)])
def test_read_png_each_filter(tmp_path, rng, kind, filters):
    img = _images(rng)[kind]
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, filters))
    got = datasets.read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _pil_array(path))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16"])
def test_read_png_written_by_pil(tmp_path, rng, kind):
    Image = pytest.importorskip("PIL.Image")
    img = _images(rng)[kind]
    path = tmp_path / f"{kind}.png"
    Image.fromarray(img).save(path)
    ref_raw = np.asarray(Image.open(path))
    np.testing.assert_array_equal(datasets.read_png(path), ref_raw)
    if kind == "rgba":
        # The reference's gray conversion takes three channels only.
        for reader in (jdatasets.read_image_gray, datasets.read_image_gray):
            with pytest.raises(ValueError):
                reader(path)
        return
    got, ref = datasets.read_image_gray(path), jdatasets.read_image_gray(path)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    if kind == "gray16":
        np.testing.assert_array_equal(datasets.read_depth_tum(path, 5000.0), jdatasets.read_depth_tum(path, 5000.0))


def test_read_png_of_port_writers(tmp_path, rng):
    pytest.importorskip("PIL.Image")
    imgs = _images(rng)
    for name, arr in (("gray", imgs["gray"]), ("rgb", imgs["rgb"]), ("gray16", imgs["gray16"])):
        path = tmp_path / f"{name}.png"
        path.write_bytes(datasets.encode_png(arr))
        np.testing.assert_array_equal(_pil_array(path), arr)
        np.testing.assert_array_equal(datasets.read_image_gray(path), jdatasets.read_image_gray(path))
    viz.write_png(tmp_path / "viz.png", imgs["rgb"])
    np.testing.assert_array_equal(datasets.read_png(tmp_path / "viz.png"), imgs["rgb"])
    np.testing.assert_array_equal(_pil_array(tmp_path / "viz.png"), imgs["rgb"])


def test_read_png_refuses_interlace_and_palette(tmp_path):
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    for depth, ctype, interlace in ((8, 0, 1), (8, 3, 0), (4, 0, 0)):
        path = tmp_path / "bad.png"
        path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0,
                                                                             interlace))
                         + chunk(b"IDAT", zlib.compress(bytes(20))) + chunk(b"IEND", b""))
        with pytest.raises(ValueError):
            datasets.read_png(path)


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def _poses(rng, n):
    out = []
    for _ in range(n):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        out.append((rng.standard_normal(3), q))
    return out


def _assert_gt_close(got, ref):
    assert sorted(got) == sorted(ref)
    for t in ref:
        np.testing.assert_allclose(got[t], ref[t], atol=1e-6)


def test_load_tum_rgbd_parity(tmp_path, rng):
    """A directory written by `write_tum_rgbd` (depth stamps 4 ms after the
    images), plus an RGB frame with no depth near it."""
    n = 6
    imgs = rng.random((n, 12, 16)) * 255
    deps = rng.random((n, 12, 16)) * 3
    Tcw = [np.linalg.inv(np.block([[np.eye(3), rng.standard_normal((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]]))
           for _ in range(n)]
    gt_written = datasets.write_tum_rgbd(tmp_path, imgs, deps, Tcw)
    with open(tmp_path / "rgb.txt", "a") as f:
        f.write("9.000000 rgb/00000.png\n")  # no depth within 0.02 s
    pairs_ref, gt_ref = jdatasets.load_tum_rgbd(tmp_path)
    pairs, gt = datasets.load_tum_rgbd(tmp_path)
    assert pairs == pairs_ref and len(pairs) == n
    _assert_gt_close(gt, gt_ref)
    _assert_gt_close(gt, gt_written)
    # The files read back as written (rounded to 8 and 16 bits).
    np.testing.assert_array_equal(datasets.read_image_gray(pairs[2]["rgb"]),
                                  np.round(imgs[2]).astype(np.uint8).astype(np.float32))
    np.testing.assert_allclose(datasets.read_depth_tum(pairs[2]["depth"]), deps[2], atol=1e-4)


@pytest.mark.parametrize("with_yaml", [True, False])
def test_load_euroc_stereo_parity(tmp_path, rng, with_yaml):
    mav = tmp_path / "mav0"
    for cam in ("cam0", "cam1"):
        (mav / cam / "data").mkdir(parents=True)
    t0 = 1403636579763555584
    rows0 = [f"{t0 + i * 50_000_000},{t0 + i * 50_000_000}.png" for i in range(5)]
    rows1 = [f"{t0 + i * 50_000_000 + 1_000_000},{t0 + i * 50_000_000 + 1_000_000}.png" for i in range(4)]
    rows1.append(f"{t0 + 4 * 50_000_000 + 9_000_000},late.png")  # 9 ms off: not paired
    (mav / "cam0" / "data.csv").write_text("#timestamp [ns],filename\n" + "\n".join(rows0) + "\n")
    (mav / "cam1" / "data.csv").write_text("#timestamp [ns],filename\n" + "\n".join(rows1) + "\n")
    if with_yaml:
        T_BS = np.eye(4)
        T_BS[:3, 3] = [0.1, -0.2, 0.3]
        vals = ", ".join(f"{v:.6f}" for v in T_BS.reshape(-1))
        (mav / "cam0" / "sensor.yaml").write_text(f"T_BS:\n  cols: 4\n  rows: 4\n  data: [{vals}]\n")
    gtd = mav / "state_groundtruth_estimate0"
    gtd.mkdir()
    lines = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"]
    for i, (t, q) in enumerate(_poses(rng, 5)):
        lines.append(f"{t0 + i * 50_000_000}," + ",".join(f"{v:.9f}" for v in (*t, q[3], q[0], q[1], q[2])))
    (gtd / "data.csv").write_text("\n".join(lines) + "\n")
    pairs_ref, gt_ref = jdatasets.load_euroc_stereo(tmp_path)
    pairs, gt = datasets.load_euroc_stereo(tmp_path)
    assert pairs == pairs_ref and len(pairs) == 4
    _assert_gt_close(gt, gt_ref)


def test_load_kitti_stereo_parity(tmp_path, rng):
    seq = tmp_path / "sequences" / "03"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
        for i in range(4):
            (seq / d / f"{i:06d}.png").write_bytes(datasets.encode_png(np.zeros((4, 4), np.uint8)))
    (seq / "times.txt").write_text("\n".join(f"{i * 0.103:e}" for i in range(4)) + "\n")
    (tmp_path / "poses").mkdir()
    (tmp_path / "poses" / "03.txt").write_text(
        "\n".join(" ".join(f"{v:e}" for v in rng.standard_normal(12)) for _ in range(4)) + "\n")
    pairs_ref, gt_ref = jdatasets.load_kitti_stereo(tmp_path, "03")
    pairs, gt = datasets.load_kitti_stereo(tmp_path, "03")
    assert pairs == pairs_ref and len(pairs) == 4
    _assert_gt_close(gt, gt_ref)
