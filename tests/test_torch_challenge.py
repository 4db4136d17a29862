"""The port's medical-image IO and challenge tooling against senas_tpu's on
identical numpy inputs, all exact: MetaImage files written by either
package are byte-identical and read back equal in the other, NIfTI reads
agree, the PROMISE12 metrics and submission writer and the nerve RLE codec
and filters give the same values and files. Then TestRunner's PROMISE12
submission path (c 8, depth 3, 64x64 slices on the CPU) against
senas_tpu's predict_test and volumetric_metrics fed the same slices."""

import gzip
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from scipy import ndimage

from senas_tpu.challenge import nerve as jnerve
from senas_tpu.challenge import promise12 as jp12
from senas_tpu.data import io as jio
from senas_torch.challenge import nerve as tnerve
from senas_torch.challenge import promise12 as tp12
from senas_torch.core.config import load_config
from senas_torch.data import DataLoader
from senas_torch.data import io as tio
from senas_torch.models import geno_searched
from senas_torch.models.senas_model import SenasModel
from senas_torch.runner.test import TestRunner
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.trainer import FixedTrainState

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _image(rng, dtype, ndim):
    shape = (5, 7, 6)[-ndim:]
    if np.dtype(dtype).kind == "f":
        arr = rng.randn(*shape).astype(dtype)
    else:
        arr = rng.randint(0, 100, shape).astype(dtype)
    return dict(array=arr, spacing=tuple(0.5 + rng.rand(ndim)),
                origin=tuple(rng.randn(ndim)), direction=tuple(np.eye(ndim).ravel()))


# ---------------------------------------------------------------------------
# data/io.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint16, np.int32, np.float32,
                                   np.float64])
def test_mhd_files_are_identical_and_cross_read(tmp_path, dtype, ndim):
    img = _image(np.random.RandomState(ndim), dtype, ndim)
    tio.write_mhd(str(tmp_path / "t.mhd"), tio.MetaImage(**img))
    jio.write_mhd(str(tmp_path / "j.mhd"), jio.MetaImage(**img))
    assert _bytes(tmp_path / "t.raw") == _bytes(tmp_path / "j.raw")
    assert _bytes(tmp_path / "t.mhd").replace(b"t.raw", b"j.raw") == _bytes(tmp_path / "j.mhd")
    for reader, path in ((jio.read_mhd, "t.mhd"), (tio.read_mhd, "j.mhd")):
        back = reader(str(tmp_path / path))
        assert back.array.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(back.array, img["array"])
        assert back.spacing == img["spacing"] and back.origin == img["origin"]
        assert back.direction == tuple(float(v) for v in img["direction"])


def test_mhd_reader_options_match(tmp_path):
    """Big-endian, zlib-compressed and ElementSize/Position headers."""
    arr = np.arange(24, dtype=">i2").reshape(2, 3, 4)
    with open(tmp_path / "v.raw", "wb") as f:
        f.write(zlib.compress(arr.tobytes()))
    with open(tmp_path / "v.mhd", "w") as f:
        f.write("NDims = 3\nDimSize = 4 3 2\nElementType = MET_SHORT\n"
                "ElementByteOrderMSB = True\nCompressedData = True\n"
                "ElementSize = 1 2 3\nPosition = 4 5 6\nElementDataFile = v.raw\n")
    got, want = tio.read_mhd(str(tmp_path / "v.mhd")), jio.read_mhd(str(tmp_path / "v.mhd"))
    np.testing.assert_array_equal(got.array, want.array)
    np.testing.assert_array_equal(got.array, arr.astype(np.int16))
    assert (got.spacing, got.origin, got.direction, got.header) == \
        (want.spacing, want.origin, want.direction, want.header)
    with pytest.raises(ValueError, match=".mhd"):
        tio.write_mhd(str(tmp_path / "v.raw"), got)


def _write_nifti(path, arr, code, endian="<", slope=0.0, inter=0.0):
    hdr = bytearray(348)
    struct.pack_into(endian + "i", hdr, 0, 348)
    dims = [arr.ndim] + list(arr.shape) + [1] * (7 - arr.ndim)
    struct.pack_into(endian + "8h", hdr, 40, *dims)
    struct.pack_into(endian + "h", hdr, 70, code)
    struct.pack_into(endian + "f", hdr, 108, 352.0)
    struct.pack_into(endian + "f", hdr, 112, slope)
    struct.pack_into(endian + "f", hdr, 116, inter)
    blob = bytes(hdr) + b"\0" * 4 + arr.astype(arr.dtype.newbyteorder(endian)).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("name,code,endian,slope", [
    ("a.nii", 16, "<", 0.0), ("b.nii.gz", 4, "<", 0.0), ("c.nii", 512, ">", 0.0),
    ("d.nii.gz", 2, "<", 2.5)])
def test_read_nifti_matches(tmp_path, name, code, endian, slope):
    dtype = {16: np.float32, 4: np.int16, 512: np.uint16, 2: np.uint8}[code]
    arr = (np.random.RandomState(code).rand(4, 3, 5) * 50).astype(dtype)
    path = str(tmp_path / name)
    _write_nifti(path, arr, code, endian, slope=slope, inter=1.0 if slope else 0.0)
    got, want = tio.read_nifti(path), jio.read_nifti(path)
    assert got.dtype == want.dtype and got.shape == want.shape == (4, 3, 5)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# challenge/promise12.py
# ---------------------------------------------------------------------------

def _blobs(rng, shape, p=0.55):
    vol = rng.rand(*shape) > p
    return vol.astype(np.int64)


@pytest.mark.parametrize("axis", [None, (1, 2)])
def test_numpy_dice_and_volume_difference_match(axis):
    rng = np.random.RandomState(0)
    a, b = _blobs(rng, (4, 9, 8)), _blobs(rng, (4, 9, 8))
    np.testing.assert_array_equal(tp12.numpy_dice(a, b, axis=axis),
                                  jp12.numpy_dice(a, b, axis=axis))
    assert tp12.rel_abs_vol_diff(a, b) == jp12.rel_abs_vol_diff(a, b)


@pytest.mark.parametrize("sampling,connectivity", [(1, 1), ((2.5, 0.7, 0.9), 1),
                                                   ((3.0, 1.0, 1.0), 3)])
def test_surface_distances_match(sampling, connectivity):
    rng = np.random.RandomState(1)
    a, b = _blobs(rng, (5, 12, 11)), _blobs(rng, (5, 12, 11), p=0.6)
    got = tp12.surface_distances(a, b, sampling, connectivity)
    np.testing.assert_array_equal(got, jp12.surface_distances(a, b, sampling, connectivity))
    # b's "surface" is its whole foreground (the reference's `|`): every b
    # voxel contributes a distance to a's surface
    conn = ndimage.generate_binary_structure(3, connectivity)
    surf_a = a.astype(bool) ^ ndimage.binary_erosion(a.astype(bool), conn)
    assert got.size == b.sum() + surf_a.sum()


@pytest.mark.parametrize("shape", [(3, 20, 30), (3, 5, 4), (3, 8, 8)])
def test_resize_slices_nearest_matches(shape):
    pred = np.random.RandomState(2).randint(0, 2, (3, 8, 8)).astype(np.uint8)
    got = tp12.resize_slices_nearest(pred, shape)
    np.testing.assert_array_equal(got, jp12.resize_slices_nearest(pred, shape))
    assert got.shape == shape


def _write_cases(folder, rng, sizes, with_gt=True):
    """PROMISE12-like cases: CaseNN.mhd (int16 MR volume) and
    CaseNN_segmentation.mhd (uint8 mask), non-unit spacing."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, (n, h, w) in enumerate(sizes):
        zz, yy, xx = np.mgrid[0:n, 0:h, 0:w]
        seg = (((yy - h / 2) / (h / 3)) ** 2 + ((xx - w / 2) / (w / 4)) ** 2
               + ((zz - n / 2) / (n / 2)) ** 2 < 1).astype(np.uint8)
        vol = (300.0 * seg + 40 * rng.randn(n, h, w)).astype(np.int16)
        spacing, origin = (0.625, 0.625, 3.6 - 0.2 * i), (-10.0 * i, 4.5, 31.25)
        direction = (1, 0, 0, 0, 1, 0, 0, 0, 1)
        path = os.path.join(folder, f"Case{i:02d}.mhd")
        tio.write_mhd(path, tio.MetaImage(vol, spacing, origin, direction))
        if with_gt:
            tio.write_mhd(os.path.join(folder, f"Case{i:02d}_segmentation.mhd"),
                          tio.MetaImage(seg, spacing, origin, direction))
        paths.append(path)
    return paths


SIZES = [(5, 40, 36), (4, 24, 24), (6, 32, 40)]


def _slices(rng, n, hw=16):
    return [rng.randint(0, 2, (hw, hw)).astype(np.uint8) for _ in range(n)]


def test_iter_case_volumes_and_volumetric_metrics_match(tmp_path):
    rng = np.random.RandomState(3)
    folder = str(tmp_path / "cases")
    _write_cases(folder, rng, SIZES)
    for masks in (True, False):
        for case_ids in (None, [1]):
            got = [(n, c.array) for n, c in tp12.iter_case_volumes(folder, case_ids, masks)]
            want = [(n, c.array) for n, c in jp12.iter_case_volumes(folder, case_ids, masks)]
            assert [n for n, _ in got] == [n for n, _ in want] and got
            for (_, g), (_, w) in zip(got, want):
                np.testing.assert_array_equal(g, w)
    slices = _slices(rng, sum(n for n, _, _ in SIZES))
    got = tp12.volumetric_metrics(slices, folder)
    assert got == jp12.volumetric_metrics(slices, folder)
    assert got["n_cases"] == 3 and all(np.isfinite(v) for v in got.values())


def test_predict_test_writes_the_same_files(tmp_path):
    rng = np.random.RandomState(4)
    paths = _write_cases(str(tmp_path / "cases"), rng, SIZES, with_gt=False)
    slices = _slices(rng, sum(n for n, _, _ in SIZES))
    got = tp12.predict_test(slices, paths, dest=str(tmp_path / "t"))
    want = jp12.predict_test(slices, paths, dest=str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)
        assert _bytes(g[:-4] + ".raw") == _bytes(w[:-4] + ".raw")


def _png_pixels(path):
    return np.asarray(pytest.importorskip("PIL.Image").open(path).convert("RGBA"))


def test_contour_grid_is_not_ported(tmp_path):
    """It is ported since: with every ground truth empty no slice is
    picked, and both packages draw the same blank grid."""
    pytest.importorskip("matplotlib")
    z = np.zeros((2, 8, 8))
    got = tp12.best_worst_contour_grid(z, z, z, str(tmp_path / "t" / "g.png"))
    want = jp12.best_worst_contour_grid(z, z, z, str(tmp_path / "j" / "g.png"))
    np.testing.assert_array_equal(_png_pixels(got), _png_pixels(want))


@pytest.mark.parametrize("n_best,n_worst", [(20, 20), (2, 3)])
def test_contour_grid_matches(tmp_path, n_best, n_worst):
    """The PNG's decoded pixels equal senas_tpu's on the same inputs."""
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(9)
    yy, xx = np.mgrid[0:48, 0:48]
    y_true = np.stack([((yy - 24) ** 2 + (xx - 20 - i) ** 2 < (6 + i) ** 2)
                       for i in range(9)]).astype(np.uint8)
    y_true[4] = 0   # an empty slice is never picked
    y_pred = np.stack([np.roll(m, i % 5, axis=1) for i, m in enumerate(y_true)])
    images = rng.rand(9, 48, 48)
    paths = [fn(images, y_true, y_pred, str(tmp_path / name / "grid.png"), n_best, n_worst)
             for name, fn in (("t", tp12.best_worst_contour_grid),
                              ("j", jp12.best_worst_contour_grid))]
    got, want = (_png_pixels(p) for p in paths)
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# challenge/nerve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 0.9])
def test_rle_codec_matches(density):
    mask = (np.random.RandomState(5).rand(20, 17) < density).astype(np.uint8)
    rle = tnerve.rle_encoding(mask)
    assert rle == jnerve.rle_encoding(mask)
    np.testing.assert_array_equal(tnerve.rle_decoding(rle, mask.shape),
                                  jnerve.rle_decoding(rle, mask.shape))
    if mask.sum() >= 5:
        np.testing.assert_array_equal(tnerve.rle_decoding(rle, mask.shape), mask)


def test_rle_submission_and_hard_dice_match(tmp_path):
    rng = np.random.RandomState(6)
    masks = [(rng.rand(12, 10) < p).astype(np.uint8) for p in (0.0, 0.2, 0.5)]
    for ids in (None, ["a", "b", "c"]):
        t = tnerve.write_rle_submission(masks, str(tmp_path / "t" / "s.csv"), ids)
        j = jnerve.write_rle_submission(masks, str(tmp_path / "j" / "s.csv"), ids)
        assert _bytes(t) == _bytes(j)
    for a in masks:
        for b in masks:
            assert tnerve.hard_dice(a, b) == jnerve.hard_dice(a, b)


def test_filter_incoherent_images_matches():
    rng = np.random.RandomState(7)
    base = rng.rand(32, 32).astype(np.float32)
    images = [base, base + 1e-4 * rng.rand(32, 32), rng.rand(32, 32), base * 1.0001]
    masks = [np.ones((32, 32)), np.zeros((32, 32)), np.zeros((32, 32)), np.zeros((32, 32))]
    got = tnerve.filter_incoherent_images(images, masks)
    assert got == jnerve.filter_incoherent_images(images, masks)
    assert got[1]  # the near-duplicates with disagreeing masks were found


# ---------------------------------------------------------------------------
# TestRunner.run_promise12_submission
# ---------------------------------------------------------------------------

class _Slices:
    """A dataset of case slices, resized to the model's input side."""

    def __init__(self, paths, hw):
        images = []
        for p in paths:
            vol = tio.read_mhd(p).array.astype(np.float32)
            ri = (np.arange(hw) * vol.shape[1] // hw)
            ci = (np.arange(hw) * vol.shape[2] // hw)
            images.extend((vol[:, ri[:, None], ci[None, :]] - 150.0) / 150.0)
        self.images = np.stack(images)[..., None]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], np.zeros(self.images.shape[1:3], np.int32)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    t = load_config(CONFIG)["training"]
    model = SenasModel(2, 1, c=t["init_channels"], depth=t["depth"],
                       genotype=geno_searched.senas, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    mgr = CheckpointManager(str(tmp_path_factory.mktemp("ckpt")))
    mgr.save(FixedTrainState.create(model, t["model_optimizer"]), {"epoch": 1}, is_best=True)
    return mgr.directory


@pytest.mark.parametrize("with_gt", [True, False])
def test_submission_matches_jax_predict_test(tmp_path, checkpoint, with_gt):
    rng = np.random.RandomState(8)
    case_dir = str(tmp_path / "cases")
    paths = _write_cases(case_dir, rng, SIZES, with_gt=with_gt)
    cfg = load_config(CONFIG)
    runner = TestRunner(cfg, resume=checkpoint, log_root=str(tmp_path / "logs"),
                        batch_size=4, device="cpu")
    queue = DataLoader(_Slices(paths, 64), 4)
    written, summary = runner.run_promise12_submission(case_dir, queue=queue)
    assert written == [os.path.join(runner.run_dir, "predictions",
                                    f"Case{i:02d}_segmentation.mhd") for i in range(3)]

    slices = [s for b in queue for s in runner.eval_step(runner._place(b))["pred"].numpy()]
    assert len(slices) == sum(n for n, _, _ in SIZES) and slices[0].dtype == np.uint8
    want = jp12.predict_test(slices, paths, dest=str(tmp_path / "jax"))
    for g, w, src in zip(written, want, paths):
        assert _bytes(g) == _bytes(w) and _bytes(g[:-4] + ".raw") == _bytes(w[:-4] + ".raw")
        back, source = tio.read_mhd(g), tio.read_mhd(src)
        assert back.array.shape == source.array.shape and back.array.dtype == np.uint8
        assert (back.origin, back.spacing, back.direction) == \
            (source.origin, source.spacing, source.direction)
    if with_gt:
        assert summary == jp12.volumetric_metrics(slices, case_dir)
        assert summary["n_cases"] == 3 and all(np.isfinite(v) for v in summary.values())
    else:
        assert summary is None
