"""The port's legacy 3-D PROMISE12 pipeline (`senas_torch.data.
legacy_promise12`), ported from tests/test_legacy_promise12.py: the same
checks on synthetic MHD volumes, then the port against senas_tpu's copy
on the same volumes, exactly (both are numpy and scipy: the resampled
images and masks, the back-registered masks and the written files are
equal bit for bit)."""

import os

import numpy as np
import pytest

from senas_tpu.data import legacy_promise12 as J
from senas_torch.data import legacy_promise12 as T
from senas_torch.data.io import MetaImage, read_mhd, write_mhd

SPACING = (0.625, 0.625, 3.0)  # a typical PROMISE12 acquisition
SHAPE_XYZ = (96, 96, 24)
PARAMS = {"dstRes": [1.0, 1.0, 1.5], "VolSize": [64, 64, 48], "normDir": False}


def _sphere(shape_xyz, center_frac=(0.5, 0.5, 0.5), radius_frac=0.25):
    x, y, z = np.meshgrid(*[np.arange(s, dtype=float) for s in shape_xyz], indexing="ij")
    cx, cy, cz = [c * s for c, s in zip(center_frac, shape_xyz)]
    r = radius_frac * min(shape_xyz)
    return (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= r * r


def _write_case(folder, key, seed, spacing=SPACING):
    """Synthetic prostate-like case: smooth intensity + sphere GT."""
    rs = np.random.RandomState(seed)
    sphere = _sphere(SHAPE_XYZ)
    img_xyz = 80.0 * sphere + 40.0 + 10.0 * rs.rand(*SHAPE_XYZ)
    for name, arr_xyz, dt in ((f"{key}.mhd", img_xyz, np.float32),
                              (f"{key}_segmentation.mhd", sphere.astype(np.float32), np.uint8)):
        write_mhd(os.path.join(folder, name),
                  MetaImage(array=np.transpose(arr_xyz, (2, 1, 0)).astype(dt), spacing=spacing))
    return sphere


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vols"))
    spheres = {k: _write_case(d, k, seed) for seed, k in enumerate(("Case00", "Case01"))}
    return d, spheres


def _manager(case_dir, pkg=T):
    folder, spheres = case_dir
    dm = pkg.DataManager(folder, folder, folder, PARAMS)
    dm.loadTrainingData()
    return dm, spheres


def test_file_lists_split_images_from_gt(case_dir):
    dm, _ = _manager(case_dir)
    assert dm.imageFileList == ["Case00.mhd", "Case01.mhd"]
    assert dm.GTFileList == ["Case00_segmentation.mhd", "Case01_segmentation.mhd"]


def test_load_rescales_to_unit_range(case_dir):
    dm, _ = _manager(case_dir)
    for meta in dm.sitkImages.values():
        assert meta.array.min() == pytest.approx(0.0)
        assert meta.array.max() == pytest.approx(1.0)
    assert 0.0 < dm.meanIntensityTrain < 1.0


def test_numpy_gt_binary_and_volume_preserved(case_dir):
    dm, spheres = _manager(case_dir)
    for key, arr in dm.getNumpyGT().items():
        assert arr.shape == tuple(PARAMS["VolSize"])
        assert set(np.unique(arr)).issubset({0.0, 1.0})
        vol_orig = spheres[key.replace("_segmentation", "")].sum() * np.prod(SPACING)
        assert arr.sum() * np.prod(PARAMS["dstRes"]) == pytest.approx(vol_orig, rel=0.05)


def test_resample_identity_when_grids_match():
    vol_xyz = np.random.RandomState(0).rand(20, 18, 16).astype(np.float32)
    meta = MetaImage(array=np.transpose(vol_xyz, (2, 1, 0)), spacing=(1.0, 1.0, 1.0))
    out = T.resample_to_grid(meta, (1.0, 1.0, 1.0), (20, 18, 16), order=1)
    np.testing.assert_allclose(out, vol_xyz, atol=1e-6)


def test_round_trip_back_registration(case_dir):
    dm, spheres = _manager(case_dir)
    back = dm.numpy_label_to_original_grid(dm.getNumpyGT()["Case00_segmentation"], "Case00")
    orig = spheres["Case00"].astype(np.uint8)
    assert back.shape == orig.shape
    assert 2 * float((back & orig).sum()) / (back.sum() + orig.sum()) > 0.9


def test_empty_mask_back_registers_empty(case_dir):
    dm, _ = _manager(case_dir)
    empty = np.zeros(tuple(PARAMS["VolSize"]), np.float32)
    assert dm.numpy_label_to_original_grid(empty, "Case00").sum() == 0


def test_legacy_dataset_modes(case_dir):
    dm, _ = _manager(case_dir)
    imgs, gts = dm.getNumpyImages(), dm.getNumpyGT()
    keys = sorted(imgs)
    ds = T.LegacyVolumeDataset("train", np.stack([imgs[k] for k in keys]),
                               np.stack([gts[k + "_segmentation"] for k in keys]))
    img, g = ds[0]
    vs = PARAMS["VolSize"]
    assert len(ds) == 2 and img.shape == (1, vs[2], vs[1], vs[0]) and img.dtype == np.float32
    assert g.shape == (vs[2], vs[1], vs[0])
    img, g, key = T.LegacyVolumeDataset("test", imgs, gts)[0]
    img2, key2 = T.LegacyVolumeDataset("infer", imgs)[0]
    assert key2 == key and img.ndim == 4 and g.ndim == 3
    np.testing.assert_array_equal(img2, img)


# ---------------------------------------------------------------------------
# the port against senas_tpu's copy
# ---------------------------------------------------------------------------

def test_numpy_images_and_gt_match(case_dir):
    dm_t, _ = _manager(case_dir, T)
    dm_j, _ = _manager(case_dir, J)
    assert dm_t.meanIntensityTrain == dm_j.meanIntensityTrain
    for got, want in ((dm_t.getNumpyImages(), dm_j.getNumpyImages()),
                      (dm_t.getNumpyGT(), dm_j.getNumpyGT())):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_back_registration_and_written_files_match(case_dir, tmp_path):
    dm_t, _ = _manager(case_dir, T)
    dm_j, _ = _manager(case_dir, J)
    label = dm_t.getNumpyGT()["Case01_segmentation"].copy()
    label[2:5, 2:5, 2:5] = 1.0  # a spurious blob the cleanup removes
    np.testing.assert_array_equal(dm_t.numpy_label_to_original_grid(label, "Case01"),
                                  dm_j.numpy_label_to_original_grid(label, "Case01"))
    got = dm_t.writeResultsFromNumpyLabel(label, "Case01", result_dir=str(tmp_path / "t"))
    want = dm_j.writeResultsFromNumpyLabel(label, "Case01", result_dir=str(tmp_path / "j"))
    for a, b in ((got, want), (got[:-4] + ".raw", want[:-4] + ".raw")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert read_mhd(got).array.shape == SHAPE_XYZ[::-1]


@pytest.mark.parametrize("norm_dir,order", [(False, 1), (True, 0), (True, 1)])
def test_resample_matches(norm_dir, order):
    vol_xyz = np.random.RandomState(1).rand(16, 14, 12).astype(np.float32)
    meta = MetaImage(array=np.transpose(vol_xyz, (2, 1, 0)), spacing=(0.7, 0.9, 2.5),
                     origin=(3.0, -2.0, 1.5), direction=(0, 1, 0, 1, 0, 0, 0, 0, -1))
    args = ((1.0, 1.0, 1.5), (12, 12, 20))
    np.testing.assert_array_equal(
        T.resample_to_grid(meta, *args, order=order, norm_dir=norm_dir),
        J.resample_to_grid(meta, *args, order=order, norm_dir=norm_dir))
