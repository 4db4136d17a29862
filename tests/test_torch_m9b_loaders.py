"""The port's loaders of the other shipped configs (`senas_torch.data`
`png_datasets`, `msd`, `monusac`) against senas_tpu's (which read with
Pillow and augment with cv2), on tiny files in each dataset's own layout:

- for each of chaos, chaos_mr, heart, spleen, pancreas, hippo, monusac,
  ultrasound_nerve, bladder and camvid, `get_dataset(name, root, mode=...)`
  in train and val mode gives the same length, the same files in the same
  order and the same samples (image and label, bit for bit) under the same
  `random.seed` and `np.random.seed`;
- CHAOS reads DICOM with and without the preamble, with explicit and
  implicit VR, and a slice without its mask gets an all-background label;
  each DICOM variant reads the same (or fails the same way) in both
  packages;
- `extract_task` writes PNGs whose decoded pixels equal those of
  senas_tpu's extraction (MR intensities above 255 saturate, labels become
  0/255);
- `class_weights_from_masks` agrees (CT and MR);
- the hippocampus geometry (configs/senas/senas_hippo.yml: 32 x 48 crops,
  search depth 3): one supernet forward at batch 1 and c 8 through both
  packages gives the same shape, and logits within the supernet parity
  tolerance (rtol 2e-4, atol 2e-5, tests/test_torch_supernet.py). At depth
  5, 48 is not a multiple of 2^5 and both packages fail with a shape
  mismatch.

Tolerance 0 elsewhere: every other comparison here is exact.
"""

import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.data import base as tbase
from senas_torch.data import dicom as tdicom
from senas_torch.data import imfile
from senas_torch.data import msd as tmsd
from senas_torch.data import png_datasets as tpng
from senas_torch.search import supernet as tsn

from torch_port_util import random_variables, write_dicom, write_nifti
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")
jbase = pytest.importorskip("senas_tpu.data.base")  # its loaders need cv2 and Pillow
from senas_tpu.data import dicom as jdicom  # noqa: E402
from senas_tpu.data import msd as jmsd  # noqa: E402

MSD = {"heart": ("Task02_Heart", (72, 88)), "spleen": ("Task09_Spleen", (60, 60)),
       "pancreas": ("Task07_Pancreas", (64, 56)), "hippo": ("Task04_Hippocampus", (35, 51))}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = ["chaos", "chaos_mr", "heart", "spleen", "pancreas", "hippo", "monusac",
         "ultrasound_nerve", "bladder", "camvid"]


def _blob(rs, h, w):
    """A smooth image with an ellipse, and the ellipse's mask."""
    y, x = np.mgrid[0:h, 0:w]
    cy, cx = h * rs.uniform(0.35, 0.65), w * rs.uniform(0.35, 0.65)
    inside = ((y - cy) / (0.25 * h)) ** 2 + ((x - cx) / (0.2 * w)) ** 2 < 1
    shade = 90 + 40 * np.sin(x / rs.uniform(4, 9)) * np.cos(y / rs.uniform(4, 9))
    return shade + 80 * inside + 10 * rs.randn(h, w), inside


def _save(path, arr, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), mode).save(path)


def _write_chaos(base, rs, mr):
    """CHAOS CT (two cases, both file namings, a missing mask, each DICOM
    variant) or MR (T1DUAL in/out phase sharing masks, T2SPIR, organ
    shades)."""
    variants = [dict(preamble=True, explicit=True), dict(preamble=False, explicit=True),
                dict(preamble=True, explicit=False, empty_first=True)]
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "notes.txt"), "w") as f:
        f.write("not a case\n")
    for case in ("1", "2"):
        series = (["T1DUAL", "T2SPIR"] if mr else [""])
        for s in series:
            d = os.path.join(base, case, s, "DICOM_anon")
            g = os.path.join(base, case, s, "Ground")
            os.makedirs(d)
            os.makedirs(g)
            n = 4 if s == "T1DUAL" else 3
            for i in range(n):
                img, inside = _blob(rs, 40, 48)
                if mr:
                    px = (img * 6).astype(np.uint16)
                    name = f"IMG-00{case}-{i + 1:05d}.dcm"
                    write_dicom(os.path.join(d, name), px, **variants[i % 3])
                    ident = "%03d" % ((i + 2) // 2) if s == "T1DUAL" else f"{i + 1:03d}"
                    shade = [80, 160, 240, 255][i % 4]
                    lab = np.where(inside, shade, 0)
                    lab[:4, :4] = 80
                    _save(os.path.join(g, f"liver_{ident}.png"), lab)
                else:
                    px = (img * 8 - 1024).astype(np.int16)
                    px[0, 0] = 5000                      # an abnormal pixel (>= 4000 HU)
                    if case == "1":
                        name, mask = f"IMG-0001-{i + 1:05d}.dcm", f"liver_GT_{i:03d}.png"
                    else:
                        name, mask = f"i{i:04d},0000b.dcm", f"liver_GT_{i:03d}.png"
                    write_dicom(os.path.join(d, name), px, slope=1.0, intercept=-1024.0,
                                **variants[i % 3])
                    if (case, i) != ("2", 1):            # one slice has no mask
                        _save(os.path.join(g, mask), np.where(inside, 255, 0))


def _write_msd(root, rs):
    for name, (task, (h, w)) in MSD.items():
        for sub in ("imagesTr", "labelsTr"):
            os.makedirs(os.path.join(root, task, sub))
        for case in ("a_001", "a_002"):
            vols, labs = [], []
            for _ in range(3):
                img, inside = _blob(rs, h, w)
                vols.append(img * 6 - 400)               # below 0 and above 255: saturates
                labs.append(inside.astype(np.uint8) * rs.randint(1, 3))
            write_nifti(os.path.join(root, task, "imagesTr", case + ".nii.gz"),
                        np.stack(vols, -1).astype(np.int16))
            write_nifti(os.path.join(root, task, "labelsTr", case + ".nii.gz"),
                        np.stack(labs, -1).astype(np.uint8))


def _write_pairs(root, rs):
    base = os.path.join(root, "MoNuSAC", "MoNuSAC_cleaned")
    for i in range(3):
        img, inside = _blob(rs, 270, 262)
        rgb = np.stack([img, img * 0.8 + 20, 255 - img], -1)
        _save(os.path.join(base, "images", f"s{i}.png"), rgb, "RGB")
        _save(os.path.join(base, "masks", f"s{i}.png"), np.where(inside, 255, 0))
    folder = os.path.join(root, "ultrasound-nerve", "data_clean")
    for i in range(3):
        img, inside = _blob(rs, 264, 270)
        _save(os.path.join(folder, f"{i + 1}_1.tif"), img)
        if i != 2:
            _save(os.path.join(folder, f"{i + 1}_1_mask.tif"), np.where(inside, 255, 0))
    for i in range(3):
        img, inside = _blob(rs, 120, 100)
        _save(os.path.join(root, "bladder", "Images", f"b{i}.png"), img)
        lab = np.where(inside, 255, 0)
        lab[:30] = np.where(lab[:30] > 0, 128, 0)
        _save(os.path.join(root, "bladder", "Labels", f"b{i}.png"), lab)
    for sub in ("train", "val"):
        for i in range(3):
            img, _ = _blob(rs, 264, 280)
            rgb = np.stack([img, 255 - img, img * 0.5 + 60], -1)
            _save(os.path.join(root, "CamVid", sub, f"c{i}.png"), rgb, "RGB")
            _save(os.path.join(root, "CamVid", sub + "annot", f"c{i}.png"),
                  rs.randint(0, 12, (264, 280)))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One set of files in every layout; a data root per package (each
    extracts its own MSD slices from the same volumes)."""
    tmp = tmp_path_factory.mktemp("m9b")
    rs = np.random.RandomState(0)
    shared = str(tmp / "shared")
    _write_chaos(os.path.join(shared, "CHAOS", "CT_data_batch"), rs, mr=False)
    _write_chaos(os.path.join(shared, "CHAOS", "MR_data_batch1"), rs, mr=True)
    _write_pairs(shared, rs)
    _write_msd(str(tmp / "volumes"), rs)
    out = {}
    for name, pkg in (("jax", jmsd), ("port", tmsd)):
        root = tmp / name
        shutil.copytree(tmp / "volumes", root)
        for entry in os.listdir(shared):
            os.symlink(os.path.join(shared, entry), root / entry)
        for task, _ in MSD.values():
            pkg.extract_task(str(root / task))
        out[name] = str(root)
    return out


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", NAMES)
def test_samples_match(roots, name, mode):
    got, want = [], []
    sets = {}
    for pkg, key, out in ((jbase, "jax", want), (tbase, "port", got)):
        random.seed(3)
        np.random.seed(3)
        ds = pkg.get_dataset(name, roots[key], mode=mode)
        sets[key] = ds
        out.extend(ds[i] for i in range(len(ds)))
    rel = lambda ds, key: [tuple(p and os.path.relpath(p, roots[key]) for p in pair)
                           for pair in ds.data_info]
    assert rel(sets["port"], "port") == rel(sets["jax"], "jax")
    spec = tbase.SPECS[name]
    assert len(got) == len(want) >= 3
    for (ti, tl), (ji, jl) in zip(got, want):
        assert ti.shape == ji.shape == spec.crop_size + (spec.in_channels,)
        assert ti.dtype == ji.dtype == np.float32 and tl.dtype == jl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    assert max(int(lab.max()) for _, lab in got) > 0


def test_chaos_has_slices_without_masks(roots):
    ds = tbase.get_dataset("chaos", roots["port"], mode="val")
    missing = [i for i, (_, mask) in enumerate(ds.data_info) if mask is None]
    assert len(missing) == 1
    assert not ds[missing[0]][1].any()


@pytest.mark.parametrize("variant", [
    dict(preamble=True, explicit=True), dict(preamble=False, explicit=True),
    dict(preamble=True, explicit=False, empty_first=True),
    dict(preamble=True, explicit=False), dict(preamble=False, explicit=False)],
    ids=["explicit", "no_preamble", "implicit", "implicit_uid_first", "implicit_no_preamble"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
def test_dicom_variants_read_alike(tmp_path, variant, dtype):
    """senas_tpu's reader (and so its copy in the port) reads explicit VR
    with or without the preamble, and implicit VR only where the data set's
    first element is empty: its scan of the file meta group steps over the
    first data set element as if it were explicit. Both packages fail the
    same way on the other implicit files."""
    rs = np.random.RandomState(1)
    px = (rs.rand(20, 24) * 3000).astype(dtype)
    path = str(tmp_path / "x.dcm")
    write_dicom(path, px, slope=2.0, intercept=-1024.0, **variant)
    results = []
    for reader in (jdicom.read_dicom_pixels, tdicom.read_dicom_pixels):
        try:
            results.append(reader(path))
        except ValueError as e:
            results.append(str(e))
    (ja, *jrest), (ta, *trest) = [r if isinstance(r, tuple) else (r,) for r in results]
    if isinstance(ja, str):
        assert ta == ja and "no PixelData" in ja
        assert not variant["explicit"] and not variant.get("empty_first")
    else:
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(ta, px)
        assert trest == jrest == [2.0, -1024.0]


@pytest.mark.parametrize("name", sorted(MSD))
def test_extract_task_matches(roots, name):
    task = MSD[name][0]
    for sub in ("imagesTr", "labelsTr"):
        dirs = [os.path.join(roots[k], task, sub) for k in ("jax", "port")]
        cases = sorted(c for c in os.listdir(dirs[0]) if ".nii" not in c)
        assert cases == sorted(c for c in os.listdir(dirs[1]) if ".nii" not in c) == [
            "a_001", "a_002"]
        for case in cases:
            files = sorted(os.listdir(os.path.join(dirs[0], case)))
            assert files == sorted(os.listdir(os.path.join(dirs[1], case))) == [
                "0.png", "1.png", "2.png"]
            for f in files:
                with Image.open(os.path.join(dirs[0], case, f)) as want_im:
                    assert want_im.mode == "L"
                    want = np.asarray(want_im)
                with Image.open(os.path.join(dirs[1], case, f)) as got_im:
                    assert got_im.mode == "L"
                    got = np.asarray(got_im)
                np.testing.assert_array_equal(got, want)
                if sub == "labelsTr":
                    assert set(np.unique(got)) <= {0, 255}
    vals = imfile.read_image(os.path.join(roots["port"], task, "imagesTr", "a_001", "0.png"),
                             "L")
    assert vals.max() == 255 and vals.min() == 0        # saturated at both ends


@pytest.mark.parametrize("name", ["chaos", "chaos_mr"])
def test_class_weights_match(roots, name):
    got = tbase.get_dataset(name, roots["port"], mode="val").class_weights_from_masks()
    want = jbase.get_dataset(name, roots["jax"], mode="val").class_weights_from_masks()
    assert got == want and len(got) == (5 if name == "chaos_mr" else 2)


def test_helpers_match():
    from senas_tpu.data import png_datasets as jpng
    from senas_tpu.utils.misc import create_class_weight as jweights

    from senas_torch.utils.misc import create_class_weight as tweights
    for name, kind, dup in (("IMG-0004-00007.dcm", "CT", False),
                            ("i0012,0000b.dcm", "CT", False),
                            ("IMG-0004-00007.dcm", "MR", True),
                            ("IMG-0004-00008.dcm", "MR", False)):
        assert tpng._chaos_mask_name(name, kind, dup) == jpng._chaos_mask_name(name, kind, dup)
    img = np.random.RandomState(2).rand(30, 30) * 255
    assert tpng.auto_contrast_params(img) == jpng.auto_contrast_params(img)
    counts = {0: 1e6, 80: 3e4, 160: 50.0, 240: 1.0, 255: 7e3}
    assert tweights(counts) == jweights(counts)


def test_unknown_roots_and_datasets_raise(tmp_path):
    with pytest.raises(ValueError, match="data_root"):
        tbase.get_dataset("heart", None)
    with pytest.raises(RuntimeError, match="Found 0"):
        tbase.get_dataset("chaos", str(tmp_path))
    with pytest.raises(RuntimeError, match="Found 0"):
        tbase.get_dataset("pascal_voc", str(tmp_path))
    with pytest.raises(KeyError):
        tbase.get_dataset("no_such_set", str(tmp_path))


@pytest.mark.parametrize("depth", [3, 5])
def test_hippocampus_geometry(depth):
    """senas_hippo.yml's 32 x 48 crops through the supernet at batch 1,
    c 8, meta 3: the config's search depth 3 gives [1, 32, 48, 2] logits in
    both packages; depth 5 halves 48 to 1.5 and both raise a shape
    mismatch (JAX a TypeError from a reshape, the port a RuntimeError)."""
    h, w = tbase.SPECS["hippo"].crop_size
    assert (h, w) == (32, 48)
    cfg = load_config(os.path.join(ROOT, "configs", "senas", "senas_hippo.yml"))
    assert cfg["searching"]["depth"] == 3
    m, c = 3, 8
    rng = np.random.RandomState(0)
    arch = {k: rng.randn(*v).astype(np.float32)
            for k, v in jsn.arch_param_count(m, depth).items()}
    x = rng.randn(1, h, w, 1).astype(np.float32)
    jm = jsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth, meta_node_num=m)
    tm = tsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth, meta_node_num=m,
                         device="cpu")
    aw = tsn.normalize_arch(convert.arch_to_torch(arch, "cpu"), m)
    if depth == 3:
        variables = random_variables(jm, rng, jnp.asarray(x), jsn.normalize_arch(arch, m), False)
        want = jm.apply(variables, jnp.asarray(x), jsn.normalize_arch(arch, m), False)
        convert.load_variables(tm, variables)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), aw, train=False)
        assert got[0].shape == want[0].shape == (1, h, w, 2)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **LOGIT_TOL)
        return
    with pytest.raises(TypeError, match="reshape"):
        random_variables(jm, rng, jnp.asarray(x), jsn.normalize_arch(arch, m), False)
    with pytest.raises(RuntimeError, match="size of tensor"):
        with torch.no_grad():
            tm(torch.from_numpy(x), aw, train=False)
