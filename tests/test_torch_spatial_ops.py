"""The image-H split of the port's mesh (senas_torch/parallel/spatial.py,
the row-split parts of mesh.py, collectives.py and runner/common.py):

  * without a second process: the row blocks, the levels a split image
    names by width, the rank layout and subgroup views, `shard_batch` and
    `assemble_global_batch` with `spatial`, the runners' placer (the rows
    split where the spatial size divides H; the data index's rows whole on
    each of its ranks where it does not; a trailing batch whole on every
    rank), and the step wrapper's choice of mesh for each;
  * over gloo ranks on the CPU (tests/torch_mesh_workers.py
    `spatial_ops`), every row-shard op of the SENAS models against the
    same op in one process, in f64 within 1e-10 of each result's scale,
    forward and gradient (x's and the kernel's; loss = a random weighting
    of the gathered outputs): 3x3, 5x5 dilation 2 and 3 (stride 1 and 2),
    7x7, 1x1 stride 2 and depthwise convolutions; stride-2 transposed
    convolutions (3x3, 5x5 dilation 2 and 3, depthwise, 1x1 unpadded); the
    3x3 average (count_include_pad=False) and max pools at stride 1 and 2;
    the 2x2 max pool; the bilinear 2x upsample; the SE block's image mean.
    Each on maps of 12, 10, 6, 3 and 2 rows: over 2 ranks (MeshSpec(1,
    2)), then over 4 (MeshSpec(1, 4) and MeshSpec(2, 2)), where blocks of
    one row and empty blocks meet halos of up to 6 rows;
  * the same way, the generalised windows of the encoder families
    (`spatial_windows`, one test case an op and a spawn size) against the
    torch op of the global image (F.conv2d, F.max_pool2d, F.avg_pool2d,
    after an F.pad where the padding is asymmetric): rectangular kernels
    with (ph, pw) pads, valid ones at stride 1 and 2; asymmetric (lo, hi)
    pads at stride 2 (TF 'SAME', depthwise too); k x k max pools with (0,
    1) and symmetric pads at strides 1 and 2; average pools with
    count_include_pad True and False; on maps where an output level
    leaves a rank's block empty.

Two spawns, one of 2 ranks and one of 4."""

import numpy as np
import pytest
import torch

from senas_torch.ops import primitives as P
from senas_torch.parallel import collectives
from senas_torch.parallel import mesh as M
from senas_torch.parallel.collectives import row_bounds
from senas_torch.parallel.spatial import _parts
from senas_torch.runner import common

from torch_mesh_workers import CASES, SPATIAL_OPS, WINDOW_OPS, Ranks, combine, window_reference
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

F64_REL = 1e-10
SHAPES = ((12, 10), (10, 8), (6, 7), (3, 5), (2, 4))
SPECS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}


def _mesh(rank, data, spatial):
    """A mesh as rank `rank` of data x spatial ranks sees it (no group)."""
    return M.Mesh(spec=M.MeshSpec(data=data, spatial=spatial), rank=rank,
                  device=torch.device("cpu"), group=object(),
                  spatial_group=object() if spatial > 1 else None,
                  data_group=object() if data > 1 and spatial > 1 else None)


def test_row_blocks_and_levels():
    assert [row_bounds(12, 4, s) for s in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert [row_bounds(6, 4, s) for s in range(4)] == [(0, 1), (1, 3), (3, 4), (4, 6)]
    assert [row_bounds(3, 4, s) for s in range(4)] == [(0, 0), (0, 1), (1, 2), (2, 3)]
    # the levels of a 24 x 20 image by their widths, as the ops enter them;
    # a width two levels share names none
    split = collectives.RowSplit(group=None, size=2, index=1, levels={20: 24})
    for width, height in ((10, 12), (5, 6), (3, 3), (10, 12), (2, 2)):
        split.enter(width, height)
    assert split.levels == {20: 24, 10: 12, 5: 6, 3: 3, 2: 2}
    assert split.height(5) == 6 and split.bounds(6) == (3, 6)
    with pytest.raises(ValueError, match="no level"):
        split.height(7)
    split.enter(2, 1)
    assert split.levels[2] is None
    with pytest.raises(ValueError, match="no level"):
        split.height(2)
    split.enter(2, 2)
    assert split.levels[2] is None
    # a window's rows above, in and below a block, inside the image
    assert _parts((3, 6), (1, 8), 12) == ((1, 3), (3, 6), (6, 8))
    assert _parts((3, 6), (-2, 2), 12) == ((0, 2), (3, 3), (2, 2))
    assert _parts((0, 0), (-1, 2), 3) == ((0, 0), (0, 0), (0, 2))


def test_rank_layout_and_data_view():
    """Rank r at data index r // spatial and spatial index r % spatial, as
    senas_tpu's devices.reshape(data, spatial)."""
    m = _mesh(5, 3, 2)
    assert (m.data_index, m.spatial_index, m.world_size) == (2, 1, 6)
    assert m.rows(12) == slice(8, 12) and m.image_rows(10) == slice(5, 10)
    view = m.data_view()
    assert view.spec == M.MeshSpec(3) and view.rank == 2 and view.group is m.data_group
    # one data index: the view has no group, so a step over it runs alone
    assert _mesh(1, 1, 2).data_view().group is None
    flat = _mesh(1, 2, 1)
    assert flat.data_view().group is flat.group and flat.data_view().rank == 1


def test_shard_batch_and_assembly_with_spatial():
    batch = {"image": np.arange(4 * 8 * 3).reshape(4, 8, 3, 1),
             "label": np.arange(4 * 8 * 3).reshape(4, 8, 3)}
    got = M.shard_batch(_mesh(3, 2, 2), batch, spatial=True)
    np.testing.assert_array_equal(got["image"], batch["image"][2:4, 4:8])
    np.testing.assert_array_equal(got["label"], batch["label"][2:4, 4:8])
    assert got[M.ROW_SPLIT] == (8, 3)
    assert M.ROW_SPLIT not in M.shard_batch(_mesh(3, 2, 2), batch)
    local, shapes = M.assemble_global_batch(_mesh(3, 2, 2), got, spatial=True)
    assert shapes["image"] == (4, 8, 3, 1) and shapes["label"] == (4, 8, 3)
    with pytest.raises(ValueError, match="spatial axis"):
        M.shard_batch(_mesh(0, 1, 3), batch, spatial=True)


def test_placer_splits_rows_where_the_spatial_size_divides_h():
    """senas_tpu/runner/common.py:98-106: H split only when the spatial
    size divides it; else the data index's rows go whole to each of its
    ranks and the step reduces over the data axis alone; a batch the data
    axis does not divide runs whole on every rank."""
    rs = np.random.RandomState(0)
    mesh = _mesh(3, 2, 2)
    place = common.make_batch_placer(torch.device("cpu"), mesh, spatial=True)
    batch = {"image": rs.randn(4, 8, 6, 1).astype(np.float32),
             "label": rs.randint(0, 2, (4, 8, 6)).astype(np.int32)}
    split = place(batch)
    np.testing.assert_array_equal(split["image"].numpy(), batch["image"][2:4, 4:8])
    assert split[M.ROW_SPLIT] == (8, 6) and M.REPLICATED not in split
    odd = place({k: v[:, :7] for k, v in batch.items()})
    assert M.ROW_SPLIT not in odd and odd["image"].shape == (2, 7, 6, 1)
    np.testing.assert_array_equal(odd["label"].numpy(), batch["label"][2:4, :7])
    whole = place({k: v[:3] for k, v in batch.items()})
    assert whole[M.REPLICATED] and whole["image"].shape == (3, 8, 6, 1)
    # the runners pass spatial only with mesh_spatial > 1: a data-only mesh
    # never splits rows
    flat = common.make_batch_placer(torch.device("cpu"), _mesh(1, 2, 1), spatial=False)(batch)
    assert M.ROW_SPLIT not in flat and flat["image"].shape == (2, 8, 6, 1)

    seen = []
    step = M.shard_train_step(lambda b: seen.append(
        (collectives.active_mesh(), collectives.active_split())), mesh)
    for b in (split, odd, whole):
        step(b)
    (m0, s0), (m1, s1), (m2, s2) = seen
    assert m0 is mesh and (s0.size, s0.index, s0.height(6), s0.levels) == (2, 1, 8, {6: 8})
    assert m1.spec == M.MeshSpec(2) and m1.group is mesh.data_group and s1 is None
    assert m2 is None and s2 is None
    assert collectives.active_mesh() is None and collectives.active_split() is None
    with pytest.raises(ValueError, match="placed differently"):
        M.shard_train_step(lambda *b: None, mesh)(split, odd)


def _ops_case(rng, batch, h, w):
    """Inputs of `spatial_ops` at an image of h x w rows and columns (each
    op enters the level it makes). The 2x2 pool floors, so it runs only
    where h and w are even."""
    x = rng.randn(batch, 3, h, w)
    weights = {n: rng.randn(*spec[2]) for n, spec in SPATIAL_OPS.items() if spec[2]}
    ops = [n for n in SPATIAL_OPS if n != "max2" or (h % 2 == 0 and w % 2 == 0)]
    r_weights = {}
    for n in ops:
        fn, kw, ws = SPATIAL_OPS[n]
        args = (torch.from_numpy(x),) + ((torch.from_numpy(weights[n]),) if ws else ())
        y = getattr(P, fn)(*args, **kw)
        r_weights[n] = rng.randn(*(y.permute(0, 2, 3, 1) if y.dim() == 4 else y).shape)
    return dict(x=x, weights=weights, r_weights=r_weights, ops=ops, image_hw=(h, w))


def _windows_case(rng, batch, h, w):
    """Inputs of `spatial_windows` at an image of h x w: the WINDOW_OPS
    whose output has a row and a column there."""
    x = rng.randn(batch, 3, h, w)
    weights = {n: rng.randn(*spec[2]) for n, spec in WINDOW_OPS.items() if spec[2]}
    ops, r_weights = [], {}
    for n in WINDOW_OPS:
        w_n = [torch.from_numpy(weights[n])] if n in weights else []
        try:
            y = window_reference(n, torch.from_numpy(x), *w_n)
        except RuntimeError:   # the window is larger than the padded map
            continue
        if min(y.shape[2:]):
            ops.append(n)
            r_weights[n] = rng.randn(*y.permute(0, 2, 3, 1).shape)
    return dict(x=x, weights=weights, r_weights=r_weights, ops=ops, image_hw=(h, w))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both kinds of case in one spawn of 2 ranks and one of 4: (per world,
    the list of (case name, spec, split result, single-process result))."""
    rng = np.random.RandomState(0)
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = {world: [("spatial_ops", spec, _ops_case(rng, 2 * spec[0], h, w)) for spec in specs
                    for h, w in SHAPES] for world, specs in SPECS.items()}
    rng = np.random.RandomState(1)
    for world, specs in SPECS.items():
        jobs[world] += [("spatial_windows", spec, _windows_case(rng, 2 * spec[0], h, w))
                        for spec in specs for h, w in SHAPES]
    ranks = Ranks([(name, dict(kw, mesh_spec=spec)) for name, spec, kw in jobs[2]], tmp, 2)
    results = {2: ranks.results()}
    ranks = Ranks([(name, dict(kw, mesh_spec=spec)) for name, spec, kw in jobs[4]], tmp, 4)
    single = {world: [CASES[name](None, **kw) for name, _, kw in job]
              for world, job in jobs.items()}
    results[4] = ranks.results()
    return {world: [(name, spec, combine([r[i] for r in results[world]], spec),
                     single[world][i]) for i, (name, spec, _) in enumerate(jobs[world])]
            for world in jobs}


@pytest.fixture(scope="module")
def ops_runs(spawned):
    return {world: [(spec, got, want) for name, spec, got, want in runs
                    if name == "spatial_ops"] for world, runs in spawned.items()}


@pytest.mark.parametrize("world", sorted(SPECS))
def test_row_shard_ops_equal_one_process_f64(ops_runs, world):
    for spec, got, want in ops_runs[world]:
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].shape == v.shape, (spec, k)
            scale = max(float(np.abs(v).max()), 1e-300)
            np.testing.assert_allclose(got[k], v, rtol=0, atol=F64_REL * scale,
                                       err_msg=f"{spec} {k}")


@pytest.mark.parametrize("world,op", [(world, op) for world in sorted(SPECS) for op in WINDOW_OPS])
def test_window_op_equals_the_global_torch_op_f64(spawned, world, op):
    """The generalised window `op` over the ranks of `world`, every mesh
    and map size where its output has a row: its output, x's gradient and
    the weight's equal the torch op's of the global image within 1e-10 of
    each result's scale."""
    ran = 0
    for name, spec, got, want in spawned[world]:
        if name != "spatial_windows" or f"{op}_loss" not in want:
            continue
        ran += 1
        keys = [k for k in (f"block2:{op}_y", f"block2:{op}_dx", f"sum:{op}_dw", f"{op}_loss")
                if k in want]
        assert len(keys) >= 3 and all(k in got for k in keys)
        for k in keys:
            assert got[k].shape == want[k].shape, (spec, k)
            scale = max(float(np.abs(want[k]).max()), 1e-300)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=F64_REL * scale,
                                       err_msg=f"{spec} {k}")
    assert ran >= 3 * len(SPECS[world]), ran
