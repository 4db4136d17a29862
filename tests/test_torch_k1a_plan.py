"""K1a's launch plan (`senas_torch.ops.grouped_epilogue.branch_stats_plan`)
on the CPU, no card and no JAX: over a grid of (n, planes, hw, dtype,
alignment) the plan is one the launcher in csrc/grouped_epilogue.cu takes
(its checks mirrored in `_launcher_takes`), its warps or CTAs own each
plane exactly once, every plane starts 16-byte aligned on the vector path,
its grid stays within CUDA's limits, and the main path's shapes give every
SM a block and leave no last wave under the blocks one SM holds."""

import numpy as np
import pytest
import torch

from senas_torch.ops import grouped_epilogue as ge

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

SMS = 132
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535
# resident 256-thread blocks an SM (2048 threads)
BLOCKS_PER_SM = 8
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# 1x1, 31, an odd plane, 16x16, 64x64, 128x128, 256x256 and 480x480
HWS = [1, 31, 1001, 256, 4096, 16384, 65536, 230400]
PLANES = [1, 6, 192, 384, 6144]


def _pack(dtype) -> int:
    return 16 // dtype.itemsize


def _launcher_takes(plan, hw, dtype, aligned) -> bool:
    """The checks of `branch_stats` in csrc/grouped_epilogue.cu."""
    if plan.vec and (hw % _pack(dtype) or not aligned):
        return False
    return plan.path in ("warp", "cta")


def _owners(plan, planes):
    """How many warps (warp path) or CTAs (CTA path) of one branch's row of
    the grid own each plane."""
    owned = np.zeros(planes, dtype=np.int64)
    row = plan.blocks
    if plan.path == "warp":
        for bx in range(row):
            for w in range(ge.STATS_WARPS):
                if bx * ge.STATS_WARPS + w < planes:   # the kernel's early return
                    owned[bx * ge.STATS_WARPS + w] += 1
    else:
        owned[np.arange(row)] += 1
    return owned


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("planes", PLANES)
@pytest.mark.parametrize("n", [1, 6])
def test_plan_owns_each_plane_once_within_cuda_limits(n, planes, hw, dtype, aligned):
    dt = DTYPES[dtype]
    e = dt.itemsize
    plan = ge.branch_stats_plan(n, planes, hw, dt, aligned=aligned)
    assert _launcher_takes(plan, hw, dt, aligned), plan
    assert plan.vec == (aligned and hw % _pack(dt) == 0)
    assert plan.blocks % n == 0
    row = plan.blocks // n                       # grid (row, n)
    assert 1 <= row <= MAX_GRID_X and n <= MAX_GRID_Y
    assert plan.path == ("warp" if hw * e <= ge.STATS_WARP_PLANE_BYTES else "cta")
    assert (_owners(ge.StatsPlan(plan.path, plan.vec, row), planes) == 1).all()
    if plan.vec:                                 # every plane 16-byte aligned
        assert all((p * hw * e) % 16 == 0 for p in range(min(planes, 64)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,n", [((8, 24, 256, 256), 6), ((12, 32, 256, 256), 1)])
def test_main_path_has_no_small_tail_wave(shape, n, dtype):
    """A CTA a plane, every SM one or more, and a last wave of at least one
    SM's worth of blocks: at n=6 on the search path's [8,24,256,256],
    1152 blocks are one wave of 132 * 8 and 96. (Splitting those planes
    over thread-block clusters to even the waves measured slower on the
    card: PERF.md section 6.)"""
    plan = ge.branch_stats_plan(n, shape[0] * shape[1], shape[2] * shape[3], DTYPES[dtype])
    assert plan.path == "cta" and plan.vec
    assert plan.blocks >= SMS
    tail = plan.blocks % (SMS * BLOCKS_PER_SM)
    assert tail == 0 or tail >= BLOCKS_PER_SM, plan


def test_small_planes_take_a_warp_each():
    """[12,32,1,1] is 48 blocks of eight warps, not 384 blocks; a plane of
    2 KB is a warp's, one of 4 KB a CTA's."""
    assert ge.branch_stats_plan(1, 12 * 32, 1, torch.float32) == ge.StatsPlan("warp", False, 48)
    assert ge.branch_stats_plan(1, 12 * 512, 256, torch.float32).path == "warp"
    assert ge.branch_stats_plan(1, 12 * 512, 1024, torch.bfloat16).path == "warp"
    assert ge.branch_stats_plan(1, 12 * 512, 1024, torch.float32).path == "cta"


def test_plan_is_cached_by_all_its_arguments():
    """The wrapper asks for the plan at every call: the second ask is the
    cache's, and dtype and alignment are part of the key."""
    first = ge.branch_stats_plan(6, 192, 65536, torch.float32)
    assert ge.branch_stats_plan(6, 192, 65536, torch.float32) is first
    assert ge.branch_stats_plan(6, 192, 65536, torch.float32, aligned=False).vec is False
    assert ge.branch_stats_plan(6, 192, 256, torch.bfloat16).path == "warp"
    assert ge.branch_stats_plan(6, 192, 256, torch.float32).path == "warp"
    assert ge.branch_stats_plan(6, 192, 1024, torch.float32).path == "cta"
