"""Row-shard forms of the models' spatial ops: the image-H split of the
mesh (ROADMAP.md M13b for the SENAS models, M13c for the baseline zoo).

Port of what GSPMD does to `senas_tpu`'s convolutions, poolings and
resizes when a batch is sharded over the "spatial" axis
(`senas_tpu/parallel/mesh.py:114-122`): each rank holds a block of image
rows, fetches the rows its outputs read from the ranks that hold them (a
halo exchange), and computes only its own output rows. The result is the
single-device op's, row for row.

Rows are indexed globally. Every level of a split image, the output of a
stride-2 op included, is cut by `collectives.row_bounds`: contiguous blocks
[s*H/S, (s+1)*H/S) rounded down, which differ by at most one row and leave
a rank empty where a level has fewer rows than ranks. Each output row is
computed by the rank that holds it in the output level; the input rows it
reads (its window) may lie on any rank, so a halo may reach past a
neighbour's whole block (a 5x5 dilation-3 convolution reads 6 rows a side,
where a deep level's blocks hold 4 or fewer).

`halo_rows` is the exchange. Every rank writes the rows it holds of every
other rank's window into one zero-padded buffer [S, 2, B, C, m, W] (slot 0
the rows above the receiver's block, slot 1 those below, m the longest
such run on any rank), one `all_reduce` over the spatial subgroup sums it,
and each rank reads its own two slots. Its backward is the adjoint: each
rank writes its window's cotangents into its slots, one `all_reduce`, and
each rank adds the entries of the rows it holds into its gradient. Every
rank makes the same calls in the same order, the first and last and an
empty one included, in the forward, in the backward and in a remat
recompute; where no rank needs a halo (a 1x1 convolution at stride 1) no
rank calls. Rows outside the image take the op's own fill: zero for a
convolution and the average pool (whose divisor counts only the image's
rows), -inf for a max pool; the bilinear resize clamps at the image's
border as the single-device resize does, with no fill.

The width stays whole on every rank, so each op keeps its padding there.
Every op returns a contiguous NCHW block, as the single-device op does
(the epilogue's kernels take contiguous operands), and enters the level it
makes (`RowSplit.enter`: a level's global height is found by its width).

The windows are general (ROADMAP.md M13d, the encoder families): a
convolution of any kernel (kh, kw), a k x k max or average pool, each with
its own (top, bottom) row pads and (left, right) column pads (`pads`):
torch's (ph, pw), TF 'SAME' at stride 2 (hi = lo + 1), a ceil-mode pool's
(0, 1). Output row o reads input rows [o*stride - top, o*stride - top +
reach]; the level it makes counts both row pads. An average pool divides
by k*k (count_include_pad) or by its taps inside the global image.

The zoo adds row resizes and whole levels. `source_rows` fetches, for each
output row of a resize, the rows its taps read at their global positions
(the nearest 2x and integer-ratio picks, the align-corners bilinear
resize at any ratio), from a split level or from a map every rank holds
whole (no exchange then). `gather_level` gives every rank a whole level
(a zero-padded `all_reduce`) for an op that reads every row; its adjoint
is the `all_reduce` of the whole level's cotangent, then this rank's rows,
since each rank's output rows send cotangent into every rank's input rows.
`HALO` counts the exchanges and the gathers and the bytes of their
buffers (forward and backward), for the card's measurements.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from senas_torch.parallel import collectives
from senas_torch.parallel.collectives import RowSplit, active_split

HALO = {"calls": 0, "bytes": 0, "gathers": 0, "gather_bytes": 0}


def reset_halo_counts() -> None:
    HALO.update(calls=0, bytes=0, gathers=0, gather_bytes=0)


Span = Tuple[int, int]


def _parts(held: Span, window: Span, height: int) -> Tuple[Span, Span, Span]:
    """(above, own, below): the rows of `window` inside the image that lie
    above the block `held`, in it, and below it; each [lo, hi), empty as
    (v, v)."""
    a, b = held
    lo, hi = max(window[0], 0), min(window[1], height)
    if lo >= hi:
        return (lo, lo), (lo, lo), (lo, lo)
    above = (lo, max(lo, min(a, hi)))
    start = max(a, lo)
    own = (start, max(start, min(b, hi)))
    start = max(b, lo)
    below = (min(start, hi), hi)
    return above, own, below


class _Plan:
    """Every rank's window and its parts, from the global layout alone, so
    that every rank computes the same plan."""

    def __init__(self, split: RowSplit, height: int, windows: Sequence[Span]):
        self.split, self.height, self.windows = split, height, list(windows)
        self.held = [split.bounds(height, r) for r in range(split.size)]
        self.parts = [_parts(h, w, height) for h, w in zip(self.held, self.windows)]
        self.m = max(max(ab[1] - ab[0], be[1] - be[0]) for ab, _, be in self.parts)

    def runs(self, r: int):
        """(slot, run) of rank r's halo: the rows above, the rows below."""
        return (0, self.parts[r][0]), (1, self.parts[r][2])


def _buffer(x: torch.Tensor, plan: _Plan) -> torch.Tensor:
    S = plan.split.size
    return x.new_zeros((S, 2) + tuple(x.shape[:2]) + (plan.m, x.shape[3]))


def _sum(buf: torch.Tensor, plan: _Plan) -> torch.Tensor:
    HALO["calls"] += 1
    HALO["bytes"] += buf.numel() * buf.element_size()
    return collectives._all_reduce_(buf, plan.split.group)


def _exchange(x: torch.Tensor, plan: _Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of this rank's window above and below its block, from the
    ranks that hold them."""
    me = plan.split.index
    a, b = plan.held[me]
    buf = _buffer(x, plan)
    for r in range(plan.split.size):
        if r == me:
            continue
        for slot, (u, v) in plan.runs(r):
            lo, hi = max(u, a), min(v, b)
            if lo < hi:
                buf[r, slot, :, :, lo - u:hi - u] = x[:, :, lo - a:hi - a]
    buf = _sum(buf, plan)
    (_, (u0, v0)), (_, (u1, v1)) = plan.runs(me)
    return buf[me, 0, :, :, :v0 - u0].clone(), buf[me, 1, :, :, :v1 - u1].clone()


def _adjoint(d_above: torch.Tensor, d_below: torch.Tensor, plan: _Plan,
             shape: torch.Size) -> torch.Tensor:
    """The cotangent of this rank's block: each rank's halo cotangents
    summed into the rows they came from."""
    me = plan.split.index
    a, b = plan.held[me]
    buf = d_above.new_zeros((plan.split.size, 2) + tuple(shape[:2]) + (plan.m, shape[3]))
    buf[me, 0, :, :, :d_above.shape[2]] = d_above
    buf[me, 1, :, :, :d_below.shape[2]] = d_below
    buf = _sum(buf, plan)
    dx = d_above.new_zeros(shape)
    for r in range(plan.split.size):
        if r == me:
            continue
        for slot, (u, v) in plan.runs(r):
            lo, hi = max(u, a), min(v, b)
            if lo < hi:
                dx[:, :, lo - a:hi - a] += buf[r, slot, :, :, lo - u:hi - u]
    return dx


class _HaloRows(torch.autograd.Function):
    """(above, below) = the halo of x's block; dx = the adjoint exchange."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape = plan, x.shape
        return _exchange(x, plan)

    @staticmethod
    def backward(ctx, d_above, d_below):
        return _adjoint(d_above.contiguous(), d_below.contiguous(), ctx.plan, ctx.shape), None


def halo_rows(x: torch.Tensor, split: RowSplit, height: int, windows: Sequence[Span],
              fill: float = 0.0) -> torch.Tensor:
    """Rows [lo, hi) = windows[s] of a level `height` rows high whose block
    [s*H/S, (s+1)*H/S) this rank holds as x [B, C, h, W]: its own rows, the
    halo rows above and below from the ranks that hold them, and `fill`
    for the rows outside the image. Every rank passes every rank's window.
    Differentiable in x (the backward exchanges the halo's cotangents)."""
    plan = _Plan(split, height, windows)
    lo, hi = plan.windows[split.index]
    a = plan.held[split.index][0]
    own = plan.parts[split.index][1]
    pieces = []
    above = min(max(-lo, 0), hi - lo)
    if above:
        pieces.append(x.new_full(x.shape[:2] + (above, x.shape[3]), fill))
    mine = x[:, :, own[0] - a:own[1] - a]
    if plan.m:
        grad = torch.is_grad_enabled() and x.requires_grad
        top, bottom = _HaloRows.apply(x, plan) if grad else _exchange(x, plan)
        pieces += [top, mine, bottom]
    else:
        pieces.append(mine)
    below = min(max(hi - height, 0), hi - lo - above)
    if below:
        pieces.append(x.new_full(x.shape[:2] + (below, x.shape[3]), fill))
    return torch.cat(pieces, dim=2) if len(pieces) > 1 else pieces[0]


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def _split() -> RowSplit:
    split = active_split()
    if split is None:
        raise RuntimeError("a row-shard op runs under an active row split only")
    return split


def _out_blocks(split: RowSplit, height: int) -> List[Span]:
    return [split.bounds(height, r) for r in range(split.size)]


def _strided_windows(split: RowSplit, out_height: int, stride: int, pad: int,
                     reach: int) -> List[Span]:
    """The input rows that output rows [oa, ob) of a strided window op read:
    [oa*stride - pad, (ob-1)*stride - pad + reach + 1), `reach` the span of
    its taps (dilation*(k-1)); empty for an empty block."""
    return [(oa * stride - pad, (ob - 1) * stride - pad + reach + 1) if ob > oa
            else (oa * stride - pad,) * 2 for oa, ob in _out_blocks(split, out_height)]


def _empty(shape, *inputs) -> torch.Tensor:
    """An output block with no rows that still depends on `inputs` (its
    window and weights), so that the backward reaches the window's halo
    exchange on this rank as on every other."""
    # (t * 0).sum(): a dense zero gradient for each input (t.sum() * 0 would
    # hand back a stride-0 one, which the gradient's all-reduce cannot fill)
    return sum((t * 0).sum() for t in inputs).expand(shape)


def _level(split: RowSplit, y: torch.Tensor, height: int) -> torch.Tensor:
    """y, a block of a level `height` rows high, after entering the level
    (`RowSplit.enter`): the next op finds its height by its width."""
    split.enter(y.shape[3], height)
    return y


def entered(y: torch.Tensor, height: int) -> torch.Tensor:
    """`_level` under the active split: for the row resizes built on
    `source_rows`, which make their columns themselves."""
    return _level(_split(), y, height)


Pads = Tuple[Span, Span]


def pads(padding) -> Pads:
    """((top, bottom), (left, right)) of a padding given as an int (every
    side), a pair of ints (rows, columns; torch's `padding=(ph, pw)`) or a
    pair of (lo, hi) pairs (TF 'SAME' at stride 2, a ceil-mode pool)."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    rows, cols = padding
    two = lambda p: (p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
    return two(rows), two(cols)


def _columns(win, cols: Span, fill: float = 0.0):
    """(the window, the column padding left to the op): the op pads a
    symmetric (p, p) itself; an asymmetric one is padded here with `fill`
    (the width is whole on every rank)."""
    left, right = cols
    if left == right:
        return win, (0, left)
    return F.pad(win, (left, right), value=fill), (0, 0)


def conv2d(x, w, stride: int = 1, dilation: int = 1, groups: int = 1, padding=0):
    """F.conv2d(x, w, stride, dilation=dilation, groups=groups) of the
    global image zero-padded by `padding` (`pads`: an int, (rows,
    columns), or ((top, bottom), (left, right))), this rank's output rows:
    any kernel (kh, kw), stride 1 or 2, depthwise too. Output row o reads
    input rows [o*stride - top, o*stride - top + dilation*(kh - 1)]; the
    level it makes is (H + top + bottom - dilation*(kh - 1) - 1) // stride
    + 1 rows high."""
    split = _split()
    (top, bottom), cols = pads(padding)
    kh, kw = w.shape[-2], w.shape[-1]
    width = x.shape[3]
    height = split.height(width)
    reach = dilation * (kh - 1)
    out_h = (height + top + bottom - reach - 1) // stride + 1
    out_w = (width + sum(cols) - dilation * (kw - 1) - 1) // stride + 1
    win = halo_rows(x, split, height, _strided_windows(split, out_h, stride, top, reach))
    oa, ob = split.bounds(out_h)
    if ob == oa:
        return _level(split, _empty((x.shape[0], w.shape[0], 0, out_w), win, w), out_h)
    win, p = _columns(win, cols)
    y = F.conv2d(win, w, stride=stride, padding=p, dilation=dilation, groups=groups)
    return _level(split, y, out_h)


def conv_transpose2d(x, w, stride: int, padding: int, output_padding: int, dilation: int = 1,
                     groups: int = 1, op: Callable = F.conv_transpose2d):
    """op(x, w, stride, padding, output_padding, groups, dilation) of the
    global image (`op` a transposed convolution with F.conv_transpose2d's
    arguments), this rank's output rows. Output row i reads input rows j
    with j*stride - padding + dilation*t = i for a tap t: this rank's
    window covers every j of its rows; the transposed convolution of the
    window, unpadded along H, lands at global row window_lo*stride -
    padding, and is cut (and zero-extended past the window's last
    contribution) to the rank's rows."""
    split = _split()
    k, width = w.shape[-1], x.shape[3]
    height = split.height(width)
    reach = dilation * (k - 1)
    out_h = (height - 1) * stride - 2 * padding + reach + output_padding + 1
    out_w = (width - 1) * stride - 2 * padding + reach + output_padding + 1
    windows = [((oa + padding - reach) // stride, (ob - 1 + padding) // stride + 1) if ob > oa
               else ((oa + padding - reach) // stride,) * 2
               for oa, ob in _out_blocks(split, out_h)]
    win = halo_rows(x, split, height, windows)
    oa, ob = split.bounds(out_h)
    if ob == oa:
        return _level(split, _empty((x.shape[0], w.shape[1] * groups, 0, out_w), win, w), out_h)
    y = op(win, w, stride=stride, padding=(0, padding), output_padding=(0, output_padding),
           groups=groups, dilation=dilation)
    start = windows[split.index][0] * stride - padding
    y = y[:, :, oa - start:ob - start]
    if y.shape[2] < ob - oa:   # rows past every tap of the window: no contribution
        y = F.pad(y, (0, 0, 0, ob - oa - y.shape[2]))
    return _level(split, y.contiguous(), out_h)


def _pool_count(n_out: int, start: int, stride: int, size: int, k: int,
                lo: int) -> torch.Tensor:
    """How many of the k taps of each output position's window, [c*stride
    - lo, c*stride - lo + k) for c = start, ..., start + n_out - 1, lie
    inside [0, size)."""
    c = (torch.arange(n_out) + start) * stride - lo
    return torch.clamp(c + k, max=size) - torch.clamp(c, min=0)


def _window_op(x, k: int, stride: int, padding, fill: float):
    """(split, the level's height, the output's height and width, this
    rank's window of rows filled with `fill` outside the image, its output
    rows) of a k x k window op."""
    split = _split()
    (top, bottom), cols = pads(padding)
    width = x.shape[3]
    height = split.height(width)
    out_h = (height + top + bottom - k) // stride + 1
    out_w = (width + sum(cols) - k) // stride + 1
    win = halo_rows(x, split, height, _strided_windows(split, out_h, stride, top, k - 1),
                    fill=fill)
    return split, height, out_h, out_w, win, split.bounds(out_h)


def max_pool(x, k: int, stride: int, padding=0):
    """F.max_pool2d(x, k, stride) of the global image padded by `padding`
    (`pads`) with -inf, as the single-device pool pads: symmetric, or a
    ceil-mode pool's (0, 1)."""
    split, _, out_h, out_w, win, (oa, ob) = _window_op(x, k, stride, padding, float("-inf"))
    if ob == oa:
        return _level(split, _empty((x.shape[0], x.shape[1], 0, out_w), win), out_h)
    win, p = _columns(win, pads(padding)[1], float("-inf"))
    return _level(split, F.max_pool2d(win, k, stride=stride, padding=p), out_h)


def avg_pool(x, k: int, stride: int, padding=0, count_include_pad: bool = True):
    """F.avg_pool2d(x, k, stride, padding, count_include_pad=...) of the
    global image. With `count_include_pad` each window sums its taps, the
    zero fill included, and divides by k*k; without, by the number of its
    taps inside the image, counted against the global image (not the
    rank's block): the window's sums, then the counts of its rows and
    columns."""
    split, height, out_h, out_w, win, (oa, ob) = _window_op(x, k, stride, padding, 0.0)
    if ob == oa:
        return _level(split, _empty((x.shape[0], x.shape[1], 0, out_w), win), out_h)
    (top, _), cols = pads(padding)
    win, p = _columns(win, cols)
    if count_include_pad:
        return _level(split, F.avg_pool2d(win, k, stride=stride, padding=p,
                                          count_include_pad=True), out_h)
    # bf16 sums in f32 and rounds once, as the single-device pool does
    wide = win.float() if win.dtype == torch.bfloat16 else win
    s = F.avg_pool2d(wide, k, stride=stride, padding=p, count_include_pad=True,
                     divisor_override=1)
    count = (_pool_count(ob - oa, oa, stride, height, k, top)[:, None]
             * _pool_count(out_w, 0, stride, x.shape[3], k, cols[0])[None, :])
    return _level(split, (s / count.to(s.device, s.dtype)).to(x.dtype), out_h)


def upsample2x(x):
    """Bilinear 2x upsample with half-pixel centres of the global image.
    Output row i reads input rows floor(i/2 - 1/4) and the next one,
    clamped to the image: the window [(oa-1)//2, (ob-2)//2 + 2) cut to the
    image, so that the window's own clamps fall where the image's do and
    every other row of it sees its two neighbours; then the rank's rows of
    the window's resize."""
    split = _split()
    width = x.shape[3]
    height = split.height(width)
    out_h = 2 * height
    windows = [(max((oa - 1) // 2, 0), min((ob - 2) // 2 + 2, height)) if ob > oa
               else (max((oa - 1) // 2, 0),) * 2 for oa, ob in _out_blocks(split, out_h)]
    win = halo_rows(x, split, height, windows)
    oa, ob = split.bounds(out_h)
    if ob == oa:
        return _level(split, _empty((x.shape[0], x.shape[1], 0, 2 * width), win), out_h)
    start = 2 * windows[split.index][0]
    y = F.interpolate(win, scale_factor=2, mode="bilinear", align_corners=False)
    return _level(split, y[:, :, oa - start:ob - start].contiguous(), out_h)


# ---------------------------------------------------------------------------
# Row resizes and whole levels (the baseline zoo)
# ---------------------------------------------------------------------------


def source_rows(x, out_h: int, sources: Sequence[Sequence[int]], whole: bool = False
                ) -> List[torch.Tensor]:
    """For a map whose row i reads rows sources[k][i] of x's level (k over
    the taps; each list nondecreasing in i, `out_h` long): the rows each tap
    reads for this rank's output rows [oa, ob), [B, C, ob - oa, W] each.
    Rank r's window is [min_k sources[k][oa_r], max_k sources[k][ob_r - 1]
    + 1), fetched by `halo_rows`; with `whole`, x is the whole level on
    every rank (a map the ranks computed whole) and needs no exchange. The
    caller makes the columns and enters the level (`entered`)."""
    split = _split()
    height = x.shape[2] if whole else split.height(x.shape[3])
    windows = []
    for oa, ob in _out_blocks(split, out_h):
        if ob > oa:
            windows.append((min(s[oa] for s in sources), max(s[ob - 1] for s in sources) + 1))
        else:
            windows.append((0, 0))
    lo = windows[split.index][0]
    win = x[:, :, lo:windows[split.index][1]] if whole else halo_rows(x, split, height, windows)
    oa, ob = split.bounds(out_h)
    return [win.index_select(2, torch.tensor(s[oa:ob], dtype=torch.long,
                                             device=x.device) - lo) for s in sources]


class _GatherLevel(torch.autograd.Function):
    """y = the whole level, every rank's block in place; dx = this rank's
    rows of the cotangent summed over the ranks (each rank's own output
    rows send cotangent into every rank's input rows)."""

    @staticmethod
    def forward(ctx, x, split, height):
        ctx.split, ctx.rows = split, split.bounds(height)
        return _gather_level(x, split, height)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.rows
        return _sum_whole(dy.contiguous().clone(), ctx.split)[:, :, a:b], None, None


def _sum_whole(buf: torch.Tensor, split: RowSplit) -> torch.Tensor:
    HALO["gathers"] += 1
    HALO["gather_bytes"] += buf.numel() * buf.element_size()
    return collectives._all_reduce_(buf, split.group)


def _gather_level(x, split: RowSplit, height: int) -> torch.Tensor:
    a, b = split.bounds(height)
    buf = x.new_zeros(x.shape[:2] + (height, x.shape[3]))
    buf[:, :, a:b] = x
    return _sum_whole(buf, split)


def gather_level(x) -> torch.Tensor:
    """The whole level of which this rank holds block x, the same on every
    rank: a zero-padded `all_reduce` over the spatial subgroup, for an op
    that reads every row (MAnet's position attention, PSPNet's pyramid
    pools, a global max). Differentiable in x; `own_rows` cuts a whole
    result back to this rank's block."""
    split = _split()
    height = split.height(x.shape[3])
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherLevel.apply(x, split, height)
    return _gather_level(x, split, height)


def own_rows(y) -> torch.Tensor:
    """This rank's block of rows of a whole level y [B, C, H, W] that every
    rank computed alike; the level is entered."""
    split = _split()
    a, b = split.bounds(y.shape[2])
    return _level(split, y[:, :, a:b].contiguous(), y.shape[2])
