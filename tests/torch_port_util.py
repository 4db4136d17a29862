"""Shared helpers for the tests that hold senas_torch against senas_tpu.

Flax variables are made without running flax's initialisers (each new
random-init shape costs an XLA:CPU compile): `jax.eval_shape` gives the
tree, and numpy fills it from a seed, with non-trivial BN running stats.
Both packages then get the same numbers through `senas_torch.convert`.
"""

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch ops on one thread. The suite runs in several
    worker processes at once; torch's default of one thread per core in
    each of them oversubscribes the host, and its spinning thread pool then
    slows the small CPU models of these tests many times over. A module
    that imports this fixture gets it."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_variables(module, rng: np.random.RandomState, *init_args, init=None):
    """Flax {"params", "batch_stats"} of `module` filled from `rng`.
    `init` stands in for `module.init` (e.g. the original of a patched one)."""
    init = init or module.init
    shapes = jax.eval_shape(
        lambda: init({"params": jax.random.PRNGKey(0)}, *init_args))

    def fill(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, coll)
            elif coll == "batch_stats" and k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif coll == "batch_stats":
                out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
            else:
                fan = int(np.prod(v.shape[:-1])) if len(v.shape) > 1 else 1
                out[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan)).astype(np.float32)
        return out

    return {c: fill(shapes[c], c) for c in ("params", "batch_stats") if c in shapes}


def unit_scales(tree):
    """`tree` with every norm layer's `scale` leaf at 1 (its init value).
    Random scales leave some small models' f32 gradients ill-conditioned
    (tests/test_torch_zoo.py); a test that follows training steps starts
    from unit ones."""
    return {k: unit_scales(v) if isinstance(v, dict) else
            (np.ones_like(v) if k == "scale" else v) for k, v in tree.items()}


def flat(tree, prefix=""):
    """Nested dict -> {"a/b/c": np.ndarray}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def flat_leaves(tree) -> np.ndarray:
    """Every leaf of a nested dict as one float64 vector, in the order of
    the sorted paths."""
    leaves = flat(tree)
    return np.concatenate([np.zeros(0)] + [np.asarray(leaves[k], np.float64).ravel()
                                           for k in sorted(leaves)])


def nhwc(t):
    """Port NCHW tensor -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def nchw(a):
    """NHWC numpy -> NCHW contiguous CPU tensor."""
    import torch
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def assert_trees_close(got, want, rtol, atol):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


def grouped_to_mixedop(gp, gs, e, E, op_names, C, P):
    """Slice edge e out of a GroupedMixedOp's flax params/batch_stats into a
    naive MixedOp's flax variables (the layout map of
    tests/test_fused_cell.py, in numpy)."""
    params, stats = {}, {}
    sl = slice(e * P, (e + 1) * P)

    def bn(name):
        return ({"scale": gp[name]["scale"][sl], "bias": gp[name]["bias"][sl]},
                {"mean": gs[name]["mean"][sl], "var": gs[name]["var"][sl]})

    for i, name in enumerate(op_names):
        key = f"branch_{i}_{name}"
        if name in ("avg_pool", "max_pool", "up_sample", "identity", "none"):
            p = {}
            if f"{name}_kernel" in gp:
                p["kernel"] = gp[f"{name}_kernel"][..., sl]
            elif name == "none" and C != P:
                # the grouped op skips the conv on zeros; the naive one owns
                # a 1x1 kernel that cannot matter
                p["kernel"] = np.zeros((1, 1, C, P), np.float32)
            p["BatchNorm_0"], s = bn(f"{name}_bn")
            params[key], stats[key] = p, {"BatchNorm_0": s}
        elif name in ("conv_3", "dil_3_conv_5", "dil_2_conv_5"):
            bp, bs = bn(f"{name}_bn")
            params[key] = {"_ConvWeight_0": {"kernel": gp[f"{name}_kernel"][..., sl]},
                           "BatchNorm_0": bp}
            stats[key] = {"BatchNorm_0": bs}
        elif name == "se_conv_3":
            bp, bs = bn(f"{name}_bn")
            params[key] = {
                "ConvBn_0": {"_ConvWeight_0": {"kernel": gp[f"{name}_kernel"][..., sl]},
                             "BatchNorm_0": bp},
                "SEBlock_0": {"Dense_0": {"kernel": gp[f"{name}_se1"][e]},
                              "Dense_1": {"kernel": gp[f"{name}_se2"][e]}},
            }
            stats[key] = {"ConvBn_0": {"BatchNorm_0": bs}}
        else:  # dep_sep_conv_{3,5}
            idx = np.arange(C) * E + e  # depthwise channel c, multiplier e
            pp, ps = bn(f"{name}_pbn")
            params[key] = {
                "depth": {"kernel": gp[f"{name}_dkernel"][..., idx]},
                "depth_norm": {"scale": gp[f"{name}_dbn"]["scale"][idx],
                               "bias": gp[f"{name}_dbn"]["bias"][idx]},
                "point": {"kernel": gp[f"{name}_pkernel"][e][None, None]},
                "point_norm": pp,
            }
            stats[key] = {
                "depth_norm": {"mean": gs[f"{name}_dbn"]["mean"][idx],
                               "var": gs[f"{name}_dbn"]["var"][idx]},
                "point_norm": ps,
            }
    return {"params": params, "batch_stats": stats}


def fused_cell_to_naive(fv, M, C, P, cell_type, op_names):
    """FusedSearchCell flax variables -> SearchCell flax variables.
    op_names: {"DOWN"/"UP"/"NORM": list of op names}."""
    fp, fs = fv["params"], fv["batch_stats"]
    params = {"preprocess0": fp["preprocess0"], "post_process": fp["post_process"]}
    stats = {"preprocess0": fs["preprocess0"], "post_process": fs["post_process"]}
    t0 = "DOWN" if cell_type == "down" else "NORM"
    t1 = "DOWN" if cell_type == "down" else "UP"
    offsets = [sum(2 + i for i in range(n)) for n in range(M)]
    for n in range(M):
        for gkey, tt, j in (("group0", t0, 0), ("group1", t1, 1)):
            v = grouped_to_mixedop(fp[gkey], fs[gkey], n, M, op_names[tt], C, P)
            params[f"edge_{offsets[n] + j}"] = v["params"]
            stats[f"edge_{offsets[n] + j}"] = v["batch_stats"]
        for j in range(n):
            pick = lambda t: {k: pick(v) if isinstance(v, dict) else v[j]
                              for k, v in t.items()}
            params[f"edge_{offsets[n] + 2 + j}"] = pick(fp[f"inner_{n}"])
            stats[f"edge_{offsets[n] + 2 + j}"] = pick(fs[f"inner_{n}"])
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Reference-layout (torch) state_dicts, made by inverting the JAX package's
# checkpoint translation (senas_tpu/compat/torch_import.py): names and
# layouts. The reference's own modules are not in the repository, so the
# tests build a reference checkpoint from flax variables with these, and
# first check that senas_tpu's translator gives the variables back exactly.
# ---------------------------------------------------------------------------

_POOLISH = ("avg_pool", "max_pool", "up_sample", "identity", "none")
_CONVISH = ("conv_3", "dil_3_conv_5", "dil_2_conv_5")


def _inv_conv(k):
    """HWIO -> Conv2d (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _inv_tconv(k):
    """HWIO -> ConvTranspose2d (I, O, kH, kW), spatially flipped."""
    return np.ascontiguousarray(np.flip(np.transpose(k, (2, 3, 0, 1)), axis=(2, 3)))


def _inv_dw_tconv(k):
    """(kH, kW, 1, C) -> depthwise ConvTranspose2d (C, 1, kH, kW), flipped."""
    return np.ascontiguousarray(np.flip(np.transpose(k, (3, 2, 0, 1)), axis=(2, 3)))


def _put_bn(sd, name, p, s):
    sd[f"{name}.weight"] = p["scale"]
    sd[f"{name}.bias"] = p["bias"]
    sd[f"{name}.running_mean"] = s["mean"]
    sd[f"{name}.running_var"] = s["var"]
    sd[f"{name}.num_batches_tracked"] = np.array(0, np.int64)


def _put_op(sd, prefix, name, p, s, transpose):
    """One candidate op's variables at `prefix` in the reference's
    Sequential/AdapterBlock layout (utils/operations.py)."""
    conv = _inv_tconv if transpose else _inv_conv
    if name in _CONVISH:
        sd[prefix + "0.weight"] = conv(p["_ConvWeight_0"]["kernel"])
        _put_bn(sd, prefix + "1", p["BatchNorm_0"], s["BatchNorm_0"])
    elif name == "se_conv_3":
        sd[prefix + "0.weight"] = conv(p["ConvBn_0"]["_ConvWeight_0"]["kernel"])
        _put_bn(sd, prefix + "1", p["ConvBn_0"]["BatchNorm_0"], s["ConvBn_0"]["BatchNorm_0"])
        sd[prefix + "2.excitation.0.weight"] = np.ascontiguousarray(
            p["SEBlock_0"]["Dense_0"]["kernel"].T)
        sd[prefix + "2.excitation.2.weight"] = np.ascontiguousarray(
            p["SEBlock_0"]["Dense_1"]["kernel"].T)
    elif name in ("dep_sep_conv_3", "dep_sep_conv_5"):
        depth = _inv_dw_tconv if transpose else _inv_conv
        sd[prefix + "0.weight"] = depth(p["depth"]["kernel"])
        _put_bn(sd, prefix + "1", p["depth_norm"], s["depth_norm"])
        sd[prefix + "3.weight"] = _inv_conv(p["point"]["kernel"])
        _put_bn(sd, prefix + "4", p["point_norm"], s["point_norm"])
    elif name in _POOLISH:
        _put_bn(sd, prefix + "norm", p["BatchNorm_0"], s["BatchNorm_0"])
        if "kernel" in p:
            sd[prefix + "conv.weight"] = _inv_conv(p["kernel"])
    else:
        raise NotImplementedError(name)


def _put_pre_post(sd, prefix, cell_type, p, s):
    pre, pre_s = p["preprocess0"], s["preprocess0"]
    if cell_type == "down":
        _put_bn(sd, prefix + "preprocess0.2", pre["BatchNorm_0"], pre_s["BatchNorm_0"])
        if "kernel" in pre:
            sd[prefix + "preprocess0.1.weight"] = _inv_conv(pre["kernel"])
    else:
        sd[prefix + "preprocess0.conv.weight"] = _inv_conv(pre["kernel"])
        _put_bn(sd, prefix + "preprocess0.norm", pre["BatchNorm_0"], pre_s["BatchNorm_0"])
    post, post_s = p["post_process"], s["post_process"]
    sd[prefix + "post_process.conv.weight"] = _inv_conv(post["kernel"])
    _put_bn(sd, prefix + "post_process.norm", post["BatchNorm_0"], post_s["BatchNorm_0"])


def _put_stems_and_head(sd, params, stats):
    sd["stem0.0.weight"] = _inv_conv(params["stem0"]["_ConvWeight_0"]["kernel"])
    _put_bn(sd, "stem0.1", params["stem0"]["BatchNorm_0"], stats["stem0"]["BatchNorm_0"])
    blk, blk_s = params["stem1_block"], stats["stem1_block"]
    sd["stem1.2.conv1.weight"] = _inv_conv(blk["conv1"])
    sd["stem1.2.conv2.weight"] = _inv_conv(blk["conv2"])
    _put_bn(sd, "stem1.2.bn1", blk["bn1"], blk_s["bn1"])
    _put_bn(sd, "stem1.2.bn2", blk["bn2"], blk_s["bn2"])
    sd["head_block.0.segmentation_head.1.weight"] = _inv_conv(
        params["head"]["segmentation_head"]["_ConvWeight_0"]["kernel"])


def _cell_prefix(name):
    """flax cell name -> the reference's module path."""
    if name == "head":
        return "head_block.0.up_cell.", "up"
    parts = name.split("_")
    if parts[0] == "down":
        return f"blocks.0.{parts[1]}.", "down"
    return f"blocks.{parts[1]}.{parts[2]}.", "up"


def reference_fixed_state_dict(variables, genotype):
    """flax SenasModel variables -> the reference SenasModel's state_dict
    (numpy), for the cells the variables have (gamma-pruned ones absent)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _put_stems_and_head(sd, params, stats)
    for name in params:
        if not name.startswith(("down_", "up_", "head")):
            continue
        p, s = (params[name]["up_cell"], stats[name]["up_cell"]) if name == "head" \
            else (params[name], stats[name])
        prefix, cell_type = _cell_prefix(name)
        _put_pre_post(sd, prefix, cell_type, p, s)
        gene = genotype.down if cell_type == "down" else genotype.up
        for i, (op_name, inp) in enumerate(gene):
            _put_op(sd, f"{prefix}_ops.{i}.", op_name, p[f"op_{i}"], s[f"op_{i}"],
                    transpose=cell_type == "up" and inp == 1)
    return sd


def reference_search_state_dict(variables, meta):
    """Naive (per-edge) flax SenasSearch variables -> the reference
    SenasSearch's state_dict (numpy)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _put_stems_and_head(sd, params, stats)
    up_edges = {sum(2 + i for i in range(n)) + 1 for n in range(meta)}
    for name in params:
        if not name.startswith(("down_", "up_", "head")):
            continue
        p, s = (params[name]["up_cell"], stats[name]["up_cell"]) if name == "head" \
            else (params[name], stats[name])
        prefix, cell_type = _cell_prefix(name)
        _put_pre_post(sd, prefix, cell_type, p, s)
        for e in range(sum(2 + i for i in range(meta))):
            for key in p[f"edge_{e}"]:
                _, bi, op_name = key.split("_", 2)
                _put_op(sd, f"{prefix}_ops.{e}._ops.{bi}.", op_name, p[f"edge_{e}"][key],
                        s[f"edge_{e}"][key], transpose=cell_type == "up" and e in up_edges)
    return sd


def reference_search_checkpoint(variables, arch, meta, use_sharing):
    """A reference search-CLI checkpoint (experiments/search_arc.py:227-238)
    holding torch tensors: the NAS state_dict (`net.` + the supernet, the
    seven arch tables at the top; with sharing, the up-normal table is the
    down-normal one)."""
    import torch
    tables = dict(arch)
    if use_sharing:
        tables["alphas_up_nm"] = tables["alphas_dn_nm"]
    nas = {f"net.{k}": v for k, v in reference_search_state_dict(variables, meta).items()}
    nas.update(tables)
    as_torch = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    alphas = {k: v for k, v in tables.items() if k.startswith("alphas")}
    betas = {k: v for k, v in tables.items() if not k.startswith("alphas")}
    return {"epoch": 3, "dur_time": 55.0, "cur_patience": 2, "geno_type": "genotype-string",
            "model_state": as_torch(nas), "arch_optimizer": {}, "model_optimizer": {},
            "alphas_dict": as_torch(alphas), "betas_dict": as_torch(betas), "scheduler": {}}


def reference_train_checkpoint(variables, genotype):
    """A reference train-CLI checkpoint (experiments/train_model.py:220-233)."""
    import torch
    sd = reference_fixed_state_dict(variables, genotype)
    return {"epoch": 7, "dur_time": 123.0,
            "model_state": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
            "model_optimizer": {}, "best_pixAcc": 91.0, "best_mIoU": 72.5,
            "best_dice_coeff": 80.25, "best_loss": 0.31}


def epilogue_case(seed, n, se, none, train, B=2, H=8, W=4, E=3, P=8, mid=1):
    """Inputs of `fused_group_epilogue` for both packages, from one seed:
    (jax args, jax kwargs) NHWC and (torch args, torch kwargs) NCHW."""
    import jax.numpy as jnp
    import torch
    C = E * P
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(B, H, W, C) * (1.0 + i) + 0.3 * i).astype(np.float32)
          for i in range(n)]
    scales = [(1.0 + 0.1 * rng.randn(C)).astype(np.float32) for _ in range(n)]
    biases = [(0.1 * rng.randn(C)).astype(np.float32) for _ in range(n)]
    al_edge = rng.rand(n + 1, E).astype(np.float32)
    al_edge /= al_edge.sum(0, keepdims=True)
    alphas = [np.repeat(al_edge[o], P) for o in range(n)]
    kw = {"train": train}
    if not train:
        kw.update(run_means=[(0.3 * rng.randn(C)).astype(np.float32) for _ in range(n)],
                  run_vars=[rng.uniform(0.5, 2.0, C).astype(np.float32) for _ in range(n)])
    if se:
        kw.update(se_index=1,
                  se_w1=(0.3 * rng.randn(E, P, mid)).astype(np.float32),
                  se_w2=(0.3 * rng.randn(E, mid, P)).astype(np.float32), E=E, P=P)
    if none:
        kw.update(none_alpha_col=np.repeat(al_edge[n], P),
                  none_bias=(0.1 * rng.randn(C)).astype(np.float32))

    def conv(v, to):
        if isinstance(v, list):
            return [to(a) for a in v]
        return to(v) if isinstance(v, np.ndarray) else v

    jargs = ([jnp.asarray(x) for x in xs], conv(scales, jnp.asarray),
             conv(biases, jnp.asarray), conv(alphas, jnp.asarray))
    jkw = {k: conv(v, jnp.asarray) for k, v in kw.items()}
    targs = ([nchw(x) for x in xs], conv(scales, torch.from_numpy),
             conv(biases, torch.from_numpy), conv(alphas, torch.from_numpy))
    tkw = {k: conv(v, torch.from_numpy) for k, v in kw.items()}
    return jargs, jkw, targs, tkw


# ---------------------------------------------------------------------------
# Writers of the medical file formats the loaders read (test phantoms)
# ---------------------------------------------------------------------------

_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_IMPLICIT_LE = "1.2.840.10008.1.2"


def _dicom_element(group, elem, vr, value: bytes, explicit: bool) -> bytes:
    import struct
    if len(value) % 2:
        value += b"\x00" if vr in (b"UI", b"OB") else b" "
    head = struct.pack("<HH", group, elem)
    if not explicit:
        return head + struct.pack("<I", len(value)) + value
    if vr in (b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"):
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def write_dicom(path, pixels, slope=1.0, intercept=0.0, preamble=True, explicit=True,
                empty_first=False):
    """A single-frame uncompressed little-endian DICOM slice of 2-D int16 or
    uint16 `pixels` with RescaleSlope/Intercept. `preamble` writes the
    128-byte preamble, "DICM" and the file meta group (which names the
    transfer syntax); `explicit` picks explicit or implicit VR for the data
    set. The data set starts with SOP Class and SOP Instance UIDs, as real
    files do, or, with `empty_first`, with an empty SpecificCharacterSet."""
    import struct
    pixels = np.ascontiguousarray(pixels)
    el = lambda g, e, vr, v: _dicom_element(g, e, vr, v, explicit)
    first = (el(0x0008, 0x0005, b"CS", b"") if empty_first else
             el(0x0008, 0x0016, b"UI", b"1.2.840.10008.5.1.4.1.1.2")
             + el(0x0008, 0x0018, b"UI", b"1.2.3.4.5.6.7"))
    data = (first
            + el(0x0028, 0x0002, b"US", struct.pack("<H", 1))
            + el(0x0028, 0x0010, b"US", struct.pack("<H", pixels.shape[0]))
            + el(0x0028, 0x0011, b"US", struct.pack("<H", pixels.shape[1]))
            + el(0x0028, 0x0100, b"US", struct.pack("<H", 8 * pixels.itemsize))
            + el(0x0028, 0x0103, b"US", struct.pack("<H", int(pixels.dtype.kind == "i")))
            + el(0x0028, 0x1052, b"DS", repr(float(intercept)).encode())
            + el(0x0028, 0x1053, b"DS", repr(float(slope)).encode())
            + el(0x7FE0, 0x0010, b"OW", pixels.astype(pixels.dtype.newbyteorder("<")).tobytes()))
    out = b""
    if preamble:
        ts = (_EXPLICIT_LE if explicit else _IMPLICIT_LE).encode()
        meta = _dicom_element(0x0002, 0x0010, b"UI", ts, True)
        out = (b"\x00" * 128 + b"DICM"
               + _dicom_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)), True)
               + meta)
    with open(path, "wb") as f:
        f.write(out + data)


def write_nifti(path, vol, slope=0.0, inter=0.0):
    """A NIfTI-1 volume (.nii or .nii.gz) of `vol` [X, Y, Z] (uint8, int16
    or float32), in file (Fortran) order."""
    import gzip
    import struct
    codes = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16}
    vol = np.asarray(vol)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (vol.ndim,) + vol.shape + (1,) * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<hh", hdr, 70, codes[vol.dtype], 8 * vol.itemsize)
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<fff", hdr, 108, 352.0, slope, inter)
    hdr[344:348] = b"n+1\x00"
    body = bytes(hdr) + b"\x00" * 4 + vol.astype(vol.dtype.newbyteorder("<")).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(body)


# ---------------------------------------------------------------------------
# bf16: how far the port's bf16 results may lie from the JAX package's
# ---------------------------------------------------------------------------


def as_f64(a):
    """A torch tensor (any dtype, bf16 too) or an array -> float64 numpy."""
    import torch
    if isinstance(a, torch.Tensor):
        return a.detach().double().cpu().numpy()
    return np.asarray(np.asarray(a).astype(np.float32), np.float64)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over all elements (0 when both are 0)."""
    a, b = as_f64(a), as_f64(b)
    den = float(np.sqrt((b ** 2).sum()))
    num = float(np.sqrt(((a - b) ** 2).sum()))
    return num / den if den else num


def bf16_ulps(got, want):
    """(share of the elements that differ, the largest difference in units
    of the bf16 spacing at the larger of the two magnitudes)."""
    g, w = as_f64(got), as_f64(want)
    diff = np.abs(g - w)
    mag = np.maximum(np.abs(g), np.abs(w))
    spacing = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return float((diff > 0).mean()), float((diff / spacing).max(initial=0.0))


def assert_bf16_bits(got, want, share: float = 1e-3, what: str = ""):
    """The module-level bound: got equals want except on at most `share`
    of the elements, and there by at most one bf16 ulp."""
    frac, ulps = bf16_ulps(got, want)
    assert frac <= share and ulps <= 1.0, f"{what}: {frac:.3g} of the elements differ, " \
                                          f"by up to {ulps:.3g} bf16 ulps"
    return frac, ulps


def assert_bf16_network(port_bf16, jax_bf16, jax_f32, what: str = ""):
    """The network- and step-level bound: the two packages' bf16 results lie
    at most twice as far apart as the JAX package's bf16 result lies from
    its f32 one (bf16's own error), plus 1e-6 (relative L2 distances)."""
    gap, own = rel_l2(port_bf16, jax_bf16), rel_l2(jax_bf16, jax_f32)
    assert gap <= 2 * own + 1e-6, f"{what}: port-vs-JAX bf16 {gap:.3g}, JAX bf16-vs-f32 {own:.3g}"
    return gap, own


def assert_bf16_computed(bf16, f32, rtol, atol, what: str = ""):
    """The control: the bf16 result fails 100 times the f32 parity
    tolerance (rtol, atol of an assert_allclose) against the f32 result,
    which an f32 computation passes: bf16 really computed."""
    a, b = as_f64(bf16), as_f64(f32)
    excess = float((np.abs(a - b) - 100 * (atol + rtol * np.abs(b))).max())
    assert excess > 0, f"{what}: bf16 lies within 100x the f32 tolerance of f32"


def search_step_pair(w_cfg, a_cfg, *, beta_mode="reference", remat=False,
                     do_arch=(True, True), M=2, D=2, C=8, HW=16, B=2, seed=0):
    """The bilevel search step of both packages from the same numpy-made
    weights, arch tables and batches (tests/test_torch_search_step.py's
    setup): one step per entry of `do_arch`, with the weight and arch
    optimizer configs `w_cfg`, `a_cfg`, the beta grouping `beta_mode` and
    `remat` in both. Returns the JAX state and per-step metrics, the port's
    state and metrics, and the starting arch tables and variables."""
    import jax.numpy as jnp
    import torch

    from senas_tpu.search import supernet as jsn
    from senas_tpu.train.loss import build_loss as jbuild_loss
    from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
    from senas_tpu.train.trainer import SearchTrainState as JState
    from senas_tpu.train.trainer import make_search_step as jmake_step
    from senas_torch import convert
    from senas_torch.search import supernet as tsn
    from senas_torch.train.loss import build_loss as tbuild_loss
    from senas_torch.train.trainer import SearchTrainState, make_search_step

    rng = np.random.RandomState(seed)
    arch = {k: (0.5 * rng.randn(*v)).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}
    mk = lambda: {"image": rng.randn(B, HW, HW, 1).astype(np.float32),
                  "label": (rng.rand(B, HW, HW) > 0.6).astype(np.int32)}
    batches = [(mk(), mk()) for _ in do_arch]
    jm = jsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                         remat=remat)
    variables = random_variables(jm, rng, jnp.asarray(batches[0][0]["image"]),
                                 jsn.normalize_arch(arch, M, beta_mode), False)

    w_tx, a_tx = jbuild_optimizer(dict(w_cfg)), jbuild_optimizer(dict(a_cfg))
    jstep = jmake_step(jm.apply, lambda a: jsn.normalize_arch(a, M, beta_mode),
                       jbuild_loss("dice_ce"), w_tx, a_tx, grad_clip=5.0, donate=False)
    jstate = JState.create(variables, arch, w_tx, a_tx)
    jmetrics = []
    for (tb, vb), arch_step in zip(batches, do_arch):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in tb.items()},
                          {k: jnp.asarray(v) for k, v in vb.items()}, arch_step)
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})

    tm = convert.load_variables(
        tsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                        remat=remat, device="cpu"), variables)
    state = SearchTrainState.create(tm, convert.arch_to_torch(arch, "cpu"), w_cfg, a_cfg)
    tstep = make_search_step(lambda a: tsn.normalize_arch(a, M, beta_mode),
                             tbuild_loss("dice_ce"), grad_clip=5.0)
    tmetrics = [{k: v.numpy() for k, v in tstep(
        state, {k: torch.from_numpy(v) for k, v in tb.items()},
        {k: torch.from_numpy(v) for k, v in vb.items()}, arch_step).items()}
        for (tb, vb), arch_step in zip(batches, do_arch)]
    return dict(jstate=jstate, jm=jmetrics, state=state, tm=tmetrics, arch=arch,
                variables=variables)


def assert_search_steps_match(runs, M=2, D=2, beta_mode="reference",
                              step_rtol=1e-5, state_atol=1e-5):
    """tests/test_torch_search_step.py's limits on a `search_step_pair`: the
    per-step loss, arch loss, grad norm and accuracy within rtol 1e-5, the
    confusion counts equal, the weights, running stats and arch tables after
    the steps within atol 1e-5, and the derived genotype identical."""
    from senas_tpu.search import supernet as jsn
    from senas_torch import convert
    from senas_torch.search import supernet as tsn

    for i, (got, want) in enumerate(zip(runs["tm"], runs["jm"])):
        for k in ("loss", "arch_loss", "grad_norm", "acc"):
            np.testing.assert_allclose(got[k], want[k], rtol=step_rtol, err_msg=f"step {i} {k}")
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {i} {k}")
    want_arch = {k: np.asarray(v) for k, v in runs["jstate"].arch.items()}
    got_arch = convert.arch_to_numpy(runs["state"].arch)
    for k in want_arch:
        np.testing.assert_allclose(got_arch[k], want_arch[k], rtol=0, atol=state_atol,
                                   err_msg=k)
    got = convert.state_dict_to_variables(runs["state"].model)
    assert_trees_close(got["params"], runs["jstate"].params, rtol=0, atol=state_atol)
    assert_trees_close(got["batch_stats"], runs["jstate"].batch_stats, rtol=0,
                       atol=state_atol)
    assert repr(tsn.derive_genotype(runs["state"].arch, M, D, beta_mode=beta_mode)) == repr(
        jsn.derive_genotype(want_arch, M, D, beta_mode=beta_mode))
