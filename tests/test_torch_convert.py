"""senas_torch.convert: flax -> port -> flax gives back the same tree, bit
for bit, for a small SenasSearch (fused cells, stacked inner edges,
transposed and depthwise-transposed kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_torch import convert
from senas_torch.search import supernet as tsn

from torch_port_util import flat, random_variables


@pytest.mark.parametrize("meta,depth,c", [(2, 3, 8), (3, 2, 4)])
def test_round_trip_is_exact(meta, depth, c):
    rng = np.random.RandomState(meta + depth)
    arch = {k: rng.randn(*v).astype(np.float32)
            for k, v in jsn.arch_param_count(meta, depth).items()}
    jm = jsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth, meta_node_num=meta)
    variables = random_variables(jm, rng, jnp.zeros((1, 16, 16, 1)),
                                 jsn.normalize_arch(arch, meta), False)
    tm = tsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth,
                         meta_node_num=meta, device="cpu")
    convert.load_variables(tm, variables)
    back = convert.state_dict_to_variables(tm)
    want, got = flat(variables), flat(back)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    # every port variable was written by the bridge (a stacked inner-edge
    # leaf of flax is n variables of the port)
    assert convert.variables_to_state_dict(tm, variables).keys() == tm.state_dict().keys()
    arch_back = convert.arch_to_numpy(convert.arch_to_torch(arch, "cpu"))
    assert all(np.array_equal(arch_back[k], arch[k]) for k in arch)


def test_unknown_leaf_is_an_error():
    tm = tsn.SenasSearch(in_channels=1, c=4, nclass=2, depth=2, meta_node_num=2,
                         device="cpu")
    variables = convert.state_dict_to_variables(tm)
    variables["params"]["stem0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        convert.load_variables(tm, variables)


def test_layouts_of_the_port_variables():
    """The bridge's per-leaf layouts: a transposed conv is flipped, a
    depthwise-transposed one with multiplier E is (C,E,k,k)."""
    tm = tsn.SenasSearch(in_channels=1, c=8, nclass=2, depth=2, meta_node_num=2,
                         device="cpu")
    group1 = tm.up_1_0.group1           # UP group: transposed branch convs
    assert group1.flax_layout["se_conv_3_kernel"] == "hwio_t"
    assert group1.flax_layout["dep_sep_conv_3_dkernel"] == "dw_t"
    assert tuple(group1.dep_sep_conv_3_dkernel.shape) == (8, 2, 3, 3)
    k = np.arange(3 * 3 * 8 * 2, dtype=np.float32).reshape(3, 3, 1, 16)
    t = convert._to_torch_layout(k, "dw_t", (8, 2, 3, 3))
    # torch (c, e, a, b) = flax (2-a, 2-b, 0, c*E + e)
    assert t[5, 1, 0, 2] == k[2, 0, 0, 5 * 2 + 1]
    assert np.array_equal(convert._to_flax_layout(t, "dw_t"), k)
    with torch.no_grad():
        assert tm.state_dict()["down_1.group0.se_conv_3_kernel"].shape == (4, 8, 3, 3)
