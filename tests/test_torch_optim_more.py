"""A bilevel search step with the other optimizers: `model_optimizer:
rmsprop` over the weights (and, as the runner builds it, the arch tables)
and `arch_optimizer: adabound` over the tables, in the port and in
senas_tpu from the same numpy-made state (tests/torch_port_util.py
`search_step_pair`: meta_node_num 2, depth 2, c 8, 16x16, batch 2, two
do_arch steps), held at tests/test_torch_search_step.py's limits: metrics
rtol 1e-5, weights, running stats and arch tables atol 1e-5, the same
genotype."""

import pytest

from torch_port_util import assert_search_steps_match, search_step_pair
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

W_CFG = {"name": "rmsprop", "lr": 1e-3, "momentum": 0.5, "weight_decay": 3e-4}
A_CFG = {"name": "adabound", "lr": 3e-4, "betas": (0.5, 0.999), "weight_decay": 1e-3}


@pytest.fixture(scope="module")
def runs():
    return search_step_pair(W_CFG, A_CFG)


def test_rmsprop_and_adabound_search_steps_match(runs):
    assert_search_steps_match(runs)


def test_the_steps_ran_the_other_optimizers(runs):
    from senas_torch.train.optim import AdaBound, RMSprop
    state = runs["state"]
    assert isinstance(state.w_opt, RMSprop) and isinstance(state.a_opt, AdaBound)
    assert state.step == 2 and all(s["count"] == 2 for s in state.a_opt.state.values())
