"""The mesh layer of the port's data parallelism (senas_torch/parallel/
mesh.py, senas_torch/runner/common.py's mesh wiring) without a second
process: the spec and its checks, the rows each rank keeps, the global
batch check, the batch placer's replicated case, the step wrapper, and
`initialize_distributed`'s environment (templates: tests/test_mesh.py
test_batch_shardings, test_assemble_global_batch_single_process,
test_initialize_distributed_noop_single_process). Two real ranks run in
tests/test_torch_collectives.py and test_torch_mesh_steps.py."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from senas_torch.models import factory
from senas_torch.parallel import collectives
from senas_torch.parallel import mesh as M
from senas_torch.runner import common

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


def _mesh(rank, data=2):
    """A mesh as rank `rank` of `data` ranks sees it (no group is joined)."""
    return M.Mesh(spec=M.MeshSpec(data=data), rank=rank, device=torch.device("cpu"),
                  group=object())


def test_mesh_spec_and_one_process_mesh():
    spec = M.MeshSpec(data=4, spatial=2)
    assert spec.axis_names == ("data", "spatial")
    mesh = M.make_mesh()
    assert not dist.is_initialized()
    assert (mesh.spec, mesh.rank, mesh.group, mesh.world_size) == (M.MeshSpec(1), 0, None, 1)
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not match 1 ranks"):
        M.make_mesh(spec=M.MeshSpec(data=2))
    assert M.backend_for("cpu") == "gloo" and M.backend_for(torch.device("cuda", 1)) == "nccl"


def test_shard_batch_keeps_each_ranks_rows():
    batch = {"image": np.arange(8 * 3 * 3).reshape(8, 3, 3, 1),
             "label": np.arange(8 * 3 * 3).reshape(8, 3, 3)}
    for rank in range(4):
        got = M.shard_batch(_mesh(rank, 4), batch)
        for k, v in batch.items():
            np.testing.assert_array_equal(got[k], v[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="do not split"):
        M.shard_batch(_mesh(0, 3), batch)
    # assembly from per-process loading: the local rows as given, the
    # global shapes beside them
    local, shapes = M.assemble_global_batch(_mesh(1, 4), M.shard_batch(_mesh(1, 4), batch))
    np.testing.assert_array_equal(local["image"], batch["image"][2:4])
    assert shapes == {"image": (8, 3, 3, 1), "label": (8, 3, 3)}


def test_check_global_batch():
    common.check_global_batch(None, 7)
    common.check_global_batch(_mesh(0, 2), 8)
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        common.check_global_batch(_mesh(0, 4), 6, "training.batch_size")


def test_batch_placer_rows_and_the_replicated_trailing_batch():
    batch = {"image": np.random.RandomState(0).randn(6, 4, 4, 1).astype(np.float32),
             "label": np.zeros((6, 4, 4), np.int32)}
    place = common.make_batch_placer(torch.device("cpu"), _mesh(1, 2))
    got = place(batch)
    assert M.REPLICATED not in got
    np.testing.assert_array_equal(got["image"].numpy(), batch["image"][3:])
    whole = place({k: v[:5] for k, v in batch.items()})
    assert whole[M.REPLICATED] and whole["image"].shape[0] == 5
    # the step wrapper runs a replicated batch as a single-device step and
    # a sharded one with the mesh active
    seen = []
    step = M.shard_train_step(lambda b: seen.append(collectives.active_mesh()), _mesh(1, 2))
    step(got)
    step(whole)
    assert seen[0] is not None and seen[0].rank == 1 and seen[1] is None
    assert collectives.active_mesh() is None
    assert M.shard_train_step(len, None) is len
    plain = common.make_batch_placer(torch.device("cpu"))(batch)
    assert sorted(plain) == ["image", "label"] and plain["image"].shape[0] == 6


def test_spatial_axis_over_two_ranks_raises(monkeypatch):
    """Every model the factory builds runs under mesh_spatial > 1 over two
    or more ranks (the zoo on any encoder since M13d): the SENAS models and
    the nine baseline models go on to the one-process-per-device check; a
    name the factory does not build raises the factory's own KeyError
    there, before a group is used, as `factory.check_model_name` (which
    the CLIs ask before they spawn ranks) raises it."""
    with pytest.raises(KeyError) as built:
        factory.get_segmentation_model("resunet", "synthetic", device="cpu")
    with pytest.raises(KeyError) as checked:
        factory.check_model_name("resunet")
    assert str(checked.value) == str(built.value) == "\"unknown model 'resunet'\""
    for name in ("senas", None, "UNet") + factory.ZOO:
        factory.check_model_name(name)
    monkeypatch.setattr(common, "visible_devices", lambda device: 2)
    section = {"multi_gpus": True, "mesh_spatial": 2}
    with pytest.raises(KeyError, match="unknown model 'resunet'"):
        common.setup_mesh(section, torch.device("cpu"), "resunet")
    for name in ("unet", "senas", None):
        with pytest.raises(RuntimeError, match="one process per device"):
            common.setup_mesh(section, torch.device("cpu"), name)
    # one visible device runs single-device, whatever the name
    monkeypatch.setattr(common, "visible_devices", lambda device: 1)
    assert common.setup_mesh(section, torch.device("cpu"), "resunet")[0] is None


@pytest.mark.parametrize("spatial", [0, 3])
def test_mesh_spatial_must_divide(monkeypatch, spatial):
    monkeypatch.setattr(common, "visible_devices", lambda device: 2)
    with pytest.raises(ValueError, match="does not divide 2 devices"):
        common.setup_mesh({"multi_gpus": True, "mesh_spatial": spatial}, torch.device("cpu"))


def test_two_devices_without_a_group_raise(monkeypatch):
    """One process does not drive two devices: the CLIs spawn one a device."""
    monkeypatch.setattr(common, "visible_devices", lambda device: 2)
    with pytest.raises(RuntimeError, match="one process per device"):
        common.setup_mesh({"multi_gpus": True}, torch.device("cpu"))
    assert common.setup_mesh({"multi_gpus": False}, torch.device("cpu")) == (None, None)


def test_initialize_distributed_noop_and_env(monkeypatch):
    """No coordinator env => no-op (must not touch torch.distributed); with
    it, the coordinates reach init_process_group, with a timeout."""
    for var in ("SENAS_COORDINATOR", "SENAS_NUM_PROCESSES", "SENAS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    called = {}
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: called.update(
        backend=backend, **kw))
    assert M.initialize_distributed(device="cpu") is False
    assert called == {}
    monkeypatch.setenv("SENAS_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("SENAS_NUM_PROCESSES", "4")
    monkeypatch.setenv("SENAS_PROCESS_ID", "2")
    assert M.initialize_distributed(device="cpu") is True
    assert called == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 4, "rank": 2, "timeout": M.INIT_TIMEOUT}
    # explicit arguments come first
    called.clear()
    M.initialize_distributed("127.0.0.1:99", 2, 1, device="cpu")
    assert (called["init_method"], called["world_size"], called["rank"]) == (
        "tcp://127.0.0.1:99", 2, 1)
    monkeypatch.delenv("SENAS_PROCESS_ID")
    with pytest.raises(ValueError, match="SENAS_PROCESS_ID"):
        M.initialize_distributed(device="cpu")


def test_cli_spawns_only_for_two_or_more_cards(monkeypatch):
    from senas_torch.parallel import launch
    for var in launch.ENV_KEYS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    on = {"multi_gpus": True}
    assert launch.ranks_to_spawn(on, "cuda") == 4
    assert launch.ranks_to_spawn(on, "cpu") == 0
    assert launch.ranks_to_spawn({"multi_gpus": False}, "cuda") == 0
    monkeypatch.setenv("SENAS_PROCESS_ID", "0")
    assert launch.ranks_to_spawn(on, "cuda") == 0
    monkeypatch.delenv("SENAS_PROCESS_ID")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.ranks_to_spawn(on, "cuda") == 0


@pytest.mark.parametrize("cli", ["search_arc", "train_model", "testing_model"])
def test_each_cli_spawns_its_ranks(monkeypatch, cli):
    """With ranks to spawn, a CLI hands its own argv to `launch` under its
    own module name, starts nothing in this process, and returns the
    launch's exit code (a failed rank's)."""
    import importlib
    mod = importlib.import_module(f"senas_torch.{cli}")
    calls = []
    monkeypatch.setattr(mod, "ranks_to_spawn", lambda section, device: 2)
    monkeypatch.setattr(mod, "launch", lambda module, argv, n: calls.append(
        (module, list(argv), n)) or 3)
    argv = ["--config", common.DEFAULT_CONFIG.replace("promise12", "synthetic")]
    assert mod.main(argv) == 3
    assert calls == [(f"senas_torch.{cli}", argv, 2)]
