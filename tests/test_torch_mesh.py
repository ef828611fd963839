"""Meshes and sharding over ``torch.distributed`` (``mrisr_torch/parallel``) on the CPU, with gloo.

``dryrun_multichip(4, device="cpu")`` runs the reference dry run's five legs on four rank processes (spawned, torch on one
thread each), each held inside the run to its single-device result: a data-parallel ResDiff step on each
rank's rows with its rows of the whole batch's draws equals one step on the whole batch (loss 1e-5,
parameters atol 2e-5); a dp x tp SDUNet value-and-grad on a 2 x 2 mesh, output channels split over
"model", equals the unsharded one (atol 2e-5) with layers actually split; the sampler and both volume
pipelines sharded over "data" equal their single-device results within 1e-4.  The tests read its results.
The helpers are checked in this process on a world of one.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch import nn

from mrisr_torch.parallel import dryrun, mesh
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

WORLD = 4


@pytest.fixture(scope="module")
def legs():
    return dryrun.dryrun_multichip(WORLD, device="cpu")


def test_dryrun_dp_step_equals_whole_batch(legs):
    assert legs["world"] == WORLD and legs["backend"] == "gloo"
    dp = legs["dp_step"]
    assert dp["loss_err"] <= dryrun.LOSS_TOL and dp["param_err"] <= dryrun.PARAM_TOL and dp["loss"] > 0


def test_dryrun_dp_tp_value_and_grad_equals_unsharded(legs):
    tp = legs["dp_tp"]
    assert tp["mesh"] == [WORLD // 2, 2] and tp["split_layers"] > 0
    assert tp["loss_err"] <= dryrun.LOSS_TOL and tp["grad_err"] <= dryrun.GRAD_TOL


@pytest.mark.parametrize("leg", ["sampler", "volume", "latent_volume"])
def test_dryrun_sharded_serving_equals_single_device(legs, leg):
    assert legs[leg]["max_abs_diff"] <= dryrun.OUT_TOL
    if leg == "latent_volume":
        assert legs[leg]["fused_towers"] is True


def test_dryrun_defaults_to_the_card_and_needs_a_gpu_a_rank(monkeypatch):
    """The entry point runs on the card unless asked for the CPU: with fewer GPUs than ranks it raises before
    it starts a process, as does a device it does not know."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="4 ranks need 4 GPUs"):
        dryrun.main(["--n", "4"])
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun.dryrun_multichip(1, device="tpu")


def test_mesh_helpers_on_one_rank(tmp_path):
    """A world of one: batch rows, sharding of nested batches, the broadcast, the gradient average (the
    identity), and the tensor-parallel rule's thresholds."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        m = mesh.make_mesh()
        sh = mesh.batch_sharding(m, 4)
        assert sh.rows(6) == slice(0, 6)
        batch = {"a": torch.arange(6), "b": [torch.ones(6, 2)]}
        out = mesh.shard_batch(m, batch)
        assert torch.equal(out["a"], batch["a"]) and out["b"][0].shape == (6, 2)
        assert torch.equal(sh.gather(torch.arange(3)), torch.arange(3))
        lin = nn.Linear(3, 2)
        before = lin.weight.detach().clone()
        assert mesh.replicate_params(m, lin) is lin and torch.equal(lin.weight, before)
        grads = {"w": torch.randn(2, 3), "b": torch.randn(2)}
        loss, avg = mesh.average_gradients(m, torch.tensor(1.5), grads)
        assert float(loss) == 1.5 and all(torch.equal(avg[k], g) for k, g in grads.items())
        m2 = mesh.make_mesh_2d(1, 1)
        rule = mesh.tp_param_sharding(m2, min_channels=64)
        assert rule(torch.zeros(64, 3, 3, 3)) and not rule(torch.zeros(32, 3)) and not rule(torch.zeros(128))
        with pytest.raises(ValueError, match="whole process group"):
            mesh.make_mesh(2)
    finally:
        dist.destroy_process_group()
