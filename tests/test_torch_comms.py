"""The port's collective-byte counter (``repro_torch.utils.comms``) against
the reference's HLO parser (``repro.utils.hlo``), on a fake process group
of 8 ranks (``repro_torch.launch.mesh.fake_world``) with a (4, 2) ("data",
"model") mesh.

The program of the reference's ``SAMPLE_HLO`` (``tests/test_infra.py``):
12 all-reduces of f32[8, 8] over groups of 2, one all-gather of f32[16, 4]
-> [64, 4] over groups of 4; run in PyTorch, counted, and held equal to
the parser's count of the HLO text, byte for byte. The other three ops
are held to the ring formulas. Exact: integer bytes. ~7 s.
"""
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import fake_world
from repro_torch.utils import comms


@pytest.fixture
def mesh():
    with fake_world(8):
        yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data",
                                                              "model"))
    assert not dist.is_initialized()


def test_sample_hlo_program_counts_as_the_parser(mesh):
    from repro.utils import hlo
    from test_infra import SAMPLE_HLO
    with comms.CollectiveCounter() as cc:
        x = torch.ones(8, 8)
        for _ in range(12):
            dist.all_reduce(x, group=mesh.get_group("model"))
        out = torch.empty(64, 4)
        dist.all_gather_into_tensor(out, torch.ones(16, 4),
                                    group=mesh.get_group("data"))
    want = hlo.collective_bytes(SAMPLE_HLO)
    got = cc.collective_bytes()
    assert got["per_op"] == want["per_op"] == {"all-reduce": 3072,
                                               "all-gather": 768}
    assert got["counts"] == want["counts"] == {"all-reduce": 12,
                                               "all-gather": 1}
    assert got["total"] == want["total"]
    top = cc.top_collectives(1)[0]
    assert (top["op"], top["bytes"], top["mult"], top["shape"]) == (
        "all-gather", 768, 1, "f32[64,4]")
    assert "test_torch_comms.py" in top["line"]


@pytest.mark.parametrize("op", ["reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_other_ops_follow_the_ring_formulas(mesh, op):
    data = mesh.get_group("data")                     # g = 4
    out = torch.empty(16, 4)                          # r = 256 bytes
    with comms.CollectiveCounter() as cc:
        if op == "reduce-scatter":
            dist.reduce_scatter_tensor(out, torch.ones(64, 4), group=data)
        elif op == "all-to-all":
            dist.all_to_all_single(out, torch.ones(16, 4), group=data)
        else:
            dist.send(out, dst=1)
    want = {"reduce-scatter": 256 * 3, "all-to-all": 256 * 3 // 4,
            "collective-permute": 256}[op]
    assert cc.collective_bytes() == {"total": want, "per_op": {op: want},
                                     "counts": {op: 1}}
    assert comms.wire_bytes(op, 256, 4) == want


def test_dtensor_redistribution_is_an_all_gather(mesh):
    d = DTensor.from_local(torch.ones(16, 4), mesh, [Shard(0), Replicate()],
                           run_check=False)
    with comms.CollectiveCounter() as cc:
        full = d.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    assert full.shape == (64, 4)
    assert cc.collective_bytes() == {"total": 768,
                                     "per_op": {"all-gather": 768},
                                     "counts": {"all-gather": 1}}


def test_fake_world_refuses_a_second_group_and_tears_down():
    with pytest.raises(ValueError):
        with fake_world(4):
            with pytest.raises(RuntimeError, match="already exists"):
                with fake_world(2):
                    pass
            assert dist.get_world_size() == 4
            raise ValueError("the body fails")
    assert not dist.is_initialized()
