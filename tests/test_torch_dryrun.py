"""repro_torch.launch.dryrun: the collective records, the three step
kinds on a small fake mesh, one cell on the production mesh, and the
cell skip logic (the cases of ``tests/test_dryrun_unit.py``).

Everything runs in this process on the fake process group (512 ranks,
this process rank 0) and on meta tensors: nothing is drawn or moved.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402


@pytest.fixture(scope="module")
def fake_pg():
    D.init_fake_process_group(D.FAKE_WORLD)
    yield
    dist.destroy_process_group()


def test_collective_bytes_of_dispatched_ops(fake_pg):
    """The reference parser's case, as dispatched collectives: an
    all-gather of a bf16 (4, 128) shard, an all-reduce and a
    reduce-scatter of f32 (256,), and a permute of u32 (8,); counts,
    operand bytes, ring wire bytes and totals in the reference's
    schema.  A functional collective and a c10d one are both seen."""
    import torch.distributed._functional_collectives as funcol

    mesh = LM.make_debug_mesh(4, 2, device_type="cpu")
    group = mesh.get_group("data")  # 4 ranks
    rec = D.CollectiveRecorder(D.mesh_group_axes(mesh))
    with rec:
        for out in (
                funcol.all_gather_tensor(
                    torch.ones(4, 128, dtype=torch.bfloat16), 0, group),
                funcol.all_reduce(torch.ones(256), "sum", group),
                funcol.reduce_scatter_tensor(torch.ones(256), "sum", 0,
                                             group)):
            funcol.wait_tensor(out)
        dist.all_reduce(torch.ones(3), group=mesh.get_group("model"))
    recs = rec.records
    assert [(r.kind, r.axis, r.group_size) for r in recs] == [
        ("all-gather", "data", 4), ("all-reduce", "data", 4),
        ("reduce-scatter", "data", 4), ("all-reduce", "model", 2)]
    out = D.collective_bytes(
        recs[:3] + [D.CollectiveRecord("collective-permute", 8 * 4, 2,
                                       "model")])
    assert set(out) == {"all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all", "collective-permute", "total_bytes",
                        "total_wire_bytes"}
    assert out["all-gather"]["count"] == 1
    assert out["all-gather"]["bytes"] == 4 * 128 * 2
    assert out["all-reduce"]["bytes"] == 256 * 4
    assert out["reduce-scatter"]["bytes"] == 256 * 4
    assert out["collective-permute"]["bytes"] == 8 * 4
    assert out["all-to-all"] == {"count": 0, "bytes": 0, "wire_bytes": 0.0}
    assert out["total_bytes"] == (4 * 128 * 2 + 256 * 4 + 256 * 4 + 8 * 4)
    # ring wire bytes: (gs - 1) x for a gather, 2 (gs - 1) / gs for an
    # all-reduce, (gs - 1) / gs for a reduce-scatter, 1 x for a permute
    assert out["all-gather"]["wire_bytes"] == 4 * 128 * 2 * 3
    assert out["all-reduce"]["wire_bytes"] == 256 * 4 * 1.5
    assert out["reduce-scatter"]["wire_bytes"] == 256 * 4 * 0.75
    assert out["collective-permute"]["wire_bytes"] == 8 * 4
    assert D._wire_factor("all-reduce", 1) == 0.0
    assert D.collectives_by_axis(recs) == {
        "data": {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1},
        "model": {"all-reduce": 1}}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_small_mesh_lowering(kind, fake_pg, tmp_path):
    """All three step kinds for a reduced config on a 1x1 fake mesh, on
    meta tensors: the exact dry-run code path without 512 ranks."""
    cfg = C.get_smoke_config("recurrentgemma-2b")
    shape = ShapeConfig("smoke", kind, 64, 2)
    mesh = LM.make_debug_mesh(1, 1, device_type="cpu")
    rec = D.run_cell("recurrentgemma-2b", shape, False, str(tmp_path),
                     mesh=mesh, cfg=cfg)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["cost"]["flops"] > 0
    # a one-rank mesh replicates everything: no collective at all
    assert rec["collectives"]["total_bytes"] == 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    saved = json.loads((tmp_path / "recurrentgemma-2b__smoke__1_1.json")
                       .read_text())
    assert saved["status"] == "ok" and saved["mesh"] == "1x1"


def test_smoke_cell_on_the_production_mesh(fake_pg, tmp_path):
    """One train cell of a smoke config on the (16, 16) fake mesh, under
    the hints: status ok, the reference's schema, a reduce-scatter over
    "data" (the gradients onto the FSDP shards) and the Muon Grams'
    all-reduces over "data"."""
    mesh = LM.make_production_mesh(device_type="cpu")
    cfg = C.get_smoke_config("qwen3-8b")
    rec = D.run_cell("qwen3-8b", SHAPES["train_4k"], False, str(tmp_path),
                     optimized=True, mesh=mesh, cfg=cfg)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    by_axis = rec["collectives_by_axis"]
    assert by_axis["data"]["reduce-scatter"] > 0
    assert by_axis["data"]["all-reduce"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(
        coll[k]["bytes"] for k in D._COLLECTIVES)
    assert (tmp_path / "qwen3-8b__train_4k__16_16__opt.json").exists()


def test_cell_skip_logic(tmp_path):
    assert C.registry.cell_supported(
        C.get_config("yi-34b"), SHAPES["long_500k"]) is not None
    assert C.registry.cell_supported(
        C.get_config("mamba2-130m"), SHAPES["long_500k"]) is None
    assert C.registry.cell_supported(
        C.get_config("h2o-danube-3-4b"), SHAPES["long_500k"]) is None
    rec = D.run_cell("yi-34b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "skip" and "sub-quadratic" in rec["skip"]
