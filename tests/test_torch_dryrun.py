"""``repro_torch.launch.dryrun``: one SMOKE cell of each family traced on
``meta`` gives the count of the same cell on real CPU tensors, FLOPs and
bytes, and allocates no storage; the CLI writes the reference's keys,
skips ``long_500k`` for a quadratic arch with the reference's reason and
reports a cell it cannot trace as ``FAILED``; ``launch.mesh`` builds the
port's meshes and refuses production ones with a pointer to the dry
run."""
import json

import pytest

from repro_torch.analysis import ProgramTrace
from repro_torch.configs import ShapeSpec
from repro_torch.dist import LocalMesh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh

TRAIN = ShapeSpec("t", 16, 2, "train")
PREFILL = ShapeSpec("p", 16, 2, "prefill")
DECODE = ShapeSpec("d", 16, 2, "decode")

# one cell of each family: (arch, shape, variant)
CELLS = [("qwen2-0.5b", TRAIN, "base"),                  # dense
         ("granite-moe-3b-a800m", PREFILL, "base"),      # moe
         ("pixtral-12b", DECODE, "opt"),                 # vlm, packed
         ("recurrentgemma-2b", DECODE, "base"),          # hybrid
         ("rwkv6-1.6b", TRAIN, "base"),                  # ssm
         ("whisper-large-v3", PREFILL, "base")]          # audio


class _Devices(ProgramTrace):
    """A count that also notes the operations whose outputs hold data (a
    device other than ``meta``, more than one element)."""

    def __init__(self):
        super().__init__()
        self.with_data = set()

    def _count(self, func, args, kwargs, out):
        from repro_torch.kernels._work import tensors
        for t in tensors(out):
            if t.numel() > 1 and t.device.type != "meta":
                self.with_data.add(func._overloadpacket.__name__)
        super()._count(func, args, kwargs, out)


@pytest.mark.parametrize("arch,shape,variant", CELLS,
                         ids=[c[0] for c in CELLS])
def test_meta_count_equals_the_cpu_count(arch, shape, variant):
    counts = {}
    for dev in ("meta", "cpu"):
        run, facts = dryrun.cell_program(arch, shape, variant, dev,
                                         smoke=True)
        with _Devices() as tr:
            run()
        counts[dev] = (tr.flops, tr.bytes, dict(tr.kernel_ops))
        if dev == "meta":
            # no storage: every tensor the program made is a meta tensor,
            # but the [B] slot positions the caller hands over from numpy
            assert tr.with_data <= {"lift_fresh"}, tr.with_data
            assert facts["memory"]["params_bytes"] > 0
    assert counts["meta"] == counts["cpu"]
    assert counts["meta"][0] > 0


def test_build_cell_record_and_the_cli(tmp_path):
    rec = dryrun.build_cell("qwen2-0.5b", DECODE, variant="opt", chips=8,
                            smoke=True)
    for key in ("status", "kind", "flops_per_chip", "hbm_bytes_per_chip",
                "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "hbm_model_breakdown", "analytic_flops_total",
                "model_flops_total", "useful_flops_ratio",
                "roofline_fraction", "plan_widths", "trace_s",
                "memory_analysis", "partition"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["t_collective_s"] is None and rec["collective_note"]
    assert rec["flops_per_chip"] == rec["flops_total"] / 8
    assert rec["kernel_ops"]["qmatmul"] > 0
    assert rec["memory_analysis"]["cache_bytes"] > 0
    skipped = dryrun.build_cell("qwen2-0.5b", "long_500k")
    assert skipped["status"] == "skipped" and "524288" in skipped["reason"]
    out = tmp_path / "out"
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k", "--out",
                 str(out)])
    (f,) = out.glob("*.json")
    assert json.loads(f.read_text())["status"] == "skipped"


def test_a_cell_that_cannot_be_traced_is_reported_failed(tmp_path,
                                                          monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("a value read on the host")

    monkeypatch.setattr(dryrun, "build_cell", boom)
    res = dryrun.run_cells(["qwen2-0.5b"], ["decode_32k"], str(tmp_path))
    (rec,) = res.values()
    assert rec["status"] == "FAILED" and "host" in rec["error"]
    assert json.loads(next(tmp_path.glob("*.json")).read_text())[
        "status"] == "FAILED"


def test_launch_mesh():
    assert lmesh.make_host_mesh(1, 1, device="cpu") is None
    m = lmesh.make_host_mesh(2, 4, device="cpu")
    assert isinstance(m, LocalMesh) and m.axis_sizes == (2, 4)
    assert lmesh.data_axes(m) == ("data",) and lmesh.data_axes(None) == ()
    with pytest.raises(NotImplementedError, match="--chips"):
        lmesh.make_production_mesh()
    with pytest.raises(NotImplementedError, match="--chips"):
        lmesh.make_production_mesh(multi_pod=True)
