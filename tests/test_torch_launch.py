"""The port's LM training launcher, ``python -m repro_torch.launch.train``
(counterpart of ``repro/launch/train.py``), on the CPU at SMOKE size
(``--device cpu``; without it the launcher runs on the card, and raises
where there is none).

It prints the reference launcher's lines (the step lines, ``resumed
from step N``, ``done: ...``); a second call on a checkpoint directory
resumes from the last checkpoint to the first call's params, qstate and
AdamW state bit for bit;
``--mesh 4x1 --grad-compression int8-wire`` runs the 1D compressed wire
over ``dist.LocalMesh(4)``, and a checkpoint made on another mesh
restarts the error-feedback residual at zero with the reference's
warning instead of failing.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.dist import LocalMesh
from repro_torch.launch.train import main
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
HOST_1X1 = str(ROOT / "examples" / "specs" / "host_1x1.json")
# the reference launcher's f-strings (src/repro/launch/train.py)
STEP_LINE = re.compile(r"^step \d+: loss=\d+\.\d{4} ebops=\S+$")
DONE_LINE = re.compile(r"^done: \d+ steps in \d+\.\ds$")


def _run(capsys, *argv, batch=2, seq=16):
    setup = main(["--spec", HOST_1X1, "--device", "cpu", "--batch",
                  str(batch), "--seq", str(seq), *argv])
    return setup, capsys.readouterr().out.splitlines()


def _state(setup):
    return tree_leaves((setup.params, setup.qstate, setup.opt))


def test_launcher_prints_the_references_lines(capsys):
    setup, lines = _run(capsys, "--steps", "2")
    assert len(lines) == 3, lines
    assert all(STEP_LINE.match(l) for l in lines[:2]), lines
    assert lines[0].startswith("step 0:") and lines[1].startswith("step 1:")
    assert DONE_LINE.match(lines[2]) and lines[2].startswith("done: 2 steps")
    assert setup.ctx.mesh is None and setup.ef_state is None
    assert setup.ctx.device == torch.device("cpu")


def test_resume_is_bit_identical(capsys, tmp_path):
    """4 steps with a checkpoint every 2 (after step 2, labelled 3: the
    next step to run); a second call on the same directory resumes there
    and its step 3 gives the first call's final state bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    full, _ = _run(capsys, "--steps", "4", "--ckpt-dir", ckpt,
                   "--ckpt-every", "2")
    resumed, lines = _run(capsys, "--steps", "4", "--ckpt-dir", ckpt,
                          "--ckpt-every", "2")
    assert lines[0] == "resumed from step 3", lines
    assert resumed.start_step == 3
    assert lines[1].startswith("step 3:") and \
        lines[-1].startswith("done: 1 steps")
    a, b = _state(full), _state(resumed)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_wire_on_a_local_mesh_and_a_checkpoint_from_another_mesh(
        capsys, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    two, lines = _run(capsys, "--mesh", "2x1", "--grad-compression",
                      "int8-wire", "--steps", "2", "--ckpt-dir", ckpt,
                      "--ckpt-every", "1", batch=4)
    assert isinstance(two.ctx.mesh, LocalMesh) and two.ctx.mesh.size == 2
    assert DONE_LINE.match(lines[-1])
    four, lines = _run(capsys, "--mesh", "4x1", "--grad-compression",
                       "int8-wire", "--steps", "3", "--ckpt-dir", ckpt,
                       "--ckpt-every", "1", batch=4)
    comp = four.ctx.grad_compression()
    assert (comp.wire, comp.wire_layout, comp.reduce) == \
        (True, "1d", "compressed")
    assert four.ctx.mesh.size == 4
    assert lines[0] == ("warning: checkpointed EF residual does not match "
                        "the current mesh/compression kind; restarting it "
                        "at zero"), lines
    assert lines[1] == "resumed from step 2"
    assert STEP_LINE.match(lines[2]) and lines[2].startswith("step 2:")
    assert DONE_LINE.match(lines[-1])
    # the 1D wire residual: one shard a rank, updated by the step
    res = tree_leaves(four.ef_state.residual)
    assert all(r.shape[0] == 4 for r in res)
    assert any(bool(r.abs().max() > 0) for r in res)


def test_launcher_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--spec", HOST_1X1, "--steps", "1"])


def test_launcher_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--spec",
         HOST_1X1, "--steps", "1", "--batch", "1", "--seq", "8",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert STEP_LINE.match(lines[0]) and DONE_LINE.match(lines[-1])
