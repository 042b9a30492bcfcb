"""The launchers on a ``(data 1, model 2)`` mesh for the RG-LRU and MoE archs, on the CPU.

``launch.train --mesh group`` and ``launch.serve --mesh group`` spawn their
ranks over gloo; recurrentgemma-9b's RG-LRU block and mixtral-8x22b's
experts run on each rank's channels and experts.  Each command must finish
and print its per-rank lines.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("recurrentgemma-9b", "mixtral-8x22b")


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=240, env=env,
                          cwd=tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_a_data_model_mesh(arch, tmp_path):
    out = _run(["repro_torch.launch.train", "--device", "cpu", "--arch", arch, "--mesh", "group", "--data", "1",
                "--model", "2", "--steps", "1", "--seq-len", "16", "--checkpoint-dir", str(tmp_path / "ckpt")],
               tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "final loss" in out.stdout and "rank 1:" in out.stdout and "LAN bytes" in out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_a_data_model_mesh(arch, tmp_path):
    out = _run(["repro_torch.launch.serve", "--device", "cpu", "--arch", arch, "--mesh", "group", "--data", "1",
                "--model", "2", "--batch", "2", "--prompt-len", "8", "--gen", "2"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "on 1 x 2 ranks" in out.stdout and "sample[0]:" in out.stdout
