"""The port's command line (`python -m repro_torch.launch.simulate`)
against the reference's (`python -m repro.launch.simulate`): the same
arguments write the same CSV on a plain run, a per-point sweep and a
two-worker farm, and a bad `--sweep` or `--workers` without
`--recover-dir` end with the reference's one-line error. The port runs
with `--device cpu` (its default is the CUDA device).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import simulate as t_cli

SRC = str(Path(t_cli.__file__).resolve().parents[2])
PLAIN = ["--model", "lv2", "--replicas", "16", "--t-end", "0.2",
         "--windows", "2"]
SWEEP = ["--model", "ecoli", "--replicas", "16", "--sweep",
         "transcribe=0.5,1.0", "--per-point", "--t-end", "20",
         "--windows", "2"]


def _cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=600)


def _reference(args, tmp_path):
    out = tmp_path / "reference.csv"
    proc = _cli("repro.launch.simulate", [*args, "--out", str(out)],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out.read_text()


@pytest.mark.parametrize("args", [PLAIN, SWEEP], ids=["plain", "sweep"])
def test_cli_writes_the_reference_csv(tmp_path, capsys, args):
    out = tmp_path / "port.csv"
    t_cli.main([*args, "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert printed.startswith("model=") and "windows=2" in printed
    if "--per-point" in args:
        assert "per-sweep-point final means:" in printed
    assert out.read_text() == _reference(args, tmp_path)


def test_cli_farm_writes_the_reference_csv(tmp_path):
    """--workers 2 --recover-dir: the port's farm, run as a module, writes
    the reference farm's CSV, which is the single-process run's at
    stat_blocks 2."""
    farm = ["--workers", "2", "--heartbeat-s", "1"]
    out = tmp_path / "port.csv"
    proc = _cli("repro_torch.launch.simulate",
                [*SWEEP, *farm, "--recover-dir", str(tmp_path / "port"),
                 "--device", "cpu", "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "farm: 2 workers, 0 worker restart(s)" in proc.stdout
    got = out.read_text()
    assert got == _reference(
        [*SWEEP, *farm, "--recover-dir", str(tmp_path / "ref")], tmp_path)
    single = tmp_path / "single.csv"
    t_cli.main([*SWEEP, "--devices", "1", "--stat-blocks", "2",
                "--device", "cpu", "--out", str(single)])
    assert got == single.read_text()


@pytest.mark.parametrize("args,message", [
    (["--sweep", "die"], "--sweep expects name=v1,v2,... got 'die'"),
    (["--workers", "2"], "--workers needs --recover-dir (the farm's "
                         "shared checkpoint directory)"),
], ids=["bad_sweep", "workers_without_recover_dir"])
def test_cli_errors_are_the_reference_one_liners(tmp_path, args, message):
    with pytest.raises(SystemExit) as e:
        t_cli.main([*PLAIN, *args, "--device", "cpu"])
    assert str(e.value) == message
    proc = _cli("repro.launch.simulate", [*PLAIN, *args], tmp_path)
    assert proc.returncode == 1
    assert proc.stderr.strip().splitlines()[-1] == message
