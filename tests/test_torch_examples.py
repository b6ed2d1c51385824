"""The port's examples (`examples/torch_*.py`) against the reference's
scripts (`examples/*.py`) on the CPU, each at its own size: the
reference script runs through `runpy` in a temporary working directory
and its module-level `result` is read; the port's runs through its
`main(device="cpu")`, or as a script with `--device cpu`.

Record means are sums of integer populations, so they are held bit for
bit, as are the pools; var and ci90 to the ulp bounds of
test_torch_api.

The E. coli example's CSV (artifacts/ecoli_fig1.csv under the working
directory) has the reference's text in every t, n and mean cell. 17 of
its 400 var and ci90 cells print another last digit in `%.6g`, because
the float32 behind them differs by 1 or 2 ulp (JAX 0.9.0, torch 2.13,
CPU): row t=1 protein ci90 (2 ulp); t=16 protein var (2); mrna var at
t=18, 34, 41, 45, 70, 71, 77, 98 (1) and t=51, 97 (2); t=51 protein var
(1) and ci90 (2); t=88 protein var (1); t=99 protein var (2) and ci90
(1). Those cells are held at the tier instead.

The sweep's per-point var is a masked sum of one point's 32 squared
deviations, which torch and XLA add in different orders. Two orders of
a sum of n non-negative float32 terms each carry a relative error of at
most (n - 1) u (u = 2^-24), so they differ by at most 2 (n - 1) u, which
is 2 (n - 1) ulp at the top of a binade: GROUP_VAR_ULP. The empirical
12 ulp of test_torch_api does not hold here: window 9, point die=1.2,
prey differs by 14 ulp; every other per-point var is within 7 and every
per-point ci90 within 4.
"""
import csv
import runpy
from pathlib import Path

import pytest
import torch

from test_torch_api import CI90_ULP, VAR_ULP, assert_records_match, ulp

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "lotka_volterra_sweep", "ecoli_gene_regulation")
SWEEP_GROUP = 32  # replicas a sweep point
GROUP_VAR_ULP = 2 * (SWEEP_GROUP - 1)
TIER = {"var": VAR_ULP, "ci90": CI90_ULP}


def _reference(name, cwd, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    return runpy.run_path(str(EXAMPLES / f"{name}.py"))["result"]


def _port(name, cwd, monkeypatch, **kw):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    main = runpy.run_path(str(EXAMPLES / f"torch_{name}.py"))["main"]
    return main(**kw)


def _assert_same_run(jres, tres):
    assert tres.completed and tres.windows_run == jres.windows_run
    assert tres.obs_names == jres.obs_names
    assert tres.means().tobytes() == jres.means().tobytes()
    assert_records_match(jres.records, tres.records)
    assert (tres.final_state() == jres.final_state()).all()


def test_quickstart_script_matches_reference(tmp_path, monkeypatch, capsys):
    """`python examples/torch_quickstart.py --device cpu`."""
    jres = _reference("quickstart", tmp_path / "ref", monkeypatch)
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["torch_quickstart.py", "--device",
                                     "cpu"])
    tres = runpy.run_path(str(EXAMPLES / "torch_quickstart.py"),
                          run_name="__main__")["result"]
    _assert_same_run(jres, tres)
    assert tres.telemetry.dispatches == len(tres.records) == 20
    lines = capsys.readouterr().out.splitlines()
    assert len([ln for ln in lines if ln.startswith("t=")]) == 20
    assert "one device dispatch per window: 20 dispatches" in lines[-1]


def test_lotka_volterra_sweep_matches_reference(tmp_path, monkeypatch):
    jres = _reference("lotka_volterra_sweep", tmp_path / "ref", monkeypatch)
    tres = _port("lotka_volterra_sweep", tmp_path / "port", monkeypatch,
                 device="cpu")
    _assert_same_run(jres, tres)
    jp, tp = jres.per_point(), tres.per_point()
    assert tp["points"] == jp["points"] and tp["mean"].shape == (10, 4, 2)
    assert tp["mean"].tobytes() == jp["mean"].tobytes()
    assert (tp["n"] == jp["n"]).all() and (tp["n"] == SWEEP_GROUP).all()
    assert ulp(tp["var"], jp["var"]) <= GROUP_VAR_ULP
    assert ulp(tp["ci90"], jp["ci90"]) <= CI90_ULP


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_ecoli_example_writes_the_reference_csv(tmp_path, monkeypatch):
    jres = _reference("ecoli_gene_regulation", tmp_path / "ref",
                      monkeypatch)
    tres = _port("ecoli_gene_regulation", tmp_path / "port", monkeypatch,
                 device="cpu")
    _assert_same_run(jres, tres)
    out = "artifacts/ecoli_fig1.csv"
    got, want = _csv(tmp_path / "port" / out), _csv(tmp_path / "ref" / out)
    assert got[0] == want[0] and len(got) == len(want) == 101
    for grow, wrow, trec, jrec in zip(got[1:], want[1:], tres.records,
                                      jres.records):
        for col, g, w in zip(got[0], grow, wrow):
            if g == w:
                continue
            obs, field = col.rsplit("_", 1)
            assert field in TIER, (col, g, w)
            k = tres.obs_names.index(obs)
            t_val, j_val = getattr(trec, field)[k], getattr(jrec, field)[k]
            assert g == f"{t_val:.6g}" and w == f"{j_val:.6g}"
            assert ulp(t_val, j_val) <= TIER[field]


@pytest.mark.parametrize("name", NAMES)
def test_example_without_gpu_raises(tmp_path, monkeypatch, name):
    """No device argument and no GPU: the example refuses, it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(name, tmp_path / "port", monkeypatch)
