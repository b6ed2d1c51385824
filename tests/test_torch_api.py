"""Port parity end to end: `repro_torch.api.simulate` against
`repro.api.simulate` on the CPU, through both the fused-kernel path
(`use_kernel=True`, whose CPU form is the kernel's plain twin) and the
unfused group loop.

Record means are exact sums of integer populations, so they are held
bit for bit; var and ci90 to the ulp bound of test_torch_reduction.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core.cwc import rules as j_rules, terms as j_terms
from repro.core.cwc.models import MODELS as J_MODELS
from repro.kernels.ops import FusedWindowTruncated as JTruncated
from repro_torch.core.cwc import rules as t_rules, terms as t_terms
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.kernels.ops import FusedWindowTruncated as TTruncated

ROOT = Path(__file__).resolve().parents[1]
VAR_ULP = 12
CI90_ULP = 8


def quickstart_model(rules, terms):
    """examples/quickstart.py's model, built from either package."""
    Rule, TOP = rules.Rule, terms.TOP
    return rules.CWCModel(
        rules=(Rule.make(TOP, {"a": 1, "b": 1}, {"c": 1}, k=0.001,
                         name="combine"),
               Rule.make(TOP, {"c": 1}, {"a": 1, "b": 1}, k=0.05,
                         name="split")),
        init_fn=lambda: terms.term({"a": 300, "b": 300}),
        observables=((TOP, "a"), (TOP, "b"), (TOP, "c")),
        name="quickstart")


def quickstart(api, model, **kw):
    return api.Experiment(
        model=model, ensemble=api.Ensemble.make(replicas=64),
        schedule=api.Schedule(t_end=50.0, n_windows=20,
                              schema=api.Schema.ONLINE),
        n_lanes=64, seed=0, **kw)


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def assert_records_match(jrecs, trecs):
    assert len(jrecs) == len(trecs)
    for a, b in zip(jrecs, trecs):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n)
        assert a.mean.tobytes() == b.mean.tobytes()
        assert ulp(a.var, b.var) <= VAR_ULP
        assert ulp(a.ci90, b.ci90) <= CI90_ULP


@pytest.fixture(scope="module")
def quickstart_ref():
    return J.simulate(quickstart(J, quickstart_model(j_rules, j_terms)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_quickstart_records_match_reference(quickstart_ref, use_kernel):
    res = T.simulate(quickstart(T, quickstart_model(t_rules, t_terms),
                                use_kernel=use_kernel), device="cpu")
    assert res.completed and res.windows_run == 20
    jm = np.stack([r.mean for r in quickstart_ref.records])
    assert res.means().tobytes() == jm.tobytes()
    assert_records_match(quickstart_ref.records, res.records)
    tele, jtele = res.telemetry, quickstart_ref.telemetry
    assert tele.steps_per_window == jtele.steps_per_window
    assert tele.dispatches == 20 and tele.host_syncs == 20
    assert (res.final_state() == quickstart_ref.final_state()).all()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("stat_blocks", [None, 4])
def test_per_point_sweep_stats(use_kernel, stat_blocks):
    sweep = {"reproduce": [0.8, 1.2], "die": [0.5, 0.7]}
    out = []
    for api, models in ((J, J_MODELS), (T, T_MODELS)):
        kw = dict(use_kernel=use_kernel, n_lanes=8, seed=3)
        if stat_blocks:
            kw["partitioning"] = api.Partitioning(stat_blocks=stat_blocks)
        exp = api.Experiment(
            model=models["lv2"](),
            ensemble=api.Ensemble.make(replicas=8, sweep=sweep),
            schedule=api.Schedule(t_end=0.3, n_windows=3),
            reduction=api.Reduction.PER_POINT, **kw)
        out.append(api.simulate(exp, **({} if api is J
                                         else {"device": "cpu"})))
    jres, tres = out
    assert_records_match(jres.records, tres.records)
    jp, tp = jres.per_point(), tres.per_point()
    assert tp["points"] == jp["points"] and tp["mean"].shape == (3, 4, 2)
    assert tp["mean"].tobytes() == jp["mean"].tobytes()
    assert (tp["n"] == jp["n"]).all()
    assert ulp(tp["var"], jp["var"]) <= VAR_ULP
    assert ulp(tp["ci90"], jp["ci90"]) <= CI90_ULP


@pytest.mark.parametrize("schema,policy", [
    ("i", "static_rr"), ("ii", "on_demand"), ("iii", "predictive"),
    ("ii", "predictive")])
def test_schemas_and_policies(schema, policy):
    out = []
    for api, models in ((J, J_MODELS), (T, T_MODELS)):
        exp = api.Experiment(
            model=models["ecoli"](), ensemble=api.Ensemble.make(replicas=12),
            schedule=api.Schedule(t_end=20.0, n_windows=3, schema=schema,
                                  policy=policy), n_lanes=5, seed=9)
        out.append(api.simulate(exp, **({} if api is J
                                         else {"device": "cpu"})))
    jres, tres = out
    assert_records_match(jres.records, tres.records)
    jt, tt = jres.trajectories(), tres.trajectories()
    if schema in ("i", "ii"):
        assert tt.shape == (12, 3, 2) and (tt == jt).all()
    else:
        assert tt is None and jt is None
    assert tres.telemetry.steps_per_window == jres.telemetry.steps_per_window
    assert tres.telemetry.peak_buffered_bytes == \
        jres.telemetry.peak_buffered_bytes


def test_max_windows_then_resume_equals_full_run():
    exp = T.Experiment(model=T_MODELS["lv2"](),
                       ensemble=T.Ensemble.make(replicas=16),
                       schedule=T.Schedule(t_end=0.4, n_windows=4),
                       use_kernel=True)
    full = T.simulate(exp, device="cpu")
    part = T.simulate(exp, device="cpu", max_windows=2)
    assert not part.completed and part.windows_run == 2
    assert "2/4 windows" in repr(part)
    part.resume()
    assert part.completed
    for a, b in zip(full.records, part.records):
        assert a.mean.tobytes() == b.mean.tobytes()
        assert a.var.tobytes() == b.var.tobytes()


def test_csv_sink_is_written_and_closed(tmp_path):
    model = T_MODELS["ecoli"]()
    sink = T.CsvSink(str(tmp_path / "o.csv"), T.observable_names(model))
    res = T.simulate(T.Experiment(
        model=model, ensemble=T.Ensemble.make(replicas=4),
        schedule=T.Schedule(t_end=10.0, n_windows=3), sinks=(sink,)),
        device="cpu")
    assert sink.closed
    rows = (tmp_path / "o.csv").read_text().splitlines()
    assert rows[0].startswith("t,n,ecoli/mrna_mean")
    assert len(rows) == 4
    assert rows[1].split(",")[2] == f"{res.records[0].mean[0]:.6g}"


def test_fused_window_truncation_raises_in_both():
    for api, models, err in ((J, J_MODELS, JTruncated),
                             (T, T_MODELS, TTruncated)):
        exp = api.Experiment(model=models["lv2"](),
                             ensemble=api.Ensemble.make(replicas=4),
                             schedule=api.Schedule(t_end=1.0, n_windows=1),
                             use_kernel=True, kernel_chunk_steps=2,
                             kernel_max_chunks=2)
        with pytest.raises(err, match="kernel_max_chunks=2"):
            api.simulate(exp, **({} if api is J else {"device": "cpu"}))


@pytest.mark.parametrize("api", [J, T], ids=["reference", "port"])
@pytest.mark.parametrize("case,match", [
    ("no_path", "resume=True requires checkpoint_path"),
    ("missing_file", "resume=True but no checkpoint at"),
    ("mid_block", "mid-block for window_block=2"),
])
def test_resume_errors_match_reference(tmp_path, api, case, match):
    """simulate(resume=True) refuses, in both packages alike: without a
    checkpoint_path, without the file, and with a file cut mid-block
    for the run's window_block (a window-3 checkpoint under 2)."""
    models = J_MODELS if api is J else T_MODELS
    kw = {} if api is J else {"device": "cpu"}
    exp = api.Experiment(model=models["lv2"](),
                         ensemble=api.Ensemble.make(replicas=4),
                         schedule=api.Schedule(t_end=0.2, n_windows=4))
    ck = str(tmp_path / "ck")
    if case == "mid_block":
        api.simulate(exp, max_windows=3, checkpoint_path=ck, **kw)
        exp = exp.with_(window_block=2)
    with pytest.raises(api.ExperimentError, match=match):
        api.simulate(exp, checkpoint_path=None if case == "no_path" else ck,
                     resume=True, **kw)


@pytest.mark.parametrize("api", [J, T], ids=["reference", "port"])
def test_window_block_with_host_loop_raises(api):
    models = J_MODELS if api is J else T_MODELS
    exp = api.Experiment(model=models["lv2"](),
                         ensemble=api.Ensemble.make(replicas=4),
                         schedule=api.Schedule(t_end=1.0, n_windows=2),
                         window_block=2, host_loop=True)
    with pytest.raises(api.ExperimentError,
                       match="window_block > 1 needs the fused or sharded"):
        api.simulate(exp, **({} if api is J else {"device": "cpu"}))


def test_spec_fields_and_defaults_match_reference():
    for name in ("Experiment", "Ensemble", "Schedule"):
        jf = dataclasses.fields(getattr(J, name))
        tf = dataclasses.fields(getattr(T, name))
        assert [f.name for f in jf] == [f.name for f in tf], name
        for a, b in zip(jf, tf):
            da, db = a.default, b.default
            if hasattr(da, "value"):
                da, db = da.value, db.value
            assert da == db or (da is dataclasses.MISSING
                                and db is dataclasses.MISSING), a.name


def test_simulate_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = T.Experiment(model=T_MODELS["lv2"](),
                       ensemble=T.Ensemble.make(replicas=4),
                       schedule=T.Schedule(t_end=1.0, n_windows=2),
                       use_kernel=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate(exp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_engine(exp)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_import_neither_jax_nor_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_port_examples_import_neither_jax_nor_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [f.name for f in files] == [
        "torch_ecoli_gene_regulation.py", "torch_lotka_volterra_sweep.py",
        "torch_quickstart.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []
