"""BENCHMARK.json against the benchmark's contract, and each name it
holds against the file the harness finds by that name."""
import json
import re

import numpy as np
import pytest

from portbench.harness.bench import cell_metrics, reader
from portbench.harness.cell import BENCH, ROOT, build_experiment, \
    experiment_spec, find, limits
from portbench.harness.readers import roofline

B = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in B["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KERNELS = ("ssa_window", "sparse_window", "tau_window", "sparse_tau_window")


def nested_keys(d) -> set:
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict):
            out |= nested_keys(v)
    return out


def test_keys_names_and_units():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"] and 1 <= B["run_seconds"] <= 51
    metrics = B["end_to_end"] + B["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in B["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = find(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.method in ("exact", "tau_leap")
    assert set(limits(cell)) == {"lanes_off", "fold_err"}
    assert c.chips == c.workload["chips"] == 1
    assert c.check["record_n"] == c.replicas
    reported = cell_metrics(c, traced=True)
    assert reported, cell
    for m in reported:
        assert callable(reader(m["name"]))
    assert {"ensemble_s", "record_gap_p95_ms", "setup_s"} == {
        m["name"] for m in cell_metrics(c, traced=False)}


@pytest.mark.parametrize("kernel", KERNELS)
def test_roofline_modules(kernel):
    mod = roofline(kernel)
    assert mod.KERNEL == f"{kernel}_kernel" and callable(mod.per_window)


def test_the_experiment_is_the_files():
    """Each key of the configuration's and the mix's experiment blocks
    reaches the Experiment; a block with a type is built by it."""
    from repro_torch.api import Partitioning

    cell = find("lv8-tau")
    spec = dict(cell.spec, partitioning={"type": "Partitioning",
                                         "n_shards": 2},
                window_block=4, pipeline_depth=2)
    exp = build_experiment(spec, seed=5)
    assert exp.partitioning == Partitioning(n_shards=2)
    assert (exp.window_block, exp.pipeline_depth) == (4, 2)
    assert exp.method.value == "tau_leap" and exp.tau_eps == 0.03
    assert exp.ensemble.replicas == cell.replicas
    assert exp.schedule.n_windows == cell.n_windows
    assert exp.seed == 5 and exp.use_kernel


@pytest.mark.parametrize("bad", [{"window_blok": 8}, {"seed": 3},
                                 {"method": "exact"}])
def test_unknown_or_doubled_keys_are_refused(bad):
    cell = find("lv8-tau")
    with pytest.raises(SystemExit):
        build_experiment(experiment_spec(
            dict(cell.config, experiment=dict(cell.config["experiment"],
                                              **bad)), cell.mix), seed=1)


@pytest.mark.parametrize("entry", B["configs"], ids=lambda c: c["name"])
def test_config_matches_the_program_model(entry):
    """The reference's network of each configuration is the table the
    port compiles from the model the configuration names."""
    from repro_torch.core.cwc.compile import compile_model
    from repro_torch.core.cwc.models import MODELS

    path = ROOT / entry["file"]
    assert path.is_relative_to(BENCH)
    config = json.loads(path.read_text())
    net = find(next(w["name"] for w in B["workloads"]
                    if w["config"] == entry["name"])).net
    system, meta = compile_model(MODELS[config["experiment"]["model"]]())
    assert np.array_equal(system.reactant_idx, net.idx)
    assert np.array_equal(system.reactant_coef, net.coef)
    assert np.array_equal(system.delta.astype(np.float32), net.delta)
    assert np.array_equal(system.rates, net.rates)
    assert np.array_equal(system.x0, net.x0)
    assert list(meta["species"]) == list(net.species)
    assert [list(v) for v in meta["observables"].values()] == [
        list(i) for i in net.obs_idx]
    assert (config["species"], config["reactions"]) == (
        net.n_species, net.n_reactions)
    assert set(entry["reduced"]) <= nested_keys(config)
