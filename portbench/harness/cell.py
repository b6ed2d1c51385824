"""A cell of `BENCHMARK.json`: its configuration (`configs/<name>.json`)
and its traffic mix (`mixes/<name>.json`), found by name, and the
experiment of one of its jobs.

The experiment of a job is the configuration's `experiment` block
merged with the mix's: each key is a field of
`repro_torch.api.Experiment`, handed to it as it stands, except `model`
(a name in `MODELS`), `reduction` (a `Reduction` value) and a block
with a `type` (the `repro_torch.api` attribute it names, called with
the block's other keys, e.g. `{"type": "Partitioning", "n_shards": 4}`).
A key that is no field, or that both files set, is refused.
"""
from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from pathlib import Path

from portbench.reference.network import Network, build

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: the experiment's keys the harness sets itself, per job
PER_JOB = ("seed", "sinks")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merged(base: dict, over: dict) -> dict:
    """`base` with the keys of `over` replaced, nested blocks merged."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def job_seed(seed: int, job: int) -> int:
    """The seed of job `job` of a run seeded `seed` (job -1 is the warm
    job of the set-up): the same for every run of that seed."""
    return (int(seed) * 1_000_003 + job + 1) % 2 ** 63


def experiment_spec(config: dict, mix: dict) -> dict:
    """The configuration's experiment block and the mix's, merged; a key
    set by both, or by neither's business (seed, sinks), is refused."""
    ce, me = config.get("experiment", {}), mix.get("experiment", {})
    both = sorted(set(ce) & set(me))
    ours = sorted((set(ce) | set(me)) & set(PER_JOB))
    if both or ours:
        raise SystemExit(f"experiment keys {both + ours} set twice: by the "
                         "configuration and the mix, or by a file and the "
                         "harness")
    return dict(ce, **me)


def api_value(v):
    """A block with a `type`, made by the `repro_torch.api` attribute it
    names; anything else as it stands."""
    if not (isinstance(v, dict) and "type" in v):
        return v
    from repro_torch import api

    make = api
    for part in v["type"].split("."):
        make = getattr(make, part)
    return make(**{k: api_value(x) for k, x in v.items() if k != "type"})


def build_experiment(spec: dict, seed: int, sinks=()):
    """The program's Experiment of one job from the merged spec."""
    from dataclasses import fields

    from repro_torch.api import Experiment, Reduction
    from repro_torch.core.cwc.models import MODELS

    known = {f.name for f in fields(Experiment)} - set(PER_JOB)
    unknown = sorted(set(spec) - known)
    if unknown:
        raise SystemExit(f"experiment keys {unknown} are no field of "
                         "repro_torch.api.Experiment")
    kw = {k: api_value(v) for k, v in spec.items()}
    kw["model"] = MODELS[spec["model"]]()
    if "reduction" in spec:
        kw["reduction"] = Reduction(spec["reduction"])
    return Experiment(seed=seed, sinks=tuple(sinks), **kw)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    net: Network

    @property
    def spec(self) -> dict:
        return experiment_spec(self.config, self.mix)

    @property
    def method(self) -> str:
        return self.spec.get("method", "exact")

    @property
    def schedule(self) -> dict:
        return self.spec["schedule"]

    @property
    def n_windows(self) -> int:
        return self.schedule["n_windows"]

    @property
    def replicas(self) -> int:
        """The lanes of a job (an ensemble without a sweep)."""
        e = self.spec["ensemble"]
        if e.get("sweep"):
            raise SystemExit("the reference follows lanes of one parameter "
                             "point; a sweep needs its rates per point")
        return e["replicas"]

    @property
    def chips(self) -> int:
        return self.workload["chips"]

    @property
    def check(self) -> dict:
        return self.config["check"]

    def job(self, seed: int) -> dict:
        """The reference's view of a job: seed, schedule and method."""
        s = self.spec
        return dict(seed=seed, t_end=self.schedule["t_end"],
                    n_windows=self.n_windows, method=self.method,
                    tau_eps=s.get("tau_eps"),
                    tau_fallback=s.get("tau_fallback"),
                    budget=s["kernel_chunk_steps"] * s["kernel_max_chunks"])

    def experiment(self, seed: int, sinks=()):
        """The program's Experiment of one job."""
        return build_experiment(self.spec, seed, sinks)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(workload: str, override=None) -> Cell:
    """The cell named `workload` in BENCHMARK.json. override: blocks of
    the configuration merged over it (a smaller run on the CPU)."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    w = cells[workload]
    config = merged(load_json(BENCH / "configs" / f"{w['config']}.json"),
                    override or {})
    mix = load_json(BENCH / "mixes" / f"{w['traffic']}.json")
    cell = Cell(workload, w, config, mix, build(config))
    experiment_spec(config, mix)  # refuses a key set twice
    return cell


def limits(workload: str) -> dict:
    """The limits of the cell's compared numbers
    (`limits/<workload>.json`)."""
    return load_json(BENCH / "limits" / f"{workload}.json")["limits"]
