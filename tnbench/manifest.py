"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout names every cell, with its
configuration and its traffic, and every metric.  The rest lies in this
folder, one file a name, so that a cell, a configuration, a traffic mix or
a metric is added by adding files and entries:

- ``configs/<config>.json``: the configuration (``BENCHMARK.json`` names
  the file), its frozen plans beside it;
- ``traffic/<traffic>.json``: the traffic mix, read by ``traffic.py``;
- ``workloads/<cell>.json``: the cell's limits on what ``compare.py``
  compares, and the readings they were set from;
- ``metrics/<metric>.py``: the metric's reader, ``read(run)``, which
  returns a number or None where it finds nothing to read.
"""

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    plan_path: str
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def applies(metric, cell_name):
    """Whether ``metric`` (a manifest entry) is reported in the cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def load(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name, root=ROOT, here=HERE):
    """The cell ``name`` of the checkout at ``root`` (its benchmark files
    in ``here``)."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    spec = _json(os.path.join(here, "workloads", name + ".json"))
    plan = os.path.join(os.path.dirname(os.path.join(root, conf["file"])),
                        traffic["plan"])
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, limits=spec["limits"], plan_path=plan,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(metric_name, here=HERE):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(here, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "tnbench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
