"""Cells by name: ``BENCHMARK.json`` names each cell's configuration,
traffic and metrics, and the harness finds their files under
``port_bench/``:

* ``configs/<config>.json`` (the file the entry names): the configuration as
  run, in the sections of ``Config`` and the serving ``engine``;
* ``traffic/<traffic>.json``: the traffic mix's parameters, whose ``kind``
  names the driver ``drivers/<kind>.py``;
* ``workloads/<cell>.json``: how the cell's output is checked (the sample
  it draws and each compared number's limit);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``, which
  returns a number, or None where its cell gives it nothing to read.

A later change adds a configuration, a traffic mix, a cell or a metric by
adding such files and entries only.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "detail_tts_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    check: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files; raises
    when an entry or file is missing."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pb = root / "port_bench"

    def mine(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    cell = Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json(root / conf["file"]), traffic_name=w["traffic"],
                traffic=_json(pb / "traffic" / f"{w['traffic']}.json"),
                check=_json(pb / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)
    for m in per_layer:
        cell.readers[m["name"]] = load_reader(pb / "metrics" / f"{m['name']}.py")
    return cell


def load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """The module ``drivers/<kind>.py``, whose ``run(cell, args)`` runs a
    cell of traffic ``kind``."""
    return importlib.import_module(f"port_bench.drivers.{kind}")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Outcome:
    """What a driver hands back: the work attempted and failed, the
    end-to-end readings (untraced run) or the readers' context (traced run),
    each compared number with its limit, and the result's ``device`` block."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    context: Dict
    compared: Dict[str, tuple]
    device: Dict = field(default_factory=dict)


def verdict(out: Outcome) -> bool:
    """Correct: every number within its limit (a number that could not be
    read fails), and no failed work."""
    ok = out.failed == 0 and bool(out.compared)
    for value, limit in out.compared.values():
        ok = ok and value is not None and math.isfinite(value) and value <= limit
    return ok


def result(cell: Cell, out: Outcome, trace: bool) -> Dict:
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]](out.context)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                      "unit": m["unit"]}
    line = {"correct": verdict(out), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": out.device}
    if trace and "trace" in out.context:
        line["breakdown"] = out.context["trace"].breakdown()
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.compared.items()}
    return line


def emit(line: Dict) -> None:
    """The verdict, then the compared numbers beside their limits as the last
    lines of standard error; the result as the last line of standard output."""
    print(f"correct {line['correct']}", file=sys.stderr)
    for k, c in line["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def limits(cell: Cell, readings: Dict[str, Optional[float]]) -> Dict[str, tuple]:
    """Each reading beside the cell's limit for it (an unknown name raises:
    every number compared has a limit)."""
    lim = cell.check["limits"]
    return {k: (v, float(lim[k])) for k, v in readings.items()}
