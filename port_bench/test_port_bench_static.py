"""The benchmark's definition: names and units in ``BENCHMARK.json``, the
files each entry needs, what a later change can add by files alone, and the
imports of ``port_bench/``."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench import bench

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def test_keys_and_sizes():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(LINE.match(w) for w in b["command"])
    assert b["paths"] == ["port_bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # the full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(group):
    b = _bench()
    names = [e["name"] for e in b[group]]
    assert len(set(names)) == len(names)
    for e in b[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end":
                assert LINE.match(e[key]), (e["name"], key)
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if group == "configs":
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
            assert (ROOT / e["file"]).is_file() and e["file"].startswith("port_bench/")


def test_metrics_shape():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
        assert any("mfu" in m["name"] and w["name"] in m["workloads"] for m in b["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads(name):
    cell = bench.load_cell(name, ROOT)
    assert cell.readers and cell.check["limits"]
    assert (HERE / "drivers" / f"{cell.traffic['kind']}.py").is_file()


def test_new_config_cell_and_metric_by_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and new entries, editing no file."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()}
    conf = json.loads((HERE / "configs" / "dtts24k-serve.json").read_text())
    conf["engine"]["diffusion_sampler"] = "dpmpp_2m"
    (root / "port_bench" / "configs" / "dtts24k-fast.json").write_text(json.dumps(conf))
    (root / "port_bench" / "traffic" / "offline-b8.json").write_text(json.dumps(
        {"kind": "serve_offline", "batch": 8, "text_chars": [10, 60],
         "prompt_seconds": [3.0, 10.0]}))
    (root / "port_bench" / "workloads" / "serve-fast-b8.json").write_text(json.dumps(
        {"sample_rows": 3, "limits": {"decode_gap": 1.0, "nucleus_gap": 0.1}}))
    (root / "port_bench" / "metrics" / "host_s.fast.py").write_text(
        "def read(ctx):\n    return ctx.get('wall_s')\n")
    b["configs"].append({"name": "dtts24k-fast", "source": "x", "reduced": [],
                         "file": "port_bench/configs/dtts24k-fast.json", "why": "x"})
    b["workloads"].append({"name": "serve-fast-b8", "config": "dtts24k-fast",
                           "traffic": "offline-b8", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("serve-fast-b8")
    b["per_layer"].append({"name": "host_s.fast", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "engine",
                           "moves": "audio_s_per_s", "workloads": ["serve-fast-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.load_cell("serve-fast-b8", root)
    assert cell.config["engine"]["diffusion_sampler"] == "dpmpp_2m"
    assert cell.traffic["batch"] == 8 and cell.readers["host_s.fast"]({"wall_s": 2.0}) == 2.0
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_jax_and_a_plain_reference(path):
    found = set(_imports(HERE / path))
    assert not found & {"jax", "jaxlib", "flax", "detail_tts_tpu"}, found
    if path.startswith("reference/"):
        assert "detail_tts_tpu_torch" not in found, found
