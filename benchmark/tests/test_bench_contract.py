"""`BENCHMARK.json` against the contract's limits, the files each cell is
put together from, the import check by whole top-level names, and the
schema of a run's last line."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as bench_run
from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))


def test_names_units_and_entries():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert (spec.ROOT / c["file"]).is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_from_its_files(cell):
    c = spec.resolve(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert spec.driver(c.traffic["driver"]).run
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_the_harness_names_no_cell():
    """The code knows no cell, configuration or traffic mix by name: a new
    one is files and entries only (`pgcn_mag.serve_refresh` is put
    together from `configs/pgcn_mag.json`, `traffic/serve_refresh.json`,
    `limits/pgcn_mag.serve.json` and its metrics' files alone)."""
    drivers = {p.stem for p in (spec.HERE / "workloads").glob("*.py")}
    words = {w["name"] for w in BENCH["workloads"]} | \
        {c["name"] for c in BENCH["configs"]} | \
        ({w["traffic"] for w in BENCH["workloads"]} - drivers)
    for path in spec.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for w in words:
            assert not re.search(rf"\b{re.escape(w)}\b", text), (path, w)


def test_forbidden_modules_compares_whole_names():
    assert bench_run.forbidden_modules(["taxoexpan_torch", "taxoexpan_torch.x",
                                        "jaxtyping", "flaxen"]) == []
    assert bench_run.forbidden_modules(["jax.numpy", "taxoexpan_tpu.ops",
                                        "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "taxoexpan_tpu"]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json;"
                          "print(json.dumps(sorted({m.split('.')[0] for m "
                          "in sys.modules})))"], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    mods = ["benchmark." + str(p.relative_to(spec.HERE).with_suffix(""))
            .replace("/", ".") for p in spec.HERE.rglob("*.py")
            if not {"tests", "metrics"} & set(p.parts)
            and p.name != "__init__.py"]
    metrics = [p.stem for p in (spec.HERE / "metrics").glob("*.py")]
    code = "\n".join(f"import {m}" for m in mods) + \
        "\nimport taxoexpan_torch.training.trainer, " \
        "taxoexpan_torch.evaluation.ranker, taxoexpan_torch.builders" + \
        "".join(f"\nbenchmark.spec.reader({m!r})" for m in metrics)
    assert not _loaded_after(code) & bench_run.FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.model, "
                           "benchmark.reference.data")
    assert "taxoexpan_torch" not in loaded
    assert not loaded & bench_run.FORBIDDEN


def test_the_last_line(tiny):
    import torch
    cell = tiny("pgat_mag.train")
    res = bench_run.execute(cell, 2 ** 31 + 99, 0.5, False,
                            torch.device("cpu"))
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"train_egonets_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def test_no_device_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_paths_hold_only_the_benchmark():
    for p in BENCH["paths"]:
        assert Path(spec.ROOT / p).is_dir()
        assert not list((spec.ROOT / p).rglob("*_torch*"))
