"""The manifest and the files it names: the contract's characters and
keys, every cell reporting each metric's target, readers for every metric,
and no import of JAX or the JAX package anywhere in the benchmark."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "surikatoko_tpu"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
def test_entry_keys_and_names(kind, keys):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) <= keys | {"workloads"} and keys - {"workloads"} <= set(e)
        assert NAME.match(e["name"]), e["name"]
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200
                assert "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_cells_and_configs_resolve():
    cfgs = {c["name"]: c for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == set(cfgs)
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())


def test_every_cell_reports_each_metrics_target():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", cells))
    for c in cells:
        assert any(c in m["workloads"] for m in MAN["per_layer"])


def test_every_metric_has_a_reader():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_import_in_sources():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    ref = set().union(*(_imports(p) for p in (BENCH / "reference").glob("*.py")))
    assert "surikatoko_tpu_torch" not in ref and "benchmark" not in ref


def test_no_jax_module_after_import():
    """Every module of the benchmark imported in a fresh process leaves no
    top-level name of JAX or the JAX package in sys.modules (compared
    whole: the port's name begins with the JAX package's)."""
    mods = ["benchmark.run", "benchmark.control"] + [
        "benchmark." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
        for sub in ("lib", "drivers", "reference")
        for p in (BENCH / sub).glob("*.py")]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import surikatoko_tpu_torch.world.device_runner\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    names = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "surikatoko_tpu_torch" in names
    assert not names & FORBIDDEN
