"""What the benchmark may not do: load JAX or the JAX package, name a
cell or a unit outside its alphabet, or write outside its checkout, its
HOME, XDG_CACHE_HOME or TMPDIR."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, copy_bench, run_cell
from vrbench.spec import NAME, UNIT, Spec, check_names

VRBENCH = REPO / "vrbench"
# JAX, its libraries, the JAX package and that package's bench.py.
BANNED = {"jax", "jaxlib", "flax", "tpuvr", "bench"}


def imported_names(path: Path):
    """Top-level names of every import in a module."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(VRBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(VRBENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(imported_names(path))
    assert not names & BANNED, f"{path} imports {names & BANNED}"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from vrbench import guard

    monkeypatch.setitem(sys.modules, "tpuvr_torch_extra", sys)
    assert "tpuvr" not in guard.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpuvr.config", sys)
    assert guard.forbidden_modules() == ["tpuvr"]


def test_benchmark_names_and_units():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    check_names(bench)
    assert len(json.dumps(bench)) < 64 * 1024
    for c in bench["configs"]:
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert (REPO / c["file"]).is_file()
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200
        assert (VRBENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (VRBENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "-lead", "é",
                                 "x" * 65, ""])
def test_bad_names_are_refused(bad):
    assert not NAME.match(bad)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"][0]["name"] = bad
    with pytest.raises(ValueError):
        check_names(bench)


@pytest.mark.parametrize("bad", ["tokens per second", "x" * 17, "µs", ""])
def test_bad_units_are_refused(bad):
    assert not UNIT.match(bad)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["end_to_end"][0]["unit"] = bad
    with pytest.raises(ValueError):
        check_names(bench)


@pytest.mark.parametrize("good", ["tokens/s", "%", "GiB", "ms"])
def test_good_units_pass(good):
    assert UNIT.match(good)


def test_no_fixed_scratch_paths_in_the_sources():
    for path in VRBENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not re.search(r"['\"]/(tmp|dev/shm)", text), path


def test_a_run_writes_only_under_its_tmpdir(tiny, tmp_path, capsys,
                                            monkeypatch):
    import tempfile

    made = []
    real = tempfile.mkdtemp

    def mkdtemp(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    tmpdir = tmp_path / "tmpdir"
    tmpdir.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmpdir))
    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    rc, res = run_cell(tiny, "c4-fit", capsys)
    assert rc == 0 and res["correct"]
    assert made and all(Path(p).parent == tmpdir for p in made)
    assert not any(Path(p).exists() for p in made)  # removed again
    after = set(os.listdir("/dev/shm")) if shm else set()
    assert not {n for n in after - shm if "vrbench" in n or "tpuvr" in n}


def test_without_a_card_run_py_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "vrbench/run.py", "--workload", "c4-fit", "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        cwd=copy_bench(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_spec_finds_each_cells_files():
    spec = Spec()
    for w in spec.bench["workloads"]:
        spec.config(w["config"])
        spec.traffic(w["traffic"])
        spec.limits(w["name"])
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
