"""tpuvr_torch as a package: it stands apart from JAX, imports without a
CUDA toolkit, never falls back to the CPU quietly, and binds its kernels'
gradients as autograd Functions."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuvr_torch import configs
from tpuvr_torch.bench import judged
from tpuvr_torch.bench.sweep import scaling_table
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.io.synth import smoke_sphere
from tpuvr_torch.kernels import _build
from tpuvr_torch.ops import lighting, render, vjp

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpuvr_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpuvr_imports(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "orbax", "tpuvr",
                           "configs"), (
            f"{path.name} imports {mod}")


def test_import_needs_no_toolkit_and_builds_nothing():
    """Importing every module pulls in neither triton nor jax and
    compiles nothing."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES if p.parent != ROOT]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from tpuvr_torch.kernels import _build\n"
        "assert not _build._libs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('triton', 'jax', 'tpuvr')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back(no_card):
    grid = torch.zeros(4, 4, 4, 4)
    cam = configs.front_ortho(4, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render.render_view(grid, cam)
    with pytest.raises(RuntimeError):
        render.prepare_grid(grid)
    prep = render.prepare_grid(grid, device="cpu")
    with pytest.raises(RuntimeError):
        render.render_prepared(prep, cam)
    with pytest.raises(RuntimeError):
        lighting.light_volume(grid[..., 0])
    with pytest.raises(RuntimeError):
        smoke_sphere(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render.render_view(grid, cam, RenderConfig(mode="fixed_dt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        judged.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling_table(grid, cam)


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_card_ops_are_autograd_functions(monkeypatch):
    """On the card the sweep and tau ops are autograd Functions whose
    backward calls the backward kernels' wrappers (stand-ins here record
    the calls), with no guard in the way."""
    from tpuvr_torch.kernels import sweep_torch
    from tpuvr_torch.ops import lighting as olight

    calls = []

    def bwd(*args, **kw):
        calls.append("sweep_bwd")
        return sweep_torch.sweep_bwd_torch(*args, **kw)

    monkeypatch.setattr(vjp, "sweep_fwd", sweep_torch.sweep_fwd_torch)
    monkeypatch.setattr(vjp, "sweep_bwd", bwd)
    op = vjp.sweep_op(False, 1.0, 0.0, "cuda")
    grid = smoke_sphere(6, device="cpu")
    prep = render.prepare_grid(grid, axes=(2,), device="cpu")
    _, _, (gsc, coeffs, en, dt) = render.sweep_inputs(
        prep, configs.front_ortho(6, 8), device="cpu")
    gsc = gsc.clone().requires_grad_(True)
    rgb, t = op(gsc, coeffs, en, dt)
    assert type(rgb.grad_fn).__name__ == "_SweepBackward"
    (rgb.sum() + t.sum()).backward()
    assert calls == ["sweep_bwd"] and float(gsc.grad.abs().max()) > 0

    monkeypatch.setattr(olight, "tau_sweep_adj",
                        lambda g, **kw: calls.append("tau_adj") or g)
    sig = grid[..., 0].clone().requires_grad_(True)
    olight._directional_tau(sig, (0.0, 0.3, 0.95)).sum().backward()
    assert calls[-1] == "tau_adj"


# What fit_grid refuses on a ('data', 'z') mesh: (fit_grid keywords,
# environment, the message's words). The first four the JAX package drops
# silently on such a mesh.
Z_MESH_REFUSALS = {
    "lighting": (dict(lighting=configs.CONFIGS["c3"]["lighting"]), {},
                 "lighting"),
    "grad_ring": (dict(grad_ring=True, bwd_chunks=2), {}, "grad_ring"),
    "bwd_chunks": (dict(bwd_chunks=2), {}, "bwd_chunks"),
    "warp_rows": ({}, {"TPUVR_WARP": "rows"}, "TPUVR_WARP=rows"),
    "fused": (dict(fused=True), {}, "fused mode"),
    "indivisible_z": (dict(grid_shape=(5, 4, 4, 4)), {},
                      "Z=5 not divisible by z-mesh 2"),
}


@pytest.mark.parametrize("case", sorted(Z_MESH_REFUSALS))
def test_fit_grid_refuses_a_mesh(case, monkeypatch):
    """On a ('data', 'z') mesh (here rank 0 of a 1 x 2 mesh made by hand,
    with no process group: a collective would fail) fit_grid raises
    ValueError before anything runs for each setting it cannot honour,
    where the JAX package would drop the first four silently."""
    from tpuvr_torch.dist.init import DataMesh, GridMesh
    from tpuvr_torch.train import fit

    kw, env, words = Z_MESH_REFUSALS[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    kw = dict(dict(grid_shape=(4, 4, 4, 4)), **kw)
    z_mesh = GridMesh(1, 2, 0, data=DataMesh(None, 0, 1),
                      z=DataMesh(None, 0, 2), flat=DataMesh(None, 0, 2))
    with pytest.raises(ValueError, match=words):
        fit.fit_grid(np.zeros((1, 4, 4, 3)), [configs.front_ortho(4, 4)],
                     mesh=z_mesh, device="cpu", **kw)


def test_build_digest_tracks_sources(tmp_path, monkeypatch):
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in before.values())
    (tmp_path / "tent.cuh").write_text(
        (tmp_path / "tent.cuh").read_text() + "\n// edit\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


def test_every_source_is_built():
    srcs = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert srcs == sorted(_build.SOURCES)
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_nvcc_prefers_cuda_home(tmp_path, monkeypatch):
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc() == str(tmp_path / "bin" / "nvcc")


def test_build_dir_is_ignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "tpuvr_torch/_build/" in lines


def test_smoke_script_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result line without a
    card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_configs_cover_the_main_path():
    assert set(configs.CONFIGS) == {"c1", "c2", "c3", "headline", "c4",
                                    "c5"}
    for name, cfg in configs.CONFIGS.items():
        if name == "c4":
            continue
        cam = configs.camera(cfg)
        assert (cam.res_x, cam.res_y) == (cfg["res"], cfg["res"])
    assert np.isclose(configs.orbit_persp(8, 8).fov_y, np.radians(40.0))
    c4 = configs.CONFIGS["c4"]
    with pytest.raises(ValueError, match="cameras"):
        configs.camera(c4)
    cams = configs.cameras(c4, n=8, res=8)
    assert len(cams) == 64 and (cams[0].res_x, cams[0].res_y) == (8, 8)
    train = c4["train"]
    assert (c4["grid_n"], c4["res"], train.lr, train.views_per_batch,
            train.ckpt_every) == (256, 256, 5e-2, 8, 200)
    assert c4["render"].early_stop_eps == 0.0 and c4["render"].use_occupancy
    c5 = configs.CONFIGS["c5"]
    assert (c5["grid_n"], c5["res"], c5["mesh_cfg"].data,
            c5["mesh_cfg"].grad_buckets) == (512, 1024, 0, 4)
    assert c5["lighting"].n_samples == 16 and c5["lighting"].detach
