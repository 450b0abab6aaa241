"""tpuvr_torch's volume and image IO (``tpuvr_torch.io.volume``,
``io.image``) and ``hollow_shell`` (``io.synth``), held against the JAX
package's ``tpuvr.io``.

Tolerances: files byte for byte, arrays bit for bit, ``hollow_shell``
bit for bit in f32 and within 1e-12 in f64 (the two libraries' f64
cosines may differ in the last bit). The PNG writer needs no imaging
library; PIL decodes its files here.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from tpuvr.io import image as jimage
from tpuvr.io import synth as jsynth
from tpuvr.io import volume as jvol
from tpuvr_torch.io import image as timage
from tpuvr_torch.io import synth as tsynth
from tpuvr_torch.io import volume as tvol


@pytest.fixture(scope="module")
def vol():
    """Mostly exact zeros, so that the zero-RLE has runs to encode."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(9, 7, 5, 4)).astype(np.float32)
    v[v < 0.8] = 0.0
    return v


def _native(mod):
    lib = mod._lib()
    assert lib is not None, f"{mod.__name__}: the native codec did not load"
    return lib


# Writers and readers of TVOL files: each package's native codec (its
# save_tvol / load_tvol with the library loaded) and its numpy codec.
WRITERS = {
    "jax_native": lambda p, v, rle: (_native(jvol), jvol.save_tvol(p, v, rle)),
    "jax_numpy": lambda p, v, rle: jvol._save_tvol_numpy(p, v, rle),
    "port_native": lambda p, v, rle: (_native(tvol),
                                      tvol.save_tvol(p, torch.as_tensor(v),
                                                     rle)),
    "port_numpy": lambda p, v, rle: tvol._save_tvol_numpy(p, v, rle),
}
READERS = {
    "jax_native": lambda p: (_native(jvol), jvol.load_tvol(p))[1],
    "jax_numpy": jvol._load_tvol_numpy,
    "port_native": lambda p: (_native(tvol), tvol.load_tvol(p))[1],
    "port_numpy": tvol._load_tvol_numpy,
}


# Every pair with the port on at least one side (tests/test_volume_io.py
# holds the JAX package's own pairs).
PAIRS = [(w, r) for w in sorted(WRITERS) for r in sorted(READERS)
         if "port" in w + r]


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "raw"])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_tvol_crosses_between_packages(tmp_path, vol, writer, reader, rle):
    """A file written by either package, by either codec, reads back bit
    for bit in every codec of the port and of the JAX package, and every
    writer writes the same bytes."""
    path = tmp_path / "v.tvol"
    WRITERS[writer](str(path), vol, rle)
    out = READERS[reader](str(path))
    assert out.dtype == np.float32 and out.shape == vol.shape
    np.testing.assert_array_equal(out.view(np.uint32), vol.view(np.uint32))
    ref = tmp_path / "ref.tvol"
    jvol._save_tvol_numpy(str(ref), vol, rle)
    assert path.read_bytes() == ref.read_bytes()


def test_tvol_three_dims_and_its_build_dir(tmp_path, vol):
    """A (Z, Y, X) volume gains a channel axis, and the port builds its
    codec into its own git-ignored build directory."""
    path = str(tmp_path / "d.tvol")
    tvol.save_tvol(path, vol[..., 0])
    np.testing.assert_array_equal(jvol.load_tvol(path), vol[..., :1])
    _native(tvol)
    assert tvol._LIB_PATH.parent.name == "_build"
    assert tvol._LIB_PATH.parent.parent.name == "tpuvr_torch"
    assert tvol._SRC.read_bytes() == (
        tvol._PKG.parent / "native" / "volcodec.cpp").read_bytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_raw_and_density_to_grid_match(tmp_path, dtype):
    rng = np.random.default_rng(1)
    d = (rng.integers(0, 255, size=(4, 5, 6)) if dtype != np.float32
         else rng.uniform(size=(4, 5, 6))).astype(dtype)
    path = str(tmp_path / "d.raw")
    d.tofile(path)
    for normalize in (True, False):
        a = tvol.load_raw(path, (4, 5, 6), dtype, normalize)
        b = jvol.load_raw(path, (4, 5, 6), dtype, normalize)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    em = (0.2, 0.4, 0.6)
    np.testing.assert_array_equal(
        tvol.density_to_grid(torch.as_tensor(a), em),
        jvol.density_to_grid(a, em))


@pytest.mark.parametrize("mode", ["uint8", "uint16", "float32"])
def test_tiff_stack_matches(tmp_path, mode):
    rng = np.random.default_rng(2)
    top = {"uint8": 255, "uint16": 65535, "float32": 1}[mode]
    vol = (rng.uniform(size=(3, 6, 5)) * top).astype(mode)
    for z in range(vol.shape[0]):
        Image.fromarray(vol[z]).save(tmp_path / f"s_{z:02d}.tif")
    pattern = str(tmp_path / "s_*.tif")
    for kw in ({}, {"normalize": False}, {"scale": 7.0}):
        np.testing.assert_array_equal(tvol.load_tiff_stack(pattern, **kw),
                                      jvol.load_tiff_stack(pattern, **kw))
    with pytest.raises(ValueError, match="no slice files"):
        tvol.load_tiff_stack(str(tmp_path / "none_*.tif"))


def _image(seed=3, h=9, w=7):
    """Linear radiance with values below 0 and above 1, to be clamped."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.2, 1.3, size=(h, w, 3)).astype(np.float32)


def test_ppm_writers_match(tmp_path):
    img = _image()
    a, b = tmp_path / "a.ppm", tmp_path / "b.ppm"
    timage.write_ppm(str(a), torch.as_tensor(img))
    jimage.write_ppm(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    assert tvol.write_ppm_native(str(a), img)
    assert jvol.write_ppm_native(str(b), img)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("shape", [(9, 7), (1, 1), (32, 48)])
def test_png_writer_needs_no_pil_and_matches(tmp_path, shape, monkeypatch):
    """The port's PNG decodes (by PIL, here) to the JAX package's pixels,
    ``tonemap(rgb) * 255 + 0.5`` as uint8, and writing it imports no
    imaging library."""
    img = _image(4, *shape)
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    jimage.write_png(str(b), img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    timage.write_png(str(a), torch.as_tensor(img))
    monkeypatch.undo()
    want = (np.asarray(jimage.tonemap(img)) * 255.0 + 0.5).astype(np.uint8)
    with Image.open(a) as pa, Image.open(b) as pb:
        assert pa.mode == "RGB" and pa.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
        np.testing.assert_array_equal(np.asarray(pa), want)
    np.testing.assert_array_equal(timage.tonemap(img), jimage.tonemap(img))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [8, 12, 16, 24])
def test_hollow_shell_matches_jax(n, dtype):
    t = tsynth.hollow_shell(n, dtype=getattr(torch, dtype),
                            device="cpu").numpy()
    j = np.asarray(jsynth.hollow_shell(n, dtype=getattr(jnp, dtype)))
    assert t.dtype == j.dtype == np.dtype(dtype) and t.shape == (n, n, n, 4)
    if dtype == "float32":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    off = j[..., 0] == 0.0
    assert off.mean() > 0.5 and (t[..., 0][off] == 0.0).all()
    kw = dict(r0=0.3, width=0.1, amp=0.5)
    np.testing.assert_allclose(
        tsynth.hollow_shell(n, device="cpu", **kw).numpy(),
        np.asarray(jsynth.hollow_shell(n, **kw)), rtol=0, atol=0)
