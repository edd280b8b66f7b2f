"""IO: native C++ vs numpy-oracle parity for obj/hdr/bmp/env-cache."""
import numpy as np
import pytest

from tpuray.io import fallback, native
from tpuray.io.obj import load_obj, transform_matrix

HAS_NATIVE = native.get_lib() is not None


@pytest.fixture
def obj_file(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "f 1/1 2/2 3/3\n"
        "f 1/1/1 2/2/2 4/3/3\n"
        "f 1 2 3\n")
    return str(p)


def test_obj_fallback_parse(obj_file):
    pos, uv, fv, fvt = fallback.parse_obj_py(obj_file)
    assert pos.shape == (4, 3)
    assert uv.shape == (3, 2)
    assert fv.shape == (3, 3)
    np.testing.assert_array_equal(fv[0], [0, 1, 2])
    np.testing.assert_array_equal(fvt[0], [0, 1, 2])
    np.testing.assert_array_equal(fvt[2], [-1, -1, -1])


@pytest.mark.skipif(not HAS_NATIVE, reason="native lib unavailable")
def test_obj_native_matches_fallback(obj_file):
    n = native.parse_obj_native(obj_file)
    f = fallback.parse_obj_py(obj_file)
    for a, b in zip(n, f):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def big_obj_file(tmp_path):
    """A model-sized OBJ (an icosphere: 3840 vertices, uv'd faces)."""
    from tpuray.scene.procedural import icosphere
    tris = icosphere(3).reshape(-1, 3)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in tris]
    lines += [f"vt {u:.4f} {v:.4f}" for u, v in (tris[:, :2] * 0.5 + 0.5)]
    lines += [f"f {i}/{i} {i + 1}/{i + 1} {i + 2}/{i + 2}"
              for i in range(1, len(tris) + 1, 3)]
    p = tmp_path / "model.obj"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.skipif(not HAS_NATIVE, reason="native lib unavailable")
def test_obj_native_matches_fallback_clock(big_obj_file):
    path = big_obj_file
    n = native.parse_obj_native(path)
    f = fallback.parse_obj_py(path)
    assert n[0].shape[0] > 1000
    for a, b in zip(n, f):
        np.testing.assert_array_equal(a, b)


def test_load_obj_normalizes_and_transforms(obj_file):
    geo = load_obj(obj_file, transform_matrix(translate=(1, 2, 3), scale=(2, 2, 2)))
    p = geo["positions"]
    assert p.shape == (3, 3, 3)
    # unit-box normalize (extent 1) then scale 2 + translate
    np.testing.assert_allclose(p[0, 0], [1, 2, 3], atol=1e-5)
    np.testing.assert_allclose(p[0, 1], [3, 2, 3], atol=1e-5)
    n = geo["normals"]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


def test_hdr_roundtrip(tmp_path, rng):
    img = (rng.random((16, 32, 3)) * 50.0).astype(np.float32)
    path = str(tmp_path / "test.hdr")
    fallback.write_hdr_py(path, img)
    back = fallback.read_hdr_py(path)
    assert back.shape == img.shape
    # RGBE quantization: error bounded by the max channel / 256 (truncation)
    bound = img.max(axis=-1, keepdims=True) / 128.0 + 1e-4
    assert (np.abs(back - img) <= bound).all()


@pytest.mark.skipif(not HAS_NATIVE, reason="native lib unavailable")
def test_hdr_native_matches_fallback(tmp_path, rng):
    img = (rng.random((8, 16, 3)) * 10.0).astype(np.float32)
    p1 = str(tmp_path / "n.hdr")
    p2 = str(tmp_path / "f.hdr")
    assert native.write_hdr_native(p1, img)
    fallback.write_hdr_py(p2, img)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    np.testing.assert_array_equal(native.read_hdr_native(p1),
                                  fallback.read_hdr_py(p1))


def test_bmp_roundtrip(tmp_path, rng):
    img = (rng.random((7, 9, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "t.bmp")
    fallback.write_bmp_py(path, img)
    back = fallback.read_bmp_py(path)
    np.testing.assert_array_equal(back[..., :3], img)
    if HAS_NATIVE:
        np.testing.assert_array_equal(native.read_bmp_native(path), back)


def test_env_cache_native_matches_fallback(rng):
    img = (rng.random((16, 32, 3)) ** 2 * 20).astype(np.float32)
    f = fallback.env_cache_py(img)
    if HAS_NATIVE:
        n = native.env_cache_native(img)
        np.testing.assert_allclose(n, f, atol=1e-6)
    # cache invariants: sample coords in [0,1), pdf sums to 1
    assert (f[..., 0] >= 0).all() and (f[..., 0] < 1).all()
    assert (f[..., 1] >= 0).all() and (f[..., 1] < 1).all()
    np.testing.assert_allclose(f[..., 2].sum(), 1.0, atol=1e-5)


def _write_tga(path, img, rle=False, origin_top=False):
    """Minimal TGA writer for decoder tests (24bpp BGR)."""
    h, w = img.shape[:2]
    desc = 0x20 if origin_top else 0
    hdr = bytes([0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                 w & 0xFF, w >> 8, h & 0xFF, h >> 8, 24, desc])
    rows = img if origin_top else img[::-1]
    bgr = rows[..., ::-1].reshape(-1, 3)
    if not rle:
        body = bgr.tobytes()
    else:
        out = bytearray()
        i = 0
        px = bgr.tolist()
        n = len(px)
        while i < n:
            run = 1
            while (i + run < n and run < 128 and px[i + run] == px[i]
                   and (i + run) % w != 0):
                run += 1
            if run > 1:
                out.append(0x80 | (run - 1))
                out.extend(px[i])
                i += run
            else:
                j = i + 1
                while (j < n and j - i < 128 and j % w != 0
                       and (j + 1 >= n or px[j + 1] != px[j])):
                    j += 1
                out.append((j - i) - 1)
                for k in range(i, j):
                    out.extend(px[k])
                i = j
        body = bytes(out)
    with open(path, "wb") as f:
        f.write(hdr + body)


def test_tga_decode(tmp_path, rng):
    from tpuray.io.image import read_tga
    img = (rng.random((6, 5, 3)) * 255).astype(np.uint8)
    for rle in (False, True):
        for top in (False, True):
            p = str(tmp_path / f"t_{rle}_{top}.tga")
            _write_tga(p, img, rle=rle, origin_top=top)
            got = read_tga(p)
            np.testing.assert_array_equal(
                (got * 255 + 0.5).astype(np.uint8), img)


def test_read_image_dispatch(tmp_path, rng):
    from tpuray.io.image import read_image, write_bmp, write_png
    img = (rng.random((5, 7, 3)) * 255).astype(np.uint8)
    pb = str(tmp_path / "a.bmp")
    pp = str(tmp_path / "a.png")
    pt = str(tmp_path / "a.tga")
    write_bmp(pb, img)
    write_png(pp, img)
    _write_tga(pt, img)
    for p in (pb, pp, pt):
        got = read_image(p)
        assert got.shape == (5, 7, 3) and got.dtype == np.float32
        np.testing.assert_array_equal((got * 255 + 0.5).astype(np.uint8), img)
    # HDR dispatch keeps dynamic range
    fimg = (rng.random((4, 8, 3)) * 10).astype(np.float32)
    ph = str(tmp_path / "a.hdr")
    fallback.write_hdr_py(ph, fimg)
    got = read_image(ph)
    assert got.max() > 1.5
    # JPEG via PIL (baked into this container)
    try:
        from PIL import Image
        pj = str(tmp_path / "a.jpg")
        Image.fromarray(np.zeros((4, 4, 3), np.uint8) + 128).save(pj)
        got = read_image(pj)
        assert got.shape == (4, 4, 3)
        np.testing.assert_allclose(got, 128 / 255.0, atol=0.02)
    except ImportError:
        pass


def test_asset_root_resolution(tmp_path, monkeypatch):
    from tpuray.io import filesystem
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "thing.obj").write_text("v 0 0 0\n")
    with pytest.raises(FileNotFoundError):
        filesystem.resolve("models/thing.obj")
    monkeypatch.setenv("TPURAY_ASSET_ROOT", str(tmp_path))
    assert filesystem.resolve("models/thing.obj") == str(
        tmp_path / "models" / "thing.obj")
    monkeypatch.delenv("TPURAY_ASSET_ROOT")
    filesystem.add_root(tmp_path)
    try:
        assert filesystem.resolve("models/thing.obj").endswith("thing.obj")
    finally:
        filesystem._extra_roots.clear()
    # absolute and cwd-relative paths pass through
    assert filesystem.resolve(str(tmp_path / "models" / "thing.obj"))


def test_texture_layer_from_file(tmp_path, rng):
    from tpuray.scene.builder import _load_texture_layer
    from tpuray.io.image import write_png
    img = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "alb.png")
    write_png(p, img)
    got = _load_texture_layer(p)
    np.testing.assert_array_equal((got * 255 + 0.5).astype(np.uint8), img)
    arr = rng.random((4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(_load_texture_layer(arr), arr)
