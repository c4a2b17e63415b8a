"""The port's data generation (mofanerf_tpu_torch/datagen/ and
cli/align_clip.py) against the JAX package's, on the same seeded inputs.

Held: mesh IO and the align/clip CLI's OBJs equal; the synthetic face family's
arrays bit-equal; the rasterizer at 64^2 with hit masks equal, depth within
1e-5 relative and colours equal, ties included (a pixel's winning fragments
within 1e-6 of its depth resolve to the largest fragment index, the order
XLA's CPU scatter leaves); `make_face_dataset` at res 32 with its JSONs,
`.npy` files and RGBA frames equal. The UV JPEGs differ by design: the
port's encoder writes 4:4:4 where the JAX package's Pillow writes 4:2:0, both
at quality 75; the decoded maps are held within 12 levels at most and 2.5 on
average of each other.
"""
import json
import os

import numpy as np
import pytest
import torch

from mofanerf_tpu.datagen import mesh as jmesh
from mofanerf_tpu.datagen import multiview as jmv
from mofanerf_tpu.datagen import rasterize as jras
from mofanerf_tpu.datagen import synthetic_faces as jsf
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu_torch.cli import align_clip
from mofanerf_tpu_torch.data.facescape import load_facescape_data
from mofanerf_tpu_torch.datagen import mesh as tmesh
from mofanerf_tpu_torch.datagen import multiview as tmv
from mofanerf_tpu_torch.datagen import rasterize as tras
from mofanerf_tpu_torch.datagen import synthetic_faces as tsf
from mofanerf_tpu_torch.utils.image_io import imread


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cube(size=1.0):
    v = np.array([[x, y, z] for x in (-size, size) for y in (-size, size) for z in (-size, size)],
                 np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def test_mesh_io_and_ops_match_jax(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nf 1/1 2/1 3/1 4/1\n")
    for got, want in zip(tmesh.load_obj(str(path)), jmesh.load_obj(str(path))):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    v, f = _cube(1.5)
    tmesh.save_obj(str(tmp_path / "t.obj"), v, f)
    jmesh.save_obj(str(tmp_path / "j.obj"), v, f)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    Rt = np.eye(4)
    Rt[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    Rt[:3, 3] = [0.5, -1, 2]
    np.testing.assert_array_equal(tmesh.apply_rt_scale(v, 0.3, Rt), jmesh.apply_rt_scale(v, 0.3, Rt))
    for c in (None, np.array([1.0, 1.0, 1.0])):
        np.testing.assert_array_equal(tmesh.clip_faces_by_distance(v, f, 2.0, c),
                                      jmesh.clip_faces_by_distance(v, f, 2.0, c))


def test_align_clip_cli_writes_the_jax_clis_objs(tmp_path, capsys):
    from mofanerf_tpu.cli import align_clip as jcli

    scans = tmp_path / "scans"
    rng = np.random.default_rng(0)
    for old in ("5", "9"):
        (scans / old).mkdir(parents=True)
        for exp in ("1_neutral", "2_smile"):
            v = rng.normal(0, 1, (30, 3))
            f = rng.integers(0, 30, (40, 3)).astype(np.int32)
            jmesh.save_obj(str(scans / old / f"{exp}.obj"), v, f)
    rt = {f"{old}_{exp}": [float(rng.uniform(0.5, 2)), np.eye(4).tolist()]
          for old in ("5", "9") for exp in ("1_neutral", "2_smile")}
    del rt["9_2_smile"]
    (tmp_path / "rt.json").write_text(json.dumps(rt))
    np.save(tmp_path / "maxd.npy", np.full(20, 2.5))
    (tmp_path / "order.txt").write_text("12 5\n3 9\n")
    args = ["--scans_dir", str(scans), "--rt_scale_json", str(tmp_path / "rt.json"),
            "--max_distance_npy", str(tmp_path / "maxd.npy"),
            "--order_map", str(tmp_path / "order.txt")]
    jcli.main(args + ["--out_dir", str(tmp_path / "j")])
    want_log = capsys.readouterr().out
    align_clip.main(args + ["--out_dir", str(tmp_path / "t")])
    assert capsys.readouterr().out.replace(str(tmp_path / "t"), "") \
        == want_log.replace(str(tmp_path / "j"), "")
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "j")
                   for r, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert files == ["12/1_neutral.obj", "12/2_smile.obj", "3/1_neutral.obj"]
    for rel in files:
        assert (tmp_path / "t" / rel).read_text() == (tmp_path / "j" / rel).read_text()


def test_synthetic_face_arrays_bit_equal():
    assert tsf.EXPRESSION_PARAMS == jsf.EXPRESSION_PARAMS
    p_t, p_j = tsf.sample_identity_params(3, 4), jsf.sample_identity_params(3, 4)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(tsf.shape_code_from_params(p_t), jsf.shape_code_from_params(p_j))
    for exp in (0, 3, 11, 17, 25):
        for got, want in zip(tsf.face_mesh(p_t[1], exp, 16, 24), jsf.face_mesh(p_j[1], exp, 16, 24)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(tsf.face_landmarks(p_t[2], exp),
                                      jsf.face_landmarks(p_j[2], exp))
        np.testing.assert_array_equal(tsf.face_uv_map(p_t[0], exp, 32),
                                      jsf.face_uv_map(p_j[0], exp, 32))


@pytest.mark.parametrize("view", [(0.0, 0.0), (37.0, -15.0), (-80.0, 30.0)],
                         ids=["front", "three_quarter", "profile"])
def test_rasterize_mesh_matches_jax(view):
    p = jsf.sample_identity_params(2, 0)[1]
    v, f, albedo = jsf.face_mesh(p, 1, 32, 48)
    K = np.array([[150.0, 0, 32], [0, 150.0, 32], [0, 0, 1]])
    c2w = pose_spherical(view[0], view[1], 16.0)
    want = jras.rasterize_mesh(v, f, K, c2w, 64, 64, face_albedo=albedo)
    got = tras.rasterize_mesh(v, f, K, c2w, 64, 64, face_albedo=albedo, device="cpu")
    np.testing.assert_array_equal(got[2], want[2])
    hit = want[2]
    assert 200 < hit.sum() < 64 * 64
    np.testing.assert_allclose(got[1][hit], want[1][hit], rtol=1e-5)
    assert np.isinf(got[1][~hit]).all()
    np.testing.assert_array_equal(got[0], want[0])
    # the uniform base colour when no albedo is given
    want = jras.rasterize_mesh(v, f, K, c2w, 64, 48, light_dir=(0.3, 0.2, 1.0))
    got = tras.rasterize_mesh(v, f, K, c2w, 64, 48, light_dir=(0.3, 0.2, 1.0), device="cpu")
    np.testing.assert_array_equal(got[0], want[0])


def test_rasterize_ties_resolve_as_jax_does():
    """A quad drawn three times in three colours: every hit pixel has three
    winners at exactly the same depth; JAX's last write (the largest
    fragment index) and the port's scatter-max agree on the third colour."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    f = np.array([[0, 1, 2], [0, 2, 3]] * 3, np.int32)
    albedo = np.repeat(np.eye(3, dtype=np.float32), 2, 0)
    K = np.array([[200.0, 0, 32], [0, 200.0, 32], [0, 0, 1]])
    c2w = pose_spherical(10.0, -5.0, 16.0)
    want = jras.rasterize_mesh(v, f, K, c2w, 64, 64, face_albedo=albedo)
    got = tras.rasterize_mesh(v, f, K, c2w, 64, 64, face_albedo=albedo, device="cpu")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    colours = np.unique(got[0][got[2]], axis=0)
    assert len(colours) == 1 and colours[0][2] > 0 and colours[0][:2].max() == 0


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_make_face_dataset_matches_jax(tmp_path, capsys):
    kw = dict(n_ids=2, exp_ids=(0, 2), res=32, seed=1, view_stride=12, n_holdout=4,
              n_lat=12, n_lon=16)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jsf.make_face_dataset(jd, **kw)
    got = tsf.make_face_dataset(td, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert _files(td) == _files(jd)
    for rel in _files(jd):
        a, b = os.path.join(jd, rel), os.path.join(td, rel)
        if rel.endswith(".json"):
            assert json.load(open(b)) == json.load(open(a)), rel
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a), err_msg=rel)
        elif rel.endswith(".png"):
            assert imread(b).shape == (32, 32, 4)
            np.testing.assert_array_equal(imread(b), imread(a), err_msg=rel)
        else:   # the UV maps: 4:4:4 against Pillow's 4:2:0
            from PIL import Image

            ja = np.asarray(Image.open(a)).astype(int)
            tb = imread(b).astype(int)
            assert tb.shape == ja.shape == (256, 256, 3)
            assert np.abs(tb - ja).max() <= 12 and np.abs(tb - ja).mean() < 2.5, rel
    assert np.load(os.path.join(td, "landmarks.npy")).shape == (300, 20, 68, 3)
    # the port's loader reads it, with the split counts the JSONs list
    codes = np.load(os.path.join(td, "factors_id.npy"))
    ds = load_facescape_data(td, [0, 1], codes, uvdir=os.path.join(td, "uv"), testskip=1)
    n_frames = sum(len(json.load(open(os.path.join(td, f"transforms_{s}_{i}.json")))["frames"])
                   for s in ("train", "val", "test") for i in (0, 1))
    assert len(ds.image_paths) == n_frames == 2 * 2 * 10
    # a second call renders nothing; a changed config raises the guard's error
    capsys.readouterr()
    tsf.make_face_dataset(td, device="cpu", **kw)
    assert capsys.readouterr().out.count("skip existing id") == 2
    with pytest.raises(RuntimeError, match="different config"):
        tsf.make_face_dataset(td, device="cpu", **{**kw, "seed": 2})


def test_render_identity_and_parallel_fan_out(tmp_path):
    """render_identity's splits and RGBA frames against JAX's; two spawn
    workers write what one process writes."""
    v, f = _cube(1.2)
    jmv.render_identity(7, {0: (v, f), 3: (v, f)}, str(tmp_path / "j"), n_holdout=6, res=24,
                        view_stride=8)
    tmv.render_identity(7, {0: (v, f), 3: (v, f)}, str(tmp_path / "t"), n_holdout=6, res=24,
                        view_stride=8, device="cpu")
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for rel in _files(tmp_path / "j"):
        if rel.endswith(".json"):
            assert json.load(open(tmp_path / "t" / rel)) == json.load(open(tmp_path / "j" / rel))
        else:
            np.testing.assert_array_equal(imread(str(tmp_path / "t" / rel)),
                                          imread(str(tmp_path / "j" / rel)))
    params = tsf.sample_identity_params(2, 3)
    loader = tsf._FaceMeshLoader(params, (0,), 8, 12)
    kw = dict(res=16, view_stride=40, n_holdout=1, seed=3, device="cpu")
    tmv.render_identities_parallel([0, 1], loader, str(tmp_path / "serial"), **kw)
    tmv.render_identities_parallel([0, 1], loader, str(tmp_path / "pool"), n_workers=2, **kw)
    assert _files(tmp_path / "pool") == _files(tmp_path / "serial")
    for rel in _files(tmp_path / "serial"):
        with open(tmp_path / "pool" / rel, "rb") as a, open(tmp_path / "serial" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    assert tmv.camera_angle_x() == jmv.camera_angle_x()
    for a, b in zip(tmv.camera_grid(), jmv.camera_grid()):
        np.testing.assert_array_equal(a, b)
