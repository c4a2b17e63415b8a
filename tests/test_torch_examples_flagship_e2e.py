"""The flagship chain's scripts (mofanerf_tpu_torch/examples) end to end on
the CPU, each at its quick or small tier, on one tiny face family of the
port's `make_face_dataset` (2 identities x 2 expressions, 32x32, every sixth
view): morphable_flagship trains its --small model 12 steps and evaluates it;
the others read that run (serve_flagship and fit_quality at --small_model run
their own seeded 2x8 + 2x16 model, as the JAX scripts do). The two RefineNet
studies run in tests/test_torch_examples_flagship_refine.py. Each JSON holds
the top-level keys its JAX script writes plus "device" (`_flagship.
JSON_KEYS`), every reading finite, and the gates that hold at this size hold
(fit_quality's gate is off at --quick in its JAX script too). morphable_scaling on the JAX package's artifacts/ reproduces
the JAX script's output and, without the later morphable32nc.json, the
committed artifacts/morphable_scaling.json. run_studies gives each chain
script its JSON and working directories under its output directory.
"""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mofanerf_tpu_torch.datagen.synthetic_faces import make_face_dataset
from mofanerf_tpu_torch.examples import (_flagship, expression_matrix, fit_quality,
                                         morphable_flagship, morphable_scaling, run_studies,
                                         serve_flagship, wild_demo)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(model flags, directory) of a morphable_flagship --small run of 12 steps on the
    tiny family, and its evaluation's JSON."""
    root = tmp_path_factory.mktemp("chain")
    data = root / "faces"
    make_face_dataset(str(data), n_ids=2, exp_ids=(0, 1), res=32, view_stride=6, n_holdout=4,
                      n_lat=16, n_lon=24, device="cpu")
    model = ["--data", str(data), "--basedir", str(root / "logs"), "--n_ids", "2"]
    result, timing = morphable_flagship.main(
        model + CPU + ["--small", "--white_bkgd", "--iters", "12", "--n_test_views", "1",
                       "--exp_matrix_ids", "1", "--out_json", str(root / "eval" / "m.json")])
    return model, root, result, timing


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or bool(np.isfinite(tree))


def _check(result, path, study, extra=()):
    with open(path) as f:
        written = json.load(f)
    assert json.loads(json.dumps(result)) == written
    assert set(written) == _flagship.JSON_KEYS[study] | set(extra)
    assert _finite(written)
    return written


def test_morphable_flagship_trains_and_evaluates(run):
    _, root, result, timing = run
    j = _check(result, root / "eval" / "m.json", "morphable_flagship",
               ["expression_transfer_matrix"])
    assert j["model"] == {"coarse": [2, 16], "fine": [2, 32], "n_samples": [8, 8], "step": 12}
    assert timing["train_steps"] == 12 and j["device"] == "cpu"
    assert [e["exp"] for e in j["expression_control"]] == [0, 1]
    assert [r["t"] for r in j["identity_interpolation"]] == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert (root / "eval" / "m_gallery.png").exists() and (root / "eval" / "m_interp.png").exists()
    log = (root / "logs" / "morphable_flagship" / "train_log.txt").read_text()
    assert "Iteration 10 " in log


def test_serve_flagship_quick(run, tmp_path):
    model, *_ = run
    out = tmp_path / "serve_flagship.json"
    result, timing = serve_flagship.main(model + CPU + ["--quick", "--small_model", "--expname",
                                                        "untrained", "--ids", "0,1",
                                                        "--out_json", str(out)])
    j = _check(result, out, "serve_flagship")
    assert [r["person"] for r in j["per_identity"]] == [0, 1]
    assert j["student"] == "quick smoke" and j["fused_rays_per_sec"] is None   # no card
    assert timing["throughput_loop"] is None and timing["distill_steps"] == 120
    assert (tmp_path / "serve_flagship_id1.png").exists()


def test_fit_quality_quick(run, tmp_path):
    model, *_ = run
    out = tmp_path / "fit_quality.json"
    result, _ = fit_quality.main(model + CPU + ["--quick", "--small_model", "--person", "1",
                                                "--out_dir", str(tmp_path / "fit"),
                                                "--out_json", str(out)])
    j = _check(result, out, "fit_quality")
    assert j["model_step"] == 0 and j["schedule"]["iters"] == 60
    assert j["pose_recovery"]["init_rot_err_deg"] > 0
    assert sorted(p.name for p in (tmp_path / "fit" / "rendering").iterdir()) == [
        "novel_yaw+000.png", "novel_yaw+060.png", "novel_yaw-060.png"]


def test_expression_matrix_small(run, tmp_path):
    model, *_ = run
    out = tmp_path / "expression_matrix.json"
    result, _ = expression_matrix.main(model + CPU + ["--small", "--expname",
                                                      "morphable_flagship", "--ids", "2",
                                                      "--poses", "1", "--out_json", str(out)])
    j = _check(result, out, "expression_matrix")
    assert j["step"] == 12 and j["bank"] == [0, 1] and set(j["per_id"]) == {"0", "1"}
    assert np.array(j["per_id"]["0"]["matrix_psnr_db"]).shape == (2, 2)


def test_wild_demo_quick(run, tmp_path):
    model, *_ = run
    out = tmp_path / "wild_demo.json"
    result, _ = wild_demo.main(model + CPU + [
        "--quick", "--small_model", "--synthetic_photos", "2",
        "--work_dir", str(tmp_path / "wild"), "--out_json", str(out),
        "--out_png", str(tmp_path / "wild_demo.png")])
    j = _check(result, out, "wild_demo")
    assert [r["photo"] for r in j["photos"]] == ["1"] and j["photos"][0]["iters"] == 60
    assert sorted(p.name for p in (tmp_path / "wild_photos").iterdir()) == ["1.png", "2.png"]
    assert (tmp_path / "wild" / "fitting" / "segRelRes_1_white" / "fit_final.png").exists()


def _jax_morphable_scaling(out):
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_morphable_scaling",
                                                  REPO / "examples" / "morphable_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["morphable_scaling.py", "--out_json", str(out)]
    try:
        mod.main()
    finally:
        sys.argv = saved
    with open(out) as f:
        return json.load(f)


def test_morphable_scaling_reproduces_the_jax_tables(tmp_path):
    arts = REPO / "artifacts"
    out = tmp_path / "scaling.json"
    result, _ = morphable_scaling.main(["--artifacts_dir", str(arts), "--out_json", str(out)])
    _check(result, out, "morphable_scaling")
    assert result == _jax_morphable_scaling(tmp_path / "jax.json")
    # the committed artifact predates morphable32nc.json, which both scripts now prefer
    older = tmp_path / "older"
    shutil.copytree(arts, older, ignore=shutil.ignore_patterns("morphable32nc.json", "*.png"))
    result, _ = morphable_scaling.main(["--artifacts_dir", str(older), "--out_json", str(out)])
    with open(arts / "morphable_scaling.json") as f:
        assert result == json.load(f)


def test_morphable_scaling_skips_what_it_lacks(run, tmp_path):
    _, root, *_ = run
    shutil.copy(root / "eval" / "m.json", tmp_path / "morphable_flagship.json")
    result, _ = morphable_scaling.main(["--artifacts_dir", str(tmp_path),
                                        "--out_json", str(tmp_path / "s.json")])
    assert [p["n_ids"] for p in result["points"]] == [8] and result["resolution_points"] == []
    assert result["points"][0]["train_step"] == 12


@pytest.mark.parametrize("study, want", [
    ("morphable_flagship", ["--out_json", "O/morphable_flagship.json", "--basedir", "B"]),
    ("fit_quality", ["--out_json", "O/fit_quality.json", "--out_dir", "O/fit", "--basedir", "B"]),
    ("refine_nerf_corpus", ["--out_json", "O/refine_nerf_quality.json", "--corpus_dir",
                            "O/corpus", "--basedir", "B"]),
    ("wild_demo", ["--out_json", "O/wild_demo.json", "--work_dir", "O/wild", "--out_png",
                   "O/wild_demo.png", "--basedir", "B"]),
    ("refine_synthetic", ["--out", "O", "--artifacts", "O/refine_quality.json"]),
    ("morphable_scaling", ["--out_json", "O/morphable_scaling.json"]),
    ("distill_morphable", ["--out", "O"]),
    ("texture_synthetic", ["O"]),
])
def test_run_studies_places_each_studys_outputs(study, want):
    assert run_studies.study_argv(study, "O", ["--x"], "B") == want + ["--x"]
