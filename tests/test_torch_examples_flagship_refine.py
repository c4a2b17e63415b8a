"""The flagship chain's two RefineNet studies end to end on the CPU at their
--quick tier (mofanerf_tpu_torch/examples/refine_synthetic.py and
refine_nerf_corpus.py; the other scripts in
tests/test_torch_examples_flagship_e2e.py): refine_synthetic on its own
rasterized cube (64x64, 60 steps; its gate is off at --quick, as in its JAX
script), refine_nerf_corpus through the two corpus CLIs on a tiny face family
of the port's `make_face_dataset` (2 identities x 2 expressions, every sixth
view), rendered at 16x16 by its --small_model (seeded 2x8 + 2x16: there is no
run of those dims to read), 80 GAN steps with the random-init VGG19 term. Each
JSON holds the top-level keys its JAX script writes plus "device"
(`_flagship.JSON_KEYS`), every reading finite.
"""
import pytest
import torch

from mofanerf_tpu_torch.datagen.synthetic_faces import make_face_dataset
from mofanerf_tpu_torch.examples import refine_nerf_corpus, refine_synthetic
from tests.test_torch_examples_flagship_e2e import CPU, _check


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_refine_synthetic_quick(tmp_path):
    out = tmp_path / "refine_quality.json"
    result, _ = refine_synthetic.main(CPU + ["--quick", "--out", str(tmp_path),
                                             "--artifacts", str(out)])
    j = _check(result, out, "refine_synthetic")
    assert j["steps"] == 60 and len(j["per_view"]) == 8


def test_refine_nerf_corpus_quick(tmp_path):
    data = tmp_path / "faces"
    make_face_dataset(str(data), n_ids=2, exp_ids=(0, 1), res=32, view_stride=6, n_holdout=4,
                      n_lat=16, n_lon=24, device="cpu")
    model = ["--data", str(data), "--basedir", str(tmp_path / "logs"), "--n_ids", "2"]
    out = tmp_path / "refine_nerf_quality.json"
    result, _ = refine_nerf_corpus.main(model + CPU + [
        "--quick", "--small_model", "--expname", "untrained", "--white_bkgd", "--res", "16",
        "--corpus_dir", str(tmp_path / "corpus"), "--out_json", str(out)])
    j = _check(result, out, "refine_nerf_corpus")
    assert j["corpus"]["pairs"] == 6 and j["corpus"]["heldout"] == 2 and j["steps"] == 80
    assert "torch generator" in j["vgg_note"]
