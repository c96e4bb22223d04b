"""The PyTorch port's configuration, derived constants, import isolation and
entry-point checks, against the JAX package."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sift_tpu.config import AnnConfig as JaxAnnConfig
from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.config import PipelineConfig as JaxPipelineConfig
from sift_tpu.config import RansacConfig as JaxRansacConfig
from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.pyramid import lowe_sigma_schedule as jax_schedule
from sift_tpu.kernels.gaussian import blur_matrix as jax_blur_matrix
from sift_tpu.kernels.gaussian import gaussian_kernel_1d as jax_taps

import sift_tpu_torch
from sift_tpu_torch.config import (AnnConfig, MatchConfig, PipelineConfig,
                                   RansacConfig, SiftConfig, config_from_dict)
from sift_tpu_torch.frontend.pyramid import lowe_sigma_schedule
from sift_tpu_torch.frontend.sift import extract_batch
from sift_tpu_torch.kernels.gaussian import blur_matrix, gaussian_kernel_1d

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(SiftConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxSiftConfig)}
    assert ours == theirs
    for o in range(6):
        assert SiftConfig().octave_cap(o) == JaxSiftConfig().octave_cap(o)
    assert SiftConfig().gaussians_per_octave == JaxSiftConfig().gaussians_per_octave


def test_config_from_dict_round_trips():
    jcfg = JaxSiftConfig(max_keypoints_per_octave=384, rootsift=True,
                         window_dtype="float32", dogs_per_epoch=4)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert config_from_dict(dataclasses.asdict(cfg)) == cfg
    with pytest.raises(ValueError):
        config_from_dict({"no_such_field": 1})


@pytest.mark.parametrize("ours,theirs", [(MatchConfig, JaxMatchConfig),
                                         (RansacConfig, JaxRansacConfig),
                                         (AnnConfig, JaxAnnConfig)])
def test_match_and_ransac_configs_match_jax(ours, theirs):
    assert ({f.name: f.default for f in dataclasses.fields(ours)}
            == {f.name: f.default for f in dataclasses.fields(theirs)})


@pytest.mark.parametrize("jcfg", [
    JaxMatchConfig(ratio=0.7, mutual=False, max_matches=8192, metric="dot",
                   impl="pallas"),
    JaxRansacConfig(num_hypotheses=256, inlier_threshold=3.0, refit=False),
    JaxAnnConfig(n_clusters=32, nprobe=4, bucket_capacity=256, query_tile=64),
])
def test_config_from_dict_builds_match_and_ransac_configs(jcfg):
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert type(cfg).__name__ == type(jcfg).__name__
    assert type(cfg).__module__ == "sift_tpu_torch.config"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert config_from_dict(dataclasses.asdict(cfg)) == cfg


def test_pipeline_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxPipelineConfig)}
    assert list(ours) == list(theirs)
    assert dataclasses.asdict(PipelineConfig()) == \
        dataclasses.asdict(JaxPipelineConfig())


def test_config_from_dict_builds_pipeline_config():
    jcfg = JaxPipelineConfig(
        window_size=6, kf_min_tracked=80, guided_radius=25.0,
        sift=JaxSiftConfig(max_keypoints=256),
        match=JaxMatchConfig(ratio=0.85, max_matches=256),
        ransac=JaxRansacConfig(num_hypotheses=256))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert type(cfg) is PipelineConfig
    assert type(cfg.sift) is SiftConfig and type(cfg.ba).__module__ == \
        "sift_tpu_torch.config"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert config_from_dict(dataclasses.asdict(cfg)) == cfg


@pytest.mark.parametrize("n,sigma", [(1, 1.6), (7, 1.2), (61, 2.0159),
                                     (600, 1.2489996), (488, 2.5398)])
def test_blur_matrix_bit_equal(n, sigma):
    np.testing.assert_array_equal(blur_matrix(n, sigma), jax_blur_matrix(n, sigma))
    np.testing.assert_array_equal(gaussian_kernel_1d(sigma), jax_taps(sigma))


@pytest.mark.parametrize("kw", [{}, {"dogs_per_epoch": 4, "octaves": 5},
                                {"sigma": 1.2, "k": 1.5}])
def test_sigma_schedule_bit_equal(kw):
    for a, b in zip(lowe_sigma_schedule(SiftConfig(**kw)),
                    jax_schedule(JaxSiftConfig(**kw))):
        np.testing.assert_array_equal(a, b)


def test_import_pulls_in_no_jax():
    code = ("import sys, sift_tpu_torch, sift_tpu_torch.frontend.sift\n"
            "import sift_tpu_torch.matching, sift_tpu_torch.geometry\n"
            "import sift_tpu_torch.cli, sift_tpu_torch.kernels.cuda.match\n"
            "import sift_tpu_torch.io.image, sift_tpu_torch.io.viz\n"
            "import sift_tpu_torch.ba, sift_tpu_torch.ba.pose_only\n"
            "import sift_tpu_torch.ba.intrinsics, sift_tpu_torch.io.synthetic\n"
            "import sift_tpu_torch.geometry.sim3, sift_tpu_torch.geometry.lie_np\n"
            "import sift_tpu_torch.slam, sift_tpu_torch.slam.pipeline\n"
            "import sift_tpu_torch.eval, sift_tpu_torch.eval.ate\n"
            "import sift_tpu_torch.io.datasets, sift_tpu_torch.io.trajectory\n"
            "import sift_tpu_torch.matching.global_index\n"
            "import sift_tpu_torch.utils.metrics\n"
            "import sift_tpu_torch.frontend.parity, sift_tpu_torch.kernels.resize\n"
            "import sift_tpu_torch.kernels.gradients\n"
            "import sift_tpu_torch.serve, sift_tpu_torch.matching.ann\n"
            "import sift_tpu_torch.io.checkpoint, sift_tpu_torch.io.native\n"
            "import sift_tpu_torch.utils.debug\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'orbax',\n"
            "                                       'sift_tpu')\n"
            "       or m.startswith(('jax.', 'jaxlib', 'flax.', 'orbax.',\n"
            "                        'sift_tpu.'))]\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_card_path_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs = np.zeros((1, 32, 32), np.float32)
    with pytest.raises(RuntimeError):
        extract_batch(imgs, SiftConfig())
    with pytest.raises(RuntimeError):
        sift_tpu_torch.extract(imgs[0])


def test_pallas_off_refused_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError):
        extract_batch(np.zeros((1, 32, 32), np.float32),
                      SiftConfig(pallas="off"), device="cuda")


@pytest.mark.parametrize("kw", [{"extrema_topk": "approx"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        extract_batch(np.zeros((1, 32, 32), np.float32), SiftConfig(**kw),
                      device="cpu")


@pytest.mark.parametrize("kw", [{"mode": "parity"}, {"subpixel": True},
                                {"mode": "parity", "subpixel": True}])
def test_parity_and_subpixel_need_the_card(monkeypatch, kw):
    """No CPU fall-back: without device="cpu" they run on the card or
    raise; parity keeps an exact selection under extrema_topk="approx"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32), np.float32)
    with pytest.raises(RuntimeError):
        extract_batch(img[None], SiftConfig(**kw))
    with pytest.raises(RuntimeError):
        sift_tpu_torch.extract(img, SiftConfig(**kw))
    kp = extract_batch(img[None], SiftConfig(**kw), device="cpu")
    assert kp.valid.device.type == "cpu" and not kp.valid.any()
    if kw.get("mode") == "parity":
        kp = sift_tpu_torch.extract(
            img, SiftConfig(extrema_topk="approx", **kw), device="cpu")
        assert not kp.valid.any()


def test_top_level_exports_match_jax():
    """Every name of `sift_tpu.__all__` but `MeshConfig` (dist/ is not
    ported)."""
    import sift_tpu
    missing = set(sift_tpu.__all__) - set(sift_tpu_torch.__all__)
    assert missing == {"MeshConfig"}
    for name in sift_tpu_torch.__all__:
        assert hasattr(sift_tpu_torch, name), name
    from sift_tpu_torch import PipelineConfig as Exported
    assert Exported is PipelineConfig
    assert sift_tpu_torch.__version__ == sift_tpu.__version__
