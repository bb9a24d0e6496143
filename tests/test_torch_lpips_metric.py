"""The port's LPIPS (`gsjax_torch.eval.lpips`) and metric CLI
(`gsjax_torch.metric`) against gsjax's and the repository's `metric.py`.

- `lpips` against gsjax's on seeded random VGG16 + head weights laid out by
  `convert_state_dicts` (the same npz keys both load), rtol 1e-5: both sum
  float32 convolutions, XLA's and PyTorch's, in their own orders;
- `load_weights()` is None, and `lpips` returns None, without a weights file;
- the metric CLI's results.json and per_view.json against root `metric.py`'s
  on the same image tree: the same keys, PSNR and SSIM to 1e-5 (float32
  reductions in another order), LPIPS null with its status without weights,
  and to rtol 1e-5 with the random weights.
"""

import json
import os
import sys

import numpy as np
import pytest

import metric as root_metric
from gsjax.eval import lpips as jlpips
from gsjax_torch import metric as metric_cli
from gsjax_torch.eval import lpips as tlpips

TV_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
            (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512),
            (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512)]
HEADS = [64, 128, 256, 512, 512]


def random_lpips_npz(path, seed=0):
    """Seeded He-scaled VGG16 convs in torchvision's layout and positive
    heads, converted by the port's `convert_state_dicts` into `path`."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, cin, cout in TV_CONVS:
        sd[f"features.{idx}.weight"] = (rng.normal(0, 1, (cout, cin, 3, 3))
                                        * np.sqrt(2 / (9 * cin))).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
    lins = [rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32) for c in HEADS]
    arrs = tlpips.convert_state_dicts(sd, lins, path)
    want = jlpips.convert_state_dicts(sd, lins)
    assert sorted(arrs) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(arrs[k], want[k])
    return arrs


def test_lpips_matches_gsjax(tmp_path):
    weights = random_lpips_npz(str(tmp_path / "w.npz"))
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a, a)):
        want = jlpips.lpips(x, y, weights)
        got = tlpips.lpips(x, y, weights)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert tlpips.lpips(a, b, weights) > 0 and tlpips.lpips(a, a, weights) == 0.0


def test_lpips_none_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("GSJAX_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert tlpips.load_weights() is None
    img = np.zeros((16, 16, 3), np.float32)
    assert tlpips.lpips(img, img) is None
    monkeypatch.delenv("GSJAX_LPIPS_WEIGHTS")
    assert tlpips.load_weights() is None


def write_tree(model, seed=0, n=3, h=48, w=64):
    """<model>/test/ours_7/{renders,gt}/#####.png of seeded images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for kind in ("renders", "gt"):
        os.makedirs(os.path.join(model, "test", "ours_7", kind))
    for i in range(n):
        gt = rng.uniform(0, 1, (h, w, 3))
        ren = np.clip(gt + rng.normal(0, 0.05 * (i + 1), gt.shape), 0, 1)
        for kind, img in (("renders", ren), ("gt", gt)):
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(model, "test", "ours_7", kind, f"{i:05d}.png"))


def read_json(model):
    out = []
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(model, name)) as f:
            out.append(json.load(f))
    return out


def assert_close_tree(got, want, rtol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_close_tree(got[k], want[k], rtol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    else:
        assert got == want


@pytest.mark.parametrize("weights", [False, True], ids=["no_lpips", "random_lpips"])
def test_metric_cli_matches_root(tmp_path, monkeypatch, weights):
    if weights:
        random_lpips_npz(str(tmp_path / "w.npz"))
        monkeypatch.setenv("GSJAX_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    else:
        monkeypatch.delenv("GSJAX_LPIPS_WEIGHTS", raising=False)
    for side in ("root", "port"):
        write_tree(str(tmp_path / side))
    monkeypatch.setattr(sys, "argv", ["metric.py", "-m", str(tmp_path / "root")])
    root_metric.main()
    got = metric_cli.main(["-m", str(tmp_path / "port"), "--device", "cpu"])
    want_full, want_views = read_json(str(tmp_path / "root"))
    got_full, got_views = read_json(str(tmp_path / "port"))
    assert got == {str(tmp_path / "port"): got_full}
    assert_close_tree(got_full, want_full, 1e-5)
    assert_close_tree(got_views, want_views, 1e-5)
    m = got_full["ours_7"]
    assert m["LPIPS_status"] == ("ok" if weights else "weights unavailable")
    assert (m["LPIPS"] is None) != weights
    assert 15 < m["PSNR"] < 40 and 0 < m["SSIM"] < 1
