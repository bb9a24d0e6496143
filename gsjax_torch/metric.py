"""NVS metric CLI: PSNR / SSIM / LPIPS over rendered image trees (port of the
repository's `metric.py`).

Mirrors the reference `metric.py:36-102`: reads
<model>/test/ours_<iter>/{renders,gt}, writes results.json + per_view.json.
LPIPS requires weights (see `gsjax_torch/eval/lpips.py`); reported as null,
with an `LPIPS_status`, when unavailable. Runs on cuda unless `--device cpu`
is given.

    python -m gsjax_torch.metric -m <model> [<model> ...] [--device cpu]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch


def read_dir(path):
    from PIL import Image

    names = sorted(os.listdir(path))
    imgs = []
    for n in names:
        with Image.open(os.path.join(path, n)) as im:
            imgs.append(np.asarray(im, dtype=np.float32) / 255.0)
    return names, imgs


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns {model_path:
    results}."""
    from gsjax_torch import resolve_device
    from gsjax_torch.eval import lpips as lpips_mod
    from gsjax_torch.train import losses

    parser = ArgumentParser(description="gsjax_torch NVS metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    lp_weights = lpips_mod.load_weights()
    if lp_weights is None:
        print("WARNING: LPIPS weights not found -> reporting lpips: null.\n"
              "  Pretrained VGG16 weights cannot be downloaded offline.\n"
              "  On any machine with the `lpips` pip package, run:\n"
              "    python -m gsjax.eval.lpips lpips_vgg.npz\n"
              "  then re-run with GSJAX_LPIPS_WEIGHTS=lpips_vgg.npz.",
              flush=True)
    lp_status = "ok" if lp_weights else "weights unavailable"
    results = {}
    for model_path in args.model_paths:
        print("Scene:", model_path)
        full = {}
        per_view = {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print("  no test renders; run render first")
            continue
        for method in sorted(os.listdir(test_dir)):
            names, renders = read_dir(os.path.join(test_dir, method, "renders"))
            _, gts = read_dir(os.path.join(test_dir, method, "gt"))
            psnrs, ssims, lpipss = [], [], []
            with torch.no_grad():
                for r, g in zip(renders, gts):
                    r3 = torch.as_tensor(r[..., :3], device=dev)
                    g3 = torch.as_tensor(g[..., :3], device=dev)
                    psnrs.append(float(losses.psnr(r3, g3)))
                    ssims.append(float(losses.ssim(r3, g3)))
                    lpipss.append(lpips_mod.lpips(r3, g3, lp_weights)
                                  if lp_weights else None)
            # LPIPS stays null with a sibling status field: a string in the
            # numeric slot breaks float()/comparison consumers.
            full[method] = {
                "PSNR": float(np.mean(psnrs)),
                "SSIM": float(np.mean(ssims)),
                "LPIPS": float(np.mean(lpipss)) if lp_weights else None,
                "LPIPS_status": lp_status,
            }
            per_view[method] = {
                "PSNR": dict(zip(names, psnrs)),
                "SSIM": dict(zip(names, ssims)),
                "LPIPS": dict(zip(names, lpipss)) if lp_weights else None,
                "LPIPS_status": lp_status,
            }
            print(f"  {method}: PSNR {full[method]['PSNR']:.4f} "
                  f"SSIM {full[method]['SSIM']:.4f} "
                  f"LPIPS {full[method]['LPIPS']} ({lp_status})")
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        results[model_path] = full
    return results


if __name__ == "__main__":
    main()
