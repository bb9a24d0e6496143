"""COLMAP SfM pipeline wrapper: raw images -> sparse reconstruction (a copy of
the repository's `convert.py`: subprocess only, no torch).

Equivalent of the reference's `utils/colmap_wrapper.py:run_colmap` (LLFF-style
imgs2poses pipeline): shells out to the `colmap` CLI for feature extraction,
matching and mapping, producing the `sparse/0` layout that
`gsjax_torch.data.readers.load_scene` consumes. Requires a `colmap` binary on
PATH (not bundled); fails with a clear message otherwise.

Usage: python -m gsjax_torch.convert -s <dir-with-images/> [--match_type exhaustive]
"""

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def run_colmap(basedir: str, match_type: str = "exhaustive",
               camera_model: str = "PINHOLE", use_gpu: bool = False):
    if shutil.which("colmap") is None:
        sys.exit("convert.py: `colmap` binary not found on PATH. Install "
                 "COLMAP or provide a dataset with sparse/0 already built.")
    logfile = os.path.join(basedir, "colmap_output.txt")
    db = os.path.join(basedir, "database.db")
    images = os.path.join(basedir, "images")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    gpu = "1" if use_gpu else "0"

    steps = [
        ["colmap", "feature_extractor",
         "--database_path", db, "--image_path", images,
         "--ImageReader.single_camera", "1",
         "--ImageReader.camera_model", camera_model,
         "--SiftExtraction.use_gpu", gpu],
        ["colmap", f"{match_type}_matcher",
         "--database_path", db, "--SiftMatching.use_gpu", gpu],
        ["colmap", "mapper",
         "--database_path", db, "--image_path", images,
         "--output_path", sparse,
         "--Mapper.num_threads", "16",
         "--Mapper.init_min_tri_angle", "4",
         "--Mapper.multiple_models", "0",
         "--Mapper.extract_colors", "0"],
    ]
    with open(logfile, "w") as log:
        for cmd in steps:
            print("running:", " ".join(cmd), flush=True)
            out = subprocess.run(cmd, capture_output=True, text=True)
            log.write(out.stdout + out.stderr)
            if out.returncode != 0:
                sys.exit(f"convert.py: `{cmd[1]}` failed "
                         f"(exit {out.returncode}); see {logfile}")
    print(f"sparse model written under {sparse}; log at {logfile}")


def main():
    parser = ArgumentParser(description="COLMAP conversion")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--match_type", default="exhaustive",
                        choices=["exhaustive", "sequential"])
    parser.add_argument("--camera_model", default="PINHOLE")
    parser.add_argument("--use_gpu", action="store_true")
    args = parser.parse_args()
    run_colmap(args.source_path, args.match_type, args.camera_model,
               args.use_gpu)


if __name__ == "__main__":
    main()
