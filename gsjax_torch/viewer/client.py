"""Python launcher for the native remote-viewer client (the port of
`gsjax/viewer/client.py`).

`gsjax_torch/cpp/sibr_client.cpp` is a headless stand-in for the reference's
SIBR_viewers C++ application: it speaks the remote wire protocol against a
running `python -m gsjax_torch.train --ip --port` server and writes orbit
frames as PPMs. This module builds it with `g++` at first use into
`build/gsjax_torch/` (the file name carries a hash of the source and the
flags, so an edited source is rebuilt) and runs it.

    python -m gsjax_torch.viewer.client <host> <port> [--width 960] ...
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
from pathlib import Path

from gsjax_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "cpp" / "sibr_client.cpp"
FLAGS = ("-O2", "-std=c++17")


def client_path() -> str:
    """The built `sibr_client`, compiled now if this source has no build
    yet. Raises, naming the command, when it cannot be compiled."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    exe = BUILD_DIR / f"sibr_client_{digest[:16]}"
    if exe.exists():
        return str(exe)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"no C++ compiler to build sibr_client: {' '.join(cmd)}") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building sibr_client failed: {' '.join(cmd)}\n{e.stderr}") from e
    os.replace(tmp, exe)         # atomic: a concurrent build finds a whole file
    return str(exe)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("host")
    ap.add_argument("port", type=int)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out_prefix", default="frame")
    ap.add_argument("--scaling_modifier", type=float, default=1.0)
    ap.add_argument("--radius", type=float, default=3.5)
    args = ap.parse_args(argv)
    return subprocess.call([
        client_path(), args.host, str(args.port), str(args.width), str(args.height),
        str(args.frames), args.out_prefix, str(args.scaling_modifier), str(args.radius)])


if __name__ == "__main__":
    sys.exit(main())
