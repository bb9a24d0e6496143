"""Config / CLI system (the parts of `gsjax/config.py` the render CLI uses,
copied so the port never imports gsjax; `get_combined_args` also takes an
explicit argv).

Mirrors `arguments/__init__.py`: the model and pipeline parameter groups with
the same flag names and defaults (listed fields get one-letter shorthands),
and the `cfg_args` dump + merge used by inference tools
(`get_combined_args`, :125-145). The dump is a plain repr-style Namespace
string for compatibility, parsed back without `eval`.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys


class ParamGroup:
    _shorthand: set = set()

    def __init__(self, parser: argparse.ArgumentParser, name: str, fill_none=False):
        group = parser.add_argument_group(name)
        for key, value in self._defaults().items():
            shorthand = key in self._shorthand
            t = type(value)
            v = None if fill_none else value
            flags = ["--" + key] + (["-" + key[0]] if shorthand else [])
            if t is bool:
                group.add_argument(*flags, default=v, action="store_true")
            else:
                group.add_argument(*flags, default=v, type=t)

    @classmethod
    def _defaults(cls) -> dict:
        return {k: v for k, v in vars(cls).items()
                if not k.startswith("_") and not callable(v)}


class ModelParams(ParamGroup):
    """arguments/__init__.py:47-73."""
    _shorthand = {"source_path", "model_path", "images", "dataset",
                  "resolution", "white_background"}
    sh_degree = 3
    sg_degree = 0
    source_path = ""
    model_path = ""
    images = "images"
    masks = ""
    dataset = ""
    resolution = -1
    white_background = False
    data_device = "cuda"
    eval = False
    use_decoupled_appearance = 0  # 0: NO, 1: GS, 2: GOF, 3: PGSR
    disable_filter3D = False
    kernel_size = 0.0
    multi_view_num = 8
    multi_view_max_angle = 30
    multi_view_min_dis = 0.01
    multi_view_max_dis = 1.5

    def __init__(self, parser, sentinel=False):
        super().__init__(parser, "Loading Parameters", sentinel)


class PipelineParams(ParamGroup):
    convert_SHs_python = False
    compute_cov3D_python = False
    debug = False

    def __init__(self, parser):
        super().__init__(parser, "Pipeline Parameters")


def dump_cfg_args(model_path, args):
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write("Namespace(" + ", ".join(
            f"{k}={v!r}" for k, v in sorted(vars(args).items())) + ")")


def read_cfg_args(model_path: str) -> dict:
    """Parse a model dir's saved cfg_args into a dict (safely, without the
    reference's eval(), arguments/__init__.py:125-145). Missing or malformed
    files yield {}."""
    try:
        with open(os.path.join(model_path, "cfg_args")) as f:
            s = f.read().strip()
        body = s[len("Namespace("):-1]
        tree = ast.parse(f"dict({body})", mode="eval")
        return {kw.arg: ast.literal_eval(kw.value)
                for kw in tree.body.keywords}
    except (OSError, SyntaxError, ValueError):
        return {}


def get_combined_args(parser: argparse.ArgumentParser, argv=None):
    """Merge CLI args (`argv`, default sys.argv[1:]) with the saved cfg_args
    (arguments/__init__.py:125-145), parsed safely instead of eval()."""
    args_cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    merged = read_cfg_args(args_cmdline.model_path)
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)
