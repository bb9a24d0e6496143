"""Config / CLI system (a copy of `gsjax/config.py`, so the port never
imports gsjax; `get_combined_args` also takes an explicit argv).

Mirrors `arguments/__init__.py`: the model, pipeline and optimisation
parameter groups with the same flag names and defaults (listed fields get one-letter shorthands),
and the `cfg_args` dump + merge used by inference tools
(`get_combined_args`, :125-145). The dump is a plain repr-style Namespace
string for compatibility, parsed back without `eval`.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys


class GroupParams:
    pass


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

    def extract(self, args) -> GroupParams:
        g = GroupParams()
        for k in self._defaults():
            setattr(g, k, getattr(args, k))
        return g


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

    def extract(self, args):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


class PipelineParams(ParamGroup):
    convert_SHs_python = False
    compute_cov3D_python = False
    debug = False

    def __init__(self, parser):
        super().__init__(parser, "Pipeline Parameters")


class OptimizationParams(ParamGroup):
    """arguments/__init__.py:82-123."""
    iterations = 30_000
    position_lr_init = 0.00016
    position_lr_final = 0.0000016
    position_lr_delay_mult = 0.01
    position_lr_max_steps = 30_000
    feature_dc_lr = 0.0013
    feature_rest_lr = 0.00011
    opacity_lr = 0.05
    scaling_lr = 0.005
    rotation_lr = 0.001
    sg_axis_lr = 0.002
    sg_sharpness_lr = 0.095
    sg_color = 0.00064
    appearance_embeddings_lr = 0.001
    appearance_network_lr = 0.001
    pgsr_appearance_lr = 0.001
    gs_appearance_lr_init = 0.01
    gs_appearance_lr_final = 0.001
    gs_appearance_lr_delay_steps = 0
    gs_appearance_lr_delay_mult = 0.0
    percent_dense = 0.01
    lambda_dssim = 0.2
    lambda_depth_normal = 0.05
    densification_interval = 100
    opacity_reset_interval = 3000
    densify_from_iter = 500
    densify_until_iter = 15_000
    regularization_from_iter = 7000
    densify_grad_threshold = 0.0002
    lambda_multi_view_geo = 0.02
    lambda_multi_view_ncc = 0.6
    multi_view_patch_size = 3
    multi_view_pixel_noise_th = 1.0
    # parsed but unused in the reference too (arguments/__init__.py:119)
    use_geo_occ_aware = True
    # random per-step background colour (train.py:91)
    random_background = False

    def __init__(self, parser):
        super().__init__(parser, "Optimization Parameters")


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
