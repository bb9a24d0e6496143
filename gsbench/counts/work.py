"""The operations a whole training step or a served frame needs, fixed by the
work and not by the code that does it: the `mfu.*` metrics divide it by the
traced window's time at the fp32 peak.

A step needs: the blend forward and backward (B1, B2) and the point query
forward and backward (B3, B5) as `blend.py` and `sample.py` count them on the
traced launches' inputs; the NCC's taps (B6's count) and its homographies and
window sums; L1 + SSIM; the depth-normal term; preprocess of the alive
gaussians in the reference view (with its SH and SG) and in the neighbour
view (degree 0), each with its VJP; Adam over the alive gaussians' leaves. A
frame needs B1 and preprocess. Constants count every arithmetic operation,
compare and select as one, as `blend.py` does; a VJP is charged twice its
forward.
"""

from __future__ import annotations

OPS_PREP_GEOM = 250        # projection, 3D and 2D covariance, conic, ray plane, normal, extent
OPS_PREP_SH_COEF = 8       # one SH basis term and its 3 colour FMAs
OPS_PREP_SG_LOBE = 20      # one SG lobe: axis dot, exp, sharpness, 3 colour FMAs
VJP_FACTOR = 2
OPS_L1_SSIM_PIXEL = 3 * (6 + 2 * 5 * 11 * 2 + 20)   # 3 channels: L1, 5 maps blurred 11+11 taps, formula
OPS_DEPTH_NORMAL_PIXEL = 60
NCC_TAPS = 49
OPS_NCC_TAP = 32           # the tap's homography and the ref / neighbour window sums
OPS_NCC_PIXEL = 30
OPS_ADAM_LEAF = 12


def preprocess_ops(alive: int, sh_degree: int, sg_degree: int) -> float:
    per = OPS_PREP_GEOM + OPS_PREP_SH_COEF * (sh_degree + 1) ** 2 + OPS_PREP_SG_LOBE * sg_degree
    return float(alive * per)


def step_ops(kernel_ops: float, alive: int, floats_per_gaussian: int, pixels: int,
             sh_degree: int, sg_degree: int, multi_view: bool) -> float:
    """One training step: `kernel_ops` is what B1, B2, B3, B5 and B6 need on
    its launches."""
    ops = kernel_ops
    ops += (1 + VJP_FACTOR) * preprocess_ops(alive, sh_degree, sg_degree)
    ops += (1 + VJP_FACTOR) * pixels * (OPS_L1_SSIM_PIXEL + OPS_DEPTH_NORMAL_PIXEL)
    if multi_view:
        ops += (1 + VJP_FACTOR) * preprocess_ops(alive, 0, 0)
        ops += (1 + VJP_FACTOR) * pixels * (NCC_TAPS * OPS_NCC_TAP + OPS_NCC_PIXEL)
    ops += alive * floats_per_gaussian * OPS_ADAM_LEAF
    return float(ops)


def frame_ops(kernel_ops: float, alive: int, sh_degree: int, sg_degree: int) -> float:
    """One served frame: `kernel_ops` is what its B1 launch needs."""
    return float(kernel_ops + preprocess_ops(alive, sh_degree, sg_degree))
