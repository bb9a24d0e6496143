"""The port's layer spans (`gsjax_torch/utils/spans.py`) and the trainer's
frame-upload counter, on the CPU.

Under torch.profiler one `Trainer.step` with a neighbour (multi-view terms
on) on a small rendered scene, and one `api.render`, record exactly the
spans of `spans.SPANS` their paths reach, each inside the span the layer
table puts it in; a backward node of `raster.preprocess` names its forward
op inside that span by `(fwd_thread, sequence_nr)`, the link a trace reader
follows from the autograd engine's kernels. With no profiler a span enters
no profiler range. `metrics["gt_upload_bytes"]` is the bytes of the frames
the step missed in the trainer's cache, and 0 when the same views come back.
"""

import random
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsjax_torch.config import OptimizationParams
from gsjax_torch.data.readers import build_nearest_view_graph, load_scene
from gsjax_torch.data.synth import write_rendered_colmap
from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster import RasterConfig, render
from gsjax_torch.train.loop import Trainer
from gsjax_torch.utils import spans

torch.set_num_threads(1)
W, H = 48, 32

# each span the step reaches and the spans it may sit in (the neighbour's
# preprocess, binning and pair gather run inside `sample.prepare`; on the
# CPU the autograd engine runs the backward on the caller's thread)
STEP_PARENTS = {
    "train_step": {None},
    "train.frames": {"train_step"},
    "model.activate": {"train_step"},
    "raster.render": {"train_step"},
    "raster.preprocess": {"raster.render", "sample.prepare"},
    "raster.binning": {"raster.render", "sample.prepare"},
    "raster.pairs": {"raster.render", "sample.prepare"},
    "raster.blend": {"raster.render"},
    "loss.image": {"train_step"},
    "loss.depth_normal": {"train_step"},
    "mv.patchmatch": {"train_step"},
    "mv.geo": {"mv.patchmatch"},
    "sample.prepare": {"mv.geo"},
    "sample.query": {"mv.geo"},
    "mv.ncc": {"mv.patchmatch"},
    "ncc.sample": {"mv.ncc"},
    "step.backward": {"train_step"},
    "raster.blend_bwd": {"step.backward"},
    "sample.query_bwd": {"step.backward"},
    "step.update": {"train_step"},
    "step.readback": {"train_step"},
}
RENDER_PARENTS = {"raster.render": {None}, "raster.preprocess": {"raster.render"},
                  "raster.binning": {"raster.render"}, "raster.pairs": {"raster.render"},
                  "raster.blend": {"raster.render"}}


def _name(ev) -> str | None:
    """The span an event is (`train_step <it>` is `train_step`), or None."""
    if ev.name.startswith("train_step "):
        return "train_step"
    return ev.name if ev.name in spans.SPANS else None


def _span_of(ev) -> str | None:
    """The innermost span enclosing a host event (its own parents)."""
    p = ev.cpu_parent
    while p is not None and _name(p) is None:
        p = p.cpu_parent
    return None if p is None else _name(p)


def _recorded(prof) -> dict[str, set]:
    """{span: the spans its events sat in}."""
    out = {}
    for ev in prof.events():
        if _name(ev) is not None:
            out.setdefault(_name(ev), set()).add(_span_of(ev))
    return out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    means, scales, quats, opac, shs = write_rendered_colmap(
        str(root / "scene"), n_images=4, width=W, height=H, device="cpu")
    info = load_scene(str(root / "scene"), device="cpu")
    build_nearest_view_graph(info.train_views, 30.0, 0.01, 1.5, 8)
    assert all(v.nearest_ids for v in info.train_views)
    n, cap = len(means), 512
    pad = lambda x: np.concatenate(
        [x, np.zeros((cap - n,) + x.shape[1:], np.float32)]).astype(np.float32)
    params = dict(xyz=pad(means), features_dc=pad(shs[:, :1]), features_rest=pad(shs[:, 1:]),
                  opacity=pad(np.log(opac / (1 - opac))), scaling=pad(np.log(scales)),
                  rotation=pad(quats), sg_axis=pad(np.zeros((n, 1, 3))),
                  sg_sharpness=pad(np.zeros((n, 1))), sg_color=pad(np.zeros((n, 1, 3))))
    params["rotation"][n:, 0] = 1.0
    aux = dict(alive=np.arange(cap) < n, filter_3d=np.zeros(cap), grad_accum=np.zeros(cap),
               grad_accum_abs=np.zeros(cap), denom=np.zeros(cap),
               max_radii=np.zeros(cap, np.int32))
    return root, info, params, aux


def _trainer(scene) -> Trainer:
    """A trainer past densification with regularisation and the multi-view
    terms on, at gsjax's default lambdas."""
    root, info, params, aux = scene
    p, a = gm.params_from_numpy(params, aux, "cpu")
    opt = types.SimpleNamespace(**{**OptimizationParams._defaults(),
                                   "regularization_from_iter": 1})
    t = Trainer(scene=info, params=p, aux=a, adam=gm.adam_init(p), opt=opt,
                model_path=str(root / "model"), device=torch.device("cpu"),
                sh_degree=3, active_sh=3, iteration=20000)
    t.refresh_filter3d()
    return t


@pytest.fixture
def first_views(monkeypatch):
    """Every draw takes the first choice: the same view and neighbour."""
    monkeypatch.setattr(random, "choice", lambda seq: seq[0])


def test_step_records_its_spans_nested(scene, first_views):
    t = _trainer(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = t.step()
    assert m["near"] is not None and m["mv_queries"] > 0
    got = _recorded(prof)
    assert set(got) == set(STEP_PARENTS)
    for name, parents in got.items():
        assert parents <= STEP_PARENTS[name], (name, parents)
    roots = [ev.name for ev in prof.events() if ev.name.startswith("train_step ")]
    assert roots == ["train_step 20001"]


def test_render_records_its_spans_nested(scene):
    t = _trainer(scene)
    view = t.scene.train_views[0]
    scales, opac = gm.scaling_n_opacity_with_3d_filter(t.params, t.aux.filter_3d)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(t.params.xyz, scales, t.params.rotation, opac, gm.get_features(t.params),
               view.camera, RasterConfig(sh_degree=3, require_depth=True), t.bg(),
               alive=t.aux.alive)
    got = _recorded(prof)
    assert got == RENDER_PARENTS


def test_span_without_profiler_enters_nothing(scene, first_views, monkeypatch):
    """Off, a span is the one shared null context and enters no profiler
    range; on, the same code enters one range per span."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert spans.span("raster.render") is spans.span("mv.ncc")
    t = _trainer(scene)
    t.step()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        t.step()
    assert "train_step 20002" in entered and "raster.preprocess" in entered


def test_preprocess_backward_links_to_its_span(scene, first_views):
    """A backward node's (fwd_thread, sequence_nr) is its forward op's
    (thread, sequence_nr); for preprocess's ops that op sits in
    `raster.preprocess`."""
    t = _trainer(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.step()
    evs = prof.events()
    fwd = {(ev.thread, ev.sequence_nr): ev for ev in evs
           if ev.sequence_nr >= 0 and ev.fwd_thread == 0 and _name(ev) is None}
    linked = []
    for ev in evs:
        if ev.name.startswith("autograd::engine::evaluate_function: ") and ev.sequence_nr >= 0:
            op = fwd.get((ev.fwd_thread, ev.sequence_nr))
            if op is not None and _span_of(op) == "raster.preprocess":
                linked.append((ev.name.split(": ")[1], op.name))
    assert linked
    # the node is the op's own: MulBackward0 differentiates aten::mul
    assert any(node.lower().startswith(op.split("::")[-1].replace("_", ""))
               for node, op in linked), linked[:10]


def test_gt_upload_bytes_counts_misses(scene, first_views):
    t = _trainer(scene)
    before = set(t._gt_cache)
    m = t.step()
    missed = [t._gt_cache[k] for k in set(t._gt_cache) - before]
    assert {k[1] for k in set(t._gt_cache) - before} == {"rgb", "gray"} and len(missed) == 3
    assert m["gt_upload_bytes"] == sum(x.numel() * x.element_size() for x in missed)
    assert m["gt_upload_bytes"] == H * W * 4 * (3 + 1 + 1)
    assert t.step()["gt_upload_bytes"] == 0
