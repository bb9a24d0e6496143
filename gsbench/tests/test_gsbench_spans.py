"""`gsbench/spans.py` on synthetic event lists: which program span each
device event goes to, the reduction's seconds, launches, covered share and
idle gaps, and the raw-event reader's filter of user annotations."""

import types

import pytest

from gsbench import spans as sp

MAIN, ENGINE = 1, 2


def H(name, thread, start, end, corr=0, link=0, seq=-1, fwd=0):
    return sp.Host(name, thread, start, end, corr, link, seq, fwd)


# a step: train_step > raster.render > raster.preprocess (aten::mul, seq 7)
# and raster.blend (a ctypes launch under its autograd Function's record, no
# aten op); step.backward on the main
# thread while the engine's thread runs MulBackward0 (seq 7) and a node with
# no forward op; a copy before any span
HOST = [
    H("train_step 15001", MAIN, 0.0, 10.0),
    H("raster.render", MAIN, 1.0, 5.0),
    H("raster.preprocess", MAIN, 1.0, 2.0),
    H("aten::mul", MAIN, 1.1, 1.5, corr=101, seq=7),
    H("cudaLaunchKernel", MAIN, 1.2, 1.3, corr=9001, link=101),
    H("raster.blend", MAIN, 3.0, 4.0),
    H("cudaLaunchKernel", MAIN, 3.1, 3.2, corr=9002, link=102),
    H("WarpSample", MAIN, 3.05, 3.9, corr=102),
    H("step.backward", MAIN, 6.0, 9.0),
    H("autograd::engine::evaluate_function: MulBackward0", ENGINE, 6.5, 7.0, corr=201,
      seq=7, fwd=MAIN),
    H("MulBackward0", ENGINE, 6.5, 7.0, corr=202, seq=7, fwd=MAIN),
    H("aten::mul", ENGINE, 6.6, 6.9, corr=203),
    H("cudaLaunchKernel", ENGINE, 6.7, 6.8, corr=9003, link=203),
    H("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", ENGINE,
      7.5, 8.0, corr=204),
    H("cudaLaunchKernel", ENGINE, 7.6, 7.7, corr=9004, link=204),
    H("cudaMemcpyAsync", MAIN, 11.0, 11.1, corr=9005, link=300),
]
DEV = [
    sp.Dev("elementwise_kernel<mul>", 1.3, 1.4, 9001, 101),
    sp.Dev("blend_fwd_kernel", 3.2, 3.7, 9002, 102),
    sp.Dev("elementwise_kernel<mul> (vjp)", 6.8, 6.9, 9003, 203),
    sp.Dev("accumulate_kernel", 7.7, 7.8, 9004, 204),
    sp.Dev("Memcpy HtoD (Pageable -> Device)", 11.1, 11.3, 9005, 300),
]


def test_each_rule_finds_its_span():
    assert sp.attribute(HOST, DEV) == [
        "raster.preprocess",   # rule 1: the aten op's innermost span
        "raster.blend",        # rule 1: a ctypes launch inside the span
        "raster.preprocess",   # rule 2: the engine's node -> its forward op
        "step.backward",       # rule 3: no span, no forward op: the main thread's
        "(none)",              # outside every span
    ]


def test_span_inside_a_backward_node_wins():
    """A span the node's own code opens (B2's Blend.backward) is innermost."""
    host = HOST + [H("raster.blend_bwd", ENGINE, 6.55, 6.95)]
    assert sp.attribute(host, DEV)[2] == "raster.blend_bwd"


def test_cpu_backward_on_the_callers_thread():
    """On the CPU the engine runs on the caller's thread, inside step.backward:
    the node is innermost, so the forward op's span still gets the kernel."""
    host = [h._replace(thread=MAIN) if h.thread == ENGINE else h for h in HOST]
    assert sp.attribute(host, DEV)[2] == "raster.preprocess"


def test_reduce_seconds_launches_covered_idle():
    r = sp.reduce(HOST, DEV)
    assert r["spans"]["raster.preprocess"] == [pytest.approx(0.2), 2]
    assert r["spans"]["raster.blend"] == [pytest.approx(0.5), 1]
    assert r["spans"]["(none)"] == [pytest.approx(0.2), 0]      # a copy, no launch
    assert r["device_s"] == pytest.approx(1.0)
    assert r["covered"] == pytest.approx(0.8)
    # the root's gaps by the span open on the main thread at their midpoint:
    # 0-1.3 and 3.7-6.8 in the step, 1.4-3.2 in the render, 6.9-7.7 and
    # 7.8-10 in the backward
    assert r["idle"] == {"train_step": pytest.approx(1.3 + 3.1),
                         "raster.render": pytest.approx(1.8),
                         "step.backward": pytest.approx(0.8 + 2.2)}


def test_root_time_is_not_covered():
    host = HOST + [H("aten::add", MAIN, 5.2, 5.5, corr=105),
                   H("cudaLaunchKernel", MAIN, 5.3, 5.4, corr=9006, link=105)]
    dev = DEV + [sp.Dev("add_kernel", 5.4, 5.9, 9006, 105)]
    r = sp.reduce(host, dev)
    assert r["spans"]["train_step"] == [pytest.approx(0.5), 1]
    assert r["covered"] == pytest.approx(0.8 / 1.5)


def test_span_names():
    assert sp.span_name("train_step 15001") == "train_step"
    assert sp.span_name("raster.preprocess") == "raster.preprocess"
    assert sp.span_name("aten::mul") is None


def test_events_leave_out_user_annotations():
    from torch.autograd import DeviceType

    def ev(name, dev, user=False, corr=1, link=0):
        return types.SimpleNamespace(
            name=lambda: name, start_ns=lambda: 1000, end_ns=lambda: 2000,
            device_type=lambda: dev, is_user_annotation=lambda: user,
            correlation_id=lambda: corr, linked_correlation_id=lambda: link,
            start_thread_id=lambda: 1, sequence_nr=lambda: -1, fwd_thread_id=lambda: 0)

    raw = [ev("raster.render", DeviceType.CPU), ev("kernel", DeviceType.CUDA, link=5),
           ev("raster.render", DeviceType.CUDA, user=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    host, dev = sp.events(prof)
    assert [h.name for h in host] == ["raster.render"]
    assert dev == [sp.Dev("kernel", 1e-6, 2e-6, 1, 5)]
