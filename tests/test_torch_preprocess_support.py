"""The support of the preprocess VJP on the CPU, and the kernel wrappers there.

(a) Each case of `tests/preprocess_cases.py` (one per branch of the twin that
    cuts or keeps a chain, dead rows, rows no cotangent reaches, SH bands and
    SG lobes past the degree): `preprocess`'s torch autograd on CPU tensors
    leaves exactly the stated elements of each input leaf at zero. The card's
    `parity_preprocess` phase (chip_smoke.py) holds the kernel VJP to the same
    cases and to the twin's zeros.
(b) `preprocess_fwd` / `preprocess_bwd` on CPU tensors run the twin and its
    autograd VJP and count no launch; on tensors of another device they raise.
"""

import dataclasses

import pytest
import torch

from gsjax_torch.ops.raster import preprocess as pp
from tests import preprocess_cases as pc

torch.set_num_threads(1)
CASES = pc.cases()


@pytest.mark.parametrize("name", list(CASES))
def test_twin_support(name):
    case = CASES[name]
    inputs, cam, cfg, alive, cots = pc.build(case)
    leaves = [None if t is None else t.clone().requires_grad_(True) for t in inputs]
    out = pp.preprocess(*leaves, cam, cfg, alive)
    pairs = [(getattr(out, k), c) for k, c in zip(pc.GRAD_FIELDS, cots) if c.any()]
    wrt = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                   allow_unused=True))
    grads = [None if t is None else next(got) for t in leaves]
    for g in grads:
        assert g is None or torch.isfinite(g).all(), name
    assert pc.failures(case, grads) == [], name


def _wrapped_case():
    case = CASES["lam_clamped"]
    return case, pc.build(dataclasses.replace(case, cfg=dict(sg_degree=2)))


def test_wrappers_run_twin_for_cpu_tensors():
    case, (inputs, cam, cfg, alive, cots) = _wrapped_case()
    inputs = pc.stack(case.rows)
    before = (pp.preprocess_fwd.launches, pp.preprocess_bwd.launches)
    got = pp.preprocess_fwd(*inputs, cam, cfg, alive)
    want = pp.preprocess_ref(*inputs, cam, cfg, alive)
    for k in pp.FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    grads = pp.preprocess_bwd(inputs, cam, cfg, alive, cots)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = pp.preprocess(*leaves, cam, cfg, alive)
    auto = torch.autograd.grad([getattr(out, k) for k in pp.GRAD_FIELDS], leaves, cots)
    # the twin's graph adds the rotation's two parts: their sum comes first
    assert len(grads) == len(pp.GRAD_INPUTS) and grads[3] is None
    for g, a in zip(grads[:3] + grads[4:], auto):
        assert torch.equal(g, a)
    assert (pp.preprocess_fwd.launches, pp.preprocess_bwd.launches) == before


def test_wrappers_raise_on_other_devices():
    _, (inputs, cam, cfg, alive, cots) = _wrapped_case()
    meta = [t.to("meta") for t in pc.stack(CASES["lam_clamped"].rows)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pp.preprocess_fwd(*meta, cam, cfg, alive)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pp.preprocess_bwd(meta, cam, cfg, alive, [c.to("meta") for c in cots])
