"""The port's decoupled appearance models (`gsjax_torch.model.appearance`)
against gsjax's (`gsjax.model.appearance`), on the CPU.

The state is carried between the packages through `state_to_arrays` /
`state_from_arrays`: gsjax's gs / pgsr initialisation into the port, and the
port's GOF initialisation into gsjax (the port draws it from a
torch.Generator, not from jax.random's stream; gsjax's own GOF
initialisation is compared by shape, through `jax.eval_shape`, since
compiling jax.random on the CPU takes ~15 s).

Limits: Adam steps within 1e-6 absolute (the same float32 formula; the
bias corrections are rounded to float32 as gsjax's); the CNN, its two
resizes and the GOF L1 within 1e-5 (float32 convolutions and bilinear
weights summed in another order); gradients of the GOF L1 to the image,
the embedding and the net within 1e-5 of each one's largest entry;
checkpoint arrays equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.model import appearance as japp
from gsjax_torch.model import appearance as tapp

torch.set_num_threads(1)
KINDS = ("gs", "pgsr", "gof")


def _gsjax_template(kind, num_cams):
    """A gsjax state of `kind` with zero tables and nets, made without
    jax.random (a template for `state_from_arrays`)."""
    if kind != "gof":
        return japp.init_appearance(kind, num_cams)
    net = {name: {"w": jnp.zeros((cout, cin, 3, 3)), "b": jnp.zeros((cout,))}
           for name, cin, cout in tapp.GOF_LAYERS}
    zeros = lambda: jax.tree_util.tree_map(jnp.zeros_like, net)
    table = jnp.zeros((num_cams, 64))
    return japp.AppearanceState("gof", table, net,
                                japp.TableAdam(table, table, jnp.zeros((), jnp.int32)),
                                japp.TableAdam(zeros(), zeros(), jnp.zeros((), jnp.int32)))


def _pair(kind, num_cams=5):
    """The same state in both packages: gsjax's gs / pgsr initialisation
    carried into the port, the port's GOF initialisation into gsjax."""
    ts = tapp.init_appearance(kind, num_cams, torch.Generator().manual_seed(0))
    if kind == "gof":
        return japp.state_from_arrays(_gsjax_template(kind, num_cams),
                                      tapp.state_to_arrays(ts)), ts
    js = japp.init_appearance(kind, num_cams)
    return js, tapp.state_from_arrays(ts, japp.state_to_arrays(js))


def _same(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy() if torch.is_tensor(b) else b,
                               rtol=0, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_init_matches_gsjax(kind):
    ts = tapp.init_appearance(kind, 4, torch.Generator().manual_seed(0))
    assert ts.kind == kind and ts.opt.count == 0
    if kind != "gof":
        _same(japp.init_appearance(kind, 4).table, ts.table)
    else:
        table, net = jax.eval_shape(lambda: (lambda a: (a.table, a.net))(
            japp.init_appearance("gof", 4)))
        assert tuple(ts.table.shape) == table.shape
        assert {k: (p["w"].shape, p["b"].shape) for k, p in net.items()} == \
            {k: (tuple(p["w"].shape), tuple(p["b"].shape)) for k, p in ts.net.tree().items()}
        # the scales of gsjax's draws: N(0, 1e-4) rows, U(+-1/sqrt(fan_in)) weights
        assert 0.5e-4 < float(ts.table.std()) < 2e-4
        for name, cin, _ in tapp.GOF_LAYERS:
            w = ts.net.tree()[name]["w"]
            assert 0.9 < float(w.detach().abs().max()) * np.sqrt(cin * 9) <= 1.0, name
    assert tapp.init_appearance("no", 4).table is None
    with pytest.raises(ValueError):
        tapp.init_appearance("other", 4)


@pytest.mark.parametrize("kind", KINDS)
def test_update_table_matches_gsjax(kind):
    js, ts = _pair(kind)
    rng = np.random.default_rng(1)
    for step, uid in enumerate((2, 4, 2)):
        g = rng.normal(0, 0.3, js.table.shape[1:]).astype(np.float32)
        lr = 0.01 / (step + 1)
        js = japp.update_table(js, uid, jnp.asarray(g), lr)
        ts = tapp.update_table(ts, uid, torch.as_tensor(g), lr)
    assert ts.opt.count == int(js.opt.count) == 3
    for a, b in ((js.table, ts.table), (js.opt.mu, ts.opt.mu), (js.opt.nu, ts.opt.nu)):
        _same(a, b, atol=1e-6)
    # whole-table Adam: row 0 got no gradient and stayed; rows 2, 4 moved
    assert torch.equal(ts.table[0], _pair(kind)[1].table[0])


def test_adam_tree_on_the_net_matches_gsjax():
    js, ts = _pair("gof")
    rng = np.random.default_rng(2)
    for _ in range(2):
        g = {k: {kk: rng.normal(0, 1e-2, vv.shape).astype(np.float32) for kk, vv in p.items()}
             for k, p in js.net.items()}
        net, net_opt = japp.adam_tree(js.net, jax.tree_util.tree_map(jnp.asarray, g),
                                      js.net_opt, 1e-3)
        js = dataclasses.replace(js, net=net, net_opt=net_opt)
        ts = tapp.update_net(ts, {k: {kk: torch.as_tensor(vv) for kk, vv in p.items()}
                                  for k, p in g.items()}, 1e-3)
    assert ts.net_opt.count == int(js.net_opt.count) == 2
    ja, ta = japp.state_to_arrays(js), tapp.state_to_arrays(ts)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_arrays_round_trip_both_ways(kind):
    js, ts = _pair(kind)
    ja = japp.state_to_arrays(js)
    ta = tapp.state_to_arrays(ts)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        assert ta[k].dtype == ja[k].dtype, k
    # port -> gsjax -> port, from a port state that has stepped
    ts = tapp.update_table(ts, 1, torch.ones(ts.table.shape[1:]), 0.01)
    ta = tapp.state_to_arrays(ts)
    back = japp.state_to_arrays(japp.state_from_arrays(_gsjax_template(kind, 5), ta))
    again = tapp.state_to_arrays(tapp.state_from_arrays(
        tapp.init_appearance(kind, 5, torch.Generator().manual_seed(7)), back))
    for k in ta:
        np.testing.assert_array_equal(again[k], ta[k], err_msg=k)
    # the legacy key restores the table only
    legacy = tapp.state_from_arrays(tapp.init_appearance(kind, 5), {"app_table": ja["app/table"]})
    _same(ja["app/table"], legacy.table)


def _gof_inputs(h, w, seed=4):
    rng = np.random.default_rng(seed)
    return rng.random((h, w, 3)).astype(np.float32), rng.random((h, w, 3)).astype(np.float32)


def test_gof_forward_and_resizes_match_gsjax():
    js, ts = _pair("gof")
    x = np.random.default_rng(5).normal(0, 1, (1, 67, 4, 5)).astype(np.float32)
    want = np.asarray(japp.gof_forward(js.net, jnp.asarray(x)))
    got = ts.net(torch.as_tensor(x))
    assert got.shape == (1, 3, 128, 160)
    _same(want, got, atol=1e-5)
    y = np.random.default_rng(6).random((1, 2, 3, 7)).astype(np.float32)
    _same(japp._bilinear_x2_align(jnp.asarray(y)), tapp.upsample_x2_align(torch.as_tensor(y)),
          atol=1e-6)
    img, _ = _gof_inputs(45, 70)
    for size in ((1, 2), (3, 5), (9, 11)):
        _same(japp.downsample_align(jnp.asarray(img), *size),
              tapp.downsample_align(torch.as_tensor(img), *size), atol=1e-6)


def test_l1_appearance_gof_and_grads_match_gsjax():
    """At 72x40: the centre crop to the /32 grid drops 4 rows top and
    bottom and 4 columns left and right."""
    js, ts = _pair("gof")
    img, gt = _gof_inputs(40, 72)
    emb = np.asarray(js.table[2])

    def jloss(im, e, net):
        return japp.l1_appearance_gof(im, jnp.asarray(gt), net, e)

    jv, (jgi, jge, jgn) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(emb), js.net)
    ti = torch.tensor(img, requires_grad=True)
    te = torch.tensor(emb, requires_grad=True)
    tree = ts.net.tree()
    leaves = [p for layer in tree.values() for p in layer.values()]
    tv = tapp.l1_appearance_gof(ti, torch.as_tensor(gt), ts.net, te)
    tgi, tge, *tgn = torch.autograd.grad(tv, [ti, te] + leaves)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    want = [jgi, jge] + [jgn[k][kk] for k, p in tree.items() for kk in p]
    for name, a, b in zip(["image", "embedding"] + [f"{k}/{kk}" for k, p in tree.items()
                                                    for kk in p], [tgi, tge] + tgn, want):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5, err_msg=name)
    # the crop: pixels outside the /32 grid get no gradient
    assert float(tgi[:4].abs().max()) == 0 and float(tgi[36:].abs().max()) == 0
    assert float(tgi[:, :4].abs().max()) == 0 and float(tgi[:, 68:].abs().max()) == 0
