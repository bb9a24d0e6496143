"""gsjax_torch model state against gsjax's: init, 3D filter, Adam, opacity
reset, densification statistics and densify/prune, capacity growth, KNN
init scales, the LR schedule and checkpoints in both directions.

Float results agree within 1e-6 (float32 in both packages); masks, slots
and counts are equal. `densify_and_prune` gets gsjax's own
`jax.random.normal` samples injected.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.model import gaussians as jgm
from gsjax.model.io import load_checkpoint as jload_ckpt
from gsjax.model.io import save_checkpoint as jsave_ckpt
from gsjax.ops.knn import mean_knn_dist2 as jknn
from gsjax.utils.schedules import expon_lr as jexpon_lr
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.model.io import load_checkpoint, save_checkpoint
from gsjax_torch.ops.knn import mean_knn_dist2
from gsjax_torch.utils.schedules import expon_lr
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _leaves(tree):
    return {f.name: np.array(getattr(tree, f.name)) for f in dataclasses.fields(tree)}


def _model(n=60, capacity=96, seed=0, sh_degree=1, sg_degree=2):
    means, _, _, _, shs = random_gaussians(n, seed=seed)
    colors = np.clip(shs[:, 0] * 0.28 + 0.5, 0, 1)
    knn = jknn(means)
    return jgm.init_from_pcd(means, colors, capacity, sh_degree, sg_degree, knn, seed=seed)


def _to_port(jp, ja):
    return tgm.params_from_numpy(_leaves(jp), _leaves(ja), "cpu")


def _assert_params(tp, jp, **tol):
    for k, v in _leaves(jp).items():
        np.testing.assert_allclose(getattr(tp, k).detach().numpy(), v, err_msg=k,
                                   **(tol or TOL))


def test_init_from_pcd_matches_gsjax():
    means, _, _, _, shs = random_gaussians(50, seed=2)
    colors = np.clip(shs[:, 0] * 0.28 + 0.5, 0, 1)
    knn = mean_knn_dist2(means)
    np.testing.assert_allclose(knn, jknn(means), rtol=1e-6)
    jp, ja = jgm.init_from_pcd(means, colors, 64, 2, 3, knn, seed=4)
    tp, ta = tgm.init_from_pcd(means, colors, 64, 2, 3, knn, seed=4, device="cpu")
    _assert_params(tp, jp)
    for k, v in _leaves(ja).items():
        np.testing.assert_array_equal(getattr(ta, k).numpy(), v, err_msg=k)


def test_compute_3d_filter_matches_gsjax():
    jp, ja = _model()
    ja = dataclasses.replace(ja, alive=ja.alive.at[5].set(False))
    cams = [look_at_camera(96, 64, angle=a) for a in (0.0, 0.4, -0.5)]
    wv = np.stack([np.asarray(c.world_view) for c in cams])
    fx = np.array([c.fx for c in cams], np.float32)
    fy = np.array([c.fy for c in cams], np.float32)
    w = np.full(3, 96, np.float32)
    h = np.full(3, 64, np.float32)
    want = jgm.compute_3d_filter(jp.xyz, ja.alive, jnp.asarray(wv), jnp.asarray(fx),
                                 jnp.asarray(w), jnp.asarray(h), jnp.asarray(fy))
    t = lambda a: torch.as_tensor(a)
    got = tgm.compute_3d_filter(t(np.asarray(jp.xyz)), t(np.asarray(ja.alive)), t(wv),
                                t(fx), t(w), t(h), t(fy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_adam_update_matches_gsjax():
    jp, ja = _model()
    tp, _ = _to_port(jp, ja)
    jadam, tadam = jgm.adam_init(jp), tgm.adam_init(tp)
    lrs = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
               scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
               sg_color=0.00064)
    rng = np.random.default_rng(9)
    for _ in range(3):
        g = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
             for k, v in _leaves(jp).items()}
        jp, jadam = jgm.adam_update(jp, jgm.GaussianParams(**g), jadam, lrs)
        tgm.adam_update(tp, {k: torch.as_tensor(v) for k, v in g.items()}, tadam, lrs)
    _assert_params(tp, jp)
    for k in tgm.PARAM_FIELDS:
        np.testing.assert_allclose(tadam.mu[k].numpy(), np.asarray(getattr(jadam.mu, k)), **TOL)
        np.testing.assert_allclose(tadam.nu[k].numpy(), np.asarray(getattr(jadam.nu, k)), **TOL)
    assert tadam.count == int(jadam.count) == 3


def test_reset_opacity_and_stats_match_gsjax():
    jp, ja = _model()
    rng = np.random.default_rng(3)
    ja = dataclasses.replace(ja, filter_3d=jnp.asarray(rng.uniform(0, 0.02, 96).astype(np.float32)))
    tp, ta = _to_port(jp, ja)
    jadam, tadam = jgm.adam_init(jp), tgm.adam_init(tp)
    jadam = dataclasses.replace(jadam, mu=dataclasses.replace(jadam.mu, opacity=jadam.mu.opacity + 1))
    tadam.mu["opacity"] += 1
    jp, jadam = jgm.reset_opacity(jp, ja, jadam)
    tgm.reset_opacity(tp, ta, tadam)
    _assert_params(tp, jp, rtol=1e-5, atol=1e-5)   # logit of ~0.01: log of a ratio
    assert float(tadam.mu["opacity"].abs().max()) == 0.0

    g2d = rng.normal(0, 1e-3, (96, 2)).astype(np.float32)
    vis = rng.uniform(size=96) < 0.7
    ja2 = jgm.add_densification_stats(ja, jnp.asarray(g2d), jnp.asarray(vis), 96, 64)
    ta2 = tgm.add_densification_stats(ta, torch.as_tensor(g2d), torch.as_tensor(vis), 96, 64)
    for k in ("grad_accum", "grad_accum_abs", "denom"):
        np.testing.assert_allclose(getattr(ta2, k).numpy(), np.asarray(getattr(ja2, k)), **TOL)


def _densify_state(layout_tail: bool):
    """A model whose statistics ask for clones, splits and prunes. With
    `layout_tail` the 96 free slots come first, so every child lands in a
    slot that was free before the call."""
    jp, ja = _model(n=160, capacity=256, seed=6, sh_degree=1, sg_degree=1)
    rng = np.random.default_rng(11)
    leaves, aux = _leaves(jp), _leaves(ja)
    n = 160
    leaves["scaling"][:n] = np.log(np.where(rng.uniform(size=(n, 1)) < 0.5, 0.01, 0.1)
                                   * np.ones((1, 3))).astype(np.float32)
    leaves["opacity"][:n] = rng.normal(-1.0, 1.5, (n, 1)).astype(np.float32)
    leaves["rotation"][:n] = rng.normal(0, 1, (n, 4)).astype(np.float32)
    aux["grad_accum"][:n] = np.where(rng.uniform(size=n) < 0.15, 3e-3, 1e-5) * 4
    aux["grad_accum_abs"][:n] = rng.uniform(0, 1e-2, n)
    aux["denom"][:n] = 4.0
    leaves["xyz"][3] = np.nan                     # a non-finite slot is pruned
    if layout_tail:
        leaves = {k: np.roll(v, 96, axis=0) for k, v in leaves.items()}
        aux = {k: np.roll(v, 96, axis=0) for k, v in aux.items()}
    leaves["features_dc"][:, 0, 0] = np.arange(256)   # each slot's own id
    return (jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            jgm.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}))


def _densify_both(layout_tail):
    jp, ja = _densify_state(layout_tail)
    tp, ta = _to_port(jp, ja)
    jadam, tadam = jgm.adam_init(jp), tgm.adam_init(tp)
    jadam = dataclasses.replace(jadam, mu=jax.tree_util.tree_map(lambda x: x + 0.5, jadam.mu))
    for v in tadam.mu.values():
        v += 0.5
    key = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(k, (256, 3)))
                      for k in jax.random.split(key, 3)])
    j = jgm.densify_and_prune(jp, ja, jadam, key, 2e-4, 0.05, jnp.asarray(3.0), 0.01)
    t = tgm.densify_and_prune(tp, ta, tadam, None, 2e-4, 0.05, 3.0, 0.01,
                              noise=torch.as_tensor(noise))
    return j, t, (jp, tp)


def test_densify_and_prune_matches_gsjax():
    (jp2, ja2, jad2, js), (tp2, ta2, tad2, ts), _ = _densify_both(layout_tail=True)
    assert ts == {k: int(v) for k, v in js.items()}
    assert ts["n_cloned"] > 0 and ts["n_split"] > 0 and ts["n_pruned"] > 0
    assert ts["n_cloned"] + 2 * ts["n_split"] <= 96, "children fit the leading free slots"
    np.testing.assert_array_equal(ta2.alive.numpy(), np.asarray(ja2.alive))
    alive = np.asarray(ja2.alive)
    for k, v in _leaves(jp2).items():
        np.testing.assert_allclose(getattr(tp2, k).detach().numpy()[alive], v[alive],
                                   err_msg=k, **TOL)
    for k in tgm.PARAM_FIELDS:
        np.testing.assert_allclose(tad2.mu[k].numpy()[alive],
                                   np.asarray(getattr(jad2.mu, k))[alive], **TOL)
    for k in ("grad_accum", "grad_accum_abs", "denom", "max_radii"):
        assert float(getattr(ta2, k).abs().sum()) == 0.0


def _copies_its_parent(params, alive, before, noise):
    """[CAP] bool: the slot holds a survivor or a child of the gaussian whose
    id its features_dc carries, with that gaussian's fields from before the
    call (a child's centre is one of the parent's three samples)."""
    from gsjax.core.quaternion import to_rotation_matrix

    q = before["rotation"] / np.linalg.norm(before["rotation"], axis=1, keepdims=True)
    rot = np.asarray(to_rotation_matrix(jnp.asarray(q)))
    scale = np.exp(before["scaling"])
    xyz = params["xyz"]
    ok = np.zeros(len(xyz), bool)
    for slot in np.nonzero(alive)[0]:
        p = int(round(float(params["features_dc"][slot, 0, 0])))
        same = all(np.allclose(params[k][slot], before[k][p], atol=1e-6)
                   for k in ("features_dc", "opacity", "rotation", "sg_color"))
        centres = [before["xyz"][p]] + [before["xyz"][p] + rot[p] @ (e[p] * scale[p])
                                        for e in noise]
        ok[slot] = same and any(np.allclose(xyz[slot], c, atol=1e-5) for c in centres)
    return ok


def test_densify_children_copy_their_parent():
    """Free slots in ascending order, so split parents' own slots are reused
    by earlier children. The port's children copy their parent as it was
    before the call; gsjax's read the slot after earlier children were
    written there (ROADMAP queue C), so some of its split children carry
    another gaussian's fields."""
    (jp2, ja2, _, js), (tp2, ta2, _, ts), (jp, _) = _densify_both(layout_tail=False)
    assert ts == {k: int(v) for k, v in js.items()}
    alive = ta2.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(ja2.alive))
    before = _leaves(jp)
    noise = [np.asarray(jax.random.normal(k, (256, 3)))
             for k in jax.random.split(jax.random.PRNGKey(3), 3)]
    port = {k: getattr(tp2, k).detach().numpy() for k in tgm.PARAM_FIELDS}
    assert _copies_its_parent(port, alive, before, noise)[alive].all()
    assert not _copies_its_parent(_leaves(jp2), alive, before, noise)[alive].all()


def test_grow_capacity_matches_gsjax():
    jp, ja = _model()
    tp, ta = _to_port(jp, ja)
    jp2, ja2, jad2 = jgm.grow_capacity(jp, ja, jgm.adam_init(jp), 160)
    tp2, ta2, tad2 = tgm.grow_capacity(tp, ta, tgm.adam_init(tp), 160)
    assert tp2.capacity == 160
    _assert_params(tp2, jp2)
    for k, v in _leaves(ja2).items():
        np.testing.assert_array_equal(getattr(ta2, k).numpy(), v, err_msg=k)
    assert tad2.mu["xyz"].shape == (160, 3)


def test_expon_lr_matches_gsjax():
    for step in (0, 1, 10, 500, 7000, 30000, 40000):
        for kw in (dict(), dict(lr_delay_steps=100, lr_delay_mult=0.01, max_steps=30000)):
            assert expon_lr(step, 1.6e-4, 1.6e-6, **kw) == jexpon_lr(step, 1.6e-4, 1.6e-6, **kw)


@pytest.mark.parametrize("direction", ["port_to_gsjax", "gsjax_to_port"])
def test_checkpoint_round_trip(tmp_path, direction):
    jp, ja = _model()
    jadam = jgm.adam_init(jp)
    rng = np.random.default_rng(5)
    jadam = dataclasses.replace(
        jadam, mu=jax.tree_util.tree_map(lambda x: x + rng.normal(), jadam.mu),
        count=jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "chkpnt7.npz")
    if direction == "port_to_gsjax":
        tp, ta = _to_port(jp, ja)
        tad = tgm.AdamState(mu={k: torch.as_tensor(np.asarray(getattr(jadam.mu, k)))
                                for k in tgm.PARAM_FIELDS},
                            nu={k: torch.as_tensor(np.asarray(getattr(jadam.nu, k)))
                                for k in tgm.PARAM_FIELDS}, count=7)
        save_checkpoint(path, tp, ta, tad, 7)
        p2, a2, ad2, it, _ = jload_ckpt(path)
        assert it == 7 and int(ad2.count) == 7
        for k in tgm.PARAM_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(p2, k)), np.asarray(getattr(jp, k)))
            np.testing.assert_array_equal(np.asarray(getattr(ad2.mu, k)),
                                          np.asarray(getattr(jadam.mu, k)))
        for k, v in _leaves(ja).items():
            np.testing.assert_array_equal(np.asarray(getattr(a2, k)), v)
    else:
        jsave_ckpt(path, jp, ja, jadam, 7, {"note": np.arange(3)})
        tp, ta, tad, it, extra = load_checkpoint(path, device="cpu")
        assert it == 7 and tad.count == 7
        np.testing.assert_array_equal(extra["note"], np.arange(3))
        _assert_params(tp, jp, rtol=0, atol=0)
        for k in tgm.PARAM_FIELDS:
            np.testing.assert_array_equal(tad.mu[k].numpy(), np.asarray(getattr(jadam.mu, k)))
        for k, v in _leaves(ja).items():
            np.testing.assert_array_equal(getattr(ta, k).numpy(), v)
