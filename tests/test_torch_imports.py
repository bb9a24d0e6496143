"""gsjax_torch and the scripts that run on the card (chip_smoke.py,
probe_search.py, ab_port.py, probe_golden.py, probe_cards.py and the benchmark entries
bench_torch.py, bench_reg_torch.py, bench_scaling_torch.py) import neither
jax nor anything of gsjax: the card's machine has no jax, and importing any
gsjax module imports it. Nor do they import a root script of the JAX side
(convert.py, metric.py, ...), whose numpy-only parts the port copies.
sklearn and matplotlib are not on the card's machine and cv2 is optional, so
no module imports them at module level: the package imports with all six
blocked."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD_SCRIPTS = ("chip_smoke.py", "probe_search.py", "ab_port.py", "probe_golden.py",
                "bench_torch.py", "bench_reg_torch.py", "bench_scaling_torch.py",
                "probe_cards.py")
SOURCES = sorted((ROOT / "gsjax_torch").rglob("*.py")) + [
    ROOT / name for name in CARD_SCRIPTS]
# the JAX side's root scripts and script folders
JAX_SIDE = ({p.stem for p in ROOT.glob("*.py") if p.name not in CARD_SCRIPTS}
            | {"eval_tnt", "scripts", "tests"})
OPTIONAL = ("sklearn", "cv2", "matplotlib")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gsjax") or top in JAX_SIDE


def _imports(path, module_level=False):
    """Absolute imports of `path`; with `module_level`, only those run when
    the module is imported (outside any function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = [tree]
    while stack:
        node = stack.pop()
        if module_level and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                               ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gsjax_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    late = [m for m in _imports(path, module_level=True) if m.split(".")[0] in OPTIONAL]
    assert not late, f"{path.relative_to(ROOT)} imports {late} at module level"


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'gsjax', 'sklearn', "
            "'cv2', 'matplotlib'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import gsjax_torch, gsjax_torch.render, gsjax_torch.ops.raster, "
            "gsjax_torch.model.io, gsjax_torch.data.readers, gsjax_torch.data.synth, "
            "gsjax_torch.ops.knn, gsjax_torch.utils.schedules, gsjax_torch.train, "
            "gsjax_torch.train.losses, gsjax_torch.train.step, gsjax_torch.train.loop, "
            "gsjax_torch.ops.sample, gsjax_torch.ops.ncc, gsjax_torch.ops.warp_sample, "
            "gsjax_torch.train.multiview, gsjax_torch.model.appearance, "
            "gsjax_torch.mesh.extract, gsjax_torch.mesh.tetra, "
            "gsjax_torch.mesh.delaunay, gsjax_torch.mesh.cluster, gsjax_torch.mesh_extract, "
            "gsjax_torch.mesh_extract_tetrahedra, gsjax_torch.metric, gsjax_torch.eval, "
            "gsjax_torch.eval.lpips, gsjax_torch.eval.dtu, gsjax_torch.eval.tnt, "
            "gsjax_torch.evaluate_dtu_mesh, gsjax_torch.eval_tnt, gsjax_torch.convert, "
            "gsjax_torch.utils.trajectories, gsjax_torch.utils.mvs, gsjax_torch.utils.llff, "
            "gsjax_torch.viewer, gsjax_torch.viewer.network_gui, gsjax_torch.viewer.web, "
            "gsjax_torch.viewer.client, gsjax_torch.nan_hunt, gsjax_torch.golden_quality, "
            "gsjax_torch.quality_r04, gsjax_torch.blobs_mesh_ab, gsjax_torch.bench, "
            "gsjax_torch.bench_reg, gsjax_torch.bench_scaling, gsjax_torch.utils.benchsync, "
            "gsjax_torch.profile_stages, gsjax_torch.measure_trepl, gsjax_torch.scaling_model, "
            "gsjax_torch.multihost_demo, gsjax_torch.profile_sample, gsjax_torch.profile_reg, "
            "gsjax_torch.trace_reg; "
            "import sys; assert not any(m == 'jax' or m.startswith(('jax.', 'gsjax.')) "
            "or m == 'gsjax' for m in sys.modules), sorted(sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
