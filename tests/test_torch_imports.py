"""gsjax_torch and the scripts that run on the card (chip_smoke.py,
probe_search.py, ab_port.py) import neither jax nor anything of gsjax: the
card's machine has no jax, and importing any gsjax module imports it."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gsjax_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "probe_search.py", "ab_port.py")]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gsjax")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gsjax_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import gsjax_torch, gsjax_torch.render, gsjax_torch.ops.raster, "
            "gsjax_torch.model.io, gsjax_torch.data.readers, gsjax_torch.data.synth, "
            "gsjax_torch.ops.knn, gsjax_torch.utils.schedules, gsjax_torch.train, "
            "gsjax_torch.train.losses, gsjax_torch.train.step, gsjax_torch.train.loop, "
            "gsjax_torch.ops.sample, gsjax_torch.ops.ncc, gsjax_torch.ops.warp_sample, "
            "gsjax_torch.train.multiview, gsjax_torch.model.appearance, "
            "gsjax_torch.mesh.extract, gsjax_torch.mesh.tetra, "
            "gsjax_torch.mesh.delaunay, gsjax_torch.mesh.cluster, gsjax_torch.mesh_extract, "
            "gsjax_torch.mesh_extract_tetrahedra; "
            "import sys; assert not any(m == 'jax' or m.startswith(('jax.', 'gsjax.')) "
            "or m == 'gsjax' for m in sys.modules), sorted(sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
