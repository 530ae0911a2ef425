"""The port stands alone: no module of ``pcdms_tpu_torch`` (nor
``chip_smoke.py``, ``examples/make_demo_notebook_torch.py``, the code cells
of ``examples/demo_torch.ipynb`` or the modules that
``scripts/*_torch.sh`` launch) imports JAX, Flax, Optax, the JAX package or
cv2 (the
card's machine has no OpenCV: the port draws with ``pose/raster.py`` and
resizes with PyTorch), and the package never calls
``scaled_dot_product_attention`` or ``torch.compile`` (library kernels are
not ports of the repository's kernels)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "pcdms_tpu_torch"
FILES = sorted(PACKAGE.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "make_demo_notebook_torch.py"]
NOTEBOOK = ROOT / "examples" / "demo_torch.ipynb"
LAUNCHERS = sorted((ROOT / "scripts").glob("*_torch.sh"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pcdms_tpu", "cv2")
# the modules of the metrics protocol, the learning proof, the DWPose path
# and the annotators, which take the JAX package's cv2 code paths over
CV2_FREE = ("eval/metrics.py", "eval/inception.py", "eval/lpips.py",
            "cli/calculate_metrics.py", "cli/learning_proof.py",
            "pose/raster.py", "pose/skeleton.py", "data/synthetic.py",
            "data/native.py", "pose/imgproc.py", "pose/dwpose.py",
            "pose/detectors/__init__.py", "pose/detectors/common.py",
            "pose/detectors/yolox.py", "pose/detectors/rtmpose.py",
            "cli/extract_pose.py", "cli/demo.py", "cli/serve_client.py",
            "cli/fastpath_drift.py", "pose/processors.py",
            "pose/detectors/openpose.py", "pose/detectors/openpose_decode.py",
            "pose/detectors/hed.py", "pose/detectors/pidi.py",
            "pose/detectors/lineart.py", "pose/detectors/lineart_anime.py",
            "pose/detectors/mlsd.py", "pose/detectors/midas.py",
            "pose/detectors/normalbae.py", "pose/detectors/zoe.py",
            "pose/detectors/leres.py", "pose/detectors/leres_boost.py",
            "pose/detectors/sam.py", "pose/detectors/sam_amg.py",
            "pose/detectors/tiny_vit.py", "pose/detectors/sam_scene.py")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _called_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                yield f.attr
                if isinstance(f.value, ast.Name):
                    yield f"{f.value.id}.{f.attr}"
            elif isinstance(f, ast.Name):
                yield f.id


def test_files_found():
    assert len(FILES) > 15 and all(p.exists() for p in FILES)
    assert {PACKAGE / m for m in CV2_FREE} <= set(FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_notebook_cells_import_no_jax():
    """The notebook's code cells run on the card's machine, read with
    ``json``: no JAX, no JAX package, no cv2 and no nbformat there."""
    import json
    cells = [("".join(c["source"]))
             for c in json.loads(NOTEBOOK.read_text())["cells"]
             if c["cell_type"] == "code"]
    assert len(cells) >= 5
    for src in cells:
        bad = [m for m in _imports(ast.parse(src))
               if m.split(".")[0] in FORBIDDEN + ("nbformat",)]
        assert not bad, bad


@pytest.mark.parametrize("path", LAUNCHERS, ids=lambda p: p.name)
def test_launchers_run_port_modules(path):
    """Each ``scripts/*_torch.sh`` launches modules of the port only, and
    each is a file of the package (whose imports the test above checks)."""
    import re
    modules = re.findall(r"-m ([\w.]+)", path.read_text())
    assert modules
    for m in modules:
        assert m.startswith("pcdms_tpu_torch."), m
        assert (ROOT / (m.replace(".", "/") + ".py")) in FILES, m


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile(path):
    tree = ast.parse(path.read_text(), str(path))
    called = set(_called_names(tree))
    assert not called & {"scaled_dot_product_attention", "torch.compile"}


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_refusal_names_item_19b(path):
    """Data parallelism (ROADMAP item 19b) is ported: no module refuses a
    flag, an argument or a path by naming it as missing."""
    text = path.read_text()
    assert "item 19b" not in text and "19b)" not in text
