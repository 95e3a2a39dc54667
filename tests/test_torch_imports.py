"""The port stands alone: importing `tpupose_torch` and every submodule
loads no JAX and nothing of `tpupose`, and no source file of the port or
`chip_smoke.py` imports either."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpupose_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    names = []
    for path in sorted((ROOT / "tpupose_torch").rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_import_loads_no_jax_and_no_tpupose():
    names = _module_names()
    for name in ("tpupose_torch.models.quantize", "tpupose_torch.ops.int8_conv",
                 "tpupose_torch.pipeline.facade", "tpupose_torch.kernels"):
        assert name in names, name
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'tpupose' or m.startswith('tpupose.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   capture_output=True, text=True, timeout=120)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_tpupose():
    assert len(PORT_FILES) > 20
    for path in PORT_FILES:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpupose"), f"{path}: imports {name}"
