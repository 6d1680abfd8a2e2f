"""The port imports torch, numpy and the standard library only: never
JAX, ml_dtypes or anything of the JAX package ``repro``.

Checked twice: by importing every module of ``repro_torch`` in a fresh
interpreter (this test process has JAX loaded by conftest), and by
reading every import statement of the port and of chip_smoke.py.  And
every module of the JAX package has its counterpart in the port, under
the same path.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_modules())
    assert {"repro_torch.kernels.paged_attention", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.mamba_scan", "repro_torch.models.mamba",
            "repro_torch.sharding.context", "repro_torch.sharding.specs",
            "repro_torch.launch.mesh", "repro_torch.models.moe_ep",
            "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_pipeline"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_forbidden_import_statement(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


# what the port has beside the JAX package's modules: the weight converter,
# the device rule, the connector's tree codec and the kernels' build
PORT_EXTRAS = {"convert.py", "device.py", "connector/tree.py", "kernels/build.py"}


def _py_files(root: pathlib.Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*.py")
            if p.name != "__init__.py" and "csrc" not in p.parts}


def test_every_module_of_the_jax_package_has_its_counterpart():
    jax_mods, port_mods = _py_files(REPO / "src" / "repro"), _py_files(PORT)
    assert sorted(jax_mods - port_mods) == []
    assert sorted(port_mods - jax_mods - PORT_EXTRAS) == []
