"""Import hygiene of the port: no file of ``src/repro_torch``, not
``chip_smoke.py`` and not the example twins (``examples/torch_*.py``)
imports ``jax`` or the reference package ``repro``, or
names a module of ``repro`` in a string (a ``"module:function"`` ref the
objective registry imports at run time, a ``python -m`` command); and
importing every module of the port, then resolving every objective and
method its registries hold, leaves both out of ``sys.modules``."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))
BANNED = ("jax", "jaxlib", "repro")
#: a dotted name under ``repro`` (``repro.exp``, ``repro.core.x:fn``)
REFERENCE_NAME = re.compile(r"(?<![\w.])repro\.[A-Za-z_]")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _docstrings(tree):
    nodes = (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.walk(tree):
        if (isinstance(node, nodes) and node.body
                and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)):
            yield node.body[0].value


def _strings(path: Path):
    """(line, text) of every string constant but docstrings; comments are
    not in the tree."""
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = {id(node) for node in _docstrings(tree)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in skip):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_reference_module(path):
    bad = [(line, text) for line, text in _strings(path)
           if REFERENCE_NAME.search(text) or text == "repro"]
    assert not bad, f"{path.relative_to(ROOT)} names repro in {bad}"


def test_reference_names_are_caught():
    """The scan sees what a copy would miss, and skips docstrings."""
    src = ('"""Mirrors repro.core.registry."""\n'
           'REF = "repro.core.objectives:eval_offline"\n'
           'CMD = [sys.executable, "-m", "repro.exp", "worker"]\n'
           'LINE = f"python -m repro.exp worker --heartbeat {h}"\n'
           'OK = "repro_torch.exp.runners:search_runner"\n')
    path = Path(os.environ.get("TMPDIR", "/tmp")) / "hygiene_probe.py"
    path.write_text(src)
    try:
        hits = [line for line, text in _strings(path)
                if REFERENCE_NAME.search(text)]
    finally:
        path.unlink()
    assert hits == [2, 3, 4]


def test_importing_the_port_loads_neither():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import repro_torch\n"
        "from repro_torch.core.objectives import objective_specs\n"
        "from repro_torch.core.registry import method_specs\n"
        "from repro_torch.multicloud import multicloud_domain\n"
        "cell = {'arch': 'qwen1.5-4b', 'shape': 'train_4k'}\n"
        "for spec in objective_specs():\n"
        "    assert spec.resolve().__module__.startswith('repro_torch.')\n"
        "    extra = cell if spec.family == 'sharding' else {}\n"
        "    spec.domain_factory({**dict(spec.defaults), **extra})\n"
        "for spec in method_specs():\n"
        "    spec.make_driver(multicloud_domain(), 33, 0)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
