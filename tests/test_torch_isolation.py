"""The PyTorch port (unet_tpu_torch/ and chip_smoke.py) imports neither
JAX nor the JAX package: checked by importing every module in a fresh
interpreter, and by reading every source for import statements (which
also catches imports inside functions that a plain import never runs)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / 'unet_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'unet_tpu')
SOURCES = sorted(PKG.rglob('*.py')) + [REPO / 'chip_smoke.py']


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix('').parts
    return '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


def _forbidden(name: str) -> bool:
    return name.split('.')[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    modules = [_module_name(p) for p in SOURCES if p.parent != REPO]
    assert 'unet_tpu_torch.cli.serve' in modules
    code = ('import importlib, json, sys\n'
            f'for m in {modules!r}:\n'
            '    importlib.import_module(m)\n'
            'print(json.dumps(sorted(sys.modules)))\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(REPO)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(modules) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []
