"""The kernel build's staleness rule, held on the CPU with ``nvcc``
replaced by a stub script: ``unet_tpu_torch/ops/_build.py`` compiles
``csrc/<name>.cu`` when its library is missing or older than the source
or than any shared header ``csrc/*.cuh``, keeps the compiler's report,
and on a failing compiler raises with its output and leaves no library.
Then the launch seam, ``_build.Kernels``, with a fake library in place of
a CDLL: error codes, the tally of launches, binding once.
"""

import ctypes
import os
import stat
import time

import pytest

from unet_tpu_torch.ops import _build

STUB = """#!/bin/sh
# stands in for nvcc: writes its -o target, reports like ptxas -v
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  src="$1"
  shift
done
echo "ptxas info    : Used 32 registers, used 1 barriers" >&2
if [ -e "$(dirname "$0")/fail" ]; then
  echo "stub: error: identifier is undefined" >&2
  echo "partial" > "$out"
  exit 1
fi
echo "compiled $src" > "$out"
echo "$src" >> "$(dirname "$0")/calls"
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ with two sources and one header, an empty build/, and a
    CUDA_HOME whose bin/nvcc is the stub. Returns (csrc, build, bin)."""
    csrc, build, bindir = (tmp_path / 'csrc', tmp_path / 'build',
                           tmp_path / 'cuda' / 'bin')
    csrc.mkdir()
    bindir.mkdir(parents=True)
    for name in ('alpha', 'beta'):
        (csrc / f'{name}.cu').write_text(f'#include "shared.cuh"\n// {name}\n')
    (csrc / 'shared.cuh').write_text('#pragma once\n')
    nvcc = bindir / 'nvcc'
    nvcc.write_text(STUB)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'cuda'))
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD', build)
    monkeypatch.setattr(_build, 'SOURCES', ('alpha', 'beta'))
    return csrc, build, bindir


def calls(bindir):
    f = bindir / 'calls'
    return f.read_text().splitlines() if f.exists() else []


def age(path, seconds):
    """Move a file's mtime ``seconds`` away from now."""
    t = time.time() + seconds
    os.utime(path, (t, t))


def test_missing_library_is_built_and_report_kept(tree):
    csrc, build, bindir = tree
    assert _build.is_stale('alpha')
    so = _build.build('alpha')
    assert so == build / 'libalpha.so'
    assert so.read_text().startswith('compiled')
    assert calls(bindir) == [str(csrc / 'alpha.cu')]
    log = (build / 'alpha.log').read_text()
    assert 'Used 32 registers' in log and 'sm_90a' in log
    assert not list(build.glob('*.tmp'))


def test_fresh_library_is_kept(tree):
    csrc, build, bindir = tree
    for f in csrc.iterdir():
        age(f, -100)
    _build.build('alpha')
    assert not _build.is_stale('alpha')
    _build.build('alpha')
    assert len(calls(bindir)) == 1


@pytest.mark.parametrize('touched', ['alpha.cu', 'shared.cuh'])
def test_newer_source_or_header_rebuilds(tree, touched):
    csrc, build, bindir = tree
    for f in csrc.iterdir():
        age(f, -100)
    _build.build('alpha')
    age(build / 'libalpha.so', -50)
    age(csrc / touched, -10)  # newer than the library
    assert _build.is_stale('alpha')
    _build.build('alpha')
    assert len(calls(bindir)) == 2
    assert not _build.is_stale('alpha')


def test_another_source_does_not_rebuild(tree):
    csrc, build, bindir = tree
    for f in csrc.iterdir():
        age(f, -100)
    _build.build('alpha')
    age(build / 'libalpha.so', -50)
    age(csrc / 'beta.cu', -10)
    assert not _build.is_stale('alpha')
    _build.build('alpha')
    assert len(calls(bindir)) == 1


def test_header_rebuilds_every_source(tree):
    csrc, build, bindir = tree
    for f in csrc.iterdir():
        age(f, -100)
    assert set(_build.build_all()) == {'alpha', 'beta'}
    for so in build.glob('*.so'):
        age(so, -50)
    age(csrc / 'shared.cuh', -10)
    _build.build_all()
    assert sorted(calls(bindir)) == sorted(
        [str(csrc / 'alpha.cu'), str(csrc / 'beta.cu')] * 2)


@pytest.mark.parametrize('had_library', [False, True])
def test_failing_compiler_raises_with_its_output(tree, had_library):
    csrc, build, bindir = tree
    if had_library:  # an older good build stays; no half-written one appears
        for f in csrc.iterdir():
            age(f, -100)
        _build.build('alpha')
        age(build / 'libalpha.so', -50)
        age(csrc / 'alpha.cu', -10)
    (bindir / 'fail').write_text('')
    with pytest.raises(RuntimeError, match='identifier is undefined'):
        _build.build('alpha')
    so = build / 'libalpha.so'
    if had_library:
        assert so.read_text().startswith('compiled')
    else:
        assert not so.exists()
    assert not list(build.glob('*.tmp'))
    assert 'identifier is undefined' in (build / 'alpha.log').read_text()


def test_missing_compiler_raises(tree, monkeypatch):
    _, _, bindir = tree
    (bindir / 'nvcc').unlink()
    monkeypatch.delenv('CUDA_HOME')
    monkeypatch.setenv('PATH', str(bindir))
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('a real nvcc is installed')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build('alpha')


@pytest.mark.parametrize('name', _build.SOURCES)
def test_every_source_is_in_the_package(name):
    assert (_build.CSRC / f'{name}.cu').is_file()


@pytest.mark.parametrize('name', ['conv3x3', 'attention_gate'])
def test_tensor_core_kernels_share_the_hopper_header(name):
    assert (_build.CSRC / 'hopper.cuh').is_file()
    text = (_build.CSRC / f'{name}.cu').read_text()
    assert '#include "hopper.cuh"' in text
    for needle in ('wgmma_k16', 'tma_load_4d', 'mbar_wait'):
        assert needle in text, needle


class FakeFunction:
    """Stands in for a ctypes function: takes argtypes and restype, and
    records its calls."""

    def __init__(self, body):
        self.body, self.calls = body, 0
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls += 1
        return self.body(*args)


class FakeLibrary:
    """Stands in for a CDLL: ``fake_launch(code)`` returns ``code``,
    ``fake_error_string`` the message of a code, ``fake_limit()`` 256;
    ``looked_up`` counts each name's lookups."""

    def __init__(self):
        self.looked_up = {}
        self.functions = {
            'fake_launch': FakeFunction(lambda code: code),
            'fake_error_string': FakeFunction(
                lambda code: f'fake error {code}'.encode()),
            'fake_limit': FakeFunction(lambda: 256)}

    def __getattr__(self, name):
        if name not in self.__dict__.get('functions', {}):
            raise AttributeError(name)
        self.looked_up[name] = self.looked_up.get(name, 0) + 1
        return self.functions[name]


@pytest.fixture
def fake(monkeypatch):
    """A ``Kernels`` of the library 'fake' (two kernels a launch, one
    query), its tally entry removed again afterwards."""
    monkeypatch.setitem(_build.launches, 'fake', 0)
    return _build.Kernels('fake', 'fake_error_string', {
        'fake_launch': ([ctypes.c_int], 2), 'fake_limit': ([], 0)})


def test_nonzero_return_raises_with_the_librarys_message(fake):
    fake.bind(FakeLibrary())
    others = {k: v for k, v in _build.launches.items() if k != 'fake'}
    with pytest.raises(RuntimeError,
                       match='^fake kernel launch failed: fake error 7$'):
        fake.fake_launch(7)
    assert _build.launches['fake'] == 0
    assert {k: v for k, v in _build.launches.items() if k != 'fake'} == others


def test_zero_return_counts_under_the_librarys_name(fake):
    fake.bind(FakeLibrary())
    others = {k: v for k, v in _build.launches.items() if k != 'fake'}
    assert fake.fake_launch(0) is None
    fake.fake_launch(0)
    assert _build.launches['fake'] == 4
    assert {k: v for k, v in _build.launches.items() if k != 'fake'} == others


def test_loading_binds_signatures_once(fake, monkeypatch):
    """The first use loads the library and binds every function with its
    signature, reading the query; later uses touch neither."""
    lib, loads = FakeLibrary(), []
    monkeypatch.setattr(_build, 'load',
                        lambda name: loads.append(name) or lib)
    for _ in range(3):
        fake.fake_launch(0)
    assert fake.fake_limit == 256 and fake.lib is lib
    assert loads == ['fake']
    assert lib.looked_up == {'fake_error_string': 1, 'fake_launch': 1,
                             'fake_limit': 1}
    fns = lib.functions
    assert fns['fake_launch'].argtypes == [ctypes.c_int]
    assert fns['fake_limit'].argtypes == [] and fns['fake_limit'].calls == 1
    assert fns['fake_error_string'].argtypes == [ctypes.c_int]
    assert fns['fake_error_string'].restype is ctypes.c_char_p
    assert fns['fake_launch'].calls == 3 and _build.launches['fake'] == 6
