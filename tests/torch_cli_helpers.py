"""Helpers of tests/test_torch_io_*.py and tests/test_torch_cli_modes.py:
run one tool of `waverange_tpu_torch.cli` and the same tool of the
reference, the same way, each in its own directory.

The reference is either the JAX package's CLI on its native backend
(`waverange_tpu.cli`, which tests/test_generic_cli.py, test_mssg.py,
test_flusi.py and test_cli_modes.py hold byte-identical to the reference
binaries), or the reference binaries themselves, which skip where they
cannot be built, as the `oracle` fixture does.
"""
import contextlib
import importlib
import io
import os
import subprocess
import sys

import pytest

from conftest import ORACLE, REPO

ORACLE_EXE = {"wrenc": "wrenc", "wrdec": "wrdec", "mssg_enc": "wrmssgenc",
              "mssg_dec": "wrmssgdec", "flusi_enc": "wrencflusi",
              "flusi_dec": "wrdecflusi"}


@contextlib.contextmanager
def _env(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_tool(package, tool, args, cwd, stdin=None, env=None, child=False):
    """Run `<package>.cli.<tool>` with argv `args` in `cwd` and `env`, with
    `stdin` as its standard input: in this process, or with `child` as
    `python -m` in a child process."""
    args = [str(a) for a in args]
    env = env or {}
    if not child:
        mod = importlib.import_module(f"{package}.cli.{tool}")
        old, old_stdin = os.getcwd(), sys.stdin
        os.chdir(cwd)
        sys.stdin = io.StringIO(stdin or "")
        try:
            with _env(env):
                assert mod.main(args) == 0
        finally:
            os.chdir(old)
            sys.stdin = old_stdin
        return
    full = dict(os.environ, **env)
    full["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])
    r = subprocess.run([sys.executable, "-m", f"{package}.cli.{tool}", *args],
                       cwd=cwd, input=stdin or "", text=True,
                       capture_output=True, env=full, timeout=300)
    assert r.returncode == 0, (tool, r.stdout[-500:], r.stderr[-2000:])


def port(tool, args, cwd, stdin=None, backend="torch", coder="range"):
    """The port's tool on the CPU (WR_DEVICE=cpu) with the given backend;
    fed `stdin`, it runs as `python -m`, as a user runs it."""
    run_tool("waverange_tpu_torch", tool, args, cwd, stdin,
             {"WR_DEVICE": "cpu", "WR_BACKEND": backend, "WR_CODER": coder},
             child=stdin is not None)


def package(tool, args, cwd, stdin=None, coder="range"):
    """The JAX package's tool on its native backend."""
    run_tool("waverange_tpu", tool, args, cwd, stdin,
             {"WR_BACKEND": "native", "WR_CODER": coder})


def oracle_exe(tool):
    """The reference binary of `tool` (the `oracle` fixture has built the
    generic and MSSG ones); skips where the FluSI ones cannot be built."""
    if tool.startswith("flusi"):
        from test_flusi import _flusi_oracle
        enc, dec = _flusi_oracle()
        return enc if tool == "flusi_enc" else dec
    return str(ORACLE / ORACLE_EXE[tool])


def _run_oracle(tool, args, cwd, stdin=None):
    subprocess.run([oracle_exe(tool), *[str(a) for a in args]], cwd=cwd,
                   input=stdin or "", text=True, check=True,
                   capture_output=True)


@pytest.fixture(params=["package", "oracle"])
def reference(request):
    """A runner `(tool, args, cwd, stdin=None)` of the reference tool."""
    if request.param == "package":
        return package
    request.getfixturevalue("oracle")  # skips where it cannot be built
    return _run_oracle


def dirs(tmp_path, make):
    """Two directories, `r` for the reference and `p` for the port, each
    set up by `make(dir)`."""
    out = []
    for name in ("r", "p"):
        d = tmp_path / name
        d.mkdir()
        make(d)
        out.append(d)
    return out


def same_files(a, b, names):
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
