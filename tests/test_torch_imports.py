"""The port stands alone: no module of mashmap_tpu_torch imports JAX or
the JAX package, and its entry points default to the CUDA device."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mashmap_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "mashmap_tpu")


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    mods = list(_modules())
    assert len(mods) > 20
    parallel = {os.path.basename(p) for p in mods
                if os.path.basename(os.path.dirname(p)) == "parallel"}
    assert parallel == {"__init__.py", "mesh.py", "sharded_index.py",
                        "distributed.py"}
    bad = [(os.path.relpath(p, ROOT), r) for p in mods
           for r in _imported_roots(p) if r in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mashmap_tpu'] = None; "
            "import mashmap_tpu_torch.api, mashmap_tpu_torch.map.engine, "
            "mashmap_tpu_torch.cli, mashmap_tpu_torch.align.driver, "
            "mashmap_tpu_torch.align.cli, mashmap_tpu_torch.native, "
            "mashmap_tpu_torch.progress, mashmap_tpu_torch.parallel.mesh, "
            "mashmap_tpu_torch.parallel.sharded_index, "
            "mashmap_tpu_torch.parallel.distributed, "
            "mashmap_tpu_torch.kernels.graphs; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules if sys.modules[m] is not None)")
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("script", ["scripts/flagship_torch.py",
                                    "chip_smoke.py", "bench_torch.py",
                                    "bench_extra_torch.py"])
def test_port_scripts_import_neither(script):
    """The port's scripts that run on the card import neither JAX nor the
    JAX package, by their source and when imported with both blocked."""
    path = os.path.join(ROOT, script)
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, bad
    code = ("import sys, importlib.util; sys.modules['jax'] = None; "
            "sys.modules['mashmap_tpu'] = None; "
            f"spec = importlib.util.spec_from_file_location('m', {path!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_package_entry_points_are_lazy():
    """``mashmap_tpu_torch.map_files`` and ``build_or_load_index`` exist,
    as in the JAX package's __init__, and importing the package loads
    neither JAX nor the modules behind them."""
    code = ("import sys; import mashmap_tpu_torch as m; "
            "assert callable(m.map_files) and "
            "callable(m.build_or_load_index); "
            "assert 'mashmap_tpu_torch.api' not in sys.modules; "
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_package_entry_points_call_the_api(monkeypatch):
    """The lazy entry points hand their arguments, the device included,
    to api.map_files and api.build_or_load_index."""
    import mashmap_tpu_torch as m
    from mashmap_tpu_torch import api
    seen = []
    monkeypatch.setattr(api, "map_files",
                        lambda *a, **kw: seen.append(("map", a, kw)))
    monkeypatch.setattr(api, "build_or_load_index",
                        lambda *a, **kw: seen.append(("build", a, kw)))
    m.map_files("p", "idx", device="cpu")
    m.build_or_load_index("p", device="cpu")
    assert seen == [("map", ("p", "idx"), {"device": "cpu",
                                           "devices": None}),
                    ("build", ("p", "cpu"), {})]


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without a device argument the entry points ask for CUDA and raise
    on a host without it, instead of running on the CPU."""
    import torch
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.index.builder import build_index
    from mashmap_tpu_torch.params import Parameters
    from mashmap_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 300 + "\n")
    p = Parameters(ref_sequences=[str(fa)], out_file_name=str(tmp_path / "o"),
                   kmer_size=11, seg_length=500, sketch_size=8,
                   no_progress=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        map_files(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index([("c", "ACGT" * 300)], 11, 500, 8)
    assert not (tmp_path / "o").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """The mapper CLI, the aligner CLI and align_files ask for CUDA
    without a device argument and raise on a host without it."""
    import torch
    from mashmap_tpu_torch import cli
    from mashmap_tpu_torch.align import cli as align_cli
    from mashmap_tpu_torch.align.driver import align_files

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 300 + "\n")
    mp = tmp_path / "m.out"
    mp.write_text("c 1200 0 1199 + c 1200 0 1199 100.0\n")
    out = str(tmp_path / "o")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-r", str(fa), "--noProgress", "-o", out])
    with pytest.raises(RuntimeError, match="CUDA"):
        align_cli.main(["-s", str(fa), "-q", str(fa), "--mappingFile",
                        str(mp), "--pi", "80", "-o", out])
    with pytest.raises(RuntimeError, match="CUDA"):
        align_files([str(fa)], [str(fa)], str(mp), 80.0, out)
    assert not (tmp_path / "o").exists()
