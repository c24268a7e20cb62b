"""Nothing the benchmark runs imports JAX or the JAX package (compared
by whole top-level name: the program's name begins with the JAX
package's), nor the repository's other benchmark programs, scripts or
tests; the reference imports nothing of the program."""

import ast
import os

import pytest

from benchmark import run

JAX = {"jax", "jaxlib", "flax", "mashmap_tpu"}
ELSEWHERE = {"bench_torch", "bench_extra_torch", "scripts", "tests",
             "genomes", "chip_smoke", "port_fixtures"}
FILES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(run.HERE) for f in fs
    if f.endswith(".py") and "cache" not in os.path.relpath(d, run.HERE))


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, run.HERE) for p in FILES])
def test_no_jax_and_nothing_from_elsewhere(path):
    names = set(imported(path))
    assert not names & JAX
    assert not names & ELSEWHERE
    if os.path.relpath(path, run.HERE).startswith("reference"):
        assert not names & {"mashmap_tpu_torch", "benchmark"}


def test_forbidden_names_are_whole_top_level_names():
    assert set(run.FORBIDDEN) == JAX
    assert "mashmap_tpu_torch".split(".")[0] not in run.FORBIDDEN
