"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program either; names are compared by
their whole top-level part (rendering_tpu_torch is not rendering_tpu)."""

import ast
import os
import sys

import pytest

from harness import registry, runner

JAX_NAMES = {"jax", "jaxlib", "flax", "rendering_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    base = os.path.join(registry.BENCH_DIR, sub)
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_jax_anywhere():
    for path in _files():
        found = set(_imports(path)) & JAX_NAMES
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        found = set(_imports(path)) & {"rendering_tpu_torch", "harness"}
        assert not found, (path, found)


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rendering_tpu_torch_fake", object())
    assert "rendering_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rendering_tpu.models", object())
    assert runner.forbidden_modules() == ["rendering_tpu"]


@pytest.mark.parametrize("text,names", [
    ("import rendering_tpu_torch.cli", {"rendering_tpu_torch"}),
    ("from rendering_tpu.models import scene", {"rendering_tpu"}),
    ("import jax.numpy as jnp", {"jax"}),
])
def test_scanner_reads_top_level_names(tmp_path, text, names):
    p = tmp_path / "m.py"
    p.write_text(text + "\n")
    assert set(_imports(str(p))) == names
