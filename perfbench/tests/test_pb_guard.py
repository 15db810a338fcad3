"""The harness's refusals: forbidden modules by whole top-level name, no
result without a card, and no result in a directory without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import pb_helpers  # noqa: F401  (puts the repository on sys.path)
from perfbench.lib import core


def test_guard_catches_the_jax_package():
    assert core.forbidden_loaded({"stabletts_tpu.ops.dit_block_pallas": 1, "os": 1}) == ["stabletts_tpu"]
    assert core.forbidden_loaded({"jax": 1, "jax.numpy": 1}) == ["jax"]
    assert core.forbidden_loaded({"flax.linen": 1, "jaxlib": 1}) == ["flax", "jaxlib"]


def test_guard_passes_the_port():
    assert core.forbidden_loaded({"stabletts_torch": 1, "stabletts_torch.api": 1, "jaxtyping": 1,
                                  "stabletts_tpu_torch": 1}) == []


def test_guard_catches_a_planted_import(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "stabletts_tpu", types.ModuleType("stabletts_tpu"))
    assert "stabletts_tpu" in core.forbidden_loaded()
    monkeypatch.delitem(sys.modules, "stabletts_tpu")


def test_cli_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(core.PKG_DIR, "run.py"), "--workload", "serve_batch_bf16",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=env,
                       cwd=core.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_cli_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ gives no result."""
    root = tmp_path / "bare"
    shutil.copytree(core.PKG_DIR, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root)
    run = core.load_module(str(root / "perfbench" / "run.py"), "pb_run_bare")
    cell = core.Cell("serve_batch_bf16", str(root))
    env_path = list(sys.path)
    try:
        sys.path[:] = [p for p in sys.path if os.path.abspath(p) != core.ROOT]
        saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == "stabletts_torch"}
        with pytest.raises(ImportError):
            run.run(cell, 1, 0.1, False, "cpu")
    finally:
        sys.path[:] = env_path
        sys.modules.update(saved)


def test_benchmark_sources_import_no_jax():
    import ast

    for dp, _, files in os.walk(core.PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                tree = ast.parse(open(os.path.join(dp, name)).read())
                for node in ast.walk(tree):
                    mods = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                        [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
                    assert all(m.split(".")[0] not in core.FORBIDDEN for m in mods), (name, mods)
