"""No module the harness loads is JAX's or the JAX package, compared by the
whole top-level name: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from . import tiny

BENCH = tiny.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "movie_recommendation_engine_tpu"}


def test_forbidden_modules_compares_whole_names():
    code = ("import sys, types; sys.path.insert(0, %r)\n"
            "from benchmarks import harness\n"
            "import movie_recommendation_engine_tpu_torch\n"
            "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
            "sys.modules['jaxlib.xla'] = types.ModuleType('jaxlib.xla')\n"
            "sys.modules['movie_recommendation_engine_tpu'] = types.ModuleType('m')\n"
            "print(harness.forbidden_modules())\n") % tiny.ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=tiny.ROOT, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "['jaxlib', 'movie_recommendation_engine_tpu']"


def test_no_source_imports_jax_or_reads_its_benchmark_files():
    for dirpath, _, files in os.walk(BENCH):
        if ".cache" in dirpath:
            continue
        for name in files:
            if not name.endswith(".py"):
                continue
            src = open(os.path.join(dirpath, name)).read()
            for node in ast.walk(ast.parse(src)):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] not in FORBIDDEN, (name, m)
            for banned in ("BENCH_r", "MULTICHIP_", "bench.py", "scripts/"):
                assert banned not in src or name == os.path.basename(__file__), (name, banned)


def test_a_run_loads_no_jax(checkout):
    # run_cell's process exits non-zero when it holds a JAX module afterwards.
    out = tiny.run_cell(checkout, "tiny-dense-train", seed=11, seconds=0.5)
    assert out["correct"] is True
