"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level names (the port's name begins with the JAX package's); the
reference imports nothing of the port; without a card the command exits
with an error and prints no result."""

import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH, REPO
from fovbench import harness

JAX_PACKAGE = "fovpathtracing_optixcodelatest_tpu"
PORT = JAX_PACKAGE + "_torch"


def test_banned_modules_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            JAX_PACKAGE, JAX_PACKAGE + ".ops", PORT, PORT + ".ops.rng",
            "jaxtyping", "flaxen", "numpy"]
    assert harness.banned_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", JAX_PACKAGE,
         JAX_PACKAGE + ".ops"])


def test_the_benchmark_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import fovbench.run, fovbench.harness, fovbench.control\n"
            "import fovbench.reference.render\n"
            "from fovbench import harness\n"
            "for m in ('config', 'render.renderer', 'parallel.stereo',\n"
            "          'models.scene', 'ops.traverse'):\n"
            "    __import__(%r + '.' + m)\n"
            "import glob, os\n"
            "for p in glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
            "    harness.load_metric(%r, os.path.basename(p)[:-3])\n"
            "print(harness.banned_modules(list(sys.modules)))\n"
            % (REPO, PORT, BENCH, BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py")) + [
        os.path.join(BENCH, "check.py"), os.path.join(BENCH, "control.py"),
        os.path.join(BENCH, "traffic.py")]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in (PORT, JAX_PACKAGE, "jax"), \
                (path, name)


def test_without_a_card_there_is_no_result(tmp_path):
    """Here (no CUDA) the command exits 2 and prints nothing on standard
    output; so it does from a tree holding only BENCHMARK.json and
    fovbench/."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "fovbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "fovbench/run.py", "--workload",
             "boxcity262k.fixate", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0 and out.stdout == "", out
