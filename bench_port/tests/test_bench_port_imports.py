"""The harness measures the port alone: no file of it imports JAX, flax or
the JAX package, the reference imports nothing of the port, and a run leaves
none of them loaded."""

import ast
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

from bench_port.harness import BANNED

HARNESS = ROOT / "bench_port"


def imported_tops(path: Path):
    """(top-level name, relative level) of every import in ``path``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HARNESS.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {name for name, level in imported_tops(f) if level == 0}
        assert not tops & set(BANNED), (f, tops & set(BANNED))


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "torch", "numpy"}
    for f in sorted((HARNESS / "reference").rglob("*.py")):
        for name, level in imported_tops(f):
            if level == 0:
                assert name in allowed, (f, name)
            else:
                assert level == 1, (f, name)  # its own siblings only


def test_whole_names_are_compared():
    from bench_port import harness

    saved = dict(sys.modules)
    try:
        sys.modules["dat_segmentation_tpu_torch_x"] = sys
        assert "dat_segmentation_tpu" not in harness.banned_modules()
        sys.modules["dat_segmentation_tpu.models"] = sys
        assert "dat_segmentation_tpu" in harness.banned_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_small_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from conftest import tiny_files\n"
        "from bench_port import harness\n"
        "cell = harness.load_cell('fpn_tiny.serve.b16', 5, 0.2, False, 'cpu', time.perf_counter(),"
        " files=tiny_files('tiny_fpn', 'serve', 'serve'))\n"
        "out, _ = harness.run_cell(cell)\n"
        "print(out['correct'], harness.banned_modules())\n"
    ) % (str(ROOT), str(HARNESS / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the card's run is the benchmark itself
    res = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "fpn_tiny.serve.b16",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 2
    assert res.stdout == ""
