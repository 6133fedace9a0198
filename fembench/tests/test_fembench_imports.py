"""No run loads jax, jaxlib, flax or the JAX package fem_simulation_tpu,
compared on whole top-level names (the program's name begins with the JAX
package's); the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from fembench import run

from .conftest import REPO

FEMBENCH = os.path.join(REPO, "fembench")
# the benchmark's own yardstick: what may not import the program
YARDSTICK = ("reference.py", "geometry.py", "meshgen.py", "bounds.py",
             "trace.py", "traffic.py")


def imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    for dp, _, fs in os.walk(FEMBENCH):
        if os.sep + "tests" in dp:
            continue
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        names = set(imported_names(path))
        assert not names & set(run.FORBIDDEN), path


def test_the_yardstick_imports_nothing_of_the_program():
    for f in YARDSTICK:
        assert "fem_simulation_tpu_torch" not in set(
            imported_names(os.path.join(FEMBENCH, f))), f


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "fem_simulation_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "fem_simulation_tpu.sim", sys)
    assert set(run.forbidden_modules()) - base == {"fem_simulation_tpu"}


def test_a_run_loads_none_and_the_reference_none_of_the_program(tiny_root):
    code = (
        "import sys\n"
        "from fembench import reference, geometry, meshgen, bounds, trace\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] == 'fem_simulation_tpu_torch'], 1\n"
        "from fembench import run\n"
        f"r = run.run_cell({tiny_root!r}, 'tinybeam.frames', 5, 0.3, False,\n"
        "                 device='cpu', log=lambda *a: None)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'fem_simulation_tpu_torch' in top\n"
        "assert not top & {'jax', 'jaxlib', 'flax', 'fem_simulation_tpu'}, "
        "top\n"
        "print('ok', r['correct'])\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["ok", "True"]
