"""Nothing the harness or the reference imports is JAX or the JAX package,
and the reference imports nothing of the program: every module they
import, followed through the benchmark's own files, by top-level name."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "qwen3tts_tpu"}
LOCAL = {p.stem for p in HERE.glob("*.py")} | {"reference", "counts", "drivers"}


def _imports(path: Path):
    """Top-level names and local modules a file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _local_file(name: str):
    parts = name.split(".")
    if parts[0] not in LOCAL:
        return None
    for n in range(len(parts), 0, -1):
        for f in (HERE.joinpath(*parts[:n]).with_suffix(".py"),
                  HERE.joinpath(*parts[:n], "__init__.py")):
            if f.is_file():
                return f
    return None


def closure(start):
    """Every top-level module name reachable from ``start`` files."""
    seen_files, names, todo = set(), set(), list(start)
    while todo:
        f = todo.pop()
        if f in seen_files:
            continue
        seen_files.add(f)
        for name in _imports(f):
            local = _local_file(name)
            if local is not None:
                todo.append(local)
            else:
                names.add(name.split(".")[0])
    return names, seen_files


def test_harness_imports_no_jax():
    start = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    names, _ = closure(start)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "qwen3tts_tpu_torch" in names  # the port is what is measured


def test_reference_imports_nothing_of_the_program():
    names, files = closure(sorted((HERE / "reference").glob("*.py")))
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names
    assert all(HERE / "reference" in f.parents for f in files)


def test_harness_modules_load_without_jax():
    """Importing every module of the harness, the port's that it names too,
    loads no JAX in the process (names compared whole: the port's begins
    with the JAX package's)."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, harness, calibrate, sweep, drivers.serve, drivers.stream\n"
            "import drivers.batch, counts.qwen3tts\n"
            "import qwen3tts_tpu_torch.api.model, qwen3tts_tpu_torch.runtime.scheduler\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))"
            % (str(HERE), str(ROOT), FORBIDDEN))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("name,whole", [("qwen3tts_tpu_torch.api", "qwen3tts_tpu_torch"),
                                        ("jax.numpy", "jax"),
                                        ("qwen3tts_tpu.core", "qwen3tts_tpu")])
def test_top_level_names_compare_whole(name, whole):
    sys.path.insert(0, str(HERE))
    import run

    assert (name.split(".")[0] in run.FORBIDDEN) == (whole in FORBIDDEN)
