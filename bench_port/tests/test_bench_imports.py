"""What the harness loads: no module whose top-level name, compared whole,
is ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
(``repro_torch`` passes), after a whole tiny run; no read of the JAX
package's ``benchmarks/``; the references import nothing of the
program."""
import ast
import subprocess
import sys

import tiny

SRC = tiny.ROOT / "bench_port"


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import tiny\n"
        "from bench_port import harness, calibrate\n"
        "for kind in ('moe', 'rwkv'):\n"
        "    tiny.run(tiny.spec(kind), seconds=1.0)\n"
        "for p in (tiny.ROOT / 'bench_port' / 'metrics').glob('*.py'):\n"
        "    harness.reader(p.stem)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.banned_modules())\n" % str(SRC / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tiny.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    tops, banned = out.stdout.strip().splitlines()[-2:]
    assert banned == "[]", tops
    assert "'repro_torch'" in tops


def test_the_comparison_counts_names_whole(monkeypatch):
    from bench_port import harness
    for m in [m for m in sys.modules if m.split(".")[0] in harness.BANNED]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serve", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.banned_modules() == ["jax", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_reads_the_jax_packages_benchmarks():
    for p in SRC.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text, p
        assert not any(m.split(".")[0] in ("benchmarks", "repro", "jax")
                       for m in _imports(p)), p


def test_references_import_nothing_of_the_program():
    for p in (SRC / "reference").glob("*.py"):
        mods = {m.split(".")[0] for m in _imports(p)}
        assert mods <= {"__future__", "typing", "numpy", "torch"}, (p, mods)
