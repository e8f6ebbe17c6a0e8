"""The yardstick stands apart from the program: the reference imports
nothing of the port (nor JAX), checked by top-level module name in a fresh
interpreter, and by the import statements of its files."""

import ast
import subprocess
import sys

from wbcbench.harness import ROOT

YARDSTICK = ("wbcbench.reference", "wbcbench.work", "wbcbench.recipes")
PORT = "libdwbc_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "libdwbc_tpu", PORT}


def test_reference_loads_no_port():
    code = ("import sys; sys.path.insert(0, %r); " % str(ROOT)
            + "; ".join(f"import {m}" for m in YARDSTICK)
            + "; print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    assert not BANNED & set(out), BANNED & set(out)


def test_reference_sources_import_no_port():
    for path in sorted((ROOT / "wbcbench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in BANNED, (path.name, n)
