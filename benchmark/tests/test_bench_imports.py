"""Nothing the benchmark runs on the card loads JAX or the JAX package,
and the reference loads nothing of the program. Module names are compared
by their top-level name whole: ``pysco_tpu_torch`` is not ``pysco_tpu``."""

import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "pysco_tpu"}


def _loaded(code: str) -> set:
    prog = ("import sys, json\n"
            f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n" + code +
            "\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def _modules(sub: str) -> list:
    return sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, sub))
                  if f.endswith(".py"))


def _import_reference() -> str:
    """Code that imports every module under ``reference/``: the shared
    reference and each configuration's own."""
    return "".join(f"import reference.{m}\n" for m in _modules("reference"))


def test_harness_and_reference_load_no_jax():
    top = _loaded(
        "import run, cell, check, loop, devtrace, yardstick\n"
        + _import_reference() + "import pysco_tpu_torch.main\n"
        f"for m in {_modules('metrics')!r}: cell.metric_reader(m)\n")
    assert "pysco_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = _loaded(_import_reference())
    assert not top & (FORBIDDEN | {"pysco_tpu_torch"})


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in FORBIDDEN | {"pysco_tpu_torch"}, (
                    f"{f} imports {m}")
