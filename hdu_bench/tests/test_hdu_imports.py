"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "hdu_bench"

PROBE = r"""
import importlib, importlib.util, json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
bench = Path({bench!r})
loaded = {{}}
for mod in {modules!r}:
    importlib.import_module(mod)
ref_only = sorted({{m.split(".")[0] for m in sys.modules}})
for i, p in enumerate(sorted(bench.rglob("*.py"))):
    if "tests" in p.parts:
        continue
    if (p.parent / "__init__.py").exists():  # a package module, by its dotted name
        importlib.import_module(".".join(p.relative_to(bench.parent).with_suffix("").parts))
        continue
    spec = importlib.util.spec_from_file_location(f"probe_{{i}}", p)  # a file found by name
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
print(json.dumps({{"after_reference": ref_only,
                  "after_all": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _probe(modules):
    code = PROBE.format(root=str(ROOT), bench=str(BENCH), modules=modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_and_a_reference_free_of_the_program():
    tops = _probe(["hdu_bench.reference.models", "hdu_bench.reference.serve",
                   "hdu_bench.reference.train"])
    forbidden = {"jax", "jaxlib", "flax", "hdenseunet_tpu"}
    assert not forbidden & set(tops["after_all"]), tops["after_all"]
    assert "hdenseunet_tpu_torch" not in tops["after_reference"]
    assert "hdu_bench" in tops["after_reference"]


def test_a_run_imports_the_program_and_nothing_forbidden():
    """The runners' program imports, done, leave no forbidden name."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r});"
            "import hdenseunet_tpu_torch.infer.predictor, hdenseunet_tpu_torch.train.trainer;"
            "from hdu_bench import harness; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
