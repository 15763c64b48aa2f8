"""The port's AST lint (``ringpop_tpu_torch/analysis/lint.py``).

Each rule is flagged on a snippet and silenced by the pragma on the
line, on a comment line right above it, or on the enclosing ``def``; a
pragma naming another code silences nothing.  The port's tree and
``chip_smoke.py`` lint clean, and the audit's modules import neither
jax nor the reference package.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from ringpop_tpu_torch.analysis import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rule -> (snippet with one hit at the marked line, compiled_path)
CASES = {
    "RPL001": ("import torch\n\ndef f(t):\n    return t.sum().item()  # HIT\n", True),
    "RPL002": ("import numpy as np\n\ndef step_impl(t):\n    return np.maximum(t, 0)  # HIT\n",
               False),
    "RPL003": ("def f(x, t):\n    return x[t.argmax()]  # HIT\n", True),
    "RPL004": ("import time\n\ndef tick_impl(s):\n    s.t = time.perf_counter()  # HIT\n    "
               "return s\n", False),
    "RPL005": ("import torch\n\ndef f(n):\n    return torch.zeros(n)  # HIT\n", True),
    "RPL006": ("import jax.numpy as jnp  # HIT\n", False),
}


def _hits(src: str, compiled: bool) -> list[str]:
    return [f.contract for f in lint.lint_source(src, "mod.py", compiled_path=compiled)]


@pytest.mark.parametrize("code", sorted(CASES))
def test_rule_flags_and_pragma_silences(code):
    src, compiled = CASES[code]
    assert _hits(src, compiled) == [f"lint:{code}"]
    line = next(i for i, ln in enumerate(src.splitlines()) if "# HIT" in ln)
    lines = src.splitlines()
    on_line = "\n".join(ln.replace("# HIT", f"# audit: allow={code} by design") for ln in lines)
    assert _hits(on_line, compiled) == []
    indent = lines[line][: len(lines[line]) - len(lines[line].lstrip())]
    above = "\n".join(lines[:line] + [f"{indent}# audit: allow={code} by design"] + lines[line:])
    assert _hits(above, compiled) == []
    bare = "\n".join(ln.replace("# HIT", "# audit: allow") for ln in lines)
    assert _hits(bare, compiled) == []
    other = "\n".join(ln.replace("# HIT", "# audit: allow=RPL999 not this one") for ln in lines)
    assert _hits(other, compiled) == [f"lint:{code}"]


def test_def_pragma_covers_the_function():
    src = ("import torch\n\n"
           "# audit: allow=RPL001 host-side by design\n"
           "def host(t):\n    a = t.cpu()\n    return int(t.max()), a.numpy()\n\n"
           "def other(t):\n    return t.tolist()\n")
    found = lint.lint_source(src, "m.py", compiled_path=True)
    assert [(f.contract, f.where) for f in found] == [("lint:RPL001", "m.py:9")]


@pytest.mark.parametrize("src,hits", [
    ("def f(t):\n    return int(t.sum())\n", ["lint:RPL001"]),
    ("import numpy as np\n\ndef f(a):\n    return int(np.max(a))\n", []),
    ("def f(t):\n    return bool(t.any(dim=0).all())\n", ["lint:RPL001"]),
    ("def f(x, t):\n    return x[t.max(dim=1).indices]\n", []),
    ("import torch\n\ndef f(x, t):\n    return x[torch.argmax(t)]\n", ["lint:RPL003"]),
    ("import torch\n\ndef f(n, d):\n    return torch.arange(n, device=d)\n", []),
    ("def f(e):\n    e.synchronize()\n", ["lint:RPL001"]),
    ("from ringpop_tpu.ops import farmhash\n", ["lint:RPL006"]),
    ("import ringpop_tpu_torch.prng\n", []),
])
def test_rule_edges(src, hits):
    assert _hits(src, True) == hits


def test_impl_rules_reach_nested_functions_only_there():
    src = ("import numpy as np\n\ndef host(a):\n    return np.sum(a)\n\n"
           "def step_impl(t):\n    def body(x):\n        return np.sum(x)\n    return body(t)\n")
    found = lint.lint_source(src, "m.py", compiled_path=False)
    assert [(f.contract, f.where) for f in found] == [("lint:RPL002", "m.py:8")]


def test_port_tree_lints_clean():
    found = lint.lint_paths(extra=[os.path.join(REPO, "chip_smoke.py")])
    assert [str(f) for f in found] == []


def test_audit_imports_no_jax():
    code = ("import sys\n"
            "import ringpop_tpu_torch.analysis.cli, ringpop_tpu_torch.analysis.contracts\n"
            "import ringpop_tpu_torch.analysis.planted\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'ringpop_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
