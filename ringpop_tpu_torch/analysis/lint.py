"""AST-level lint for the port's own hazards in its source.

The port of ``ringpop_tpu/analysis/lint.py``, with the hazards of eager
PyTorch on a card in place of those of a traced program:

* **RPL001 host-read** — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``bool()``/``int()``/``float()`` of a tensor reduction,
  or a ``synchronize()`` in a compiled-path module: each waits for the
  card's queue to drain (a host sync).  Module-wide in
  ``COMPILED_PATH_DIRS``: a drain is a drain wherever the call sits.
  ``.tolist()`` and ``.numpy()`` dispatch no ATen op, so the audit's CPU
  count of host reads cannot see them; this rule can.
* **RPL002 numpy-on-tensor** — ``np.*`` calls or ``.numpy()`` inside a
  ``*_impl`` function: numpy on a CUDA tensor raises, on a host copy it
  is a read back.
* **RPL003 scalar-index** — an index built from a tensor reduction
  (``x[t.argmax()]``, ``x[i, t.sum()]``): a 0-dim tensor used as an
  index is read back to the host (one sync a tick in ``converged_impl``
  until it became a one-row ``index_select``).  Module-wide in
  compiled-path modules, in ``*_impl`` functions elsewhere.
* **RPL004 wallclock-in-impl** — ``time.time`` / ``perf_counter`` /
  ``datetime.now`` inside a ``*_impl`` function: a host clock read in
  the step makes its result depend on the host's pacing.
* **RPL005 host-factory** — ``torch.tensor``, ``zeros``, ``empty``,
  ``arange`` and the like with no ``device=`` in a compiled-path module:
  a tensor made on the CPU and then moved (a copy a call) or left there.
* **RPL006 reference-import** — any ``jax`` or ``ringpop_tpu`` import in
  the port or ``chip_smoke.py``: the port imports torch, numpy and the
  standard library only.

**Impl functions** are those named ``*_impl`` and every function nested
in one (the port keeps the reference's names for the functions its
programs were traced from).  Suppress a true-but-intended hit with a
``# audit: allow`` or ``# audit: allow=RPL001,RPL005`` comment followed
by the reason: on any line the flagged node spans or on a comment line
right above it, or on the ``def`` line of the enclosing function (or a
comment line right above the function) to cover all of it.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

from ringpop_tpu_torch.analysis.findings import Finding

# The port's modules on the card's path: a host read here stalls the
# card's queue whatever function it sits in.  obs/, cli/ and analysis/
# are host-side by design and get the impl-function rules only.
COMPILED_PATH_DIRS = ("models", "scenarios", "traffic", "ops", "parallel", "policies")

_ALLOW_RE = re.compile(r"#\s*audit:\s*allow(?:=(?P<codes>[\w,]+))?")

_WALLCLOCK_CALLS = {
    ("time", "time"),
    ("time", "perf_counter"),
    ("time", "monotonic"),
    ("time", "process_time"),
    ("datetime", "now"),
    ("datetime", "utcnow"),
}

_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
# methods and torch functions whose no-dim form gives a 0-dim tensor
_REDUCTIONS = {"sum", "max", "min", "amax", "amin", "any", "all", "argmax", "argmin",
               "prod", "mean", "count_nonzero"}
# receivers whose reductions are host values, not tensors
_HOST_ROOTS = {"np", "numpy", "math", "builtins", "statistics"}
_FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange", "linspace",
              "logspace", "eye", "rand", "randn", "randint", "randperm", "empty_strided",
              "tril_indices", "triu_indices", "scalar_tensor"}
# numpy names that are types or constants, not computations
_NP_TYPES = {"ndarray", "dtype", "int32", "int64", "float32", "float64", "bool_", "uint32",
             "int8", "uint8", "int16", "uint16", "newaxis", "iinfo", "finfo"}
_BANNED_IMPORTS = ("jax", "jaxlib", "ringpop_tpu")


@dataclasses.dataclass
class _Ctx:
    impl: bool
    func: str
    allow: set[str] | None  # codes the def line allows (None: all)
    allow_any: bool


def _dotted(node: ast.expr) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node: ast.expr) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_reduction_call(node: ast.expr, *, no_dim: bool) -> bool:
    """``t.sum()`` / ``torch.argmax(t)`` style calls on a tensor
    (``no_dim``: only the forms that reduce to a 0-dim tensor)."""
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr not in _REDUCTIONS or _root_name(node.func) in _HOST_ROOTS:
        return False
    if not no_dim:
        return True
    if any(kw.arg in ("dim", "axis") for kw in node.keywords):
        return False
    # torch.argmax(t) takes the tensor positionally; t.argmax() takes none
    torch_fn = _dotted(node.func.value) == "torch"
    return len(node.args) == (1 if torch_fn else 0)


def _holds_reduction(node: ast.expr) -> bool:
    return any(_is_reduction_call(sub, no_dim=False) for sub in ast.walk(node))


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, compiled_path: bool):
        self.path = path
        self.lines = source.splitlines()
        self.compiled_path = compiled_path
        self.findings: list[Finding] = []
        self.stack: list[_Ctx] = []

    # -- helpers ------------------------------------------------------------

    def _pragma(self, line: int, comment_only: bool = False) -> tuple[bool, set[str] | None]:
        if not 1 <= line <= len(self.lines):
            return False, None
        text = self.lines[line - 1]
        m = _ALLOW_RE.search(text)
        if not m or (comment_only and not text.lstrip().startswith("#")):
            return False, None
        codes = m.group("codes")
        return True, None if codes is None else set(codes.split(","))

    def _allowed(self, node: ast.AST, code: str) -> bool:
        first = node.lineno
        last = getattr(node, "end_lineno", None) or first
        for ln in range(first - 1, last + 1):
            hit, codes = self._pragma(ln, comment_only=ln < first)
            if hit and (codes is None or code in codes):
                return True
        for ctx in self.stack:
            if ctx.allow_any and (ctx.allow is None or code in ctx.allow):
                return True
        return False

    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        if self._allowed(node, code):
            return
        self.findings.append(
            Finding(
                contract=f"lint:{code}",
                severity="error",
                entry=self.path,
                message=message,
                where=f"{self.path}:{node.lineno}",
            )
        )

    @property
    def _in_impl(self) -> bool:
        return any(c.impl for c in self.stack)

    @property
    def _func(self) -> str:
        return self.stack[-1].func if self.stack else "<module>"

    # -- scope tracking -----------------------------------------------------

    def _visit_func(self, node) -> None:
        top = min([node.lineno] + [d.lineno for d in node.decorator_list])
        hit, codes = self._pragma(node.lineno)
        if not hit:
            hit, codes = self._pragma(top - 1, comment_only=True)
        self.stack.append(_Ctx(impl=node.name.endswith("_impl") or self._in_impl,
                               func=node.name, allow=codes, allow_any=hit))
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- checks -------------------------------------------------------------

    def _check_import(self, node: ast.AST, module: str) -> None:
        head = module.split(".")[0]
        if head in _BANNED_IMPORTS:
            self._emit(node, "RPL006",
                       f"import of {module!r}: the port imports torch, numpy and the "
                       "standard library only, never jax or the reference package")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and not node.level:
            self._check_import(node, node.module)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        if self.compiled_path:
            if attr in _READ_METHODS:
                self._emit(node, "RPL001",
                           f".{attr}() in a compiled-path module: a host read that waits "
                           "for the card's queue — keep the value on the device, or mark "
                           "'# audit: allow=RPL001 <reason>'")
            elif attr == "synchronize":
                self._emit(node, "RPL001",
                           f"{name or 'synchronize'}() in a compiled-path module: a drain "
                           "point — drain in the caller that owns the pacing")
            elif (isinstance(node.func, ast.Name) and node.func.id in ("bool", "int", "float")
                  and node.args and _holds_reduction(node.args[0])):
                self._emit(node, "RPL001",
                           f"{node.func.id}() of a tensor reduction in a compiled-path "
                           "module: the value is read back to the host (a sync)")
            if (name and name.startswith("torch.") and name.count(".") == 1
                    and name.split(".")[1] in _FACTORIES
                    and not any(kw.arg == "device" for kw in node.keywords)):
                self._emit(node, "RPL005",
                           f"{name}() without device= in a compiled-path module: the "
                           "tensor is made on the CPU and then moved, or left there")
        if self._in_impl:
            head, _, tail = (name or "").partition(".")
            if head in ("np", "numpy") and tail and tail.split(".")[0] not in _NP_TYPES:
                self._emit(node, "RPL002",
                           f"{name}() inside '{self._func}': numpy on a tensor raises "
                           "on the card or reads it back — use torch")
            elif attr == "numpy":
                self._emit(node, "RPL002",
                           f".numpy() inside '{self._func}': a read back of a tensor")
            if name and ((head, tail) in _WALLCLOCK_CALLS or name in (
                    "perf_counter", "datetime.datetime.now")):
                self._emit(node, "RPL004",
                           f"wall-clock read {name}() inside '{self._func}': the step's "
                           "result would depend on the host's pacing")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self.compiled_path or self._in_impl:
            idx = node.slice
            parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            if any(_is_reduction_call(p, no_dim=True) for p in parts):
                self._emit(node, "RPL003",
                           "an index built from a tensor reduction: the 0-dim tensor is "
                           "read back to the host — index with a one-row index_select")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>",
                compiled_path: bool = True) -> list[Finding]:
    """Lint one module's source text; ``compiled_path`` enables the
    module-wide rules (RPL001, RPL003, RPL005)."""
    tree = ast.parse(source, filename=path)
    linter = _Linter(path, source, compiled_path)
    linter.visit(tree)
    return linter.findings


def package_root() -> Path:
    """The ``ringpop_tpu_torch`` package directory."""
    return Path(__file__).resolve().parent.parent


def lint_paths(root: str | Path | None = None,
               dirs: Iterable[str] = COMPILED_PATH_DIRS,
               extra: Iterable[str | Path] = ()) -> list[Finding]:
    """Lint every .py under the package ``root`` (default: this one):
    the compiled-path ``dirs`` with every rule, the rest with the
    impl-function and import rules; then each file of ``extra`` (by
    default none; the CLI adds the checkout's ``chip_smoke.py``) with
    the latter."""
    root = Path(root) if root is not None else package_root()
    findings: list[Finding] = []
    compiled = {d: True for d in dirs}
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root)
        findings += lint_source(p.read_text(), str(p.relative_to(root.parent)),
                                compiled_path=len(rel.parts) > 1 and rel.parts[0] in compiled)
    for p in extra:
        p = Path(p)
        findings += lint_source(p.read_text(), p.name, compiled_path=False)
    return findings
