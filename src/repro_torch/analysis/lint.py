"""Reservoir-lint for the PyTorch port: AST-based determinism and torch
static analysis (stdlib only).

Usage::

    python -m repro_torch.analysis.lint [paths...] [--fail-on=error]
        [--show-waived] [--list-rules]

The default path is ``src/repro_torch``.  The twin of
``repro/analysis/lint.py``: the D- and O-class rules, the waiver ledger
(W000/W001) and the command line are the reference's, with the same semantics
and messages; its J-class (JAX) rules become a T-class of torch rules.

D-class — determinism rules (simulator correctness):

* **D001** (error): builtin ``hash()`` call (process-salted).
* **D002** (error): wall-clock read inside a sim-path package (``core/``,
  ``federation/``, ``faults/``, ``serving/``); ``launch/`` and
  ``benchmarks/`` are exempt.  The package is found after the last
  ``repro_torch``, ``repro`` or ``src`` in the path.
* **D003** (error): unseeded randomness.
* **D004** (warning): iteration over a bare ``set``.

T-class — torch rules (the counterparts of J001/J002, and TF32):

* **T001** (error): a compiled or loaded callable built inside a function
  or a loop with no cache around it — ``torch.compile``,
  ``torch.jit.script`` / ``trace``, ``torch.utils.cpp_extension.load`` /
  ``load_inline``, ``ctypes.CDLL``, or a ``@triton.jit`` (or
  ``@torch.compile`` / ``@torch.jit.script``) def nested in a function.
  Each call builds (or compiles, or maps) it anew.  A function decorated
  with ``functools.lru_cache`` / ``cache`` is a cache around it; a function
  that caches what it builds by hand is waived with the cache as the
  reason.
* **T002** (warning): a host sync in code that runs per launch —
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, or ``float()`` / ``int()`` / ``bool()`` of a
  non-constant that is not shape arithmetic (``x.shape[i]``, ``x.size(i)``,
  ``len(...)``, ``x.ndim``, ``x.numel()`` and sums or products of them) or
  otherwise known to be a host number (a parameter annotated ``int`` /
  ``float`` / ``bool`` or an ``Optional`` of one, a local name assigned a
  host number, a comparison of dtypes, devices or strings, a ``math`` or
  numpy result).  Per launch means: ``forward`` / ``backward`` of a
  ``torch.autograd.Function`` subclass, every function of a module under a
  ``kernels/`` directory, and ``@triton.jit`` bodies.  Each one stalls the
  host until the card has drained its queue.
* **T003** (error): code that turns TF32 on —
  ``torch.backends.cuda.matmul.allow_tf32 = True``,
  ``torch.backends.cudnn.allow_tf32 = True``,
  ``torch.set_float32_matmul_precision(<constant other than "highest">)``,
  or ``input_precision="tf32"`` / ``allow_tf32=True`` on a ``tl.dot``.
  TF32 flips hash vertices and near-tie top-1 winners against the
  reference's fp32 math.  Restoring a saved setting (a non-constant) is
  not flagged.

O-class — **O001** (error): direct subscript mutation of a
registry-adopted stats mapping inside a sim-path package.

Waivers.  The shared marker ``# lint: disable=D001(reason)`` waives the
D- and O-class rules, which both linters see (the reference lints all of
``src/``, the port included).  T-class rules take the twin's own marker,
``# torch-lint: waive=T002(reason)``, which the reference's parser does
not read (it would report a T code it does not know as an unused waiver).
Either marker trails the flagged line or sits alone on the line above; a
reason is mandatory (W000), a waiver that matches no violation is unused
(W001), and so is a code given under the other linter's marker.

Exit status: nonzero iff any unwaived violation at or above ``--fail-on``
severity (default ``error``).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import sys
import tokenize
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

SEVERITIES = ("warning", "error")  # ascending

RULES: Dict[str, Tuple[str, str]] = {
    # code -> (severity, summary)
    "D001": ("error", "process-salted builtin hash(); use zlib.crc32"),
    "D002": ("error", "wall-clock read on the virtual timeline"),
    "D003": ("error", "unseeded / global-state randomness"),
    "D004": ("warning", "order-sensitive iteration over a bare set"),
    "O001": ("error", "direct mutation of a registry-adopted stats map"),
    "T001": ("error", "compiled/loaded callable built per call (no cache)"),
    "T002": ("warning", "host sync in per-launch code"),
    "T003": ("error", "TF32 turned on (breaks fp32 parity)"),
    "W000": ("error", "waiver without a reason"),
    "W001": ("error", "unused waiver"),
}

# legacy stats mappings re-homed into the metrics registry (O001)
REGISTRY_STATS_ATTRS = {"stats", "engine_stats", "fault_stats"}

# packages where only the virtual clock may be read (D002)
SIM_PATH_PACKAGES = {"core", "federation", "faults", "serving"}
# packages exempt from D002 (real wall time is the point there)
WALLCLOCK_EXEMPT = {"launch", "benchmarks"}
# a module under this directory runs per launch (T002)
KERNEL_PACKAGE = "kernels"

WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

GLOBAL_RANDOM_DRAWS = {
    "random", "randint", "randrange", "choice", "choices", "sample",
    "shuffle", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "seed", "getrandbits",
}
GLOBAL_NP_RANDOM = {
    "seed", "rand", "randn", "randint", "random", "random_sample", "choice",
    "uniform", "normal", "standard_normal", "shuffle", "permutation",
    "beta", "binomial", "poisson", "exponential", "get_state", "set_state",
}

# T001: calls that compile or load a callable
BUILD_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "ctypes.CDLL",
}
# T001: decorators that compile the def they decorate
BUILD_DECORATORS = {"triton.jit", "torch.compile", "torch.jit.script"}
CACHE_DECORATORS = {"functools.lru_cache", "functools.cache"}
AUTOGRAD_FUNCTION = "torch.autograd.Function"
# T002: methods that copy a device value to the host
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# T002: shape arithmetic, which reads no device value
SHAPE_ATTRS = {"shape", "ndim"}
SHAPE_METHODS = {"size", "numel", "dim"}
# T002: a tensor's metadata and the annotations of a Python number
METADATA_ATTRS = {"dtype", "device"}
HOST_NUMBER_TYPES = {"int", "float", "bool"}
HOST_MODULES = {"math", "numpy"}   # whose calls return host values
HOST_BUILTINS = {"int", "float", "bool", "abs", "min", "max", "round"}
# T003
TF32_FLAGS = {"torch.backends.cuda.matmul.allow_tf32",
              "torch.backends.cudnn.allow_tf32"}
TRITON_DOT = "triton.language.dot"

# the shared marker (the reference's parser reads it too) and the twin's own
_WAIVER_RE = re.compile(r"lint:\s*disable=(.+)")
_TORCH_WAIVER_RE = re.compile(r"torch-lint:\s*waive=(.+)")
_WAIVER_ITEM_RE = re.compile(r"([A-Z]\d{3})(?:\(([^)]*)\))?")
SHARED_MARKER, TORCH_MARKER = "lint: disable=", "torch-lint: waive="


def _marker_for(rule: str) -> str:
    return TORCH_MARKER if rule.startswith("T") else SHARED_MARKER


@dataclasses.dataclass
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = ""
    waived: bool = False
    waive_reason: str = ""

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES[self.rule][0]

    def format(self) -> str:
        tag = f" [waived: {self.waive_reason}]" if self.waived else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.severity}] {self.message}{tag}")


@dataclasses.dataclass
class _Waiver:
    rule: str
    line: int          # line the waiver applies to
    comment_line: int  # line the comment physically sits on
    reason: str
    marker: str        # SHARED_MARKER or TORCH_MARKER
    used: bool = False


def _collect_waivers(source: str) -> List[_Waiver]:
    """Parse both markers' ``CODE(reason)[,CODE(reason)...]`` comments.

    A trailing comment waives its own line; a comment alone on a line
    waives the next line.  Uses ``tokenize`` so string literals containing
    a marker are never mistaken for waivers.
    """
    waivers: List[_Waiver] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            # comment alone on its line -> applies to the next line
            prefix = source.splitlines()[line - 1][: tok.start[1]]
            target = line + 1 if prefix.strip() == "" else line
            for regex, marker in ((_WAIVER_RE, SHARED_MARKER),
                                  (_TORCH_WAIVER_RE, TORCH_MARKER)):
                m = regex.search(tok.string)
                if m is None:
                    continue
                for item in _WAIVER_ITEM_RE.finditer(m.group(1)):
                    waivers.append(_Waiver(item.group(1), target, line,
                                           (item.group(2) or "").strip(),
                                           marker))
    except tokenize.TokenError:
        pass
    return waivers


# --------------------------------------------------------------------- helpers
def _module_parts(path: Path) -> Tuple[str, ...]:
    """Path components after the last ``repro_torch``/``repro``/``src``
    marker (best effort)."""
    parts = path.parts
    for marker in ("repro_torch", "repro", "src"):
        if marker in parts:
            return parts[len(parts) - parts[::-1].index(marker):]
    return parts


def _is_sim_path(path: Path) -> bool:
    parts = _module_parts(path)
    if any(p in WALLCLOCK_EXEMPT for p in parts):
        return False
    return any(p in SIM_PATH_PACKAGES for p in parts)


def _is_kernel_module(path: Path) -> bool:
    return KERNEL_PACKAGE in _module_parts(path)[:-1]


class _Aliases(ast.NodeVisitor):
    """First pass: import aliases + set attrs."""

    def __init__(self):
        self.aliases: Dict[str, str] = {}       # local name -> canonical module
        self.from_names: Dict[str, str] = {}    # local name -> canonical dotted
        self.set_attrs: Set[str] = set()        # self.<attr> assigned a set

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for a in node.names:
            self.from_names[a.asname or a.name] = f"{mod}.{a.name}"
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if _is_set_expr(node.value, None):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    self.set_attrs.add(tgt.attr)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        ann = node.annotation
        is_set_ann = (isinstance(ann, ast.Name) and ann.id in ("set", "Set")) \
            or (isinstance(ann, ast.Subscript)
                and _dotted(ann.value, self) in ("set", "Set", "typing.Set",
                                                 "frozenset"))
        if is_set_ann or (node.value is not None
                          and _is_set_expr(node.value, None)):
            tgt = node.target
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self.set_attrs.add(tgt.attr)
        self.generic_visit(node)


def _dotted(node: ast.AST, info) -> Optional[str]:
    """Resolve an expression to a canonical dotted name, or None.

    ``tl.dot`` -> ``triton.language.dot`` given ``import triton.language as
    tl``; a bare imported name resolves through ``from_names``.
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = node.id
    if info is not None:
        if base in info.aliases:
            base = info.aliases[base]
        elif base in info.from_names:
            base = info.from_names[base]
    parts.append(base)
    return ".".join(reversed(parts))


def _is_set_expr(node: ast.AST, scope: Optional["_Scope"]) -> bool:
    """Can ``node`` be locally proven to evaluate to a set?"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if scope is not None:
        if isinstance(node, ast.Name) and node.id in scope.set_names:
            return True
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in scope.set_attrs):
            return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr,
                                                            ast.BitAnd,
                                                            ast.Sub)):
        return (_is_set_expr(node.left, scope)
                and _is_set_expr(node.right, scope))
    return False


def _is_host_number_annotation(ann: Optional[ast.AST]) -> bool:
    """Is ``ann`` a Python number type (``int``, ``float``, ``bool``, or an
    ``Optional`` / ``Union`` of them)?"""
    if isinstance(ann, ast.Name):
        return ann.id in HOST_NUMBER_TYPES
    if isinstance(ann, ast.Constant):
        return ann.value is None
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id in ("Optional", "Union"):
        inner = ann.slice
        items = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        return all(_is_host_number_annotation(a) for a in items)
    return False


def _is_host_value(node: ast.AST, numbers: Set[str], info) -> bool:
    """Is ``node`` known to hold no device value: constants and shape
    arithmetic (``x.shape[i]``, ``x.size(i)``, ``len(...)``, ``x.ndim``,
    ``x.numel()``), parameters annotated as Python numbers (``numbers``),
    local names assigned such a value, a comparison of dtypes, devices or
    strings, math or numpy results, and numeric builtins of these, joined
    by arithmetic?"""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in numbers
    if isinstance(node, ast.Attribute):
        return node.attr in SHAPE_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_host_value(node.value, numbers, info)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
        if isinstance(node.func, ast.Name) and node.func.id in HOST_BUILTINS:
            return all(_is_host_value(a, numbers, info) for a in node.args)
        root = node.func
        while isinstance(root, (ast.Attribute, ast.Call)):
            root = root.func if isinstance(root, ast.Call) else root.value
        if isinstance(root, ast.Name) and \
                _dotted(root, info).split(".")[0] in HOST_MODULES:
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr in SHAPE_METHODS)
    if isinstance(node, ast.Compare):   # of dtypes, devices or strings
        return any((isinstance(x, ast.Attribute) and x.attr in METADATA_ATTRS)
                   or (isinstance(x, ast.Constant) and isinstance(x.value, str))
                   for x in [node.left, *node.comparators])
    if isinstance(node, ast.BinOp):
        return (_is_host_value(node.left, numbers, info)
                and _is_host_value(node.right, numbers, info))
    if isinstance(node, ast.UnaryOp):
        return _is_host_value(node.operand, numbers, info)
    if isinstance(node, ast.IfExp):
        return (_is_host_value(node.body, numbers, info)
                and _is_host_value(node.orelse, numbers, info))
    return False


@dataclasses.dataclass
class _Scope:
    set_names: Set[str]
    set_attrs: Set[str]


# --------------------------------------------------------------------- checker
class _Checker(ast.NodeVisitor):
    def __init__(self, path: Path, info: _Aliases, sim_path: bool,
                 kernel_module: bool):
        self.path = path
        self.info = info
        self.sim_path = sim_path
        self.kernel_module = kernel_module
        self.violations: List[Violation] = []
        self.func_stack: List[ast.AST] = []   # enclosing FunctionDefs
        self.launch_stack: List[bool] = []    # is each one per-launch code?
        self.class_stack: List[bool] = []     # is each class an autograd.Function?
        self.numbers: List[Set[str]] = [set()]  # names known to hold Python numbers
        self.loop_depth = 0
        self.scopes: List[_Scope] = [_Scope(set(), info.set_attrs)]

    # ------------------------------------------------------------- utils
    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.violations.append(Violation(
            rule, str(self.path), node.lineno, node.col_offset, message))

    def _decorators(self, node) -> Set[str]:
        out = set()
        for dec in node.decorator_list:
            name = _dotted(dec.func if isinstance(dec, ast.Call) else dec,
                           self.info)
            if name is not None:
                out.add(name)
        return out

    def _cached(self) -> bool:
        """Is an enclosing function decorated with a cache?"""
        return any(self._decorators(f) & CACHE_DECORATORS
                   for f in self.func_stack)

    def _per_launch(self, node, decorators: Set[str]) -> bool:
        if self.kernel_module or "triton.jit" in decorators:
            return True
        if self.launch_stack and self.launch_stack[-1]:
            return True   # a closure of per-launch code
        return (not self.func_stack and bool(self.class_stack)
                and self.class_stack[-1]
                and node.name in ("forward", "backward"))

    # --------------------------------------------------------- traversal
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(any(_dotted(b, self.info) == AUTOGRAD_FUNCTION
                                    for b in node.bases))
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        decorators = self._decorators(node)
        # T001: a compiling decorator on a def nested inside another
        # function compiles a fresh callable per outer call
        built = sorted(decorators & BUILD_DECORATORS)
        if built and (self.loop_depth > 0
                      or (self.func_stack and not self._cached())):
            self._add("T001", node,
                      f"@{built[0]} '{node.name}' defined inside a function: "
                      "every outer call compiles a fresh kernel; hoist it to "
                      "module scope or cache what it builds")
        self.launch_stack.append(self._per_launch(node, decorators))
        args = node.args
        self.numbers.append(self.numbers[-1] | {
            a.arg for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)
            if _is_host_number_annotation(a.annotation)})
        self.func_stack.append(node)
        self.scopes.append(_Scope(set(), self.info.set_attrs))
        self.generic_visit(node)
        self.scopes.pop()
        self.func_stack.pop()
        self.numbers.pop()
        self.launch_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_stats_mutation(self, tgt: ast.AST, node: ast.AST) -> None:
        # O001 — <obj>.stats[...] written directly in a sim path
        if not (self.sim_path and isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Attribute)
                and tgt.value.attr in REGISTRY_STATS_ATTRS):
            return
        self._add("O001", node,
                  f"direct mutation of '.{tgt.value.attr}[...]': this "
                  "mapping is a CounterGroup adopted by the metrics "
                  "registry; write through .inc(key, n) so the increment "
                  "is visible to per-interval snapshots")

    def _check_tf32_flag(self, tgt: ast.AST, value: ast.AST) -> None:
        # T003 — allow_tf32 = True
        name = _dotted(tgt, self.info)
        if name in TF32_FLAGS and isinstance(value, ast.Constant) \
                and value.value is True:
            self._add("T003", tgt,
                      f"'{name} = True' turns TF32 on: hash vertices and "
                      "near-tie winners then differ from the reference's "
                      "fp32 math; leave it off")

    def visit_Assign(self, node: ast.Assign) -> None:
        if _is_set_expr(node.value, self.scopes[-1]):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.scopes[-1].set_names.add(tgt.id)
        else:
            for tgt in node.targets:  # reassignment to non-set clears the mark
                if isinstance(tgt, ast.Name):
                    self.scopes[-1].set_names.discard(tgt.id)
        host = _is_host_value(node.value, self.numbers[-1], self.info)
        for tgt in node.targets:
            self._check_stats_mutation(tgt, node)
            self._check_tf32_flag(tgt, node.value)
        self.generic_visit(node)
        for tgt in node.targets:   # T002: whether a name now holds a host number
            if isinstance(tgt, ast.Name):
                (self.numbers[-1].add if host else self.numbers[-1].discard)(tgt.id)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_stats_mutation(node.target, node)
        self.generic_visit(node)

    def _check_iteration(self, iter_node: ast.AST) -> None:
        if _is_set_expr(iter_node, self.scopes[-1]):
            self._add("D004", iter_node,
                      "iterating a bare set: order is insertion- and "
                      "hash-salt-dependent; sorted() it (or use an ordered "
                      "container) before order feeds scheduling or "
                      "serialization")

    def visit_For(self, node: ast.For) -> None:
        self._check_iteration(node.iter)
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iteration(gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # ------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        info = self.info
        # D001 — builtin hash()
        if isinstance(node.func, ast.Name) and node.func.id == "hash" \
                and node.func.id not in info.from_names:
            self._add("D001", node,
                      "builtin hash() is process-salted (PYTHONHASHSEED): "
                      "seeds/routing derived from it differ per invocation "
                      "and break cross-process goldens; use "
                      "zlib.crc32(x.encode())")
        name = _dotted(node.func, info)
        # D002 — wall clock in sim path
        if self.sim_path and name in WALLCLOCK_CALLS:
            self._add("D002", node,
                      f"wall-clock read '{name}' in a sim-path package: "
                      "only the virtual clock (EventLoop.now) may be read "
                      "on the simulated timeline")
        # D003 — unseeded / global-state randomness
        if name == "random.Random" and not node.args and not node.keywords:
            self._add("D003", node,
                      "random.Random() without a seed draws from OS "
                      "entropy: pass an explicit seed")
        elif name == "random.SystemRandom":
            self._add("D003", node,
                      "random.SystemRandom is nondeterministic by "
                      "construction; use a seeded random.Random")
        elif name is not None and name.startswith("random.") \
                and name.split(".", 1)[1] in GLOBAL_RANDOM_DRAWS:
            self._add("D003", node,
                      f"'{name}' draws from the process-global RNG: any "
                      "import-order change reshuffles every stream; use a "
                      "seeded random.Random instance")
        elif name is not None and name.startswith("numpy.random.") \
                and name.rsplit(".", 1)[1] in GLOBAL_NP_RANDOM:
            self._add("D003", node,
                      f"'{name}' uses numpy's global RNG state; use "
                      "np.random.default_rng(seed)")
        elif name == "numpy.random.default_rng" and not node.args \
                and not node.keywords:
            self._add("D003", node,
                      "np.random.default_rng() without a seed is "
                      "entropy-seeded; pass an explicit seed")
        # T001 — compiled / loaded callable built per call
        if name in BUILD_CALLS:
            if self.loop_depth > 0:
                self._add("T001", node,
                          f"{name} inside a loop: each iteration builds "
                          "(compiles, loads) a fresh callable; hoist it out")
            elif self.func_stack and not self._cached():
                self._add("T001", node,
                          f"{name} inside a function: every call builds "
                          "(compiles, loads) a fresh callable; hoist it to "
                          "module scope or cache what it builds")
        # T003 — TF32 through the precision setting or a tl.dot
        if name == "torch.set_float32_matmul_precision" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value != "highest":
            self._add("T003", node,
                      f"set_float32_matmul_precision({node.args[0].value!r}) "
                      "lets fp32 matmuls run in TF32 (or bf16): hash "
                      "vertices and near-tie winners then differ from the "
                      "reference's fp32 math; keep 'highest'")
        if name == TRITON_DOT:
            for kw in node.keywords:
                if isinstance(kw.value, ast.Constant) and (
                        (kw.arg == "input_precision" and kw.value.value == "tf32")
                        or (kw.arg == "allow_tf32" and kw.value.value is True)):
                    self._add("T003", node,
                              f"tl.dot({kw.arg}={kw.value.value!r}) runs the "
                              "fp32 product in TF32; use "
                              "input_precision='ieee'")
        # D004 — order capture of a set
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("list", "tuple", "iter", "enumerate") \
                and node.args and _is_set_expr(node.args[0], self.scopes[-1]):
            self._add("D004", node,
                      f"{node.func.id}() over a bare set captures "
                      "arbitrary order; use sorted()")
        if isinstance(node.func, ast.Attribute) and node.func.attr == "join" \
                and node.args and _is_set_expr(node.args[0], self.scopes[-1]):
            self._add("D004", node,
                      "join() over a bare set serializes arbitrary order; "
                      "use sorted()")
        # T002 — host sync in per-launch code
        if self.launch_stack and self.launch_stack[-1]:
            self._check_host_sync(node, name)
        self.generic_visit(node)

    def _check_host_sync(self, node: ast.Call, name: Optional[str]) -> None:
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and node.args \
                and not _is_host_value(node.args[0], self.numbers[-1], self.info):
            self._add("T002", node,
                      f"{node.func.id}() of a value not known to be a host "
                      "number: on a tensor it copies to the host and waits "
                      "for the card on every launch; keep it on the device "
                      "(shape arithmetic and number-typed values are exempt)")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in SYNC_METHODS and not node.args \
                and not node.keywords:
            self._add("T002", node,
                      f".{node.func.attr}() copies a device value to the "
                      "host and waits for the card on every launch")
        if name == "torch.cuda.synchronize":
            self._add("T002", node,
                      "torch.cuda.synchronize() in per-launch code stalls "
                      "the host until the card drains its queue")


# ----------------------------------------------------------------------- api
def lint_source(source: str, path: str = "<string>") -> List[Violation]:
    """Lint one source string; returns ALL violations (waived ones marked).

    Unused waivers and reason-less waivers are appended as W-class
    violations so the waiver ledger itself stays honest.
    """
    p = Path(path)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation("W000", str(p), e.lineno or 1, 0,
                          f"syntax error: {e.msg}", severity="error")]
    info = _Aliases()
    info.visit(tree)
    checker = _Checker(p, info, _is_sim_path(p), _is_kernel_module(p))
    checker.visit(tree)
    violations = checker.violations
    waivers = _collect_waivers(source)
    for v in violations:
        for w in waivers:
            if w.rule == v.rule and w.line == v.line \
                    and w.marker == _marker_for(v.rule):
                w.used = True
                if not w.reason:
                    continue  # reason-less waivers do not suppress
                v.waived = True
                v.waive_reason = w.reason
    for w in waivers:
        if not w.reason:
            violations.append(Violation(
                "W000", str(p), w.comment_line, 0,
                f"waiver for {w.rule} has no reason: use "
                f"'# {_marker_for(w.rule)}{w.rule}(why this is safe)'"))
        elif w.rule in RULES and w.marker != _marker_for(w.rule):
            violations.append(Violation(
                "W001", str(p), w.comment_line, 0,
                f"waiver for {w.rule} under '{w.marker}' waives nothing: "
                f"{w.rule} takes '# {_marker_for(w.rule)}{w.rule}(reason)'"))
        elif not w.used:
            violations.append(Violation(
                "W001", str(p), w.comment_line, 0,
                f"waiver for {w.rule} matches no violation on line "
                f"{w.line}; delete it"))
    violations.sort(key=lambda v: (v.line, v.col, v.rule))
    return violations


def lint_paths(paths) -> List[Violation]:
    out: List[Violation] = []
    for root in paths:
        root = Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            out.extend(lint_source(f.read_text(), str(f)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    fail_on = "error"
    show_waived = False
    paths: List[str] = []
    for a in argv:
        if a.startswith("--fail-on"):
            fail_on = a.split("=", 1)[1] if "=" in a else "error"
            if fail_on not in SEVERITIES:
                print(f"unknown severity {fail_on!r}; use one of "
                      f"{SEVERITIES}", file=sys.stderr)
                return 2
        elif a == "--show-waived":
            show_waived = True
        elif a == "--list-rules":
            for code, (sev, summary) in sorted(RULES.items()):
                print(f"{code} [{sev}] {summary}")
            return 0
        elif a.startswith("-"):
            print(f"unknown option {a!r}", file=sys.stderr)
            return 2
        else:
            paths.append(a)
    if not paths:
        paths = ["src/repro_torch"]
    violations = lint_paths(paths)
    gate = SEVERITIES.index(fail_on)
    failing = 0
    for v in violations:
        if v.waived:
            if show_waived:
                print(v.format())
            continue
        print(v.format())
        if SEVERITIES.index(v.severity) >= gate:
            failing += 1
    waived = sum(v.waived for v in violations)
    active = sum(not v.waived for v in violations)
    print(f"reservoir-lint (torch): {active} violation(s) "
          f"({failing} at/above '{fail_on}'), {waived} waived",
          file=sys.stderr)
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
