"""Source-level AST rules over ``src/repro_torch`` -- the registry behind
``torch_check_no_globals.py`` (counterpart of
``repro/analysis/ast_rules.py``: the same five rules, retargeted).

Same shape as the program rules: a :class:`SourceRule` is (name, doc,
check); ``SOURCE_RULES`` is the immutable registry; ``check_source``
walks a tree and runs every rule.  Rules:

* ``no-global`` — any ``global`` statement: mutating module state from
  a function is the pattern that made jitted programs depend on ambient
  configuration (use ``repro_torch.dist.scope.Scoped``).
* ``module-mutable`` — module-level bindings of mutable container
  literals (``= []`` / ``= {}`` / ``= dict()`` ...), including through
  tuple-unpack targets (``a, b = [], {}``) and starred targets
  (``a, *rest = ...`` — a starred target *always* binds a fresh list).
* ``inexact-bit-arith`` — tensor ``torch.exp2`` / ``torch.log2`` /
  ``torch.pow`` / ``Tensor.pow`` calls (any attribute call of those
  names) inside the bit-exact modules (quantizer grids, calibration, the
  plan, fixed-point wrap, the kernels and their plain versions): a
  transcendental approximation an ulp off at e.g. ``2^13`` silently
  shifts the quantization grid.  Use the frexp/ldexp-exact helpers
  (``core.quantizer._exp2i`` / ``floor_log2``).  Python-level
  ``2.0 ** k`` is exact and allowed.
* ``fixed-prngkey`` — a literal-0 seed in library code
  (``manual_seed(0)`` on a ``torch.Generator`` or on ``torch``): one
  fixed stream silently correlates draws that were meant to be
  independent; take a seed argument instead.
* ``deprecated-shim-call`` — calls to the removed-next-release
  ``set_axes`` / ``set_compute_dtype`` / ``set_packed_matmul`` shims:
  library code must use the RunSpec surface.

Suppression: a ``# lint: allow(<rule>)`` comment on the offending line,
or an allowlist entry — ``path::name`` (one binding) or ``path::*``
(whole file, any rule), paths relative to the repo root.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, FrozenSet, List, Tuple

MUTABLE_CALLS = frozenset({"dict", "list", "set", "defaultdict",
                           "OrderedDict", "deque", "Counter"})

# modules whose arithmetic must stay bit-exact: quantization grids, wire
# packing, fixed-point wrap/overflow.  Relative-path prefixes.
BIT_EXACT_PREFIXES = (
    "src/repro_torch/core/quantizer.py",
    "src/repro_torch/core/fixedpoint.py",
    "src/repro_torch/core/calibrate.py",
    "src/repro_torch/core/plan.py",
    "src/repro_torch/kernels/",
)

INEXACT_CALLS = frozenset({"exp2", "log2", "power", "pow"})

DEPRECATED_SHIMS = frozenset({"set_axes", "set_compute_dtype",
                              "set_packed_matmul"})

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([\w-]+)\)")


@dataclasses.dataclass(frozen=True)
class SourceFile:
    """One parsed module plus everything a rule needs to judge it."""
    rel: str                    # path relative to the repo root
    tree: ast.Module
    lines: Tuple[str, ...]      # source lines, for pragma lookups
    allow: FrozenSet[str]       # path::name / path::* allowlist

    def allowed(self, rule: str, lineno: int, name: str = "") -> bool:
        if f"{self.rel}::*" in self.allow:
            return True
        if name and f"{self.rel}::{name}" in self.allow:
            return True
        if 1 <= lineno <= len(self.lines):
            m = _ALLOW_RE.search(self.lines[lineno - 1])
            if m and m.group(1) == rule:
                return True
        return False


@dataclasses.dataclass(frozen=True)
class SourceRule:
    name: str
    doc: str
    check: Callable[[SourceFile], List[str]]


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _fail(src: SourceFile, rule: str, lineno: int, msg: str,
          name: str = "") -> List[str]:
    if src.allowed(rule, lineno, name):
        return []
    return [f"{src.rel}:{lineno}: [{rule}] {msg}"]


# -- no-global -----------------------------------------------------------

def _check_no_global(src: SourceFile) -> List[str]:
    out = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Global):
            out += _fail(
                src, "no-global", node.lineno,
                f"`global {', '.join(node.names)}` — module-level mutable "
                f"state; use repro_torch.dist.scope.Scoped")
    return out


# -- module-mutable ------------------------------------------------------

def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _call_name(node) in MUTABLE_CALLS
    return False


def _mutable_bindings(target: ast.AST, value: ast.AST
                      ) -> List[Tuple[str, bool]]:
    """``(name, is_starred)`` pairs bound to a mutable value by one
    (possibly nested tuple-unpack) assignment target.  A starred target
    binds a fresh list regardless of the value's type."""
    if isinstance(target, ast.Starred):
        inner = _mutable_bindings(target.value, value)
        return [(n, True) for n, _ in inner] or (
            [(ast.unparse(target.value), True)])
    if isinstance(target, ast.Name):
        return [(target.id, False)] if _is_mutable_literal(value) else []
    if isinstance(target, (ast.Tuple, ast.List)):
        elts = target.elts
        # element-wise when the value is a matching literal tuple/list
        # (`a, b = [], 3` flags only a); otherwise judge the whole value
        # against every name (`a, b = make_pair()` with a mutable call)
        if isinstance(value, (ast.Tuple, ast.List)) \
                and len(value.elts) == len([e for e in elts
                                            if not isinstance(e, ast.Starred)]):
            vals = list(value.elts)
            out = []
            vi = 0
            for e in elts:
                if isinstance(e, ast.Starred):
                    out += _mutable_bindings(e, value)
                else:
                    out += _mutable_bindings(e, vals[vi])
                    vi += 1
            return out
        return [b for e in elts for b in _mutable_bindings(e, value)]
    return []


def _check_module_mutable(src: SourceFile) -> List[str]:
    out = []
    for node in src.tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            for name, starred in _mutable_bindings(t, value):
                if name.startswith("__") and name.endswith("__"):
                    continue   # dunder module attrs (__all__) are constants
                why = ("a starred target always binds a fresh list"
                       if starred else
                       "bind it in a class or a Scoped default")
                out += _fail(
                    src, "module-mutable", node.lineno,
                    f"module-level mutable binding `{name}` — {why}",
                    name=name)
    return out


# -- inexact-bit-arith ---------------------------------------------------

def _check_inexact_bit_arith(src: SourceFile) -> List[str]:
    if not any(src.rel.startswith(p) for p in BIT_EXACT_PREFIXES):
        return []
    out = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name not in INEXACT_CALLS:
            continue
        # only tensor math (attribute calls like torch.exp2 / x.pow);
        # plain `pow(2, k)` / `2.0 ** k` run in Python and are exact
        if not isinstance(node.func, ast.Attribute):
            continue
        out += _fail(
            src, "inexact-bit-arith", node.lineno,
            f"`{ast.unparse(node.func)}` in a bit-exact module — a "
            f"{name} approximation an ulp off at e.g. 2^13 shifts the "
            f"quantization grid; use core.quantizer._exp2i / floor_log2 "
            f"(frexp/ldexp-exact)")
    return out


# -- fixed-prngkey -------------------------------------------------------

def _check_fixed_prngkey(src: SourceFile) -> List[str]:
    out = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call) \
                or _call_name(node) != "manual_seed":
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == 0:
            out += _fail(
                src, "fixed-prngkey", node.lineno,
                "hardcoded manual_seed(0) — one fixed stream correlates "
                "draws meant to be independent; take a seed argument "
                "instead")
    return out


# -- deprecated-shim-call ------------------------------------------------

def _check_deprecated_shims(src: SourceFile) -> List[str]:
    out = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call) and _call_name(node) in DEPRECATED_SHIMS:
            out += _fail(
                src, "deprecated-shim-call", node.lineno,
                f"call to deprecated `{_call_name(node)}` — library code "
                f"must configure through repro_torch.api.RunSpec, not the "
                f"one-release compatibility shims")
    return out


SOURCE_RULES: Tuple[SourceRule, ...] = (
    SourceRule("no-global",
               "no `global` statements anywhere in src/repro_torch",
               _check_no_global),
    SourceRule("module-mutable",
               "no module-level mutable-container bindings (incl. "
               "tuple-unpack and starred targets)",
               _check_module_mutable),
    SourceRule("inexact-bit-arith",
               "no torch.exp2/log2/pow or Tensor.pow in bit-exact "
               "modules — frexp/ldexp-exact helpers only",
               _check_inexact_bit_arith),
    SourceRule("fixed-prngkey",
               "no hardcoded manual_seed(0) in library code",
               _check_fixed_prngkey),
    SourceRule("deprecated-shim-call",
               "no calls to the deprecated set_* shims",
               _check_deprecated_shims),
)


def check_source(rel: str, text: str, allow: FrozenSet[str] = frozenset(),
                 rules: Tuple[SourceRule, ...] = SOURCE_RULES
                 ) -> List[str]:
    """All rule findings for one module's source text.  ``rel`` is the
    repo-root-relative path used in messages and allowlist keys."""
    src = SourceFile(rel=rel, tree=ast.parse(text, filename=rel),
                     lines=tuple(text.splitlines()), allow=allow)
    out = []
    for rule in rules:
        out.extend(rule.check(src))
    return out
