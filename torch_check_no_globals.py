"""Source-level AST rules over src/repro_torch (the port's counterpart of
``tools/check_no_globals.py``, over the registry of
``repro_torch.analysis.ast_rules``):

* ``no-global`` — no ``global`` statements (``dist.scope.Scoped`` is the
  mechanism for per-call state);
* ``module-mutable`` — no module-level mutable-container bindings,
  including tuple-unpack (``a, b = [], {}``) and starred targets;
* ``inexact-bit-arith`` — no ``torch.exp2`` / ``log2`` / ``pow`` or
  ``Tensor.pow`` in the bit-exact modules (frexp/ldexp-exact helpers
  only);
* ``fixed-prngkey`` — no hardcoded ``manual_seed(0)`` in library code;
* ``deprecated-shim-call`` — no calls to the deprecated ``set_*`` shims.

Allowlist entries are ``path::name`` (one binding) or ``path::*``
(whole file); a ``# lint: allow(<rule>)`` comment suppresses one line.

Usage:  python torch_check_no_globals.py [--src src/repro_torch]
Prints one ``FAIL path:line: [rule] message`` line a finding on stderr,
or one line saying the tree passes.
Exit codes: 0 = clean, 1 = violations, 2 = bad invocation.
"""
from __future__ import annotations

import os
import sys
from typing import List

ROOT = os.path.dirname(os.path.abspath(__file__))

# path::name entries exempt from the module-level-mutable rule.  Keep
# this list SHORT and justified.
ALLOWLIST = frozenset({
    # the process's loaded kernel libraries, filled at first use under a
    # lock: a library cannot be unloaded while the allocator may still
    # hold work launched from it, so the cache lives as long as the
    # process
    "src/repro_torch/kernels/_build.py::_LOADED",
})


def check_tree(src_root: str, root: str = ROOT,
               allow: frozenset = ALLOWLIST) -> List[str]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.analysis.ast_rules import check_source
    problems: List[str] = []
    for dirpath, _, files in sorted(os.walk(src_root)):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as f:
                problems += check_source(rel, f.read(), allow=allow)
    return problems


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="source-level AST rules over src/repro_torch")
    ap.add_argument("--src", default=os.path.join(ROOT, "src",
                                                  "repro_torch"),
                    help="tree to check (paths in messages/allowlist "
                         "stay relative to its grandparent)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.src):
        print(f"missing {args.src}", file=sys.stderr)
        return 2
    # allowlist keys are relative to the directory holding `src/`
    root = os.path.dirname(os.path.dirname(os.path.abspath(args.src)))
    problems = check_tree(os.path.abspath(args.src), root=root)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if problems:
        return 1
    print("torch_check_no_globals: src tree passes all source rules "
          "(no-global, module-mutable, inexact-bit-arith, fixed-prngkey, "
          "deprecated-shim-call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
