"""bench.py read as source, without running it: its numpy helpers and the
keys of its output line.  bench.py imports jax inside main(), so neither
the tests that hold bench_torch.py against it nor chip_smoke.py (on a
machine without jax) can import it; both read it with `ast`.  This module
imports neither jax nor torch."""

import ast
import os

import numpy as np

BENCH_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
HELPERS = ("kf_ate", "quantiles", "worst_at")


def _main(path: str) -> ast.FunctionDef:
    with open(path) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def reference_helpers(path: str = BENCH_PY) -> dict:
    """bench.py's kf_ate, quantiles and worst_at: closures inside main()
    that use numpy alone, compiled on their own."""
    defs = [n for n in _main(path).body
            if isinstance(n, ast.FunctionDef) and n.name in HELPERS]
    if sorted(d.name for d in defs) != sorted(HELPERS):
        raise ValueError("bench.py's main() defines "
                         f"{[d.name for d in defs]}")
    ns = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return {name: ns[name] for name in HELPERS}


def _str_keys(d: ast.Dict) -> set:
    return {k.value for k in d.keys}


def reference_keys(path: str = BENCH_PY) -> set:
    """The keys of bench.py's output line: its `out` literal, the keys
    stored into `out`, and the dicts merged by `out.update(...)`, where
    `out.update(stats_p)` merges run_once's `stats` (its literal and the
    keys stored into it)."""
    assigned = {"out": set(), "stats": set()}
    merged, merges_stats = set(), False
    for n in ast.walk(_main(path)):
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            t = n.targets[0]
            if isinstance(t, ast.Name) and t.id in assigned \
                    and isinstance(n.value, ast.Dict):
                assigned[t.id] |= _str_keys(n.value)
            elif isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id in assigned:
                assigned[t.value.id].add(t.slice.value)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "update" \
                and isinstance(n.func.value, ast.Name) \
                and n.func.value.id == "out":
            (arg,) = n.args
            if isinstance(arg, ast.Dict):
                merged |= _str_keys(arg)
            elif isinstance(arg, ast.Name) and arg.id == "stats_p":
                merges_stats = True
            else:
                raise ValueError(f"out.update({ast.unparse(arg)})")
    if not merges_stats:
        raise ValueError("bench.py no longer merges the pass's stats")
    return assigned["out"] | merged | assigned["stats"]
