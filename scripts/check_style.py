#!/usr/bin/env python
"""In-repo style gate (the reference ships its own style script,
`/root/reference/scripts/check_style_cpplint.sh`; this is the Python
equivalent, stdlib-only because the image has no ruff/flake8).

Checks, per .py file:
* tabs in indentation and trailing whitespace;
* missing newline at EOF;
* lines longer than MAX_LEN (92: black-ish 88 plus slack for tables);
* unused imports (AST-based; `__init__.py` re-export files are exempt,
  and a trailing ``# noqa`` comment silences any line).

Exit code 1 with a file:line report when violations exist.
"""

from __future__ import annotations

import ast
import pathlib
import sys

MAX_LEN = 92
ROOT = pathlib.Path(__file__).resolve().parents[1]
TARGETS = [
    "kaldi_decoder_tpu", "tests", "scripts", "bench.py", "chip_smoke.py",
    "__graft_entry__.py",
]


def iter_files():
    for t in TARGETS:
        p = ROOT / t
        if p.is_file():
            yield p
        else:
            yield from sorted(p.rglob("*.py"))


def _used_names(tree: ast.AST) -> set:
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # Root of dotted access: walk to the base Name.
            cur = node
            while isinstance(cur, ast.Attribute):
                cur = cur.value
            if isinstance(cur, ast.Name):
                used.add(cur.id)
    # Names referenced in __all__ strings.
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__":
                    for elt in ast.walk(node.value):
                        if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, str
                        ):
                            used.add(elt.value)
    return used


def unused_imports(path: pathlib.Path, src: str, lines) -> list:
    if path.name == "__init__.py":
        return []
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []  # compileall reports syntax separately
    used = _used_names(tree)
    out = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [(a.asname or a.name.split(".")[0], a) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue  # __future__ imports act by existing
            if any(a.name == "*" for a in node.names):
                continue
            names = [(a.asname or a.name, a) for a in node.names]
        for name, _ in names:
            if name.startswith("_"):
                continue
            if name not in used:
                line = lines[node.lineno - 1]
                if "noqa" in line:
                    continue
                out.append((node.lineno, f"unused import '{name}'"))
    return out


def check_file(path: pathlib.Path) -> list:
    src = path.read_text()
    lines = src.split("\n")
    problems = []
    for i, line in enumerate(lines, 1):
        if "noqa" in line:
            continue
        if line.rstrip("\r") != line.rstrip("\r").rstrip():
            problems.append((i, "trailing whitespace"))
        stripped = line.lstrip("\t ")
        if "\t" in line[: len(line) - len(stripped)]:
            problems.append((i, "tab in indentation"))
        if len(line) > MAX_LEN:
            problems.append((i, f"line length {len(line)} > {MAX_LEN}"))
    if src and not src.endswith("\n"):
        problems.append((len(lines), "missing newline at EOF"))
    problems.extend(unused_imports(path, src, lines))
    return problems


def main() -> int:
    bad = 0
    for path in iter_files():
        for lineno, msg in sorted(check_file(path)):
            print(f"{path.relative_to(ROOT)}:{lineno}: {msg}")
            bad += 1
    if bad:
        print(f"\n{bad} style violation(s)", file=sys.stderr)
        return 1
    print("style gate: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
