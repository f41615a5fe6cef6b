"""fleetlint rule engine: per-file AST walks with pragma suppression.
The port's own copy of the JAX package's engine (the port imports
nothing of that package); it holds no rule, so it reads any tree.

The five planes are held to contracts that used to exist only as prose
(docs/training_plane.md, docs/transmission_plane.md, ROADMAP.md
conventions).  fleetlint turns each contract into a `Rule` that walks a
module's AST and yields `Finding`s; the engine handles file discovery,
pragma parsing, suppression, and JSON/human reporting, so rules stay
pure functions of the parsed module.

Pragma syntax (one per comment)::

    x = bank.params_stack()  # fleetlint: disable=borrowed-stack -- reason
    # fleetlint: disable=host-sync -- reason      (applies to next line)
    # fleetlint: disable-file=determinism -- reason (whole file)

The justification text after ``--`` (or an em dash) is REQUIRED — a
pragma without one is itself a finding (the `pragma-reason` meta rule),
so every suppression in the tree documents which side of the contract
makes it legal.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str          # posix-style path as given on the command line
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str

    def human(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"

    def as_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One parsed `# fleetlint:` comment."""
    line: int                  # line the comment sits on
    target: int                # line the suppression applies to
    rules: tuple               # rule names it disables ("*" = all)
    file_level: bool           # disable-file= form
    reason: str                # justification text ("" = missing)


_PRAGMA_RE = re.compile(
    r"#\s*fleetlint:\s*(disable(?:-file)?)\s*=\s*"
    r"([A-Za-z0-9_*,\- ]+?)\s*(?:(?:--|—|–)\s*(.*))?$")


def parse_pragmas(source: str) -> List[Pragma]:
    """All fleetlint pragmas in `source`.

    A pragma trailing a code line suppresses that line; a standalone
    comment pragma suppresses the next CODE line (blank lines and the
    justification's continuation comments may sit in between)."""
    lines = source.splitlines()

    def target_of(comment_line: int) -> int:
        before = lines[comment_line - 1].split("#", 1)[0]
        if before.strip():
            return comment_line            # trails code: its own line
        for i in range(comment_line, len(lines)):
            s = lines[i].strip()
            if s and not s.startswith("#"):
                return i + 1               # next code line (1-based)
        return comment_line

    out: List[Pragma] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(2).split(",")
                          if r.strip())
            out.append(Pragma(line=tok.start[0],
                              target=target_of(tok.start[0]),
                              rules=rules,
                              file_level=m.group(1) == "disable-file",
                              reason=(m.group(3) or "").strip()))
    except tokenize.TokenError:
        pass
    return out


@dataclasses.dataclass
class Module:
    """Everything a rule gets to look at for one file."""
    path: str                  # as reported in findings
    rel: str                   # posix path relative to the scan root
    source: str
    tree: ast.Module
    pragmas: List[Pragma]

    @property
    def lines(self) -> List[str]:
        return self.source.splitlines()


class Rule:
    """Protocol for a lint rule.

    Subclasses set `name` (the pragma token) and `contract` (one line:
    which plane contract this encodes, with the doc that states it) and
    implement `check(module) -> Iterator[Finding]`.  Rules must not
    mutate the module.
    """
    name: str = ""
    contract: str = ""

    def check(self, module: Module) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(rule=self.name, path=module.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


def load_module(path: Path, report_path: Optional[str] = None,
                rel: Optional[str] = None) -> Optional[Module]:
    """Parse one file; returns None for files that do not parse (the
    tier-1 suite owns syntax errors — a linter crash would mask them)."""
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    return Module(path=report_path or str(path),
                  rel=rel if rel is not None else path.as_posix(),
                  source=source, tree=tree, pragmas=parse_pragmas(source))


def module_from_source(source: str, rel: str) -> Module:
    """A Module for an in-memory snippet (the fixture tests)."""
    return Module(path=rel, rel=rel, source=source,
                  tree=ast.parse(source), pragmas=parse_pragmas(source))


def _suppressed(finding: Finding, pragmas: Sequence[Pragma]) -> bool:
    for p in pragmas:
        if finding.rule not in p.rules and "*" not in p.rules:
            continue
        if p.file_level:
            return True
        # trailing comment: its own line; standalone: the next code line
        if finding.line in (p.line, p.target):
            return True
    return False


def check_module(module: Module, rules: Sequence[Rule]) -> List[Finding]:
    """All unsuppressed findings for one module, source order."""
    out: List[Finding] = []
    for rule in rules:
        for f in rule.check(module):
            if not _suppressed(f, module.pragmas):
                out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def iter_python_files(paths: Iterable[str]) -> Iterator[Path]:
    for p in paths:
        root = Path(p)
        if root.is_file() and root.suffix == ".py":
            yield root
        elif root.is_dir():
            yield from sorted(root.rglob("*.py"))


def run(paths: Sequence[str], rules: Sequence[Rule]) -> List[Finding]:
    """Lint every .py file under `paths` with `rules`."""
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        mod = load_module(path, report_path=path.as_posix(),
                          rel=path.as_posix())
        if mod is None:
            continue
        findings.extend(check_module(mod, rules))
    return findings


def report_human(findings: Sequence[Finding], rules: Sequence[Rule],
                 n_files: int) -> str:
    lines = [f.human() for f in findings]
    lines.append(f"fleetlint: {len(findings)} finding(s) in {n_files} "
                 f"file(s), {len(rules)} rule(s) active")
    return "\n".join(lines)


def report_json(findings: Sequence[Finding], rules: Sequence[Rule],
                n_files: int) -> str:
    return json.dumps({
        "findings": [f.as_json() for f in findings],
        "rules": [{"name": r.name, "contract": r.contract} for r in rules],
        "files_checked": n_files,
        "clean": not findings,
    }, indent=1)
