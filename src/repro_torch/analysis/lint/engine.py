"""AST lint engine for the port's invariants (``src/repro_torch``).

The port's own copy of the reference's engine (``repro.analysis.lint``),
with the same behaviour: the hard bugs of this codebase were *invariant*
violations, not logic errors (a product accumulating in bf16 before a
Cholesky, a collective reducing twice, a kernel guarded by ``assert``, a
host sync inside a solve that must not stall the card), and this engine
machine-checks those contracts.  The rules it runs are the torch forms
of the reference's (:mod:`repro_torch.analysis.lint.rules`).

Design:

* a :class:`Rule` is any object with ``name``, ``doc`` and
  ``check(ctx) -> Iterable[Finding]``; rules register through
  :func:`register_rule` (same idiom as ``repro_torch.core.registry``);
* one :class:`FileContext` per file carries the parsed AST, source
  lines, and the comment map rules use for justification tags;
* suppressions are per-line comments —
  ``# repro-lint: disable=<rule>[,<rule>] -- why`` on the flagged line
  or the line above;
* a committed JSON baseline lets genuinely-accepted findings ride
  without exempting new code: fresh findings fail, baselined ones
  report as such, and fixed baseline entries are flagged stale so the
  file shrinks monotonically.

The engine is stdlib-only (``ast`` + ``tokenize``): it runs on a bare
Python and imports neither ``torch`` nor ``jax``, nor anything of the
reference package.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import tokenize
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Protocol, Sequence

SUPPRESS_TAG = "repro-lint: disable="


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    snippet: str = ""  # stripped source line, for fingerprint identity

    def fingerprint(self) -> str:
        """Line-independent identity used by the baseline: the same
        violation must not re-fail just because code above it moved,
        but a *new* violation with the same message elsewhere in the
        file must not ride an old entry — the source text itself is the
        tiebreaker.  (Byte-identical duplicate violations in one file
        share an identity; a baseline entry then covers them all.)"""
        return f"{self.path}::{self.rule}::{self.message}::{self.snippet}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule(Protocol):
    """Pluggable rule protocol: stateless check over one file."""

    name: str
    doc: str

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        ...


_RULES: Dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    """Register ``rule`` under ``rule.name`` (fail loud on collisions)."""
    if rule.name in _RULES:
        raise ValueError(f"duplicate lint rule {rule.name!r}")
    _RULES[rule.name] = rule
    return rule


def all_rules() -> Dict[str, Rule]:
    # Import for side effect: the built-in rules self-register.
    from repro_torch.analysis.lint import rules as _rules  # noqa: F401

    return dict(_RULES)


def resolve_rules(names: Optional[Sequence[str]] = None) -> List[Rule]:
    table = all_rules()
    if names is None:
        return [table[k] for k in sorted(table)]
    missing = sorted(set(names) - set(table))
    if missing:
        raise ValueError(
            f"unknown lint rule(s) {missing}; known: {sorted(table)}")
    return [table[k] for k in sorted(set(names))]


class FileContext:
    """Parsed view of one source file handed to every rule."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.comments = self._comment_map(source)

    @staticmethod
    def _comment_map(source: str) -> Dict[int, str]:
        out: Dict[int, str] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass
        return out

    def comment_near(self, line: int, *, lookback: int = 6) -> str:
        """Concatenated comment text on ``line`` and up to ``lookback``
        contiguous comment/blank lines above it — the justification
        window rules search for tags like ``check_rep``."""
        parts = []
        if line in self.comments:
            parts.append(self.comments[line])
        cur = line - 1
        seen = 0
        while cur > 0 and seen < lookback:
            if cur in self.comments:
                parts.append(self.comments[cur])
            elif cur <= len(self.lines) and self.lines[cur - 1].strip():
                break  # non-comment code line ends the window
            cur -= 1
            seen += 1
        return "\n".join(parts)

    def suppressed(self, line: int, rule: str) -> bool:
        for cand in (line, line - 1):
            text = self.comments.get(cand, "")
            if SUPPRESS_TAG not in text:
                continue
            spec = text.split(SUPPRESS_TAG, 1)[1]
            spec = spec.split("--", 1)[0]
            names = {s.strip() for s in spec.replace(";", ",").split(",")}
            if rule in names or "all" in names:
                return True
        return False

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            rule=rule,
            message=message,
            snippet=snippet,
        )


@dataclasses.dataclass
class LintResult:
    """Outcome of one lint run, split for CLI/CI consumption."""

    findings: List[Finding]          # new (non-baselined, unsuppressed)
    baselined: List[Finding]         # matched a committed baseline entry
    suppressed: int                  # silenced by inline disable comments
    stale_baseline: List[str]        # baseline fingerprints no longer seen
    files: int
    errors: List[str]                # unparseable files

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors


def iter_python_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    # de-dup while keeping order
    seen = set()
    uniq = []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def load_baseline(path: Optional[str]) -> List[str]:
    if not path or not Path(path).exists():
        return []
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict):
        data = data.get("fingerprints", [])
    if not isinstance(data, list):
        raise ValueError(f"baseline {path}: expected a JSON list")
    return [str(x) for x in data]


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    fps = sorted({f.fingerprint() for f in findings})
    Path(path).write_text(json.dumps(fps, indent=2) + "\n")


def run_lint(
    paths: Sequence[str],
    *,
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[str] = None,
    source_loader: Optional[Callable[[Path], str]] = None,
) -> LintResult:
    """Lint every ``*.py`` under ``paths`` with the selected rules."""
    active = resolve_rules(rules)
    base_fps = set(load_baseline(baseline))
    new: List[Finding] = []
    known: List[Finding] = []
    errors: List[str] = []
    suppressed = 0
    seen_fps = set()
    files = iter_python_files(paths)
    for file in files:
        try:
            src = source_loader(file) if source_loader else file.read_text()
            ctx = FileContext(str(file), src)
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{file}: {e}")
            continue
        for rule in active:
            for f in rule.check(ctx):
                if ctx.suppressed(f.line, f.rule):
                    suppressed += 1
                    continue
                seen_fps.add(f.fingerprint())
                if f.fingerprint() in base_fps:
                    known.append(f)
                else:
                    new.append(f)
    stale = sorted(base_fps - seen_fps)
    new.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    known.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(
        findings=new,
        baselined=known,
        suppressed=suppressed,
        stale_baseline=stale,
        files=len(files),
        errors=errors,
    )
