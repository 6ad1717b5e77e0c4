"""AST lint layer of the port: engine + built-in rules (stdlib-only, no
torch, no jax)."""

from repro_torch.analysis.lint.engine import (  # noqa: F401
    FileContext,
    Finding,
    LintResult,
    Rule,
    all_rules,
    load_baseline,
    register_rule,
    resolve_rules,
    run_lint,
    write_baseline,
)
