"""SQL tokenizer for the engine's dialect subset.

The reference gets SQL parsing from DataFusion (sqlparser-rs); this engine
carries its own small tokenizer + recursive-descent parser covering the
reference's full query surface (see sql/parser.py).
"""

from __future__ import annotations

import dataclasses
import re

from sequila_tpu_torch.errors import PlanError

TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<number>\d+(\.\d+)?([eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<param>\$\d+)
  | (?P<op><>|!=|<=|>=|<|>|=|\|\||::)
  | (?P<punct>[(),.;*+\-/%\[\]])
    """,
    re.VERBOSE,
)


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # 'number' | 'string' | 'ident' | 'qident' | 'op' | 'punct' | 'eof'
    value: str
    pos: int

    @property
    def upper(self) -> str:
        return self.value.upper()


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i = 0
    n = len(sql)
    while i < n:
        m = TOKEN_RE.match(sql, i)
        if not m:
            raise PlanError(f"SQL syntax error at position {i}: {sql[i:i+20]!r}")
        kind = m.lastgroup
        text = m.group()
        if kind != "ws":
            if kind == "string":
                text = text[1:-1].replace("''", "'")
            elif kind == "qident":
                text = text[1:-1].replace('""', '"')
            tokens.append(Token(kind, text, i))
        i = m.end()
    tokens.append(Token("eof", "", n))
    return tokens
