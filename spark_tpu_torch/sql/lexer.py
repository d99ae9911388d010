"""SQL lexer: a hand-rolled tokenizer for the SELECT subset (the port's
copy of `spark_tpu/sql/lexer.py`, pure Python).

The reference generates its lexer from the ANTLR grammar
(`sql/catalyst/src/main/antlr4/.../parser/SqlBase.g4`); this engine's
grammar is small enough that a direct scanner is simpler and yields
better error messages (token + position).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


class ParseError(Exception):
    pass


@dataclass(frozen=True)
class Token:
    kind: str       # 'ident' | 'number' | 'string' | 'op' | 'eof'
    value: str      # normalized text (idents/keywords upper-cased in .upper)
    pos: int        # character offset in the source (for error messages)

    @property
    def upper(self) -> str:
        return self.value.upper()


# multi-char operators first so the scanner is greedy
_OPS = ("<>", "<=", ">=", "!=", "||", "=", "<", ">", "+", "-", "*", "/",
        "%", "(", ")", ",", ".", ";")


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and text.startswith("--", i):
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise ParseError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if text[j] == "'" and j + 1 < n and text[j + 1] == "'":
                    buf.append("'")
                    j += 2
                    continue
                if text[j] == "'":
                    break
                buf.append(text[j])
                j += 1
            if j >= n:
                raise ParseError(f"unterminated string literal at {i}")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":
            close = c
            j = text.find(close, i + 1)
            if j < 0:
                raise ParseError(f"unterminated quoted identifier at {i}")
            out.append(Token("ident", text[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = text[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and \
                        (text[j + 1].isdigit() or text[j + 1] in "+-"):
                    seen_exp = True
                    j += 2 if text[j + 1] in "+-" else 1
                else:
                    break
            out.append(Token("number", text[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            out.append(Token("ident", text[i:j], i))
            i = j
            continue
        for op in _OPS:
            if text.startswith(op, i):
                out.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise ParseError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", n))
    return out
