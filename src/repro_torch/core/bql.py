"""BigDAWG Query Language (paper §VI): functional syntax with island
tokens — ``bdrel`` / ``bdarray`` / ``bdtext`` / ``bdstream`` for
intra-island queries, ``bdcast`` for inter-island migration (always
nested between island queries), ``bdcatalog`` for metadata.  This module
parses BQL into a CrossIslandQueryPlan tree (paper §V.B): nodes either
carry an intra-island query or an inter-island migration.

Island query text is opaque to this parser (each island's shim owns its
own grammar) — which is why the streaming island's keyword-argument ops
(``join(W1, W2, on=ts, tol=0.5)``) and event-time windows
(``ewindow(S, span)``) need no grammar changes here: ``=`` and nested
calls pass through ``_split_top_commas`` untouched, and only ``bdcast``
boundaries are rewritten.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

ISLAND_TOKENS = {"bdrel": "relational", "bdarray": "array",
                 "bdtext": "text", "bdstream": "streaming",
                 "bdml": "ml"}
ALL_TOKENS = tuple(ISLAND_TOKENS) + ("bdcast", "bdcatalog")


@dataclasses.dataclass
class CastNode:
    """bdcast(inner, dest_name, dest_schema, dest_island)."""
    child: "IslandQueryNode"
    dest_name: str
    dest_schema: str
    dest_island: str


@dataclasses.dataclass
class IslandQueryNode:
    """An intra-island query; nested casts appear as name references."""
    island: str
    query: str                       # island-language text, casts replaced
    casts: List[CastNode] = dataclasses.field(default_factory=list)

    def walk(self):
        """Post-order traversal of the plan tree."""
        for cast in self.casts:
            yield from cast.child.walk()
            yield cast
        yield self


@dataclasses.dataclass
class CatalogQueryNode:
    query: str


def _find_token(s: str, start: int = 0) -> Optional[Tuple[str, int]]:
    """Earliest BQL token at/after ``start``; returns (token, index)."""
    best: Optional[Tuple[str, int]] = None
    for tok in ALL_TOKENS:
        i = s.find(tok + "(", start)
        if i >= 0 and (best is None or i < best[1]):
            best = (tok, i)
    return best


def _balanced_body(s: str, open_idx: int) -> Tuple[str, int]:
    """Given index of '(' return (body, index-after-closing-paren)."""
    depth = 0
    for j in range(open_idx, len(s)):
        if s[j] == "(":
            depth += 1
        elif s[j] == ")":
            depth -= 1
            if depth == 0:
                return s[open_idx + 1:j], j + 1
    raise ValueError(f"unbalanced parentheses in BQL: {s!r}")


def _split_top_commas(s: str) -> List[str]:
    parts, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in ("'", '"'):
            quote = ch
            cur.append(ch)
            continue
        if ch == "(" or ch == "[" or ch == "{":
            depth += 1
        elif ch == ")" or ch == "]" or ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return parts


def parse(query: str):
    """Parse a full BQL string into a plan tree root."""
    q = query.strip()
    found = _find_token(q)
    if not found or q[:found[1]].strip():
        raise ValueError(f"not a BQL query: {query!r}")
    tok, idx = found
    body, end = _balanced_body(q, idx + len(tok))
    if q[end:].strip():
        raise ValueError(f"trailing input after BQL query: {q[end:]!r}")
    if tok == "bdcatalog":
        return CatalogQueryNode(body.strip())
    if tok == "bdcast":
        raise ValueError("bdcast must be nested inside an island query")
    return _parse_island(ISLAND_TOKENS[tok], body)


def _parse_island(island: str, body: str) -> IslandQueryNode:
    """Replace nested bdcast(...) occurrences with their dest names."""
    casts: List[CastNode] = []
    out = []
    pos = 0
    while True:
        i = body.find("bdcast(", pos)
        if i < 0:
            out.append(body[pos:])
            break
        out.append(body[pos:i])
        cast_body, after = _balanced_body(body, i + len("bdcast"))
        parts = _split_top_commas(cast_body)
        if len(parts) < 3:
            raise ValueError(f"bdcast needs (query, name, schema[, island]): "
                             f"{cast_body!r}")
        inner_q = parts[0]
        dest_name = parts[1].strip()
        dest_schema = parts[2].strip().strip("'\"")
        dest_island = parts[3].strip() if len(parts) > 3 else island
        inner = parse(inner_q)
        if not isinstance(inner, IslandQueryNode):
            raise ValueError("bdcast inner query must be an island query")
        casts.append(CastNode(inner, dest_name, dest_schema, dest_island))
        out.append(dest_name)
        pos = after
    text = "".join(out).strip()
    return IslandQueryNode(island=island, query=text, casts=casts)
