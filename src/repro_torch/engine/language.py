"""Textual hybrid-pattern query language: lexer, parser, pretty-printer.

Grammar (whitespace-insensitive)::

    query    :=  segment (',' segment)*
    segment  :=  node (edge node)*
    node     :=  '(' NAME (':' LABEL)? ')'
    edge     :=  '-/->' | '-//->' | '<-/-' | '<-//-'
    NAME     :=  [A-Za-z_][A-Za-z0-9_]*
    LABEL    :=  [A-Za-z_][A-Za-z0-9_]*

``-/->`` is a *child* edge (edge-to-edge mapping, ``p/q``) and ``-//->`` a
*descendant* edge (edge-to-path mapping, ``p//q``); the ``<-``-forms are the
same edges written right-to-left.  A node must carry a label on its first
mention; later mentions may repeat it (checked) or omit it::

    (a:Person)-/->(b:City)-//->(c:Country), (a)-//->(c)

Query-node indices are assigned in order of first appearance, so a query
round-trips exactly through :func:`fmt` / :func:`parse`.

String labels are mapped onto the int label space of the data graph through
a :class:`Vocab`; labels without an explicit name spell ``L<i>``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..core.query import CHILD, DESC, PatternQuery, QueryEdge

__all__ = ["Vocab", "QueryParseError", "parse", "fmt", "node_name"]

_GENERIC_LABEL = re.compile(r"^L(\d+)$")


class Vocab:
    """Bidirectional mapping between string label names and int label ids.

    Labels without an explicit name round-trip through the generic spelling
    ``L<i>``.  When ``num_labels`` is set (e.g. from a resident graph), any
    label outside the graph's label space is rejected at parse time.
    """

    def __init__(self,
                 names: Union[None, Sequence[str], Mapping[str, int]] = None,
                 num_labels: Optional[int] = None):
        self.num_labels = num_labels
        self._to_int: Dict[str, int] = {}
        self._to_str: Dict[int, str] = {}
        if names is not None:
            if isinstance(names, Mapping):
                for name, idx in names.items():
                    self.add(name, int(idx))
            else:
                for idx, name in enumerate(names):
                    self.add(name, idx)

    @classmethod
    def for_graph(cls, graph,
                  names: Union[None, Sequence[str], Mapping[str, int]] = None
                  ) -> "Vocab":
        return cls(names=names, num_labels=graph.num_labels)

    def add(self, name: str, idx: int) -> None:
        if _NAME.fullmatch(name) is None:
            raise ValueError(f"label name {name!r} is not a valid identifier "
                             f"([A-Za-z_][A-Za-z0-9_]*): fmt() output would "
                             f"not parse back")
        m = _GENERIC_LABEL.match(name)
        if m and int(m.group(1)) != idx:
            raise ValueError(f"label name {name!r} shadows the generic "
                             f"spelling of label id {m.group(1)} but maps "
                             f"to id {idx}")
        if self.num_labels is not None and not (0 <= idx < self.num_labels):
            raise ValueError(f"label id {idx} outside label space "
                             f"[0, {self.num_labels})")
        self._to_int[name] = idx
        self._to_str[idx] = name

    def encode(self, name: str) -> int:
        """Label name -> int id.  Raises ``KeyError`` if unknown."""
        if name in self._to_int:
            return self._to_int[name]
        m = _GENERIC_LABEL.match(name)
        if m:
            idx = int(m.group(1))
            if self.num_labels is None or idx < self.num_labels:
                return idx
        raise KeyError(name)

    def decode(self, idx: int) -> str:
        return self._to_str.get(int(idx), f"L{int(idx)}")

    def known_names(self) -> List[str]:
        return sorted(self._to_int)


class QueryParseError(ValueError):
    """Parse failure with position information and a caret display."""

    def __init__(self, msg: str, text: str, pos: int):
        self.msg, self.text, self.pos = msg, text, pos
        super().__init__(self.__str__())

    def __str__(self) -> str:
        line = self.text.replace("\n", " ")
        return f"{self.msg}\n  {line}\n  {' ' * self.pos}^"


# ------------------------------------------------------------------- lexer
_EDGE_TOKENS: List[Tuple[str, Tuple[int, bool]]] = [
    # token -> (kind, reversed)
    ("-//->", (DESC, False)),
    ("-/->", (CHILD, False)),
    ("<-//-", (DESC, True)),
    ("<-/-", (CHILD, True)),
]
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@dataclass
class _Token:
    kind: str          # 'lparen' | 'rparen' | 'colon' | 'comma' | 'edge' | 'name'
    pos: int
    text: str = ""
    edge: Tuple[int, bool] = (CHILD, False)


def _lex(text: str) -> List[_Token]:
    toks: List[_Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "(":
            toks.append(_Token("lparen", i))
            i += 1
        elif c == ")":
            toks.append(_Token("rparen", i))
            i += 1
        elif c == ":":
            toks.append(_Token("colon", i))
            i += 1
        elif c == ",":
            toks.append(_Token("comma", i))
            i += 1
        else:
            for tok, edge in _EDGE_TOKENS:
                if text.startswith(tok, i):
                    toks.append(_Token("edge", i, tok, edge))
                    i += len(tok)
                    break
            else:
                m = _NAME.match(text, i)
                if m:
                    toks.append(_Token("name", i, m.group(0)))
                    i = m.end()
                else:
                    raise QueryParseError(
                        f"unexpected character {c!r} (expected a node "
                        f"'(name:Label)', an edge '-/->' / '-//->', or ',')",
                        text, i)
    return toks


# ------------------------------------------------------------------ parser
class _Parser:
    def __init__(self, text: str, vocab: Vocab):
        self.text = text
        self.vocab = vocab
        self.toks = _lex(text)
        self.i = 0
        self.index: Dict[str, int] = {}      # node name -> query-node index
        self.labels: List[int] = []
        self.edges: List[Tuple[int, int, int]] = []

    def _err(self, msg: str, pos: Optional[int] = None) -> QueryParseError:
        if pos is None:
            pos = (self.toks[self.i].pos if self.i < len(self.toks)
                   else len(self.text))
        return QueryParseError(msg, self.text, pos)

    def _peek(self) -> Optional[_Token]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    _PUNCT = {"lparen": "'('", "rparen": "')'", "colon": "':'",
              "comma": "','"}

    def _expect(self, kind: str, what: str) -> _Token:
        t = self._peek()
        if t is None:
            got = "end of query"
        elif t.text:
            got = repr(t.text)
        else:
            got = self._PUNCT.get(t.kind, t.kind)
        if t is None or t.kind != kind:
            raise self._err(f"expected {what}, got {got}")
        self.i += 1
        return t

    def _node(self) -> int:
        self._expect("lparen", "'('")
        name_tok = self._expect("name", "a node name")
        name = name_tok.text
        label_tok = None
        if self._peek() and self._peek().kind == "colon":
            self.i += 1
            label_tok = self._expect("name", "a label name after ':'")
        self._expect("rparen", "')'")

        label: Optional[int] = None
        if label_tok is not None:
            try:
                label = self.vocab.encode(label_tok.text)
            except KeyError:
                known = self.vocab.known_names()
                hint = f" (known labels: {', '.join(known)})" if known else \
                       " (use L0, L1, ... for unnamed labels)"
                raise self._err(f"unknown label {label_tok.text!r}{hint}",
                                label_tok.pos) from None
        if name in self.index:
            q = self.index[name]
            if label is not None and label != self.labels[q]:
                raise self._err(
                    f"node {name!r} relabeled: was "
                    f"{self.vocab.decode(self.labels[q])!r}, "
                    f"now {label_tok.text!r}", label_tok.pos)
            return q
        if label is None:
            raise self._err(
                f"node {name!r} needs a label on first mention, e.g. "
                f"({name}:SomeLabel)", name_tok.pos)
        q = len(self.labels)
        self.index[name] = q
        self.labels.append(label)
        return q

    def _segment(self) -> None:
        src = self._node()
        while True:
            t = self._peek()
            if t is None or t.kind != "edge":
                return
            self.i += 1
            dst = self._node()
            kind, reversed_ = t.edge
            a, b = (dst, src) if reversed_ else (src, dst)
            if a == b:
                raise self._err("self-loop pattern edges are not supported",
                                t.pos)
            self.edges.append((a, b, kind))
            src = dst

    def run(self) -> PatternQuery:
        if not self.toks:
            raise self._err("empty query", 0)
        self._segment()
        while self._peek() is not None:
            self._expect("comma", "',' between segments")
            self._segment()
        return PatternQuery(labels=self.labels,
                            edges=[QueryEdge(*e) for e in self.edges])


def parse(text: str, vocab: Optional[Vocab] = None,
          name: str = "") -> PatternQuery:
    """Parse query text into a :class:`PatternQuery`.

    Node indices follow first appearance in the text; labels go through
    ``vocab`` (default: the generic ``L<i>`` spelling only).
    """
    q = _Parser(text, vocab or Vocab()).run()
    q.name = name
    return q


# ----------------------------------------------------------- pretty-printer
def node_name(i: int) -> str:
    """Canonical node names: a..z then n26, n27, ..."""
    return chr(ord("a") + i) if i < 26 else f"n{i}"


_EDGE_STR = {CHILD: "-/->", DESC: "-//->"}


def fmt(q: PatternQuery, vocab: Optional[Vocab] = None) -> str:
    """Pretty-print ``q`` so that ``parse(fmt(q))`` reproduces it exactly
    (same node indexing, labels and edges; ``name`` is not serialized).

    Edges are emitted as maximal chains.  If chaining alone would mention
    nodes out of index order (which would re-index them on parse), node
    declarations are prepended in index order.
    """
    vocab = vocab or Vocab()
    if q.n == 0:
        raise ValueError("cannot format an empty query")

    # greedy chain decomposition over the canonical (sorted) edge order
    unused = list(q.edges)
    chains: List[List[QueryEdge]] = []
    while unused:
        chain = [unused.pop(0)]
        while True:
            tail = chain[-1].dst
            nxt = next((e for e in unused if e.src == tail), None)
            if nxt is None:
                break
            unused.remove(nxt)
            chain.append(nxt)
        chains.append(chain)

    appearance: List[int] = []
    seen = set()

    def _appear(v: int) -> None:
        if v not in seen:
            seen.add(v)
            appearance.append(v)

    for chain in chains:
        _appear(chain[0].src)
        for e in chain:
            _appear(e.dst)
    in_order = (appearance == sorted(appearance)
                and len(appearance) == q.n)

    segments: List[str] = []
    emitted = set()

    def _node(v: int) -> str:
        if v in emitted:
            return f"({node_name(v)})"
        emitted.add(v)
        return f"({node_name(v)}:{vocab.decode(q.labels[v])})"

    if not in_order:
        # declare every node first, in index order, then chains by reference
        segments.extend(_node(v) for v in range(q.n))
    for chain in chains:
        parts = [_node(chain[0].src)]
        for e in chain:
            parts.append(_EDGE_STR[e.kind])
            parts.append(_node(e.dst))
        segments.append("".join(parts))
    return ", ".join(segments)
