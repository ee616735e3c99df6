# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Guided (structured) decoding: regex and JSON-schema constrained sampling
(the port's own copy of ``conch_tpu/serving/guided.py``; numpy and json only).

Pipeline:

1. ``compile_regex``: a regex subset (literals, escapes, character
   classes, ``.``, ``* + ? {m,n}``, groups, alternation) to a Thompson NFA.
   Python's ``re`` cannot enumerate transition sets, so the subset has its
   own compiler.
2. ``TokenFSM.from_regex``: the character NFA lifted to a DFA over the
   tokenizer's vocabulary: a (states, vocab) int32 transition table and a
   bool ``allowed`` mask a state, built by subset construction over the
   reachable state sets only, with a (state set, char) memo so that shared
   token prefixes are walked once.
3. ``json_schema_to_regex``: a flat JSON-schema subset (an object of
   string / integer / number / boolean / null / enum / homogeneous array
   properties) to a regex, outlines-style: fixed property order, minimal
   optional whitespace.

The engine (``serving/engine.py``) masks a guided request's disallowed next
tokens to -inf each step, last among the logit rules: EOS is legal only in
accepting states, and the only legal token once the match cannot extend.
A request's FSM state is walked from its ``output_tokens`` (with an O(1)
incremental cache), so a preemption's recompute and a parallel-sampling
fork need no bookkeeping of their own. The FSM is host state, like the
block tables; the device sees one (rows, vocab) bool mask a step.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

# --------------------------------------------------------------------------
# Regex subset -> NFA
# --------------------------------------------------------------------------

_ANY = ("any",)

_ESCAPE_CLASSES = {
    "d": frozenset("0123456789"),
    "w": frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(" \t\n\r\f\v"),
}
_ESCAPE_LITERALS = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v", "0": "\0"}


@dataclass
class _Nfa:
    """Thompson NFA fragment set. States are ints; edge predicates are
    ('any',), ('in', chars) or ('notin', chars)."""

    edges: list[tuple[int, tuple, int]] = field(default_factory=list)
    eps: list[tuple[int, int]] = field(default_factory=list)
    n_states: int = 0
    start: int = 0
    accept: int = 0

    def new_state(self) -> int:
        self.n_states += 1
        return self.n_states - 1


class _RegexParser:
    """Recursive-descent parser building a Thompson NFA.

    Grammar: alt := concat ('|' concat)* ; concat := repeat* ;
    repeat := atom ('*'|'+'|'?'|'{m,n}')* ; atom := '(' alt ')' |
    '[' class ']' | '.' | escape | literal.
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _Nfa()

    # -- character stream ---------------------------------------------------
    def _peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def _expect(self, ch: str) -> None:
        if self._peek() != ch:
            msg = f"regex parse error at {self.i}: expected {ch!r} in {self.p!r}"
            raise ValueError(msg)
        self._next()

    # -- fragments ------------------------------------------------------------
    def _frag_pred(self, pred: tuple) -> tuple[int, int]:
        s, a = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.edges.append((s, pred, a))
        return s, a

    def _frag_empty(self) -> tuple[int, int]:
        s = self.nfa.new_state()
        return s, s

    def _concat(self, f1, f2):
        self.nfa.eps.append((f1[1], f2[0]))
        return f1[0], f2[1]

    def _union(self, f1, f2):
        s, a = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.eps += [(s, f1[0]), (s, f2[0]), (f1[1], a), (f2[1], a)]
        return s, a

    def _star(self, f):
        s, a = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.eps += [(s, f[0]), (s, a), (f[1], f[0]), (f[1], a)]
        return s, a

    def _copy_frag(self, frag, edges_snapshot, eps_snapshot):
        """Duplicate a fragment (for {m,n} expansion) by re-numbering the
        states reachable in its recorded edge lists."""
        remap: dict[int, int] = {}

        def m(st: int) -> int:
            if st not in remap:
                remap[st] = self.nfa.new_state()
            return remap[st]

        for src, pred, dst in edges_snapshot:
            self.nfa.edges.append((m(src), pred, m(dst)))
        for src, dst in eps_snapshot:
            self.nfa.eps.append((m(src), m(dst)))
        return m(frag[0]), m(frag[1])

    # -- grammar --------------------------------------------------------------
    def parse(self) -> _Nfa:
        frag = self._alt()
        if self.i != len(self.p):
            msg = f"regex parse error: trailing input at {self.i} in {self.p!r}"
            raise ValueError(msg)
        self.nfa.start, self.nfa.accept = frag
        return self.nfa

    def _alt(self):
        frag = self._concat_seq()
        while self._peek() == "|":
            self._next()
            frag = self._union(frag, self._concat_seq())
        return frag

    def _concat_seq(self):
        frag = None
        while self._peek() not in (None, "|", ")"):
            nxt = self._repeat()
            frag = nxt if frag is None else self._concat(frag, nxt)
        return frag if frag is not None else self._frag_empty()

    def _repeat(self):
        # Snapshot edge list indices so {m,n} can copy just this atom.
        e0, p0 = len(self.nfa.edges), len(self.nfa.eps)
        frag = self._atom()
        while self._peek() in ("*", "+", "?", "{"):
            edges_snap = self.nfa.edges[e0:]
            eps_snap = self.nfa.eps[p0:]
            op = self._next()
            if op == "*":
                frag = self._star(frag)
            elif op == "+":
                frag = self._concat(frag, self._star(self._copy_frag(frag, edges_snap, eps_snap)))
            elif op == "?":
                frag = self._union(frag, self._frag_empty())
            else:  # {m}, {m,}, {m,n}
                lo_s = ""
                while self._peek() is not None and self._peek().isdigit():
                    lo_s += self._next()
                hi_s: str | None = lo_s
                if self._peek() == ",":
                    self._next()
                    hi_s = ""
                    while self._peek() is not None and self._peek().isdigit():
                        hi_s += self._next()
                self._expect("}")
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s else None  # None => unbounded
                parts = [frag]
                count = lo if hi is None else max(hi, lo)
                for _ in range(max(count - 1, 0)):
                    parts.append(self._copy_frag(frag, edges_snap, eps_snap))
                out = None
                for k, part in enumerate(parts):
                    if k >= lo:
                        part = self._union(part, self._frag_empty())
                    out = part if out is None else self._concat(out, part)
                if hi is None:
                    tail = self._star(self._copy_frag(frag, edges_snap, eps_snap))
                    out = tail if out is None else self._concat(out, tail)
                frag = out if out is not None else self._frag_empty()
            e0, p0 = len(self.nfa.edges), len(self.nfa.eps)
        return frag

    def _atom(self):
        ch = self._peek()
        if ch == "(":
            self._next()
            if self._peek() == "?":  # (?:...) non-capturing — same thing here
                self._next()
                self._expect(":")
            frag = self._alt()
            self._expect(")")
            return frag
        if ch == "[":
            return self._frag_pred(self._char_class())
        if ch == ".":
            self._next()
            return self._frag_pred(_ANY)
        if ch == "\\":
            self._next()
            return self._frag_pred(self._escape_pred(self._next()))
        if ch in ("*", "+", "?", "{", "}", ")", "|"):
            msg = f"regex parse error: unexpected {ch!r} at {self.i} in {self.p!r}"
            raise ValueError(msg)
        self._next()
        return self._frag_pred(("in", frozenset(ch)))

    def _escape_pred(self, ch: str) -> tuple:
        if ch in _ESCAPE_CLASSES:
            return ("in", _ESCAPE_CLASSES[ch])
        if ch.upper() == ch and ch.lower() in _ESCAPE_CLASSES:  # \D \W \S
            return ("notin", _ESCAPE_CLASSES[ch.lower()])
        return ("in", frozenset(_ESCAPE_LITERALS.get(ch, ch)))

    def _char_class(self) -> tuple:
        self._expect("[")
        negate = self._peek() == "^"
        if negate:
            self._next()
        chars: set[str] = set()
        first = True
        while self._peek() != "]" or first:
            first = False
            if self._peek() is None:
                msg = f"regex parse error: unterminated class in {self.p!r}"
                raise ValueError(msg)
            ch = self._next()
            if ch == "\\":
                pred = self._escape_pred(self._next())
                if pred[0] == "notin":
                    msg = "negated escape inside a character class is unsupported"
                    raise ValueError(msg)
                chars |= set(pred[1])
                continue
            if self._peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self._next()
                hi = self._next()
                if hi == "\\":
                    hi = self._next()
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)
        self._expect("]")
        return ("notin" if negate else "in", frozenset(chars))


def compile_regex(pattern: str) -> _Nfa:
    """Compile the supported regex subset to a Thompson NFA."""
    return _RegexParser(pattern).parse()


def _pred_matches(pred: tuple, ch: str) -> bool:
    if pred[0] == "any":
        return True
    if pred[0] == "in":
        return ch in pred[1]
    return ch not in pred[1]


# --------------------------------------------------------------------------
# Token-level FSM (DFA over the vocabulary)
# --------------------------------------------------------------------------


class TokenFSM:
    """DFA over *tokens*: ``transitions[state, token] -> state`` (-1 =
    token not allowed), ``accepting[state]`` marks states where the full
    match is complete (EOS becomes legal).

    Built once per (pattern, vocab) on the host; per-step masking is one
    row lookup + one device scatter. Identity-hashable so it can live in
    a frozen ``SamplingParams``.
    """

    def __init__(self, transitions: np.ndarray, accepting: np.ndarray, pattern: str = ""):
        self.transitions = transitions  # (S, V) int32
        self.allowed = transitions >= 0  # (S, V) bool
        self.accepting = accepting  # (S,) bool
        self.pattern = pattern

    # Explicit identity semantics (frozen-dataclass fields need hash).
    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other

    @property
    def num_states(self) -> int:
        return self.transitions.shape[0]

    @property
    def start_state(self) -> int:
        return 0

    def advance(self, state: int, token: int) -> int:
        """Next state after emitting ``token`` (-1 if illegal/dead)."""
        if state < 0:
            return -1
        return int(self.transitions[state, token])

    def walk(self, tokens: list[int], state: int | None = None) -> int:
        s = self.start_state if state is None else state
        for t in tokens:
            s = self.advance(s, t)
            if s < 0:
                break
        return s

    @classmethod
    def from_regex(cls, pattern: str, vocab: list[str]) -> TokenFSM:
        """Lift a character regex to a token DFA over ``vocab``.

        ``vocab[token_id]`` is the decoded string of that token. Tokens
        that decode to the empty string are never allowed (they would
        stall the FSM).
        """
        nfa = compile_regex(pattern)

        # eps-closures once per NFA state.
        eps_adj: dict[int, list[int]] = {}
        for src, dst in nfa.eps:
            eps_adj.setdefault(src, []).append(dst)

        def closure(states: frozenset[int]) -> frozenset[int]:
            seen = set(states)
            stack = list(states)
            while stack:
                s = stack.pop()
                for d in eps_adj.get(s, ()):
                    if d not in seen:
                        seen.add(d)
                        stack.append(d)
            return frozenset(seen)

        out_edges: dict[int, list[tuple[tuple, int]]] = {}
        for src, pred, dst in nfa.edges:
            out_edges.setdefault(src, []).append((pred, dst))

        start = closure(frozenset([nfa.start]))
        set_ids: dict[frozenset[int], int] = {start: 0}
        sets: list[frozenset[int]] = [start]
        # memo: (set_id, char) -> set_id or -1
        char_memo: dict[tuple[int, str], int] = {}

        def step_char(set_id: int, ch: str) -> int:
            key = (set_id, ch)
            if key in char_memo:
                return char_memo[key]
            nxt: set[int] = set()
            for s in sets[set_id]:
                for pred, dst in out_edges.get(s, ()):
                    if _pred_matches(pred, ch):
                        nxt.add(dst)
            if not nxt:
                char_memo[key] = -1
                return -1
            closed = closure(frozenset(nxt))
            if closed not in set_ids:
                set_ids[closed] = len(sets)
                sets.append(closed)
            result = set_ids[closed]
            char_memo[key] = result
            return result

        vocab_rows: list[np.ndarray] = []
        accepting: list[bool] = [nfa.accept in start]
        frontier = 0
        while frontier < len(sets):
            row = np.full(len(vocab), -1, dtype=np.int32)
            for tok_id, text in enumerate(vocab):
                if not text:
                    continue
                sid = frontier
                for ch in text:
                    sid = step_char(sid, ch)
                    if sid < 0:
                        break
                row[tok_id] = sid
            vocab_rows.append(row)
            while len(accepting) < len(sets):
                accepting.append(nfa.accept in sets[len(accepting)])
            frontier += 1

        return cls(np.stack(vocab_rows), np.asarray(accepting, dtype=bool), pattern)


# --------------------------------------------------------------------------
# Flat JSON-schema subset -> regex
# --------------------------------------------------------------------------

_REGEX_META = set("\\^$.|?*+()[]{}")


def _rx_escape(text: str) -> str:
    return "".join("\\" + c if c in _REGEX_META else c for c in text)


_STRING_RX = '"[^"]*"'
_INT_RX = "-?(0|[1-9][0-9]*)"
_NUMBER_RX = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?"
_BOOL_RX = "(true|false)"
_NULL_RX = "null"


def _value_regex(spec: dict) -> str:
    if "enum" in spec:
        opts = "|".join(_rx_escape(json.dumps(v)) for v in spec["enum"])
        return f"({opts})"
    t = spec.get("type")
    if t == "string":
        return _STRING_RX
    if t == "integer":
        return _INT_RX
    if t == "number":
        return _NUMBER_RX
    if t == "boolean":
        return _BOOL_RX
    if t == "null":
        return _NULL_RX
    if t == "array":
        item = _value_regex(spec.get("items", {"type": "string"}))
        return f"\\[({item}(, ?{item})*)?\\]"
    msg = f"unsupported JSON schema fragment: {spec!r} (flat subset only)"
    raise ValueError(msg)


def json_schema_to_regex(schema: dict) -> str:
    """Flat JSON-schema subset -> regex (canonical key order, minimal
    optional whitespace), in the style of outlines' schema compilation."""
    if schema.get("type") != "object" or "properties" not in schema:
        msg = "top-level schema must be {'type': 'object', 'properties': ...}"
        raise ValueError(msg)
    parts = []
    for name, spec in schema["properties"].items():
        key = _rx_escape(json.dumps(name))
        parts.append(f"{key}: ?{_value_regex(spec)}")
    body = ", ?".join(parts)
    return "\\{ ?" + body + " ?\\}"


def fsm_for_json_schema(schema: dict, vocab: list[str]) -> TokenFSM:
    return TokenFSM.from_regex(json_schema_to_regex(schema), vocab)
