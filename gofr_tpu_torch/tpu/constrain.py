"""Grammar-constrained decoding: the host-side token-mask engine
(counterpart of ``gofr_tpu/tpu/constrain.py``, a copy of its code: numpy
and ``json`` only).

Compiles a grammar — a limited regex dialect or a JSON schema lowered to
that dialect — into a byte-level DFA, then lifts the DFA to *token*
granularity against the serving tokenizer's vocabulary: for each DFA
state it materialises a cached boolean "token allowed" mask and a float32
additive logit-bias row (0 for allowed tokens, ``NEG_BIAS`` for
disallowed ones). The engine copies the row of each constrained slot
into a (max_slots, vocab) host slab, uploads it into a device buffer at a
fixed address ahead of the tick that reads it, and the tick adds it to
the decode logits before argmax or sampling — so greedy output under a
fixed grammar is bit-reproducible (same mask → same biased logits → same
argmax) across the dense and paged KV layouts.

Byte-level on purpose: the repo's tokenizer is byte-level BPE (ids
0..255 are raw bytes; merged ids concatenate their children), so walking
a token means walking its byte expansion through the DFA. Multi-byte
UTF-8 literals in a pattern compile to byte sequences; ``.`` matches any
byte except ``\\n``.

Everything here is cold-path host code (grammar compile happens at
submission, mask rows are cached per (grammar, state)); the only hot-path
work is a row copy into the tick's slab in the engine. The grammar tables
stay numpy: what reaches the device is the bias slab only.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# Additive bias for disallowed tokens. Finite (not -inf) so temperature
# scaling and top-k renormalisation in the sampled path never produce
# NaNs, yet far below any real logit so argmax/softmax mass is zero.
NEG_BIAS = np.float32(-1e9)

_ALL_BYTES = (1 << 256) - 1
_MAX_DFA_STATES = 4096
_MAX_PATTERN_LEN = 4096


class GrammarError(ValueError):
    """Raised for malformed patterns/schemas or resource-limit blowups."""


# -- token byte table ---------------------------------------------------------

def token_byte_table(tokenizer=None, vocab_size: Optional[int] = None
                     ) -> List[bytes]:
    """Byte expansion of every vocab id, in id order.

    Works off the tokenizer's ``merges`` list (byte-level BPE: id ``i`` <
    256 is ``bytes([i])``; merge ``j`` yields id ``256+j`` concatenating
    its pair). Ids past the derivable range (padded vocabs) map to
    ``b""`` and are never allowed by any grammar.
    """
    merges = list(getattr(tokenizer, "merges", None) or [])
    size = vocab_size if vocab_size is not None else 256 + len(merges)
    table: List[bytes] = [bytes([i]) for i in range(min(256, size))]
    for j, (left, right) in enumerate(merges):
        if 256 + j >= size:
            break
        table.append(table[left] + table[right])
    while len(table) < size:
        table.append(b"")
    return table


# -- regex → NFA (Thompson construction over bytes) ---------------------------

class _NFA:
    """States have epsilon edges plus byte-class edges (mask → dst).
    Masks are 256-bit ints; bit b set means byte b is accepted."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[int, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, src: int, dst: int) -> None:
        self.eps[src].append(dst)

    def add_edge(self, src: int, mask: int, dst: int) -> None:
        self.edges[src].append((mask, dst))


_CLASS_D = 0
for _b in range(ord("0"), ord("9") + 1):
    _CLASS_D |= 1 << _b
_CLASS_W = _CLASS_D | (1 << ord("_"))
for _b in range(ord("a"), ord("z") + 1):
    _CLASS_W |= 1 << _b
for _b in range(ord("A"), ord("Z") + 1):
    _CLASS_W |= 1 << _b
_CLASS_S = 0
for _b in b" \t\r\n\f\v":
    _CLASS_S |= 1 << _b
_CLASS_DOT = _ALL_BYTES & ~(1 << ord("\n"))

_ESCAPE_CLASSES = {
    "d": _CLASS_D, "D": _ALL_BYTES & ~_CLASS_D,
    "w": _CLASS_W, "W": _ALL_BYTES & ~_CLASS_W,
    "s": _CLASS_S, "S": _ALL_BYTES & ~_CLASS_S,
}
_ESCAPE_CHARS = {"n": ord("\n"), "t": ord("\t"), "r": ord("\r"),
                 "f": ord("\f"), "v": ord("\v"), "0": 0}


class _Parser:
    """Recursive-descent parser for the supported dialect:
    literals (incl. multi-byte UTF-8), ``.``, escapes (``\\d \\w \\s``
    + negations, ``\\xHH``, control chars, escaped metachars),
    ``[...]`` classes with ranges and negation, grouping ``(...)``,
    alternation ``|``, and repetition ``* + ? {m} {m,} {m,n}``.
    Anchors/backrefs/lookaround are rejected — token masking needs a
    pure DFA."""

    def __init__(self, pattern: str):
        if len(pattern) > _MAX_PATTERN_LEN:
            raise GrammarError(
                f"pattern too long ({len(pattern)} > {_MAX_PATTERN_LEN})")
        self.src = pattern
        self.pos = 0
        self.nfa = _NFA()

    def parse(self) -> Tuple[int, int]:
        start, accept = self._alternation()
        if self.pos != len(self.src):
            raise GrammarError(
                f"unexpected {self.src[self.pos]!r} at {self.pos}")
        return start, accept

    def _peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def _take(self) -> str:
        ch = self.src[self.pos]
        self.pos += 1
        return ch

    # fragment = (start, accept)
    def _alternation(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        start, accept = self.nfa.state(), self.nfa.state()
        for fragment_start, fragment_accept in frags:
            self.nfa.add_eps(start, fragment_start)
            self.nfa.add_eps(fragment_accept, accept)
        return start, accept

    def _concat(self) -> Tuple[int, int]:
        start = self.nfa.state()
        accept = start
        while self._peek() not in ("", "|", ")"):
            fragment_start, fragment_accept = self._repeat()
            self.nfa.add_eps(accept, fragment_start)
            accept = fragment_accept
        return start, accept

    def _repeat(self) -> Tuple[int, int]:
        frag = self._atom()
        while self._peek() in ("*", "+", "?", "{"):
            op = self._peek()
            if op == "{":
                frag = self._bounded(frag)
                continue
            self._take()
            start, accept = self.nfa.state(), self.nfa.state()
            fragment_start, fragment_accept = frag
            self.nfa.add_eps(start, fragment_start)
            self.nfa.add_eps(fragment_accept, accept)
            if op in ("*", "?"):
                self.nfa.add_eps(start, accept)
            if op in ("*", "+"):
                self.nfa.add_eps(fragment_accept, fragment_start)
            frag = (start, accept)
        return frag

    def _bounded(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        # {m}, {m,}, {m,n} — expand by re-parsing the atom's source slice
        # is fragile, so instead duplicate the fragment structurally.
        brace = self.pos
        self._take()  # '{'
        spec = ""
        while self._peek() not in ("", "}"):
            spec += self._take()
        if self._peek() != "}":
            raise GrammarError(f"unterminated {{...}} at {brace}")
        self._take()
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s) if lo_s.strip() else 0
            hi = int(hi_s) if hi_s.strip() else lo + 64
        else:
            lo = hi = int(spec)
        if not (0 <= lo <= hi <= 256):
            raise GrammarError(f"bad repetition bounds {{{spec}}}")
        start = self.nfa.state()
        accept = start
        tails: List[int] = []
        for i in range(hi):
            copy_start, copy_accept = self._copy_fragment(frag)
            self.nfa.add_eps(accept, copy_start)
            if i >= lo:
                tails.append(accept)
            accept = copy_accept
        end = self.nfa.state()
        self.nfa.add_eps(accept, end)
        for tail in tails:
            self.nfa.add_eps(tail, end)
        if lo == 0 and hi == 0:
            self.nfa.add_eps(start, end)
        return start, end

    def _copy_fragment(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        """Deep-copy the subgraph reachable from frag's start."""
        start, accept = frag
        mapping: Dict[int, int] = {}
        stack = [start, accept]
        while stack:
            node = stack.pop()
            if node in mapping:
                continue
            mapping[node] = self.nfa.state()
            for dst in list(self.nfa.eps[node]):
                stack.append(dst)
            for _, dst in list(self.nfa.edges[node]):
                stack.append(dst)
        for node, clone in mapping.items():
            for dst in self.nfa.eps[node]:
                self.nfa.add_eps(clone, mapping[dst])
            for mask, dst in self.nfa.edges[node]:
                self.nfa.add_edge(clone, mask, mapping[dst])
        return mapping[start], mapping[accept]

    def _atom(self) -> Tuple[int, int]:
        ch = self._peek()
        if ch == "":
            raise GrammarError("unexpected end of pattern")
        if ch == "(":
            self._take()
            if self._peek() == "?":  # (?:...) non-capturing; others rejected
                self._take()
                if self._peek() != ":":
                    raise GrammarError("lookaround/backrefs unsupported")
                self._take()
            frag = self._alternation()
            if self._peek() != ")":
                raise GrammarError("unbalanced parenthesis")
            self._take()
            return frag
        if ch == "[":
            return self._byte_fragment(self._char_class())
        if ch == ".":
            self._take()
            return self._byte_fragment(_CLASS_DOT)
        if ch == "\\":
            return self._escape_fragment()
        if ch in ")|*+?{}]":
            raise GrammarError(f"unexpected {ch!r} at {self.pos}")
        self._take()
        return self._literal_fragment(ch)

    def _literal_fragment(self, ch: str) -> Tuple[int, int]:
        encoded = ch.encode("utf-8")
        start = self.nfa.state()
        node = start
        for byte in encoded:
            nxt = self.nfa.state()
            self.nfa.add_edge(node, 1 << byte, nxt)
            node = nxt
        return start, node

    def _byte_fragment(self, mask: int) -> Tuple[int, int]:
        start, accept = self.nfa.state(), self.nfa.state()
        self.nfa.add_edge(start, mask, accept)
        return start, accept

    def _escape_fragment(self) -> Tuple[int, int]:
        self._take()  # backslash
        if self._peek() == "":
            raise GrammarError("trailing backslash")
        ch = self._take()
        if ch in _ESCAPE_CLASSES:
            return self._byte_fragment(_ESCAPE_CLASSES[ch])
        return self._byte_fragment(1 << self._escape_byte(ch))

    def _escape_byte(self, ch: str) -> int:
        if ch in _ESCAPE_CHARS:
            return _ESCAPE_CHARS[ch]
        if ch == "x":
            hexpair = self.src[self.pos:self.pos + 2]
            if len(hexpair) != 2:
                raise GrammarError("truncated \\xHH escape")
            self.pos += 2
            return int(hexpair, 16)
        if ch in ".^$*+?()[]{}|\\/\"'-":
            return ord(ch)
        raise GrammarError(f"unsupported escape \\{ch}")

    def _char_class(self) -> int:
        self._take()  # '['
        negate = False
        if self._peek() == "^":
            negate = True
            self._take()
        mask = 0
        first = True
        while True:
            ch = self._peek()
            if ch == "":
                raise GrammarError("unterminated character class")
            if ch == "]" and not first:
                self._take()
                break
            first = False
            low = self._class_member()
            if low < 0:  # multi-byte escape class like \d inside [...]
                mask |= -low - 1
                continue
            if self._peek() == "-" and self.src[self.pos + 1:self.pos + 2] \
                    not in ("]", ""):
                self._take()
                high = self._class_member()
                if high < 0 or high < low:
                    raise GrammarError("bad character-class range")
                for byte in range(low, high + 1):
                    mask |= 1 << byte
            else:
                mask |= 1 << low
        if negate:
            mask = _ALL_BYTES & ~mask
        return mask

    def _class_member(self) -> int:
        """One class member → byte value, or -(mask+1) for escape classes."""
        ch = self._take()
        if ch == "\\":
            if self._peek() == "":
                raise GrammarError("trailing backslash in class")
            esc = self._take()
            if esc in _ESCAPE_CLASSES:
                return -(_ESCAPE_CLASSES[esc] + 1)
            return self._escape_byte(esc)
        code = ch.encode("utf-8")
        if len(code) != 1:
            raise GrammarError(
                "non-ASCII characters unsupported inside [...] classes")
        return code[0]


# -- lazy subset-construction DFA ---------------------------------------------

class _DFA:
    """NFA → DFA by lazy subset construction: transitions are computed
    per (state, byte) on first use and memoised, so negated classes and
    ``.`` never force a full 256-way table walk upfront. Dead state is
    ``-1``."""

    def __init__(self, nfa: _NFA, start: int, accept: int):
        self._nfa = nfa
        self._accept_nfa = accept
        self._ids: Dict[frozenset, int] = {}
        self._sets: List[frozenset] = []
        self._accepting: List[bool] = []
        self._trans: Dict[Tuple[int, int], int] = {}
        self.start = self._intern(self._closure({start}))

    def _closure(self, states) -> frozenset:
        seen = set(states)
        stack = list(states)
        eps = self._nfa.eps
        while stack:
            node = stack.pop()
            for dst in eps[node]:
                if dst not in seen:
                    seen.add(dst)
                    stack.append(dst)
        return frozenset(seen)

    def _intern(self, closed: frozenset) -> int:
        sid = self._ids.get(closed)
        if sid is None:
            if len(self._sets) >= _MAX_DFA_STATES:
                raise GrammarError(
                    f"grammar DFA exceeds {_MAX_DFA_STATES} states")
            sid = len(self._sets)
            self._ids[closed] = sid
            self._sets.append(closed)
            self._accepting.append(self._accept_nfa in closed)
        return sid

    def step(self, state: int, byte: int) -> int:
        if state < 0:
            return -1
        key = (state, byte)
        dest = self._trans.get(key)
        if dest is not None:
            return dest
        bit = 1 << byte
        moved = set()
        edges = self._nfa.edges
        for node in self._sets[state]:
            for mask, dst in edges[node]:
                if mask & bit:
                    moved.add(dst)
        dest = self._intern(self._closure(moved)) if moved else -1
        self._trans[key] = dest
        return dest

    def accepting(self, state: int) -> bool:
        return state >= 0 and self._accepting[state]

    @property
    def n_states(self) -> int:
        return len(self._sets)


# -- JSON schema → regex ------------------------------------------------------

_REGEX_META = set(".^$*+?()[]{}|\\")


def _regex_escape(text: str) -> str:
    return "".join("\\" + ch if ch in _REGEX_META else ch for ch in text)


_JSON_STRING = ('"([^"\\\\\\x00-\\x1f]|\\\\["\\\\/bfnrt]'
                '|\\\\u[0-9a-fA-F]{4})*"')
_JSON_INTEGER = "-?(0|[1-9][0-9]*)"
_JSON_NUMBER = _JSON_INTEGER + "(\\.[0-9]+)?([eE][+-]?[0-9]+)?"

_MAX_SCHEMA_DEPTH = 16


def schema_to_regex(schema, depth: int = 0) -> str:
    """Lower a (restricted) JSON schema to the regex dialect above,
    matching *canonical* JSON: no whitespace, object keys in declared
    order, all declared properties present. That canonical form is what
    the bias mask steers the model to emit."""
    if depth > _MAX_SCHEMA_DEPTH:
        raise GrammarError("schema nesting too deep")
    if not isinstance(schema, dict):
        raise GrammarError("schema must be an object")
    if "const" in schema:
        return _regex_escape(json.dumps(schema["const"],
                                        separators=(",", ":")))
    if "enum" in schema:
        choices = [_regex_escape(json.dumps(value, separators=(",", ":")))
                   for value in schema["enum"]]
        if not choices:
            raise GrammarError("empty enum")
        return "(" + "|".join(choices) + ")"
    if "anyOf" in schema or "oneOf" in schema:
        subs = schema.get("anyOf") or schema.get("oneOf")
        return "(" + "|".join(schema_to_regex(sub, depth + 1)
                              for sub in subs) + ")"
    kind = schema.get("type")
    if kind == "string":
        if "pattern" in schema:
            return '"' + schema["pattern"] + '"'
        return _JSON_STRING
    if kind == "integer":
        return _JSON_INTEGER
    if kind == "number":
        return _JSON_NUMBER
    if kind == "boolean":
        return "(true|false)"
    if kind == "null":
        return "null"
    if kind == "object":
        properties = schema.get("properties", {})
        if not properties:
            raise GrammarError("object schema needs explicit properties")
        parts = []
        for key, sub in properties.items():
            parts.append('"' + _regex_escape(key) + '":'
                         + schema_to_regex(sub, depth + 1))
        return "\\{" + ",".join(parts) + "\\}"
    if kind == "array":
        item = schema_to_regex(schema.get("items", {"type": "integer"}),
                               depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 8))
        if not (0 <= lo <= hi <= 64):
            raise GrammarError("array bounds out of range (0..64)")
        if hi == 0:
            return "\\[\\]"
        body = f"({item})(,({item})){{{max(lo - 1, 0)},{hi - 1}}}"
        if lo == 0:
            return "\\[(" + body + ")?\\]"
        return "\\[" + body + "\\]"
    raise GrammarError(f"unsupported schema type {kind!r}")


# -- compiled grammar: token-level masks over the DFA -------------------------

class CompiledGrammar:
    """A byte-DFA lifted to token granularity, with per-state cached
    boolean allowed-masks and float32 bias rows. Shared across requests
    via :class:`GrammarCache`; per-request position lives in
    :class:`GrammarWalker`."""

    def __init__(self, pattern: str, token_table: List[bytes],
                 eos_id: Optional[int], source_key: str = ""):
        parser = _Parser(pattern)
        start, accept = parser.parse()
        self.pattern = pattern
        self.source_key = source_key or pattern
        self.dfa = _DFA(parser.nfa, start, accept)
        self.token_table = token_table
        self.vocab = len(token_table)
        self.eos_id = eos_id
        self._rows: Dict[int, np.ndarray] = {}
        self._allowed: Dict[int, np.ndarray] = {}
        self._open_count: Dict[int, int] = {}  # allowed non-eos tokens
        self._token_dest: Dict[Tuple[int, int], int] = {}
        self.mask_builds = 0
        self.mask_hits = 0

    @property
    def start(self) -> int:
        return self.dfa.start

    def token_dest(self, state: int, token_id: int) -> int:
        key = (state, token_id)
        dest = self._token_dest.get(key)
        if dest is not None:
            return dest
        if token_id == self.eos_id:
            dest = state if self.dfa.accepting(state) else -1
        else:
            expansion = (self.token_table[token_id]
                         if 0 <= token_id < self.vocab else b"")
            if not expansion:
                dest = -1
            else:
                dest = state
                for byte in expansion:
                    dest = self.dfa.step(dest, byte)
                    if dest < 0:
                        break
        self._token_dest[key] = dest
        return dest

    def _build_state(self, state: int) -> None:
        allowed = np.zeros((self.vocab,), dtype=bool)
        open_count = 0
        for token_id in range(self.vocab):
            if token_id == self.eos_id:
                allowed[token_id] = self.dfa.accepting(state)
            elif self.token_dest(state, token_id) >= 0:
                allowed[token_id] = True
                open_count += 1
        row = np.zeros((self.vocab,), dtype=np.float32)
        row[~allowed] = NEG_BIAS
        self._allowed[state] = allowed
        self._rows[state] = row
        self._open_count[state] = open_count
        self.mask_builds += 1

    def bias_row(self, state: int) -> np.ndarray:
        """Cached float32 (vocab,) additive-bias row for ``state``.
        Callers must treat it as read-only (copy into slabs)."""
        row = self._rows.get(state)
        if row is None:
            self._build_state(state)
            row = self._rows[state]
        else:
            self.mask_hits += 1
        return row

    def allowed_mask(self, state: int) -> np.ndarray:
        if state not in self._allowed:
            self._build_state(state)
        return self._allowed[state]

    def open_count(self, state: int) -> int:
        if state not in self._open_count:
            self._build_state(state)
        return self._open_count[state]

    def accepting(self, state: int) -> bool:
        return self.dfa.accepting(state)

    def fullmatch(self, token_ids) -> bool:
        """Would this token sequence be a complete grammar match?
        (Test/validation helper — not used on the serving path.)"""
        state = self.start
        for token_id in token_ids:
            if token_id == self.eos_id:
                return self.dfa.accepting(state)
            state = self.token_dest(state, token_id)
            if state < 0:
                return False
        return self.dfa.accepting(state)

    def stats(self) -> dict:
        return {"dfa_states": self.dfa.n_states,
                "cached_state_masks": len(self._rows),
                "mask_builds": self.mask_builds,
                "mask_hits": self.mask_hits}


class GrammarWalker:
    """Per-request cursor over a shared :class:`CompiledGrammar`."""

    __slots__ = ("grammar", "state", "violated")

    def __init__(self, grammar: CompiledGrammar):
        self.grammar = grammar
        self.state = grammar.start
        self.violated = False

    def bias_row(self) -> np.ndarray:
        return self.grammar.bias_row(self.state)

    def advance(self, token_id: int) -> bool:
        """Consume one emitted token. Returns False (and flags
        ``violated``) if the token falls outside the grammar — the
        engine finishes the slot rather than emitting garbage."""
        dest = self.grammar.token_dest(self.state, token_id)
        if dest < 0:
            self.violated = True
            return False
        self.state = dest
        return True

    @property
    def accepting(self) -> bool:
        return self.grammar.accepting(self.state)

    @property
    def must_stop(self) -> bool:
        """No non-eos continuation exists — the match is complete (or
        the walk is dead); the engine should finish the slot."""
        return self.violated or self.grammar.open_count(self.state) == 0


# -- grammar cache ------------------------------------------------------------

def canonical_source(response_format: dict) -> Tuple[str, str]:
    """Normalise a request ``response_format`` → (kind, canonical source).
    Supported: {"type": "regex", "pattern": ...} and
    {"type": "json_schema", "schema": {...}} (also accepts the nested
    OpenAI-style {"json_schema": {"schema": ...}} shape)."""
    if not isinstance(response_format, dict):
        raise GrammarError("response_format must be an object")
    kind = response_format.get("type")
    if kind == "regex":
        pattern = response_format.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError("regex response_format needs 'pattern'")
        return "regex", pattern
    if kind == "json_schema":
        schema = response_format.get("schema")
        if schema is None:
            nested = response_format.get("json_schema")
            if isinstance(nested, dict):
                # OpenAI nests {"json_schema": {"name", "schema": {...}}};
                # a bare {"json_schema": {<schema>}} is the schema itself
                inner = nested.get("schema")
                schema = inner if isinstance(inner, dict) else nested
        if not isinstance(schema, dict):
            raise GrammarError("json_schema response_format needs 'schema'")
        return "json_schema", json.dumps(schema, sort_keys=True,
                                         separators=(",", ":"))
    raise GrammarError(f"unsupported response_format type {kind!r}")


class GrammarCache:
    """LRU of :class:`CompiledGrammar`, keyed by (kind, canonical source,
    eos_id). One cache per engine (it is bound to the engine's token
    table), so repeat jobs against the same grammar pay compilation and
    per-state mask construction exactly once."""

    def __init__(self, token_table: List[bytes], max_entries: int = 32):
        self.token_table = token_table
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[Tuple[str, str, Optional[int]], CompiledGrammar]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, response_format: dict,
            eos_id: Optional[int]) -> CompiledGrammar:
        kind, source = canonical_source(response_format)
        key = (kind, source, eos_id)
        grammar = self._entries.get(key)
        if grammar is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return grammar
        self.misses += 1
        pattern = source if kind == "regex" else schema_to_regex(
            json.loads(source))
        grammar = CompiledGrammar(pattern, self.token_table, eos_id,
                                  source_key=f"{kind}:{source}")
        self._entries[key] = grammar
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return grammar

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}
