"""JSGF grammar compiler: JSGF text -> FsgModel.

Port of `pocketsphinx_tpu.lm.jsgf`: host code, copied.

Small recursive-descent re-implementation of the reference's flex/bison
JSGF frontend (src/lm/jsgf.c, jsgf_parser.y, _jsgf_scanner.l) — the
SURVEY.md §2 "rewrite small" plan.  Supports the constructs the
reference exercises in its grammars and tests: grammar header, public
rules, rule references <name> (with fully-qualified names collapsed to
their last component), sequences, alternations with /weight/ prefixes,
grouping (), optionals [], Kleene * and +, and {tags} (ignored).

FSG construction mirrors expand_rule/jsgf_build_fsg (src/lm/jsgf.c:
378-560): each RHS expands into a subgraph linked with null transitions;
alternation weights become transition probabilities (uniform when
unweighted); Kleene closures loop with a null transition back.
"""

from __future__ import annotations

import re

from .fsg import FsgModel


class JsgfError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<weight>/[0-9.eE+-]+/)
  | (?P<tag>\{[^}]*\})
  | (?P<ruleref><[^>]+>)
  | (?P<punct>[=;|()\[\]*+])
  | (?P<word>[^\s=;|()\[\]*+{}/<>]+)
""", re.VERBOSE | re.DOTALL)


def _tokenize(text: str):
    toks = []
    for m in _TOKEN_RE.finditer(text):
        kind = m.lastgroup
        if kind in ("comment", "tag"):
            continue
        toks.append((kind, m.group(0)))
    return toks


class _Node:
    """Expression AST: seq / alt / kleene / opt / ref / word."""

    def __init__(self, kind, children=None, value=None, weight=None):
        self.kind = kind
        self.children = children or []
        self.value = value
        self.weight = weight


class Jsgf:
    def __init__(self, text: str):
        self.rules: dict[str, _Node] = {}
        self.public: list[str] = []
        self.name = ""
        self._parse(text)

    @classmethod
    def parse_file(cls, path: str) -> "Jsgf":
        return cls(open(path, encoding="utf-8", errors="replace").read())

    # -- parsing -------------------------------------------------------------

    def _parse(self, text: str):
        # header
        m = re.match(r"\s*#JSGF[^;]*;", text)
        if not m:
            raise JsgfError("missing #JSGF header")
        toks = _tokenize(text[m.end():])
        i = 0

        def expect(kind=None, val=None):
            nonlocal i
            if i >= len(toks):
                raise JsgfError("unexpected end of grammar")
            k, v = toks[i]
            if kind and k != kind or val and v != val:
                raise JsgfError(f"expected {val or kind}, got {v!r}")
            i += 1
            return v

        while i < len(toks):
            k, v = toks[i]
            if k == "word" and v == "grammar":
                i += 1
                self.name = expect("word")
                expect(val=";")
            elif k == "word" and v == "import":
                # skip "import <...> ;"
                i += 1
                while i < len(toks) and toks[i][1] != ";":
                    i += 1
                i += 1
            elif k == "word" and v == "public":
                i += 1
                name = self._rulename(expect("ruleref"))
                expect(val="=")
                node, i = self._parse_alt(toks, i)
                expect(val=";")
                self.rules[name] = node
                self.public.append(name)
            elif k == "ruleref":
                name = self._rulename(v)
                i += 1
                expect(val="=")
                node, i = self._parse_alt(toks, i)
                expect(val=";")
                self.rules[name] = node
            else:
                raise JsgfError(f"unexpected token {v!r}")

    @staticmethod
    def _rulename(tok: str) -> str:
        # <com.example.rule> -> rule
        return tok[1:-1].split(".")[-1]

    def _parse_alt(self, toks, i):
        branches = []
        while True:
            node, i, w = self._parse_seq(toks, i)
            node.weight = w
            branches.append(node)
            if i < len(toks) and toks[i][1] == "|":
                i += 1
                continue
            break
        if len(branches) == 1 and branches[0].weight is None:
            return branches[0], i
        return _Node("alt", branches), i

    def _parse_seq(self, toks, i):
        weight = None
        if i < len(toks) and toks[i][0] == "weight":
            weight = float(toks[i][1].strip("/"))
            i += 1
        items = []
        while i < len(toks):
            k, v = toks[i]
            if v in (";", "|", ")", "]"):
                break
            if k == "word":
                node = _Node("word", value=v)
                i += 1
            elif k == "ruleref":
                node = _Node("ref", value=self._rulename(v))
                i += 1
            elif v == "(":
                node, i = self._parse_alt(toks, i + 1)
                if i >= len(toks) or toks[i][1] != ")":
                    raise JsgfError("missing )")
                i += 1
            elif v == "[":
                inner, i = self._parse_alt(toks, i + 1)
                if i >= len(toks) or toks[i][1] != "]":
                    raise JsgfError("missing ]")
                i += 1
                node = _Node("opt", [inner])
            elif k == "weight":
                raise JsgfError("weight not at alternative start")
            else:
                raise JsgfError(f"unexpected {v!r}")
            # postfix closures
            while i < len(toks) and toks[i][1] in ("*", "+"):
                node = _Node("star" if toks[i][1] == "*" else "plus", [node])
                i += 1
            items.append(node)
        if not items:
            node = _Node("seq", [])  # empty sequence (epsilon)
        elif len(items) == 1:
            node = items[0]
        else:
            node = _Node("seq", items)
        return node, i, weight

    # -- FSG construction ----------------------------------------------------

    def build_fsg(self, rule: str | None = None, lw: float = 1.0) -> FsgModel:
        if rule is None:
            if not self.public:
                raise JsgfError("no public rules")
            rule = self.public[0]
        if rule not in self.rules:
            raise JsgfError(f"no rule <{rule}>")
        fsg = FsgModel(name=rule, n_state=0, start_state=0, final_state=0,
                       lw=lw)
        counter = [0]

        def new_state():
            counter[0] += 1
            return counter[0] - 1

        def emit(node: _Node, src: int, dst: int, prob: float,
                 stack: tuple):
            """Wire `node` between states src..dst with entry prob."""
            lp = fsg.add_log_prob(prob) if prob < 1.0 else 0.0
            if node.kind == "word":
                fsg.trans_add(src, dst, lp, fsg.word_add(node.value))
            elif node.kind == "ref":
                name = node.value
                if name in stack:
                    raise JsgfError(f"recursive rule <{name}>")
                if name not in self.rules:
                    raise JsgfError(f"undefined rule <{name}>")
                if prob < 1.0:
                    mid = new_state()
                    fsg.null_trans_add(src, mid, lp)
                    src = mid
                emit(self.rules[name], src, dst, 1.0, stack + (name,))
            elif node.kind == "seq":
                if not node.children:
                    fsg.null_trans_add(src, dst, lp)
                    return
                cur = src
                for j, ch in enumerate(node.children):
                    nxt = dst if j == len(node.children) - 1 else new_state()
                    emit(ch, cur, nxt, prob if j == 0 else 1.0, stack)
                    cur = nxt
            elif node.kind == "alt":
                n = len(node.children)
                weights = [ch.weight for ch in node.children]
                if any(w is not None for w in weights):
                    total = sum(w or 0.0 for w in weights)
                    probs = [(w or 0.0) / total if total > 0 else 1.0 / n
                             for w in weights]
                else:
                    probs = [1.0 / n] * n
                for ch, p in zip(node.children, probs):
                    emit(ch, src, dst, prob * p, stack)
            elif node.kind == "opt":
                emit(node.children[0], src, dst, prob * 0.5, stack)
                fsg.null_trans_add(src, dst,
                                   fsg.add_log_prob(prob * 0.5))
            elif node.kind == "star":
                loop = new_state()
                fsg.null_trans_add(src, loop, lp)
                fsg.null_trans_add(loop, dst, 0.0)
                emit(node.children[0], loop, loop, 1.0, stack)
            elif node.kind == "plus":
                loop = new_state()
                emit(node.children[0], src, loop, prob, stack)
                fsg.null_trans_add(loop, dst, 0.0)
                emit(node.children[0], loop, loop, 1.0, stack)
            else:
                raise JsgfError(f"bad node {node.kind}")

        start = new_state()
        final = new_state()
        emit(self.rules[rule], start, final, 1.0, (rule,))
        fsg.n_state = counter[0]
        fsg.start_state = start
        fsg.final_state = final
        return fsg
