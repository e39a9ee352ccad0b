"""CEL-subset evaluator for CRD validation rules.

Reference: staging/src/k8s.io/apiextensions-apiserver/pkg/apiserver/
schema/cel/ — x-kubernetes-validations carries CEL expressions over
`self` (and `oldSelf` on update) that must hold for a write to be
admitted.

The reference links google/cel-go; nothing equivalent is available
here, so this is an independent interpreter for the subset of CEL that
CRD rules in the wild overwhelmingly use:

  literals        int/float/string ('x' or "x")/bool/null, lists [a,b]
  identifiers     self, oldSelf, bound loop vars
  selection       a.b.c (absent field -> error, like CEL)
  indexing        a[i], map[key]
  operators       == != < <= > >= + - * / % ! && || ? : in
  macros          has(a.b), size(x), all/exists/exists_one(x, v, expr)
  functions       x.startsWith(s) .endsWith(s) .contains(s) .matches(re)
                  string(x) int(x) double(x)

Evaluation is total and sandboxed: no attribute access on Python
objects (only dict/list traversal), no callables beyond the table
above, recursion and iteration bounded by the object's size.  Parse or
eval failure raises CELError — the apiserver maps it to a 422 exactly
like a failing rule, which is CEL's own posture (errors are failures,
not passes).
"""

from __future__ import annotations

import re

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<float>\d+\.\d+)
    | (?P<int>\d+)
    | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>&&|\|\||[=!<>]=|[-+*/%().,\[\]<>!?:])
    )""", re.VERBOSE)

_KEYWORDS = {"true": True, "false": False, "null": None}


class CELError(Exception):
    pass


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise CELError(f"bad token at {rest[:20]!r}")
        pos = m.end()
        for kind in ("float", "int", "string", "ident", "op"):
            val = m.group(kind)
            if val is not None:
                out.append((kind, val))
                break
    out.append(("end", ""))
    return out


class _Parser:
    """Precedence-climbing parser producing a nested-tuple AST."""

    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, op: str):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise CELError(f"expected {op!r}, got {val!r}")

    def parse(self):
        node = self.ternary()
        if self.peek()[0] != "end":
            raise CELError(f"trailing input at {self.peek()[1]!r}")
        return node

    def ternary(self):
        cond = self.or_()
        if self.peek() == ("op", "?"):
            self.next()
            then = self.ternary()
            self.expect(":")
            other = self.ternary()
            return ("?:", cond, then, other)
        return cond

    def or_(self):
        node = self.and_()
        while self.peek() == ("op", "||"):
            self.next()
            node = ("||", node, self.and_())
        return node

    def and_(self):
        node = self.cmp()
        while self.peek() == ("op", "&&"):
            self.next()
            node = ("&&", node, self.cmp())
        return node

    def cmp(self):
        node = self.add()
        kind, val = self.peek()
        if (kind, val) in (("op", "=="), ("op", "!="), ("op", "<"),
                           ("op", "<="), ("op", ">"), ("op", ">=")) \
                or (kind, val) == ("ident", "in"):
            self.next()
            return (val, node, self.add())
        return node

    def add(self):
        node = self.mul()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.next()[1]
            node = (op, node, self.mul())
        return node

    def mul(self):
        node = self.unary()
        while self.peek() in (("op", "*"), ("op", "/"), ("op", "%")):
            op = self.next()[1]
            node = (op, node, self.unary())
        return node

    def unary(self):
        if self.peek() == ("op", "!"):
            self.next()
            return ("!", self.unary())
        if self.peek() == ("op", "-"):
            self.next()
            return ("neg", self.unary())
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            kind, val = self.peek()
            if (kind, val) == ("op", "."):
                self.next()
                name_kind, name = self.next()
                if name_kind != "ident":
                    raise CELError(f"expected field name, got {name!r}")
                if self.peek() == ("op", "("):
                    node = ("call", name, node, self._args())
                else:
                    node = ("sel", node, name)
            elif (kind, val) == ("op", "["):
                self.next()
                idx = self.ternary()
                self.expect("]")
                node = ("idx", node, idx)
            else:
                return node

    def _args(self):
        self.expect("(")
        args = []
        if self.peek() != ("op", ")"):
            args.append(self.ternary())
            while self.peek() == ("op", ","):
                self.next()
                args.append(self.ternary())
        self.expect(")")
        return args

    def primary(self):
        kind, val = self.next()
        if kind == "int":
            return ("lit", int(val))
        if kind == "float":
            return ("lit", float(val))
        if kind == "string":
            body = val[1:-1]
            return ("lit", re.sub(r"\\(.)", r"\1", body))
        if kind == "ident":
            if val in _KEYWORDS:
                return ("lit", _KEYWORDS[val])
            if self.peek() == ("op", "("):
                return ("fn", val, self._args())
            return ("var", val)
        if (kind, val) == ("op", "("):
            node = self.ternary()
            self.expect(")")
            return node
        if (kind, val) == ("op", "["):
            items = []
            if self.peek() != ("op", "]"):
                items.append(self.ternary())
                while self.peek() == ("op", ","):
                    self.next()
                    items.append(self.ternary())
            self.expect("]")
            return ("list", items)
        raise CELError(f"unexpected {val!r}")


_MACROS = {"all", "exists", "exists_one", "map", "filter"}


def _eval(node, env: dict):
    op = node[0]
    if op == "lit":
        return node[1]
    if op == "var":
        if node[1] not in env:
            raise CELError(f"unknown identifier {node[1]!r}")
        return env[node[1]]
    if op == "list":
        return [_eval(n, env) for n in node[1]]
    if op == "sel":
        base = _eval(node[1], env)
        if isinstance(base, dict):
            if node[2] not in base:
                raise CELError(f"no such field {node[2]!r}")
            return base[node[2]]
        raise CELError(f"cannot select {node[2]!r} from {type(base).__name__}")
    if op == "idx":
        base = _eval(node[1], env)
        idx = _eval(node[2], env)
        try:
            if isinstance(base, list) and isinstance(idx, int):
                return base[idx]
            if isinstance(base, dict):
                return base[idx]
        except (KeyError, IndexError):
            raise CELError(f"index {idx!r} out of range") from None
        raise CELError("bad indexing")
    if op == "!":
        return not _truthy(_eval(node[1], env))
    if op == "neg":
        val = _eval(node[1], env)
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            raise CELError("negation of non-number")
        return -val
    if op == "&&":
        return _truthy(_eval(node[1], env)) and _truthy(_eval(node[2], env))
    if op == "||":
        return _truthy(_eval(node[1], env)) or _truthy(_eval(node[2], env))
    if op == "?:":
        return (_eval(node[2], env) if _truthy(_eval(node[1], env))
                else _eval(node[3], env))
    if op in ("==", "!=", "<", "<=", ">", ">=", "+", "-", "*", "/", "%",
              "in"):
        left, right = _eval(node[1], env), _eval(node[2], env)
        return _binop(op, left, right)
    if op == "fn":
        if node[1] == "has":  # macro: args must stay unevaluated
            return _fn("has", [], node[2], env)
        return _fn(node[1], [_eval(a, env) for a in node[2]], node[2], env)
    if op == "call":
        return _method(node[1], node[2], node[3], env)
    raise CELError(f"bad node {op!r}")


def _truthy(val) -> bool:
    if not isinstance(val, bool):
        raise CELError("non-boolean in boolean context")
    return val


def _binop(op, left, right):
    try:
        if op == "==":
            return left == right
        if op == "!=":
            return left != right
        if op == "in":
            if isinstance(right, (list, str)):
                return left in right
            if isinstance(right, dict):
                return left in right
            raise CELError("'in' needs list/map/string")
        if op == "+" and isinstance(left, str) and isinstance(right, str):
            return left + right
        if op == "+" and isinstance(left, list) and isinstance(right, list):
            return left + right
        if isinstance(left, bool) or isinstance(right, bool):
            raise CELError(f"bad operands for {op}")
        if isinstance(left, (int, float)) and isinstance(right, (int, float)):
            if op == "<":
                return left < right
            if op == "<=":
                return left <= right
            if op == ">":
                return left > right
            if op == ">=":
                return left >= right
            if op == "+":
                return left + right
            if op == "-":
                return left - right
            if op == "*":
                return left * right
            if op == "/":
                if right == 0:
                    raise CELError("division by zero")
                if isinstance(left, int) and isinstance(right, int):
                    # CEL truncates toward zero (C semantics), not
                    # Python's floor: -7/2 is -3, not -4
                    quotient = abs(left) // abs(right)
                    return quotient if (left < 0) == (right < 0) \
                        else -quotient
                return left / right
            if op == "%":
                if right == 0:
                    raise CELError("modulo by zero")
                if isinstance(left, int) and isinstance(right, int):
                    # remainder keeps the dividend's sign: -7%2 is -1
                    remainder = abs(left) % abs(right)
                    return remainder if left >= 0 else -remainder
                return left % right
        if isinstance(left, str) and isinstance(right, str) \
                and op in ("<", "<=", ">", ">="):
            return {"<": left < right, "<=": left <= right,
                    ">": left > right, ">=": left >= right}[op]
    except TypeError:
        pass
    raise CELError(f"bad operands for {op}: "
                   f"{type(left).__name__}, {type(right).__name__}")


def _fn(name, args, raw_args, env):
    if name == "size" and len(args) == 1:
        if isinstance(args[0], (str, list, dict)):
            return len(args[0])
        raise CELError("size() of non-sized value")
    if name == "has" and len(raw_args) == 1:
        # macro: has(a.b) is true iff selecting b off a succeeds
        node = raw_args[0]
        if node[0] != "sel":
            raise CELError("has() needs a field selection")
        try:
            _eval(node, env)
            return True
        except CELError:
            return False
    if name == "string" and len(args) == 1:
        if isinstance(args[0], bool):
            return "true" if args[0] else "false"
        return str(args[0])
    if name == "int" and len(args) == 1:
        try:
            return int(args[0])
        except (TypeError, ValueError):
            raise CELError("int() conversion failed") from None
    if name == "double" and len(args) == 1:
        try:
            return float(args[0])
        except (TypeError, ValueError):
            raise CELError("double() conversion failed") from None
    raise CELError(f"unknown function {name}()")


def _method(name, recv_node, arg_nodes, env):
    if name in _MACROS:
        # comprehension macros: recv.all(v, expr) etc.
        recv = _eval(recv_node, env)
        if not isinstance(recv, (list, dict)):
            raise CELError(f"{name}() needs a list/map")
        items = list(recv)  # maps iterate their KEYS, like CEL
        if len(arg_nodes) != 2 or arg_nodes[0][0] != "var":
            raise CELError(f"{name}(var, expr) expected")
        var = arg_nodes[0][1]
        body = arg_nodes[1]
        results = []
        for item in items:
            results.append(_eval(body, {**env, var: item}))
        if name == "all":
            return all(_truthy(r) for r in results)
        if name == "exists":
            return any(_truthy(r) for r in results)
        if name == "exists_one":
            return sum(1 for r in results if _truthy(r)) == 1
        if name == "filter":
            return [i for i, r in zip(items, results) if _truthy(r)]
        if name == "map":
            return results
    recv = _eval(recv_node, env)
    args = [_eval(a, env) for a in arg_nodes]
    if isinstance(recv, str) and len(args) == 1 \
            and isinstance(args[0], str):
        if name == "startsWith":
            return recv.startswith(args[0])
        if name == "endsWith":
            return recv.endswith(args[0])
        if name == "contains":
            return args[0] in recv
        if name == "matches":
            try:
                return re.search(args[0], recv) is not None
            except re.error as e:
                raise CELError(f"bad regex: {e}") from None
    raise CELError(f"unknown method {name}()")


# process-local: compiled-expression memo keyed by rule text; each
# apiserver/child process rebuilds its own copy on first evaluate()
_CACHE: dict[str, tuple] = {}


def evaluate(rule: str, self_obj, old_self=None) -> bool:
    """True iff `rule` holds for self (and oldSelf when given)."""
    ast = _CACHE.get(rule)
    if ast is None:
        ast = _Parser(_tokenize(rule)).parse()
        if len(_CACHE) > 1024:
            _CACHE.clear()
        _CACHE[rule] = ast
    env = {"self": self_obj}
    if old_self is not None:
        env["oldSelf"] = old_self
    result = _eval(ast, env)
    if not isinstance(result, bool):
        raise CELError("rule did not evaluate to a boolean")
    return result
