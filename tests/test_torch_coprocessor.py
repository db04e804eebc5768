"""The coprocessor of the port against the JAX package's: typed
memcomparable values and rows (common/serial.py), the expression VM
(coprocessor/expr.py) and CoprocessorV2's filter, projection and grouped
aggregation (coprocessor/coprocessor_v2.py).

Seeded inputs go through both packages and the outputs must be equal:
the same bytes, the same values (None for SQL unknown) and the same
exception types. Then the cases of test_coprocessor_v2.py, the Expr cases
of test_snapshot_transfer_expr.py and test_common.py's serial and tracker
cases run through the port: each is the JAX package's test function with
its imports from ``dingo_tpu`` taken from ``dingo_tpu_torch``.
"""

import ast
import importlib
import math
import os
import random
import re
import struct
import types

import pytest

PKGS = ("dingo_tpu", "dingo_tpu_torch")
TESTS = os.path.dirname(os.path.abspath(__file__))


def _ported(module, names):
    """The port's name for `module` when it has every one of `names`."""
    port = "dingo_tpu_torch" + module[len("dingo_tpu"):]
    try:
        m = importlib.import_module(port)
    except ImportError:
        return None
    for n in names:
        if not hasattr(m, n):
            try:
                importlib.import_module(f"{port}.{n}")
            except ImportError:
                return None
    return port


def port_cases(test_file):
    """`test_file` of this directory as a module whose imports from the
    JAX package come from the port wherever the port has the names; the
    rest (the gRPC surface) stay the JAX package's."""
    path = os.path.join(TESTS, test_file)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                re.match(r"dingo_tpu(\.|$)", node.module):
            port = _ported(node.module, [a.name for a in node.names])
            if port is not None:
                node.module = port
    mod = types.ModuleType(f"port_{test_file[:-3]}")
    mod.__file__ = path
    exec(compile(tree, path, "exec"), mod.__dict__)
    return mod


def port_on_cpu(monkeypatch):
    """Point every port module's ``resolve_device`` at one whose default
    is the CPU (the port's own default is CUDA, which raises here), for
    the JAX package's cases that build regions and engines without a
    device argument."""
    import pkgutil
    import sys

    import dingo_tpu_torch
    from dingo_tpu_torch.common import device

    for m in pkgutil.walk_packages(dingo_tpu_torch.__path__,
                                   prefix="dingo_tpu_torch."):
        importlib.import_module(m.name)
    orig = device.resolve_device

    def on_cpu(dev=None):
        return orig("cpu" if dev is None else dev)

    for name, m in list(sys.modules.items()):
        if name.startswith("dingo_tpu_torch") and \
                getattr(m, "resolve_device", None) is orig:
            monkeypatch.setattr(m, "resolve_device", on_cpu)


def mods(name):
    return types.SimpleNamespace(
        serial=importlib.import_module(f"{name}.common.serial"),
        expr=importlib.import_module(f"{name}.coprocessor.expr"),
        v2=importlib.import_module(f"{name}.coprocessor.coprocessor_v2"),
        agg=importlib.import_module(f"{name}.coprocessor.aggregation"),
    )


REF, PORT = mods("dingo_tpu"), mods("dingo_tpu_torch")


def outcome(fn):
    """fn()'s value, or the name of the exception type it raised."""
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__)


def same(a, b):
    """Equal outcomes; NaN equals NaN, and 0.0 and -0.0 differ."""
    if isinstance(a, float) and isinstance(b, float):
        return struct.pack(">d", a) == struct.pack(">d", b) or (
            math.isnan(a) and math.isnan(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


# ---------------- serial: typed memcomparable values ------------------------

def seeded_values(seed=11, n=400):
    rng = random.Random(seed)
    fixed = [None, False, True, 0, -1, 1, (1 << 63) - 1, -(1 << 63),
             1 << 62, -(1 << 62), 0.0, -0.0, math.inf, -math.inf,
             5e-324, -5e-324, 2.2250738585072014e-308 / 3, 1e308, -1e-300,
             "", "a", "ab\x00", "ab\x00\x00", "été", "\U0001f600",
             "x" * 8, "x" * 9, "x" * 16, b"", b"\xff\x00", "abc", "abd"]
    out = list(fixed)
    for _ in range(n):
        kind = rng.randrange(5)
        if kind == 0:
            out.append(rng.randrange(-(1 << 63), 1 << 63))
        elif kind == 1:
            out.append(struct.unpack(">d", struct.pack(
                ">Q", rng.getrandbits(64)))[0])
        elif kind == 2:
            out.append("".join(chr(rng.choice(
                [rng.randrange(32, 127), rng.randrange(0x80, 0x800),
                 rng.randrange(0x4e00, 0x9fff), 0]))
                for _ in range(rng.randrange(0, 20))))
        elif kind == 3:
            out.append(rng.random() < 0.5)
        else:
            out.append(None)
    return out


def test_serial_values_equal_bytes_round_trip_and_order():
    values = seeded_values()
    for v in values:
        a, b = REF.serial.encode_value(v), PORT.serial.encode_value(v)
        assert a == b, v
        va, oa = REF.serial.decode_value(a)
        vb, ob = PORT.serial.decode_value(b)
        assert oa == ob == len(a) and same(va, vb), (v, va, vb)
        if isinstance(v, float) and not math.isnan(v):
            assert same(vb, v)
    # the same sort order: the encoded bytes of each package
    want = sorted(range(len(values)),
                  key=lambda i: REF.serial.encode_value(values[i]))
    got = sorted(range(len(values)),
                 key=lambda i: PORT.serial.encode_value(values[i]))
    assert [PORT.serial.encode_value(values[i]) for i in got] == \
        [REF.serial.encode_value(values[i]) for i in want]
    # and within one type the bytes order as the values do
    ints = sorted({v for v in values if type(v) is int})
    assert sorted(ints, key=PORT.serial.encode_value) == ints
    floats = [v for v in values if type(v) is float and not math.isnan(v)]
    assert [v for v in sorted(floats, key=PORT.serial.encode_value)] == \
        sorted(floats, key=lambda v: (v, math.copysign(1, v)))
    with pytest.raises(TypeError):
        PORT.serial.encode_value([1])
    with pytest.raises(TypeError):
        REF.serial.encode_value([1])


def test_serial_row_keys_equal_bytes_and_tuple_order():
    rng = random.Random(5)
    values = seeded_values(seed=5, n=200)
    rows = [tuple(rng.choice(values) for _ in range(rng.randrange(1, 5)))
            for _ in range(300)]
    for r in rows:
        a, b = REF.serial.encode_row_key(r), PORT.serial.encode_row_key(r)
        assert a == b
        assert same(REF.serial.decode_row_key(a),
                    PORT.serial.decode_row_key(b))
    ints = [(rng.randrange(-5, 5), rng.randrange(-5, 5)) for _ in range(100)]
    assert sorted(ints, key=PORT.serial.encode_row_key) == sorted(ints)
    for bad in (b"\x09", b"\x03\x00"):
        assert outcome(lambda: REF.serial.decode_row_key(bad)) == \
            outcome(lambda: PORT.serial.decode_row_key(bad))


# ---------------- the expression VM ----------------------------------------

FIELDS = ("a", "b", "c", "s", "t", "n", "x")
BINOPS = ("eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul", "div",
          "mod", "pow", "in", "concat")
UNOPS = ("neg", "abs", "floor", "ceil", "sqrt", "exp", "ln", "lower",
         "upper", "length")
CASTS = ("BIGINT", "DOUBLE", "VARCHAR", "BOOL")


def gen_expr(rng, depth):
    """A random wire tree over every operator family."""
    if depth == 0 or rng.random() < 0.2:
        if rng.random() < 0.5:
            return ["field", rng.choice(FIELDS)]
        return ["const", rng.choice(
            [None, 0, 1, -3, 2, 7, 0.5, -2.5, 1e6, "ab", "AB", "true", "0",
             "x9", True, False, [1, 2, "ab"], 10 ** 30])]
    k = rng.randrange(9)
    sub = lambda: gen_expr(rng, depth - 1)  # noqa: E731
    if k == 0:
        return [rng.choice(BINOPS), sub(), sub()]
    if k == 1:
        return [rng.choice(UNOPS), sub()]
    if k == 2:
        return [rng.choice(("and", "or"))] + [sub() for _ in range(
            rng.randrange(2, 4))]
    if k == 3:
        return ["not", sub()]
    if k == 4:
        return ["is_null", sub()]
    if k == 5:
        return ["if", sub(), sub(), sub()]
    if k == 6:
        return ["cast", rng.choice(CASTS), sub()]
    if k == 7:
        return ["substr", sub(), sub(), sub()]
    return [rng.choice(("lt", "ge", "eq")), ["field", rng.choice(FIELDS)],
            ["const", rng.choice([0, 1, 2.5, "ab"])]]


def gen_row(rng):
    pool = [None, 0, 1, -4, 3, 2.5, -0.0, 1e300, "ab", "Ab", "", "12",
            True, False, b"\xc3\xa9", b"\xff"]
    return {f: rng.choice(pool) for f in FIELDS if rng.random() < 0.9}


def test_expr_seeded_trees_equal_outcomes():
    rng = random.Random(17)
    rows = [gen_row(rng) for _ in range(24)]
    n_unknown = n_value = 0
    for _ in range(600):
        tree = gen_expr(rng, rng.randrange(1, 5))
        ca = outcome(lambda: REF.expr.Expr(tree))
        cb = outcome(lambda: PORT.expr.Expr(tree))
        assert ca[0] == cb[0] and (ca[0] == "value" or ca == cb), tree
        if ca[0] == "raised":
            continue
        ea, eb = ca[1], cb[1]
        for row in rows:
            ra, rb = outcome(lambda: ea.eval(row)), outcome(
                lambda: eb.eval(row))
            assert ra[0] == rb[0] and same(ra[1], rb[1]), (tree, row, ra, rb)
            assert ea.matches(row) == eb.matches(row)
            assert same(ea.eval_or_null(row), eb.eval_or_null(row))
            if ra[0] == "raised":
                n_unknown += 1
            else:
                n_value += 1
    # the script reaches both outcomes often
    assert n_unknown > 1000 and n_value > 1000, (n_unknown, n_value)


@pytest.mark.parametrize("tree", [
    ["bogus_op", ["const", 1]], ["eq", ["const", 1]], [], "eq",
    ["const"], ["field", 3], ["not"], ["and", ["const", 1]],
    ["cast", "INT", ["const", 1]], ["if", ["const", 1], ["const", 2]],
    ["substr", ["const", "a"], ["const", 0]], ["abs"],
    ["eq", ["const", 1], ["const", 2], ["const", 3]],
])
def test_expr_validation_errors_equal(tree):
    assert outcome(lambda: REF.expr.Expr(tree)) == \
        outcome(lambda: PORT.expr.Expr(tree)) == ("raised", "ExprError")


def test_expr_filter_adapter():
    tree = ["and", ["ge", ["field", "age"], ["const", 21]],
            ["in", ["field", "color"], ["const", ["red", "blue"]]]]
    fa, fb = REF.expr.ExprFilter(tree), PORT.expr.ExprFilter(tree)
    for row in ({"age": 30, "color": "red"}, {"age": 18, "color": "red"},
                {"color": "red"}, {"age": "x", "color": "blue"}):
        assert fa.matches(row) == fb.matches(row)
    assert fa.is_empty() is fb.is_empty() is False


# ---------------- CoprocessorV2 ---------------------------------------------

def schema(m):
    C = m.v2.SchemaColumn
    return [C("id", "BIGINT", 0), C("dept", "VARCHAR", 1),
            C("salary", "DOUBLE", 2), C("active", "BOOL", 3),
            C("note", "VARCHAR", 4)]


def table_rows(seed=3, n=300):
    rng = random.Random(seed)
    depts = ["eng", "ops", "hr", None]
    rows = []
    for i in range(n):
        rows.append([i, rng.choice(depts),
                     None if rng.random() < 0.1 else
                     round(rng.uniform(10, 200), 3),
                     None if rng.random() < 0.05 else rng.random() < 0.6,
                     rng.choice(["", "x", "ab", None, "é"])])
    return rows


def kvs(m, rows):
    return [(m.serial.encode_row_key([r[0]]), m.v2.encode_row(r))
            for r in rows]


def definitions(m):
    A, O, D = m.v2.AggregationSpec, m.v2.AggOpV2, m.v2.CoprocessorDef
    sch = schema(m)
    sal_ge = ["ge", ["field", "salary"], ["const", 80.0]]
    return {
        "all": D(original_schema=sch),
        "filter": D(original_schema=sch, filter_expr=[
            "and", ["eq", ["field", "active"], ["const", True]], sal_ge]),
        "project": D(original_schema=sch, selection=[1, 2],
                     filter_expr=["or", sal_ge,
                                  ["is_null", ["field", "dept"]]]),
        "computed": D(original_schema=sch, selection=[
            0, ["mul", ["field", "salary"], ["const", 2.0]],
            ["upper", ["field", "dept"]],
            ["concat", ["field", "dept"], ["field", "note"]],
            ["if", ["field", "active"], ["const", 1], ["const", 0]]]),
        "group": D(original_schema=sch, group_by=[1, 3],
                   filter_expr=["ne", ["field", "note"], ["const", "x"]],
                   aggregations=[A(op, 2) for op in O]
                   + [A(O.COUNT, -1),
                      A(O.SUM, expr=["mul", ["field", "salary"],
                                     ["const", 0.5]]),
                      A(O.MAX, expr=["length", ["field", "note"]])]),
        "global": D(original_schema=sch,
                    aggregations=[A(O.SUM0, 2), A(O.MIN, 2), A(O.MAX, 0),
                                  A(O.COUNT_WITH_NULL, 4)]),
        "empty_group": D(original_schema=sch, filter_expr=[
            "eq", ["field", "dept"], ["const", "nope"]],
            aggregations=[A(O.SUM0, 2)]),
        "overflow": D(original_schema=sch, selection=[
            ["mul", ["field", "id"], ["const", 1 << 62]]]),
        "unencodable": D(original_schema=sch, selection=[
            ["const", [1, 2]]]),
    }


@pytest.mark.parametrize("name", ["all", "filter", "project", "computed",
                                  "group", "global", "empty_group",
                                  "overflow", "unencodable"])
@pytest.mark.parametrize("limit", [0, 7])
def test_execute_equal_bytes(name, limit):
    rows = table_rows()
    got = {}
    for tag, m in (("ref", REF), ("port", PORT)):
        cop = m.v2.CoprocessorV2(definitions(m)[name])
        got[tag] = outcome(lambda: cop.execute(kvs(m, rows), limit=limit))
    assert got["ref"] == got["port"], name
    if name in ("overflow", "unencodable"):
        assert got["port"] == ("raised", "CoprocessorError")
    elif name != "empty_group":
        assert got["port"][1], name


def test_row_at_a_time_contract_equal():
    rows = table_rows(seed=9, n=120)
    ref = REF.v2.CoprocessorV2(definitions(REF)["filter"])
    port = PORT.v2.CoprocessorV2(definitions(PORT)["filter"])
    for r in rows:
        blob = PORT.v2.encode_row(r)
        assert blob == REF.v2.encode_row(r)
        da, db = ref.decode(blob), port.decode(blob)
        assert same(da, db)
        assert ref.filter_row(da) == port.filter_row(db)
        assert same(ref.project(da), port.project(db))
        assert same(REF.v2.decode_row(blob, 5), PORT.v2.decode_row(blob, 5))


@pytest.mark.parametrize("bad", [
    {"selection": [9]}, {"selection": [-1]}, {"selection": ["x"]},
    {"group_by": [5]}, {"aggregations": "sum7"},
    {"aggregations": "sum-2"}, {"filter_expr": ["nope"]},
    {"selection": [["bogus"]]},
])
def test_bad_definitions_equal_errors(bad):
    got = []
    for m in (REF, PORT):
        kw = dict(bad)
        if kw.get("aggregations") == "sum7":
            kw["aggregations"] = [m.v2.AggregationSpec(m.v2.AggOpV2.SUM, 7)]
        elif kw.get("aggregations") == "sum-2":
            kw["aggregations"] = [m.v2.AggregationSpec(m.v2.AggOpV2.SUM, -2)]
        got.append(outcome(lambda: m.v2.CoprocessorV2(
            m.v2.CoprocessorDef(original_schema=schema(m), **kw))))
    assert got[0][0] == got[1][0] == "raised" and got[0] == got[1], got


def test_aggregator_equal():
    rows = [dict(zip(("id", "dept", "salary", "active", "note"), r))
            for r in table_rows(seed=4, n=80)]
    specs = lambda m: [(f, op) for f in ("salary", "id", "note")  # noqa: E731
                       for op in m.agg.AggOp if not (
                           f == "note" and op is m.agg.AggOp.SUM)]
    assert REF.agg.Aggregator(specs(REF)).run(rows) == \
        PORT.agg.Aggregator(specs(PORT)).run(rows)


# ---------------- the JAX package's cases through the port ------------------

COP_V2 = port_cases("test_coprocessor_v2.py")
EXPR = port_cases("test_snapshot_transfer_expr.py")
COMMON = port_cases("test_common.py")

#: the cases that run in process (the rest drive the gRPC surface)
COP_V2_CASES = [n for n in dir(COP_V2) if n.startswith("test_") and n not in (
    "test_scan_with_coprocessor_over_grpc", "test_projection_over_wire_proto")]


def test_coprocessor_case_list():
    assert len(COP_V2_CASES) == 18, COP_V2_CASES


@pytest.mark.parametrize("case", COP_V2_CASES)
def test_coprocessor_v2_cases_through_the_port(case):
    getattr(COP_V2, case)()


@pytest.mark.parametrize("case", ["test_expr_eval_basics",
                                  "test_expr_arithmetic_and_not",
                                  "test_expr_validation"])
def test_expr_cases_through_the_port(case):
    getattr(EXPR, case)()


@pytest.mark.parametrize("case", ["test_tracker_spans",
                                  "test_serial_roundtrip_and_ordering"])
def test_common_cases_through_the_port(case):
    getattr(COMMON, case)()


def test_tracker_equal_report_keys():
    """Both trackers report the same stages; spans add up and an unopened
    stage's end is ignored."""
    got = []
    for name in PKGS:
        Tracker = importlib.import_module(f"{name}.common.tracker").Tracker
        t = Tracker()
        t.end("never_opened")
        for _ in range(2):
            with t.span("queue"):
                pass
        t.begin("raft")
        t.end("raft")
        t.mark("acked")
        rep = t.report()
        assert rep["total_us"] >= rep["queue"] >= 0
        assert t._marks["acked"] >= 0
        got.append(sorted(rep))
    assert got[0] == got[1] == ["queue", "raft", "total_us"]
