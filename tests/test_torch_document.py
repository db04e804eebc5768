"""Documents of the port against the JAX package's: the BM25 DocumentIndex
with typed columns (document/index.py), the query parser
(document/query.py), DOCUMENT regions (store/region.py), the document
apply handlers (engine/apply.py) and the node's rebuild_document_index.

Seeded typed documents go through both packages' DocumentIndex: the ids
and BM25 scores of every search are exactly equal (the same float
operations in the same order), as are range_select, parse_query's output
and the SchemaError / QueryParseError raised on bad input; an index saved
by one package loads in the other. Then a DOCUMENT region on 3-replica
raft clusters of each package takes the same adds and deletes and answers
the same searches on every replica, after a restart (recover rebuilds the
index from the engine) and after a split. test_document_typed.py's
in-process cases run through the port.
"""

import dataclasses
import importlib
import random
import time
import types

import pytest
import torch

from test_torch_coprocessor import port_cases, port_on_cpu

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
SIDS = ["s0", "s1", "s2"]
#: raft timing that rides out a loaded host (the tier-1 run's workers):
#: elections not before 1 s of silence, proposals wait up to 30 s
RAFT_KW = {"election_timeout": (1.0, 2.0), "heartbeat_interval": 0.1}
PROPOSE_TIMEOUT_S = 30.0
SCHEMA = {"title": "text", "body": "text", "price": "i64", "rating": "f64",
          "sku": "bytes", "in_stock": "bool"}
WORDS = ("red blue green shoes hat coat warm running walking winter "
         "waterproof stylish comfortable hiking light heavy raft tpu vector "
         "search engine storage").split()


def pkg(name):
    p = types.SimpleNamespace(name=name, kw={"device": "cpu"} if name ==
                              "dingo_tpu_torch" else {})
    for attr, m in {"index": "document.index", "query": "document.query",
                    "regm": "store.region", "node": "store.node",
                    "raft": "raft", "wd": "engine.write_data",
                    "vcodec": "index.codec"}.items():
        setattr(p, attr, importlib.import_module(f"{name}.{m}"))
    return p


def docs(seed=21, n=400):
    rng = random.Random(seed)
    out = []
    for did in range(1, n + 1):
        out.append((did, {
            "title": " ".join(rng.choice(WORDS)
                              for _ in range(rng.randrange(1, 4))),
            "body": " ".join(rng.choice(WORDS)
                             for _ in range(rng.randrange(3, 15))),
            "price": rng.randrange(1, 500), "rating": round(
                rng.uniform(0, 5), 2),
            "sku": bytes([65 + rng.randrange(26), 48 + rng.randrange(10)]),
            "in_stock": rng.random() < 0.7}))
    return out


QUERIES = [("shoes", "or"), ("red shoes", "or"), ("red shoes", "and"),
           ("running shoes", "phrase"), ("warm winter", "and"),
           ("shoes price:[60 TO 200]", "query"),
           ("+hat -red rating:[4.0 TO 5.0]", "query"),
           ('"waterproof hiking" in_stock:true', "query"),
           ("title:shoes -in_stock:false", "query"),
           ("-price:[1 TO 400]", "query"), ("price:{100 TO 250}", "query"),
           ("sku:[A0 TO M9]", "query"), ("nothing matches this", "or"),
           ("", "or"), ("vector OR search", "query")]


def build(p, items, deletes=()):
    idx = p.index.DocumentIndex(1, text_fields=("title", "body"),
                                schema=SCHEMA)
    for did, doc in items:
        idx.add(did, doc)
    idx.delete(list(deletes))
    return idx


def results(idx):
    out = [idx.search(q, topk=25, mode=m) for q, m in QUERIES]
    out.append(idx.search("shoes", topk=25, column_filter={"in_stock": True}))
    for field, lo, hi, il, ih in (("price", 50, 150, True, True),
                                  ("price", 50, 150, False, False),
                                  ("rating", None, 2.5, True, True),
                                  ("sku", b"C", None, True, True)):
        out.append(idx.range_select(field, lo, hi, il, ih))
    return out + [idx.count(), idx.get(3)]


def test_index_equal_ids_and_scores():
    items = docs()
    dels = [5, 17, 200, 399]
    got = {name: results(build(pkg(name), items, dels)) for name in PKGS}
    # exactly equal: the same float operations in the same order
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]
    assert sum(len(r) for r in got["dingo_tpu"][:15]) > 100
    # upserts move postings and columns alike
    for name in PKGS:
        idx = build(pkg(name), items[:50])
        idx.add(7, dict(items[8][1], title="brand new"))
        got[name] = results(idx)
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]


@pytest.mark.parametrize("doc", [
    {"title": 3}, {"price": "cheap"}, {"price": True}, {"rating": "x"},
    {"sku": "str"}, {"in_stock": 1}, {"unknown_col": 1},
])
def test_schema_errors_equal(doc):
    got = []
    for name in PKGS:
        p = pkg(name)
        idx = p.index.DocumentIndex(1, text_fields=("title",), schema=SCHEMA)
        try:
            idx.add(1, dict({"title": "ok"}, **doc))
            got.append(("ok", idx.get(1)))
        except ValueError as e:
            got.append((type(e).__name__, str(e)))
    assert got[0] == got[1]


def test_schema_type_and_range_errors_equal():
    for name in PKGS:
        p = pkg(name)
        with pytest.raises(p.index.SchemaError):
            p.index.DocumentIndex(1, schema={"c": "decimal"})
        idx = p.index.DocumentIndex(1, schema=SCHEMA)
        with pytest.raises(p.index.SchemaError):
            idx.range_select("title", 1, 2)


@pytest.mark.parametrize("q", [
    "shoes", "+red -blue shoes", '"running shoes" hat', "title:hat",
    "price:[10 TO 20]", "price:{10 TO *}", "rating:[* TO 4.5]",
    "in_stock:true", "-price:[1 TO 5]", "sku:[A TO B]", "a AND b",
    "price:[x TO 5]", "price:[1 TO", "in_stock:maybe", 'open "phrase',
    "rating:abc", "-", "+", "",
])
def test_parse_query_equal(q):
    got = []
    for name in PKGS:
        p = pkg(name)
        try:
            pq = p.query.parse_query(q, SCHEMA)
            got.append(("ok", dataclasses.asdict(pq)))
        except ValueError as e:
            got.append((type(e).__name__, str(e)))
    assert got[0] == got[1]


def test_save_and_load_across_packages(tmp_path):
    items = docs(seed=4, n=120)
    idx = {name: build(pkg(name), items, [3, 9]) for name in PKGS}
    for src in PKGS:
        path = str(tmp_path / f"{src}.idx")
        idx[src].save(path)
        for dst in PKGS:
            p = pkg(dst)
            loaded = p.index.DocumentIndex(2)
            loaded.load(path)
            assert loaded.schema == SCHEMA
            assert results(loaded) == results(idx["dingo_tpu"])


# ---------------- DOCUMENT regions under raft -------------------------------

def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


class Cluster:
    def __init__(self, p, raws=None):
        self.p = p
        self.transport = p.raft.LocalTransport()
        self.nodes = {sid: p.node.StoreNode(
            sid, self.transport, None, raft_kw={"seed": i, **RAFT_KW},
            raw_engine=None if raws is None else raws[sid], **p.kw)
            for i, sid in enumerate(SIDS)}

    def leader(self, rid):
        def one():
            lead = [s for s in SIDS if self.nodes[s].engine.get_node(rid)
                    is not None and self.nodes[s].engine.get_node(
                        rid).is_leader()]
            return lead[0] if len(lead) == 1 else None
        assert wait_for(lambda: one() is not None)
        return one()

    def write(self, rid, data):
        """Propose on the leader, retried across leadership changes; a
        retried document add or delete applies the same bytes again."""
        from importlib import import_module

        failed = import_module(f"{self.p.name}.raft.core").ProposalFailed
        for _ in range(20):
            sid = self.leader(rid)
            try:
                self.nodes[sid].engine.write(
                    self.nodes[sid].get_region(rid), data,
                    timeout=PROPOSE_TIMEOUT_S)
                return
            except (self.p.raft.NotLeader, failed):
                time.sleep(0.1)
        raise AssertionError("no stable leader")

    def settle(self, rid):
        target = self.nodes[self.leader(rid)].engine.get_node(
            rid).commit_index
        assert wait_for(lambda: all(
            self.nodes[s].engine.get_node(rid).last_applied >= target
            for s in SIDS))

    def answers(self, rid):
        return {s: results(self.nodes[s].get_region(rid).document_index)
                for s in SIDS}

    def stop(self):
        for n in self.nodes.values():
            n.stop()


def doc_definition(p, rid=30, lo=0, hi=1 << 20):
    return p.regm.RegionDefinition(
        region_id=rid, start_key=p.vcodec.encode_vector_key(0, lo),
        end_key=p.vcodec.encode_vector_key(0, hi), peers=list(SIDS),
        region_type=p.regm.RegionType.DOCUMENT, document_schema=SCHEMA)


def test_document_region_under_raft_equal():
    items = docs(seed=8, n=240)
    got = {}
    for name in PKGS:
        p = pkg(name)
        c = Cluster(p)
        try:
            for n in c.nodes.values():
                n.create_region(doc_definition(p))
            ts = 100
            for lo in range(0, len(items), 60):
                chunk = items[lo:lo + 60]
                ts += 1
                c.write(30, p.wd.DocumentAddData(
                    ts=ts, ids=[d for d, _ in chunk],
                    documents=[doc for _, doc in chunk]))
            c.write(30, p.wd.DocumentDeleteData(ts=ts + 1,
                                                ids=[2, 50, 51, 239]))
            c.settle(30)
            after_writes = c.answers(30)
            assert all(a == after_writes["s0"] for a in after_writes.values())
            counts = {s: n.get_region(30).document_index.count()
                      for s, n in c.nodes.items()}
            raws = {s: n.raw for s, n in c.nodes.items()}
        finally:
            c.stop()
        # restart every replica on its engine: recover rebuilds the index
        c = Cluster(p, raws)
        try:
            assert all(n.recover() == 1 for n in c.nodes.values())
            c.leader(30)
            restarted = c.answers(30)
            # split: the child serves its half from its own index
            split_key = p.vcodec.encode_vector_key(0, 120)
            sid = c.leader(30)
            c.nodes[sid].propose_split(30, split_key, 31)
            assert wait_for(lambda: all(n.get_region(31) is not None
                                        for n in c.nodes.values()))
            c.settle(30)
            if name == "dingo_tpu":
                # the JAX package leaves a split child's document index
                # empty; its rebuild (the RegionRebuildIndex path) fills it
                for n in c.nodes.values():
                    n.rebuild_document_index(n.get_region(31))
            child = c.answers(31)
            c.write(31, p.wd.DocumentAddData(
                ts=ts + 5, ids=[1000], documents=[items[0][1]]))
            c.settle(31)
            child_after = c.answers(31)
        finally:
            c.stop()
        got[name] = (after_writes, counts, restarted, child, child_after)
    ref, port = got["dingo_tpu"], got["dingo_tpu_torch"]
    assert port == ref
    after_writes, counts, restarted, child, child_after = port
    assert restarted == after_writes
    assert set(counts.values()) == {len(items) - 4}
    assert child["s0"][-2] == len([d for d, _ in items
                                   if d >= 120 and d not in (239,)])
    assert child_after["s0"][-2] == child["s0"][-2] + 1


def test_heartbeat_document_count():
    from dingo_tpu_torch.metrics.collector import StoreMetricsCollector

    p = pkg("dingo_tpu_torch")
    c = Cluster(p)
    try:
        for n in c.nodes.values():
            n.create_region(doc_definition(p))
        items = docs(seed=2, n=30)
        c.write(30, p.wd.DocumentAddData(ts=5, ids=[d for d, _ in items],
                                         documents=[d for _, d in items]))
        c.settle(30)
        for n in c.nodes.values():
            snap = StoreMetricsCollector(n).collect()
            rm = [r for r in snap.regions if r.region_id == 30]
            assert rm and rm[0].document_count == 30
    finally:
        c.stop()


# ---------------- the JAX package's cases through the port ------------------

TYPED = port_cases("test_document_typed.py")
#: the in-process cases (the rest drive the gRPC server and the CLI)
TYPED_CASES = ["test_schema_validation", "test_range_select_typed_columns",
               "test_query_parser", "test_query_mode_search",
               "test_schema_survives_save_load",
               "test_negated_predicates_and_phrases",
               "test_schemaless_range_and_mixed_types",
               "test_split_preserves_document_schema",
               "test_unknown_schema_type_rejected_at_coordinator"]


@pytest.mark.parametrize("case", TYPED_CASES)
def test_document_typed_cases_through_the_port(case, tmp_path, monkeypatch):
    port_on_cpu(monkeypatch)
    assert TYPED.DocumentIndex.__module__ == "dingo_tpu_torch.document.index"
    fn = getattr(TYPED, case)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(**{a: {"tmp_path": tmp_path}[a] for a in args})
