"""SQL surface tests, mirroring the reference's integration suite shapes
(tests/integration_test.rs: CREATE VIRTUAL TABLE / INSERT with vec_f32 /
MATCH + k KNN / UPDATE / DELETE / DROP) and the scalar function unit
coverage (src/sql_functions.rs)."""

import json
import sqlite3

import jax
import numpy as np
import pytest

from tpuvec.sql import connect, register_all
from tpuvec.sql import functions as F
from tpuvec.sql.ddl import parse_create_vtab, split_args
from tpuvec.types import DistanceMetric, IndexQuantization, IndexType, VectorType


def f32blob(vals):
    return np.asarray(vals, dtype="<f4").tobytes()


class TestScalarFunctions:
    def test_constructors(self):
        assert F.vec_f32("[1.0, 2.0]") == f32blob([1, 2])
        assert F.vec_f32(f32blob([3, 4])) == f32blob([3, 4])
        assert F.vec_int8("[1, -2]") == bytes([1, 254])
        assert F.vec_bit("[1, 0, 1, 1, 0, 0, 0, 0]") == bytes([0b00001101])

    def test_distances(self):
        a, b = f32blob([1, 2, 3]), f32blob([4, 5, 6])
        assert abs(F.vec_distance_l2(a, b) - np.sqrt(27)) < 1e-6
        assert abs(F.vec_distance_l1(a, b) - 9.0) < 1e-6
        assert abs(F.vec_distance_cosine(a, a)) < 1e-6
        assert F.vec_distance_hamming(bytes([0xFF]), bytes([0x0F])) == 4.0

    def test_introspection_sniffing(self):
        assert F.vec_length(f32blob([1, 2, 3])) == 3
        assert F.vec_type(f32blob([1, 2, 3])) == "float32"
        assert F.vec_length(bytes([1, 2, 3])) == 3  # not /4 -> int8
        assert F.vec_type(bytes([1, 2, 3])) == "int8"
        assert json.loads(F.vec_to_json(f32blob([1.5, -2.0]))) == [1.5, -2.0]

    def test_math(self):
        assert F.vec_add(f32blob([1, 2]), f32blob([3, 4])) == f32blob([4, 6])
        assert F.vec_sub(f32blob([1, 2]), f32blob([3, 4])) == f32blob([-2, -2])
        out = np.frombuffer(F.vec_normalize(f32blob([3, 4])), dtype="<f4")
        np.testing.assert_allclose(out, [0.6, 0.8], rtol=1e-6)
        assert F.vec_slice(f32blob([1, 2, 3, 4]), 1, 3) == f32blob([2, 3])

    def test_quantize(self):
        q = np.frombuffer(F.vec_quantize_int8(f32blob([0.0, 1.0])), dtype=np.int8)
        assert list(q) == [-128, 127]
        b = F.vec_quantize_binary(f32blob([1.0, 2.0, 3.0, 4.0]))
        assert b == bytes([0b00001100])

    def test_version_and_debug(self):
        assert F.vec_version().startswith("tpuvec ")
        info = json.loads(F.vec_debug())
        assert "backend" in info
        assert info["device_kind"] == jax.devices()[0].device_kind

    def test_register_on_stdlib_sqlite(self):
        conn = sqlite3.connect(":memory:")
        register_all(conn)
        (v,) = conn.execute("SELECT vec_length(vec_f32('[1,2,3]'))").fetchone()
        assert v == 3
        (d,) = conn.execute(
            "SELECT vec_distance_l2(vec_f32('[0,0]'), vec_f32('[3,4]'))"
        ).fetchone()
        assert abs(d - 5.0) < 1e-6


class TestDdl:
    def test_split_args(self):
        args = split_args("a float[4] hnsw(M=8, distance=l2), b TEXT, type=enn")
        assert len(args) == 3

    def test_parse_full(self):
        out = parse_create_vtab(
            """CREATE VIRTUAL TABLE docs USING vec0(
                emb float[768] hnsw(M=64, ef_construction=200,
                                    index_quantization=int8, distance=l2),
                user_id INTEGER PARTITION KEY,
                +payload TEXT,
                label TEXT,
                chunk_size=1024
            )"""
        )
        name, cols, index_type, options = out
        assert options == {}
        assert name == "docs"
        assert index_type is IndexType.HNSW
        emb = cols[0]
        assert emb.kind == "vector" and emb.dimensions == 768
        assert emb.vec_type is VectorType.FLOAT32
        assert emb.metric is DistanceMetric.L2
        assert emb.hnsw and emb.params.m == 64 and emb.params.ef_construction == 200
        assert emb.quantization is IndexQuantization.INT8
        kinds = [c.kind for c in cols]
        assert kinds == ["vector", "partition", "aux", "metadata"]

    def test_default_metric_cosine_and_no_hnsw(self):
        _, cols, _, _ = parse_create_vtab(
            "CREATE VIRTUAL TABLE t USING vec0(v float[4])"
        )
        assert cols[0].metric is DistanceMetric.COSINE
        assert not cols[0].hnsw

    def test_enn_type(self):
        _, _, it, _ = parse_create_vtab(
            "CREATE VIRTUAL TABLE t USING vec0(v float[4], type=enn)"
        )
        assert it is IndexType.ENN

    def test_not_vec0(self):
        assert parse_create_vtab("CREATE TABLE t(x)") is None

    def test_capacity_option(self):
        _, _, _, opts = parse_create_vtab(
            "CREATE VIRTUAL TABLE t USING vec0(v float[4], capacity=50000)"
        )
        assert opts == {"capacity": 50000}
        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE c USING vec0(v float[4] hnsw(M=4), capacity=2000)"
        )
        assert db.table("c").cap >= 2000


class TestDatabase:
    def make_db(self):
        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE t USING vec0("
            "e float[8] hnsw(M=8, ef_construction=32, distance=l2), label TEXT)"
        )
        return db

    def test_insert_and_knn(self):
        db = self.make_db()
        for i in range(20):
            v = [float(i)] + [0.0] * 7
            db.execute(
                "INSERT INTO t(rowid, e, label) VALUES (?, vec_f32(?), ?)",
                [i + 1, json.dumps(v), f"L{i}"],
            )
        rows = db.execute(
            "SELECT rowid, distance FROM t WHERE e MATCH ? AND k = 3 ORDER BY distance",
            [json.dumps([4.9] + [0.0] * 7)],
        ).fetchall()
        assert [r[0] for r in rows] == [6, 5, 7]
        assert abs(rows[0][1] - 0.1) < 1e-4

    def test_blob_and_json_equivalent(self):
        # reference integration_test.rs:988,1076
        db = self.make_db()
        v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
        db.execute("INSERT INTO t(rowid, e) VALUES (1, vec_f32(?))", [json.dumps(v)])
        db.execute(
            "INSERT INTO t(rowid, e) VALUES (2, ?)",
            [np.asarray(v, dtype="<f4").tobytes()],
        )
        r1 = db.execute("SELECT e FROM t WHERE rowid = 1").fetchone()
        r2 = db.execute("SELECT e FROM t WHERE rowid = 2").fetchone()
        assert json.loads(r1[0]) == json.loads(r2[0]) == v

    def test_match_blob_and_json_equivalent_all_types(self):
        """MATCH accepts the query vector as raw blob, vec_* blob, or JSON
        text, and all three return identical (rowid, distance) — across
        f32 / int8 / bit column types (reference integration_test.rs:
        1032-1131 sweeps the same surface for f32)."""
        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE tf USING vec0(e float[8] "
            "hnsw(M=4, ef_construction=32, distance=l2))"
        )
        db.execute(
            "CREATE VIRTUAL TABLE ti USING vec0(e int8[8] "
            "hnsw(M=4, ef_construction=32, distance=l2))"
        )
        db.execute(
            "CREATE VIRTUAL TABLE tb USING vec0(e bit[32] "
            "hnsw(M=4, ef_construction=32, distance=hamming))"
        )
        rng = np.random.default_rng(3)
        for i in range(16):
            f = [float(i + j) for j in range(8)]
            q8 = [int(v) for v in rng.integers(-100, 100, 8)]
            bits = [int(b) for b in rng.integers(0, 2, 32)]
            db.execute(
                "INSERT INTO tf(rowid, e) VALUES (?, vec_f32(?))",
                [i + 1, json.dumps(f)],
            )
            db.execute(
                "INSERT INTO ti(rowid, e) VALUES (?, vec_int8(?))",
                [i + 1, json.dumps(q8)],
            )
            db.execute(
                "INSERT INTO tb(rowid, e) VALUES (?, vec_bit(?))",
                [i + 1, json.dumps(bits)],
            )

        def knn(table, qparam):
            return db.execute(
                f"SELECT rowid, distance FROM {table} "
                "WHERE e MATCH ? AND k = 4 ORDER BY distance",
                [qparam],
            ).fetchall()

        # f32: JSON text vs raw LE blob
        qf = [5.1, 6.0, 7.2, 8.0, 9.0, 10.0, 11.0, 12.0]
        a = knn("tf", json.dumps(qf))
        b = knn("tf", np.asarray(qf, dtype="<f4").tobytes())
        assert [r[0] for r in a] == [r[0] for r in b] and a[0][0] == 6
        np.testing.assert_allclose(
            [r[1] for r in a], [r[1] for r in b], rtol=1e-6
        )
        # int8: JSON vs int8 blob
        qi = [int(v) for v in rng.integers(-100, 100, 8)]
        a = knn("ti", json.dumps(qi))
        b = knn("ti", np.asarray(qi, dtype=np.int8).tobytes())
        assert [(r[0], r[1]) for r in a] == [(r[0], r[1]) for r in b]
        # bit: JSON 0/1 list vs packed blob
        qb = [int(v) for v in rng.integers(0, 2, 32)]
        a = knn("tb", json.dumps(qb))
        b = knn("tb", np.packbits(qb, bitorder="little").tobytes())
        assert [(r[0], r[1]) for r in a] == [(r[0], r[1]) for r in b]

    def test_select_star_and_rowid(self):
        db = self.make_db()
        db.execute(
            "INSERT INTO t(e, label) VALUES (vec_f32('[1,0,0,0,0,0,0,0]'), 'x')"
        )
        rows = db.execute("SELECT * FROM t").fetchall()
        assert len(rows) == 1
        assert rows[0][0] == 1  # auto rowid
        row = db.execute("SELECT label FROM t WHERE rowid = 1").fetchone()
        assert row == ("x",)

    def test_update_delete_drop(self):
        db = self.make_db()
        db.execute("INSERT INTO t(rowid, e) VALUES (1, vec_f32('[1,0,0,0,0,0,0,0]'))")
        db.execute(
            "UPDATE t SET e = vec_f32('[0,1,0,0,0,0,0,0]') WHERE rowid = 1"
        )
        got = json.loads(db.execute("SELECT e FROM t WHERE rowid = 1").fetchone()[0])
        assert got[1] == 1.0
        db.execute("DELETE FROM t WHERE rowid = 1")
        assert db.execute("SELECT rowid FROM t").fetchall() == []
        db.execute("DROP TABLE t")
        with pytest.raises(Exception):
            db.table("t")

    def test_metadata_filter_in_where(self):
        db = self.make_db()
        for i in range(12):
            v = [float(i)] + [0.0] * 7
            db.execute(
                "INSERT INTO t(e, label) VALUES (vec_f32(?), ?)",
                [json.dumps(v), "even" if i % 2 == 0 else "odd"],
            )
        rows = db.execute(
            "SELECT rowid FROM t WHERE e MATCH ? AND k = 3 AND label = ?",
            [json.dumps([3.8] + [0.0] * 7), "odd"],
        ).fetchall()
        got = [r[0] for r in rows]
        assert got and all(g % 2 == 0 for g in got)  # rowid = i+1, odd i -> even rowid

    def test_vec_expr_projections(self):
        """vec_*(col) expressions in SELECT projections — the top slice of
        the SQL composability the reference gets from SQLite's planner
        (src/vtab.rs:2341-2482, integration_test.rs:681-1076)."""
        db = self.make_db()
        v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
        db.execute(
            "INSERT INTO t(rowid, e, label) VALUES (1, vec_f32(?), 'a')",
            [json.dumps(v)],
        )
        cur = db.execute(
            "SELECT rowid, vec_to_json(e), vec_length(e) AS n, label "
            "FROM t WHERE rowid = 1"
        )
        row = cur.fetchone()
        assert row[0] == 1
        assert json.loads(row[1]) == v
        assert row[2] == 8
        assert row[3] == "a"
        assert cur.description[2][0] == "n"

    def test_vec_expr_projection_with_knn_and_filter(self):
        """Function projections + MATCH + metadata filter in ONE statement."""
        db = self.make_db()
        for i in range(12):
            v = [float(i)] + [0.0] * 7
            db.execute(
                "INSERT INTO t(e, label) VALUES (vec_f32(?), ?)",
                [json.dumps(v), "even" if i % 2 == 0 else "odd"],
            )
        rows = db.execute(
            "SELECT rowid, distance, vec_to_json(e), label FROM t "
            "WHERE e MATCH ? AND k = 2 AND label = ?",
            [json.dumps([3.8] + [0.0] * 7), "odd"],
        ).fetchall()
        assert rows, "no results"
        for rid, dist, ejson, label in rows:
            assert label == "odd"
            assert json.loads(ejson)[0] == float(rid - 1)
            assert dist >= 0

    def test_vec_expr_projection_with_param(self):
        """A `?` inside a projection binds before WHERE params (textual
        order), e.g. distance-to-a-second-anchor per result row."""
        db = self.make_db()
        for i in range(6):
            db.execute(
                "INSERT INTO t(e) VALUES (vec_f32(?))",
                [json.dumps([float(i)] + [0.0] * 7)],
            )
        anchor = json.dumps([0.0] * 8)
        probe = json.dumps([2.1] + [0.0] * 7)
        rows = db.execute(
            "SELECT rowid, vec_distance_l2(e, vec_f32(?)) FROM t "
            "WHERE e MATCH ? AND k = 2",
            [anchor, probe],
        ).fetchall()
        assert rows[0][0] == 3  # nearest to 2.1 is row 3 (value 2.0)
        assert abs(rows[0][1] - 2.0) < 1e-5  # distance to the 0-anchor

    def test_unknown_projection_function_raises(self):
        db = self.make_db()
        db.execute("INSERT INTO t(e) VALUES (vec_f32('[1,0,0,0,0,0,0,0]'))")
        with pytest.raises(Exception, match="unknown function"):
            db.execute("SELECT vec_bogus(e) FROM t")

    def test_executemany_bulk_insert(self):
        db = self.make_db()
        db.executemany(
            "INSERT INTO t(e, label) VALUES (vec_f32(?), ?)",
            [[json.dumps([float(i)] + [0.0] * 7), f"L{i}"] for i in range(16)],
        )
        assert len(db.table("t")) == 16
        rows = db.execute(
            "SELECT rowid FROM t WHERE e MATCH ? AND k = 1",
            [json.dumps([7.0] + [0.0] * 7)],
        ).fetchall()
        assert rows[0][0] == 8

    def test_rebuild_sql(self):
        db = self.make_db()
        for i in range(10):
            db.execute(
                "INSERT INTO t(e) VALUES (vec_f32(?))",
                [json.dumps([float(i)] + [0.0] * 7)],
            )
        db.execute("SELECT vec_rebuild_hnsw('t', 'e', 4, 32)")
        assert db.integrity_check("t") == []
        rows = db.execute(
            "SELECT rowid FROM t WHERE e MATCH ? AND k = 1",
            [json.dumps([7.1] + [0.0] * 7)],
        ).fetchall()
        assert rows[0][0] == 8

    def test_rebuild_validation(self):
        db = self.make_db()
        db.execute("INSERT INTO t(e) VALUES (vec_f32('[1,0,0,0,0,0,0,0]'))")
        with pytest.raises(Exception):
            db.execute("SELECT vec_rebuild_hnsw('t', 'e', 1, 32)")  # M < 2
        with pytest.raises(Exception):
            db.execute("SELECT vec_rebuild_hnsw('t', 'e', 8, 5000)")  # ef_c > 2000

    def test_plain_sqlite_passthrough(self):
        db = self.make_db()
        db.execute("CREATE TABLE plain(x INTEGER)")
        db.execute("INSERT INTO plain(x) VALUES (41)")
        (v,) = db.execute("SELECT x + 1 FROM plain").fetchone()
        assert v == 42
        (ver,) = db.execute("SELECT vec_version()").fetchone()
        assert ver.startswith("tpuvec ")


class TestEnnTable:
    def test_enn_type_uses_exact_scan(self):
        import json as _json

        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE e USING vec0(v float[4] hnsw(distance=l2), type=enn)"
        )
        t = db.table("e")
        assert not next(iter(t.vector_cols.values())).has_hnsw
        for i in range(30):
            db.execute(
                "INSERT INTO e(v) VALUES (vec_f32(?))",
                [_json.dumps([float(i), 0.0, 0.0, 0.0])],
            )
        rows = db.execute(
            "SELECT rowid, distance FROM e WHERE v MATCH ? AND k = 3",
            [_json.dumps([10.2, 0.0, 0.0, 0.0])],
        ).fetchall()
        assert [r[0] for r in rows] == [11, 12, 10]  # exact
        assert abs(rows[0][1] - 0.2) < 1e-4


class TestEfOverride:
    def test_ef_in_match_query(self):
        import json as _json

        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE f USING vec0(v float[8] hnsw(M=8, ef_construction=32, distance=l2))"
        )
        for i in range(40):
            db.execute(
                "INSERT INTO f(v) VALUES (vec_f32(?))",
                [_json.dumps([float(i)] + [0.0] * 7)],
            )
        # per-query ef override (extension: the reference stores ef_search
        # but exposes no per-query override, SURVEY §5 config note)
        rows = db.execute(
            "SELECT rowid FROM f WHERE v MATCH ? AND k = 3 AND ef = 16",
            [_json.dumps([20.1] + [0.0] * 7)],
        ).fetchall()
        assert rows[0][0] == 21

class TestPlannerRobustness:
    def make_db(self):
        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE t USING vec0("
            "e float[8] hnsw(M=8, ef_construction=32, distance=l2), label TEXT)"
        )
        return db

    def test_param_binding_textual_order(self):
        # '?' placeholders must bind by textual position, not clause type:
        # here the filter '?' comes before k = ?.
        db = self.make_db()
        for i in range(12):
            v = [float(i)] + [0.0] * 7
            db.execute(
                "INSERT INTO t(e, label) VALUES (vec_f32(?), ?)",
                [json.dumps(v), "even" if i % 2 == 0 else "odd"],
            )
        rows = db.execute(
            "SELECT rowid FROM t WHERE e MATCH ? AND label = ? AND k = ?",
            [json.dumps([3.8] + [0.0] * 7), "odd", 3],
        ).fetchall()
        got = [r[0] for r in rows]
        assert len(got) == 3 and all(g % 2 == 0 for g in got)
        # filter '?' before MATCH '?' too
        rows = db.execute(
            "SELECT rowid FROM t WHERE label = ? AND e MATCH ? AND k = ?",
            ["odd", json.dumps([3.8] + [0.0] * 7), 3],
        ).fetchall()
        assert [r[0] for r in rows] == got

    def test_unsupported_statement_raises(self):
        # statements the engine can't run anywhere must raise a clear
        # error; joins/subqueries now compose via the SQLite mirror
        from tpuvec.types import InvalidParameter

        db = self.make_db()
        db.execute("INSERT INTO t(e) VALUES (vec_f32('[1,0,0,0,0,0,0,0]'))")
        rows = db.execute(
            "SELECT a.rowid FROM t a JOIN t b ON a.rowid = b.rowid"
        ).fetchall()
        assert rows == [(1,)]
        rows = db.execute("SELECT rowid FROM (SELECT * FROM t)").fetchall()
        assert rows == [(1,)]
        # writes through arbitrary SQL shapes still raise clearly
        with pytest.raises(InvalidParameter, match="unsupported statement"):
            db.execute("INSERT INTO t SELECT * FROM t")
        # ordinary SQL on non-vec0 tables still passes through
        db.execute("CREATE TABLE plain(x INTEGER)")
        db.execute("INSERT INTO plain VALUES (7)")
        assert db.execute("SELECT x FROM plain").fetchone() == (7,)


class TestComposability:
    """Arbitrary-SQL over vec0 tables via the SQLite mirror fallback —
    the composability the reference gets from hosting a virtual table
    inside SQLite's planner (src/vtab.rs:964-1028, 2341-2482):
    joins, subqueries, aggregates, GROUP BY, arbitrary WHERE, and
    KNN-with-metadata in one statement (integration_test.rs:681-1076)."""

    def make_db(self, n=60):
        db = connect()
        db.execute(
            "CREATE VIRTUAL TABLE t USING vec0(e float[8] "
            "hnsw(M=4, ef_construction=32, distance=l2), cat)"
        )
        rng = np.random.default_rng(0)
        self.X = rng.normal(size=(n, 8)).astype(np.float32)
        for i, v in enumerate(self.X):
            db.execute(
                "INSERT INTO t(rowid, e, cat) VALUES (?, ?, ?)",
                [i + 1, v.tobytes(), int(i % 3)],
            )
        db.execute("CREATE TABLE meta (id INTEGER PRIMARY KEY, title TEXT)")
        for i in range(n):
            db.execute("INSERT INTO meta VALUES (?, ?)", [i + 1, f"doc{i + 1}"])
        return db

    def test_aggregates_and_group_by(self):
        db = self.make_db()
        assert db.execute("SELECT count(*) FROM t").fetchone()[0] == 60
        rows = db.execute(
            "SELECT cat, count(*) FROM t GROUP BY cat ORDER BY cat"
        ).fetchall()
        assert rows == [(0, 20), (1, 20), (2, 20)]

    def test_arbitrary_where_predicates(self):
        db = self.make_db()
        # range predicate (the regex planner would previously scan-drop it)
        assert db.execute(
            "SELECT count(*) FROM t WHERE cat > 1"
        ).fetchone() == (20,)
        # vec_* function in WHERE
        n = db.execute(
            "SELECT count(*) FROM t WHERE vec_length(e) = 8"
        ).fetchone()
        assert n == (60,)

    def test_knn_join_with_metadata(self):
        db = self.make_db()
        rows = db.execute(
            "SELECT t.rowid, t.distance, m.title FROM t "
            "JOIN meta m ON m.id = t.rowid "
            "WHERE t.e MATCH ? AND k = 5 ORDER BY t.distance",
            [self.X[7].tobytes()],
        ).fetchall()
        assert len(rows) == 5
        assert rows[0][0] == 8 and rows[0][2] == "doc8"
        assert abs(rows[0][1]) < 1e-5
        assert [r[1] for r in rows] == sorted(r[1] for r in rows)

    def test_knn_match_via_vec_f32_and_alias(self):
        db = self.make_db()
        q = json.dumps([float(x) for x in self.X[9]])
        rows = db.execute(
            "SELECT a.rowid FROM t AS a JOIN meta m ON m.id = a.rowid "
            "WHERE a.e MATCH vec_f32(?) AND k = 2",
            [q],
        ).fetchall()
        assert rows[0][0] == 10

    def test_subquery_and_cte(self):
        db = self.make_db()
        r = db.execute(
            "SELECT vec_length(e) FROM t WHERE rowid IN "
            "(SELECT id FROM meta WHERE title = ?)",
            ["doc3"],
        ).fetchall()
        assert r == [(8,)]
        r = db.execute(
            "WITH big AS (SELECT rowid AS r FROM t WHERE cat = 2) "
            "SELECT count(*) FROM big"
        ).fetchone()
        assert r == (20,)

    def test_order_by_metadata_and_limit(self):
        db = self.make_db()
        rows = db.execute(
            "SELECT rowid FROM t ORDER BY cat DESC, rowid LIMIT 3"
        ).fetchall()
        assert rows == [(3,), (6,), (9,)]

    def test_composed_delete_and_update(self):
        db = self.make_db()
        db.execute("DELETE FROM t WHERE cat = 0 AND rowid > 50")
        assert db.execute("SELECT count(*) FROM t").fetchone()[0] == 57
        db.execute("UPDATE t SET cat = ? WHERE cat = 2 AND rowid <= 6", [9])
        assert db.execute(
            "SELECT count(*) FROM t WHERE cat = 9"
        ).fetchone()[0] == 2
        # mirror must re-materialize after the on-device writes
        assert db.execute(
            "SELECT count(*) FROM t WHERE cat = 2"
        ).fetchone()[0] == 18

    def test_mirror_vectors_are_json_text(self):
        # direct projection of a vector column through the mirror reads
        # as JSON (the reference's column() contract, vtab.rs:2341-2482)
        db = self.make_db()
        v = db.execute(
            "SELECT e FROM t WHERE rowid = 4 AND 1 = 1"
        ).fetchone()[0]
        got = json.loads(v)
        np.testing.assert_allclose(got, self.X[3], rtol=1e-6)

    def test_two_vec0_tables_join(self):
        db = self.make_db(20)
        db.execute(
            "CREATE VIRTUAL TABLE u USING vec0(f float[8] "
            "hnsw(M=4, ef_construction=32, distance=l2), tag)"
        )
        for i in range(10):
            db.execute(
                "INSERT INTO u(rowid, f, tag) VALUES (?, ?, ?)",
                [i + 1, self.X[i].tobytes(), int(i)],
            )
        rows = db.execute(
            "SELECT t.rowid, u.tag FROM t JOIN u ON u.rowid = t.rowid "
            "WHERE t.cat = 0 AND u.tag < 4 ORDER BY t.rowid"
        ).fetchall()
        assert rows == [(1, 0), (4, 3)]

    def test_single_table_fast_path_unaffected(self):
        db = self.make_db()
        rows = db.execute(
            "SELECT rowid, distance FROM t WHERE e MATCH ? AND k = 3 "
            "ORDER BY distance",
            [self.X[4].tobytes()],
        ).fetchall()
        assert rows[0][0] == 5
        # no mirror should exist for the fast path
        got = db.sqlite.execute(
            "SELECT name FROM sqlite_temp_master WHERE type='table'"
        ).fetchall()
        assert got == []
