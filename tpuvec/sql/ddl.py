"""vec0 DDL parsing: CREATE VIRTUAL TABLE ... USING vec0(...).

Grammar parity with the reference's parse_create_args + extract_hnsw_clause
(src/vtab.rs:670-888):

* vector columns:  name float[768] [hnsw(M=64, ef_construction=200,
                   index_quantization=int8, distance=l2)]
  types: float/float32, int8, bit/binary; default distance cosine
  (src/vtab.rs:240-249); bare ``hnsw()`` enables the index with defaults;
* partition key:   user_id INTEGER PARTITION KEY (src/vtab.rs:854-859)
* auxiliary:       +payload TEXT  (src/vtab.rs:860-867)
* metadata:        label TEXT (or bare name -> TEXT)
* table options:   type=hnsw|enn (src/vtab.rs:738-750); chunk_size=N is
                   accepted and ignored (legacy knob); capacity=N
                   (device-specific) pre-sizes the device arrays so the jit
                   programs never recompile on growth — the analogue of
                   the reference's page-size tuning advice
                   (src/vtab.rs:160-216).
"""

from __future__ import annotations

import re

from tpuvec.index.params import HnswParams
from tpuvec.store.table import ColumnSpec
from tpuvec.types import (
    DistanceMetric,
    IndexQuantization,
    IndexType,
    InvalidParameter,
    VectorType,
)

__all__ = ["parse_create_vtab", "parse_vec0_args", "split_args"]

_CREATE_RE = re.compile(
    r"^\s*CREATE\s+VIRTUAL\s+TABLE\s+(?:IF\s+NOT\s+EXISTS\s+)?"
    r"(?P<name>[\w\".]+)\s+USING\s+vec0\s*\((?P<args>.*)\)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)


def split_args(args: str) -> list[str]:
    """Split the vec0(...) argument list on top-level commas (parens may
    nest inside hnsw(...) clauses, reference extract_hnsw_clause
    src/vtab.rs:670-709)."""
    out, depth, cur = [], 0, []
    for ch in args:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last:
        out.append(last)
    return [a for a in out if a]


def _parse_hnsw_clause(clause: str):
    """Parse ``hnsw(M=64, ef_construction=200, ...)`` -> (params, quant, metric)."""
    inner = clause[clause.index("(") + 1 : clause.rindex(")")].strip()
    params = HnswParams()
    quant = IndexQuantization.NONE
    metric = None
    if inner:
        for part in inner.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise InvalidParameter(
                    f"Invalid hnsw parameter: '{part}'. Expected key=value format"
                )
            k, v = (s.strip() for s in part.split("=", 1))
            kl = k.lower()
            if kl == "m":
                params = params.with_(m=int(v), max_m0=2 * int(v))
            elif kl == "ef_construction":
                params = params.with_(ef_construction=int(v))
            elif kl == "ef_search":
                params = params.with_(ef_search=int(v))
            elif kl == "index_quantization":
                quant = IndexQuantization.parse(v)
            elif kl == "distance":
                metric = DistanceMetric.parse(v)
            else:
                raise InvalidParameter(
                    f"Unknown hnsw parameter: '{k}'. Valid: M, ef_construction, "
                    "ef_search, index_quantization, distance"
                )
    return params, quant, metric


_VEC_TYPE_RE = re.compile(r"^(?P<t>[A-Za-z0-9]+)\s*\[\s*(?P<d>\d+)\s*\]$")
_HNSW_RE = re.compile(r"(?i)\bhnsw\s*\(")


def parse_vec0_args(args: list[str]):
    """Parse the vec0 argument list into (columns, index_type, options)."""
    columns: list[ColumnSpec] = []
    index_type = IndexType.HNSW
    options: dict = {}
    for arg in args:
        arg = arg.strip()
        if not arg:
            continue

        # table options (key=value with no spaces before '=')
        m = re.match(r"^(\w+)\s*=\s*(\w+)$", arg)
        if m:
            key, value = m.group(1).lower(), m.group(2)
            if key == "type":
                index_type = IndexType.parse(value)
                continue
            if key == "chunk_size":
                continue  # legacy knob, accepted and ignored
            if key == "capacity":
                cap = int(value)
                if cap <= 0:
                    raise InvalidParameter("capacity must be positive")
                options["capacity"] = cap
                continue
            raise InvalidParameter(f"Unknown table option: '{arg}'")

        # pull out a trailing hnsw(...) clause
        hnsw_clause = None
        hm = _HNSW_RE.search(arg)
        if hm:
            start = hm.start()
            depth = 0
            end = None
            for i in range(arg.index("(", start), len(arg)):
                if arg[i] == "(":
                    depth += 1
                elif arg[i] == ")":
                    depth -= 1
                    if depth == 0:
                        end = i + 1
                        break
            if end is None:
                raise InvalidParameter(f"Unbalanced hnsw( ) in: '{arg}'")
            hnsw_clause = arg[start:end]
            arg = (arg[:start] + arg[end:]).strip()

        parts = arg.split()
        if not parts:
            continue
        name = parts[0]

        if len(parts) == 1:
            columns.append(ColumnSpec.metadata(name))
            continue

        type_spec = parts[1]
        vm = _VEC_TYPE_RE.match(type_spec)
        if vm:
            vec_type = VectorType.parse(vm.group("t"))
            dims = int(vm.group("d"))
            if len(parts) > 2:
                raise InvalidParameter(
                    f"Unknown vector column option: '{parts[2]}'. "
                    "Use hnsw(M=N, ef_construction=N, index_quantization=int8)"
                )
            params, quant, metric = (HnswParams(), IndexQuantization.NONE, None)
            has_hnsw = False
            if hnsw_clause is not None:
                has_hnsw = True
                params, quant, metric = _parse_hnsw_clause(hnsw_clause)
            columns.append(
                ColumnSpec.vector(
                    name,
                    dims,
                    vec_type=vec_type,
                    metric=metric or DistanceMetric.COSINE,
                    # hnsw only when the clause is present; plain vector
                    # columns take the brute-force path (src/vtab.rs:2284-2296)
                    hnsw=has_hnsw,
                    params=params,
                    quantization=quant,
                )
            )
            continue

        rest = " ".join(parts[1:]).upper()
        if "PARTITION" in rest:
            columns.append(ColumnSpec.partition_key(name))
        elif name.startswith("+"):
            columns.append(ColumnSpec.aux(name.lstrip("+")))
        else:
            columns.append(ColumnSpec.metadata(name))
    return columns, index_type, options


def parse_create_vtab(sql: str):
    """Parse a full CREATE VIRTUAL TABLE statement.

    Returns (table_name, columns, index_type, options) or None if the
    statement is not a vec0 DDL.
    """
    m = _CREATE_RE.match(sql)
    if not m:
        return None
    name = m.group("name").strip('"')
    columns, index_type, options = parse_vec0_args(split_args(m.group("args")))
    return name, columns, index_type, options
