"""Host table IO: CSV / Parquet / BED / VCF / GFF readers (pyarrow C++).

The reference registers external tables through DataFusion's CSV/Parquet
scans (reference queries/q1-coitrees.sql: CREATE EXTERNAL TABLE ... STORED AS
CSV ... OPTIONS('delimiter' '\t', 'has_header' 'false')).  The equivalent
surface here supports the same storage formats and options; BED files are
the headerless tab-separated (contig, start, end) special case.
"""

from __future__ import annotations

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from sequila_tpu_torch.errors import PlanError
from sequila_tpu_torch.models.table import Table


def read_csv(
    path: str,
    has_header: bool = True,
    delimiter: str = ",",
    column_names: list[str] | None = None,
    schema: pa.Schema | None = None,
) -> Table:
    delimiter = {"\\t": "\t"}.get(delimiter, delimiter)
    read_opts = pacsv.ReadOptions(
        autogenerate_column_names=not has_header and column_names is None,
        column_names=column_names if not has_header else None,
    )
    parse_opts = pacsv.ParseOptions(delimiter=delimiter)
    convert_opts = (
        pacsv.ConvertOptions(column_types={f.name: f.type for f in schema})
        if schema is not None
        else pacsv.ConvertOptions()
    )
    t = pacsv.read_csv(
        path, read_options=read_opts, parse_options=parse_opts,
        convert_options=convert_opts,
    )
    if column_names and has_header:
        t = t.rename_columns(column_names)
    return Table(t)


def read_parquet(path: str, columns: list[str] | None = None) -> Table:
    return Table(pq.read_table(path, columns=columns))


def read_bed(path: str, column_names=("contig", "pos_start", "pos_end")) -> Table:
    """Headerless tab-separated genomic intervals; extra BED columns kept."""
    t = pacsv.read_csv(
        path,
        read_options=pacsv.ReadOptions(autogenerate_column_names=True),
        parse_options=pacsv.ParseOptions(delimiter="\t"),
    )
    names = list(column_names) + [
        f"col{i}" for i in range(len(column_names), t.num_columns)
    ]
    return Table(t.rename_columns(names[: t.num_columns]))


def read_table(path: str, fmt: str, **options) -> Table:
    fmt = fmt.lower()
    if fmt == "csv":
        return read_csv(path, **options)
    if fmt == "parquet":
        return read_parquet(path)
    if fmt == "bed":
        return read_bed(path)
    if fmt == "json":
        import pyarrow.json as pajson

        return Table(pajson.read_json(path))
    if fmt == "vcf":
        return read_vcf(path)
    if fmt in ("gff", "gff3", "gtf"):
        return read_gff(path)
    raise PlanError(f"unsupported storage format: {fmt}")


def _unique_names(names: list[str]) -> list[str]:
    """Duplicate column names (SELECT * over a join) get :1 suffixes —
    parquet requires unique field names."""
    if len(set(names)) == len(names):
        return list(names)
    seen: dict[str, int] = {}
    uniq = []
    for n in names:
        k = seen.get(n, 0)
        uniq.append(n if k == 0 else f"{n}:{k}")
        seen[n] = k + 1
    return uniq


def write_table(table: Table, path: str, fmt: str | None = None) -> None:
    """Write a table; format from ``fmt`` (STORED AS override) or the
    extension (.parquet/.csv/.bed/.tsv)."""
    arrow = table.arrow
    uniq = _unique_names(arrow.column_names)
    if uniq != arrow.column_names:
        arrow = arrow.rename_columns(uniq)
    lower = f"x.{fmt.lower()}" if fmt else path.lower()
    if lower.endswith(".parquet"):
        pq.write_table(arrow, path)
    elif lower.endswith((".bed", ".tsv")):
        pacsv.write_csv(
            arrow, path,
            write_options=pacsv.WriteOptions(include_header=False, delimiter="\t"),
        )
    elif lower.endswith(".csv"):
        pacsv.write_csv(arrow, path)
    else:
        raise PlanError(f"can't infer output format from path: {path}")


def _open_writer(path: str, lower: str, schema: pa.Schema):
    """One incremental sink.  Parquet defaults are tuned for the genomic
    SELECT * shape (measured per 4-vCPU writer on the 154M-row COPY):
    plain-encoded coordinate columns without compression or per-page
    statistics (snappy costs 3.5x encode throughput — 8.5 vs 30 M
    rows/s/writer — to shave random-coordinate pages that barely
    compress), but parquet dictionary pages for columns that arrive
    dictionary-typed (the join's contig/strand outputs): they encode as
    int32 codes instead of repeated strings, both faster AND smaller.
    Env-overridable: SEQUILA_PARQUET_COMPRESSION (snappy/lz4/zstd),
    SEQUILA_PARQUET_DICT=1 (all columns) / 0 (none), SEQUILA_PARQUET_STATS=1."""
    import os

    if lower.endswith(".parquet"):
        dict_env = os.environ.get("SEQUILA_PARQUET_DICT", "auto")
        if dict_env == "auto":
            dict_cols = [
                f.name for f in schema if pa.types.is_dictionary(f.type)
            ]
            use_dictionary = dict_cols if dict_cols else False
        else:
            use_dictionary = dict_env == "1"
        return pq.ParquetWriter(
            path, schema,
            compression=os.environ.get("SEQUILA_PARQUET_COMPRESSION", "none"),
            use_dictionary=use_dictionary,
            write_statistics=os.environ.get("SEQUILA_PARQUET_STATS", "0") == "1",
        )
    if lower.endswith((".bed", ".tsv")):
        return pacsv.CSVWriter(
            path, schema,
            write_options=pacsv.WriteOptions(include_header=False, delimiter="\t"),
        )
    return pacsv.CSVWriter(path, schema)


def write_table_batches(batches, path: str, fmt: str | None = None) -> int:
    """Stream an iterator of Tables into the destination; returns the row
    count written.  The streaming half of COPY ... TO: each batch is
    appended through an incremental writer (ParquetWriter / CSVWriter),
    so the full result never has to exist in memory — the engine's analog
    of the reference's pull-based batch sink.  Formats and the duplicate-
    name rule match ``write_table``; the first batch fixes the schema.

    Two sink shapes:
    - a FILE path: one writer on a background thread, overlapping batch
      production (the join) with encoding;
    - a DIRECTORY path (trailing '/' or an existing directory; format
      from STORED AS, default parquet): ``part-N.<ext>`` files written by
      a pool of writer threads pulling from one shared queue — parquet
      encoding is single-threaded per file, so partitioned output is how
      the sink keeps up with the join (the 154M-row COPY measured ~50M
      rows/s at 4 writers vs 6M at one on the 4-vCPU bench host; the
      producer alone sustains ~170M rows/s, so the sink is encoder +
      page-cache bound).  Readers open the directory as a dataset
      (``pq.read_table(dir)``).
    In both shapes a bounded queue keeps RSS at a few batches.
    """
    import os
    import queue
    import threading

    is_dir = path.endswith(("/", os.sep)) or os.path.isdir(path)
    if is_dir:
        ext = (fmt or "parquet").lower()
        if ext not in ("parquet", "csv", "tsv", "bed"):
            raise PlanError(f"unsupported directory COPY format: {ext}")
        lower = f"x.{ext}"
        os.makedirs(path, exist_ok=True)
        nwriters = max(1, min(int(os.environ.get(
            "SEQUILA_COPY_WRITERS", os.cpu_count() or 4)), 16))
    else:
        lower = f"x.{fmt.lower()}" if fmt else path.lower()
        if not lower.endswith((".parquet", ".bed", ".tsv", ".csv")):
            raise PlanError(f"can't infer output format from path: {path}")
        nwriters = 1

    names: list[str] | None = None
    total = 0
    # ONE shared bounded queue, all writers pulling: round-robin delivery
    # head-of-line blocks the producer whenever a single writer lags (a
    # big row group, a writeback stall), idling the other writers; work
    # stealing keeps every encoder busy.  Each writer still owns its own
    # part file, so no ordering or locking is needed inside a file.
    # maxsize=nwriters bounds in-flight batches (queue + one per writer +
    # producer) to ~2x the writer count; a deeper queue only grows RSS
    # once the producer outruns the encoders (measured ~5 GB peak at the
    # 154M-row COPY with 2x, ~2.5 GB with 1x, same throughput)
    q: "queue.Queue" = queue.Queue(maxsize=max(nwriters, 2))
    errors: list[BaseException] = []
    started: list[threading.Thread] = []

    def run_writer(i: int, schema: pa.Schema):
        target = (
            os.path.join(path, f"part-{i}.{lower.rsplit('.', 1)[1]}")
            if is_dir else path
        )
        w = _open_writer(target, lower, schema)
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                w.write_table(b)
        except BaseException as e:  # surfaced to the producer
            errors.append(e)
            while q.get() is not None:  # drain so the producer can't block
                pass
        finally:
            w.close()

    try:
        for t in batches:
            arrow = t.arrow if isinstance(t, Table) else t
            if names is None:
                names = _unique_names(arrow.column_names)
                for i in range(nwriters):
                    schema = pa.schema(
                        [f.with_name(n) for f, n in zip(arrow.schema, names)]
                    )
                    th = threading.Thread(
                        target=run_writer, args=(i, schema), daemon=True
                    )
                    th.start()
                    started.append(th)
            if arrow.column_names != names:
                arrow = arrow.rename_columns(names)
            if errors:
                break
            q.put(arrow)
            total += arrow.num_rows
    finally:
        for _ in started:
            q.put(None)  # one sentinel per writer; each consumes exactly one
        for th in started:
            th.join()
    if errors:
        raise errors[0]
    return total


_VCF_COLS = ("contig", "pos_start", "id", "ref", "alt", "qual", "filter", "info")


def read_vcf(path: str) -> Table:
    """Plain-text VCF (no bgzip): the 8 fixed columns, plus computed
    end-inclusive ``pos_end`` (start + len(ref) - 1 — the deletion span)
    so variants drop straight into the interval-join operators.
    FORMAT/sample columns are ignored; '##' headers skipped."""
    t = _read_tab_skip_hash(path)
    cols = {}
    ncols = min(len(t.column_names), len(_VCF_COLS))
    for i in range(ncols):
        cols[_VCF_COLS[i]] = t.column(i)
    import pyarrow.compute as pc

    start = pc.cast(cols["pos_start"], pa.int64())
    ref_len = pc.utf8_length(pc.cast(cols["ref"], pa.string()))
    cols["pos_start"] = start
    out = pa.table(cols)
    end = pc.add(start, pc.subtract(pc.cast(ref_len, pa.int64()), 1))
    out = out.add_column(2, "pos_end", end)
    return Table(out)


def _read_tab_skip_hash(path: str) -> pa.Table:
    """Tab-separated read skipping '#'-prefixed header lines (VCF '##'
    metadata + '#CHROM' header, GFF '##' pragmas)."""
    import io

    with open(path, "rb") as f:
        data = b"".join(
            line for line in f if not line.startswith(b"#")
        )
    if not data.strip():
        raise PlanError(f"no data rows in '{path}' (headers/comments only)")
    return pacsv.read_csv(
        io.BytesIO(data),
        read_options=pacsv.ReadOptions(autogenerate_column_names=True),
        parse_options=pacsv.ParseOptions(delimiter="\t"),
        convert_options=pacsv.ConvertOptions(
            column_types={"f5": pa.string(), "f6": pa.string()}
        ),
    )


_GFF_COLS = (
    "contig", "source", "type", "pos_start", "pos_end",
    "score", "strand", "phase", "attributes",
)


def read_gff(path: str) -> Table:
    """GFF3/GTF: the 9 standard columns with interval-ready names
    (contig/pos_start/pos_end are the join columns; GFF is 1-based
    end-inclusive already, matching the engine's convention)."""
    t = _read_tab_skip_hash(path)
    cols = {}
    ncols = min(len(t.column_names), len(_GFF_COLS))
    for i in range(ncols):
        cols[_GFF_COLS[i]] = t.column(i)
    import pyarrow.compute as pc

    cols["pos_start"] = pc.cast(cols["pos_start"], pa.int64())
    cols["pos_end"] = pc.cast(cols["pos_end"], pa.int64())
    return Table(pa.table(cols))
