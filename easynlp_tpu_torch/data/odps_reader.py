"""ODPS (MaxCompute) table reader seam of the PyTorch port (its own copy
of easynlp_tpu/data/odps_reader.py).

Capability parity: reference easynlp/appzoo/dataset.py:68-134 — rows come
from `common_io.table.TableReader` sliced per worker
(slice_id/slice_count); reference io_utils TFOSSIO/odps routing. The
common_io SDK only exists inside PAI, so this module:

- uses the real `common_io` when importable (production path, identical
  interface);
- otherwise serves a registered local emulation (odps://local/<path> → TSV
  file), keeping the whole odps:// flow testable end-to-end.
"""

from easynlp_tpu_torch.utils.logger import logger

_LOCAL_TABLES = {}


def register_local_table(name, path):
    """Map odps://local/<name> to a local TSV file (test/dev emulation)."""
    _LOCAL_TABLES[name] = path


class ODPSTableReader:
    """common_io.table.TableReader-compatible surface: get_row_count(),
    seek(), read(num_records) → list of column tuples, close()."""

    def __init__(self, table_path, slice_id=0, slice_count=1,
                 selected_cols=""):
        self.table_path = table_path
        self.slice_id = slice_id
        self.slice_count = slice_count
        self._local_rows = None
        self._reader = None
        self._pos = 0
        if table_path.startswith("odps://local/"):
            name = table_path[len("odps://local/"):]
            path = _LOCAL_TABLES.get(name, name)
            with open(path, encoding="utf-8") as f:
                rows = [tuple(ln.rstrip("\n").split("\t"))
                        for ln in f if ln.strip()]
            self._local_rows = rows[slice_id::slice_count]
            return
        try:
            import common_io
        except ImportError as e:
            raise RuntimeError(
                "reading %r needs the common_io SDK (PAI runtime) or a "
                "local emulation registered with register_local_table()"
                % table_path) from e
        self._reader = common_io.table.TableReader(
            table_path, slice_id=slice_id, slice_count=slice_count,
            selected_cols=selected_cols)

    def get_row_count(self):
        if self._local_rows is not None:
            return len(self._local_rows)
        return self._reader.get_row_count()

    def seek(self, offset):
        if self._local_rows is not None:
            self._pos = offset
        else:
            self._reader.seek(offset)

    def read(self, num_records=1, allow_smaller_final_batch=True):
        if self._local_rows is not None:
            out = self._local_rows[self._pos:self._pos + num_records]
            self._pos += len(out)
            return out
        return self._reader.read(num_records, allow_smaller_final_batch)

    def close(self):
        if self._reader is not None:
            self._reader.close()


def read_odps_rows(table_path, process_index=0, num_processes=1,
                   batch=4096):
    """Whole-slice fetch as TSV-joined strings (what BaseDataset.read_rows
    hands to parse_row; reference appzoo/dataset.py:94-121)."""
    reader = ODPSTableReader(table_path, slice_id=process_index,
                             slice_count=num_processes)
    rows = []
    total = reader.get_row_count()
    while len(rows) < total:
        chunk = reader.read(min(batch, total - len(rows)))
        if not chunk:
            break
        rows.extend("\t".join(str(c) for c in rec) for rec in chunk)
    reader.close()
    logger.info("odps: read %d rows from %s (slice %d/%d)", len(rows),
                table_path, process_index, num_processes)
    return rows
