"""Datasets and batching for the PyTorch port: its own copy of the parts of
easynlp_tpu/data/dataset.py that it calls, with the same rows, features and
batch order.

- a dataset reads the non-blank rows of its table as JAX dataset.py:49-75
  does: a local TSV through lazy row views (the native reader where it
  builds, else data/lazy_loader.LazyRows over an mmap), an odps:// table
  through data/odps_reader.py (its per-process slice), any other path
  through the io seam (utils/io_utils.py), and featurises them once into
  fixed-shape numpy arrays; with num_processes > 1 it keeps rows
  process_index::num_processes, as JAX dataset.py:32-56 (the api passes a
  rank's data-parallel index and count, appzoo/api.py);
- DataLoader: train mode shuffles per epoch with a seed, drop-last;
  eval/predict mode keeps the order and pads the final batch by repeating
  row 0, flagged `_valid` = 0. `set_epoch` passes the epoch on to a
  dataset that has `set_epoch`.
"""

import numpy as np

from easynlp_tpu_torch.utils import parse_row_by_schema, parse_schema
from easynlp_tpu_torch.utils.io_utils import io


class BaseDataset:
    """The non-blank rows of a local TSV, parsed by input_schema.
    Subclasses featurise them (__getitem__ returns one example's arrays)."""

    def __init__(self, data_file, input_schema=None, process_index=0,
                 num_processes=1, **kwargs):
        self.data_file = data_file
        self.input_schema = input_schema
        self.schema = parse_schema(input_schema) if input_schema else None
        self.process_index = process_index or 0
        self.num_processes = num_processes or 1
        self.kwargs = kwargs
        self.rows = self.read_rows(data_file)
        # an odps table's reader returns this process's slice already
        if self.num_processes > 1 and not str(data_file).startswith(
                "odps://"):
            self.rows = self.rows[self.process_index::self.num_processes]

    def read_rows(self, data_file):
        if str(data_file).startswith("odps://"):
            from easynlp_tpu_torch.data.odps_reader import read_odps_rows
            return read_odps_rows(str(data_file),
                                  process_index=self.process_index,
                                  num_processes=self.num_processes)
        if "://" not in str(data_file):
            from easynlp_tpu_torch.data.native_reader import (
                NativeLazyRows, available)
            if available():
                return NativeLazyRows(data_file)
            from easynlp_tpu_torch.data.lazy_loader import LazyRows
            return LazyRows(data_file)
        with io.open(data_file) as f:
            return [line.rstrip("\n") for line in f if line.strip()]

    def parse_row(self, row):
        if self.schema:
            return parse_row_by_schema(row, self.schema)
        return {"text": row}

    def batch_fn(self, examples):
        return {key: np.stack([np.asarray(e[key]) for e in examples])
                for key in examples[0]}

    @property
    def label_enumerate_values(self):
        return []

    def __len__(self):
        return len(self.rows)


def load_dataset(name, *args, **kwargs):
    """The datahub's loading-script registry, then HF datasets (reference
    appzoo/dataset.py:393-422; data/datahub.py)."""
    from easynlp_tpu_torch.data.datahub import load_dataset as datahub_load
    return datahub_load(name, *args, **kwargs)


class DataLoader:
    """Static-shape batching iterator.

    train mode: per-epoch shuffle with a deterministic seed, drop-last.
    eval/predict mode: in-order, final partial batch padded by repeating
    row 0 with `_valid` = 0 so metrics and writers can drop the padding.
    """

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 drop_last=None, num_workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.epoch = 0
        self.num_workers = int(num_workers or 0)
        self._pool = None

    def _fetch(self, idx):
        if self.num_workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="dataloader")
            return list(self._pool.map(
                lambda i: self.dataset[int(i)], idx))
        return [self.dataset[int(i)] for i in idx]

    def set_epoch(self, epoch):
        """The epoch for the shuffle, passed on to a dataset whose
        featurisation depends on it (MLM's dynamic masking)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_batch):
        """Iterate from batch `start_batch` without featurising the skipped
        batches; the shuffle order is a function of (seed, epoch), so the
        skip replays exactly what a full iteration would give."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        bs = self.batch_size
        for b in range(int(start_batch), len(self)):
            idx = order[b * bs:(b + 1) * bs]
            valid = np.ones(len(idx), np.int32)
            if len(idx) < bs:  # pad the final batch
                pad = np.zeros(bs - len(idx), order.dtype)
                valid = np.concatenate([valid, np.zeros(bs - len(idx), np.int32)])
                idx = np.concatenate([idx, pad])
            batch = self.dataset.batch_fn(self._fetch(idx))
            batch["_valid"] = valid
            yield batch


def get_label_mapping(label_enumerate_values):
    if isinstance(label_enumerate_values, str):
        label_enumerate_values = label_enumerate_values.split(",")
    return {label: i for i, label in enumerate(label_enumerate_values)}
