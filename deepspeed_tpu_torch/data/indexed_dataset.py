"""Memory-mapped indexed dataset for pretokenized corpora — counterpart of
``deepspeed_tpu/data/indexed_dataset.py`` (the reference's Megatron-derived
``MMapIndexedDataset``, ``runtime/data_pipeline/data_sampling/
indexed_dataset.py``).

A ``.bin`` file of concatenated token arrays and a ``.idx`` sidecar: the
magic ``DSTPUIDX1\\0``, a dtype code and the item count (``<BQ``), then the
int64 offsets.  The bytes are JAX's, so each package reads what the
other's builder writes.  Reads go through ``np.memmap``: a corpus larger
than host memory costs none of it.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

_MAGIC = b"DSTPUIDX1\x00"

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Append token sequences, then ``finalize()`` writes the index."""

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        self._data = open(data_file_path(prefix), "wb")
        self._lengths: List[int] = []

    def add_item(self, tokens) -> None:
        """``tokens``: a sequence, numpy array or CPU tensor of ids."""
        arr = np.asarray(tokens, dtype=self.dtype)
        self._data.write(arr.tobytes(order="C"))
        self._lengths.append(arr.size)

    def add_document(self, tokens, doc_boundaries=None) -> None:  # reference API
        self.add_item(tokens)

    def finalize(self) -> None:
        self._data.close()
        lengths = np.asarray(self._lengths, dtype=np.int64)
        offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        with open(index_file_path(self.prefix), "wb") as fh:
            fh.write(_MAGIC)
            fh.write(struct.pack("<BQ", _DTYPE_CODES[self.dtype], len(lengths)))
            fh.write(offsets.tobytes(order="C"))


class MMapIndexedDataset:
    """Zero-copy reads of sequence ``i`` (a numpy array) via ``np.memmap``."""

    def __init__(self, prefix: str, skip_warmup: bool = True):
        self.prefix = prefix  # re-openable by the analyzer's map workers
        with open(index_file_path(prefix), "rb") as fh:
            magic = fh.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{index_file_path(prefix)}: bad magic {magic!r}")
            code, n = struct.unpack("<BQ", fh.read(9))
            self.dtype = np.dtype(_DTYPES[code])
            self._offsets = np.frombuffer(fh.read(8 * (n + 1)), dtype=np.int64)
        self._n = int(n)
        self._data = np.memmap(data_file_path(prefix), dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(self._n))]
        if idx < 0:
            idx += self._n
        if not 0 <= idx < self._n:
            raise IndexError(idx)
        return np.asarray(self._data[self._offsets[idx]:self._offsets[idx + 1]])

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self._offsets)

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        start = self._offsets[idx] + offset
        stop = self._offsets[idx + 1] if length is None else start + length
        return np.asarray(self._data[start:stop])

