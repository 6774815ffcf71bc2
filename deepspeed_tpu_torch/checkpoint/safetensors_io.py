"""A small reader and writer of the safetensors format, so that the port
needs neither the ``safetensors`` package nor ``ml_dtypes``.

The format: an 8-byte little-endian header length, a JSON header mapping
each name to ``{"dtype", "shape", "data_offsets"}`` (and an optional
``__metadata__`` map of strings), padded with spaces to a multiple of 8,
then the tensors' raw little-endian bytes.  The writer lays tensors out as
the reference implementation does (by dtype, widest first, then by name;
compact JSON, ``__metadata__`` first), so its files are byte-identical to
``safetensors.torch.save_file``'s (with at most one metadata key: the
package writes a larger metadata map in its hash order).  bf16 goes
through torch.

Both sides stream: ``SafetensorsReader.get`` reads one tensor from disk,
and ``write_safetensors`` takes ``(name, dtype, shape)`` specs and a
producer of one tensor at a time, so a host never holds more than one.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_CODES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "F8_E5M2": torch.float8_e5m2, "F8_E4M3": torch.float8_e4m3fn,
    "I16": torch.int16, "F16": torch.float16, "BF16": torch.bfloat16,
    "I32": torch.int32, "F32": torch.float32, "F64": torch.float64, "I64": torch.int64,
}
_NAMES = {v: k for k, v in _CODES.items()}
# the reference writer's dtype order (its Dtype enum), widest last
_RANK = ["BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "I16", "U16", "F16", "BF16", "I32",
         "U32", "F32", "F64", "I64", "U64"]


class SafetensorsReader:
    """Reads tensors of one ``.safetensors`` file by name, one at a time."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
        self.metadata = header.pop("__metadata__", None)
        self.header = header
        self._base = 8 + n

    def keys(self) -> List[str]:
        return list(self.header)

    def __contains__(self, name: str) -> bool:
        return name in self.header

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor of its stored dtype."""
        entry = self.header[name]
        begin, end = entry["data_offsets"]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        with open(self.path, "rb") as fh:
            fh.seek(self._base + begin)
            if end > begin:
                fh.readinto(memoryview(buf.numpy()))
        return buf.view(_CODES[entry["dtype"]]).reshape(entry["shape"])


def _layout(specs: Sequence[Tuple[str, torch.dtype, Tuple[int, ...]]],
            metadata: Optional[Dict[str, str]]) -> Tuple[bytes, List[str]]:
    """The padded header and the names in data order."""
    order = sorted(specs, key=lambda s: (-_RANK.index(_NAMES[s[1]]), s[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    for name, dtype, shape in order:
        n = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": _NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw, [s[0] for s in order]


def write_safetensors(path: str, specs: Iterable[Tuple[str, torch.dtype, Tuple[int, ...]]],
                      produce: Callable[[str], torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``path``: ``specs`` gives each tensor's name, dtype and shape,
    ``produce(name)`` the tensor itself when its turn comes (moved to the
    CPU here).  Returns the bytes written."""
    specs = list(specs)
    head, order = _layout(specs, metadata)
    want = {name: (dtype, tuple(shape)) for name, dtype, shape in specs}
    total = len(head)
    with open(path, "wb") as fh:
        fh.write(head)
        for name in order:
            t = produce(name).detach().to("cpu").contiguous()
            if (t.dtype, tuple(t.shape)) != want[name]:
                raise ValueError(f"{name}: produced {t.dtype} {tuple(t.shape)}, declared "
                                 f"{want[name]}")
            if t.numel():
                fh.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
            total += t.numel() * t.element_size()
    return total


def list_shards(model_dir: str) -> List[str]:
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    return [os.path.join(model_dir, f) for f in files]
