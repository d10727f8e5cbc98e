"""TF1 bundle checkpoints -> the port's param trees (port of
disn_tpu/convert/tf_ckpt.py; the reference's restore semantics at
train/train_sdf.py:190-219, 276-299).

A pure-Python reader of TensorFlow bundle checkpoints ({prefix}.index and
{prefix}.data-*), needing no TensorFlow:

* the .index file is a LevelDB-format table (48-byte footer with the magic
  0xdb4775248b80fb57, prefix-compressed key blocks with restart arrays);
* its values are BundleEntryProto messages (dtype, TensorShapeProto, shard
  id, byte offset and size), decoded by a minimal varint protobuf walker;
* the tensors' bytes are sliced out of the data shards.

Slim variable scopes become nested dict paths
('vgg_16/conv1/conv1_1/weights' -> params[vgg_16][conv1][conv1_1][weights]);
the per-point 1x1 conv kernels of the SDF and camera heads are squeezed to
dense [in, out] kernels (models/layers.py's layout). Optimizer slots (Adam
moments, beta powers, the global step, the learning rate) are dropped, as
the reference's Saver excludes them. convert_checkpoint writes the tree
through train/checkpoint.save, so the npz restores in either package.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: object, 9: np.int64, 10: np.bool_, 14: np.uint16,
    19: np.float16, 23: np.uint32, 24: np.uint64,
}


# --------------------------------------------------------------------------
# varint / protobuf primitives
# --------------------------------------------------------------------------

def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _walk_proto(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    dims = []
    for field, _, val in _walk_proto(buf):
        if field == 2:  # Dim message
            size = 1
            for f2, _, v2 in _walk_proto(val):
                if f2 == 1:
                    size = v2 if isinstance(v2, int) else 0
            dims.append(size)
    return tuple(dims)


def _parse_entry(buf: bytes) -> dict:
    entry = {"dtype": 1, "shape": (), "shard": 0, "offset": 0, "size": 0}
    for field, _, val in _walk_proto(buf):
        if field == 1:
            entry["dtype"] = val
        elif field == 2:
            entry["shape"] = _parse_shape(val)
        elif field == 3:
            entry["shard"] = val
        elif field == 4:
            entry["offset"] = val
        elif field == 5:
            entry["size"] = val
    return entry


# --------------------------------------------------------------------------
# LevelDB table format
# --------------------------------------------------------------------------

def _block_entries(block: bytes):
    """Iterate (key, value) in one table block (prefix-compressed keys)."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block payload + 1-byte compression type + 4-byte crc."""
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return raw
    if ctype == 1:
        try:
            import snappy  # pragma: no cover - not in the image
            return snappy.decompress(raw)
        except ImportError:
            raise ValueError("snappy-compressed checkpoint index; "
                             "snappy is unavailable")
    raise ValueError(f"unknown block compression {ctype}")


def _read_table(path: str) -> dict[bytes, bytes]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError(f"{path}: too small for a table footer")
    footer = data[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    pos = 0
    _, pos = _varint(footer, pos)          # metaindex offset
    _, pos = _varint(footer, pos)          # metaindex size
    idx_off, pos = _varint(footer, pos)    # index block offset
    idx_size, pos = _varint(footer, pos)
    index = _read_block(data, idx_off, idx_size)
    out: dict[bytes, bytes] = {}
    for _, handle in _block_entries(index):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        for key, value in _block_entries(_read_block(data, off, size)):
            out[key] = value
    return out


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def read_tf_checkpoint(prefix: str) -> dict[str, np.ndarray]:
    """{variable name: array} from a TF bundle checkpoint prefix."""
    table = _read_table(prefix + ".index")
    # header under key "" carries num_shards; entry keys are variable names
    shards: dict[int, bytes] = {}

    def shard_bytes(shard: int) -> bytes:
        if shard not in shards:
            names = [p for p in os.listdir(os.path.dirname(prefix) or ".")
                     if p.startswith(os.path.basename(prefix)
                                     + f".data-{shard:05d}-of-")]
            if not names:
                raise FileNotFoundError(f"missing data shard {shard} "
                                        f"for {prefix}")
            with open(os.path.join(os.path.dirname(prefix) or ".",
                                   names[0]), "rb") as f:
                shards[shard] = f.read()
        return shards[shard]

    out: dict[str, np.ndarray] = {}
    for key, value in table.items():
        if not key:
            continue
        entry = _parse_entry(value)
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None or dtype is object:
            continue  # skip string tensors
        raw = shard_bytes(entry["shard"])[
            entry["offset"]:entry["offset"] + entry["size"]]
        arr = np.frombuffer(raw, dtype=dtype)
        out[key.decode()] = arr.reshape(entry["shape"]).copy()
    return out


_SKIP_SUBSTR = ("/Adam", "beta1_power", "beta2_power", "Momentum",
                "global_step", "batch", "learning_rate", "/lr")

# scopes whose 1x1 conv kernels become dense [in, out] (per-point MLPs)
_DENSE_SCOPES = ("sdfprediction", "sdfprediction_imgfeat", "sdfimgfeat",
                 "cameraprediction")


def tf_vars_to_params(tf_vars: dict[str, np.ndarray]) -> dict[str, Any]:
    """Nest slim variable names into the param tree, squeezing the
    per-point-MLP 1x1 conv kernels to dense layout."""
    params: dict[str, Any] = {}
    for name, arr in sorted(tf_vars.items()):
        if any(s in name for s in _SKIP_SUBSTR):
            continue
        parts = name.split("/")
        if parts[0] in _DENSE_SCOPES and name.endswith("weights") \
                and arr.ndim == 4 and arr.shape[0] == arr.shape[1] == 1:
            arr = arr[0, 0]
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return params


def convert_checkpoint(prefix: str, out_path: str) -> dict[str, Any]:
    """TF bundle -> npz checkpoint ({"params": tree}, with the source in
    its metadata); returns the param tree of numpy arrays."""
    from disn_tpu_torch.train import checkpoint
    params = tf_vars_to_params(read_tf_checkpoint(prefix))
    checkpoint.save(out_path, {"params": params},
                    metadata={"source": prefix, "format": "tf1-bundle"})
    return params
