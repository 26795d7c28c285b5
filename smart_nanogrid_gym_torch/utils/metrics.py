"""Persistent training metrics: CSV + TensorBoard event files, no dependencies.

The reference logs training scalars to TensorBoard through SB3
(solvers/RL/ppo_train.py:92 ``tensorboard_log=...``; the shipped
images/Indicative_tensorboard.png shows the dashboards).  This framework
writes the same two artifact kinds from its own train loops:

- ``progress.csv`` — one row per logged update, columns = metric names
  (machine-readable stream for dashboards/pandas);
- ``events.out.tfevents.*`` — real TensorBoard scalar events, written by a
  minimal encoder for the TFRecord framing (length + masked CRC32C) and the
  ``Event``/``Summary`` protobufs.  Only varint/double/float/length-delimited
  wire types are needed for scalars, so the encoder is ~60 lines and the files
  open in stock TensorBoard.

The PyTorch port keeps this copy of ``smart_nanogrid_gym_tpu/utils/metrics.py``,
unchanged apart from this note, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord framing checksums
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding (only what Event/Summary scalars need)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _double(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _float(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _int64(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(num: int, value: bytes) -> bytes:
    return _field(num, 2) + _varint(len(value)) + value


def _scalar_event(step: int, wall_time: float, scalars: dict[str, float]) -> bytes:
    # Summary.Value{tag=1, simple_value=2}; Summary{value=1}; Event{wall_time=1,
    # step=2, summary=5}
    summary = b"".join(
        _bytes(1, _bytes(1, tag.encode()) + _float(2, float(val)))
        for tag, val in scalars.items()
    )
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class MetricsWriter:
    """Streams training scalars to ``progress.csv`` + a tfevents file.

    ``add(step, **scalars)`` appends one row/event; files are flushed per call
    so dashboards can tail a live run.  The CSV header is the union of metric
    names from the first ``add`` (later unknown names raise — keep the schema
    stable like the reference's fixed TB scalar set).
    """

    def __init__(self, log_dir: str, run_name: str = ""):
        self.log_dir = os.path.join(log_dir, run_name) if run_name else log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self._csv_path = os.path.join(self.log_dir, "progress.csv")
        # Resuming into an existing CSV must keep rows aligned with its header:
        # read it now and validate the first add() against it (raise on a
        # schema mismatch rather than silently writing misaligned rows).
        self._existing_header: list[str] | None = None
        if os.path.exists(self._csv_path) and os.path.getsize(self._csv_path) > 0:
            with open(self._csv_path) as fp:
                first = fp.readline().rstrip("\n")
            if first:
                self._existing_header = first.split(",")
        self._csv = open(self._csv_path, "a")
        self._columns: list[str] | None = None
        wall = time.time()
        self._events_path = os.path.join(
            self.log_dir, f"events.out.tfevents.{int(wall)}.{os.getpid()}"
        )
        self._events = open(self._events_path, "ab")
        self._events.write(_record(_file_version_event(wall)))
        self._events.flush()

    def add(self, step: int, **scalars: float) -> None:
        if self._columns is None:
            self._columns = ["step"] + sorted(scalars)
            if self._existing_header is not None:
                if self._existing_header != self._columns:
                    raise ValueError(
                        f"progress.csv at {self._csv_path} has header "
                        f"{self._existing_header} but this run logs "
                        f"{self._columns}; use a fresh log_dir/run_name")
            elif self._csv.tell() == 0:
                self._csv.write(",".join(self._columns) + "\n")
        unknown = set(scalars) - set(self._columns)
        if unknown:
            raise ValueError(f"new metric names after first add: {sorted(unknown)}")
        row = {"step": step, **scalars}
        self._csv.write(",".join(str(row.get(c, "")) for c in self._columns) + "\n")
        self._csv.flush()
        self._events.write(_record(_scalar_event(step, time.time(), scalars)))
        self._events.flush()

    def close(self) -> None:
        self._csv.close()
        self._events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
