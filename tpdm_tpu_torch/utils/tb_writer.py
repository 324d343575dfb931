"""Native TensorBoard event-file writer (no tensorboard/TF dependency).

The port's own copy of ``tpdm_tpu/utils/tb_writer.py``: the on-disk
protocol written by hand, so any stock TensorBoard pointed at ``--logdir``
renders the training curves:

- TFRecord framing: u64-LE length, masked crc32c of the length bytes,
  payload, masked crc32c of the payload (mask = rotr15 + 0xa282ead8, the
  TFRecord convention).
- Payloads are binary `tensorflow.Event` protos, hand-encoded (proto
  wire format is stable and tiny for the scalar subset): wall_time
  (field 1, double), step (field 2, varint), file_version (field 3,
  string, first record only), summary (field 5) holding repeated
  Summary.Value{tag (field 1), simple_value (field 2, float)}.

Only scalars are emitted — the subset the trainer's metric stream
(~15 scalar training metrics per update) actually uses; images/figures
go through EvalVisualizationCallback's disk (and wandb) path instead.
"""

from __future__ import annotations

import numbers
import os
import socket
import struct
import threading
import time
from typing import Mapping, Optional

# -- crc32c (Castagnoli, reflected poly 0x82F63B78) --------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal proto wire encoding ---------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def encode_scalar_event(
    step: int, scalars: Mapping[str, float], wall_time: float
) -> bytes:
    summary = b"".join(
        _field_bytes(
            1,  # Summary.value (repeated)
            _field_bytes(1, tag.encode("utf-8"))  # Value.tag
            + _field_float(2, float(value)),  # Value.simple_value
        )
        for tag, value in scalars.items()
    )
    return (
        _field_double(1, wall_time)  # Event.wall_time
        + _field_varint(2, int(step))  # Event.step
        + _field_bytes(5, summary)  # Event.summary
    )


def encode_version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


# -- the writer ---------------------------------------------------------------


class EventWriter:
    """Append-only TensorBoard event file in `logdir`.

    Thread-safe (the trainer's callback and a serving engine's stats
    thread may both log); one file per writer, TensorBoard merges all
    files in a directory into one run.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s.%d%s" % (
            int(time.time()),
            socket.gethostname(),
            os.getpid(),
            filename_suffix,
        )
        self.path = os.path.join(logdir, name)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._write_record(encode_version_event(time.time()))
        self.flush()

    def add_scalars(
        self,
        step: int,
        scalars: Mapping[str, float],
        wall_time: Optional[float] = None,
    ) -> None:
        numeric = {}
        for k, v in scalars.items():
            # numbers.Number admits numpy scalars (np.float32 etc.), which
            # isinstance(v, (int, float)) would silently drop; bools stay out
            if isinstance(v, numbers.Number) and not isinstance(v, bool):
                numeric[k] = float(v)
        if not numeric:
            return
        self._write_record(
            encode_scalar_event(step, numeric, wall_time or time.time())
        )

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        rec = (
            header
            + struct.pack("<I", _masked_crc(header))
            + payload
            + struct.pack("<I", _masked_crc(payload))
        )
        with self._lock:
            if not self._f.closed:  # a late tick must not raise post-close
                self._f.write(rec)

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StatsStreamer:
    """Periodically snapshot a stats() dict into a TensorBoard event file.

    Serving-side observability twin of the trainer's TensorBoardCallback:
    point it at `BatchingEngine.stats` (or any () -> dict) and TensorBoard
    renders queue waits / stage latencies / shed counters live. Nested
    one-level dicts flatten to "outer/inner" tags; non-numeric leaves are
    skipped. Steps are tick counts (wall_time carries real time).
    """

    def __init__(self, stats_fn, logdir: str, interval_s: float = 10.0):
        self._stats_fn = stats_fn
        self._writer = EventWriter(logdir, filename_suffix=".stats")
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(
            target=self._loop, name="tb-stats", daemon=True
        )
        self._thread.start()

    def _tick(self) -> None:
        try:
            stats = self._stats_fn()
        except Exception:  # engine mid-shutdown etc.; never kill the loop
            return
        flat: dict = {}

        def put(prefix, value):
            # recurse to ANY depth: the multi-resolution / family routers
            # nest per-engine stats two levels deep ("resolutions/16/...")
            if isinstance(value, dict):
                for ik, iv in value.items():
                    put(f"{prefix}/{ik}" if prefix else str(ik), iv)
            else:
                flat[prefix] = value

        put("", stats)
        self._step += 1
        self._writer.add_scalars(self._step, flat)
        self._writer.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._tick()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.interval_s + 1)
        if not self._thread.is_alive():
            # final snapshot so short runs still record one; skipped when
            # the loop thread is wedged inside stats_fn — closing under it
            # would turn its eventual write into write-after-close
            self._tick()
        self._writer.close()


# -- reader (round-trip verification / tooling; not used by training) --------


def read_scalar_events(path: str) -> list[tuple[int, dict]]:
    """Parse an event file back into [(step, {tag: value})]. Verifies the
    masked CRCs; raises ValueError on corruption. A TRUNCATED final record
    (writer killed mid-append, or a file still being written) is tolerated by stopping at the last complete
    record, matching stock TensorBoard. Used by tests and by
    `python -m tpdm_tpu_torch.utils.tb_writer <file>` for inspection."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            break  # truncated tail: header incomplete
        (length,) = struct.unpack_from("<Q", data, pos)
        if pos + 16 + length > len(data):
            break  # truncated tail: payload/crc incomplete
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != hcrc:
            raise ValueError(f"bad header crc at byte {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc at byte {pos}")
        pos += 16 + length
        step, scalars = _parse_event(payload)
        if scalars:
            out.append((step, scalars))
    return out


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 5:
            val, pos = buf[pos : pos + 4], pos + 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        else:  # pragma: no cover - groups never emitted
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _parse_event(payload: bytes) -> tuple[int, dict]:
    step, scalars = 0, {}
    for num, wire, val in _parse_fields(payload):
        if num == 2 and wire == 0:
            step = val
        elif num == 5 and wire == 2:  # summary
            for vnum, vwire, vval in _parse_fields(val):
                if vnum == 1 and vwire == 2:  # repeated Value
                    tag, fval = None, None
                    for fnum, fwire, fv in _parse_fields(vval):
                        if fnum == 1 and fwire == 2:
                            tag = fv.decode("utf-8")
                        elif fnum == 2 and fwire == 5:
                            (fval,) = struct.unpack("<f", fv)
                    if tag is not None and fval is not None:
                        scalars[tag] = fval
    return step, scalars


if __name__ == "__main__":  # pragma: no cover - CLI inspector
    import sys

    for step_, row in read_scalar_events(sys.argv[1]):
        print(step_, row)
