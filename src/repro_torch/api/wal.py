"""Per-table write-ahead commit log — the port's own copy of
``repro.api.wal`` (stdlib and numpy only; same segment format, so a log
written by either package replays in the other).

Bigtable pairs every memtable with a commit log: a mutation is appended
to the log and fsync'd *before* it is applied to the memtable and acked,
so an acknowledged write survives any crash; recovery replays the log
tail into a fresh memtable.

* every append is encoded as one **CRC-framed record** (``u32 length +
  u32 crc32(payload)`` header, payload = monotone sequence number +
  dtype + raw code bytes) and fsync'd before the ack;
* an optional **group-commit window** batches concurrent writers into
  one fsync: appends are buffered under a short lock, one *leader*
  sleeps ``group_commit_ms`` and fsyncs for the whole wave, then every
  waiter acks;
* :meth:`WriteAheadLog.recover` replays a segment on ``SuffixTable.
  open``: records are validated (CRC, framing, strictly increasing
  sequence) and a **torn or corrupt tail is discarded** — a record is
  applied whole or not at all — with the outcome reported as a recovery
  summary (``SuffixTable.stats()["wal"]``);
* :meth:`WriteAheadLog.seal` truncates the segment **via atomic
  rename** (a fresh header-only segment is fsync'd beside the live one,
  then ``os.replace``'d over it), called only *after* a snapshot holds
  the memtable's content.  Records not yet fsync'd (the one whose
  append filled the memtable) are fsync'd in the retired segment first,
  so no waiter is released on a record that never reached the disk.
  Records carry sequence numbers so a crash between persist and seal is
  harmless: replay skips records at or below the snapshot's
  ``wal_seq``.

Segment layout (little-endian)::

    header   magic 8s | start_seq u64 | crc32(magic+start_seq) u32
    record   payload_len u32 | crc32(payload) u32 | payload
    payload  seq u64 | dtype 8s | n u64 | data (n * itemsize bytes)

The log lives under the table's directory in the catalog root
(``root/<name>/wal/wal.log``, ``api.catalog.table_wal_dir``), so
dropping or reconciling a table removes its log with it.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib

import numpy as np

from repro_torch.checkpoint.manager import fsync_path

MAGIC = b"SAWAL\x00\x01\n"
_HEADER = struct.Struct("<8sQI")           # magic, start_seq, header crc
_FRAME = struct.Struct("<II")              # payload_len, crc32(payload)
_PAYLOAD = struct.Struct("<Q8sQ")          # seq, dtype str, element count
# enforced on BOTH sides: append() refuses to frame a larger record (the
# failure must reach the writer before the ack, not surface as a
# silently-discarded 'bad_frame' on recovery), and read_segment treats a
# frame claiming more as corruption
_MAX_PAYLOAD = 1 << 30

HEADER_SIZE = _HEADER.size


@dataclasses.dataclass
class RecoverySummary:
    """What :meth:`WriteAheadLog.recover` found in a segment.

    ``records_replayed`` / ``records_skipped`` are filled in by the
    table (the log cannot know the snapshot's ``wal_seq``); everything
    else is segment-level: ``torn_bytes`` were discarded past the last
    valid record, ``reason`` says why scanning stopped (``"clean"`` for
    a segment that ends exactly at a record boundary).
    """
    segment_start_seq: int = 0
    records_scanned: int = 0
    records_replayed: int = 0
    records_skipped: int = 0
    valid_bytes: int = 0
    torn_bytes: int = 0
    reason: str = "clean"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def encode_record(seq: int, codes: np.ndarray) -> bytes:
    """One CRC-framed append record (the unit of atomicity on replay)."""
    codes = np.ascontiguousarray(codes)
    dt = codes.dtype.str.encode("ascii")
    if len(dt) > 8:
        raise ValueError(f"dtype tag {dt!r} too long for the WAL frame")
    payload = _PAYLOAD.pack(int(seq), dt.ljust(8, b"\x00"),
                            int(codes.size)) + codes.tobytes()
    if len(payload) > _MAX_PAYLOAD:
        raise ValueError(
            f"append of {codes.size} x {codes.dtype} ({len(payload)} "
            f"bytes) exceeds the WAL record cap ({_MAX_PAYLOAD}); split "
            f"the batch — a larger frame would be unrecoverable")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes) -> tuple[int, np.ndarray]:
    seq, dt, n = _PAYLOAD.unpack_from(payload, 0)
    dtype = np.dtype(dt.rstrip(b"\x00").decode("ascii"))
    data = payload[_PAYLOAD.size:]
    if len(data) != n * dtype.itemsize:
        raise ValueError(f"payload claims {n} x {dtype} but carries "
                         f"{len(data)} bytes")
    return int(seq), np.frombuffer(data, dtype=dtype).copy()


def read_segment(path: str) -> tuple[int, list, RecoverySummary]:
    """Scan a segment file: ``(start_seq, [(seq, codes, end_offset)],
    summary)``.  Scanning stops at the first torn or corrupt frame; every
    returned record passed its CRC and the strict seq monotonicity check.
    Shared by :meth:`WriteAheadLog.recover` and the crash-injection tests
    (which need record boundaries to aim their kills at)."""
    summary = RecoverySummary()
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < HEADER_SIZE:
        summary.reason = "missing_header"
        summary.torn_bytes = len(blob)
        return 0, [], summary
    magic, start_seq, hcrc = _HEADER.unpack_from(blob, 0)
    if magic != MAGIC or hcrc != zlib.crc32(blob[:_HEADER.size - 4]):
        summary.reason = "bad_header"
        summary.torn_bytes = len(blob)
        return 0, [], summary
    summary.segment_start_seq = int(start_seq)
    records: list[tuple[int, np.ndarray, int]] = []
    off, last_seq = HEADER_SIZE, int(start_seq) - 1
    while True:
        if off == len(blob):
            break                                       # clean end
        if off + _FRAME.size > len(blob):
            summary.reason = "torn_frame"
            break
        plen, crc = _FRAME.unpack_from(blob, off)
        if plen < _PAYLOAD.size or plen > _MAX_PAYLOAD:
            summary.reason = "bad_frame"
            break
        start, end = off + _FRAME.size, off + _FRAME.size + plen
        if end > len(blob):
            summary.reason = "torn_record"
            break
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            summary.reason = "crc_mismatch"
            break
        try:
            seq, codes = _decode_payload(payload)
        except Exception:  # noqa: BLE001 — any malformed payload is torn
            summary.reason = "bad_payload"
            break
        if seq != last_seq + 1:
            # a gap or regression can only come from tampering, never
            # from a torn tail; nothing after it can be trusted
            summary.reason = "seq_gap"
            break
        records.append((seq, codes, end))
        last_seq = seq
        off = end
        summary.records_scanned += 1
    summary.valid_bytes = off
    summary.torn_bytes = len(blob) - off
    return int(start_seq), records, summary


class WriteAheadLog:
    """One table's commit log: a single live segment, group-commit fsync.

    Thread-safe: :meth:`append` may be called under the table's write
    lock while :meth:`wait` (the durability barrier) is called *outside*
    it, so concurrent clients overlap their fsync waits — that overlap
    is what group commit batches.  Sequence numbers are assigned by the
    caller (the table owns the counter and persists it in snapshots).
    """

    def __init__(self, path: str, *, group_commit_ms: float = 0.0):
        if group_commit_ms < 0:
            raise ValueError(f"group_commit_ms must be >= 0, "
                             f"got {group_commit_ms}")
        self.path = path
        self.group_commit_ms = float(group_commit_ms)
        self._cond = threading.Condition()
        self._file = None                   # set by create()/recover()
        self._last_written_seq = 0          # highest seq buffered
        self._synced_seq = 0                # highest seq durable
        self._leader_active = False
        # counters (surfaced by SuffixTable.stats()["wal"])
        self.appends = 0
        self.fsyncs = 0
        self.acked = 0                      # appends acked via wait()
        self.seals = 0

    # -- segment lifecycle ---------------------------------------------------
    @classmethod
    def create(cls, path: str, *, start_seq: int,
               group_commit_ms: float = 0.0) -> "WriteAheadLog":
        """Start a fresh segment expecting ``start_seq`` as its first
        record (replacing any file already at ``path``)."""
        wal = cls(path, group_commit_ms=group_commit_ms)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wal._publish_fresh_segment(start_seq)
        wal._last_written_seq = wal._synced_seq = int(start_seq) - 1
        return wal

    def _publish_fresh_segment(self, start_seq: int) -> None:
        """Write a header-only segment beside the live path and atomically
        rename it into place (crash-safe truncation)."""
        tmp = self.path + ".new"
        hdr = MAGIC + struct.pack("<Q", int(start_seq))
        with open(tmp, "wb") as f:
            f.write(hdr + struct.pack("<I", zlib.crc32(hdr)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        fsync_path(os.path.dirname(self.path))   # the rename is durable
        if self._file is not None:
            self._file.close()
        self._file = open(self.path, "r+b")
        self._file.seek(0, os.SEEK_END)

    def recover(self) -> tuple[list, RecoverySummary]:
        """Scan the live segment, truncate any torn tail in place, and
        open it for appending.  Returns ``([(seq, codes)], summary)``;
        a missing segment recovers as empty (``reason="missing_segment"``,
        a fresh header is published lazily by the first append via
        :meth:`seal`, or eagerly by the caller)."""
        if not os.path.exists(self.path):
            summary = RecoverySummary(reason="missing_segment")
            return [], summary
        start_seq, records, summary = read_segment(self.path)
        self._file = open(self.path, "r+b")
        self._file.truncate(summary.valid_bytes)   # drop the torn tail
        self._file.seek(0, os.SEEK_END)
        if summary.torn_bytes:
            self._file.flush()
            os.fsync(self._file.fileno())
        last = records[-1][0] if records else int(start_seq) - 1
        self._last_written_seq = self._synced_seq = last
        return [(seq, codes) for seq, codes, _ in records], summary

    # -- the write path ------------------------------------------------------
    def append(self, codes: np.ndarray, seq: int) -> int:
        """Buffer one record; returns a durability token for
        :meth:`wait`.  The record is NOT yet on disk — callers must not
        ack until ``wait(token)`` returns.  Must be called with ``seq``
        strictly increasing (the table's mutation lock guarantees it)."""
        if self._file is None:
            raise RuntimeError("WAL has no live segment — use create() "
                               "or recover() first")
        rec = encode_record(seq, codes)
        with self._cond:
            if seq != self._last_written_seq + 1:
                raise ValueError(f"non-contiguous WAL seq {seq} after "
                                 f"{self._last_written_seq}")
            self._file.write(rec)
            self._last_written_seq = int(seq)
            self.appends += 1
        return int(seq)

    def wait(self, token: int) -> None:
        """Block until the record with seq ``token`` is durable (fsync'd
        or covered by a sealed snapshot).  The first waiter of a wave
        becomes the *leader*: it sleeps the group-commit window so later
        writers can join, then fsyncs once for everyone."""
        with self._cond:
            self.acked += 1
            while self._synced_seq < token:
                if not self._leader_active:
                    self._leader_active = True
                    break
                self._cond.wait()
            else:
                return
        # leader: sleep the window OUTSIDE the lock, so writers joining
        # the wave can buffer their records into it meanwhile
        if self.group_commit_ms > 0:
            time.sleep(self.group_commit_ms / 1e3)
        with self._cond:
            try:
                if self._file is not None:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                    self.fsyncs += 1
                # else: close() fsync'd and marked everything synced
                # already.  _synced_seq advances ONLY after a successful
                # fsync — on an fsync error the exception reaches this
                # caller and the other waiters retry leadership, so no
                # writer ever acks a record that missed the disk.
                self._synced_seq = max(self._synced_seq,
                                       self._last_written_seq)
            finally:
                self._leader_active = False
                self._cond.notify_all()

    def append_durable(self, codes: np.ndarray, seq: int) -> None:
        """``append`` + ``wait`` in one call (the single-writer path)."""
        self.wait(self.append(codes, seq))

    # -- truncation ----------------------------------------------------------
    def seal(self, start_seq: int) -> None:
        """Truncate the segment after its content has been persisted by a
        snapshot: fsync the records it holds that no wave has (counted in
        ``fsyncs``), then publish a fresh header-only segment (expecting
        ``start_seq`` next) over the live one via atomic rename, and
        release every waiter.  A segment with nothing unsynced is
        retired with no fsync of its own."""
        with self._cond:
            if (self._file is not None
                    and self._last_written_seq > self._synced_seq):
                self._file.flush()
                os.fsync(self._file.fileno())
                self.fsyncs += 1
                self._synced_seq = self._last_written_seq
            self._publish_fresh_segment(start_seq)
            self._last_written_seq = max(self._last_written_seq,
                                         int(start_seq) - 1)
            self._synced_seq = self._last_written_seq
            self.seals += 1
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None
            self._synced_seq = self._last_written_seq
            self._cond.notify_all()

    def stats(self) -> dict:
        return {"appends": self.appends, "acked": self.acked,
                "fsyncs": self.fsyncs, "seals": self.seals,
                "group_commit_ms": self.group_commit_ms,
                "synced_seq": self._synced_seq}
