"""Checksummed append-only write-ahead log for the live corpus.

A copy of `repro.data.wal` with the same framing and on-disk format; the
records are encoded by the port's own msgpack codec (`data._msgpack`,
byte-identical to ``msgpack.packb(use_bin_type=True)``), so either
package replays the other's logs.

Every corpus mutation (`data.live_corpus.LiveCorpus.add_docs` /
``remove_docs``) is made durable here BEFORE it is applied in memory or
acknowledged to the caller, so a crash at any instant loses at most the
operations that were never acknowledged -- the one-directional durability
contract: **acked means recoverable** (un-acked operations may or may not
survive, and either outcome is legal).

Record framing (little-endian, self-delimiting)::

    [u32 payload length][u32 crc32(payload)][payload = msgpack record]

Replay semantics are *truncate at first bad record*: a record whose header
is incomplete, whose payload is short, whose CRC mismatches, or whose
msgpack fails to decode marks the torn tail a crashed writer leaves
behind. Everything before it is intact (each record's CRC covers its whole
payload); everything from it on is discarded and the file is truncated to
the last good boundary, so the next append continues a clean log. This is
the standard WAL recovery rule (ARIES-style logs, LevelDB/RocksDB journal
files) and is exactly what the fsync-before-ack ordering needs: the
acknowledged prefix always verifies.

Durability: `WalWriter.append` flushes AND fsyncs before returning, so an
append that returned is on disk. The ``hook`` callback fires at the three
write boundaries (``wal.append.pre`` / ``wal.append.torn`` /
``wal.append.synced``) -- the crash-point injector's substrate
(`serving.faultinject.CrashInjector`): a crash raised at ``torn`` leaves a
half-written record on disk (a real kill -9 between two write() calls),
which replay must truncate; one at ``synced`` leaves a durable but
un-acked record, which replay may legally surface. Production code passes
no hook; the boundaries cost one no-op call each.

Journal rotation belongs to the caller: `LiveCorpus` keeps one log per
snapshot generation (``wal_<gen>.log`` beside ``snapshot_<gen>``) and
starts a fresh log after each atomic snapshot rename, so replay is always
"latest complete snapshot + its own log" and old generations can be
garbage-collected wholesale.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Callable

from repro_torch.data import _msgpack

_HDR = struct.Struct("<II")   # (payload length, crc32(payload))


def _no_hook(name: str) -> None:
    pass


class WalWriter:
    """Append-only writer over one log file (created if missing, opened for
    append otherwise -- recovery truncates torn tails *before* reopening,
    see `replay`). Not thread-safe; the live corpus serializes writers
    under its own lock."""

    def __init__(self, path: str, *,
                 hook: Callable[[str], None] | None = None,
                 tracer=None):
        self.path = path
        self._hook = hook or _no_hook
        # optional repro_torch.obs tracer: WAL boundaries land in the structured
        # event log. Fired BEFORE the crash hook at each boundary, so an
        # injected (or real) crash still leaves its boundary on record.
        if tracer is None:
            from repro_torch.obs.trace import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        self._f = open(path, "ab")

    def _boundary(self, name: str, **fields) -> None:
        if self.tracer.enabled:
            self.tracer.event(name, path=self.path, **fields)
        self._hook(name)

    def append(self, record) -> int:
        """Durably append one msgpack-able record; returns the end offset.

        Write order is header, half the payload, the rest -- with crash
        boundaries between -- then flush + fsync. Only after the fsync
        (the ``synced`` boundary) may the caller acknowledge the
        operation; a crash anywhere earlier leaves a torn record that
        replay truncates away."""
        payload = _msgpack.packb(record)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._boundary("wal.append.pre", bytes=len(payload))
        half = len(payload) // 2
        self._f.write(_HDR.pack(len(payload), crc))
        self._f.write(payload[:half])
        self._f.flush()
        self._boundary("wal.append.torn")
        self._f.write(payload[half:])
        self._f.flush()
        os.fsync(self._f.fileno())
        self._boundary("wal.append.synced")
        return self._f.tell()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def replay(path: str, *, truncate: bool = True) -> list:
    """Read every intact record from a log; truncate the torn tail.

    Returns the decoded records in append order. Decoding stops at the
    first record that fails any check (short header, short payload, CRC
    mismatch, undecodable msgpack); with ``truncate`` (the recovery
    default) the file is cut back to the last good record boundary so
    subsequent appends extend a verified log. A missing file is an empty
    log (the fresh-directory case)."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        buf = f.read()
    records: list = []
    off = 0
    while off + _HDR.size <= len(buf):
        length, crc = _HDR.unpack_from(buf, off)
        start = off + _HDR.size
        end = start + length
        if end > len(buf):
            break                                   # short payload (torn)
        payload = buf[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                                   # corrupt (torn write)
        try:
            rec = _msgpack.unpackb(payload)
        except ValueError:          # CRC passed but payload undecodable --
            break                   # treat as bad, same truncation rule
        records.append(rec)
        off = end
    if truncate and off < len(buf):
        with open(path, "r+b") as f:
            f.truncate(off)
    return records
