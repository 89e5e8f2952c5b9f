"""The port's write-ahead log (`repro_torch.data.wal`) and its msgpack codec
(`repro_torch.data._msgpack`) against the reference's (`repro.data.wal`,
the `msgpack` package).

* The codec writes the bytes of ``msgpack.packb(use_bin_type=True)`` and
  decodes like ``msgpack.unpackb(raw=False)`` on drawn records of every
  type the WAL and snapshot records hold, and refuses malformed buffers
  and other types.
* Both packages' `WalWriter` write byte-identical logs for one record
  sequence, and each replays the other's log.
* The reference's torn-tail damages (`tests/test_wal.py`) truncate the
  port's log back to its last good record, and the port's writer crosses
  the three hook boundaries in the reference's order.
"""
import os
import struct
import zlib

import msgpack
import pytest

from repro.data import wal as ref_wal
from repro_torch.data import _msgpack
from repro_torch.data import wal
from repro_torch.serving.faultinject import CrashInjector, InjectedCrash

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

_SCALARS = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2**63, max_value=2**64 - 1),
    st.floats(allow_nan=False), st.text(max_size=300),
    st.binary(max_size=300))
_RECORDS = st.recursive(
    _SCALARS,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(st.text(max_size=40), inner, max_size=20)),
    max_leaves=60)

# one sequence of WAL records like the live corpus writes them
RECORDS = [{"op": "add", "ids": [1, 2], "docs": [[[0, 1.0]], []]},
           {"op": "remove", "ids": [7, 2**40]},
           {"op": "add", "ids": [3], "docs": [[[5, 0.25], [6, 0.75]]]},
           {"op": "add", "ids": list(range(300)),
            "docs": [[[i, 1.0 / (i + 1)]] for i in range(300)]}]


@hypothesis.settings(max_examples=150, deadline=None)
@hypothesis.given(_RECORDS)
def test_codec_is_byte_equal_to_msgpack(obj):
    blob = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == blob
    assert _msgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False)


def test_codec_length_boundaries_match_msgpack():
    """The fix / 8 / 16 / 32-bit length forms at their boundaries, and
    tuples packed as arrays."""
    for n in (0, 15, 16, 31, 32, 255, 256, 65535, 65536):
        for obj in ("s" * n, b"b" * n, [1] * n, (2,) * n,
                    {f"{i:06d}": i for i in range(min(n, 70000))}):
            blob = msgpack.packb(obj, use_bin_type=True)
            assert _msgpack.packb(obj) == blob
            assert _msgpack.unpackb(blob) == msgpack.unpackb(blob,
                                                             raw=False)


@pytest.mark.parametrize("blob", [
    b"", b"\xc1", b"\x92\x01", b"\x01\x02", b"\xd9\x05ab", b"\xcb\x00",
    b"\x81\x01\x02", b"\xca\x00\x00\x00\x00", b"\xd4\x00\x00",
    b"\xa2\xff\xfe"], ids=["empty", "never_used", "short_array",
                           "extra_data", "short_str", "short_float",
                           "int_key", "float32", "fixext", "bad_utf8"])
def test_codec_refuses_malformed_buffers(blob):
    with pytest.raises(ValueError):
        _msgpack.unpackb(blob)


def test_codec_refuses_other_types():
    for obj in (object(), {1, 2}, 1j):
        with pytest.raises(TypeError):
            _msgpack.packb(obj)
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)


def test_logs_are_byte_identical_and_cross_replay(tmp_path):
    p_ref, p_port = str(tmp_path / "ref.log"), str(tmp_path / "port.log")
    with ref_wal.WalWriter(p_ref) as w_ref, wal.WalWriter(p_port) as w:
        for rec in RECORDS:
            assert w.append(rec) == w_ref.append(rec)
    with open(p_ref, "rb") as f_ref, open(p_port, "rb") as f:
        assert f.read() == f_ref.read()
    assert wal.replay(p_ref) == RECORDS
    assert ref_wal.replay(p_port) == RECORDS


def test_roundtrip_and_extend(tmp_path):
    path = str(tmp_path / "test.log")
    with wal.WalWriter(path) as w:
        off = w.append(RECORDS[0])
    assert off == os.path.getsize(path)
    with wal.WalWriter(path) as w:
        w.append(RECORDS[1])
    assert wal.replay(path) == RECORDS[:2]
    assert wal.replay(str(tmp_path / "nope.log")) == []


@pytest.mark.parametrize("damage", ["garbage", "short_header",
                                    "short_payload", "bitflip",
                                    "undecodable"])
def test_torn_tail_truncated(tmp_path, damage):
    """The reference's torn tails, and a record whose CRC holds over a
    payload that does not decode: each is cut back to the last good
    record, and the log extends cleanly again."""
    path = str(tmp_path / "test.log")
    with wal.WalWriter(path) as w:
        w.append({"n": 1})
        good = w.append({"n": 2})
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        if damage == "garbage":
            f.write(b"\xde\xad\xbe\xef" * 4)
        elif damage == "short_header":
            f.write(b"\x08")                       # 1 of 8 header bytes
        elif damage == "short_payload":
            f.write(struct.pack("<II", 100, 0))    # header promises 100B
            f.write(b"xy")                         # ... delivers 2
        elif damage == "bitflip":
            f.seek(good + 4)                       # a header with a bad
            f.write(struct.pack("<II", 3, 42))     # CRC
            f.write(b"abc")
        else:
            payload = b"\xc1"                      # never-used type byte
            f.write(struct.pack("<II", 1, zlib.crc32(payload)))
            f.write(payload)
    assert wal.replay(path) == [{"n": 1}, {"n": 2}]
    assert os.path.getsize(path) == good
    with wal.WalWriter(path) as w:
        w.append({"n": 3})
    assert wal.replay(path) == [{"n": 1}, {"n": 2}, {"n": 3}]


def test_hook_boundaries_in_order_and_crash_semantics(tmp_path):
    hook = CrashInjector()                          # pure counter
    with wal.WalWriter(str(tmp_path / "a.log"), hook=hook) as w:
        w.append({"n": 1})
        w.append({"n": 2})
    assert hook.log == ["wal.append.pre", "wal.append.torn",
                        "wal.append.synced"] * 2
    # a crash at torn leaves a half record replay drops; one at synced a
    # durable record replay surfaces
    path = str(tmp_path / "b.log")
    with wal.WalWriter(path) as w:
        w.append({"n": 1})
    for target, want in ((1, [{"n": 1}]), (2, [{"n": 1}, {"n": 3}])):
        w = wal.WalWriter(path, hook=CrashInjector(target=target,
                                                   match="wal"))
        with pytest.raises(InjectedCrash):
            w.append({"n": 3, "pad": "x" * 64} if target == 1 else {"n": 3})
        w.close()
        assert wal.replay(path) == want
