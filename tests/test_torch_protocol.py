"""The port's wire framing against the reference's (hypothesis twins of
``tests/test_protocol_properties.py``): any sequence of page blocks
(0-byte batches to payloads beyond the socket buffer and the page size),
tags, destinations and control messages encodes to the reference's frame
bytes, decodes in either package to the same batches, and round-trips
through a live localhost TCP connection with the cursor exact. Also the
AGG partials' page blocks, whose payload bytes are the per-rank
``shuffle_bytes``."""
import socket
import threading

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.dist.protocol as rp  # noqa: E402
import repro.objectmodel.vectorlist as rv  # noqa: E402

pytest.importorskip("torch")
import repro_torch.dist.protocol as pp  # noqa: E402
import repro_torch.objectmodel.vectorlist as pv  # noqa: E402

_sizes = st.integers(0, 256) | st.just(70_000)
_tags = st.text(
    alphabet=st.characters(min_codepoint=33, max_codepoint=126),
    min_size=1, max_size=10)
_dsts = st.integers(-1, 7)


def _batch(vl_mod, n_rows: int, seed: int):
    base = np.arange(n_rows, dtype=np.int64) * 2654435761 + seed
    return vl_mod.VectorList({"a": base,
                              "b": (base % 977).astype(np.float64) / 3.0})


def _messages(proto, vl_mod, frames):
    out = []
    for i, (dst, tag, rows) in enumerate(frames):
        if i % 5 == 4:
            msg = None
        elif i % 5 == 3:
            msg = {"proto": 2, "rank": i, "note": tag}
        else:
            msg = [proto.encode_batch(_batch(vl_mod, rows, i))]
        out.append((dst, tag, msg))
    return out


def _blob(proto, msgs):
    return b"".join(bytes(buf) for dst, tag, msg in msgs
                    for buf in proto.frame_buffers(0, dst, tag, msg))


def _assert_same(sent, received, proto):
    (dst, tag, msg), (src, got_dst, got_tag, got_msg) = sent, received
    assert (src, got_dst, got_tag) == (0, dst, tag)
    if msg is None or isinstance(msg, dict):
        assert got_msg == msg
        return
    a, b = pp.decode_batch(msg[0]), proto.decode_batch(got_msg[0])
    assert list(a.names) == list(b.names)
    for c in a.names:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@given(frames=st.lists(st.tuples(_dsts, _tags, _sizes),
                       min_size=1, max_size=6))
@settings(max_examples=40, deadline=None)
def test_frames_are_the_reference_bytes_and_decode_in_both(frames):
    msgs = _messages(pp, pv, frames)
    blob = _blob(pp, msgs)
    assert blob == _blob(rp, _messages(rp, rv, frames))
    for proto in (pp, rp):
        off = 0
        for sent in msgs:
            decoded, off = proto.decode_frame(blob, off)
            _assert_same(sent, decoded, proto)
        assert off == len(blob)


@given(frames=st.lists(st.tuples(_dsts, _tags, _sizes),
                       min_size=1, max_size=4))
@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_frames_roundtrip_live_localhost_socket(frames):
    msgs = _messages(pp, pv, frames)
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    wr = socket.create_connection(lst.getsockname(), timeout=30)
    rd, _ = lst.accept()
    lst.close()
    rd.settimeout(30)  # a framing bug must fail, not hang

    def writer():
        for dst, tag, msg in msgs:
            pp.write_frame(wr, 0, dst, tag, msg)
        wr.close()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for sent in msgs:
            decoded = rp.read_frame(rd)  # the reference reads the port
            assert decoded is not None
            _assert_same(sent, decoded, rp)
        assert rp.read_frame(rd) is None
    finally:
        rd.close()
        t.join(timeout=30)


@given(keys=st.lists(st.integers(-50, 50), min_size=0, max_size=300),
       seed=st.integers(0, 2**16))
@settings(max_examples=30, deadline=None)
def test_agg_partials_are_the_reference_page_bytes(keys, seed):
    """A pre-aggregation partial's page block: the reference's payload
    bytes (what ``shuffle_bytes`` counts), decoded back to the same map."""
    from repro.core.relops import AggMap as RMap, AggSpec as RSpec
    from repro_torch.core.relops import AggMap as PMap, AggSpec as PSpec
    rng = np.random.default_rng(seed)
    k = np.asarray(keys, np.int64)
    v = rng.normal(size=len(k))
    maps = []
    for Map, Spec in ((RMap, RSpec), (PMap, PSpec)):
        m = Map(Spec(key_names=("k",), combiners=("sum", "max"),
                     finalize=("0", "1"), out_names=("s", "m")))
        if len(k):
            m.absorb([k], [v, v])
        maps.append(m)
    rblock, pblock = rp.encode_agg_map(maps[0]), pp.encode_agg_map(maps[1])
    if not len(k):
        assert rblock is None and pblock is None
        return
    assert pblock.nbytes == rblock.nbytes
    assert pblock.descr == rblock.descr and pblock.names == rblock.names
    assert [(n, p.tobytes()) for n, p in pblock.payloads] == [
        (n, p.tobytes()) for n, p in rblock.payloads]
    back = pp.decode_agg_map(pblock, maps[1].spec)
    assert list(back.data) == list(maps[1].data)
