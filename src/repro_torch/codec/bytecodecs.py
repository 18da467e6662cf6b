"""Host-path byte codecs: ``none`` (identity) and ``delta-rle`` (lossless).

``delta-rle`` exploits temporal redundancy between successive datasets of
the same tar: iterative solvers rewrite mostly-unchanged grids every few
timesteps, so XOR against the previous payload is sparse and run-length
encodes well.  The RLE operates on 64-byte chunks (a zero *chunk* is the
unit of a run) so the encoder is a handful of vectorized numpy passes, not
a per-byte Python loop.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

from .base import Codec, CodecOrderError, as_bytes_array, register_codec

_CHUNK = 64
_TOK = struct.Struct(">II")  # (zero_chunks, literal_chunks)


def _zrle_encode(buf: np.ndarray) -> bytes:
    """Run-length encode zero 64-byte chunks: [u32 z][u32 l][l*64 bytes]...

    Full chunks are tokenized; the sub-chunk tail is appended verbatim.
    """
    n = buf.size
    nc = n // _CHUNK
    parts = []
    if nc:
        head = buf[:nc * _CHUNK].reshape(nc, _CHUNK)
        zero = ~head.any(axis=1)
        edges = np.flatnonzero(np.diff(zero.view(np.int8))) + 1
        bounds = np.concatenate(([0], edges, [nc]))
        i = 0
        while i < len(bounds) - 1:
            a, b = int(bounds[i]), int(bounds[i + 1])
            if zero[a]:
                z, i = b - a, i + 1
                if i < len(bounds) - 1:
                    lb = int(bounds[i + 1])
                    parts.append(_TOK.pack(z, lb - b))
                    parts.append(head[b:lb].tobytes())
                    i += 1
                else:
                    parts.append(_TOK.pack(z, 0))
            else:
                parts.append(_TOK.pack(0, b - a))
                parts.append(head[a:b].tobytes())
                i += 1
    tail = buf[nc * _CHUNK:]
    if tail.size:
        parts.append(tail.tobytes())
    return b"".join(parts)


def _zrle_decode(payload, n: int) -> np.ndarray:
    out = np.zeros(n, np.uint8)
    mv = memoryview(payload).cast("B")
    nc = n // _CHUNK
    pos = off = done = 0
    while done < nc:
        z, l = _TOK.unpack_from(mv, pos)
        pos += _TOK.size
        off += z * _CHUNK
        done += z
        if l:
            nb = l * _CHUNK
            out[off:off + nb] = np.frombuffer(mv[pos:pos + nb], np.uint8)
            pos += nb
            off += nb
            done += l
    tail = n - nc * _CHUNK
    if tail:
        out[nc * _CHUNK:] = np.frombuffer(mv[pos:pos + tail], np.uint8)
        pos += tail
    if pos != len(mv):
        raise ValueError(f"zrle payload has {len(mv) - pos} trailing bytes")
    return out


@register_codec("none")
class NoneCodec(Codec):
    """Identity codec — the default.  Never selected on the hot path (the
    Communicator skips encoding entirely for ``codec="none"``); exists so
    the registry, negotiation, and benchmarks treat "no codec" uniformly."""

    lossless = True

    def encode(self, data, *, dtype: str = "uint8",
               key: str = "") -> Tuple[Any, Dict[str, Any]]:
        raw = as_bytes_array(data)
        return raw, {"raw_size": int(raw.size)}

    def decode(self, payload, meta: Dict[str, Any], *,
               key: str = "") -> np.ndarray:
        return as_bytes_array(payload)


@register_codec("delta-rle")
class DeltaRleCodec(Codec):
    """XOR-delta against the previous same-key dataset + zero-chunk RLE.

    Chained: dataset *i* can only be decoded after dataset *i-1* of the same
    key, so the staging server decodes at ingest and parks out-of-order
    arrivals.  A size change (or first dataset of a key) resets the chain
    (``base=None`` → self-contained RLE of the raw bytes).  If RLE would
    expand the payload (incompressible delta) the codec falls back to
    shipping the delta verbatim (``mode="raw"``) so output never exceeds
    input size.
    """

    lossless = True
    chained = True

    def __init__(self):
        # key -> (seq of last encoded/decoded dataset, its raw uint8 copy)
        self._enc: Dict[str, Tuple[int, np.ndarray]] = {}
        self._dec: Dict[str, Tuple[int, np.ndarray]] = {}

    def reset(self, key: str = "") -> None:
        # next encode of this key is self-contained (base=None, seq=0):
        # replay after a reconnect cannot assume the server's chain state
        self._enc.pop(key, None)

    def encode(self, data, *, dtype: str = "uint8",
               key: str = "") -> Tuple[Any, Dict[str, Any]]:
        raw = as_bytes_array(data)
        prev = self._enc.get(key)
        if prev is not None and prev[1].size == raw.size:
            base, delta = prev[0], np.bitwise_xor(raw, prev[1])
        else:
            base, delta = None, raw
        seq = (prev[0] + 1) if prev is not None else 0
        payload = _zrle_encode(delta)
        meta = {"raw_size": int(raw.size), "seq": seq, "base": base,
                "mode": "rle"}
        if len(payload) >= raw.size:
            payload, meta["mode"] = delta.tobytes(), "raw"
        self._enc[key] = (seq, raw.copy())
        return payload, meta

    def decode(self, payload, meta: Dict[str, Any], *,
               key: str = "") -> np.ndarray:
        n = int(meta["raw_size"])
        base, seq = meta.get("base"), int(meta["seq"])
        prev = self._dec.get(key)
        if base is not None:
            if prev is None or prev[0] != base:
                raise CodecOrderError(key, base, -1 if prev is None
                                      else prev[0])
            if prev[1].size != n:
                raise ValueError(
                    f"delta chain for {key!r} expects base of {n}B, "
                    f"have {prev[1].size}B")
        if meta.get("mode") == "raw":
            delta = as_bytes_array(payload).copy()
            if delta.size != n:
                raise ValueError(
                    f"raw delta for {key!r} is {delta.size}B, expected {n}B")
        else:
            delta = _zrle_decode(payload, n)
        raw = delta if base is None else np.bitwise_xor(delta, prev[1])
        self._dec[key] = (seq, raw)
        return raw
