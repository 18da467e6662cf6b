"""Negotiated egress-path reduction codecs (DESIGN.md section 13).

Selected per session via ``TransportConfig.codec`` / ``decode_at``,
negotiated per connection through the ``hello`` handshake (JSON-fallback
peers silently get ``none``).
"""
from .base import (Codec, CodecError, CodecOrderError, UnknownCodecError,
                   as_bytes_array, available, create, get, np_dtype,
                   register_codec)
from .bytecodecs import DeltaRleCodec, NoneCodec
from .int8block import Int8BlockCodec

__all__ = [
    "Codec", "CodecError", "CodecOrderError", "UnknownCodecError",
    "as_bytes_array", "available", "create", "get", "np_dtype",
    "register_codec", "NoneCodec", "DeltaRleCodec", "Int8BlockCodec",
]
