from .arkworks import (
    PointCodec,
    buffer_size,
    g1_codec,
    g2_codec,
    serialize_fr,
    deserialize_fr,
    write_to_file,
)

__all__ = [
    "PointCodec",
    "buffer_size",
    "g1_codec",
    "g2_codec",
    "serialize_fr",
    "deserialize_fr",
    "write_to_file",
]
