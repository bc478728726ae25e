from .api import (
    ShardedEngine,
    compress_device_sharded,
    compress_device_sharded_gathered,
    compress_sharded,
    decompress_sharded,
)
from .sharding import (
    make_mesh,
    assemble_frame_sharded,
    encode_segments_sharded,
    encode_superblocks_sharded,
    decode_slabs_sharded,
    ragged_traffic_model,
    sharded_compress_step,
)

__all__ = [
    "make_mesh",
    "ShardedEngine",
    "assemble_frame_sharded",
    "compress_device_sharded",
    "compress_device_sharded_gathered",
    "compress_sharded",
    "decompress_sharded",
    "encode_segments_sharded",
    "encode_superblocks_sharded",
    "decode_slabs_sharded",
    "ragged_traffic_model",
    "sharded_compress_step",
]
