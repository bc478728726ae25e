"""Device entropy stage: RFC 8878 (zstd) frame encoder.

The reference delegates its entropy stage to libzstd (zstd_wrapper.h); this
package reimplements the encoder for the device (SURVEY.md §7 step 4):
Huffman table construction and tree serialization are per-superblock host
metadata (tiny), while the bulk bitstream encoding runs on the device
(huff_device.py). Output is
standard zstd — validated by cross-decoding with libzstd — so frames remain
decodable by the C++ reference.

Phasing (SURVEY.md §7): huffman-literals-only frames first (this package),
FSE sequence modeling later. Clean-room from the RFC; no libzstd code.
"""

from .zstd_frame import encode_frame_host  # noqa: F401
