"""BGZF (blocked gzip) writer/reader — pure Python, no htslib.

The reference pipeline compresses BED9 tracks with `bgzip` and indexes them
with `tabix -p bed` (modules/single_group/4_generate_single_group_bed_files
.nf:24-30). Neither binary ships in this environment, so this module
implements the BGZF container format itself (as specified in the SAM/BAM
spec, section 4.1): a series of standalone gzip members, each at most 64 KiB
of compressed data, carrying the compressed block size in a "BC" gzip extra
subfield so readers can hop block-to-block without inflating. Files written
here are valid multi-member gzip streams (readable by `gzip`/`zcat`/Python's
gzip module) AND random-accessible via the virtual file offsets tabix needs.

Virtual file offset convention (used by tabix/BAM indexes):
    voffset = (compressed_block_start << 16) | offset_within_inflated_block

The port's own copy of hygeia_tpu/utils/bgzf.py (struct and zlib only),
so that the port imports nothing of the JAX package; same bytes.
"""

from __future__ import annotations

import struct
import zlib

# Maximum bytes of UNCOMPRESSED payload per block. htslib uses 0xff00 so even
# incompressible data fits the 16-bit BSIZE field after deflate overhead.
MAX_BLOCK_SIZE = 0xFF00

# The canonical 28-byte BGZF EOF marker: an empty block (SAM spec section
# 4.1.2); its presence distinguishes a complete file from a truncated one.
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _compress_block(data: bytes) -> bytes:
    """One complete BGZF block (gzip member with the BC/BSIZE extra field)."""
    deflater = zlib.compressobj(6, zlib.DEFLATED, -15)  # raw deflate
    payload = deflater.compress(data) + deflater.flush()
    # BSIZE stores (total block size - 1); total = header(18) + payload + trailer(8).
    bsize = len(payload) + 18 + 8 - 1
    if bsize >= 1 << 16:
        raise ValueError("BGZF block overflow (incompressible oversize input)")
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 0x08, 0x04,  # magic, DEFLATE, FLG.FEXTRA
        0,  # MTIME
        0, 0xFF,  # XFL, OS=unknown
        6,  # XLEN
        0x42, 0x43, 2,  # SI1='B', SI2='C', SLEN=2
        bsize,  # BSIZE - 1 (total block size minus 1)
    )
    trailer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + payload + trailer


class BgzfWriter:
    """Buffered BGZF writer tracking virtual file offsets.

    `tell_virtual()` returns the voffset of the NEXT byte written — call it
    before/after writing a record to get the (beg, end) chunk the tabix index
    stores.
    """

    def __init__(self, path):
        self._fh = open(path, "wb")
        self._buffer = bytearray()
        self._block_start = 0  # compressed offset of the block being filled

    def tell_virtual(self) -> int:
        return (self._block_start << 16) | len(self._buffer)

    def write(self, data: bytes) -> None:
        self._buffer.extend(data)
        while len(self._buffer) >= MAX_BLOCK_SIZE:
            self._flush_block(self._buffer[:MAX_BLOCK_SIZE])
            del self._buffer[:MAX_BLOCK_SIZE]

    def _flush_block(self, data) -> None:
        block = _compress_block(bytes(data))
        self._fh.write(block)
        self._block_start += len(block)

    def close(self) -> None:
        if self._fh is None:
            return
        if self._buffer:
            self._flush_block(self._buffer)
            self._buffer.clear()
        self._fh.write(EOF_MARKER)
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress_file(src_path, dst_path=None, *, delete_src=False):
    """bgzip-compress an existing file (the `bgzip file` CLI behaviour)."""
    import os

    dst_path = dst_path or src_path + ".gz"
    with open(src_path, "rb") as src, BgzfWriter(dst_path) as dst:
        while True:
            chunk = src.read(1 << 20)
            if not chunk:
                break
            dst.write(chunk)
    if delete_src:
        os.remove(src_path)
    return dst_path


class BgzfReader:
    """Random-access BGZF reader (enough for tabix region queries).

    Blocks are inflated on demand and memoised by compressed offset; tabix
    queries touch a handful of blocks so the cache stays small.
    """

    def __init__(self, path):
        self._fh = open(path, "rb")
        self._cache = {}

    def _read_block(self, coffset: int):
        cached = self._cache.get(coffset)
        if cached is not None:
            return cached
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) < 18 or header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"not a BGZF block at offset {coffset}")
        bsize = struct.unpack("<H", header[16:18])[0] + 1
        rest = self._fh.read(bsize - 18)
        payload = rest[:-8]
        data = zlib.decompress(payload, -15)
        self._cache[coffset] = (data, coffset + bsize)
        return data, coffset + bsize

    def read_from(self, voffset: int):
        """Yield lines (bytes, newline-stripped) starting at a virtual offset."""
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        partial = b""
        while True:
            try:
                data, next_coffset = self._read_block(coffset)
            except ValueError:
                break
            if not data:  # EOF marker block
                break
            chunk = data[uoffset:]
            uoffset = 0
            lines = (partial + chunk).split(b"\n")
            partial = lines.pop()
            # Virtual offset of the start of each yielded line: needed by the
            # index builder; queries ignore it.
            for line in lines:
                yield line
            coffset = next_coffset
        if partial:
            yield partial

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
