"""Tabix (.tbi) index builder and region query — pure Python, no htslib.

Implements the tabix index format (SAM spec appendix / tabix paper) over
BGZF-compressed, position-sorted TAB files, with the BED preset the
reference pipeline uses (`tabix -p bed`, modules/single_group/
4_generate_single_group_bed_files.nf:30): 0-based half-open coordinates in
columns 1/2/3.

The index is the standard UCSC 5-level binning scheme (bins of 512 Mb down
to 16 kb) plus a 16 kb linear index of minimal virtual offsets; the .tbi
file is itself BGZF-compressed. `query()` resolves a region through the
index exactly the way htslib does: candidate bins via reg2bins, chunks
filtered by the linear index, then a sequential scan from the smallest
surviving chunk start.

The port's own copy of hygeia_tpu/utils/tabix.py (struct and zlib only),
so that the port imports nothing of the JAX package; same bytes.
"""

from __future__ import annotations

import struct
import zlib

from hygeia_tpu_torch.utils.bgzf import BgzfReader, BgzfWriter

_TBI_MAGIC = b"TBI\x01"
# Preset flag for BED (0-based, half-open): TBX_UCSC in htslib.
_PRESET_BED = 0x10000
_COL_SEQ, _COL_BEG, _COL_END = 1, 2, 3
_META_CHAR = ord("#")
_LINEAR_SHIFT = 14  # 16 kb windows


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin fully containing [beg, end) (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int):
    """All bins overlapping [beg, end) (SAM spec section 5.3)."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def _iter_lines_with_voffsets(path):
    """Yield (voffset_of_line_start, line_bytes) over a BGZF text file."""
    with open(path, "rb") as fh:
        coffset = 0
        line_start_voffset = 0
        partial = b""
        while True:
            header = fh.read(18)
            if len(header) < 18:
                break
            if header[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError(f"not a BGZF block at offset {coffset}")
            bsize = struct.unpack("<H", header[16:18])[0] + 1
            rest = fh.read(bsize - 18)
            data = zlib.decompress(rest[:-8], -15)
            next_coffset = coffset + bsize
            if not data:  # EOF marker / empty block
                coffset = next_coffset
                continue
            pos = 0
            while True:
                nl = data.find(b"\n", pos)
                if nl < 0:
                    partial += data[pos:]
                    break
                yield line_start_voffset, partial + data[pos:nl]
                partial = b""
                pos = nl + 1
                if pos < len(data):
                    line_start_voffset = (coffset << 16) | pos
                else:
                    line_start_voffset = next_coffset << 16
            coffset = next_coffset
        if partial:
            yield line_start_voffset, partial


def build_index(bgzf_path, index_path=None):
    """Build a .tbi index (BED preset) for a position-sorted BGZF BED file."""
    index_path = index_path or bgzf_path + ".tbi"
    names = []  # ref names in order of first appearance
    per_ref_bins = []  # list of {bin: [[cnk_beg, cnk_end], ...]}
    per_ref_linear = []  # list of {window: min_voffset}
    cur = -1
    open_chunk = None  # the single chunk whose end awaits the next line start

    for voffset, line in _iter_lines_with_voffsets(bgzf_path):
        if not line or line[0] == _META_CHAR:
            continue
        # A chunk's end is the start of the line after its last record
        # (virtual offsets are not byte-contiguous across block boundaries,
        # so it can't be computed from the record itself).
        if open_chunk is not None:
            open_chunk[1] = voffset
        fields = line.split(b"\t")
        ref = fields[_COL_SEQ - 1].decode()
        beg = int(fields[_COL_BEG - 1])
        end = int(fields[_COL_END - 1])
        if not names or names[-1] != ref:
            if ref in names:
                raise ValueError(f"file not sorted: {ref} appears twice")
            names.append(ref)
            per_ref_bins.append({})
            per_ref_linear.append({})
            cur += 1
        b = reg2bin(beg, end)
        chunks = per_ref_bins[cur].setdefault(b, [])
        if chunks and chunks[-1][1] == voffset:
            open_chunk = chunks[-1]  # contiguous with this bin's last chunk
        else:
            open_chunk = [voffset, None]
            chunks.append(open_chunk)
        linear = per_ref_linear[cur]
        for w in range(
            beg >> _LINEAR_SHIFT, ((max(end, beg + 1) - 1) >> _LINEAR_SHIFT) + 1
        ):
            if w not in linear or voffset < linear[w]:
                linear[w] = voffset

    if open_chunk is not None:
        open_chunk[1] = _file_end_voffset(bgzf_path)

    with BgzfWriter(index_path) as out:
        name_blob = b"".join(n.encode() + b"\x00" for n in names)
        out.write(_TBI_MAGIC)
        out.write(
            struct.pack(
                "<8i",
                len(names),
                _PRESET_BED,
                _COL_SEQ,
                _COL_BEG,
                _COL_END,
                _META_CHAR,
                0,  # skip
                len(name_blob),
            )
        )
        out.write(name_blob)
        for bins, linear in zip(per_ref_bins, per_ref_linear):
            out.write(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = bins[b]
                out.write(struct.pack("<Ii", b, len(chunks)))
                for cnk_beg, cnk_end in chunks:
                    out.write(struct.pack("<QQ", cnk_beg, cnk_end))
            n_intv = max(linear) + 1 if linear else 0
            out.write(struct.pack("<i", n_intv))
            filled = []
            last = 0
            for w in range(n_intv):
                last = linear.get(w, last)
                filled.append(last)
            out.write(struct.pack(f"<{n_intv}Q", *filled))
    return index_path


def _file_end_voffset(path):
    import os

    from hygeia_tpu_torch.utils.bgzf import EOF_MARKER

    size = os.path.getsize(path)
    return (size - len(EOF_MARKER)) << 16


class TabixFile:
    """Region queries over a BGZF file through its .tbi index."""

    def __init__(self, bgzf_path, index_path=None):
        self.path = bgzf_path
        self._load_index(index_path or bgzf_path + ".tbi")

    def _load_index(self, index_path):
        blob = _read_all_bgzf(index_path)
        if blob[:4] != _TBI_MAGIC:
            raise ValueError("not a tabix index")
        (n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm) = struct.unpack(
            "<8i", blob[4:36]
        )
        self.preset = fmt
        self.col_seq, self.col_beg, self.col_end = col_seq, col_beg, col_end
        names = blob[36 : 36 + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        off = 36 + l_nm
        self.bins = []
        self.linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack("<i", blob[off : off + 4])
            off += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack("<Ii", blob[off : off + 8])
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack("<QQ", blob[off : off + 16])
                    off += 16
                    chunks.append((beg, end))
                bins[b] = chunks
            (n_intv,) = struct.unpack("<i", blob[off : off + 4])
            off += 4
            ioff = struct.unpack(f"<{n_intv}Q", blob[off : off + 8 * n_intv])
            off += 8 * n_intv
            self.bins.append(bins)
            self.linear.append(list(ioff))

    def query(self, ref, beg, end):
        """Yield decoded lines overlapping [beg, end) on `ref` (0-based)."""
        if ref not in self.names:
            return
        rid = self.names.index(ref)
        bins = self.bins[rid]
        linear = self.linear[rid]
        w = beg >> _LINEAR_SHIFT
        min_ioff = linear[min(w, len(linear) - 1)] if linear else 0
        chunks = []
        for b in reg2bins(beg, end):
            for cnk_beg, cnk_end in bins.get(b, ()):
                if cnk_end > min_ioff:
                    chunks.append((max(cnk_beg, min_ioff), cnk_end))
        if not chunks:
            return
        start = min(c[0] for c in chunks)
        with BgzfReader(self.path) as reader:
            for line in reader.read_from(start):
                if not line or line[0:1] == b"#":
                    continue
                fields = line.split(b"\t")
                if fields[self.col_seq - 1].decode() != ref:
                    break  # sorted file: past this reference
                rbeg = int(fields[self.col_beg - 1])
                rend = int(fields[self.col_end - 1])
                if rbeg >= end:
                    break  # sorted by beg: nothing further overlaps
                if rend > beg:
                    yield line.decode()


def _read_all_bgzf(path):
    out = bytearray()
    with open(path, "rb") as fh:
        while True:
            header = fh.read(18)
            if len(header) < 18:
                break
            bsize = struct.unpack("<H", header[16:18])[0] + 1
            rest = fh.read(bsize - 18)
            out.extend(zlib.decompress(rest[:-8], -15))
    return bytes(out)
