"""A plain decoder of Zstandard frames (RFC 8878), in Python.

The JAX package's orbax checkpoints hold zarr chunks and OCDBT B-tree nodes
compressed as zstd frames; the standard library has no zstd, and neither
this package nor the card's machine may count on the ``zstandard``
package.  This module is the plain version of ``csrc/zstd_decode.cc``,
the native decoder that ``train/ocdbt.py`` calls: the tests hold the two
against each other and against ``zstandard``.  It is written for clarity,
not speed (about 1 MB/s).

It decodes every frame the format allows without a dictionary: raw, RLE
and compressed blocks; raw, RLE, Huffman-coded (one or four streams) and
treeless literals; sequences whose literal-length, offset and match-length
codes use the predefined, RLE, FSE-compressed or repeated tables; the
three repeat offsets; matches reaching into earlier blocks of the frame;
skippable frames; and the content checksum (the low 32 bits of XXH64,
:func:`xxh64`).  A frame that asks for a dictionary, or that is corrupt,
raises :class:`ZstdError` naming the byte offset in the input where
decoding failed.
"""

from __future__ import annotations

MAGIC = 0xFD2FB528
_SKIPPABLE_LO, _SKIPPABLE_HI = 0x184D2A50, 0x184D2A5F
BLOCK_MAX = 128 * 1024
_MASK64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


class ZstdError(ValueError):
    """A frame the decoder refuses; ``offset`` is the input byte where it
    failed."""

    def __init__(self, offset: int, reason: str):
        self.offset = offset
        super().__init__(f"zstd: corrupt or unsupported frame at byte {offset}: {reason}")


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _MASK64, 31) * _P1) & _MASK64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the hash zstd's content checksum truncates)."""
    data = memoryview(bytes(data))
    n, pos = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _MASK64, (seed + _P2) & _MASK64, seed & _MASK64,
             (seed - _P1) & _MASK64]
        lanes = memoryview(data[:n - n % 32]).cast("Q")
        for i in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[i + j]) for j in range(4)]
        pos = n - n % 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _MASK64
        for lane in v:
            h = (((h ^ _round(0, lane)) * _P1) + _P4) & _MASK64
    else:
        h = (seed + _P5) & _MASK64
    h = (h + n) & _MASK64
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _MASK64
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos:pos + 4], "little") * _P1) & _MASK64
        h = (_rotl(h, 23) * _P2 + _P3) & _MASK64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _MASK64
        h = (_rotl(h, 11) * _P1) & _MASK64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _MASK64
    h ^= h >> 29
    h = (h * _P3) & _MASK64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# bit streams
# ---------------------------------------------------------------------------


class _Backward:
    """A backward bit stream (RFC 8878 §4.1): read from the last byte down,
    most significant bit first, after the last byte's highest set bit.
    Reads past the start give zeros and count as overflow."""

    def __init__(self, data: bytes, offset: int):
        if not data or data[-1] == 0:
            raise ZstdError(offset + len(data) - 1, "bit stream without its end mark")
        # the read order is the binary digits of the stream as a
        # little-endian integer, after its leading 1 (the end mark)
        self.bits = format(int.from_bytes(data, "little"), "b")[1:]
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        chunk = self.bits[self.pos:self.pos + n]
        self.pos += n
        if len(chunk) < n:
            chunk = chunk.ljust(n, "0")
        return int(chunk, 2)

    def overflowed(self) -> bool:
        return self.pos > len(self.bits)

    def done(self) -> bool:
        return self.pos == len(self.bits)


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int, offset: int):
    """An FSE table description at ``data[pos:]`` (RFC 8878 §4.1.1):
    returns (normalized counts, accuracy log, bytes read)."""
    value = int.from_bytes(data[pos:pos + 512], "little")
    bit = 0

    def take(n):
        nonlocal bit
        v = (value >> bit) & ((1 << n) - 1)
        bit += n
        return v

    log = take(4) + 5
    if log > max_log:
        raise ZstdError(offset + pos, f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: list[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = len(counts)
            while True:
                flag = take(2)
                n0 += flag
                if flag != 3:
                    break
            if n0 > max_symbol + 1:
                raise ZstdError(offset + pos + bit // 8, "FSE zero run past the last symbol")
            counts.extend([0] * (n0 - len(counts)))
            if len(counts) > max_symbol:
                break
        mx = (2 * threshold - 1) - remaining
        low = (value >> bit) & (threshold - 1)
        if low < mx:
            count = low
            bit += nbits - 1
        else:
            count = (value >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1 or bit > 8 * 512:
        raise ZstdError(offset + pos, "FSE table description does not sum to its size")
    size = (bit + 7) // 8
    if pos + size > len(data):
        raise ZstdError(offset + len(data), "FSE table description past the end of the block")
    return counts, log, size


def _fse_table(counts: list[int], log: int) -> list[tuple[int, int, int]]:
    """Decoding table of (symbol, bits, baseline) per state (§4.1.1)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ValueError("FSE spread did not return to 0")
    table = []
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


class _State:
    def __init__(self, table, stream: _Backward):
        self.table = table
        self.log = (len(table) - 1).bit_length()
        self.state = stream.read(self.log)

    def symbol(self) -> int:
        return self.table[self.state][0]

    def update(self, stream: _Backward) -> None:
        _, nb, base = self.table[self.state]
        self.state = base + stream.read(nb)


# predefined distributions (§3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
#: (max symbol, max accuracy log) of the literal-length, offset and match-length codes
_LIMITS = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}
_DEFAULTS = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT, "ml": _ML_DEFAULT}


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------


def _huffman_table(weights: list[int], offset: int):
    """(table indexed by the next max_bits bits -> (symbol, bits), max_bits)
    from the decoded weights, the last weight implied (§4.2.1)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError(offset, "Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError(offset, "Huffman weights leave no power of two for the last symbol")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        raise ZstdError(offset, f"Huffman codes of {max_bits} bits (at most 11)")
    rank_count = [0] * (max_bits + 1)
    for w in weights:
        if w > max_bits:
            raise ZstdError(offset, "Huffman weight above the maximum code length")
        rank_count[w] += 1
    start, nxt = [0] * (max_bits + 1), 0
    for w in range(1, max_bits + 1):
        start[w] = nxt
        nxt += rank_count[w] << (w - 1)
    table = [(0, 0)] * (1 << max_bits)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            table[start[w]:start[w] + n] = [(s, max_bits + 1 - w)] * n
            start[w] += n
    return table, max_bits


def _read_huffman_tree(data: bytes, pos: int, end: int, offset: int):
    """A Huffman tree description at ``data[pos:end]``: (table, bytes read)."""
    if pos >= end:
        raise ZstdError(offset + pos, "Huffman tree description missing")
    header = data[pos]
    if header >= 128:  # weights as 4-bit fields
        n = header - 127
        size = 1 + (n + 1) // 2
        if pos + size > end:
            raise ZstdError(offset + pos, "Huffman weights past the literals section")
        weights = []
        for i in range(n):
            byte = data[pos + 1 + i // 2]
            weights.append(byte >> 4 if i % 2 == 0 else byte & 15)
    else:  # FSE-compressed weights, two interleaved states
        size = 1 + header
        if pos + size > end:
            raise ZstdError(offset + pos, "Huffman weights past the literals section")
        counts, log, used = _read_ncount(data[:pos + size], pos + 1, 255, 6, offset)
        table = _fse_table(counts, log)
        stream = _Backward(data[pos + 1 + used:pos + size], offset + pos + 1 + used)
        s1, s2 = _State(table, stream), _State(table, stream)
        weights = []
        while True:
            for a, b in ((s1, s2), (s2, s1)):
                weights.append(a.symbol())
                a.update(stream)
                if stream.overflowed():
                    weights.append(b.symbol())
                    break
                if len(weights) > 255:
                    raise ZstdError(offset + pos, "more than 255 Huffman weights")
            else:
                continue
            break
    return _huffman_table(weights, offset + pos), size


def _huffman_stream(data: bytes, offset: int, table, max_bits: int, count: int) -> bytes:
    stream = _Backward(data, offset)
    out = bytearray(count)
    bits, pos = stream.bits, 0
    for i in range(count):
        s, nb = table[int(bits[pos:pos + max_bits].ljust(max_bits, "0"), 2)]
        out[i] = s
        pos += nb
    if pos != len(bits):
        raise ZstdError(offset, "Huffman stream not consumed exactly")
    return bytes(out)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _FrameState, offset: int):
    """The literals section at ``data[pos:end]``: (literals, next pos)."""
    if pos >= end:
        raise ZstdError(offset + pos, "literals section missing")
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, hl = b0 >> 3, 1
        elif fmt == 1:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        pos += hl
        if kind == 0:
            if pos + size > end:
                raise ZstdError(offset + pos, "raw literals past the end of the block")
            return data[pos:pos + size], pos + size
        if pos >= end:
            raise ZstdError(offset + pos, "RLE literals byte missing")
        return bytes([data[pos]]) * size, pos + 1
    hl = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + hl > end:
        raise ZstdError(offset + pos, "literals header past the end of the block")
    h = int.from_bytes(data[pos:pos + hl], "little")
    bits = {0: 10, 1: 10, 2: 14, 3: 18}[fmt]
    size = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    pos += hl
    if pos + csize > end:
        raise ZstdError(offset + pos, "compressed literals past the end of the block")
    if size > BLOCK_MAX:
        raise ZstdError(offset + pos, f"{size} literals in one block")
    lit_end = pos + csize
    if kind == 2:
        st.huffman, used = _read_huffman_tree(data, pos, lit_end, offset)
        pos += used
    elif st.huffman is None:
        raise ZstdError(offset + pos, "treeless literals with no earlier Huffman tree")
    table, max_bits = st.huffman
    if streams == 1:
        return _huffman_stream(data[pos:lit_end], offset + pos, table, max_bits, size), lit_end
    if pos + 6 > lit_end:
        raise ZstdError(offset + pos, "literals jump table past the end")
    sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
    pos += 6
    sizes.append(lit_end - pos - sum(sizes))
    if sizes[3] < 0:
        raise ZstdError(offset + pos, "literals jump table beyond the streams")
    seg = (size + 3) // 4
    counts = [seg, seg, seg, size - 3 * seg]
    if counts[3] < 0:
        raise ZstdError(offset + pos, "literal count too small for four streams")
    out = []
    for n_bytes, count in zip(sizes, counts):
        out.append(_huffman_stream(data[pos:pos + n_bytes], offset + pos, table, max_bits,
                                   count))
        pos += n_bytes
    return b"".join(out), lit_end


def _sequence_table(name: str, mode: int, data: bytes, pos: int, st: _FrameState,
                    offset: int) -> int:
    max_symbol, max_log = _LIMITS[name]
    if mode == 0:
        st.tables[name] = _fse_table(*_DEFAULTS[name])
    elif mode == 1:
        if data[pos] > max_symbol:
            raise ZstdError(offset + pos, f"RLE {name} code {data[pos]} above {max_symbol}")
        st.tables[name] = [(data[pos], 0, 0)]
        return pos + 1
    elif mode == 2:
        counts, log, used = _read_ncount(data, pos, max_symbol, max_log, offset)
        st.tables[name] = _fse_table(counts, log)
        return pos + used
    elif st.tables[name] is None:
        raise ZstdError(offset + pos, f"repeated {name} table with none before it")
    return pos


def _block(data: bytes, pos: int, end: int, out: bytearray, frame_start: int,
           st: _FrameState, offset: int) -> None:
    """One compressed block ``data[pos:end]`` appended to ``out``."""
    lits, pos = _literals(data, pos, end, st, offset)
    if pos >= end:
        raise ZstdError(offset + pos, "sequences section missing")
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            raise ZstdError(offset + pos, "sequence count past the end of the block")
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            raise ZstdError(offset + pos, "sequence count past the end of the block")
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    start_len = len(out)
    if nseq == 0:
        if pos != end:
            raise ZstdError(offset + pos, "bytes after a block with no sequences")
        out += lits
        return
    if pos >= end:
        raise ZstdError(offset + pos, "sequence modes missing")
    modes = data[pos]
    if modes & 3:
        raise ZstdError(offset + pos, "reserved bits of the sequence modes set")
    pos += 1
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _sequence_table(name, (modes >> shift) & 3, data[:end], pos, st, offset)
    if pos >= end:
        raise ZstdError(offset + pos, "sequence bit stream missing")
    stream = _Backward(data[pos:end], offset + pos)
    ll, of, ml = (_State(st.tables[n], stream) for n in ("ll", "of", "ml"))
    rep = st.rep
    lit_pos = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of.symbol(), ml.symbol(), ll.symbol()
        if ml_code > 52 or ll_code > 35:
            raise ZstdError(offset + pos, "sequence code out of range")
        offset_value = (1 << of_code) + stream.read(of_code)
        match = _ML_BASE[ml_code] + stream.read(_ML_BITS[ml_code])
        lit_len = _LL_BASE[ll_code] + stream.read(_LL_BITS[ll_code])
        if offset_value > 3:
            dist = offset_value - 3
            rep[:] = [dist, rep[0], rep[1]]
        else:
            idx = offset_value + (lit_len == 0)
            if idx == 1:
                dist = rep[0]
            elif idx == 2:
                dist = rep[1]
                rep[:] = [rep[1], rep[0], rep[2]]
            elif idx == 3:
                dist = rep[2]
                rep[:] = [rep[2], rep[0], rep[1]]
            else:
                dist = rep[0] - 1
                rep[:] = [dist, rep[0], rep[1]]
        if i + 1 < nseq:
            ll.update(stream)
            ml.update(stream)
            of.update(stream)
        if stream.overflowed():
            raise ZstdError(offset + pos, "sequence bit stream overrun")
        if lit_pos + lit_len > len(lits):
            raise ZstdError(offset + pos, "a sequence takes more literals than the block has")
        out += lits[lit_pos:lit_pos + lit_len]
        lit_pos += lit_len
        if dist <= 0 or dist > len(out) - frame_start:
            raise ZstdError(offset + pos, f"match offset {dist} outside the frame's output")
        if dist >= match:
            out += out[len(out) - dist:len(out) - dist + match]
        else:
            pattern = bytes(out[len(out) - dist:])
            out += (pattern * (match // dist + 1))[:match]
    if not stream.done():
        raise ZstdError(offset + pos, "sequence bit stream not consumed exactly")
    out += lits[lit_pos:]
    if len(out) - start_len > BLOCK_MAX:
        raise ZstdError(offset + pos, "block decodes to more than 128 KiB")


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """The frame at ``data[pos:]`` (after its magic) appended to ``out``;
    returns the position after it."""
    if pos >= len(data):
        raise ZstdError(pos, "frame header missing")
    fhd = data[pos]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError(pos, "reserved bit of the frame header set")
    pos += 1
    window = None
    if not single:
        wd = data[pos]
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
        pos += 1
    dict_size = (0, 1, 2, 4)[dict_flag]
    if dict_size and int.from_bytes(data[pos:pos + dict_size], "little"):
        raise ZstdError(pos, "frame needs a dictionary")
    pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        if pos + fcs_size > len(data):
            raise ZstdError(pos, "frame content size past the end of the input")
        content = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2
                                                                        else 0)
        pos += fcs_size
    if window is None:
        window = content
    block_max = min(window, BLOCK_MAX)
    start = len(out)
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError(pos, "block header past the end of the input")
        h = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        pos += 3
        if kind == 3:
            raise ZstdError(pos - 3, "reserved block type")
        if kind == 1:
            if pos >= len(data):
                raise ZstdError(pos, "RLE block byte missing")
            if size > block_max:
                raise ZstdError(pos - 3, f"RLE block of {size} bytes above {block_max}")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if size > block_max or pos + size > len(data):
                raise ZstdError(pos - 3, f"block of {size} bytes past the input or above "
                                f"{block_max}")
            if kind == 0:
                out += data[pos:pos + size]
            else:
                _block(data, pos, pos + size, out, start, st, 0)
            pos += size
        if last:
            break
    if content is not None and len(out) - start != content:
        raise ZstdError(pos, f"frame decodes to {len(out) - start} bytes, its header says "
                        f"{content}")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError(pos, "content checksum past the end of the input")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError(pos, "content checksum mismatch")
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """The concatenated content of every frame in ``data`` (skippable
    frames skipped)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    if not data:
        raise ZstdError(0, "no frame")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError(pos, "truncated magic number")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if _SKIPPABLE_LO <= magic <= _SKIPPABLE_HI:
            if pos + 8 > len(data):
                raise ZstdError(pos, "truncated skippable frame")
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos + 8 + size > len(data):
                raise ZstdError(pos, "skippable frame past the end of the input")
            pos += 8 + size
            continue
        if magic != MAGIC:
            raise ZstdError(pos, f"bad magic number {magic:#010x}")
        try:
            pos = _frame(data, pos + 4, out)
        except IndexError as e:  # a field read past the end of the input
            raise ZstdError(len(data), f"input ends inside a frame ({e})") from None
    return bytes(out)
