"""Pure-Python FLAC decoder — fallback for environments without g++.

Primary decode path is native/flac.cpp (same algorithm, ~100x faster); this
module exists so FLAC corpora (e.g. the HiFi-TTS recipe, reference:
recipes/hifi_tts.py) remain loadable with zero native toolchain. Written from
the public FLAC format spec (RFC 9639); supports all subframe types
(constant / verbatim / fixed / LPC), both Rice methods incl. escape
partitions, all channel assignments, and wasted bits. Returns channel 0 to
match the reference's mono conversion (reference: utils/audio.py:68-69).
"""

from __future__ import annotations

import numpy as np

_BLOCK_SIZES = [0, 192, 576, 1152, 2304, 4608, 0, 0,
                256, 512, 1024, 2048, 4096, 8192, 16384, 32768]


class _Bits:
    __slots__ = ("data", "pos", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.n = len(data) * 8

    def read(self, nbits: int) -> int:
        if self.pos + nbits > self.n:
            raise EOFError
        end = self.pos + nbits
        # gather the bytes covering [pos, end)
        b0, b1 = self.pos >> 3, (end + 7) >> 3
        chunk = int.from_bytes(self.data[b0:b1], "big")
        v = (chunk >> ((b1 - b0) * 8 - (end - b0 * 8))) & ((1 << nbits) - 1)
        self.pos = end
        return v

    def sread(self, nbits: int) -> int:
        v = self.read(nbits)
        sign = 1 << (nbits - 1)
        return (v ^ sign) - sign

    def unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
            if q > 1 << 24:
                raise EOFError
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def eof(self) -> bool:
        return self.pos >= self.n


def _coded_number(br: _Bits) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    for mask, val, ne in ((0xE0, 0xC0, 1), (0xF0, 0xE0, 2), (0xF8, 0xF0, 3),
                          (0xFC, 0xF8, 4), (0xFE, 0xFC, 5), (0xFF, 0xFE, 6)):
        if (b0 & mask) == val:
            v = b0 & (0xFF >> (ne + 2)) if ne < 6 else 0
            n_extra = ne
            break
    else:
        raise ValueError("bad coded number")
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("bad coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _residual(br: _Bits, block_size: int, order: int, out: list) -> None:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual method")
    param_bits, escape = (4, 0x0F) if method == 0 else (5, 0x1F)
    part_order = br.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError("bad partition order")
    part_len = block_size >> part_order
    idx = order
    for p in range(n_parts):
        n = part_len - order if p == 0 else part_len
        if n < 0:
            raise ValueError("bad partition length")
        param = br.read(param_bits)
        if param == escape:
            raw = br.read(5)
            for _ in range(n):
                out[idx] = br.sread(raw) if raw else 0
                idx += 1
        else:
            for _ in range(n):
                q = br.unary()
                u = (q << param) | br.read(param)
                out[idx] = (u >> 1) ^ -(u & 1)
                idx += 1


def _subframe(br: _Bits, block_size: int, bps: int) -> list:
    if br.read(1):
        raise ValueError("bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.unary()
    ebps = bps - wasted
    out = [0] * block_size
    if stype == 0:  # constant
        v = br.sread(ebps)
        out = [v] * block_size
    elif stype == 1:  # verbatim
        out = [br.sread(ebps) for _ in range(block_size)]
    elif 8 <= stype <= 12:  # fixed predictor
        order = stype - 8
        for i in range(order):
            out[i] = br.sread(ebps)
        _residual(br, block_size, order, out)
        if order == 1:
            for i in range(1, block_size):
                out[i] += out[i - 1]
        elif order == 2:
            for i in range(2, block_size):
                out[i] += 2 * out[i - 1] - out[i - 2]
        elif order == 3:
            for i in range(3, block_size):
                out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]
        elif order == 4:
            for i in range(4, block_size):
                out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]
    elif stype >= 32:  # LPC
        order = (stype & 0x1F) + 1
        for i in range(order):
            out[i] = br.sread(ebps)
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = br.sread(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coef = [br.sread(precision) for _ in range(order)]
        _residual(br, block_size, order, out)
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coef[j] * out[i - 1 - j]
            out[i] += acc >> shift
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out = [v << wasted for v in out]
    return out


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decodes a FLAC stream → (mono float32 channel 0 in [-1, 1], sample_rate)."""
    br = _Bits(data)
    if br.read(32) != 0x664C6143:  # "fLaC"
        raise ValueError("not a FLAC stream")
    sample_rate = channels = bps = 0
    total = 0
    last = False
    while not last:
        last = bool(br.read(1))
        btype = br.read(7)
        blen = br.read(24)
        if btype == 0 and blen >= 34:  # STREAMINFO
            br.read(16), br.read(16), br.read(24), br.read(24)
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            br.pos += (blen - 18) * 8  # md5 (16 bytes) + any trailing extension
        else:
            br.pos += blen * 8
    if not sample_rate:
        raise ValueError("missing STREAMINFO")
    out = np.zeros(total if total else 0, dtype=np.float32)
    grow = total == 0
    written = 0
    while not br.eof():
        br.align()
        try:
            if br.read(14) != 0x3FFE:
                break
            br.read(2)  # reserved + blocking strategy
            bs_code = br.read(4)
            sr_code = br.read(4)
            ch_code = br.read(4)
            ss_code = br.read(3)
            br.read(1)
            _coded_number(br)
            if bs_code == 6:
                block_size = br.read(8) + 1
            elif bs_code == 7:
                block_size = br.read(16) + 1
            else:
                block_size = _BLOCK_SIZES[bs_code]
            if sr_code == 12:
                br.read(8)
            elif sr_code in (13, 14):
                br.read(16)
            frame_bps = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(ss_code, bps)
            br.read(8)  # CRC8
            if ch_code < 8:
                n_ch, assign = ch_code + 1, "indep"
            elif ch_code == 8:
                n_ch, assign = 2, "left_side"
            elif ch_code == 9:
                n_ch, assign = 2, "right_side"
            elif ch_code == 10:
                n_ch, assign = 2, "mid_side"
            else:
                break
            if n_ch != channels or block_size == 0:
                break
            chans = []
            for c in range(n_ch):
                sub_bps = frame_bps
                if (assign == "left_side" and c == 1) or \
                   (assign == "right_side" and c == 0) or \
                   (assign == "mid_side" and c == 1):
                    sub_bps += 1
                chans.append(_subframe(br, block_size, sub_bps))
            br.align()
            br.read(16)  # CRC16
        except (EOFError, ValueError):
            break
        if assign == "right_side":
            left = [s + r for s, r in zip(chans[0], chans[1])]
        elif assign == "mid_side":
            left = [(((m << 1) | (s & 1)) + s) >> 1 for m, s in zip(chans[0], chans[1])]
        else:  # indep / left_side both store left in channel 0
            left = chans[0]
        block = np.asarray(left, dtype=np.float64) / float(1 << (frame_bps - 1))
        if grow:
            out = np.concatenate([out, block.astype(np.float32)])
            written = out.shape[0]
        else:
            n = min(block_size, out.shape[0] - written)
            if n <= 0:
                break
            out[written:written + n] = block[:n]
            written += n
            if written >= out.shape[0]:
                break
    if written == 0:
        raise ValueError("no FLAC frames decoded")
    return out[:written], int(sample_rate)
