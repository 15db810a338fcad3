"""Compressed reference clips written from a seed, for the port's decoder
tests and chip_smoke.py's reference-format phase: FLAC through
tests/flac_writer.py, mp3 through the port's test-only libmp3lame binding,
and Ogg Vorbis through libvorbisenc (ctypes; no runtime path encodes ogg).
Imports numpy alone, so chip_smoke.py can load it by path.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def _flac_writer():
    spec = importlib.util.spec_from_file_location("flac_writer", os.path.join(_HERE, "flac_writer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def have(*libs: str) -> bool:
    """Whether every shared library named loads here."""
    for lib in libs:
        try:
            ctypes.CDLL(lib)
        except OSError:
            return False
    return True


# the decoder and the encoder of each compressed format
MP3_LIBS = ("libmpg123.so.0", "libmp3lame.so.0")
OGG_LIBS = ("libvorbisfile.so.3", "libvorbisenc.so.2", "libvorbis.so.0", "libogg.so.0")


def write_flac(path: str, wav: np.ndarray, sr: int) -> None:
    """16-bit FLAC of the int16 PCM that `save_wav` writes for the same wave."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    with open(path, "wb") as f:
        f.write(_flac_writer().encode_flac(pcm, sr, 16))


def write_mp3(path: str, wav: np.ndarray, sr: int) -> None:
    from stabletts_torch.utils.codecs import encode_mp3

    encode_mp3(wav, sr, path)


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.c_void_p), ("bytes", ctypes.c_long), ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long), ("granulepos", ctypes.c_int64), ("packetno", ctypes.c_int64)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)), ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)), ("body_len", ctypes.c_long)]


def write_ogg(path: str, wav: np.ndarray, sr: int, quality: float = 0.6, chunk: int = 4096) -> None:
    """Mono Ogg Vorbis (VBR at `quality`) through libvorbisenc, as its
    encoder example does."""
    ogg, vorbis, venc = ctypes.CDLL("libogg.so.0"), ctypes.CDLL("libvorbis.so.0"), ctypes.CDLL("libvorbisenc.so.2")
    vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    # the library's state structs, opaque here: room to spare for each
    vi, vc, vd, vb, os_ = (ctypes.create_string_buffer(1 << 14) for _ in range(5))
    vorbis.vorbis_info_init(vi)
    if venc.vorbis_encode_init_vbr(vi, ctypes.c_long(1), ctypes.c_long(sr), ctypes.c_float(quality)) != 0:
        raise RuntimeError("vorbis_encode_init_vbr failed")
    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_, 1234)
    page, out = _OggPage(), bytearray()

    def drain(fn) -> None:
        while fn(os_, ctypes.byref(page)):
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    headers = [_OggPacket() for _ in range(3)]
    vorbis.vorbis_analysis_headerout(vd, vc, *(ctypes.byref(h) for h in headers))
    for h in headers:
        ogg.ogg_stream_packetin(os_, ctypes.byref(h))
    drain(ogg.ogg_stream_flush)
    samples = np.ascontiguousarray(wav, dtype=np.float32)
    packet = _OggPacket()
    for start in [*range(0, len(samples), chunk), len(samples)]:
        block = samples[start:start + chunk]
        if len(block):
            buf = vorbis.vorbis_analysis_buffer(vd, ctypes.c_int(len(block)))
            ctypes.memmove(buf[0], block.ctypes.data, block.nbytes)
        vorbis.vorbis_analysis_wrote(vd, ctypes.c_int(len(block)))  # 0 marks the end of the stream
        while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
            vorbis.vorbis_analysis(vb, None)
            vorbis.vorbis_bitrate_addblock(vb)
            while vorbis.vorbis_bitrate_flushpacket(vd, ctypes.byref(packet)):
                ogg.ogg_stream_packetin(os_, ctypes.byref(packet))
                drain(ogg.ogg_stream_pageout)
    drain(ogg.ogg_stream_flush)
    ogg.ogg_stream_clear(os_)
    vorbis.vorbis_block_clear(vb)
    vorbis.vorbis_dsp_clear(vd)
    vorbis.vorbis_comment_clear(vc)
    vorbis.vorbis_info_clear(vi)
    with open(path, "wb") as f:
        f.write(bytes(out))
