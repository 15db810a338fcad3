"""Compressed-audio codecs via the system codec libraries (ctypes).

The reference loads mp3/ogg prompt audio through torchaudio, which wraps
the system's ffmpeg codecs (reference: utils/audio.py:59-74 `torchaudio.load`).
This module takes the same engineering position one layer lower: bind the
canonical system decoders directly — libmpg123 for MPEG-1/2 Layer III and
libvorbisfile for Ogg Vorbis — with no Python-level dependency. WAV and
FLAC have from-scratch decoders elsewhere (utils/flac_py.py, native/flac.cpp);
for the patent-era perceptual codecs the system library IS the reference
implementation, and shipping a half-correct Huffman re-derivation would be
worse engineering than binding the canonical one.

A libmp3lame binding (`encode_mp3`) is provided for the test suite so
round-trip fixtures can be synthesized on the fly; it is not used by any
runtime path.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np


def _load(*names: str) -> Optional[ctypes.CDLL]:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".")[0].replace("lib", ""))
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            pass
    return None


# --- mpg123 (MPEG-1/2 Layer I/II/III decode) --------------------------------

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0  # mpg123.h: MPG123_ENC_SIGNED_16

_mpg123 = None
_mpg123_ready = False


def _get_mpg123():
    global _mpg123, _mpg123_ready
    if _mpg123 is None:
        lib = _load("libmpg123.so.0", "libmpg123.so")
        if lib is None:
            raise RuntimeError(
                "mp3 decoding needs libmpg123 (not found on this system); "
                "convert the file to WAV/FLAC offline"
            )
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _mpg123 = lib
    if not _mpg123_ready:
        _mpg123.mpg123_init()
        _mpg123_ready = True
    return _mpg123


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an mp3 file -> (float32 [-1,1] waveform [T, C], sample_rate)."""
    lib = _get_mpg123()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (err={err.value})")
    try:
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123 cannot open {path!r}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        ) != _MPG123_OK:
            raise RuntimeError(f"mpg123 cannot read format of {path!r}")
        # pin the output format to s16 at the stream's native rate/channels
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_SIGNED_16)
        chunks = []
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise RuntimeError(f"mpg123_read error {rc} on {path!r}")
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
        wav = pcm.astype(np.float32) / 32768.0
        if channels.value > 1:
            wav = wav.reshape(-1, channels.value)
        else:
            wav = wav[:, None]
        return wav, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# --- vorbisfile (Ogg Vorbis decode) -----------------------------------------

_vorbisfile = None


class _VorbisInfo(ctypes.Structure):
    # leading fields of vorbis_info (codec.h); only channels/rate are read
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


def _get_vorbisfile():
    global _vorbisfile
    if _vorbisfile is None:
        lib = _load("libvorbisfile.so.3", "libvorbisfile.so")
        if lib is None:
            raise RuntimeError(
                "ogg decoding needs libvorbisfile (not found on this system); "
                "convert the file to WAV/FLAC offline"
            )
        lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ov_clear.argtypes = [ctypes.c_void_p]
        _vorbisfile = lib
    return _vorbisfile


def decode_ogg(path: str) -> tuple[np.ndarray, int]:
    """Decode an ogg/vorbis file -> (float32 [T, C] waveform, sample_rate)."""
    lib = _get_vorbisfile()
    # OggVorbis_File is ~944 bytes; allocate with headroom (opaque to us)
    vf = (ctypes.c_char * 2048)()
    if lib.ov_fopen(path.encode(), vf) != 0:
        raise RuntimeError(f"vorbisfile cannot open {path!r}")
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise RuntimeError(f"vorbisfile: no stream info in {path!r}")
        channels = info.contents.channels
        rate = int(info.contents.rate)
        chunks = []
        buf = (ctypes.c_char * 65536)()
        bitstream = ctypes.c_int(0)
        while True:
            n = lib.ov_read(vf, buf, len(buf), 0, 2, 1, ctypes.byref(bitstream))
            if n == 0:
                break
            if n < 0:  # hole in stream — skip per vorbisfile docs
                continue
            chunks.append(bytes(buf[:n]))
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
        wav = pcm.astype(np.float32) / 32768.0
        wav = wav.reshape(-1, channels) if channels > 1 else wav[:, None]
        return wav, rate
    finally:
        lib.ov_clear(vf)


# --- lame (mp3 ENCODE — test fixtures only) ---------------------------------

_lame = None


def _get_lame():
    global _lame
    if _lame is None:
        lib = _load("libmp3lame.so.0", "libmp3lame.so")
        if lib is None:
            raise RuntimeError("libmp3lame not found (test-only dependency)")
        lib.lame_init.restype = ctypes.c_void_p
        for f in ("lame_set_in_samplerate", "lame_set_num_channels",
                  "lame_set_brate", "lame_set_quality"):
            getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer_interleaved.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lame_encode_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _lame = lib
    return _lame


def encode_mp3(wav: np.ndarray, sr: int, path: str, bitrate_kbps: int = 192):
    """Encode float32 [-1,1] mono/stereo PCM to an mp3 file (tests only)."""
    lib = _get_lame()
    if wav.ndim == 1:
        wav = wav[:, None]
    channels = wav.shape[1]
    pcm = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
    gf = lib.lame_init()
    if not gf:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gf, sr)
        lib.lame_set_num_channels(gf, channels)
        lib.lame_set_brate(gf, bitrate_kbps)
        lib.lame_set_quality(gf, 2)
        if lib.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")
        n = pcm.shape[0]
        out = (ctypes.c_char * (n * 5 // 4 + 7200))()
        if channels == 2:
            inter = np.ascontiguousarray(pcm)
            m = lib.lame_encode_buffer_interleaved(
                gf, inter.ctypes.data_as(ctypes.c_void_p), n, out, len(out)
            )
        else:
            mono = np.ascontiguousarray(pcm[:, 0])
            m = lib.lame_encode_buffer(
                gf, mono.ctypes.data_as(ctypes.c_void_p),
                mono.ctypes.data_as(ctypes.c_void_p), n, out, len(out),
            )
        if m < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({m})")
        with open(path, "wb") as fh:
            fh.write(bytes(out[:m]))
            m = lib.lame_encode_flush(gf, out, len(out))
            if m > 0:
                fh.write(bytes(out[:m]))
    finally:
        lib.lame_close(gf)
