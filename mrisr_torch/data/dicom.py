"""Minimal DICOM reader and writer (port of ``mrisr_tpu/data/dicom.py``; pure numpy and struct).

Covers what the FastMRI path needs: uncompressed little-endian DICOM part-10
files, explicit or implicit VR, the pixel array with rescale slope and
intercept, and the metadata tags the index builder records (patient id,
field strength, series description, instance number, acquisition matrix,
pixel spacing).  Compressed transfer syntaxes are rejected with an error.
``write_dicom_minimal`` writes the files the tests read.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# (group, element) tags we care about
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_PATIENT_ID = (0x0010, 0x0020)
TAG_FIELD_STRENGTH = (0x0018, 0x0087)
TAG_SERIES_DESC = (0x0008, 0x103E)
TAG_PROTOCOL = (0x0018, 0x1030)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_ACQ_MATRIX = (0x0018, 0x1310)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOC = (0x0028, 0x0100)
TAG_PIXEL_REP = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}

_UNCOMPRESSED_SYNTAXES = {
    "1.2.840.10008.1.2",  # implicit VR LE
    "1.2.840.10008.1.2.1",  # explicit VR LE
}


@dataclass
class DicomFile:
    tags: dict = field(default_factory=dict)
    pixel_array: np.ndarray | None = None

    def get(self, tag, default=None):
        return self.tags.get(tag, default)


def _parse_elements(buf: bytes, pos: int, explicit: bool, stop_at_pixels: bool):
    tags: dict = {}
    n = len(buf)
    pixel_info = None
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        pos += 4
        if explicit or group == 0x0002:
            vr = buf[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            vr = b"UN"
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4

        if tag == TAG_PIXEL_DATA:
            if length == 0xFFFFFFFF:
                raise ValueError("encapsulated (compressed) PixelData not supported")
            pixel_info = (pos, length)
            pos += length
            if stop_at_pixels:
                break
            continue

        if length == 0xFFFFFFFF or vr == b"SQ":
            # Skip sequences: parse items until sequence delimiter.
            pos = _skip_sequence(buf, pos, length)
            continue

        value = buf[pos : pos + length]
        pos += length
        tags[tag] = _decode_value(vr, value, explicit)
    return tags, pixel_info, pos


def _skip_sequence(buf: bytes, pos: int, length: int) -> int:
    if length != 0xFFFFFFFF:
        return pos + length
    # Undefined length: scan for sequence delimitation item (FFFE, E0DD).
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        (ilen,) = struct.unpack_from("<I", buf, pos + 4)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return pos
        if (group, elem) == (0xFFFE, 0xE000):
            if ilen == 0xFFFFFFFF:
                pos = _skip_sequence(buf, pos, 0xFFFFFFFF)
            else:
                pos += ilen
        else:
            pos += ilen
    return pos


def _decode_value(vr: bytes, value: bytes, explicit: bool):
    if vr in (b"US",):
        return struct.unpack("<H", value[:2])[0] if len(value) >= 2 else None
    if vr in (b"UL",):
        return struct.unpack("<I", value[:4])[0] if len(value) >= 4 else None
    if vr in (b"SS",):
        return struct.unpack("<h", value[:2])[0] if len(value) >= 2 else None
    if vr in (b"US\\US", b"SS\\SS"):
        return value
    if vr == b"UN" and len(value) == 2:
        # Implicit VR: short binary ints are common for US tags.
        return struct.unpack("<H", value)[0]
    try:
        return value.decode("ascii", "ignore").strip("\x00 ").strip()
    except Exception:
        return value


def read_dicom(path: str | Path, read_pixels: bool = True) -> DicomFile:
    buf = Path(path).read_bytes()
    pos = 0
    explicit = True
    meta_tags: dict = {}
    if len(buf) > 132 and buf[128:132] == b"DICM":
        pos = 132
        # File meta group (0002) is always explicit VR LE; parse until group != 2
        meta_end = pos
        while meta_end + 8 <= len(buf):
            group, _ = struct.unpack_from("<HH", buf, meta_end)
            if group != 0x0002:
                break
            vr = buf[meta_end + 4 : meta_end + 6]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, meta_end + 8)
                hdr = 12
            else:
                (length,) = struct.unpack_from("<H", buf, meta_end + 6)
                hdr = 8
            value = buf[meta_end + hdr : meta_end + hdr + length]
            meta_tags[(group, struct.unpack_from("<HH", buf, meta_end)[1])] = _decode_value(
                vr, value, True
            )
            meta_end += hdr + length
        pos = meta_end
        ts = meta_tags.get(TAG_TRANSFER_SYNTAX, "1.2.840.10008.1.2.1")
        if ts not in _UNCOMPRESSED_SYNTAXES:
            raise ValueError(f"{path}: unsupported transfer syntax {ts}")
        explicit = ts != "1.2.840.10008.1.2"
    else:
        # Raw dataset without preamble: sniff explicit VR.
        vr = buf[4:6]
        explicit = vr.isalpha() and vr.isupper()

    tags, pixel_info, _ = _parse_elements(buf, pos, explicit, stop_at_pixels=True)
    tags.update(meta_tags)
    dcm = DicomFile(tags=tags)
    if read_pixels and pixel_info is not None:
        off, length = pixel_info
        rows = int(tags.get(TAG_ROWS) or 0)
        cols = int(tags.get(TAG_COLS) or 0)
        bits = int(tags.get(TAG_BITS_ALLOC) or 16)
        signed = int(tags.get(TAG_PIXEL_REP) or 0) == 1
        if bits == 16:
            dt = np.int16 if signed else np.uint16
        elif bits == 8:
            dt = np.int8 if signed else np.uint8
        else:
            raise ValueError(f"{path}: unsupported BitsAllocated={bits}")
        arr = np.frombuffer(buf, dtype=dt, count=rows * cols, offset=off)
        arr = arr.reshape(rows, cols).astype(np.float32)
        slope = float(tags.get(TAG_RESCALE_SLOPE) or 1.0)
        inter = float(tags.get(TAG_RESCALE_INTERCEPT) or 0.0)
        if slope != 1.0 or inter != 0.0:
            arr = arr * slope + inter
        dcm.pixel_array = arr
    return dcm


def write_dicom_minimal(
    path: str | Path,
    pixels: np.ndarray,
    patient_id: str = "anon",
    field_strength: str = "3.0",
    series_desc: str = "T2",
    instance_number: int = 1,
):
    """Write a tiny explicit-VR-LE DICOM (for tests / fixtures)."""
    pixels = np.ascontiguousarray(pixels.astype(np.uint16))
    rows, cols = pixels.shape

    def elem(group, el, vr, value: bytes) -> bytes:
        if len(value) % 2:
            value += b"\x00" if vr != b"UI" else b"\x00"
        if vr in _EXPLICIT_LONG_VRS:
            return struct.pack("<HH2sHI", group, el, vr, 0, len(value)) + value
        return struct.pack("<HH2sH", group, el, vr, len(value)) + value

    meta = elem(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    body = b"".join(
        [
            elem(0x0008, 0x103E, b"LO", series_desc.encode()),
            elem(0x0010, 0x0020, b"LO", patient_id.encode()),
            elem(0x0018, 0x0087, b"DS", field_strength.encode()),
            elem(0x0018, 0x1310, b"US", struct.pack("<4H", 0, cols, rows, 0)),
            elem(0x0020, 0x0013, b"IS", str(instance_number).encode()),
            elem(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            elem(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            elem(0x0028, 0x0030, b"DS", b"1.0\\1.0"),
            elem(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            elem(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
            elem(0x7FE0, 0x0010, b"OW", pixels.tobytes()),
        ]
    )
    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + meta + body)
