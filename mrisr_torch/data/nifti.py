"""NIfTI-1 reader and writer (the port's own copy of ``mrisr_tpu/data/nifti.py``; numpy only).

The subset of NIfTI-1.1 the MRI pipelines need: the header (dims, datatype,
scaling, qform / sform affines), gzip, data with scl_slope / scl_inter
applied, and nearest-axis reorientation to RAS+ as MONAI's
``OrientationD(axcodes='RAS')`` does.  Byte layout as in the public NIfTI-1
C header (nifti1.h).
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray  # spatial array, [X, Y, Z] (Fortran-ordered on disk)
    affine: np.ndarray  # 4x4 voxel -> world (RAS+ mm)
    header: dict

    @property
    def shape(self):
        return self.data.shape


def _read_bytes(path: str | Path) -> bytes:
    p = Path(path)
    raw = p.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = max(0.0, 1.0 - b * b - c * c - d * d)
    a = np.sqrt(a2)
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    scale = np.diag([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R @ scale
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def read_nifti(path: str | Path, apply_scaling: bool = True) -> NiftiImage:
    raw = _read_bytes(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: too short for a NIfTI-1 header")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr_be,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr_be == 348:
            endian = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    dim = struct.unpack_from(f"{endian}8h", raw, 40)
    (datatype,) = struct.unpack_from(f"{endian}h", raw, 70)
    pixdim = struct.unpack_from(f"{endian}8f", raw, 76)
    (vox_offset,) = struct.unpack_from(f"{endian}f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(f"{endian}2f", raw, 112)
    qform_code, sform_code = struct.unpack_from(f"{endian}2h", raw, 252)
    quatern = struct.unpack_from(f"{endian}6f", raw, 256)
    srow_x = struct.unpack_from(f"{endian}4f", raw, 280)
    srow_y = struct.unpack_from(f"{endian}4f", raw, 296)
    srow_z = struct.unpack_from(f"{endian}4f", raw, 312)
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    ndim = dim[0]
    shape = tuple(int(s) for s in dim[1 : 1 + max(ndim, 3)])
    shape = tuple(max(s, 1) for s in shape)
    count = int(np.prod(shape))
    off = int(vox_offset) if vox_offset >= 352 else 352
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=off)
    data = data.reshape(shape, order="F")
    # Drop trailing singleton (time) dims down to 3D.
    while data.ndim > 3 and data.shape[-1] == 1:
        data = data[..., 0]

    hdr = {
        "dim": dim,
        "datatype": datatype,
        "pixdim": pixdim,
        "scl_slope": scl_slope,
        "scl_inter": scl_inter,
        "qform_code": qform_code,
        "sform_code": sform_code,
        "quatern_b": quatern[0],
        "quatern_c": quatern[1],
        "quatern_d": quatern[2],
        "qoffset_x": quatern[3],
        "qoffset_y": quatern[4],
        "qoffset_z": quatern[5],
    }

    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    arr = np.asarray(data)
    if apply_scaling and scl_slope not in (0.0,) and not (
        scl_slope == 1.0 and scl_inter == 0.0
    ):
        arr = arr.astype(np.float32) * scl_slope + scl_inter
    return NiftiImage(data=arr, affine=affine, header=hdr)


def write_nifti(path: str | Path, data: np.ndarray, affine: np.ndarray | None = None):
    """Minimal NIfTI-1 writer (sform only), gzipped when path ends in .gz."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    code = _DTYPE_CODES.get(np.dtype(data.dtype))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * (7 - 3)))
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform 0, sform 1
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.tobytes(order="F")
    p = Path(path)
    if p.suffix == ".gz" or str(p).endswith(".nii.gz"):
        p.write_bytes(gzip.compress(payload))
    else:
        p.write_bytes(payload)


def io_orientation(affine: np.ndarray) -> list[tuple[int, int]]:
    """Nearest-axis orientation of each voxel axis: (world_axis, direction)."""
    R = affine[:3, :3]
    out = []
    used = set()
    for col in range(3):
        v = R[:, col]
        order = np.argsort(-np.abs(v))
        for w in order:
            if w not in used:
                used.add(int(w))
                out.append((int(w), 1 if v[w] >= 0 else -1))
                break
    return out


def to_ras(img: NiftiImage) -> NiftiImage:
    """Reorient to RAS+ via axis permutation/flips (MONAI OrientationD parity)."""
    orient = io_orientation(img.affine)
    perm = [0, 0, 0]
    flips = [False, False, False]
    for voxel_axis, (world_axis, direction) in enumerate(orient):
        perm[world_axis] = voxel_axis
        flips[world_axis] = direction < 0

    data = np.transpose(img.data, perm)
    affine = img.affine.copy()
    # Permute affine columns to match
    P = np.zeros((4, 4))
    P[3, 3] = 1.0
    for world_axis, voxel_axis in enumerate(perm):
        P[voxel_axis, world_axis] = 1.0
    affine = affine @ P
    for ax in range(3):
        if flips[ax]:
            data = np.flip(data, axis=ax)
            # new_index = n-1 - old_index
            affine[:, ax] = -affine[:, ax]
            affine[:3, 3] += affine[:3, ax] * -(data.shape[ax] - 1)
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine, header=img.header)
