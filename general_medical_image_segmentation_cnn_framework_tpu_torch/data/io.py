"""Medical volume I/O: NIfTI-1 (.nii / .nii.gz) and MetaImage (.mhd/.raw/.zraw).

The PyTorch port's own copy of the JAX package's ``data/io.py`` (same names
and behaviour). Pure-numpy implementations (no nibabel or SimpleITK).
Capability parity with the reference's readers/writers, which go through
TorchIO/SimpleITK (reference dataloader.py:44-46 reads,
reference predict.py:204-214 writes ``save_mhd``/``save_nii``,
reference utils/trans2nii.py converts MHD->NIfTI).

In-memory representation: :class:`Volume` with ``data`` shaped ``[C, X, Y, Z]``
(channels first like TorchIO's ``[C, W, H, D]``) and a 4x4 voxel-to-world
``affine``.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Volume container
# ---------------------------------------------------------------------------


@dataclass
class Volume:
    """A (possibly multi-channel) volume plus its voxel-to-world affine."""

    data: np.ndarray  # [C, X, Y, Z]
    affine: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )
    path: Optional[Path] = None

    def __post_init__(self) -> None:
        self.data = np.asarray(self.data)
        if self.data.ndim == 3:
            self.data = self.data[None]
        assert self.data.ndim == 4, f"Volume data must be [C,X,Y,Z], got {self.data.shape}"
        self.affine = np.asarray(self.affine, dtype=np.float64)
        assert self.affine.shape == (4, 4)

    @property
    def spatial_shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape[1:])  # type: ignore[return-value]

    @property
    def num_channels(self) -> int:
        return self.data.shape[0]

    @property
    def spacing(self) -> Tuple[float, float, float]:
        """Voxel spacing: column norms of the affine's rotation block."""
        rot = self.affine[:3, :3]
        return tuple(float(np.linalg.norm(rot[:, i])) for i in range(3))  # type: ignore[return-value]

    def astype(self, dtype) -> "Volume":
        return Volume(self.data.astype(dtype), self.affine.copy(), self.path)

    def copy(self) -> "Volume":
        return Volume(self.data.copy(), self.affine.copy(), self.path)


# ---------------------------------------------------------------------------
# NIfTI-1
# ---------------------------------------------------------------------------

# nifti datatype code -> numpy dtype
_NIFTI_DTYPES = {
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
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _open_maybe_gz(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: Union[str, Path]) -> Volume:
    """Read a NIfTI-1 file (.nii or .nii.gz) into a Volume."""
    path = Path(path)
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()

    hdr = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        endian = ">"

    def unpack(fmt: str, offset: int):
        fmt = endian + fmt
        return struct.unpack_from(fmt, hdr, offset)

    dim = unpack("8h", 40)
    datatype = unpack("h", 70)[0]
    pixdim = unpack("8f", 76)
    vox_offset = int(unpack("f", 108)[0])
    scl_slope = unpack("f", 112)[0]
    scl_inter = unpack("f", 116)[0]
    qform_code = unpack("h", 252)[0]
    sform_code = unpack("h", 254)[0]
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(max(1, d) for d in dim[1 : 1 + max(ndim, 3)])
    if datatype not in _NIFTI_DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=data.dtype.newbyteorder("="))

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    # affine: sform > qform > pixdim
    if sform_code > 0:
        srow_x = unpack("4f", 280)
        srow_y = unpack("4f", 296)
        srow_z = unpack("4f", 312)
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        b, c, d = unpack("3f", 256)
        a2 = max(0.0, 1.0 - b * b - c * c - d * d)
        a = np.sqrt(a2)
        qox, qoy, qoz = unpack("3f", 268)
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
                [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
                [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
            ]
        )
        S = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
        affine = np.eye(4)
        affine[:3, :3] = R @ S
        affine[:3, 3] = [qox, qoy, qoz]
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    # normalize to [C, X, Y, Z]
    if data.ndim == 3:
        data = data[None]
    elif data.ndim == 4:
        data = np.moveaxis(data, 3, 0)  # NIfTI dim4 is "time"/channel
    elif data.ndim > 4:
        data = data.reshape(data.shape[:3] + (-1,), order="F")
        data = np.moveaxis(data, 3, 0)
    return Volume(np.ascontiguousarray(data), affine, path)


def write_nifti(path: Union[str, Path], volume: Volume) -> None:
    """Write a Volume to .nii / .nii.gz with an sform affine."""
    path = Path(path)
    data = volume.data
    if data.shape[0] == 1:
        arr = data[0]
        dim = (3,) + arr.shape + (1, 1, 1, 1)
    else:
        arr = np.moveaxis(data, 0, 3)
        dim = (4,) + arr.shape + (1, 1, 1)

    dt = np.dtype(arr.dtype)
    if dt not in _NIFTI_CODES:
        arr = arr.astype(np.float32)
        dt = np.dtype(np.float32)
    datatype = _NIFTI_CODES[dt]
    bitpix = dt.itemsize * 8

    affine = volume.affine
    spacing = volume.spacing

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2], 1, 1, 1, 1)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(arr).tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# MetaImage (.mhd + .raw/.zraw)
# ---------------------------------------------------------------------------

_MET_DTYPES = {
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16,
    "MET_SHORT": np.int16,
    "MET_UINT": np.uint32,
    "MET_INT": np.int32,
    "MET_ULONG": np.uint64,
    "MET_LONG": np.int64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_CODES = {np.dtype(v): k for k, v in _MET_DTYPES.items()}


def read_mhd(path: Union[str, Path]) -> Volume:
    """Read a MetaImage header + raw/zraw payload into a Volume."""
    path = Path(path)
    header = {}
    with open(path, "r") as f:
        for line in f:
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            header[key.strip()] = value.strip()

    ndims = int(header.get("NDims", 3))
    shape = tuple(int(x) for x in header["DimSize"].split())
    dtype = np.dtype(_MET_DTYPES[header["ElementType"]])
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true" or (
        header.get("ElementByteOrderMSB", "False").lower() == "true"
    ):
        dtype = dtype.newbyteorder(">")
    compressed = header.get("CompressedData", "False").lower() == "true"
    n_channels = int(header.get("ElementNumberOfChannels", 1))

    datafile = header["ElementDataFile"]
    data_path = path.parent / datafile
    with open(data_path, "rb") as f:
        blob = f.read()
    if compressed:
        blob = zlib.decompress(blob)

    count = int(np.prod(shape)) * n_channels
    data = np.frombuffer(blob, dtype=dtype, count=count)
    data = np.asarray(data, dtype=data.dtype.newbyteorder("="))
    # MetaImage raster order: x fastest -> C-order over reversed dims
    if n_channels > 1:
        data = data.reshape(tuple(reversed(shape)) + (n_channels,))
        data = np.moveaxis(data, -1, 0)
        data = np.transpose(data, (0,) + tuple(range(ndims, 0, -1)))
    else:
        data = data.reshape(tuple(reversed(shape))).transpose(tuple(range(ndims - 1, -1, -1)))[None]

    spacing = [float(x) for x in header.get("ElementSpacing", "1 1 1").split()]
    offset = [float(x) for x in header.get("Offset", header.get("Position", "0 0 0")).split()]
    tm = [float(x) for x in header.get("TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]
    R = np.array(tm, dtype=np.float64).reshape(3, 3).T  # column-major direction cosines
    affine = np.eye(4)
    affine[:3, :3] = R @ np.diag(spacing[:3])
    affine[:3, 3] = offset[:3]
    return Volume(np.ascontiguousarray(data), affine, path)


def write_mhd(path: Union[str, Path], volume: Volume, compressed: bool = True) -> None:
    """Write a Volume as .mhd (+ .zraw when compressed, else .raw).

    Mirrors the reference's ``save_mhd`` output format
    (reference predict.py:204-208, README.md:82-87 promises .mhd/.zraw).
    """
    path = Path(path)
    data = volume.data  # [C, X, Y, Z]
    n_channels = int(data.shape[0])
    dt = np.dtype(data.dtype)
    if dt not in _MET_CODES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)

    affine = volume.affine
    spacing = np.asarray(volume.spacing)
    R = affine[:3, :3] / spacing[None, :]
    offset = affine[:3, 3]

    ext = ".zraw" if compressed else ".raw"
    data_name = path.with_suffix(ext).name
    # MetaImage raster: channel fastest, then x, y, z (matches read_mhd's
    # reversed-dims + trailing-channel reshape)
    blob = np.ascontiguousarray(np.moveaxis(data, 0, -1).transpose(2, 1, 0, 3)).tobytes()
    if compressed:
        blob = zlib.compress(blob)
    with open(path.parent / data_name, "wb") as f:
        f.write(blob)

    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        "TransformMatrix = " + " ".join(f"{v:g}" for v in R.T.flatten()),
        "Offset = " + " ".join(f"{v:g}" for v in offset),
        "CenterOfRotation = 0 0 0",
        "ElementSpacing = " + " ".join(f"{v:g}" for v in spacing),
        "DimSize = " + " ".join(str(s) for s in data.shape[1:]),
        f"ElementType = {_MET_CODES[dt]}",
    ]
    if n_channels > 1:
        lines.append(f"ElementNumberOfChannels = {n_channels}")
    lines.append(f"ElementDataFile = {data_name}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def read_volume(path: Union[str, Path]) -> Volume:
    path = Path(path)
    name = path.name.lower()
    if name.endswith(".nii") or name.endswith(".nii.gz"):
        return read_nifti(path)
    if name.endswith(".mhd"):
        return read_mhd(path)
    raise ValueError(f"unsupported volume format: {path}")


def write_volume(path: Union[str, Path], volume: Volume) -> None:
    path = Path(path)
    name = path.name.lower()
    if name.endswith(".nii") or name.endswith(".nii.gz"):
        write_nifti(path, volume)
    elif name.endswith(".mhd"):
        write_mhd(path, volume)
    else:
        raise ValueError(f"unsupported volume format: {path}")
