"""Image files without PIL: JPEG and PNG decode and encode, header probes.

The machine with the card has neither PIL nor cv2, so the port reads and
writes its frames, annotations, pseudo-labels, exported masks and
visualization grids here. The JPEG decode and encode and the PNG row
unfilter run in host C++ (``csrc/image_codec.cpp``), built with the host
compiler into ``rcf_tpu_torch/build/librcf_codec_<hash>.so`` at first use
(named by a hash of the source and the flags) and called through
``ctypes``, which releases the GIL, so a loader's threads decode in
parallel. A failed build raises: there is no slower fallback.

``read_image(path, mode)`` returns what ``np.asarray(PIL.Image.open(path)
.convert(mode))`` returns for the files the pipeline reads:

* JPEG: baseline sequential, 8-bit, 1 or 3 components, computed as
  libjpeg's defaults compute it (islow IDCT, fancy upsampling, fixed-point
  YCbCr); progressive, lossless, arithmetic, 12-bit, CMYK and multi-scan
  files raise ``ValueError`` naming the file and the reason;
* PNG: 8-bit gray, RGB, RGBA, gray + alpha; palette and gray at 1, 2, 4
  or 8 bits; every filter; not interlaced. ``convert("RGB")`` drops alpha
  and expands gray and palettes; ``convert("L")`` takes ITU-R 601-2 luma
  in PIL's fixed point, ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``.

``mode=None`` reads a file as stored, as ``np.array(PIL.Image.open(path))``:
a palette PNG gives its indices, gray its values (1-bit gray as bool),
gray + alpha ``[H, W, 2]``, RGBA ``[H, W, 4]``, a JPEG ``L`` or ``RGB``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "image_codec.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 512
_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librcf_codec_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the codec if this source hash has not been built; returns the .so path."""
    so = library_path()
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cxx = os.environ.get("CXX", "c++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the image codec with {cxx} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            ip = ctypes.POINTER(ctypes.c_int)
            lib.rcf_jpeg_info.argtypes = [p, sz, ip, ip, ip, ctypes.c_char_p, i]
            lib.rcf_jpeg_decode.argtypes = [p, sz, p, i, ctypes.c_char_p, i]
            lib.rcf_jpeg_encode.argtypes = [p, i, i, i, p, sz, ctypes.POINTER(sz),
                                            ctypes.c_char_p, i]
            lib.rcf_png_unfilter.argtypes = [p, p, i, i, i, ctypes.c_char_p, i]
            for fn in (lib.rcf_jpeg_info, lib.rcf_jpeg_decode, lib.rcf_jpeg_encode,
                       lib.rcf_png_unfilter):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray | bytes) -> ctypes.c_void_p:
    if isinstance(a, bytes):
        return ctypes.cast(ctypes.c_char_p(a), ctypes.c_void_p)
    return ctypes.c_void_p(a.ctypes.data)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(width, height, components) from a JPEG's frame header."""
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _load().rcf_jpeg_info(_ptr(data), len(data), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return w.value, h.value, c.value


def decode_jpeg(data: bytes, mode: str | None = "RGB") -> np.ndarray:
    """A JPEG's pixels as uint8 [H, W, 3] (``mode="RGB"``) or [H, W] (``"L"``);
    ``None``: as stored (``L`` for one component, else ``RGB``)."""
    w, h, comps = jpeg_info(data)
    if mode is None:
        mode = "L" if comps == 1 else "RGB"
    channels = 1 if (mode == "L" and comps == 1) else 3
    out = np.empty((h, w, channels), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _load().rcf_jpeg_decode(_ptr(data), len(data), _ptr(out), channels, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    if mode == "L":
        return out[..., 0] if channels == 1 else rgb_to_l(out)
    if mode != "RGB":
        raise ValueError(f"unsupported mode {mode!r} (RGB or L)")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JPEG (4:2:0) of uint8 [H, W, 3] RGB."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8 RGB, got {img.shape}")
    h, w = img.shape[:2]
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = h * w * 3 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        rc = _load().rcf_jpeg_encode(_ptr(img), w, h, int(quality), _ptr(out), cap,
                                     ctypes.byref(size), err, _ERR_LEN)
        if rc == 0:
            return out[: size.value].tobytes()
        if rc != 2:
            raise ValueError(err.value.decode())
        cap = size.value


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return


def decode_png(data: bytes, mode: str | None = "RGB") -> np.ndarray:
    """A PNG's pixels as uint8 [H, W, 3] (``mode="RGB"``) or [H, W] (``"L"``);
    ``None``: as stored (see the module note)."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG")
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    ch = _PNG_CHANNELS[ctype]
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"unsupported PNG bit depth {depth} for colour type {ctype}")
    row_bytes = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (row_bytes + 1):
        raise ValueError("truncated PNG image data")
    rows = np.empty((h, row_bytes), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _load().rcf_png_unfilter(raw, _ptr(rows), h, row_bytes, max(1, ch * depth // 8), err,
                                _ERR_LEN):
        raise ValueError(err.value.decode())
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        px = vals if ctype == 3 else vals * np.uint8(255 // ((1 << depth) - 1))
        px = px[..., None]
    else:
        px = rows[:, : w * ch].reshape(h, w, ch)
    if mode is None:
        if ctype == 0 and depth == 1:
            return px[..., 0] > 0  # PIL's mode "1"
        return np.ascontiguousarray(px[..., 0] if ch == 1 else px)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = palette[:256]
        rgb = pal[px[..., 0]]
        return rgb if mode == "RGB" else _require_l(mode, rgb_to_l(rgb))
    if ctype in (0, 4):  # gray (+ alpha)
        gray = px[..., 0]
        if mode == "L":
            return np.ascontiguousarray(gray)
        return _require_rgb(mode, np.repeat(gray[..., None], 3, axis=-1))
    rgb = np.ascontiguousarray(px[..., :3])
    return rgb if mode == "RGB" else _require_l(mode, rgb_to_l(rgb))


def _require_rgb(mode: str, arr: np.ndarray) -> np.ndarray:
    if mode != "RGB":
        raise ValueError(f"unsupported mode {mode!r} (RGB or L)")
    return arr


def _require_l(mode: str, arr: np.ndarray) -> np.ndarray:
    if mode != "L":
        raise ValueError(f"unsupported mode {mode!r} (RGB or L)")
    return arr


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")``: ITU-R 601-2 luma in 16-bit fixed point."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG (filter 0, zlib) of uint8 [H, W] gray or [H, W, 3] RGB."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3] uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    return (_PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def read_image(path: str, mode: str | None = "RGB") -> np.ndarray:
    """A JPEG or PNG file as ``np.asarray(Image.open(path).convert(mode))``;
    ``mode=None``: as stored, ``np.array(Image.open(path))``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:2] == b"\xff\xd8":
            return decode_jpeg(data, mode)
        if data.startswith(_PNG_SIG):
            return decode_png(data, mode)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    raise ValueError(f"{path}: not a JPEG or PNG file (the port reads only these)")


def image_size(path: str) -> tuple[int, int]:
    """(W, H) of a JPEG (from its SOF) or PNG (from its IHDR), reading only the header."""
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
        if head.startswith(_PNG_SIG):
            w, h = struct.unpack(">II", head[16:24])
            return int(w), int(h)
        if head[:2] == b"\xff\xd8":
            while True:
                try:
                    w, h, _ = jpeg_info(head)
                    return w, h
                except ValueError as exc:
                    more = f.read(len(head))
                    if not more or "truncated" not in str(exc):
                        raise ValueError(f"{path}: {exc}") from None
                    head += more
    raise ValueError(f"{path}: not a JPEG or PNG file (the port reads only these)")


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_jpeg(path: str, img: np.ndarray, quality: int = 90) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
