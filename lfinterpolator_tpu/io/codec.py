"""Image decode/encode.

The reference vendors stb_image / stb_image_write (reference:
src/lfLoader.cpp:36, src/interpolator.cu:313). Here the codec is pluggable:

  1. a native C++ codec (libpng for PNG, libjpeg for JPEG, via ctypes; built
     from native/) when available -- the fast path for bulk dataset ingest,
  2. Pillow as the portable fallback (and for any other format).

Decoded images are always RGBA8 (channels forced to 4, matching
STBI_rgb_alpha at src/lfLoader.cpp:35-39).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_native_lock = threading.Lock()
_native_lib = None
_native_checked = False


def _native_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "liblfi_codec.so",
    )


def _load_native():
    """Load the native codec shared library if it has been built."""
    global _native_lib, _native_checked
    with _native_lock:
        if _native_checked:
            return _native_lib
        _native_checked = True
        path = os.environ.get("LFI_CODEC_LIB", _native_path())
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.lfi_decode_png_rgba.restype = ctypes.c_int
            lib.lfi_decode_png_rgba.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ]
            lib.lfi_decode_jpeg_rgba.restype = ctypes.c_int
            lib.lfi_decode_jpeg_rgba.argtypes = lib.lfi_decode_png_rgba.argtypes
            lib.lfi_encode_png_rgba.restype = ctypes.c_int
            lib.lfi_encode_png_rgba.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            lib.lfi_free.restype = None
            lib.lfi_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
            # The batch symbol is newer than the rest: probe it separately
            # so a stale pre-batch .so keeps its per-image fast paths and
            # only decode_batch degrades (returns False -> caller fallback).
            try:
                lib.lfi_decode_batch_rgba.restype = ctypes.c_int
                lib.lfi_decode_batch_rgba.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                lib._lfi_has_batch = True
            except AttributeError:
                lib._lfi_has_batch = False
            try:
                lib.lfi_encode_batch_png.restype = ctypes.c_int
                lib.lfi_encode_batch_png.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                lib._lfi_has_batch_encode = True
            except AttributeError:
                lib._lfi_has_batch_encode = False
            _native_lib = lib
        except (OSError, AttributeError):
            # unloadable library, or a stale/unrelated .so missing the
            # expected symbols -- fall back to Pillow either way
            _native_lib = None
        return _native_lib


def native_available() -> bool:
    return _load_native() is not None


def decode(path: str) -> np.ndarray:
    """Decode an image file to an RGBA8 array [H, W, 4]."""
    lib = _load_native()
    if lib is not None:
        ext = os.path.splitext(path)[1].lower()
        fn = {
            ".png": lib.lfi_decode_png_rgba,
            ".jpg": lib.lfi_decode_jpeg_rgba,
            ".jpeg": lib.lfi_decode_jpeg_rgba,
        }.get(ext)
        if fn is not None:
            w = ctypes.c_int()
            h = ctypes.c_int()
            buf = ctypes.POINTER(ctypes.c_ubyte)()
            rc = fn(
                path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(buf)
            )
            if rc == 0:
                try:
                    n = w.value * h.value * 4
                    arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
                    return arr.reshape(h.value, w.value, 4)
                finally:
                    lib.lfi_free(buf)
            # fall through to Pillow on native decode failure
    return _decode_pil(path)


def decode_batch(
    paths: list[str], out: np.ndarray, threads: int | None = None
) -> bool:
    """Decode many same-resolution files into a preallocated RGBA8 stack.

    `out` is [N, H, W, 4] uint8, C-contiguous; every file must decode to
    (H, W) (mirrors the reference loader's bulk ingest, src/lfLoader.cpp:59-66,
    but parallel over a native std::thread pool with one decode pass and no
    per-image Python round-trip). Returns False when the native codec is
    unavailable (caller falls back to per-image decode); raises on any
    decode failure or resolution mismatch.
    """
    lib = _load_native()
    if lib is None or not lib._lfi_has_batch:
        return False
    n, h, w, c = out.shape
    if n != len(paths) or c != 4 or out.dtype != np.uint8:
        raise ValueError(f"decode_batch needs [len(paths), H, W, 4] u8 out, "
                         f"got {out.shape} {out.dtype}")
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("decode_batch needs a C-contiguous output stack")
    if n == 0:
        return True
    if threads is None:
        threads = min(16, os.cpu_count() or 4)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err_i = ctypes.c_int(-1)
    err_c = ctypes.c_int(0)
    rc = lib.lfi_decode_batch_rgba(
        arr, n, w, h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        threads, ctypes.byref(err_i), ctypes.byref(err_c),
    )
    if rc != 0:
        if err_i.value < 0:
            raise RuntimeError(
                f"decode_batch rejected its arguments (code {err_c.value})"
            )
        bad = paths[err_i.value] if err_i.value < n else "?"
        if err_c.value == -1:
            raise ValueError(
                f"Image {bad} has a different resolution than the first "
                f"image (expected {w}x{h})"
            )
        raise RuntimeError(
            f"Cannot load image {bad} (native codec error {err_c.value}; "
            f"{rc} file(s) failed)"
        )
    return True


def encode_batch_png(
    paths: list[str], stack: np.ndarray, threads: int | None = None
) -> bool:
    """Encode a contiguous RGBA8 stack [N, H, W, 4] to per-frame PNGs.

    The write-side sibling of decode_batch (reference result loop:
    src/interpolator.cu:299-316): one native std::thread pool, each frame
    staged to <path>.tmp and renamed into place (same atomicity as
    writer._encode_atomic). Returns False when the native codec or the
    batch-encode symbol is unavailable (caller falls back to per-image
    encode); raises on any encode failure.
    """
    lib = _load_native()
    if lib is None or not lib._lfi_has_batch_encode:
        return False
    n, h, w, c = stack.shape
    if n != len(paths) or c != 4 or stack.dtype != np.uint8:
        raise ValueError(
            f"encode_batch_png needs [len(paths), H, W, 4] u8, "
            f"got {stack.shape} {stack.dtype}"
        )
    if not stack.flags["C_CONTIGUOUS"]:
        raise ValueError("encode_batch_png needs a C-contiguous stack")
    if n == 0:
        return True
    if threads is None:
        threads = min(16, os.cpu_count() or 4)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err_i = ctypes.c_int(-1)
    err_c = ctypes.c_int(0)
    rc = lib.lfi_encode_batch_png(
        arr, n, w, h,
        stack.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        threads, ctypes.byref(err_i), ctypes.byref(err_c),
    )
    if rc != 0:
        if err_i.value < 0:
            raise RuntimeError(
                f"encode_batch_png rejected its arguments (code {err_c.value})"
            )
        bad = paths[err_i.value] if err_i.value < n else "?"
        raise RuntimeError(
            f"Cannot write image {bad} (native codec error {err_c.value}; "
            f"{rc} file(s) failed)"
        )
    return True


_NO_CODEC = (
    "No image codec available: build the native codec (make -C native) "
    "or install Pillow."
)


def _decode_pil(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(_NO_CODEC) from e
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGBA"), dtype=np.uint8)
    except Exception as e:
        raise RuntimeError(f"Cannot load image {path}") from e


def encode_png(path: str, image: np.ndarray) -> None:
    """Encode an RGB(A)8 array to a PNG file."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode_png expects uint8 HxWx{{1,3,4}}, got {image.shape}")
    lib = _load_native()
    if lib is not None and image.shape[2] == 4:
        h, w = image.shape[:2]
        ptr = image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        if lib.lfi_encode_png_rgba(path.encode(), w, h, 4, ptr) == 0:
            return
        # fall through to Pillow on native encode failure
    _encode_pil(path, image)


def _encode_pil(path: str, image: np.ndarray) -> None:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(_NO_CODEC) from e

    mode = {1: "L", 3: "RGB", 4: "RGBA"}[image.shape[2]]
    # encode_png always produces PNG bytes; the extension may be a staging
    # name (.tmp for atomic write-then-rename), so never let Pillow infer.
    Image.fromarray(
        image.squeeze(-1) if mode == "L" else image, mode=mode
    ).save(path, format="PNG")
