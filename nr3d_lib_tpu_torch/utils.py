"""Generic utilities of the port (port of nr3d_lib_tpu/utils.py): the
nested-dict tools, dtype and tensor conversion, statistics, a timing
harness, image IO and chunk spans.

The PNG writer and reader use the standard library alone (`zlib` and
`struct`), so that images are written and read where neither PIL nor
matplotlib is installed. `load_rgb` reads other formats through PIL when
it imports.
"""

from __future__ import annotations

import importlib
import os
import struct
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from nr3d_lib_tpu_torch.profile import count_sync

__all__ = ["import_str", "nested_dict_keys", "nested_dict_items",
           "nested_dict_get", "nested_dict_set", "collate_nested_dict",
           "tree_map",
           "to_numpy", "cond_mkdir", "torch_dtype", "check_to_torch",
           "tensor_statistics", "timeit_torch", "img_to_uint8", "write_png",
           "encode_png", "read_png", "decode_png", "load_rgb", "save_image",
           "save_video", "downscale_img", "chunked", "backup_project"]


def import_str(string: str):
    """Import ``pkg.mod.attr`` from a dotted string."""
    module, _, attr = string.rpartition(".")
    if not module:
        return importlib.import_module(attr)
    return getattr(importlib.import_module(module), attr)


# ----------------------------------------------------------------- nested dict
def nested_dict_keys(d: dict, prefix: tuple = ()) -> List[tuple]:
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out += nested_dict_keys(v, prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


def nested_dict_items(d: dict, prefix: tuple = ()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from nested_dict_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def nested_dict_get(d: dict, keys: Sequence, default=None):
    node = d
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def nested_dict_set(d: dict, keys: Sequence, value):
    node = d
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def collate_nested_dict(dicts: Sequence[dict], stack: bool = True):
    """Collate a list of nested dicts of tensors into one nested dict:
    tensors and numbers stacked (or concatenated with `stack=False`),
    anything else listed."""
    if len(dicts) == 0:
        return {}
    out = {}
    for k, v in dicts[0].items():
        vs = [d[k] for d in dicts]
        if isinstance(v, dict):
            out[k] = collate_nested_dict(vs, stack=stack)
        elif hasattr(v, "shape") or isinstance(v, (int, float)):
            ts = [torch.as_tensor(x) for x in vs]
            out[k] = torch.stack(ts) if stack else torch.cat(ts)
        else:
            out[k] = vs
    return out


def tree_map(fn, tree):
    """`fn` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array-like → numpy. A tensor's read
    is one `syncs` of the innermost open span (on a card the host waits
    for it)."""
    if hasattr(x, "detach"):
        count_sync()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cond_mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


# ---------------------------------------------------------------------- dtypes
_DTYPES = {
    "half": torch.bfloat16, "float16": torch.float16, "fp16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "double": torch.float64, "float64": torch.float64,
    "int": torch.int32, "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    """'half'/'float16'/'bf16'/... → torch dtype, by JAX's table ('half' is
    bfloat16, as on the TPU); None → float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        return _DTYPES[dtype]
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def check_to_torch(x, dtype=None, ref: Optional[torch.Tensor] = None,
                   device=None):
    """Array-likes, lists and nested dicts → tensors on `device` (else
    `ref`'s, else the tensor's own; an array-like with none of them goes
    to the card). Floating values take `dtype` (else `ref`'s)."""
    from nr3d_lib_tpu_torch.device import resolve_device

    if dtype is None and ref is not None:
        dtype = ref.dtype
    if isinstance(x, dict):
        return {k: check_to_torch(v, dtype=dtype, ref=ref, device=device)
                for k, v in x.items()}
    if x is None:
        return None
    if device is None:
        device = ref.device if ref is not None else \
            x.device if isinstance(x, torch.Tensor) else resolve_device(None)
    t = torch.as_tensor(x).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(torch_dtype(dtype))
    return t


# ----------------------------------------------------------------------- stats
def tensor_statistics(x, prefix: str = "") -> Dict[str, float]:
    """Summary statistics for logging, in float64."""
    x = to_numpy(x).astype(np.float64).reshape(-1)
    if x.size == 0:
        return {}
    p = lambda k: f"{prefix}.{k}" if prefix else k
    return {
        p("mean"): float(x.mean()), p("std"): float(x.std()),
        p("min"): float(x.min()), p("max"): float(x.max()),
        p("absmax"): float(np.abs(x).max()),
        p("norm"): float(np.linalg.norm(x)),
    }


# ------------------------------------------------------------------- benchmark
def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    return False


def timeit_torch(fn: Callable, *args, n_iters: int = 20, warmup: int = 3,
                 **kwargs) -> float:
    """Median ms of one call of `fn`. A call whose arguments or outputs
    hold a CUDA tensor is timed on the device with CUDA events; any other
    with `time.perf_counter`."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    cuda = _on_cuda((args, kwargs, out))
    times = []
    if cuda:
        torch.cuda.synchronize()
        for _ in range(n_iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(n_iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


# -------------------------------------------------------------------- images
def img_to_uint8(img) -> np.ndarray:
    img = to_numpy(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels → PNG color type
_PNG_CHANNELS = {v: k for k, v in _PNG_COLOR_TYPE.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + \
        struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA)
    → the bytes of an 8-bit PNG, every row with filter type 0."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"a PNG holds 1 to 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """`encode_png` to a file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter_row(kind: int, row: bytearray, prev: bytearray,
                  bpp: int) -> None:
    """Undo one scanline's filter in place (PNG spec §9.2); `prev` is the
    unfiltered row above (zeros for the first)."""
    n = len(row)
    if kind == 0:
        return
    if kind == 1:                                           # Sub
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif kind == 2:                                         # Up
        for i in range(n):
            row[i] = (row[i] + prev[i]) & 0xFF
    elif kind == 3:                                         # Average
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif kind == 4:                                         # Paeth
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: unknown filter type {kind}")


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA
    PNG (any of the five filters) → uint8 [H, W, C]."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"PNG: only 8-bit non-interlaced gray, gray+alpha, "
                         f"RGB and RGBA are read (bit depth {depth}, color "
                         f"type {color}, interlace {interlace})")
    c = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    stride = w * c
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG: image data of the wrong length")
    out = np.empty((h, stride), np.uint8)
    prev = bytearray(stride)
    for y in range(h):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], row, prev, c)
        out[y] = np.frombuffer(bytes(row), np.uint8)
        prev = row
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def load_rgb(path: str, downscale: float = 1.0) -> np.ndarray:
    """Load an image → float32 [H, W, 3] in [0, 1]. A PNG is read by the
    port's own decoder (gray replicated to RGB, alpha dropped, as PIL's
    `convert("RGB")` does); any other format through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        u8 = decode_png(data)
        u8 = np.repeat(u8[..., :1], 3, -1) if u8.shape[-1] <= 2 \
            else u8[..., :3]
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{path}: only PNG is read without PIL") from e
        with Image.open(path) as im:
            u8 = np.asarray(im.convert("RGB"))
    img = np.asarray(u8, dtype=np.float32) / 255.0
    if downscale != 1.0:
        img = downscale_img(img, downscale)
    return img


def downscale_img(img: np.ndarray, factor: float) -> np.ndarray:
    """Area downscale by an integer factor, as a block mean."""
    f = int(factor)
    h, w = img.shape[:2]
    h2, w2 = h // f * f, w // f * f
    img = img[:h2, :w2]
    return img.reshape(h2 // f, f, w2 // f, f, -1).mean(axis=(1, 3)).squeeze()


def save_image(path: str, img) -> None:
    """Save a float [0,1] or uint8 image as PNG."""
    write_png(path, img_to_uint8(img))


def save_video(path: str, frames: Sequence, fps: int = 24) -> str:
    """Write frames ([T,H,W,3] float [0,1] or uint8) to a video file when a
    video writer (imageio with ffmpeg) is installed; otherwise, as in JAX,
    a PNG sequence directory beside it. Returns the path written."""
    frames_u8 = [img_to_uint8(f) for f in frames]
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames_u8, fps=fps)
        return path
    except Exception:
        if os.path.exists(path):   # leave no truncated video behind
            os.remove(path)
        root = os.path.splitext(path)[0] + "_frames"
        cond_mkdir(root)
        for i, f in enumerate(frames_u8):
            save_image(os.path.join(root, f"{i:05d}.png"), f)
        return root


def chunked(total: int, chunk: int):
    """Yield (start, size) spans covering [0, total)."""
    for start in range(0, total, chunk):
        yield start, min(chunk, total - start)


def backup_project(backup_dir: str, source_dir: str = "./",
                   subdirs_to_copy: Sequence[str] = ("nr3d_lib_tpu_torch",
                                                     "examples_torch"),
                   filetypes_to_copy: Sequence[str] = (".py", ".yaml", ".sh",
                                                      ".cpp", ".h", ".cu",
                                                      ".cuh")) -> None:
    """Copy the source files into an experiment directory: the root's own
    files, and the listed subdirectories recursively."""
    import shutil

    exts = tuple(filetypes_to_copy)

    def _copy_tree(dst_root, src_root, recursive):
        os.makedirs(dst_root, exist_ok=True)
        for name in sorted(os.listdir(src_root)):
            src = os.path.join(src_root, name)
            dst = os.path.join(dst_root, name)
            if os.path.isfile(src) and src.endswith(exts):
                shutil.copy2(src, dst)
            elif recursive and os.path.isdir(src) and not name.startswith("."):
                _copy_tree(dst, src, True)

    _copy_tree(backup_dir, source_dir, False)
    for sub in subdirs_to_copy:
        src = os.path.join(source_dir, sub)
        if os.path.isdir(src):
            _copy_tree(os.path.join(backup_dir, sub), src, True)
