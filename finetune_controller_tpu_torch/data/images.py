"""Host-side image decode/resize/normalize for multimodal datasets (a copy of
the reference's ``data/images.py``).

Dataset rows reference images as file paths (PNG/JPEG via PIL, ``.npy``
arrays) or base64 payloads (``data:`` URIs or bare base64 of the same
formats). Output is always ``(size, size, 3) float32`` ready for the ViT
patch conv — normalized with the CLIP mean/std by default, because the
shipped LLaVA preset imports a CLIP tower pretrained under exactly that
preprocessing (reference dataset contract:
``app/models/base/finetuning.py:37-49`` — the reference only declares
content types; the actual pipeline lived in user containers).
"""

from __future__ import annotations

import base64
import binascii
import io
from pathlib import Path

import numpy as np

#: OpenAI CLIP preprocessing constants (the tower the LLaVA preset imports)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def _from_bytes(raw: bytes) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] from PNG/JPEG/NPY bytes."""
    if raw[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
        return _as_float01(arr)
    from PIL import Image

    img = Image.open(io.BytesIO(raw)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _as_float01(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.ndim != 3 or arr.shape[-1] not in (1, 3):
        raise ValueError(f"image array must be (H, W, 3), got {arr.shape}")
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    arr = arr.astype(np.float32)
    if arr.max() > 1.0 + 1e-6:
        arr = arr / 255.0
    return arr


def decode_image(ref: str, *, base_dir: Path | str | None = None) -> np.ndarray:
    """Resolve an ``image`` field: data URI, bare base64, or a path
    (relative paths resolve against the dataset file's directory)."""
    if ref.startswith("data:"):
        _, _, payload = ref.partition(",")
        return _from_bytes(base64.b64decode(payload))
    p = Path(ref)
    if not p.is_absolute() and base_dir is not None:
        p = Path(base_dir) / p
    if p.exists():
        if p.suffix == ".npy":
            return _as_float01(np.load(p, allow_pickle=False))
        return _from_bytes(p.read_bytes())
    if Path(ref).suffix or "\\" in ref:
        # a file suffix ("." in the last component) or a backslash cannot
        # appear in base64 — this is a missing/typo'd PATH, so don't even try
        # the fallback ("/" alone is NOT a path signal: it is in the base64
        # alphabet, and bare payloads legitimately contain it)
        raise FileNotFoundError(
            f"image ref {ref[:80]!r} is neither an existing file nor "
            "decodable base64 (its file suffix rules the base64 fallback out)"
        )
    # not a file — try bare base64 before giving up. A typo'd extensionless
    # path can be VALID base64 of garbage bytes, which then dies inside the
    # image decoder (PIL's UnidentifiedImageError is an OSError) — catch that
    # too and raise the intended error instead of an uncaught decode failure.
    try:
        return _from_bytes(base64.b64decode(ref, validate=True))
    except (binascii.Error, ValueError, OSError):
        raise FileNotFoundError(
            f"image ref {ref[:80]!r} is neither an existing file nor "
            "decodable base64"
        ) from None


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to (size, size, 3) (PIL when available, else a
    nearest-neighbor numpy fallback — tests/containers without PIL)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    try:
        from PIL import Image

        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        return np.asarray(
            pil.resize((size, size), Image.BILINEAR), np.float32
        ) / 255.0
    except ImportError:
        ys = (np.arange(size) * img.shape[0] / size).astype(int)
        xs = (np.arange(size) * img.shape[1] / size).astype(int)
        return img[ys][:, xs]


def preprocess_image(
    ref: str, size: int, *,
    base_dir: Path | str | None = None,
    normalize: str = "clip",
) -> np.ndarray:
    """ref → (size, size, 3) float32, CLIP-normalized by default."""
    img = resize_image(decode_image(ref, base_dir=base_dir), size)
    if normalize == "clip":
        return (img - CLIP_MEAN) / CLIP_STD
    if normalize == "none":
        return img
    raise ValueError(f"unknown image normalize mode {normalize!r}")
