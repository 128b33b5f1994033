"""Host-side image transforms, PIL and numpy (the port's own copy of
`jperceiver_tpu/data/transforms.py`): LANCZOS resize to the working
resolution, horizontal flip, a color jitter whose factors the caller draws
once per sample, and the BEV label binarization. Images come out float32
HWC in [0, 1]; the datasets transpose them to the port's CHW.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance

ANTIALIAS = Image.LANCZOS


def resize_image(img: Image.Image, height: int, width: int) -> Image.Image:
    return img.resize((width, height), ANTIALIAS)


def to_array(img: Image.Image) -> np.ndarray:
    """8-bit PIL image -> float32 HWC in [0, 1]: every value is exactly
    k/255 for an integer k."""
    return np.asarray(img, np.float32) / 255.0


def apply_color_jitter(img: Image.Image, b: float, c: float, s: float,
                       h: float, order) -> Image.Image:
    """Brightness, contrast, saturation and hue by the given factors, in
    the given order of the four ops (a permutation of 0..3)."""
    for op in order:
        if op == 0:
            img = ImageEnhance.Brightness(img).enhance(b)
        elif op == 1:
            img = ImageEnhance.Contrast(img).enhance(c)
        elif op == 2:
            img = ImageEnhance.Color(img).enhance(s)
        elif op == 3 and abs(h) > 1e-8:
            hsv = np.asarray(img.convert("HSV"), np.uint8).copy()
            # modulo keeps a tiny negative h from giving uint8(256)
            shift = np.uint8(int(h * 255) % 256)
            hsv[..., 0] = hsv[..., 0] + shift  # uint8 wraparound
            img = Image.fromarray(hsv, "HSV").convert("RGB")
    return img


def process_topview(img: Image.Image, size: int, flip: bool) -> np.ndarray:
    """BEV label PNG -> (size, size) {0, 1} float32: convert('1'), NEAREST
    resize, 'L', == 255."""
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    tv = img.convert("1").resize((size, size), Image.NEAREST).convert("L")
    return (np.asarray(tv) == 255).astype(np.float32)


def process_topview_both(img: Image.Image, size: int, flip: bool) -> np.ndarray:
    """The Argoverse `both` label: a plain NEAREST resize, then == 255."""
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img.resize((size, size), Image.NEAREST))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr == 255).astype(np.float32)


def chw_frames(frames: list[np.ndarray]) -> np.ndarray:
    """F HWC frames -> one contiguous (F, 3, H, W) array, the port's
    layout."""
    return np.ascontiguousarray(np.stack(frames, 0).transpose(0, 3, 1, 2))
