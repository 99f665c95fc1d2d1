"""Host-side image transforms (numpy, CHW float32 in [0, 1]): the eval
letterbox and the train-time augmentation, the port's own copy of
sam2unet_tpu/data/transforms.py (torchvision-formula ops; the reference's
pipeline is dataset.py:13-285)."""

from __future__ import annotations

import numpy as np

from sam2unet_torch.ops.resize_np import resize_np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------- color ops

def rgb_to_grayscale(img: np.ndarray, keep_channels: bool = True) -> np.ndarray:
    """img: (3, H, W). torchvision ITU-R 601-2 weights."""
    g = 0.2989 * img[0] + 0.587 * img[1] + 0.114 * img[2]
    return np.repeat(g[None], 3, axis=0) if keep_channels else g[None]


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = rgb_to_grayscale(img, keep_channels=False).mean()
    return np.clip(factor * img + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = rgb_to_grayscale(img)
    return np.clip(factor * img + (1.0 - factor) * gray, 0.0, 1.0)


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    r, g, b = img[0], img[1], img[2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dz = np.where(deltac == 0, 1.0, deltac)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc, 0.0)
    h = np.where((maxc == g) & (maxc != r), 2.0 + rc - bc, h)
    h = np.where((maxc == b) & (maxc != r) & (maxc != g), 4.0 + gc - rc, h)
    h = (h / 6.0) % 1.0
    h = np.where(deltac == 0, 0.0, h)
    return np.stack([h, s, v])


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[0], hsv[1], hsv[2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b])


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """factor in [-0.5, 0.5], cyclic shift of hue."""
    hsv = _rgb_to_hsv(np.clip(img, 0.0, 1.0))
    hsv[0] = (hsv[0] + factor) % 1.0
    return _hsv_to_rgb(hsv)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    return np.clip(gain * np.clip(img, 0.0, 1.0) ** gamma, 0.0, 1.0)


def gaussian_blur(img: np.ndarray, kernel_size: int) -> np.ndarray:
    """Separable Gaussian, torchvision sigma rule, reflect padding (scipy's
    correlate1d; it runs per sample in the prefetch threads)."""
    from scipy.ndimage import correlate1d

    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    half = kernel_size // 2
    xs = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    out = img.astype(np.float32)
    for axis in (1, 2):
        out = correlate1d(out, k, axis=axis, mode="mirror")
    return out.astype(np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    return (img - mean[:, None, None]) / std[:, None, None]


# ----------------------------------------------------------- geometric ops

def rotate90(img: np.ndarray, angle: int) -> np.ndarray:
    """Exact 90/180/270 CCW rotation on (C, H, W) (torchvision positive
    angle = counter-clockwise; exact for right angles)."""
    return np.ascontiguousarray(np.rot90(img, k=angle // 90, axes=(1, 2)))


def letterbox(
    img: np.ndarray,
    size: int,
    method: str = "bilinear",
    antialias: bool = True,
) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Resize the longest side to `size`, center-pad to square with zeros.
    Returns (padded (C, size, size), (left, top, right, bottom))."""
    h, w = img.shape[-2:]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_np(img, (nh, nw), method, antialias=antialias)
    pad_h, pad_w = size - nh, size - nw
    top, left = pad_h // 2, pad_w // 2
    bottom, right = pad_h - top, pad_w - left
    out = np.zeros((img.shape[0], size, size), np.float32)
    out[:, top : top + nh, left : left + nw] = resized
    return out, (left, top, right, bottom)


def letterbox_nearest(img: np.ndarray, size: int) -> np.ndarray:
    out, _ = letterbox(img, size, method="nearest", antialias=False)
    return out


# ------------------------------------------------- random train transforms

class TrainAugment:
    """The fork's train-time pipeline (dataset.py:298-309), seeded RNG:

    ResizeLongestSideAndPad(rand white-pad 1.0-1.5x | rand crop 0.5-1.0x,
    then letterbox) -> RandomRotate(90/180/270, p=.75) -> ToGray(p=.5) ->
    ColorAugmentations(p=.8) -> GaussianBlur(p=.2) -> Normalize."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray, label: np.ndarray):
        rng = self.rng
        c, h, w = image.shape

        # -- random pad-with-white or crop (dataset.py:52-102)
        if rng.random() < 0.5:
            sfh = rng.uniform(1.0, 1.5)
            sfw = rng.uniform(1.0, 1.5)
            nh, nw = int(round(h * sfh)), int(round(w * sfw))
            pad_h, pad_w = nh - h, nw - w
            top = rng.integers(0, pad_h + 1)
            left = rng.integers(0, pad_w + 1)
            img2 = np.ones((c, nh, nw), np.float32)  # white
            img2[:, top : top + h, left : left + w] = image
            lbl2 = np.zeros((label.shape[0], nh, nw), np.float32)
            lbl2[:, top : top + h, left : left + w] = label
            image, label = img2, lbl2
        else:
            sfh = rng.uniform(0.5, 1.0)
            sfw = rng.uniform(0.5, 1.0)
            nh = max(1, int(round(h * sfh)))
            nw = max(1, int(round(w * sfw)))
            y1 = rng.integers(0, h - nh + 1)
            x1 = rng.integers(0, w - nw + 1)
            image = image[:, y1 : y1 + nh, x1 : x1 + nw]
            label = label[:, y1 : y1 + nh, x1 : x1 + nw]

        image, _ = letterbox(image, self.size)
        label = letterbox_nearest(label, self.size)

        # -- rotate (dataset.py:157-174)
        if rng.random() < 0.75:
            angle = int(rng.choice([90, 180, 270]))
            image = rotate90(image, angle)
            label = rotate90(label, angle)

        # -- gray (p=.5)
        if rng.random() < 0.5:
            image = rgb_to_grayscale(image)

        # -- color (p=.8, one of 4 modes, dataset.py:216-255)
        if rng.random() < 0.8:
            choice = int(rng.integers(0, 4))
            if choice == 0:
                image = adjust_brightness(image, rng.uniform(0.5, 1.5))
                image = adjust_contrast(image, rng.uniform(0.5, 1.5))
            elif choice == 1:
                image = adjust_brightness(image, rng.uniform(0.5, 1.5))
                image = adjust_contrast(image, rng.uniform(0.5, 1.5))
                image = adjust_saturation(image, rng.uniform(0.5, 1.5))
                image = adjust_hue(image, rng.uniform(-0.5, 0.5))
            elif choice == 2:
                image = adjust_saturation(image, rng.uniform(0.5, 1.5))
                image = adjust_hue(image, rng.uniform(-0.5, 0.5))
            else:
                image = adjust_gamma(image, rng.uniform(0.5, 1.5))

        # -- blur (p=.2, k in {3,5})
        if rng.random() < 0.2:
            image = gaussian_blur(image, int(rng.choice([3, 5])))

        return normalize(image), label
