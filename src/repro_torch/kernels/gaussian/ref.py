"""Plain PyTorch version of the Gaussian blur benchmark (paper Table I:
lws=128, 2:1 read:write buffers, 8192px image, 31px filter).  Transcribes
the JAX package's oracle op for op."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_weights(ksize: int, sigma: float = 0.0) -> np.ndarray:
    sigma = sigma or 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    w = np.exp(-(x * x) / (2 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def blur_rows_ref(img_padded, w1d, row0: int, n_rows: int):
    """Separable 2D gaussian blur of rows [row0, row0+n_rows).
    img_padded: (H + K - 1, W + K - 1) with symmetric K//2 halo."""
    K = w1d.shape[0]
    Wout = img_padded.shape[1] - (K - 1)
    block = img_padded[row0:row0 + n_rows + K - 1]
    # vertical pass
    tmp = sum(w1d[k] * block[k:k + n_rows, :] for k in range(K))
    # horizontal pass
    out = sum(w1d[k] * tmp[:, k:k + Wout] for k in range(K))
    return out


def blur_full_ref(img, ksize: int = 31):
    w = torch.from_numpy(gaussian_weights(ksize)).to(img.device)
    pad = ksize // 2
    ip = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    return blur_rows_ref(ip, w, 0, img.shape[0])
