"""Descriptor extraction: 3x3 Sobel responses + libelas 16-sample descriptor
(counterpart of ``repro/core/descriptor.py``).

The two Sobel maps are int8 and come from the Sobel kernel
(:func:`repro_torch.kernels.sobel.sobel`; both views of a frame or a wave
in one launch); :func:`assemble_descriptors` gathers the 16-sample
descriptor per pixel as a (..., H, W, 16) int8 tensor.  Edge padding is
built by clamping indices (the same values as ``jnp.pad(mode="edge")``)
rather than ``F.pad(mode="replicate")``, which is not dispatched for
integer tensors on every device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import descriptor_texture  # noqa: F401 (re-exported)
from repro_torch.kernels.sobel import sobel

# (dy, dx) sample offsets for the 16-dim libelas descriptor.
# 12 samples from the horizontal Sobel map (centre duplicated, as in
# libelas' descriptor.cpp) + 4 samples from the vertical Sobel map.
DU_OFFSETS: tuple = (
    (-2, 0),
    (-1, -2), (-1, 0), (-1, 2),
    (0, -1), (0, 0), (0, 0), (0, 1),
    (1, -2), (1, 0), (1, 2),
    (2, 0),
)
DV_OFFSETS: tuple = ((-1, 0), (0, -1), (0, 1), (1, 0))
DESC_DIM = len(DU_OFFSETS) + len(DV_OFFSETS)  # 16


def edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate ``pad`` cells on both sides of the last two axes."""
    h, w = x.shape[-2:]
    rows = torch.arange(-pad, h + pad, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=x.device).clamp_(0, w - 1)
    return x[..., rows, :][..., cols]


def sobel3x3(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel in horizontal (du) and vertical (dv) directions.

    Input: (..., H, W) image.  Output: two (..., H, W) int8 maps,
    ``clip(g // 4)`` (floor division, as libelas' 8-bit packing).
    """
    return sobel(image)


def assemble_descriptors(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(..., H, W) int8 Sobel maps -> (..., H, W, 16) int8 descriptors.

    Border pixels sample clamped coordinates.
    """
    h, w = gx.shape[-2:]
    pads = 2
    gxp = edge_pad(gx, pads)
    gyp = edge_pad(gy, pads)
    feats = [gxp[..., pads + dy : pads + dy + h, pads + dx : pads + dx + w]
             for dy, dx in DU_OFFSETS]
    feats += [gyp[..., pads + dy : pads + dy + h, pads + dx : pads + dx + w]
              for dy, dx in DV_OFFSETS]
    return torch.stack(feats, dim=-1)


def extract(image: torch.Tensor) -> torch.Tensor:
    """Full path: (..., H, W) image -> (..., H, W, 16) int8 descriptors."""
    gx, gy = sobel3x3(image)
    return assemble_descriptors(gx, gy)


def extract_views(
    img_left: torch.Tensor, img_right: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Descriptors of both views of a frame (H, W) or a wave (B, H, W),
    from one Sobel launch over the stacked views."""
    if img_left.shape != img_right.shape:
        raise ValueError(
            f"view shapes differ: {tuple(img_left.shape)} vs {tuple(img_right.shape)}"
        )
    desc = extract(torch.stack([img_left, img_right]))
    return desc[0], desc[1]
