"""View pipelines: the test transform and the weak-view backends.

Views leave here as normalized float32 NCHW, the layout of the port's
convolutions, from u8 NHWC batches (the dataset's layout).
"""

from __future__ import annotations

import torch

from fedmlp_tpu_torch.ops.warp import weak_augment_batch_fused


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    """ToTensor + Normalize on NHWC: [0,255] → ((x/255) − mean)/std."""
    m = torch.tensor(mean, dtype=torch.float32, device=img.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=img.device) * 255.0
    return (img - m) / s


def eval_batch(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """Test transform (normalize only) of u8 NHWC → f32 NCHW."""
    return normalize(images_u8.to(torch.float32), mean, std).permute(0, 3, 1, 2)


def pick_weak_backend(augment_backend: str):
    """Weak-view function ``(u8 NHWC, generator, mean, std) → f32 NCHW``:
    'fused' (warp kernel) or 'normonly' (normalize without warp or flip).
    'auto' is 'fused' on every device: the kernel's plain version serves
    CPU tensors."""
    backend = "fused" if augment_backend == "auto" else augment_backend
    if backend == "normonly":
        return lambda imgs, generator, mean, std: eval_batch(imgs, mean, std)
    if backend == "fused":
        return weak_augment_batch_fused
    raise ValueError(f"weak augment backend {augment_backend!r} is not ported; "
                     "use 'auto', 'fused' or 'normonly'")
