"""Swin-B's forward FLOPs per image from its layer shapes (Liu et al. 2021,
arXiv:2103.14030, Table 1: 15.4 G multiply-adds at 224 px): 2 × the
multiply-adds of the patch embedding, every block's qkv, output projection
and two MLP linears over the map's tokens, both attention products (q·kᵀ and
the scores times v) over every window of the padded map, patch merging's
linear and the head. LayerNorm, GELU, softmax, the bias and mask additions,
the rolls and the residual sums are left out."""

EMBED, DEPTHS, WINDOW, PATCH, MLP_RATIO = 128, (2, 2, 18, 2), 7, 4, 4


def block_macs(side: int, dim: int, window: int = WINDOW) -> int:
    """Multiply-adds of one block on a side × side map of ``dim`` channels."""
    tokens = side * side
    padded = -(-side // window) * window
    n = window * window  # a window's tokens
    linears = tokens * dim * (3 * dim + dim + 2 * MLP_RATIO * dim)
    attention = (padded // window) ** 2 * 2 * n * n * dim  # q·kᵀ and scores·v, all heads
    return linears + attention


def forward_flops(image_size: int, n_classes: int) -> int:
    side = image_size // PATCH
    macs = side * side * EMBED * 3 * PATCH * PATCH
    dim = EMBED
    for i, depth in enumerate(DEPTHS):
        macs += depth * block_macs(side, dim)
        if i < len(DEPTHS) - 1:
            side = -(-side // 2)
            macs += side * side * 4 * dim * 2 * dim  # patch merging's linear
            dim *= 2
    return 2 * (macs + dim * n_classes)
