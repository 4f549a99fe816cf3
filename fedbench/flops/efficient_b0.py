"""EfficientNet-B0's forward FLOPs per image from its layer shapes (Tan & Le
2019, Table 1): 2 × the multiply-adds of every convolution (stem, expand,
depthwise, squeeze-excite, project, head) and of the linear head. Batch norm,
activations, pooling and the residual sums are left out."""

import math

# (expand ratio, output channels, repeats, stride, kernel)
BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
          (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
STEM, HEAD = 32, 1280


def block_macs(side: int, cin: int, cout: int, expand: int, kernel: int, stride: int) -> int:
    """Multiply-adds of one MBConv block whose input is side × side."""
    mid = cin * expand
    out = math.ceil(side / stride)  # TF "SAME"
    se = max(1, int(cin * 0.25))
    macs = side * side * cin * mid if expand != 1 else 0
    macs += out * out * mid * kernel * kernel  # depthwise
    macs += mid * se + se * mid  # squeeze-excite on the pooled 1 x 1
    return macs + out * out * mid * cout


def forward_flops(image_size: int, n_classes: int) -> int:
    side = math.ceil(image_size / 2)
    macs = side * side * STEM * 3 * 3 * 3
    cin = STEM
    for expand, cout, reps, stride, kernel in BLOCKS:
        for r in range(reps):
            s = stride if r == 0 else 1
            macs += block_macs(side, cin, cout, expand, kernel, s)
            side, cin = math.ceil(side / s), cout
    macs += side * side * cin * HEAD + HEAD * n_classes
    return 2 * macs
